"""The train step, as the JAX package's ``train/step.py``
(``_forward_and_loss`` and the step bodies of ``make_train_step``): on one
device, or as one rank of a data-parallel world (the ``shard_map`` +
``pmean`` step over the ``data`` axis).

The path is the one the JAX package takes with its fused kernels on:
the head outputs concatenated to (B, A, K), targets from
``anchor_targets_compact_batched`` (the matching kernel on a card) under
``torch.no_grad()``, and ``total_loss_compact`` (the focal kernels on a
card).  The JAX package's default arm, the per-level NHWC loss, gives the
same values and is not carried over (``losses.py``).  The step records the
pre-clip global gradient norm, which the clip reuses, and the post-update
parameter norm; with ``numerics`` enabled, the numerics summary of
``obs/numerics.py`` too.

In a world (``launch/pod.py::World``) each rank runs its share of the
global batch through the model's replica (``parallel/mesh.py::replicate``),
whose hook averages each gradient bucket over the ranks while the backward
runs; the loss metrics are then averaged and ``num_pos`` summed, and each
rank's BatchNorm statistics, updated from its own images, are averaged,
all in one all-reduce.  ``grad_norm`` is the norm of the averaged
gradients, the one the clip uses, and every rank applies the same update,
so the parameters stay bit-identical.  With the numerics summary on,
``replica_agreement`` compares the ranks' local gradient norms before the
reduce.

The gradient-communication flavors (``comm``, a ``comm/config.py::
CommConfig``, and ``shard_weight_update``) are the JAX mesh step's
``make_comm_step`` and ``make_zero_step``.  They run the model itself, not
a DDP replica (whose reducer would average the gradients in buckets of its
own, while the compression's blocks and scales follow the JAX plan over the
flax key paths): every rank takes rank 0's parameters when
``train/state.py::create_train_state`` builds the state, then

- ``comm``: after the backward, ``comm/compress.py::reduce_tree`` reduces
  the gradients in the plan's buckets (an exact f32 reduce-scatter, the EF
  add-back from ``state.comm_state``, int8 or bf16 blocks gathered); with
  ``comm.overlap`` each stage's reduce runs inside the backward instead
  (``comm/overlap.py``), bit for bit the same values; with a ``topology``
  whose hops differ, the tree is hierarchical.  ``grad_norm`` is the norm of
  the dequantized gradients the optimizer consumes;
- ``shard_weight_update`` (ZeRO, ``parallel/zero.py``): one exact
  reduce-scatter of the gradients, the optimizer on this rank's shards,
  and one all-gather of the new shards, or, with ``comm``, the compressed
  gather of the update shards (``comm/compress.py::zero_gather_updates``).

Both add ``ef_residual_norm``, ``ef_saturation`` and
``comm_compressed_bytes`` (per hop on the hierarchical tree) to the
metrics, and feed ``replica_agreement`` the local gradient norm before the
reduce.  A NaN or Inf gradient poisons its block's scale, so the world's
loss metrics and norms go non-finite together and the loop stops every
rank at the same step.

:func:`make_train_step_spatial` is the JAX package's spatially partitioned
step (``make_train_step_spatial``): each image's H axis over the S ranks of
a space group (``parallel/spatial.py``), with the JAX factory's refusals.

The kernels' launch shapes (the matching kernel's ``tile_a``, the focal
kernels' ``focal_fwd_tile_a``/``focal_bwd_tile_a``) left None in the configs
are the schedule registry's for the step's device
(:func:`resolve_kernel_schedule`), once when the step is built, for every
flavor and on every rank.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as compress_lib
from batchai_retinanet_horovod_coco_tpu_torch.comm import overlap as overlap_lib
from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
from batchai_retinanet_horovod_coco_tpu_torch.obs import numerics as numerics_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_params, to_flax
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh
from batchai_retinanet_horovod_coco_tpu_torch.parallel import spatial
from batchai_retinanet_horovod_coco_tpu_torch.parallel import zero as zero_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.train.state import TrainState
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

#: The step's phases, in order; a step called with ``mark`` calls
#: ``mark(name)`` as each one ends.
PHASES = ("forward", "targets", "loss", "backward", "optimizer")


def resolve_kernel_schedule(
    loss_config: losses_lib.LossConfig,
    matching_config: matching_lib.MatchingConfig,
    device: str | torch.device,
) -> tuple[losses_lib.LossConfig, matching_lib.MatchingConfig]:
    """The configs with every launch shape left None filled from the
    schedule registry for ``device`` (the JAX package's
    resolve_kernel_schedule): the focal kernels' forward and backward
    tiles and the matching kernel's tile.  An explicit value always wins;
    a device with no file gets the kernels' default shapes."""
    from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

    sched = schedule_lib.lookup(device)
    if matching_config.tile_a is None:
        matching_config = dataclasses.replace(
            matching_config, tile_a=int(sched["matching"]["tile_a"]))
    if loss_config.focal_fwd_tile_a is None:
        loss_config = dataclasses.replace(
            loss_config, focal_fwd_tile_a=int(sched["focal"]["fwd_tile_a"]))
    if loss_config.focal_bwd_tile_a is None:
        loss_config = dataclasses.replace(
            loss_config, focal_bwd_tile_a=int(sched["focal"]["bwd_tile_a"]))
    return loss_config, matching_config


def forward_and_loss(
    model: torch.nn.Module,
    images: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors: torch.Tensor,
    loss_config: losses_lib.LossConfig = losses_lib.LossConfig(),
    matching_config: matching_lib.MatchingConfig = matching_lib.MatchingConfig(),
    mark: Callable[[str], None] | None = None,
) -> dict[str, torch.Tensor]:
    """Loss metrics of one batch: ``loss`` (differentiable), ``cls_loss``,
    ``box_loss`` and ``num_pos``.  uint8 images are normalized here."""
    outputs = model(pipeline_lib.normalize_images(images))
    if mark is not None:
        mark("forward")
    with torch.no_grad():
        targets = matching_lib.anchor_targets_compact_batched(
            anchors, gt_boxes, gt_labels, gt_mask, matching_config
        )
    if mark is not None:
        mark("targets")
    metrics = losses_lib.total_loss_compact(
        outputs["cls_logits"],
        outputs["box_deltas"],
        targets.matched_labels,
        targets.box_targets,
        targets.state,
        loss_config,
    )
    metrics["num_pos"] = (targets.state == matching_lib.POSITIVE).float().sum()
    if mark is not None:
        mark("loss")
    return metrics


def make_train_step(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    num_classes: int,
    loss_config: losses_lib.LossConfig = losses_lib.LossConfig(),
    matching_config: matching_lib.MatchingConfig = matching_lib.MatchingConfig(),
    anchor_config: anchors_lib.AnchorConfig | None = None,
    device: str | torch.device = "cuda",
    numerics: numerics_lib.NumericsConfig = numerics_lib.NumericsConfig(),
    world=None,
    comm: CommConfig | None = None,
    shard_weight_update: bool = False,
    topology=None,
) -> Callable[..., dict[str, torch.Tensor]]:
    """The train step for one shape bucket, on one device or (``world``)
    as one rank of a data-parallel world (module docstring).

    The returned ``step(state, batch, mark=None)`` takes a batch dict of
    ``images`` (B, H, W, 3), ``gt_boxes`` (B, G, 4), ``gt_labels`` and
    ``gt_mask`` (B, G) on the device, updates ``state`` in place (the
    model's parameters and BatchNorm statistics, the optimizer, the step
    count) and returns the metrics as 0-dim device tensors: ``loss``,
    ``cls_loss``, ``box_loss``, ``num_pos``, the pre-clip ``grad_norm`` and
    the post-update ``param_norm``.  ``mark``, when given, is called with
    each name of :data:`PHASES` as that phase ends (for timing).

    With ``numerics.enabled`` the metrics also hold ``nonfinite_grads``,
    ``update_ratio`` and ``gnorm/<group>`` a top-level module
    (``obs/numerics.py``), all on the device: the group norms reuse the
    per-tensor gradient norms ``grad_norm`` is taken from; the gradients
    (for their non-finite count) and the parameters before the in-place
    update are copied into buffers made here, once.  Disabled, the step
    and its metrics are unchanged.

    ``comm``, ``shard_weight_update`` and ``topology`` (``parallel/mesh.py::
    CommTopology``) select the gradient-communication flavors of the module
    docstring; each needs a ``world``, and the ``state`` they step must come
    from ``create_train_state`` with the same flags (which gives every rank
    rank 0's weights).  A topology engages only where it has more than one
    slice and ``comm``'s two hops differ; otherwise the step runs the flat
    tree at the single-hop mode.  ZeRO ignores ``comm.overlap`` and the topology (its
    compressed gather is flat), with a warning each.
    """
    device = resolve_device(device)
    loss_config, matching_config = resolve_kernel_schedule(loss_config, matching_config, device)
    if model.config.num_classes != num_classes:
        raise ValueError(
            f"the model has {model.config.num_classes} classes, the step {num_classes}"
        )
    if shard_weight_update and world is None:
        raise ValueError("shard_weight_update requires a mesh: pass world=")
    flags = (comm, shard_weight_update, topology)
    comm_topology = None
    if comm is not None and topology is not None:
        if shard_weight_update:
            if comm.hierarchical_with(topology):
                warnings.warn(
                    "comm topology has no effect with shard_weight_update: the ZeRO path "
                    "compresses the post-update gather, which stays flat — the hierarchical "
                    "tree is a DP-path mechanism"
                )
        elif comm.hierarchical_with(topology):
            comm_topology = topology
        else:
            comm = comm.flat_equivalent(topology)
    comm_on = comm is not None and comm.enabled
    if comm_on and world is None:
        raise ValueError("comm compression requires a mesh: pass world=")
    if comm_topology is not None and comm_topology.num_devices != world.size:
        raise ValueError(
            f"topology is {comm_topology.num_slices}x{comm_topology.slice_size} = "
            f"{comm_topology.num_devices} devices but the mesh has {world.size}"
        )
    if comm_on and comm.overlap and shard_weight_update:
        warnings.warn(
            "comm.overlap has no effect with shard_weight_update: the ZeRO path compresses "
            "the post-update gather, not the backward-pass gradient collectives "
            "(comm/overlap.py is a DP-path mechanism)"
        )
    anchors = detect_lib.anchors_on(image_hw, anchor_config or anchors_lib.AnchorConfig(), device)
    if comm_on or shard_weight_update:
        return _make_comm_step(model, image_hw, anchors, loss_config, matching_config, numerics,
                               world, comm if comm_on else None, shard_weight_update,
                               comm_topology, flags)
    replica = model if world is None else mesh.replicate(model, world)
    stats = [] if world is None else mesh.batch_statistics(model)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    before = flat = None
    if numerics.enabled:
        groups = [numerics_lib.group_of(n) for n, _ in named]
        before = [torch.empty_like(p) for p in params]
        flat = torch.empty(sum(p.numel() for p in params), dtype=params[0].dtype,
                           device=params[0].device)

    def step(
        state: TrainState,
        batch: dict[str, Any],
        mark: Callable[[str], None] | None = None,
    ) -> dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        if tuple(batch["images"].shape[1:3]) != tuple(image_hw):
            raise ValueError(
                f"images {tuple(batch['images'].shape)} do not match the step's {image_hw}"
            )
        model.train()
        model.zero_grad(set_to_none=True)
        if world is not None:
            replica.grad_probe.reset()
        metrics = forward_and_loss(
            replica, batch["images"], batch["gt_boxes"], batch["gt_labels"],
            batch["gt_mask"], anchors, loss_config, matching_config, mark,
        )
        metrics["loss"].backward()
        if world is not None:
            mesh.average_over_ranks(world, metrics, stats)
            if numerics.enabled:
                metrics[numerics_lib.REPLICA_AGREEMENT] = numerics_lib.replica_agreement(
                    replica.grad_probe.local_norm(), world
                )
        if mark is not None:
            mark("backward")
        grads = [p.grad for p in params if p.grad is not None]
        norms = optim.tensor_norms(grads)
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(norms))
        if before is not None:
            metrics.update(numerics_lib.step_summary(grads, norms, groups, flat))
            torch._foreach_copy_(before, params)
        state.apply_gradients(metrics["grad_norm"], metrics["loss"].detach())
        with torch.no_grad():
            metrics["param_norm"] = optim.global_norm(params)
            if before is not None:
                metrics[numerics_lib.UPDATE_RATIO] = numerics_lib.update_ratio(
                    before, params, metrics["param_norm"]
                )
        if mark is not None:
            mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _make_comm_step(model, image_hw, anchors, loss_config, matching_config, numerics, world,
                    comm: CommConfig | None, zero: bool, topology, flags: tuple):
    """The ZeRO and compressed flavors of the world step (see
    :func:`make_train_step`); ``flags`` are the step's as given, which the
    state's must equal."""
    device = anchors.device
    stats = mesh.batch_statistics(model)
    leaves = flax_params(model)
    by_path = {path: p for _, path, p in leaves}
    groups = [numerics_lib.group_of(name) for name, _, _ in leaves]
    axis = mesh.DataAxis(world)
    probe = mesh.GradProbe(device)
    hierarchy = None
    if topology is not None:
        hierarchy = compress_lib.Hierarchy(topology, *mesh.hop_axes(world, topology))
    plan = grad_fn = None
    if comm is not None:
        plan = compress_lib.plan_buckets({path: to_flax(p) for path, p in by_path.items()}, comm,
                                         topology)
        if comm.overlap and not zero:
            grad_fn = overlap_lib.make_overlap_grad_fn(plan, comm, axis, by_path, hierarchy)
    before = flat = None
    if numerics.enabled:
        before = [torch.empty_like(p) for p in by_path.values()]
        flat = torch.empty(sum(p.numel() for p in by_path.values()), dtype=torch.float32,
                           device=device)

    def local_grads() -> dict[str, torch.Tensor]:
        for p in by_path.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return {path: to_flax(p.grad) for path, p in by_path.items()}

    def step(state, batch: dict[str, Any], mark: Callable[[str], None] | None = None):
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        if state.comm_flags != flags:
            raise ValueError("the state was not built for this step's communication: build it "
                             "with create_train_state(..., comm=, shard_weight_update=, "
                             "topology=) as the step")
        if tuple(batch["images"].shape[1:3]) != tuple(image_hw):
            raise ValueError(
                f"images {tuple(batch['images'].shape)} do not match the step's {image_hw}"
            )
        model.train()
        model.zero_grad(set_to_none=True)
        probe.reset()
        metrics = forward_and_loss(
            model, batch["images"], batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"],
            anchors, loss_config, matching_config, mark,
        )
        comm_state = state.comm_state
        new_comm, sat = comm_state, None
        if grad_fn is not None:
            new_comm, sat = grad_fn(metrics["loss"].backward, comm_state, probe)
            grads = local_grads()
        else:
            metrics["loss"].backward()
            grads = local_grads()
            probe.sum_sq += sum(g.float().square().sum() for g in grads.values())
        grad_list = list(grads.values())
        if numerics.enabled and zero:
            # The mean gradient exists only as shards: count and measure the
            # local gradients, then reduce (a NaN anywhere poisons the
            # reduce-scatter, so local detection is global detection).
            norms = optim.tensor_norms(grad_list)
            local = [numerics_lib.nonfinite_count(grad_list, flat)]
            local += list(numerics_lib.group_norms(groups, norms).values())
            summary = world.all_reduce(torch.stack(local).float())
            metrics[numerics_lib.NONFINITE] = summary[0]
            for i, key in enumerate(numerics_lib.group_norms(groups, norms)):
                metrics[f"{numerics_lib.GROUP_PREFIX}{key}"] = summary[1 + i] / world.size
        mesh.average_over_ranks(world, metrics, stats)
        if numerics.enabled:
            metrics[numerics_lib.REPLICA_AGREEMENT] = numerics_lib.replica_agreement(
                probe.local_norm(), world)
        if grad_fn is None and not zero:
            reduced, new_comm, sat = compress_lib.reduce_tree(grads, comm_state, plan, comm, axis,
                                                              hierarchy)
            with torch.no_grad():
                for path, g in grads.items():
                    g.copy_(reduced[path])
        if mark is not None:
            mark("backward")
        if before is not None:
            torch._foreach_copy_(before, list(by_path.values()))
        loss = metrics["loss"].detach()
        if zero:
            gather = None
            if comm is not None:
                def gather(updates):
                    nonlocal new_comm, sat
                    params = {path: to_flax(p.detach()) for path, p in by_path.items()}
                    new_params, new_comm, sat = compress_lib.zero_gather_updates(
                        updates, params, comm_state, plan, comm, axis)
                    return new_params
            metrics.update(zero_lib.sharded_update(state.optimizer, state.shards, grads, axis,
                                                   loss, gather))
            state.step += 1
        else:
            norms = optim.tensor_norms(grad_list)
            metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(norms))
            if numerics.enabled:
                metrics.update(numerics_lib.step_summary(grad_list, norms, groups, flat))
            state.apply_gradients(metrics["grad_norm"], loss)
        with torch.no_grad():
            params = list(by_path.values())
            metrics["param_norm"] = optim.global_norm(params)
            if before is not None:
                metrics[numerics_lib.UPDATE_RATIO] = numerics_lib.update_ratio(
                    before, params, metrics["param_norm"])
        if comm is not None:
            metrics.update(compress_lib.comm_metrics(plan, new_comm, sat.to(device), axis,
                                                     zero=zero, topology=topology))
            state.comm_state = dict(new_comm)
        if mark is not None:
            mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    return step


def _degenerate_strided_conv_heights(image_h: int, num_space: int) -> list[int]:
    """The JAX package's envelope of XLA's strided-conv weight-gradient
    bug (its ``train/step.py``): the input heights of the family's stride-2
    3x3 convs (ceil(H/4) .. ceil(H/64)) at [num_space/2, 2*num_space) rows
    for >= 8 shards.  The port computes those gradients exactly; it keeps
    the envelope so that both packages accept and refuse the same runs."""
    if num_space < 8:
        return []
    heights = [-(-image_h // d) for d in (4, 8, 16, 32, 64)]
    return [h for h in heights if num_space / 2 <= h < 2 * num_space]


# The JAX package's backbones whose spatial-step gradients it measured exact
# with a data axis (its train/step.py).
_SPATIAL_GRAD_VALIDATED_BACKBONES = frozenset({"resnet_test"})


def _data_axis_risky_stage_heights(image_h: int, num_space: int) -> list[int]:
    """The JAX package's data-axis envelope: backbone-stage heights
    ceil(H/4) .. ceil(H/32) at <= 1 row per shard (its ``train/step.py``)."""
    if num_space < 2:
        return []
    heights = [-(-image_h // d) for d in (4, 8, 16, 32)]
    return [h for h in heights if h <= num_space]


def check_spatial_config(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    num_data: int,
    num_space: int,
    allow_degenerate_spatial_sharding: bool = False,
    allow_unvalidated_bf16: bool = False,
    allow_data_axis_divergence: bool = False,
) -> None:
    """The JAX ``make_train_step_spatial``'s refusals, with its messages:
    a model that is not f32, a space size whose strided-conv heights fall in
    the JAX envelope, and a data axis >= 2 on a deep backbone whose stages
    reach <= 1 row a shard.  The port's gradients are exact in all three
    (no partitioner); the refusals keep the two packages' envelopes one."""
    dtype = model.config.dtype
    if dtype != torch.float32 and not allow_unvalidated_bf16:
        raise ValueError(
            f"spatial partitioning with a {str(dtype).removeprefix('torch.')} model is "
            "refused: the SPMD partitioner miscompiles the bf16 train "
            "step at flagship width (wrong cls_loss values, 14-60x wrong "
            "gradients — see make_train_step_spatial's docstring and the "
            "bf16 spatial canary test).  Train spatially in f32 "
            "(--f32 with --spatial-shards), or pass "
            "allow_unvalidated_bf16=True after validating one step "
            "against the single-device step on your backend"
        )
    if not allow_degenerate_spatial_sharding:
        risky = _degenerate_strided_conv_heights(image_hw[0], num_space)
        if risky:
            raise ValueError(
                f"space axis size {num_space} is too large for image "
                f"height {image_hw[0]}: stride-2 3x3 conv input maps of "
                f"height {risky} would land in the measured envelope "
                "where XLA's SPMD partitioner mis-computes strided-conv "
                "weight gradients (~[0.5, 2) rows per shard at >= 8 "
                "shards; see make_train_step_spatial docstring).  Use a "
                "smaller --spatial-shards for this bucket (space <= 4 is "
                "always outside the envelope), or pass "
                "allow_degenerate_spatial_sharding=True to accept "
                "1e-3-class gradient error in the affected conv kernels"
            )
    risky_stage = _data_axis_risky_stage_heights(image_hw[0], num_space)
    if (
        num_space > 1
        and num_data > 1
        and risky_stage
        and model.config.backbone not in _SPATIAL_GRAD_VALIDATED_BACKBONES
        and not allow_data_axis_divergence
    ):
        raise ValueError(
            f"spatial mesh (data={num_data}, space={num_space}) with "
            f"backbone {model.config.backbone!r} at image height "
            f"{image_hw[0]} is refused: backbone-stage maps of height "
            f"{risky_stage} land at <= 1 row per shard, where the "
            "partitioned backward of deep (residual-chain) backbones "
            "diverges from the single-device gradients once the data "
            "axis exceeds 1 (measured f64: 2.8e-4 per-step param L2 at "
            "data=2 growing ~3x per doubling — see "
            "make_train_step_spatial's 'Data-axis envelope').  Use a "
            "pure-spatial (1, space) mesh (device count equal to the "
            "spatial shard count), larger images (flagship 800-class "
            "buckets keep every stage >= 3 rows/shard at space <= 4 and "
            "measure clean), a plain DP mesh, or pass "
            "allow_data_axis_divergence=True to accept the measured "
            "gradient error"
        )


def spatial_anchors(
    image_hw: tuple[int, int], config: anchors_lib.AnchorConfig, axis: spatial.SpaceAxis,
    device: torch.device,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This space rank's anchors and their global indices on ``device``
    (``ops/anchors.py::anchors_for_rows``).  Raises, on every rank alike,
    when some rank of the group would own no anchor at all (the matching
    needs one)."""
    for index in range(axis.size):
        if anchors_lib.anchors_for_rows(image_hw, config, axis.size, index)[1].size == 0:
            raise ValueError(
                f"image height {image_hw[0]} leaves space rank {index} of {axis.size} no "
                "anchor rows at any pyramid level: use fewer --spatial-shards"
            )
    anchors, index = anchors_lib.anchors_for_rows(image_hw, config, axis.size, axis.index)
    return torch.from_numpy(np.array(anchors)).to(device), torch.from_numpy(index).to(device)


def make_train_step_spatial(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    num_classes: int,
    world,
    num_space: int,
    loss_config: losses_lib.LossConfig = losses_lib.LossConfig(),
    matching_config: matching_lib.MatchingConfig = matching_lib.MatchingConfig(),
    anchor_config: anchors_lib.AnchorConfig | None = None,
    allow_degenerate_spatial_sharding: bool = False,
    allow_unvalidated_bf16: bool = False,
    allow_data_axis_divergence: bool = False,
    numerics: numerics_lib.NumericsConfig = numerics_lib.NumericsConfig(),
) -> Callable[..., dict[str, torch.Tensor]]:
    """The train step with each image's H axis over ``num_space`` ranks
    (the JAX package's ``make_train_step_spatial``), as one rank of
    ``world``, a (world.size // num_space) x num_space grid
    (``parallel/mesh.py::space_axis``), on the world's device.

    ``step(state, batch, mark=None)`` takes the batch of this rank's data
    index, the whole images (B, H, W, 3), and slices its own rows; the gts
    are the whole image's.  The model runs on the rows inside a
    ``spatial.sharded`` block (the halo exchanges, the norms' statistics
    over the group); the matching kernel runs on the rank's own anchors
    with the per-gt best reduced over the group, and the focal kernels on
    its own anchors, each image's loss divided by its positives summed over
    the group and by the global batch.  No DDP: the ranks of a space group
    hold partial sums of the same images, so the gradients are summed over
    the world (one all-reduce), which with that scaling is the exact
    gradient of the global mean loss; every rank applies the same update.
    The metrics are the JAX spatial step's: ``loss``, ``cls_loss``,
    ``box_loss``, ``num_pos``, ``grad_norm``, ``param_norm`` and, with
    ``numerics``, the numerics summary without ``replica_agreement`` (the
    JAX path has none).  The ``state`` should come from
    ``create_train_state(..., world=world, spatial_shards=num_space)``,
    which gives every rank rank 0's weights.

    The refusals are the JAX factory's (:func:`check_spatial_config`); with
    the ``allow_*`` overrides this step still computes the exact gradient.
    """
    if world is None:
        raise ValueError("spatial partitioning needs a world: pass world=")
    if num_space < 1 or world.size % num_space:
        raise ValueError(
            f"space size {num_space} does not divide the world's {world.size} ranks"
        )
    if model.config.num_classes != num_classes:
        raise ValueError(
            f"the model has {model.config.num_classes} classes, the step {num_classes}"
        )
    num_data = world.size // num_space
    check_spatial_config(model, image_hw, num_data, num_space, allow_degenerate_spatial_sharding,
                         allow_unvalidated_bf16, allow_data_axis_divergence)
    check_shape = getattr(model.backbone, "check_shape", None)
    if check_shape is not None:
        check_shape(*image_hw)
    device = world.device
    loss_config, matching_config = resolve_kernel_schedule(loss_config, matching_config, device)
    axis = mesh.space_axis(world, num_space)
    anchors, anchor_index = spatial_anchors(
        image_hw, anchor_config or anchors_lib.AnchorConfig(), axis, device)
    row0, row1 = spatial.rows_of(image_hw[0], num_space, axis.index)
    named = list(model.named_parameters())
    params = [p for _, p in named if p.requires_grad]
    groups = [numerics_lib.group_of(n) for n, p in named if p.requires_grad]
    before = flat = None
    if numerics.enabled:
        before = [torch.empty_like(p) for p in params]
        flat = torch.empty(sum(p.numel() for p in params), dtype=params[0].dtype, device=device)

    def step(
        state: TrainState,
        batch: dict[str, Any],
        mark: Callable[[str], None] | None = None,
    ) -> dict[str, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the state holds another model than this step's")
        images = batch["images"]
        if tuple(images.shape[1:3]) != tuple(image_hw):
            raise ValueError(
                f"images {tuple(images.shape)} do not match the step's {image_hw}"
            )
        model.train()
        model.zero_grad(set_to_none=True)
        global_batch = images.shape[0] * num_data
        with spatial.sharded(axis):
            outputs = model(pipeline_lib.normalize_images(images[:, row0:row1]))
            if mark is not None:
                mark("forward")
            with torch.no_grad():
                targets = matching_lib.anchor_targets_compact_spatial(
                    anchors, anchor_index, batch["gt_boxes"], batch["gt_labels"],
                    batch["gt_mask"], axis, matching_config,
                )
                positive = (targets.state == matching_lib.POSITIVE).float()
                image_pos = spatial.psum(positive.sum(dim=-1), axis)
            if mark is not None:
                mark("targets")
            metrics = losses_lib.total_loss_compact(
                outputs["cls_logits"], outputs["box_deltas"], targets.matched_labels,
                targets.box_targets, targets.state, loss_config, image_pos, global_batch,
            )
            if mark is not None:
                mark("loss")
            metrics["loss"].backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        # One all-reduce: the gradients summed over the world, then the loss
        # metrics and the positives (each rank's share sums to the global).
        reduced = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(
            [metrics[k].detach().float() for k in mesh.MEAN_METRICS] + [positive.sum()])])
        world.all_reduce(reduced)
        offset = 0
        with torch.no_grad():
            for g in grads:
                g.copy_(reduced[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
        metrics = dict(zip(mesh.MEAN_METRICS, reduced[offset:offset + 3]))
        metrics["num_pos"] = reduced[offset + 3]
        if mark is not None:
            mark("backward")
        norms = optim.tensor_norms(grads)
        metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(norms))
        if before is not None:
            metrics.update(numerics_lib.step_summary(grads, norms, groups, flat))
            torch._foreach_copy_(before, params)
        state.apply_gradients(metrics["grad_norm"], metrics["loss"])
        with torch.no_grad():
            metrics["param_norm"] = optim.global_norm(params)
            if before is not None:
                metrics[numerics_lib.UPDATE_RATIO] = numerics_lib.update_ratio(
                    before, params, metrics["param_norm"])
        if mark is not None:
            mark("optimizer")
        return {k: v.detach() for k, v in metrics.items()}

    return step
