"""The train step, as the JAX package's ``train/step.py``
(``_forward_and_loss`` and the step bodies of ``make_train_step``): on one
device, or as one rank of a data-parallel world (the ``shard_map`` +
``pmean`` step over the ``data`` axis).

The path is the one the JAX package takes with its fused kernels on:
the head outputs concatenated to (B, A, K), targets from
``anchor_targets_compact_batched`` (the matching kernel on a card) under
``torch.no_grad()``, and ``total_loss_compact`` (the focal kernels on a
card).  The step records the pre-clip global gradient norm, which the clip
reuses, and the post-update parameter norm; with ``numerics`` enabled, the
numerics summary of ``obs/numerics.py`` too.

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
"""

from __future__ import annotations

import warnings
from collections.abc import Callable
from typing import Any

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
from batchai_retinanet_horovod_coco_tpu_torch.parallel import zero as zero_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.train.state import TrainState
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

#: The step's phases, in order; a step called with ``mark`` calls
#: ``mark(name)`` as each one ends.
PHASES = ("forward", "targets", "loss", "backward", "optimizer")


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
