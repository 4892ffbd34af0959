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
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
from batchai_retinanet_horovod_coco_tpu_torch.obs import numerics as numerics_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh
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
    """
    device = resolve_device(device)
    if model.config.num_classes != num_classes:
        raise ValueError(
            f"the model has {model.config.num_classes} classes, the step {num_classes}"
        )
    anchors = detect_lib.anchors_on(image_hw, anchor_config or anchors_lib.AnchorConfig(), device)
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
