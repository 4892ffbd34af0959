"""Detection losses, as the JAX package's ``losses.py``: sigmoid focal loss
over non-ignored anchors and smooth-L1 over positive anchors.

Normalization is per image: each image's sum is divided by its own number
of positive anchors (at least 1), then the batch takes the mean.  The train
step uses the compact form (integer labels and a per-anchor state; the
one-hot target is implicit), and on CUDA tensors the focal sums come from
the kernels of ``ops/cuda/focal.cu``.  The JAX package's per-level and NHWC
loss paths (the NHWC one is its default, ``pallas_focal=False``) give the
same values, which ``tests/test_torch_loss_levels.py`` holds this path to.
They are not carried over: on a card this path is the only one, and a
per-level path would come as a hand-written kernel, once a benchmark shows
it faster than this one.

``jax.nn.softplus`` is ``logaddexp(x, 0)``; torch's ``softplus`` returns
``x`` above its threshold of 20 and would differ there, so softplus is
``torch.logaddexp(x, 0)``: the same ``max(x, 0) + log1p(exp(-|x|))``, with
the true derivative at ``x = 0`` (autograd of that formula written out
takes ``|x|' = 0`` there and gets 1 in place of 1/2).
"""

from __future__ import annotations

import dataclasses

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops import matching
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda


@dataclasses.dataclass(frozen=True)
class LossConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    smooth_l1_beta: float = 1.0 / 9.0  # sigma=3 in the reference parametrization
    box_loss_weight: float = 1.0
    # The focal kernels' launch shapes (their menus, ops/cuda/focal.py):
    # groups a forward block, threads a backward block.  None: the train
    # step asks the schedule registry (train/step.py::
    # resolve_kernel_schedule); a caller below the step gets the kernels'
    # defaults.
    focal_fwd_tile_a: int | None = None
    focal_bwd_tile_a: int | None = None


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, x.new_zeros(()))


def _normalize_per_image(
    per_image: torch.Tensor,
    anchor_state: torch.Tensor,
    num_pos: torch.Tensor | None = None,
    batch_size: int | None = None,
) -> torch.Tensor:
    """Mean over images of ``per_image / max(#positive anchors, 1)``.

    A space rank of spatial partitioning holds part of each image's
    anchors: its ``num_pos`` is each image's count summed over the space
    group first (the trap: its own positives would be the wrong
    denominator), and it divides by the global ``batch_size``, so the sum
    of every rank's value is the global loss."""
    if num_pos is None:
        num_pos = (anchor_state == matching.POSITIVE).float().sum(dim=-1)
    per = per_image / torch.clamp_min(num_pos, 1.0)
    return per.mean() if batch_size is None else per.sum() / batch_size


def _focal_elementwise(
    logits: torch.Tensor, targets: torch.Tensor, config: LossConfig
) -> torch.Tensor:
    """Per-element focal terms in the exponential form (f32 in and out):
    ``bce = sp_neg + x - x t`` and ``(1 - p_t)^gamma = exp(-gamma (sp_neg + x t))``
    with ``sp_neg = softplus(-x)``."""
    sp_neg = softplus(-logits)
    xt = logits * targets
    bce = sp_neg + logits - xt
    modulator = torch.exp(-config.focal_gamma * (sp_neg + xt))
    alpha_t = config.focal_alpha * targets + (1.0 - config.focal_alpha) * (1.0 - targets)
    return alpha_t * modulator * bce


def focal_sums(
    cls_logits: torch.Tensor,
    cls_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
) -> torch.Tensor:
    """Per-image focal sums (...,) over non-ignored anchors, no normalizer.
    Computed in f32, or in f64 for f64 logits (a reference for the kernels'
    gradient, whose f32 error is below the f32 autograd's own)."""
    dtype = torch.promote_types(cls_logits.dtype, torch.float32)
    loss = _focal_elementwise(cls_logits.to(dtype), cls_targets.to(dtype), config)
    not_ignored = (anchor_state != matching.IGNORE).to(dtype)
    return (loss * not_ignored[..., None]).sum(dim=(-2, -1))


def focal_sums_compact(
    cls_logits: torch.Tensor,
    matched_labels: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
) -> torch.Tensor:
    """Per-image focal sums from integer labels (implicit one-hot): the
    plain version of the focal kernels."""
    classes = torch.arange(cls_logits.shape[-1], dtype=torch.int32, device=cls_logits.device)
    targets = (anchor_state == matching.POSITIVE)[..., None] & (
        matched_labels.to(torch.int32)[..., None] == classes
    )
    return focal_sums(cls_logits, targets.float(), anchor_state, config)


def focal_loss(
    cls_logits: torch.Tensor,
    cls_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
) -> torch.Tensor:
    """Scalar focal loss from (..., A, K) one-hot targets."""
    return _normalize_per_image(
        focal_sums(cls_logits, cls_targets, anchor_state, config), anchor_state
    )


def focal_loss_compact(
    cls_logits: torch.Tensor,
    matched_labels: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
    num_pos: torch.Tensor | None = None,
    batch_size: int | None = None,
) -> torch.Tensor:
    """Scalar focal loss from integer labels.  The per-image sums come from
    ``ops.cuda.focal.focal_loss_per_image_sums``: the kernels on a card, the
    plain version on the CPU.  Leading dims are flattened into one batch
    dim for it.  ``num_pos`` and ``batch_size``: see
    :func:`_normalize_per_image`."""
    a, k = cls_logits.shape[-2:]
    sums = focal_cuda.focal_loss_per_image_sums(
        cls_logits.reshape(-1, a, k).float().contiguous(),
        matched_labels.to(torch.int32).reshape(-1, a).contiguous(),
        anchor_state.to(torch.int32).reshape(-1, a).contiguous(),
        config.focal_alpha,
        config.focal_gamma,
        config.focal_fwd_tile_a,
        config.focal_bwd_tile_a,
    )
    return _normalize_per_image(sums.reshape(anchor_state.shape[:-1]), anchor_state, num_pos,
                                batch_size)


def _smooth_l1_elementwise(
    preds: torch.Tensor, targets: torch.Tensor, config: LossConfig
) -> torch.Tensor:
    diff = torch.abs(preds - targets)
    beta = config.smooth_l1_beta
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def smooth_l1_sums(
    box_preds: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
) -> torch.Tensor:
    """Per-image smooth-L1 sums (...,) over positive anchors, no normalizer."""
    loss = _smooth_l1_elementwise(box_preds.float(), box_targets.float(), config)
    positive = (anchor_state == matching.POSITIVE).float()
    return (loss * positive[..., None]).sum(dim=(-2, -1))


def smooth_l1_loss(
    box_preds: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
    num_pos: torch.Tensor | None = None,
    batch_size: int | None = None,
) -> torch.Tensor:
    """Scalar smooth-L1 regression loss over positive anchors."""
    return _normalize_per_image(
        smooth_l1_sums(box_preds, box_targets, anchor_state, config), anchor_state, num_pos,
        batch_size,
    )


def total_loss_compact(
    cls_logits: torch.Tensor,
    box_preds: torch.Tensor,
    matched_labels: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
    num_pos: torch.Tensor | None = None,
    batch_size: int | None = None,
) -> dict[str, torch.Tensor]:
    """:func:`total_loss` on compact (integer-label) targets: the step path
    (``num_pos`` and ``batch_size`` for a space rank's share,
    :func:`_normalize_per_image`)."""
    cls = focal_loss_compact(cls_logits, matched_labels, anchor_state, config, num_pos,
                             batch_size)
    box = smooth_l1_loss(box_preds, box_targets, anchor_state, config, num_pos, batch_size)
    return {"loss": cls + config.box_loss_weight * box, "cls_loss": cls, "box_loss": box}


def total_loss(
    cls_logits: torch.Tensor,
    box_preds: torch.Tensor,
    cls_targets: torch.Tensor,
    box_targets: torch.Tensor,
    anchor_state: torch.Tensor,
    config: LossConfig = LossConfig(),
) -> dict[str, torch.Tensor]:
    cls = focal_loss(cls_logits, cls_targets, anchor_state, config)
    box = smooth_l1_loss(box_preds, box_targets, anchor_state, config)
    return {"loss": cls + config.box_loss_weight * box, "cls_loss": cls, "box_loss": box}
