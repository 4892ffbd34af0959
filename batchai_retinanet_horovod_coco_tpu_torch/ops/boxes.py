"""Box encoding, decoding and clipping, as the JAX package's ``ops/boxes.py``.

Center-form deltas (dx, dy, dw, dh) with normalization stds; decoding
clamps dw/dh with a max only, at ``log(1000/16)``.  The JAX package's
coordinate-planar encode, the (B, 4, A) targets of its NHWC loss path, is
a TPU lane layout of the same values and is not carried over.
"""

from __future__ import annotations

import dataclasses

import torch

from batchai_retinanet_horovod_coco_tpu_torch.utils.device import constant


@dataclasses.dataclass(frozen=True)
class BoxCodecConfig:
    means: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    stds: tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # Clamp on dw/dh before exp, to keep decode finite for garbage logits.
    max_log_scale: float = 4.135  # log(1000/16), detectron convention


def _to_center_form(boxes: torch.Tensor) -> tuple[torch.Tensor, ...]:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return cx, cy, w, h


def encode_boxes(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    config: BoxCodecConfig = BoxCodecConfig(),
) -> torch.Tensor:
    """Regression targets for ``gt_boxes`` w.r.t. ``anchors``; both (..., 4).
    Widths and heights are floored at 1e-6 (padded boxes; callers mask
    them), and the log takes the ratio: ``log(gw / aw)``, as JAX does."""
    acx, acy, aw, ah = _to_center_form(anchors)
    gcx, gcy, gw, gh = _to_center_form(gt_boxes)
    aw = torch.clamp_min(aw, 1e-6)
    ah = torch.clamp_min(ah, 1e-6)
    gw = torch.clamp_min(gw, 1e-6)
    gh = torch.clamp_min(gh, 1e-6)
    deltas = torch.stack(
        [(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw), torch.log(gh / ah)],
        dim=-1,
    )
    means = constant(config.means, deltas.dtype, deltas.device)
    stds = constant(config.stds, deltas.dtype, deltas.device)
    return (deltas - means) / stds


def decode_boxes(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    config: BoxCodecConfig = BoxCodecConfig(),
) -> torch.Tensor:
    """(..., 4) regression deltas relative to ``anchors`` → corner boxes."""
    means = constant(config.means, deltas.dtype, deltas.device)
    stds = constant(config.stds, deltas.dtype, deltas.device)
    deltas = deltas * stds + means
    acx, acy, aw, ah = _to_center_form(anchors)
    dx, dy, dw, dh = deltas.unbind(-1)
    dw = torch.clamp_max(dw, config.max_log_scale)
    dh = torch.clamp_max(dh, config.max_log_scale)
    cx = acx + dx * aw
    cy = acy + dy * ah
    w = aw * torch.exp(dw)
    h = ah * torch.exp(dh)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def clip_boxes(boxes: torch.Tensor, image_hw: tuple[int, int]) -> torch.Tensor:
    """Clip corner boxes to [0, W] x [0, H]."""
    h, w = image_hw
    x1 = torch.clamp(boxes[..., 0], 0.0, float(w))
    y1 = torch.clamp(boxes[..., 1], 0.0, float(h))
    x2 = torch.clamp(boxes[..., 2], 0.0, float(w))
    y2 = torch.clamp(boxes[..., 3], 0.0, float(h))
    return torch.stack([x1, y1, x2, y2], dim=-1)
