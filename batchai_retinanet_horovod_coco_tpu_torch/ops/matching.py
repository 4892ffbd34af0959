"""IoU-based anchor→gt target assignment, as the JAX package's
``ops/matching.py``.

Per anchor: IoU ≥ 0.5 positive, < 0.4 negative, in between ignored, plus
the force-match rescue (every real gt with some overlap makes its best
anchor positive).  gt boxes arrive padded to a fixed ``max_gt`` with a
mask; padded rows give IoU 0.  The functions take a leading batch
dimension written out where JAX vmapped: ``anchors`` (A, 4) is shared,
``gt_boxes`` (..., G, 4), ``gt_labels`` and ``gt_mask`` (..., G).

Two points where torch and JAX scatters differ are handled explicitly:

- JAX routes non-forced gts to the out-of-range anchor index A and drops
  them (``mode="drop"``).  Here the scatter has one spare slot at index A
  that is cut off afterwards, so those gts never write.
- Two gts may share a best anchor.  JAX's scatter then keeps the highest
  gt index (the last write); a torch ``index_put_`` with duplicate indices
  is undefined on a card.  The winner is resolved by ``scatter_reduce``
  with ``"amax"`` over gt indices (order-free), then gathered.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops.boxes import (
    BoxCodecConfig,
    encode_boxes,
)
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.iou import pairwise_iou

IGNORE = -1
NEGATIVE = 0
POSITIVE = 1


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    positive_iou: float = 0.5
    negative_iou: float = 0.4
    # Force-match each gt's best anchor even below positive_iou.
    force_match_best: bool = True
    # Anchors a block of the matching kernel (its menu, ops/cuda/matching.py).
    # None: the train step asks the schedule registry (train/step.py::
    # resolve_kernel_schedule); a caller below the step gets the kernel's
    # default.  Every tile gives the same targets.
    tile_a: int | None = None


class AnchorAssignment(NamedTuple):
    matched_gt: torch.Tensor  # (..., A) int32 index into gt rows (0 if unmatched)
    state: torch.Tensor  # (..., A) int32 in {IGNORE, NEGATIVE, POSITIVE}


class CompactTargets(NamedTuple):
    """Targets with the classification one-hot left implicit:
    ``(matched_labels[..., None] == arange(K)) & (state == POSITIVE)``."""

    matched_labels: torch.Tensor  # (..., A) int32 class id of the matched gt
    box_targets: torch.Tensor  # (..., A, 4) encoded deltas (zero unless positive)
    state: torch.Tensor  # (..., A) int32


def _force_winner(forced_target: torch.Tensor, num_anchors: int) -> torch.Tensor:
    """(..., A) int64: the highest gt index force-matched to each anchor, or
    -1.  ``forced_target`` (..., G) holds each gt's anchor, or ``num_anchors``
    for a gt that is not forced; that index lands in a spare slot."""
    lead = forced_target.shape[:-1]
    gt_index = torch.arange(forced_target.shape[-1], device=forced_target.device)
    winner = torch.full((*lead, num_anchors + 1), -1, dtype=torch.int64,
                        device=forced_target.device)
    winner.scatter_reduce_(-1, forced_target, gt_index.expand(forced_target.shape), "amax")
    return winner[..., :num_anchors]


def _finalize_states(
    max_iou: torch.Tensor,
    gt_best_iou: torch.Tensor,
    gt_best_anchor: torch.Tensor,
    gt_mask: torch.Tensor,
    num_anchors: int,
    config: MatchingConfig,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The matching rule from the per-anchor and per-gt IoU reductions,
    shared by the plain and the kernel paths.  Returns ``(state, winner)``:
    ``winner`` (..., A) is the gt force-matched to each anchor or -1 (see
    :func:`_force_winner`), None when force-matching is off."""
    any_gt = gt_mask.any(dim=-1, keepdim=True)
    positive = (max_iou >= config.positive_iou) & any_gt
    negative = max_iou < config.negative_iou
    winner = None
    if config.force_match_best:
        # Padding and gts with no overlap (whose argmax is anchor 0) are
        # not forced: they must not claim anchor 0.
        force = gt_mask & (gt_best_iou > 0.0)
        forced_target = torch.where(force, gt_best_anchor.long(), num_anchors)
        winner = _force_winner(forced_target, num_anchors)
        forced = winner >= 0
        positive = positive | forced
        negative = negative & ~forced
    state = torch.full(max_iou.shape, IGNORE, dtype=torch.int32, device=max_iou.device)
    state = torch.where(negative, NEGATIVE, state)
    state = torch.where(positive, POSITIVE, state)
    return state, winner


def _gather_rows(
    gt_boxes: torch.Tensor, gt_labels: torch.Tensor, index: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """gt box (..., A, 4) f32 and label (..., A) int32 of each anchor's
    gt ``index`` (..., A)."""
    index = index.long()
    boxes = torch.gather(
        gt_boxes.float(), -2, index[..., None].expand(*index.shape, 4)
    )
    labels = torch.gather(gt_labels.to(torch.int32), -1, index)
    return boxes, labels


def assign_anchors(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    config: MatchingConfig = MatchingConfig(),
) -> AnchorAssignment:
    """Assign each of A anchors to one of G (padded) gt boxes; ties go to the
    first maximum, as ``jnp.argmax`` (and ``torch.max``) break them."""
    num_anchors = anchors.shape[0]
    iou = pairwise_iou(anchors, gt_boxes)  # (..., A, G)
    iou = torch.where(gt_mask[..., None, :], iou, 0.0)
    max_iou, matched_gt = iou.max(dim=-1)
    gt_best_iou, gt_best_anchor = iou.max(dim=-2)
    state, winner = _finalize_states(
        max_iou, gt_best_iou, gt_best_anchor, gt_mask, num_anchors, config
    )
    if winner is not None:
        matched_gt = torch.where(winner >= 0, winner, matched_gt)
    return AnchorAssignment(matched_gt=matched_gt.to(torch.int32), state=state)


def anchor_targets_compact(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    matching: MatchingConfig = MatchingConfig(),
    codec: BoxCodecConfig = BoxCodecConfig(),
) -> CompactTargets:
    """Per-anchor targets with integer labels: the plain path.  The JAX
    package's one-hot matmul lookup (a TPU choice) is a gather here."""
    assignment = assign_anchors(anchors, gt_boxes, gt_mask, matching)
    matched_boxes, matched_labels = _gather_rows(gt_boxes, gt_labels, assignment.matched_gt)
    positive = assignment.state == POSITIVE
    box_targets = encode_boxes(anchors, matched_boxes, codec)
    box_targets = torch.where(positive[..., None], box_targets, 0.0)
    return CompactTargets(matched_labels, box_targets, assignment.state)


def finish_fused(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    assigned: tuple[torch.Tensor, ...],
    matching: MatchingConfig = MatchingConfig(),
    codec: BoxCodecConfig = BoxCodecConfig(),
) -> CompactTargets:
    """Targets from the fused assignment's five outputs
    (``ops.cuda.matching.assign_fused``), as the JAX fused branch finishes:
    thresholds, then the force-matched anchors patched with their gt's box
    and label (the kernel's rows reflect the pre-force argmax), then the
    encode."""
    matched_boxes, matched_labels, max_iou, gt_best_iou, gt_best_anchor = assigned
    state, winner = _finalize_states(
        max_iou, gt_best_iou, gt_best_anchor, gt_mask, anchors.shape[0], matching
    )
    if winner is not None:
        forced = winner >= 0
        forced_boxes, forced_labels = _gather_rows(gt_boxes, gt_labels, winner.clamp_min(0))
        matched_boxes = torch.where(forced[..., None], forced_boxes, matched_boxes)
        matched_labels = torch.where(forced, forced_labels, matched_labels)
    positive = state == POSITIVE
    box_targets = encode_boxes(anchors, matched_boxes, codec)
    box_targets = torch.where(positive[..., None], box_targets, 0.0)
    return CompactTargets(matched_labels, box_targets, state)


def anchor_targets_compact_batched(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    matching: MatchingConfig = MatchingConfig(),
    codec: BoxCodecConfig = BoxCodecConfig(),
) -> CompactTargets:
    """The train step's entry point over (B, G, ...) gts.  On a card the
    matching kernel computes the IoU reductions and :func:`finish_fused`
    the rest; on the CPU the plain path runs.  Both give the same targets.
    ``box_targets`` is (B, A, 4)."""
    if gt_boxes.device.type == "cpu":
        matching_cuda.check_tile(matching.tile_a)
        return anchor_targets_compact(anchors, gt_boxes, gt_labels, gt_mask, matching, codec)
    assigned = matching_cuda.assign_fused(
        anchors.float().contiguous(), gt_boxes.float().contiguous(),
        gt_labels.to(torch.int32).contiguous(), gt_mask.contiguous(), matching.tile_a,
    )
    return finish_fused(anchors, gt_boxes, gt_labels, gt_mask, assigned, matching, codec)


def _best_anchor_over_group(
    gt_best_iou: torch.Tensor,
    gt_best_anchor: torch.Tensor,
    anchor_index: torch.Tensor,
    axis,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each gt's best anchor over the whole image, as this rank's
    ``(gt_best_iou, gt_best_anchor)``: the global best IoU and the local
    index where this rank owns the best anchor, else IoU 0 (not forced
    here).

    Trap: ``force_match_best`` is a reduction over the whole image.  A
    rank's first argmax over its own anchors is the lowest global index
    among its local ties (local order is monotone in global order), so the
    group reduces (max IoU, then min global index), the single-device
    argmax's tie rule."""
    from batchai_retinanet_horovod_coco_tpu_torch.parallel import spatial

    local = torch.stack([gt_best_iou.double(), anchor_index[gt_best_anchor.long()].double()])
    ious, index = spatial.all_gather(local, axis).unbind(1)
    best = ious.max(dim=0).values
    winner = torch.where(ious == best, index, float("inf")).min(dim=0).values.long()
    at = torch.searchsorted(anchor_index, winner).clamp_max(anchor_index.numel() - 1)
    owned = anchor_index[at] == winner
    return (torch.where(owned, best.float(), 0.0),
            torch.where(owned, at, 0).to(gt_best_anchor.dtype))


def anchor_targets_compact_spatial(
    anchors: torch.Tensor,
    anchor_index: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    axis,
    matching: MatchingConfig = MatchingConfig(),
    codec: BoxCodecConfig = BoxCodecConfig(),
) -> CompactTargets:
    """The targets of a space rank's own anchors (``anchors`` (A_local, 4),
    their global indices ``anchor_index``, increasing) against the whole
    image's gts: the matching kernel on a card (its plain version on the
    CPU) over this rank's anchors, the per-gt best reduced over the space
    group (:func:`_best_anchor_over_group`), then :func:`finish_fused`, so
    each rank force-matches only the anchors it owns.  Equal to the
    one-process targets at those anchors."""
    assigned = matching_cuda.assign_fused(
        anchors.float().contiguous(), gt_boxes.float().contiguous(),
        gt_labels.to(torch.int32).contiguous(), gt_mask.contiguous(), matching.tile_a,
    )
    if matching.force_match_best:
        *rows, gt_best_iou, gt_best_anchor = assigned
        assigned = (*rows, *_best_anchor_over_group(gt_best_iou, gt_best_anchor, anchor_index,
                                                    axis))
    return finish_fused(anchors, gt_boxes, gt_labels, gt_mask, assigned, matching, codec)
