"""PASCAL-VOC-style detection mAP, as the JAX package's
``evaluate/voc_eval.py``: per-class average precision at one IoU threshold
(default 0.5) with all-point interpolation, over the same COCO-format gt
and detection dicts as the COCO oracle, so that either metric runs off one
detection pass.

- detections per class sorted by descending score; greedy matching, each
  gt box claimable once; a detection whose best IoU ≥ threshold against an
  unclaimed gt is a TP, everything else (including a second detection of a
  claimed gt) is an FP;
- AP = the sum over recall steps of the monotone precision envelope;
- classes with no ground truth are left out of the mean and of the
  per-class output;
- ``weighted_average`` weights the mean by each class's annotation count;
- ``iscrowd=1`` ground truth is an ignore region: it never counts as an
  annotation, and a detection whose max-overlap match over all boxes is an
  ignore box at ≥ threshold is neither TP nor FP.
"""

from __future__ import annotations

import numpy as np


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP from monotone-enveloped precision."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    # Monotone non-increasing envelope, right to left.
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    # Sum precision over the recall steps where recall changes.
    idx = np.flatnonzero(mrec[1:] != mrec[:-1])
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_matrix(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU of corner boxes, (D,4) x (G,4) → (D,G)."""
    ix1 = np.maximum(dt[:, None, 0], gt[None, :, 0])
    iy1 = np.maximum(dt[:, None, 1], gt[None, :, 1])
    ix2 = np.minimum(dt[:, None, 2], gt[None, :, 2])
    iy2 = np.minimum(dt[:, None, 3], gt[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _to_corners(bbox: list[float]) -> list[float]:
    x, y, w, h = bbox
    return [x, y, x + w, y + h]


def evaluate_detections_voc(
    gt: list[dict],
    dt: list[dict],
    iou_threshold: float = 0.5,
    weighted_average: bool = False,
) -> dict[str, float]:
    """VOC mAP over COCO-format gt annotations and detection results.

    Input dicts use the same schema as the COCO oracle
    (``evaluate/coco_eval.py``): gt has image_id/category_id/bbox
    [x,y,w,h]/iscrowd; dt adds score.  Returns ``{"voc_mAP": float,
    "voc_AP_<cat>": float per class with annotations}``.
    """
    gt_by_class: dict[int, dict[int, np.ndarray]] = {}
    ignore_by_class: dict[int, dict[int, np.ndarray]] = {}
    counts: dict[int, int] = {}
    for ann in gt:
        cat, img = int(ann["category_id"]), int(ann["image_id"])
        if ann.get("iscrowd", 0):
            ignore_by_class.setdefault(cat, {}).setdefault(img, []).append(
                _to_corners(ann["bbox"])
            )
            continue
        gt_by_class.setdefault(cat, {}).setdefault(img, []).append(
            _to_corners(ann["bbox"])
        )
        counts[cat] = counts.get(cat, 0) + 1
    for table in (gt_by_class, ignore_by_class):
        for per_img in table.values():
            for img, boxes in per_img.items():
                per_img[img] = np.asarray(boxes, dtype=np.float64)

    dt_by_class: dict[int, list[dict]] = {}
    for det in dt:
        dt_by_class.setdefault(int(det["category_id"]), []).append(det)

    aps: dict[int, tuple[float, int]] = {}
    for cat, num_ann in counts.items():
        dets = sorted(
            dt_by_class.get(cat, ()), key=lambda d: -float(d["score"])
        )
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        claimed: dict[int, np.ndarray] = {}
        cat_ignore = ignore_by_class.get(cat, {})
        for i, det in enumerate(dets):
            img = int(det["image_id"])
            dbox = np.asarray([_to_corners(det["bbox"])], dtype=np.float64)
            boxes = gt_by_class[cat].get(img)
            n_real = 0 if boxes is None else len(boxes)
            real_ious = (
                _iou_matrix(dbox, boxes)[0] if n_real else np.zeros(0)
            )
            ign = cat_ignore.get(img)
            ign_max = (
                float(_iou_matrix(dbox, ign).max())
                if ign is not None and len(ign)
                else -1.0
            )
            # VOC devkit rule: assign to the max-overlap gt over ALL boxes,
            # difficult included.  Winner difficult (≥ threshold) → neither
            # TP nor FP (tp=fp=0 leaves both cumsums — hence precision and
            # recall at every other rank — unchanged, equivalent to
            # removal).  Winner real → TP if unclaimed, else FP (a
            # duplicate of a claimed box is an FP even if a difficult box
            # also overlaps it, because the real box overlaps MORE).
            j = int(np.argmax(real_ious)) if n_real else -1
            best_real = float(real_ious[j]) if n_real else -1.0
            if ign_max >= iou_threshold and ign_max > best_real:
                continue
            if best_real >= iou_threshold:
                taken = claimed.setdefault(img, np.zeros(n_real, bool))
                if not taken[j]:
                    taken[j] = True
                    tp[i] = 1
                    continue
            fp[i] = 1
        ctp, cfp = np.cumsum(tp), np.cumsum(fp)
        recall = ctp / num_ann
        precision = ctp / np.maximum(ctp + cfp, 1e-12)
        aps[cat] = (compute_ap(recall, precision), num_ann)

    out: dict[str, float] = {}
    if aps:
        values = np.array([ap for ap, _ in aps.values()])
        weights = np.array([n for _, n in aps.values()], dtype=np.float64)
        if weighted_average:
            out["voc_mAP"] = float(np.sum(values * weights) / np.sum(weights))
        else:
            out["voc_mAP"] = float(values.mean())
    else:
        out["voc_mAP"] = 0.0
    for cat, (ap, _) in sorted(aps.items()):
        out[f"voc_AP_{cat}"] = ap
    return out
