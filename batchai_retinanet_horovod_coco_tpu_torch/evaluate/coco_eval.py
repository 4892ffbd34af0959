"""COCO detection mAP: pycocotools ``COCOeval`` bbox semantics, as the JAX
package's ``evaluate/coco_eval.py``.  The pairwise IoU and the greedy
matching run in the C++ helper ``native/cocoeval.cpp``
(``evaluate/_native.py``), off the interpreter lock; the numpy functions
``numpy_bbox_iou_xywh`` and ``numpy_match_detections`` are its oracle,
bit for bit, and are not a fallback.

- IoU thresholds 0.50:0.05:0.95 (10), recall thresholds 0:0.01:1 (101-point
  interpolated AP), maxDets [1, 10, 100];
- area ranges all/small/medium/large = [0,1e10]/[0,32²]/[32²,96²]/[96²,1e10];
- greedy per-image per-category matching in descending score order, each
  detection taking the best still-unmatched gt with IoU ≥ threshold,
  crowd/out-of-range gts matchable but marked ignore;
- monotone precision envelope + searchsorted sampling at the 101 recall
  points; AP = mean over classes and IoU thresholds of sampled precision.

Inputs are plain lists of dicts in COCO annotation/result format.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.evaluate import _native


@dataclasses.dataclass
class EvalParams:
    """Mirror of pycocotools ``Params(iouType='bbox')`` defaults."""

    iou_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.5, 0.95, 10)
    )
    rec_thrs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.linspace(0.0, 1.0, 101)
    )
    max_dets: tuple[int, ...] = (1, 10, 100)
    area_rng: tuple[tuple[float, float], ...] = (
        (0.0, 1e10),
        (0.0, 32.0**2),
        (32.0**2, 96.0**2),
        (96.0**2, 1e10),
    )
    area_rng_lbl: tuple[str, ...] = ("all", "small", "medium", "large")


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes, crowd-aware, by the native helper
    (``numpy_bbox_iou_xywh`` is its oracle)."""
    return _native.bbox_iou_xywh(dt, gt, iscrowd)


def numpy_bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes, crowd-aware (COCO ``maskUtils.iou`` bbox path).

    For a crowd gt the denominator is the detection area alone (a detection
    inside a crowd region counts as fully covered).
    Shapes: dt (D, 4), gt (G, 4) → (D, G).
    """
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), dtype=np.float64)
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0.0,
        None,
    )
    ih = np.clip(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0.0,
        None,
    )
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :].astype(bool), d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def match_detections(
    ious: np.ndarray,
    iou_thrs: np.ndarray,
    g_ignore: np.ndarray,
    g_crowd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The greedy matcher by the native helper (``numpy_match_detections``
    is its oracle)."""
    return _native.match_detections(ious, iou_thrs, g_ignore, g_crowd)


def numpy_match_detections(
    ious: np.ndarray,
    iou_thrs: np.ndarray,
    g_ignore: np.ndarray,
    g_crowd: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The greedy matcher (COCOeval ``evaluateImg``'s core).

    Dets must be score-sorted, gts ignore-sorted (non-ignored first), the
    layout ``CocoEval._evaluate_img`` establishes.  Returns
    (dtm (T, D), gtm (T, G), dt_ignore (T, D)).
    """
    D, G = ious.shape
    T = len(iou_thrs)
    gtm = -np.ones((T, G), dtype=np.int64)  # index of matching det
    dtm = -np.ones((T, D), dtype=np.int64)  # index of matching gt
    dt_ignore = np.zeros((T, D), dtype=bool)

    for t, thr in enumerate(iou_thrs):
        for dind in range(D):
            best = min(thr, 1.0 - 1e-10)
            m = -1
            for gind in range(G):
                # Gt already claimed at this threshold (crowds may rematch).
                if gtm[t, gind] >= 0 and not g_crowd[gind]:
                    continue
                # Gts are sorted ignore-last: once we have a real match,
                # stop before the ignore region.
                if m > -1 and not g_ignore[m] and g_ignore[gind]:
                    break
                if ious[dind, gind] < best:
                    continue
                best = ious[dind, gind]
                m = gind
            if m == -1:
                continue
            dtm[t, dind] = m
            gtm[t, m] = dind
            dt_ignore[t, dind] = g_ignore[m]
    return dtm, gtm, dt_ignore


class CocoEval:
    """bbox-only COCOeval: ``evaluate() → accumulate() → summarize()``.

    ``gt_anns``: COCO annotation dicts (image_id, category_id, bbox xywh,
    area, iscrowd, optional ignore).  ``dt_anns``: COCO result dicts
    (image_id, category_id, bbox xywh, score).  ``img_ids`` fixes the
    evaluated image set (images with no gt still contribute false positives,
    as in pycocotools when the gt index knows the image).
    """

    def __init__(
        self,
        gt_anns: list[dict],
        dt_anns: list[dict],
        img_ids: list[int] | None = None,
        params: EvalParams | None = None,
    ):
        self.params = params or EvalParams()
        # ``_prepare`` caches per (img, cat) with dets truncated at
        # max_dets[-1]; ``accumulate`` then re-slices ``[:max_det]`` per M
        # entry.  Both steps (like pycocotools itself) are only correct when
        # max_dets is ascending — reject the silent-wrong-scores case.
        if list(self.params.max_dets) != sorted(self.params.max_dets):
            raise ValueError(
                f"EvalParams.max_dets must be ascending, got "
                f"{list(self.params.max_dets)}"
            )
        if img_ids is None:
            img_ids = sorted(
                {a["image_id"] for a in gt_anns} | {a["image_id"] for a in dt_anns}
            )
        self.img_ids = list(img_ids)
        self.cat_ids = sorted(
            {a["category_id"] for a in gt_anns} | {a["category_id"] for a in dt_anns}
        )

        self._gts: dict[tuple[int, int], list[dict]] = {}
        self._dts: dict[tuple[int, int], list[dict]] = {}
        img_set = set(self.img_ids)
        for a in gt_anns:
            if a["image_id"] in img_set:
                self._gts.setdefault((a["image_id"], a["category_id"]), []).append(a)
        for a in dt_anns:
            if a["image_id"] in img_set:
                self._dts.setdefault((a["image_id"], a["category_id"]), []).append(a)

        self.eval_imgs: dict[tuple[int, int, int], dict | None] = {}
        self._prepared: dict[tuple[int, int], tuple | None] = {}
        self.eval: dict = {}
        self.stats = np.zeros(12)

    # -- evaluate ----------------------------------------------------------

    def _prepare(self, img_id: int, cat_id: int, max_det: int) -> tuple | None:
        """Score-sort dets and compute the IoU matrix ONCE per (img, cat).

        The result is shared by all four area ranges (pycocotools'
        ``computeIoU`` cache); ious are in (score-sorted det) × (original gt)
        order.
        """
        key = (img_id, cat_id)
        if key in self._prepared:
            return self._prepared[key]
        gt = self._gts.get(key, [])
        dt = self._dts.get(key, [])
        if not gt and not dt:
            self._prepared[key] = None
            return None
        d_scores = np.array([d["score"] for d in dt], dtype=np.float64)
        d_order = np.argsort(-d_scores, kind="stable")[:max_det]
        dt = [dt[i] for i in d_order]
        g_boxes = np.array([g["bbox"] for g in gt], dtype=np.float64).reshape(-1, 4)
        d_boxes = np.array([d["bbox"] for d in dt], dtype=np.float64).reshape(-1, 4)
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gt], dtype=bool)
        ious = bbox_iou_xywh(d_boxes, g_boxes, g_crowd)
        prepared = (gt, dt, d_boxes, ious)
        self._prepared[key] = prepared
        return prepared

    def _evaluate_img(
        self, img_id: int, cat_id: int, area_rng: tuple[float, float], max_det: int
    ) -> dict | None:
        p = self.params
        prepared = self._prepare(img_id, cat_id, max_det)
        if prepared is None:
            return None
        gt, dt, d_boxes, ious_raw = prepared

        g_ignore = np.array(
            [
                bool(g.get("ignore", 0))
                or bool(g.get("iscrowd", 0))
                or g["area"] < area_rng[0]
                or g["area"] > area_rng[1]
                for g in gt
            ],
            dtype=bool,
        )
        # Non-ignored gts first (stable), matching pycocotools' argsort.
        g_order = np.argsort(g_ignore, kind="stable")
        gt = [gt[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        g_crowd = np.array([bool(g.get("iscrowd", 0)) for g in gt], dtype=bool)
        ious = ious_raw[:, g_order] if len(gt) else ious_raw

        D, G = len(dt), len(gt)
        iou_thrs = np.asarray(p.iou_thrs, dtype=np.float64)
        dtm, gtm, dt_ignore = match_detections(
            np.asarray(ious, dtype=np.float64).reshape(D, G), iou_thrs, g_ignore, g_crowd
        )

        # Unmatched dets whose own area is outside the range are ignored too.
        d_area = d_boxes[:, 2] * d_boxes[:, 3]
        d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
        dt_ignore |= (dtm == -1) & d_out[None, :]

        return {
            "dt_scores": np.array([d["score"] for d in dt], dtype=np.float64),
            "dt_matched": dtm >= 0,
            "dt_ignore": dt_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    def evaluate_image(self, img_id: int) -> None:
        """Fill ``eval_imgs`` for ONE image across all (category, area)
        cells — the unit both ``evaluate`` and the streaming scorer
        (``StreamingCocoEval``) are built from, so their matching can
        never diverge."""
        p = self.params
        max_det = p.max_dets[-1]
        for c, cat_id in enumerate(self.cat_ids):
            for a, area_rng in enumerate(p.area_rng):
                self.eval_imgs[(c, a, img_id)] = self._evaluate_img(
                    img_id, cat_id, area_rng, max_det
                )

    def evaluate(self) -> None:
        for img_id in self.img_ids:
            self.evaluate_image(img_id)

    # -- accumulate --------------------------------------------------------

    def accumulate(self) -> None:
        p = self.params
        T, R = len(p.iou_thrs), len(p.rec_thrs)
        K, A, M = len(self.cat_ids), len(p.area_rng), len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k in range(K):
            for a in range(A):
                imgs = [
                    e
                    for img_id in self.img_ids
                    if (e := self.eval_imgs.get((k, a, img_id))) is not None
                ]
                if not imgs:
                    continue
                for m, max_det in enumerate(p.max_dets):
                    scores = np.concatenate([e["dt_scores"][:max_det] for e in imgs])
                    # Stable global sort by descending score (mergesort, as
                    # in pycocotools, keeps cross-refactor determinism).
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["dt_matched"][:, :max_det] for e in imgs], axis=1
                    )[:, order]
                    ignored = np.concatenate(
                        [e["dt_ignore"][:, :max_det] for e in imgs], axis=1
                    )[:, order]
                    npig = sum(e["num_gt"] for e in imgs)
                    if npig == 0:
                        continue
                    tps = np.cumsum(matched & ~ignored, axis=1, dtype=np.float64)
                    fps = np.cumsum(~matched & ~ignored, axis=1, dtype=np.float64)
                    for t in range(T):
                        tp, fp = tps[t], fps[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0.0
                        # Monotone envelope: precision at recall r is the max
                        # precision at any recall ≥ r.
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        inds = np.searchsorted(rc, p.rec_thrs, side="left")
                        q = np.zeros(R)
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[t, :, k, a, m] = q

        self.eval = {"precision": precision, "recall": recall}

    # -- summarize ---------------------------------------------------------

    def _summarize(
        self,
        ap: bool,
        iou_thr: float | None = None,
        area: str = "all",
        max_dets: int = 100,
    ) -> float:
        p = self.params
        a = p.area_rng_lbl.index(area)
        m = p.max_dets.index(max_dets)
        if ap:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, a, m]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, a, m]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> np.ndarray:
        """The 12 standard COCO stats; stats[0] is mAP@[.5:.95]."""
        self.stats = np.array(
            [
                self._summarize(True),
                self._summarize(True, iou_thr=0.5),
                self._summarize(True, iou_thr=0.75),
                self._summarize(True, area="small"),
                self._summarize(True, area="medium"),
                self._summarize(True, area="large"),
                self._summarize(False, max_dets=1),
                self._summarize(False, max_dets=10),
                self._summarize(False, max_dets=100),
                self._summarize(False, area="small"),
                self._summarize(False, area="medium"),
                self._summarize(False, area="large"),
            ]
        )
        return self.stats


_STAT_NAMES = (
    "AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge",
    "AR1", "AR10", "AR100", "ARsmall", "ARmedium", "ARlarge",
)


class StreamingCocoEval:
    """Incremental ``CocoEval``: feed detections batch-by-batch as they
    come off the device; the per-image greedy matching (the dominant host
    cost of an eval pass — O(images × categories × thresholds) of
    numpy/C++ work) runs AS SOON AS an image's detections are complete,
    instead of all at once after the last batch.  The pipelined
    ``run_coco_eval`` (evaluate/detect.py) runs this inside its consumer
    thread, overlapping scoring with the device work of later batches.

    Result-identical to the one-shot path, by construction: per-image
    evaluation is independent across images (``_evaluate_img`` touches only
    that image's annotations), and ``finish()`` runs the exact same
    ``accumulate``/``summarize`` over the same ``eval_imgs`` table.  The
    category list may be a SUPERSET of the categories that end up appearing
    (it must be fixed before matching starts): categories with neither gt
    nor detections evaluate to ``None`` everywhere and are excluded by
    ``accumulate``/``summarize`` exactly as absent categories are, so the
    stats match ``evaluate_detections`` bit-for-bit.

    Contract: ``add(dts, done_img_ids)`` marks images COMPLETE — every
    detection for those images must be in this or an earlier call (the
    eval pipeline satisfies this trivially: each image lives in exactly one
    batch).  Detections for images already marked done are rejected loudly
    rather than silently dropped from the score.
    """

    def __init__(
        self,
        gt_anns: list[dict],
        img_ids: list[int],
        cat_ids: list[int] | None = None,
        params: EvalParams | None = None,
    ):
        self._ev = CocoEval(gt_anns, [], img_ids=img_ids, params=params)
        if cat_ids is not None:
            self._ev.cat_ids = sorted(set(self._ev.cat_ids) | set(cat_ids))
        self._img_set = set(self._ev.img_ids)
        self._done: set[int] = set()
        self._finished = False

    def add(self, dt_anns: list[dict], done_img_ids) -> None:
        """Register a batch of detections and match the completed images."""
        if self._finished:
            raise RuntimeError("add() after finish()")
        for a in dt_anns:
            img_id = a["image_id"]
            if img_id not in self._img_set:
                continue
            if img_id in self._done:
                raise ValueError(
                    f"detections for image {img_id} arrived after it was "
                    "marked complete — they would be silently excluded "
                    "from the score"
                )
            self._ev._dts.setdefault((img_id, a["category_id"]), []).append(a)
        for img_id in done_img_ids:
            img_id = int(img_id)
            if img_id in self._done or img_id not in self._img_set:
                continue
            self._ev.evaluate_image(img_id)
            self._done.add(img_id)

    def finish(self) -> dict[str, float]:
        """Match remaining images (gt-only / never streamed), then
        accumulate + summarize → the same named stats dict as
        ``evaluate_detections``."""
        if not self._finished:
            for img_id in self._ev.img_ids:
                if img_id not in self._done:
                    self._ev.evaluate_image(img_id)
                    self._done.add(img_id)
            self._ev.accumulate()
            self._ev.summarize()
            self._finished = True
        return dict(zip(_STAT_NAMES, (float(s) for s in self._ev.stats)))


def evaluate_detections(
    gt_anns: list[dict],
    dt_anns: list[dict],
    img_ids: list[int] | None = None,
) -> dict[str, float]:
    """One-call evaluate/accumulate/summarize → named stats dict."""
    ev = CocoEval(gt_anns, dt_anns, img_ids=img_ids)
    ev.evaluate()
    ev.accumulate()
    stats = ev.summarize()
    return dict(zip(_STAT_NAMES, (float(s) for s in stats)))
