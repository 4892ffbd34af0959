"""The native COCOeval helper (``native/cocoeval.cpp`` through
``evaluate/_native.py``) against its numpy oracle in
``evaluate/coco_eval.py``: the IoU matrix, the greedy matching, and the
COCO stats of a whole ``evaluate_detections``, bit for bit (no tolerance),
on random, empty, zero-area, crowd and tied inputs.  The JAX package's
``evaluate_detections`` (its numpy path) is the reference for the stats.
"""

import numpy as np
import pytest

from batchai_retinanet_horovod_coco_tpu.evaluate import coco_eval as j_coco_eval
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import _native
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import coco_eval as t_coco_eval

THRESHOLDS = np.linspace(0.5, 0.95, 10)


def boxes(rng, n: int, zero_area: float = 0.0) -> np.ndarray:
    """xywh boxes on a coarse grid (exact ties), some of zero width or height."""
    xy = rng.integers(0, 40, (n, 2)) * 2.5
    wh = rng.integers(1, 30, (n, 2)) * 2.5
    wh[rng.random((n, 2)) < zero_area] = 0.0
    return np.concatenate([xy, wh], 1).astype(np.float64)


CASES = {
    "random": dict(d=37, g=11, zero_area=0.0, crowd=0.2),
    "zero-area": dict(d=23, g=9, zero_area=0.3, crowd=0.3),
    "no-detections": dict(d=0, g=7, zero_area=0.0, crowd=0.0),
    "no-gts": dict(d=9, g=0, zero_area=0.0, crowd=0.0),
    "both-empty": dict(d=0, g=0, zero_area=0.0, crowd=0.0),
    "one-by-one": dict(d=1, g=1, zero_area=0.0, crowd=1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_helper_equals_the_numpy_oracle(case):
    c = CASES[case]
    for seed in range(5):
        rng = np.random.default_rng(seed)
        dt, gt = boxes(rng, c["d"], c["zero_area"]), boxes(rng, c["g"], c["zero_area"])
        crowd = rng.random(c["g"]) < c["crowd"]
        got = _native.bbox_iou_xywh(dt, gt, crowd)
        want = t_coco_eval.numpy_bbox_iou_xywh(dt, gt, crowd)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape == (c["d"], c["g"])
        assert np.array_equal(got, want)
        ignore = np.sort(rng.random(c["g"]) < 0.3)  # ignore-sorted, as the caller lays them out
        for a, b in zip(_native.match_detections(got, THRESHOLDS, ignore, crowd),
                        t_coco_eval.numpy_match_detections(want, THRESHOLDS, ignore, crowd), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert t_coco_eval.bbox_iou_xywh is not t_coco_eval.numpy_bbox_iou_xywh


def annotations(seed: int, num_images: int = 12):
    """Seeded COCO gts and detections: crowds, three area ranges, an image
    without gts and one without detections, some zero-area boxes."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(1, num_images + 1):
        placed = []
        for _ in range(0 if img == 2 else int(rng.integers(1, 10))):
            side = rng.choice([rng.uniform(6, 30), rng.uniform(35, 90), rng.uniform(100, 250)])
            w, h = side * rng.uniform(0.6, 1.4, 2)
            x, y = rng.uniform(0, 400, 2)
            cat = int(rng.integers(1, 4))
            gts.append({"id": len(gts) + 1, "image_id": img, "category_id": cat, "bbox": [x, y, w, h],
                        "area": float(w * h), "iscrowd": int(rng.random() < 0.15)})
            placed.append((cat, (x, y, w, h)))
        for _ in range(0 if img == 3 else int(rng.integers(20, 120))):
            if placed and rng.random() < 0.5:
                cat, (x, y, w, h) = placed[int(rng.integers(len(placed)))]
                bbox = [x, y, w, h] + rng.normal(0, 0.1, 4) * [w, h, w, h]
            else:
                cat, bbox = int(rng.integers(1, 4)), [*rng.uniform(0, 400, 2), *rng.uniform(0, 150, 2)]
            if rng.random() < 0.03:
                bbox[2] = 0.0
            dts.append({"image_id": img, "category_id": cat, "bbox": [float(v) for v in bbox],
                        "score": float(np.round(rng.random(), 2))})  # rounded: tied scores
    return gts, dts, list(range(1, num_images + 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_detections_equals_the_oracle(seed, monkeypatch):
    gts, dts, img_ids = annotations(seed)
    got = t_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    want_jax = j_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    monkeypatch.setattr(t_coco_eval, "bbox_iou_xywh", t_coco_eval.numpy_bbox_iou_xywh)
    monkeypatch.setattr(t_coco_eval, "match_detections", t_coco_eval.numpy_match_detections)
    want = t_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    assert got == want  # bit for bit, every stat
    assert got == {k: float(v) for k, v in want_jax.items()}
    assert 0.0 < got["AP50"] < 1.0
