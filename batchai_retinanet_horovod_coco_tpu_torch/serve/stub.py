"""The stub engine: serve machinery without device work; the JAX package's
``serve/stub.py`` over the port's ``IdentityLabelMap``.

One fixed detection per batch row, an optional per-dispatch delay, and a
record of dispatched batch sizes — everything the queue, batcher and
frontend machinery needs to run for real while the "device" costs nothing.
The fleet's subprocess stub replicas (``python -m
batchai_retinanet_horovod_coco_tpu_torch.serve --stub-engine``) and the
tests serve it; it needs no card.

The fixed detection round-trips ``detections_to_coco`` exactly:
``EXPECTED_DETECTIONS`` is what any 64x64 request served through a stub
engine comes back as.
"""

from __future__ import annotations

import time  # the injected dispatch delay only

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import IdentityLabelMap


class StubDetections:
    """Duck-typed Detections (boxes/scores/labels/valid attrs)."""

    def __init__(self, boxes, scores, labels, valid):
        self.boxes, self.scores, self.labels = boxes, scores, labels
        self.valid = valid


#: What one stub-served 64x64 request resolves to, after the shared
#: ``detections_to_coco`` conversion (xyxy → xywh, clamped).
EXPECTED_DETECTIONS = [
    {"category_id": 0, "bbox": [1.0, 2.0, 9.0, 18.0], "score": 0.5}
]


class StubDetectEngine:
    """One fixed detection per row; records dispatched batch sizes.

    ``delay_s`` makes the "device" slow enough that bounded queues shed
    under an open-loop flood or that a canary's p99 visibly regresses.
    """

    min_side = 64
    max_side = 64
    buckets = ((64, 64),)
    label_to_cat_id = IdentityLabelMap()
    source = "stub"

    def __init__(
        self,
        batch_sizes: tuple[int, ...] = (4,),
        delay_s: float = 0.0,
        version: str = "stub",
        video: bool = False,
    ):
        self._sizes = sorted(batch_sizes)
        self.delay_s = delay_s
        self.version = version
        self.video = video
        self.dispatched: list[int] = []

    def batch_sizes(self, hw):
        return list(self._sizes)

    def max_batch(self, hw):
        return self._sizes[-1]

    def batch_size_for(self, hw, n):
        for b in self._sizes:
            if b >= n:
                return b
        return self._sizes[-1]

    def warmup(self):
        pass

    def dispatch(self, hw, images):
        if self.delay_s:
            # The injected "device time" — a plain sleep, deliberately
            # not the obs clock (nothing here is a timestamp).
            time.sleep(self.delay_s)
        b = images.shape[0]
        self.dispatched.append(b)
        if self.video:
            return self._dispatch_video(images)
        boxes = np.tile(
            np.array([[[1.0, 2.0, 10.0, 20.0]]], np.float32), (b, 1, 1)
        )
        return StubDetections(
            boxes,
            np.full((b, 1), 0.5, np.float32),
            np.zeros((b, 1), np.int32),
            np.ones((b, 1), bool),
        )

    def _dispatch_video(self, images):
        """Video mode: each row's boxes are a pure function of THAT ROW's
        pixels (mean brightness → box offset), so serving a
        ``drift_frames`` sequence yields deterministic, smoothly drifting
        boxes however rows land in batches.  Two boxes per row with
        distinct categories give the track stitcher a real 2×2 matching
        problem every frame."""
        b = images.shape[0]
        boxes = np.zeros((b, 2, 4), np.float32)
        for r in range(b):
            m = np.float32(images[r].mean())
            dx = m * np.float32(0.2)  # ≤ ~36px inside the 64px bucket
            dy = m * np.float32(0.1)
            boxes[r, 0] = [1.0 + dx, 2.0 + dx, 10.0 + dx, 20.0 + dx]
            boxes[r, 1] = [30.0 + dy, 28.0 + dy, 44.0 + dy, 50.0 + dy]
        return StubDetections(
            np.clip(boxes, 0.0, 64.0),
            np.tile(np.array([[0.5, 0.4]], np.float32), (b, 1)),
            np.tile(np.array([[0, 1]], np.int32), (b, 1)),
            np.ones((b, 2), bool),
        )

    def fetch(self, det):
        return det


def drift_frames(
    seed: int = 0,
    n: int = 30,
    hw: tuple[int, int] = (64, 64),
    step: float = 1.0,
    cut_every: int = 0,
) -> list[np.ndarray]:
    """A seeded synthetic video: ``n`` uniform-brightness HWC uint8 frames
    whose value drifts by ``step`` per frame (so the mean-abs pixel delta
    between consecutive frames is ≈ ``step`` — the delta cache's hit/miss
    dial), with an optional hard "scene cut" every ``cut_every`` frames (a
    large jump: a cache miss AND a track break).  Pure function of
    ``seed``."""
    rng = np.random.default_rng(seed)
    v = float(rng.integers(30, 90))
    frames = []
    for i in range(n):
        if cut_every and i and i % cut_every == 0:
            # Jump to the opposite brightness band: the cut's delta is
            # ≥ 30 counts no matter where the drift had wandered.
            if v < 100.0:
                v = float(rng.integers(130, 170))
            else:
                v = float(rng.integers(10, 50))
        elif i:
            v += step
        v = min(175.0, max(10.0, v))
        frames.append(
            np.full((hw[0], hw[1], 3), int(round(v)), np.uint8)
        )
    return frames


__all__ = [
    "EXPECTED_DETECTIONS",
    "StubDetectEngine",
    "StubDetections",
    "drift_frames",
]
