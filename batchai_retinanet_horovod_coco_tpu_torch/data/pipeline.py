"""What serving and training need of the JAX package's ``data/pipeline.py``.

Normalization, the resize rule, the shape buckets, the pad pixel and its
template, and the stop-gated queue handoff — the same geometry the JAX
package's eval pipeline and serve router share, so a served image lands in
the same bucket at the same size.  For training, ``Batch``,
``PipelineStats`` and :func:`assemble`, which pads a list of examples into
one batch: images to the bucket, gt lists to ``max_gt`` rows with a mask;
for eval, :func:`pad_batch`, which fills a short batch with padding rows.
File decoding and the dataset readers are not ported yet.  The bilinear
resize runs in torch on the
host (``F.interpolate``, no antialias, rounded back to uint8) in place of
``cv2.INTER_LINEAR``: the two agree in shape and scale exactly and in
pixels within one grey level.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from batchai_retinanet_horovod_coco_tpu_torch.utils.device import constant

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)
# Normalize as x*scale - offset == (x/255-m)/s.
_NORM_SCALE = (1.0 / (255.0 * IMAGENET_STD)).astype(np.float32)
_NORM_OFFSET = (IMAGENET_MEAN / IMAGENET_STD).astype(np.float32)
# uint8 batch padding ≈ the dataset mean, i.e. ~0.0 in normalized space.
_PAD_PIXEL = np.round(IMAGENET_MEAN * 255.0).astype(np.uint8)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """ImageNet normalization of a (B, H, W, 3) uint8 batch, in f32 on the
    batch's device; float inputs pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    scale = constant(tuple(_NORM_SCALE.tolist()), torch.float32, images.device)
    offset = constant(tuple(_NORM_OFFSET.tolist()), torch.float32, images.device)
    return images.float() * scale - offset


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def stop_gated_put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Blocking put into a bounded queue that aborts when ``stop`` is set
    (a plain blocking put would leak the producer thread if the consumer
    disappears while the queue is full).  Returns False on abort."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def default_buckets(min_side: int, max_side: int) -> tuple[tuple[int, int], ...]:
    """Static (H, W) shape buckets covering the resize rule's output range:
    a landscape/square result fits (lo, hi), a portrait one (hi, lo)."""
    lo = round_up(min_side, 32)
    hi = round_up(max_side, 32)
    if lo == hi:
        return ((lo, lo),)
    return ((lo, hi), (hi, lo))


def resize_scale(h: int, w: int, min_side: int, max_side: int) -> float:
    """Reference resize rule: scale so min side = min_side, capped by max_side."""
    scale = min_side / min(h, w)
    if scale * max(h, w) > max_side:
        scale = max_side / max(h, w)
    return scale


def bucket_for_source(
    h: int,
    w: int,
    min_side: int,
    max_side: int,
    buckets: tuple[tuple[int, int], ...],
) -> tuple[int, int]:
    """Bucket a SOURCE-resolution image lands in: resize rule + rounding +
    bucket pick."""
    scale = resize_scale(h, w, min_side, max_side)
    return pick_bucket(int(round(h * scale)), int(round(w * scale)), buckets)


def pick_bucket(
    h: int, w: int, buckets: tuple[tuple[int, int], ...]
) -> tuple[int, int]:
    """Smallest bucket that fits (h, w); falls back to the largest-area one."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if fitting:
        return min(fitting, key=lambda b: b[0] * b[1])
    return max(buckets, key=lambda b: b[0] * b[1])


def _resize_bilinear(image: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Bilinear resize of one HWC uint8 image, half-pixel centres."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    y = F.interpolate(
        x.float(), size=(nh, nw), mode="bilinear", align_corners=False,
        antialias=False,
    )
    y = y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return np.ascontiguousarray(y.numpy())


def resize_for_bucket(
    image: np.ndarray,
    bucket: tuple[int, int],
    min_side: int,
    max_side: int,
) -> tuple[np.ndarray, float]:
    """Aspect-preserving resize of ONE uint8 HWC image into ``bucket``: the
    reference resize rule capped so the result fits the bucket.  Returns
    ``(image, scale)``; when no resize is needed the input array is returned
    as it is."""
    h, w = image.shape[:2]
    bh, bw = bucket
    scale = min(resize_scale(h, w, min_side, max_side), bh / h, bw / w)
    nh = min(bh, int(round(h * scale)))
    nw = min(bw, int(round(w * scale)))
    if (nh, nw) != (h, w):
        image = _resize_bilinear(image, nh, nw)
    return image, scale


_PAD_TEMPLATES: dict[tuple[int, int], np.ndarray] = {}
_PAD_LOCK = threading.Lock()


def _pad_template(bh: int, bw: int) -> np.ndarray:
    """Contiguous (bh, bw, 3) uint8 array of the pad pixel, cached per
    bucket shape (copying from it is a plain strided memcpy)."""
    with _PAD_LOCK:
        tmpl = _PAD_TEMPLATES.get((bh, bw))
        if tmpl is None:
            tmpl = np.empty((bh, bw, 3), dtype=np.uint8)
            tmpl[...] = _PAD_PIXEL
            tmpl.setflags(write=False)
            _PAD_TEMPLATES[(bh, bw)] = tmpl
        return tmpl


def paste_image(slot: np.ndarray, image: np.ndarray, pad: np.ndarray) -> None:
    """Copy ``image`` into the top-left of the (bh, bw, 3) ``slot`` and fill
    the margins from the pad template ``pad`` of the same shape."""
    h, w = image.shape[:2]
    bh, bw = slot.shape[:2]
    slot[:h, :w] = image
    if h < bh:
        slot[h:] = pad[h:]
    if w < bw:
        slot[:h, w:] = pad[:h, w:]


@dataclasses.dataclass
class PipelineStats:
    """Counters of boxes lost to ``max_gt`` padding: an image with more
    boxes than ``max_gt`` loses the overflow from its training targets."""

    truncated_boxes: int = 0
    truncated_images: int = 0


class Batch(NamedTuple):
    images: np.ndarray  # (B, H, W, 3) uint8 (the device normalizes)
    gt_boxes: np.ndarray  # (B, max_gt, 4) float32, resized coords
    gt_labels: np.ndarray  # (B, max_gt) int32
    gt_mask: np.ndarray  # (B, max_gt) bool
    image_ids: np.ndarray  # (B,) int64
    scales: np.ndarray  # (B,) float32: resized / original
    valid: np.ndarray  # (B,) bool: False for eval padding rows


def assemble(
    examples: list[tuple[np.ndarray, np.ndarray, np.ndarray, float]],
    image_ids: list[int],
    bucket: tuple[int, int],
    max_gt: int = 100,
    stats: PipelineStats | None = None,
) -> Batch:
    """Pad ``(image, boxes (N, 4), labels (N,), scale)`` examples into one
    ``Batch`` at ``bucket``: uint8 images with pad-pixel margins, and the gt
    lists cut or padded to ``max_gt`` rows (zeros, mask False).  Boxes past
    ``max_gt`` are counted in ``stats``."""
    b = len(examples)
    bh, bw = bucket
    pad = _pad_template(bh, bw)
    images = np.empty((b, bh, bw, 3), dtype=np.uint8)
    gt_boxes = np.zeros((b, max_gt, 4), dtype=np.float32)
    gt_labels = np.zeros((b, max_gt), dtype=np.int32)
    gt_mask = np.zeros((b, max_gt), dtype=bool)
    scales = np.zeros((b,), dtype=np.float32)
    for i, (img, boxes, labels, scale) in enumerate(examples):
        paste_image(images[i], img, pad)
        n = min(len(boxes), max_gt)
        if stats is not None and len(boxes) > n:
            stats.truncated_boxes += len(boxes) - n
            stats.truncated_images += 1
        gt_boxes[i, :n] = boxes[:n]
        gt_labels[i, :n] = labels[:n]
        gt_mask[i, :n] = True
        scales[i] = scale
    return Batch(
        images=images,
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_mask=gt_mask,
        image_ids=np.asarray(image_ids, dtype=np.int64),
        scales=scales,
        valid=np.ones((b,), dtype=bool),
    )


def pad_batch(batch: Batch, batch_size: int) -> Batch:
    """Pad a short eval batch to ``batch_size`` rows of zeros with
    ``valid=False`` (the JAX package's ``_pad_batch``)."""
    pad = batch_size - batch.images.shape[0]

    def pad0(x: np.ndarray) -> np.ndarray:
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    return Batch(
        images=pad0(batch.images),
        gt_boxes=pad0(batch.gt_boxes),
        gt_labels=pad0(batch.gt_labels),
        gt_mask=pad0(batch.gt_mask),
        image_ids=pad0(batch.image_ids),
        scales=pad0(batch.scales),
        valid=np.concatenate([batch.valid, np.zeros(pad, dtype=bool)]),
    )
