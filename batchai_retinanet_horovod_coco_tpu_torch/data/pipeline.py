"""Host input pipeline, as the JAX package's ``data/pipeline.py``: decode →
augment → resize → bucket-pad → batch.

Every image is resized (aspect kept) and padded into one of a few static
(H, W) shape buckets, and a batch is formed within one bucket, so the step
is built once per bucket; gt boxes are padded to ``max_gt`` rows with a
mask, and target assignment happens on the device.  :func:`build_pipeline`
decodes and resizes on a thread pool (the codec and the resize release the
interpreter lock), keeps several batches in flight, and emits them in plan
order: for a fixed seed the batches equal the JAX package's in order,
buckets, boxes, labels, masks, scales, ``valid`` and image ids, and the
images within the resize's and, with ``transform``, the warp's tolerance.
Images are read by ``data/image_io.py`` (the port's decoder, PIL's pixels)
and shipped as uint8; the device normalizes (:func:`normalize_images`).

The bilinear resize runs on the host in the codec library
(``image_io.resize_bilinear``: ``F.interpolate``'s half-pixel taps and
weights, no antialias, in f32 on one thread, so its pixels do not depend on
the thread or process that runs it) in place of ``cv2.INTER_LINEAR``: the
two agree in shape and scale exactly and in pixels within one grey level.  The
same geometry serves the serve router, so a served image lands in the same
bucket at the same size.  :func:`assemble` pads a list of examples into one
batch; :func:`pad_batch` fills a short eval batch with padding rows.

``num_worker_procs > 0`` hands the decodes to worker processes instead
(``shm_pipeline.py``): the same batches, bit for bit.  Not ported
(``ROADMAP.md``): sharding over processes and host-side normalization.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from collections import deque
from collections.abc import Iterator
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data.transforms import (
    TransformConfig,
    apply_random_transform,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import constant

logger = logging.getLogger(__name__)

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
        image = image_io.resize_bilinear(image, nh, nw)
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


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    batch_size: int = 2
    # (H, W) buckets; an image goes to the smallest bucket that fits its
    # resized shape.
    buckets: tuple[tuple[int, int], ...] = ((800, 1344), (1344, 800), (1024, 1024))
    min_side: int = 800
    max_side: int = 1333
    max_gt: int = 100
    hflip_prob: float = 0.5
    # The full random affine and photometric augmentation (data/transforms.py);
    # when set it replaces the flip-only path (its flip_x_prob flips).
    transform: TransformConfig | None = None
    shuffle: bool = True
    seed: int = 0
    # Decode threads.
    num_workers: int = 8
    # > 0: that many decode worker PROCESSES writing into shared-memory
    # slabs (shm_pipeline.py) in place of the threads; the same batches.
    num_worker_procs: int = 0
    # Worker processes: a head-of-line batch that gets no result for this
    # many seconds raises (a wedged worker); a dead worker raises at once.
    worker_timeout: float = 120.0
    # Resume: skip this many already consumed batches (train only) at the
    # plan level, without decoding them.
    skip_batches: int = 0
    # Image ids never emitted, dropped after the epoch's shuffle.
    exclude_ids: tuple[int, ...] = ()


# Finished batches the producer keeps ready ahead of the consumer.
_PREFETCH = 4


def dataset_max_gt(dataset) -> int:
    """Largest annotation count of an image (crowds excluded: only
    ``record.boxes`` feed training targets)."""
    return max((len(r.boxes) for r in dataset.records), default=0)


def resolve_max_gt(requested: int | None, *datasets, cap: int = 512) -> int:
    """The gt padding of a run: ``requested`` as it is, or (``None``) the
    datasets' largest box count rounded up to a multiple of 8, within
    [8, cap]."""
    if requested is not None:
        return requested
    need = max((dataset_max_gt(ds) for ds in datasets), default=0)
    return max(8, min(round_up(max(need, 1), 8), cap))


def load_example(
    dataset,
    record,
    config: PipelineConfig,
    rng: np.random.Generator | None,
    bucket: tuple[int, int],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Decode, augment (train only: ``rng`` given) and resize one image into
    ``bucket``.  Returns the uint8 HWC image (not yet padded, but fitting
    the bucket), its boxes (N, 4) in resized pixels, labels and scale."""
    image = image_io.read_rgb(dataset.image_path(record))
    boxes = record.boxes.copy()
    labels = record.labels.copy()
    h, w = image.shape[:2]

    if rng is not None and config.transform is not None:
        image, boxes, labels = apply_random_transform(image, boxes, labels, config.transform, rng)
    elif rng is not None and config.hflip_prob > 0 and rng.random() < config.hflip_prob:
        image = image[:, ::-1]
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x1

    image, scale = resize_for_bucket(image, bucket, config.min_side, config.max_side)
    if image.shape[:2] != (h, w):
        boxes = boxes * scale
    return image, boxes, labels, scale


def example_rng(config: PipelineConfig, train: bool, epoch: int, idx: int) -> np.random.Generator | None:
    """The augmentation generator of one example, keyed on (seed, epoch,
    record index): it does not depend on which thread decodes it."""
    if not train:
        return None
    return np.random.default_rng(np.random.SeedSequence([config.seed, epoch, idx]))


def epoch_indices(dataset, config: PipelineConfig, train: bool, epoch: int) -> list[int]:
    """The record indices of ``epoch``, shuffled per (seed, epoch) for
    training; ``config.exclude_ids`` leave holes after the shuffle."""
    idx = np.arange(len(dataset.records))
    if train and config.shuffle:
        np.random.default_rng(np.random.SeedSequence([config.seed, epoch])).shuffle(idx)
    if config.exclude_ids:
        excluded = {int(i) for i in config.exclude_ids}
        idx = np.asarray(
            [i for i in idx if int(dataset.records[i].image_id) not in excluded], dtype=np.int64
        )
    return list(idx)


def batch_plans(
    dataset, config: PipelineConfig, train: bool, epoch: int
) -> Iterator[tuple[tuple[int, int], list[int], list[int], bool]]:
    """The batches of one epoch in emission order: ``(bucket,
    record_indices, image_ids, short)``, records grouped by bucket in order
    of first appearance; a short last batch is dropped in training and
    padded in eval."""
    by_bucket: dict[tuple[int, int], list[int]] = {}
    for i in epoch_indices(dataset, config, train, epoch):
        r = dataset.records[i]
        bucket = bucket_for_source(r.height, r.width, config.min_side, config.max_side, config.buckets)
        by_bucket.setdefault(bucket, []).append(i)
    for bucket, idxs in by_bucket.items():
        for start in range(0, len(idxs), config.batch_size):
            chunk = idxs[start : start + config.batch_size]
            if len(chunk) < config.batch_size and train:
                continue
            ids = [dataset.records[i].image_id for i in chunk]
            short = not train and len(chunk) < config.batch_size
            yield bucket, chunk, ids, short


def _warn_truncation(dataset, config: PipelineConfig) -> None:
    over = sum(1 for r in dataset.records if len(r.boxes) > config.max_gt)
    if over:
        logger.warning(
            "max_gt=%d truncates %d/%d images (dataset max %d boxes/image); "
            "overflow boxes are DROPPED from training targets. Pass an "
            "explicit larger --max-gt to keep them.",
            config.max_gt, over, len(dataset.records), dataset_max_gt(dataset),
        )


class _PipelineIterator:
    """Iterator over batches with live ``stats`` (:class:`PipelineStats`);
    ``close()`` stops the producer thread."""

    def __init__(self, gen: Iterator[Batch], stats: PipelineStats, stop: threading.Event,
                 thread: threading.Thread):
        self._gen = gen
        self._stop = stop
        self._thread = thread
        self.stats = stats

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        return next(self._gen)

    def close(self) -> None:
        """Stop the producer (set its stop event: closing a generator that
        never started does not) and join it."""
        self._stop.set()
        self._gen.close()
        self._thread.join(timeout=30)


def build_pipeline(dataset, config: PipelineConfig, train: bool = True) -> _PipelineIterator:
    """Endless (train) or one-epoch (eval) iterator of bucketed batches.

    Train: shuffled per epoch, grouped by bucket, full batches only. Eval:
    the records in order, no augmentation, the last batch padded with
    ``valid=False`` rows so every record is evaluated once.  A producer
    thread submits ``load_example`` calls to a pool of
    ``config.num_workers`` threads, several batches ahead, and emits the
    batches in plan order into a queue of ``_PREFETCH``; a failure in
    either is raised to the consumer.  The producer heartbeats as
    ``pipe-producer`` and spans its waits on the decodes
    (``pipe_decode_wait``) and its assembly (``pipe_assemble``).

    ``config.num_worker_procs > 0`` returns the multiprocess producer of
    ``shm_pipeline.py`` instead: the same batches, decoded by processes.
    """
    _warn_truncation(dataset, config)
    if config.num_worker_procs > 0:
        from batchai_retinanet_horovod_coco_tpu_torch.data.shm_pipeline import build_shm_pipeline

        return build_shm_pipeline(dataset, config, train)
    stats = PipelineStats()
    out: queue.Queue = queue.Queue(maxsize=_PREFETCH)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        return stop_gated_put(out, item, stop)

    def produce(pool: ThreadPoolExecutor, hb: watchdog.Heartbeat) -> None:
        # Several batches' decodes in flight, so the pool does not drain at
        # a batch boundary; batches leave in submission order.
        max_inflight = max(2, -(-config.num_workers // max(1, config.batch_size)) + 1)
        inflight: deque = deque()

        def flush_one() -> bool:
            futures, ids, bucket, short = inflight.popleft()
            with trace.span("pipe_decode_wait"):
                examples = [f.result() for f in futures]
            hb.beat()  # decode progress is the pool's liveness
            with trace.span("pipe_assemble"):
                batch = assemble(examples, ids, bucket, config.max_gt, stats)
            if short:
                batch = pad_batch(batch, config.batch_size)
            hb.idle()  # a full output queue is backpressure, not a stall
            ok = put(batch)
            hb.beat()
            return ok

        epoch = 0
        to_skip = config.skip_batches if train else 0
        while not stop.is_set():
            for bucket, chunk, ids, short in batch_plans(dataset, config, train, epoch):
                if to_skip > 0:
                    to_skip -= 1
                    continue
                futures = [
                    pool.submit(load_example, dataset, dataset.records[i], config,
                                example_rng(config, train, epoch, int(i)), bucket)
                    for i in chunk
                ]
                inflight.append((futures, ids, bucket, short))
                if len(inflight) >= max_inflight and not flush_one():
                    return
                if stop.is_set():
                    return
            if not train:
                while inflight:
                    if not flush_one():
                        return
                put(end)
                return
            epoch += 1

    def producer() -> None:
        # The decode threads report through future.result() on this
        # registered thread: a wedged decode stalls its heartbeat.
        pool = ThreadPoolExecutor(max_workers=config.num_workers, thread_name_prefix="pipe-decode")
        hb = watchdog.register("pipe-producer", details=lambda: {"qsize": out.qsize()})
        try:
            produce(pool, hb)
        except BaseException as exc:  # handed to the consumer; never hang it
            put(exc)
        finally:
            hb.close()
            pool.shutdown(wait=True, cancel_futures=True)

    # watchdog: registers in producer() at thread start.
    thread = threading.Thread(target=producer, daemon=True, name="pipe-producer")
    thread.start()

    def iterate() -> Iterator[Batch]:
        try:
            while True:
                item = out.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return _PipelineIterator(iterate(), stats, stop, thread)
