"""Detection: normalize → forward → sigmoid → decode → clip → batched NMS,
and the dataset-level eval driver.

The JAX package's ``evaluate/detect.py``.  The NMS suppression stage is
``ops.cuda.nms.batched_multiclass_nms_cuda``: the hand-written CUDA kernel
on a card, the plain ``greedy_keep`` on the CPU — decided by the device the
tensors are on, never by a fallback.  ``pre_nms_size`` and the NMS
kernel's launch shape (``nms_mask_lanes``, ``nms_scan_threads``) left None
are read from the schedule registry (``tune/schedule.py``) for that device,
in :func:`postprocess`, which every detect path goes through (the built-in
defaults are 1000 and the kernel's shapes before its menus, 4 and 256).

``run_coco_eval`` streams eval batches, detects per shape bucket (one
detect function each), rescales boxes to the original images and scores
them with COCO mAP (``evaluate/coco_eval.py``, over its native helper).
Pipelined (the default), it runs three stages, and gives the same results
in the same order as the sequential path (``pipelined=False``):

1. **device prefetch**: a thread pins each batch's images and starts their
   copy to the card on a side stream, ``EVAL_PREFETCH_DEPTH`` batches
   ahead (``data/prefetch.py``);
2. **one-behind fetch**: batch N is dispatched before batch N-1's
   detections are fetched.  An event is recorded after each batch's
   detect; N-1's detections are copied into pinned host memory on a copy
   stream that waits on N-1's event, and only that copy is waited for, so
   the fetch overlaps N's forward (a plain ``.cpu()`` on the compute
   stream would wait for N's forward too);
3. **a consumer thread** converts to COCO result dicts and scores each
   image as its batch arrives (``StreamingCocoEval``), behind a bounded
   queue, FIFO, with the error contract of the prefetch thread.

In a data-parallel world each rank detects its own shard of the val set
(the pipeline's ``shard_index``/``shard_count``) and
:func:`allgather_process_detections` merges the shards, so every rank
scores the same full list (rank 0 logs it).

The stages heartbeat to ``obs/watchdog.py`` (``eval-device-prefetch``,
``eval-driver``, ``eval-consumer``) and span their work
(``build_detect_fn``, ``detect_dispatch``, ``detect_fetch``,
``eval_put_wait``, ``eval_convert``, ``eval_score``).
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.data.coco import CocoDataset
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch
from batchai_retinanet_horovod_coco_tpu_torch.data.prefetch import prefetch_map
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.coco_eval import (
    StreamingCocoEval,
    evaluate_detections,
)
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.voc_eval import evaluate_detections_voc
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import boxes as boxes_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import (
    resolve_device,
    stage,
    take,
    to_device_images,
)

# Eval batches staged on the card ahead of the detect in flight (pipelined).
EVAL_PREFETCH_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """FilterDetections-equivalent knobs (the reference's defaults);
    ``pre_nms_size`` None is the schedule registry's for the device, and so
    are the NMS kernel's launch shapes: lanes a mask row and scan threads
    (their menus, ``ops/cuda/nms.py``; every shape gives the same
    detections)."""

    score_threshold: float = 0.05
    iou_threshold: float = 0.5
    pre_nms_size: int | None = None
    max_detections: int = 300
    nms_mask_lanes: int | None = None
    nms_scan_threads: int | None = None
    codec: boxes_lib.BoxCodecConfig = boxes_lib.BoxCodecConfig()
    anchor: anchors_lib.AnchorConfig = anchors_lib.AnchorConfig()


_SCHEDULED = (("pre_nms_size", "pre_nms_size"), ("nms_mask_lanes", "mask_lanes"),
              ("nms_scan_threads", "scan_threads"))


def resolve_detect_config(config: DetectConfig, device: str | torch.device | None) -> DetectConfig:
    """``config`` with ``pre_nms_size`` and the NMS launch shape from the
    schedule registry for ``device`` where they are None (the JAX package's
    resolve_detect_config; an explicit value wins)."""
    if all(getattr(config, field) is not None for field, _ in _SCHEDULED):
        return config
    from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

    entry = schedule_lib.lookup(device)["nms"]
    return dataclasses.replace(config, **{
        field: int(entry[key]) for field, key in _SCHEDULED if getattr(config, field) is None})


def postprocess(
    outputs: dict[str, torch.Tensor],
    anchors: torch.Tensor,
    image_hw: tuple[int, int],
    config: DetectConfig,
    nms: Callable[..., nms_lib.Detections] | None = None,
) -> nms_lib.Detections:
    """Forward outputs → Detections: sigmoid in f32 → decode against
    ``anchors`` (A, 4) → clip to the bucket extent (not the image: the
    conversion re-clamps to the true image) → ``nms``, at the registry's
    ``pre_nms_size`` for the outputs' device where ``config`` leaves it
    None.  ``nms`` None is ``batched_multiclass_nms_cuda`` at the config's
    launch shape (the registry's where it leaves them None); another
    ``nms`` takes the selection knobs only."""
    scores = torch.sigmoid(outputs["cls_logits"])  # (B, A, K)
    config = resolve_detect_config(config, scores.device)
    if nms is None:
        nms = functools.partial(nms_cuda.batched_multiclass_nms_cuda,
                                mask_lanes=config.nms_mask_lanes,
                                scan_threads=config.nms_scan_threads)
    boxes = boxes_lib.decode_boxes(anchors[None], outputs["box_deltas"], config.codec)
    boxes = boxes_lib.clip_boxes(boxes, image_hw)
    return nms(
        boxes,
        scores,
        score_threshold=config.score_threshold,
        iou_threshold=config.iou_threshold,
        pre_nms_size=config.pre_nms_size,
        max_detections=config.max_detections,
    )


def anchors_on(
    image_hw: tuple[int, int], config: anchors_lib.AnchorConfig, device: torch.device
) -> torch.Tensor:
    """The (A, 4) f32 anchors of a padded image shape, on ``device``."""
    return torch.from_numpy(
        np.array(anchors_lib.anchors_for_image_shape(image_hw, config))
    ).to(device)


class DetectProgram(torch.nn.Module):
    """The detect program of one bucket: uint8 images (B, H, W, 3) →
    ``(boxes, scores, labels, valid)``, the flat tuple that ``jax.export``
    makes of ``Detections``.  It holds the model, the bucket's anchors as a
    buffer and the ``DetectConfig``; the live path (:func:`make_detect_fn`)
    runs it, and ``evaluate/export.py`` exports it, so the two are one
    program.  Moving the images to the device stays outside it."""

    def __init__(
        self,
        model: torch.nn.Module,
        image_hw: tuple[int, int],
        config: DetectConfig = DetectConfig(),
    ):
        super().__init__()
        self.model = model
        self.image_hw = tuple(image_hw)
        self.config = config
        self.register_buffer("anchors", anchors_on(self.image_hw, config.anchor, torch.device("cpu")))

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, ...]:
        outputs = self.model(pipeline_lib.normalize_images(images))
        return tuple(postprocess(outputs, self.anchors, self.image_hw, self.config))


def make_detect_fn(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    config: DetectConfig = DetectConfig(),
    device: str | torch.device = "cuda",
) -> Callable[[object], nms_lib.Detections]:
    """``detect(images (B, H, W, 3) uint8) → Detections`` for one bucket,
    on ``device`` (``cuda`` unless the caller asks for the CPU; without a
    card it raises): a :class:`DetectProgram`.  ``model`` is moved to
    ``device`` and put in eval mode.  On a card the call returns without
    synchronising: read the result with ``.cpu()``."""
    device = resolve_device(device)
    program = DetectProgram(model, image_hw, config).to(device).eval()

    def detect(images) -> nms_lib.Detections:
        x = to_device_images(images, device)
        if tuple(x.shape[1:3]) != tuple(image_hw):
            raise ValueError(f"batch of {tuple(x.shape)} for bucket {image_hw}")
        with torch.inference_mode():
            return nms_lib.Detections(*program(x))

    return detect


def detections_to_coco(
    det: nms_lib.Detections,
    image_ids: np.ndarray,
    scales: np.ndarray,
    valid_rows: np.ndarray,
    label_to_cat_id: dict[int, int],
    image_sizes: dict[int, tuple[int, int]] | None = None,
) -> list[dict]:
    """Detections (one batch, numpy) → COCO result dicts in ORIGINAL coords.

    Boxes come back in resized-image coordinates; dividing by the per-image
    scale restores original coordinates.  The device-side clip is to the
    static bucket extent (which includes padding), so with ``image_sizes``
    ({image_id: (width, height)}) boxes are re-clamped to the true image
    bounds here; degenerate (zero-area) boxes — e.g. spurious hits entirely
    inside the padding — are dropped.
    """
    boxes = np.asarray(det.boxes, dtype=np.float64)
    scores = np.asarray(det.scores, dtype=np.float64)
    labels = np.asarray(det.labels)
    valid = np.asarray(det.valid)

    results: list[dict] = []
    for i in range(boxes.shape[0]):
        if not valid_rows[i]:
            continue  # eval padding row
        inv = 1.0 / float(scales[i])
        img_id = int(image_ids[i])
        wh = image_sizes.get(img_id) if image_sizes else None
        for j in np.flatnonzero(valid[i]):
            x1, y1, x2, y2 = boxes[i, j] * inv
            if wh is not None:
                x1, x2 = np.clip([x1, x2], 0.0, wh[0])
                y1, y2 = np.clip([y1, y2], 0.0, wh[1])
                if x2 <= x1 or y2 <= y1:
                    continue
            results.append(
                {
                    "image_id": img_id,
                    "category_id": int(label_to_cat_id[int(labels[i, j])]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(scores[i, j]),
                }
            )
    return results


def coco_gt_from_dataset(dataset: CocoDataset) -> tuple[list[dict], list[int]]:
    """Ground-truth annotation dicts and the image ids of a ``CocoDataset``;
    crowd annotations come through with ``iscrowd=1`` and each keeps its
    area, so the oracle's ignore and area-range rules match pycocotools'."""
    gts: list[dict] = []
    ann_id = 1
    for rec in dataset.records:
        for boxes, labels, areas, iscrowd in (
            (rec.boxes, rec.labels, rec.areas, 0),
            (rec.crowd_boxes, rec.crowd_labels, rec.crowd_areas, 1),
        ):
            for box, label, area in zip(boxes, labels, areas):
                x1, y1, x2, y2 = (float(v) for v in box)
                gts.append({
                    "id": ann_id,
                    "image_id": rec.image_id,
                    "category_id": dataset.label_to_cat_id[int(label)],
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "area": float(area),
                    "iscrowd": iscrowd,
                })
                ann_id += 1
    return gts, [rec.image_id for rec in dataset.records]


class _EvalConsumer:
    """Stage 3: fetched Detections → COCO result dicts (and the optional
    per-batch scoring hook) in one thread behind a bounded queue.

    A crash in the thread re-raises in the driver at its next ``put()`` or
    ``finish()``; ``close()`` stops the thread promptly and may be called
    twice; batches are taken FIFO by one thread, so ``results`` is ordered
    as the sequential path orders it.
    """

    _DONE = object()

    def __init__(
        self,
        label_to_cat_id: dict[int, int],
        image_sizes: dict[int, tuple[int, int]] | None,
        on_batch: Callable[[list[dict], Sequence[int]], None] | None = None,
        maxsize: int = 4,
    ):
        self._label_to_cat_id = label_to_cat_id
        self._image_sizes = image_sizes
        self._on_batch = on_batch
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, maxsize))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self.results: list[dict] = []
        # watchdog: registers in _run() at thread start.
        self._thread = threading.Thread(target=self._run, daemon=True, name="eval-consumer")
        self._thread.start()

    def _run(self) -> None:
        # Every poll beats (a waiting consumer is healthy): only a wedged
        # conversion or scoring callback stops the heartbeat.
        hb = watchdog.register(
            "eval-consumer",
            details=lambda: {"qsize": self._queue.qsize(), "results": len(self.results)},
        )
        try:
            while not self._stop.is_set():
                hb.beat()
                try:
                    item = self._queue.get(timeout=0.1)
                except queue.Empty:
                    continue
                if item is self._DONE:
                    return
                det, image_ids, scales, valid = item
                with trace.span("eval_convert"):
                    batch_results = detections_to_coco(
                        det, image_ids, scales, valid, self._label_to_cat_id,
                        image_sizes=self._image_sizes,
                    )
                self.results.extend(batch_results)
                if self._on_batch is not None:
                    done = [int(i) for i, v in zip(image_ids, valid) if v]
                    with trace.span("eval_score"):
                        self._on_batch(batch_results, done)
                if trace.enabled():
                    trace.counter("eval_consumer.qsize", self._queue.qsize())
        except BaseException as exc:  # re-raised in the driver
            self._error = exc
            self._stop.set()  # unblocks a driver waiting on a full queue
        finally:
            hb.close()

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise RuntimeError("eval consumer thread failed") from self._error

    def put(self, det, image_ids, scales, valid) -> None:
        """Hand one fetched batch to the thread; raises its pending error."""
        self._raise_pending()
        if not pipeline_lib.stop_gated_put(self._queue, (det, image_ids, scales, valid), self._stop):
            self._raise_pending()
            raise RuntimeError("eval consumer stopped")

    def finish(self) -> list[dict]:
        """Drain, join and surface the thread's error → the ordered results."""
        pipeline_lib.stop_gated_put(self._queue, self._DONE, self._stop)
        self._thread.join()
        self._raise_pending()
        return self.results

    def close(self) -> None:
        """Stop without draining (the driver is unwinding on its own error)."""
        self._stop.set()
        self._thread.join(timeout=10)


class _Fetcher:
    """Stage 2's fetch: Detections to numpy.  On a card the copy runs on its
    own stream into pinned host memory, after the event recorded behind the
    batch's detect, and only that copy is waited for."""

    def __init__(self, device: torch.device):
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def fetch(self, det: nms_lib.Detections, done: torch.cuda.Event | None) -> nms_lib.Detections:
        if self._stream is None:
            return nms_lib.Detections(*(f.numpy() for f in det))
        self._stream.wait_event(done)
        with torch.cuda.stream(self._stream):
            host = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True) for f in det]
            for h, f in zip(host, det):
                h.copy_(f, non_blocking=True)
                f.record_stream(self._stream)
            copied = torch.cuda.Event()
            copied.record(self._stream)
        copied.synchronize()
        return nms_lib.Detections(*(h.numpy() for h in host))


def collect_detections(
    model: torch.nn.Module,
    dataset: CocoDataset,
    batches: Iterable[Batch],
    config: DetectConfig = DetectConfig(),
    device: str | torch.device = "cuda",
    *,
    pipelined: bool = True,
    detect_fns: dict[tuple[int, int], Callable] | None = None,
    on_batch: Callable[[list[dict], Sequence[int]], None] | None = None,
) -> list[dict]:
    """Detect over an eval batch stream → COCO result dicts, in batch order.

    One detect function of ``model`` is built per shape bucket; pass
    ``detect_fns`` to share them between calls on the same model.
    ``pipelined`` selects the three-stage driver (module docstring),
    ``False`` the sequential one; both give identical results in identical
    order.  Padding rows (``valid=False``) add nothing.  ``on_batch``, if
    given, sees each batch's results and the image ids it completed (in the
    consumer thread when pipelined).
    """
    device = resolve_device(device)
    if detect_fns is None:
        detect_fns = {}
    image_sizes = {rec.image_id: (rec.width, rec.height) for rec in dataset.records}

    def fn_for(hw: tuple[int, int]) -> Callable:
        fn = detect_fns.get(hw)
        if fn is None:
            with trace.span("build_detect_fn", bucket=f"{hw[0]}x{hw[1]}"):
                fn = detect_fns[hw] = make_detect_fn(model, hw, config, device)
        return fn

    if not pipelined:
        results: list[dict] = []
        for batch in batches:
            det = fn_for(tuple(batch.images.shape[1:3]))(batch.images)
            det = nms_lib.Detections(*(f.cpu().numpy() for f in det))
            batch_results = detections_to_coco(
                det, batch.image_ids, batch.scales, batch.valid, dataset.label_to_cat_id,
                image_sizes=image_sizes,
            )
            results.extend(batch_results)
            if on_batch is not None:
                on_batch(batch_results, [int(i) for i, v in zip(batch.image_ids, batch.valid) if v])
        return results

    h2d_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    fetcher = _Fetcher(device)
    consumer = _EvalConsumer(dataset.label_to_cat_id, image_sizes, on_batch=on_batch)
    staged = prefetch_map(
        batches,
        lambda b: (tuple(b.images.shape[1:3]), stage({"images": b.images}, device, h2d_stream),
                   (b.image_ids, b.scales, b.valid)),
        depth=EVAL_PREFETCH_DEPTH,
        thread_name="eval-device-prefetch",
    )
    # The driver's own heartbeat: the consumer beats on every idle poll and
    # the prefetch thread idles behind a full queue, so a fetch hanging on
    # the device would otherwise show no liveness signal at all.
    hb = watchdog.register("eval-driver", details=lambda: {"results": len(consumer.results)})

    def hand_over(pending: tuple) -> None:
        with trace.span("detect_fetch"):
            fetched = fetcher.fetch(*pending[:2])
        hb.beat()
        hb.idle()  # a full consumer queue is backpressure
        with trace.span("eval_put_wait"):
            consumer.put(fetched, *pending[2])
        hb.beat()

    pending: tuple | None = None
    try:
        for hw, images, meta in staged:
            hb.beat()
            with trace.span("detect_dispatch"):
                det = fn_for(hw)(take(images)["images"])
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            if pending is not None:
                hand_over(pending)
            pending = (det, done, meta)
        if pending is not None:
            hand_over(pending)
            pending = None
        hb.idle()  # finish() waits on the consumer's drain
        return consumer.finish()
    finally:
        staged.close()
        consumer.close()
        hb.close()


def allgather_process_detections(results: list[dict], world) -> list[dict]:
    """Every rank's COCO result dicts, merged in rank order: the JAX
    package's cross-process gather of the sharded eval.  The dicts pack
    into fixed-width arrays padded to the largest rank's count: the image
    id as its two 32-bit halves and the category id (int64), the box and
    score (f64, the values the dicts hold, so the merged list equals one
    process's).  ``world`` None: the identity."""
    if world is None:
        return results
    n = len(results)
    ids = torch.zeros((n, 3), dtype=torch.int64)  # image id low, high; category id
    vals = torch.zeros((n, 5), dtype=torch.float64)  # x, y, w, h, score
    for i, r in enumerate(results):
        image_id = int(r["image_id"])
        ids[i] = torch.tensor([image_id & 0xFFFFFFFF, image_id >> 32, int(r["category_id"])])
        vals[i] = torch.tensor([*r["bbox"], r["score"]])
    counts = [int(c) for c in world.all_gather(torch.tensor([n], dtype=torch.int64))]
    n_max = max(counts)
    if n_max == 0:
        return []
    pad = n_max - n
    ids_g = world.all_gather(torch.nn.functional.pad(ids, (0, 0, 0, pad)))
    vals_g = world.all_gather(torch.nn.functional.pad(vals, (0, 0, 0, pad)))
    merged: list[dict] = []
    for count, rank_ids, rank_vals in zip(counts, ids_g, vals_g):
        for (lo, hi, cat), v in zip(rank_ids[:count].tolist(), rank_vals[:count].tolist()):
            merged.append({"image_id": lo | (hi << 32), "category_id": cat,
                           "bbox": v[:4], "score": v[4]})
    return merged


def run_coco_eval(
    model: torch.nn.Module,
    dataset: CocoDataset,
    batches: Iterable[Batch],
    config: DetectConfig = DetectConfig(),
    device: str | torch.device = "cuda",
    *,
    voc_metrics: bool = False,
    voc_weighted_average: bool = False,
    pipelined: bool = True,
    detect_fns: dict[tuple[int, int], Callable] | None = None,
    world=None,
) -> dict[str, float]:
    """A full eval pass: detect everything, then COCO mAP's 12 stats
    (``AP``, ``AP50``, ...) from ``evaluate/coco_eval.py``.

    Pipelined, the consumer thread scores each image as its batch arrives
    (``StreamingCocoEval``); the metrics equal the one-shot scoring's.
    ``voc_metrics`` adds PASCAL-VOC AP@0.5 (``voc_*`` keys) from the same
    detections, its mean weighted by each class's annotation count with
    ``voc_weighted_average``.
    ``world``: ``batches`` are this rank's shard of the val set; the
    detections of every rank are gathered (:func:`allgather_process_detections`)
    and scored after the gather, on every rank.
    """
    gt, img_ids = coco_gt_from_dataset(dataset)
    scorer = None
    if pipelined and world is None:
        scorer = StreamingCocoEval(gt, img_ids, cat_ids=list(dataset.label_to_cat_id.values()))
    dt = collect_detections(
        model, dataset, batches, config, device,
        pipelined=pipelined, detect_fns=detect_fns,
        on_batch=scorer.add if scorer is not None else None,
    )
    dt = allgather_process_detections(dt, world)
    metrics = scorer.finish() if scorer is not None else evaluate_detections(gt, dt, img_ids=img_ids)
    if voc_metrics:
        metrics.update(evaluate_detections_voc(gt, dt, weighted_average=voc_weighted_average))
    return metrics
