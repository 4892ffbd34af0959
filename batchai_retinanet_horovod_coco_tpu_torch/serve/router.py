"""Preprocess router: validate → resize → bucket-route, on host threads.

The JAX package's ``serve/router.py``: requests carry encoded image bytes
or decoded HWC uint8 RGB arrays; bytes are decoded by the package's codec
(``data/image_io.py::decode``, the pixels PIL gives), then resized on host
worker threads with the pipeline's own geometry (``bucket_for_source`` /
``resize_for_bucket``) and routed into the per-bucket queues the batcher
coalesces from.  What the codec refuses (arithmetic-coded, 12-bit,
lossless or hierarchical JPEG, RLE BMP, GIF, TIFF, WebP) is a
``decode_error``, where the JAX package's PIL decode serves it.

Failure routing is per request: a bad payload rejects THAT request with
``decode_error`` and the worker moves on; only a crash of the worker loop
itself escalates to ``on_fatal``.  Each worker heartbeats as
``serve-preprocess`` and spans a request's decode and resize as
``serve_preprocess``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    bucket_for_source,
    resize_for_bucket,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    RequestRejected,
    RequestTimeout,
    ServeRequest,
)


def decode_payload(payload) -> np.ndarray:
    """Request payload → HWC uint8 RGB array: an array is checked, encoded
    bytes are decoded by ``data/image_io.py::decode`` (the pipeline's own
    decode, so a dataset image's bytes give the pixels eval saw)."""
    if isinstance(payload, np.ndarray):
        if payload.ndim != 3 or payload.shape[2] != 3:
            raise ValueError(f"expected HWC RGB array, got {payload.shape}")
        if payload.dtype != np.uint8:
            raise ValueError(f"expected uint8 pixels, got {payload.dtype}")
        return payload
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return image_io.decode(bytes(payload), "<request>")
    raise ValueError(f"unsupported payload type {type(payload).__name__}")


class Router:
    """``workers`` threads pulling from the admission queue."""

    _POLL_S = 0.1

    def __init__(
        self,
        engine,
        admission_queue: queue.Queue,
        bucket_queues: dict[tuple[int, int], queue.Queue],
        on_reject: Callable[[ServeRequest, BaseException], None],
        on_fatal: Callable[[BaseException], None],
        stop: threading.Event,
        workers: int = 2,
    ):
        self._engine = engine
        self._in = admission_queue
        self._buckets = bucket_queues
        self._on_reject = on_reject
        self._on_fatal = on_fatal
        self._stop = stop
        # watchdog: each worker registers in _run() at thread start.
        self.threads = [
            threading.Thread(
                target=self._run, daemon=True, name=f"serve-preprocess-{i}"
            )
            for i in range(max(1, workers))
        ]
        for t in self.threads:
            t.start()

    def _preprocess(self, req: ServeRequest) -> None:
        """One request: validate → bucket pick → resize → route (or shed)."""
        if req.expired():
            self._on_reject(req, RequestTimeout(
                f"request {req.id} expired before preprocessing"
            ))
            return
        try:
            with trace.span("serve_preprocess"):
                image = decode_payload(req.payload)
                h, w = image.shape[:2]
                bucket = bucket_for_source(
                    h, w, self._engine.min_side, self._engine.max_side,
                    self._engine.buckets,
                )
                resized, scale = resize_for_bucket(
                    image, bucket, self._engine.min_side, self._engine.max_side,
                )
        except Exception as exc:  # bad input, not a broken server
            self._on_reject(req, RequestRejected("decode_error", repr(exc)))
            return
        req.payload = None  # the raw pixels are dead weight from here on
        req.image = resized
        req.scale = np.float32(scale)
        req.orig_wh = (w, h)
        req.bucket = bucket
        try:
            self._buckets[bucket].put_nowait(req)  # full queue = shed, not wait
        except queue.Full:
            self._on_reject(req, RequestRejected("bucket_queue_full"))

    def _run(self) -> None:
        # Beats on every poll: only a wedged decode or resize stops it.
        hb = watchdog.register(
            "serve-preprocess", details=lambda: {"admission_qsize": self._in.qsize()}
        )
        try:
            while not self._stop.is_set():
                hb.beat()
                try:
                    req = self._in.get(timeout=self._POLL_S)
                except queue.Empty:
                    continue
                self._preprocess(req)
        except Exception as exc:  # routed to the frontend: fails every future
            self._on_fatal(exc)
        finally:
            hb.close()
