"""Detect-program table + one-behind device dispatch (the serve device layer).

The JAX package's ``serve/engine.py``.  ``DetectEngine`` owns one detect
program per (shape bucket, batch size) plus the routing metadata.  Two
constructors:

- ``from_export(dir)`` loads a ``convert_model`` export directory
  (``evaluate/export.py``): exported programs, weights inside, no model
  code.  Buckets, batch sizes, the resize rule and the label → category
  map come from the manifest.
- ``from_state(model, ...)`` runs a live model: a ``make_detect_fn``
  closure (the same ``DetectProgram``) per bucket.

``dispatch`` enqueues a batch on the device and returns its Detections as
device tensors without synchronising; ``fetch`` synchronises and copies
them to numpy.

``DeviceDispatcher`` is the single device-facing thread: it dispatches
ONE-BEHIND — batch N is dispatched before batch N−1's results are pulled,
so the host-side fetch and conversion of N−1 overlap N's forward and NMS on
the device.  In continuous mode a ``DispatchGate`` tells the bucket
batchers when the device will take the next batch immediately, so partial
batches seal against it instead of waiting out the coalescing deadline.
The dispatcher heartbeats as ``serve-dispatch`` and spans each batch's
``serve_dispatch`` and ``serve_fetch``; ``warmup`` spans each program's
first run as ``serve_warmup``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import default_buckets
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import (
    DetectConfig,
    make_detect_fn,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.ops.nms import Detections
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import AssembledBatch
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


class IdentityLabelMap(dict):
    """label → category fallback when no mapping is known (labels ARE the
    category ids)."""

    def __missing__(self, key: int) -> int:
        return key


class DetectEngine:
    """A (bucket, batch) → detect-program table with routing metadata."""

    def __init__(
        self,
        fns: dict[tuple[int, int], dict[int, Callable]],
        min_side: int,
        max_side: int,
        label_to_cat_id: dict[int, int] | None = None,
        device: str | torch.device = "cuda",
        source: str = "live",
        version: str = "live",
    ):
        if not fns:
            raise ValueError("engine needs at least one (bucket, batch) program")
        self._fns = fns
        self.min_side = min_side
        self.max_side = max_side
        self.label_to_cat_id = (
            label_to_cat_id if label_to_cat_id else IdentityLabelMap()
        )
        self.device = resolve_device(device)
        # Where the programs came from (an export directory, or "live"),
        # and the rollout identity: the manifest's version, else the
        # export directory's basename, or "live" for from_state engines.
        self.source = source
        self.version = version
        self.buckets: tuple[tuple[int, int], ...] = tuple(sorted(fns))

    # ---- table lookups ---------------------------------------------------

    def batch_sizes(self, hw: tuple[int, int]) -> list[int]:
        return sorted(self._fns[hw])

    def max_batch(self, hw: tuple[int, int]) -> int:
        return max(self._fns[hw])

    def batch_size_for(self, hw: tuple[int, int], n: int) -> int:
        """Smallest batch size that fits ``n`` requests; the largest
        otherwise (the batcher never forms more than ``max_batch``)."""
        sizes = self.batch_sizes(hw)
        for b in sizes:
            if b >= n:
                return b
        return sizes[-1]

    # ---- device ----------------------------------------------------------

    def dispatch(self, hw: tuple[int, int], images: np.ndarray) -> Detections:
        """Enqueue one padded batch on the device; returns Detections as
        device tensors without synchronising (read them with ``fetch``)."""
        return self._fns[hw][images.shape[0]](images)

    def fetch(self, det: Detections) -> Detections:
        """Block until a dispatched batch finishes; numpy Detections."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return Detections(*(field.cpu().numpy() for field in det))

    def warmup(self) -> None:
        """Run every (bucket, batch) program once on a pad batch and sync,
        so first-call costs (cuDNN plans, the kernel build) stay out of the
        request path."""
        for hw in self.buckets:
            for b in self.batch_sizes(hw):
                with trace.span("serve_warmup", bucket=f"{hw[0]}x{hw[1]}", batch=b):
                    self.fetch(self.dispatch(hw, np.zeros((b, *hw, 3), np.uint8)))

    # ---- constructors ----------------------------------------------------

    @classmethod
    def from_export(
        cls, export_dir: str, device: str | torch.device = "cuda"
    ) -> "DetectEngine":
        """Engine over a ``convert_model`` export directory, on ``device``
        (``cuda`` unless the caller asks for the CPU; without a card it
        raises): needs torch and the NMS op, never the model code or the
        checkpoint."""
        from batchai_retinanet_horovod_coco_tpu_torch.evaluate.export import load_model

        loaded = load_model(export_dir, device)
        fns: dict[tuple[int, int], dict[int, Callable]] = {}
        for b, h, w in loaded.buckets():
            raw = loaded.fn(b, (h, w))

            # Exported programs return the bare (boxes, scores, labels,
            # valid) tuple; the conversion path reads Detections.
            def call(images, _raw=raw) -> Detections:
                return Detections(*_raw(images))

            fns.setdefault((h, w), {})[b] = call
        manifest = loaded.manifest
        raw_map = manifest.get("label_to_cat_id")
        label_map = {int(k): int(v) for k, v in raw_map.items()} if raw_map else None
        buckets = sorted(fns)
        # Without a recorded resize rule, the bucket extents keep routing
        # sane (every image fits some bucket).
        min_side = manifest.get("image_min_side") or min(min(hw) for hw in buckets)
        max_side = manifest.get("image_max_side") or max(max(hw) for hw in buckets)
        version = manifest.get("version") or os.path.basename(os.path.normpath(export_dir))
        return cls(
            fns, min_side, max_side, label_map, loaded.device, source=export_dir,
            version=str(version),
        )

    @classmethod
    def from_state(
        cls,
        model: torch.nn.Module,
        buckets: tuple[tuple[int, int], ...] | None = None,
        batch_sizes: tuple[int, ...] = (8,),
        config: DetectConfig | None = None,
        device: str | torch.device = "cuda",
        min_side: int = 800,
        max_side: int = 1333,
        label_to_cat_id: dict[int, int] | None = None,
    ) -> "DetectEngine":
        """Engine over a live model: one detect program per bucket × batch
        size, on ``device`` (``cuda`` unless the caller asks for the CPU;
        without a card it raises)."""
        device = resolve_device(device)
        if buckets is None:
            buckets = default_buckets(min_side, max_side)
        config = config or DetectConfig()
        fns: dict[tuple[int, int], dict[int, Callable]] = {}
        for hw in buckets:
            detect = make_detect_fn(model, hw, config, device)
            # One closure serves every batch size of a bucket: PyTorch runs
            # eagerly, so the table's entries differ only by the key.
            fns[hw] = {b: detect for b in sorted(set(batch_sizes))}
        return cls(fns, min_side, max_side, label_to_cat_id, device)


class DispatchGate:
    """The device-readiness handshake between the dispatcher and the bucket
    batchers (continuous mode).

    - **ready** (dispatcher → batchers): the next sealed batch will be
      dispatched immediately — the device is idle, or batch N's results
      just landed.  Set by the dispatcher, cleared by whoever consumes it.
    - **armed** (batchers → dispatcher): at least one bucket pool has
      claimed slots, so a brief post-fetch handoff wait can yield a batch.
    """

    __slots__ = ("_event", "_lock", "_armed")

    def __init__(self):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._armed: set = set()

    def set_ready(self) -> None:
        self._event.set()

    def clear(self) -> None:
        self._event.clear()

    def is_ready(self) -> bool:
        return self._event.is_set()

    def arm(self, key) -> None:
        with self._lock:
            self._armed.add(key)

    def disarm(self, key) -> None:
        with self._lock:
            self._armed.discard(key)

    def armed(self) -> bool:
        with self._lock:
            return bool(self._armed)


class DeviceDispatcher:
    """The single device thread: bounded in-queue → one-behind dispatch.

    ``on_batch(assembled, detections_np)`` runs HERE, after batch N+1 has
    been dispatched (or immediately when the queue is idle), so conversion
    overlaps device compute.  ``on_fatal(exc)`` routes a crash to the
    frontend.
    """

    _POLL_S = 0.05
    # Post-fetch handoff: how long the dispatcher gives an ARMED batcher to
    # seal against the just-raised gate before converting anyway.
    _HANDOFF_S = 0.02

    def __init__(
        self,
        engine: DetectEngine,
        batch_queue: queue.Queue,
        on_batch: Callable[[AssembledBatch, object], None],
        on_fatal: Callable[[BaseException], None],
        stop: threading.Event,
        gate: DispatchGate | None = None,
    ):
        self._engine = engine
        self._queue = batch_queue
        self._on_batch = on_batch
        self._on_fatal = on_fatal
        self._stop = stop
        self._gate = gate
        self.dispatched_batches = 0
        # watchdog: registers in _run() at thread start.
        self.thread = threading.Thread(
            target=self._run, daemon=True, name="serve-dispatch"
        )
        self.thread.start()

    def _dispatch(self, assembled: AssembledBatch):
        with trace.span(
            "serve_dispatch", bucket=f"{assembled.hw[0]}x{assembled.hw[1]}",
            n=len(assembled.requests),
        ):
            det = self._engine.dispatch(assembled.hw, assembled.images)
        self.dispatched_batches += 1
        if trace.enabled():
            trace.counter("serve.dispatch_qsize", self._queue.qsize())
        return det

    def _fetch(self, pending):
        assembled, det = pending
        with trace.span("serve_fetch", bucket=f"{assembled.hw[0]}x{assembled.hw[1]}"):
            return self._engine.fetch(det)

    def _finish(self, pending) -> None:
        self._on_batch(pending[0], self._fetch(pending))

    def _idle_flush(self, pending):
        """Queue ran dry with one batch in flight: fetch it now.  In
        continuous mode the gate rises the moment the results land, and a
        batch sealed against it is dispatched BEFORE the fetched batch's
        conversion.  Returns the new pending batch (or None)."""
        if self._gate is None:
            self._finish(pending)
            return None
        fetched = self._fetch(pending)
        self._gate.set_ready()
        nxt = None
        try:
            if self._gate.armed():
                nxt = self._queue.get(timeout=self._HANDOFF_S)
            else:
                nxt = self._queue.get_nowait()
        except queue.Empty:
            pass  # still idle: the gate stays set
        if nxt is not None:
            self._gate.clear()
            det = self._dispatch(nxt)
        self._on_batch(pending[0], fetched)
        return (nxt, det) if nxt is not None else None

    def _run(self) -> None:
        # Beats on every poll (an idle dispatcher is healthy): a fetch
        # hanging on the device stops the heartbeat.
        hb = watchdog.register(
            "serve-dispatch",
            details=lambda: {
                "qsize": self._queue.qsize(),
                "dispatched": self.dispatched_batches,
            },
        )
        pending = None
        try:
            while True:
                hb.beat()
                if self._stop.is_set():
                    return
                if self._gate is not None and pending is None:
                    self._gate.set_ready()  # fully idle device
                try:
                    if self._gate is not None and pending is not None:
                        # Continuous: never park a finished device round
                        # behind the poll.
                        assembled = self._queue.get_nowait()
                    else:
                        assembled = self._queue.get(timeout=self._POLL_S)
                except queue.Empty:
                    if pending is not None:
                        pending = self._idle_flush(pending)
                    continue
                if self._gate is not None:
                    self._gate.clear()
                det = self._dispatch(assembled)
                if pending is not None:
                    self._finish(pending)
                pending = (assembled, det)
        except Exception as exc:  # routed to the frontend: fails every future
            self._on_fatal(exc)
        finally:
            hb.close()
