"""Shared serve-side vocabulary: config, request lifecycle, errors, stats.

The JAX package's ``serve/common.py``: the serve machines (admission
frontend, preprocess router, per-bucket batcher, one-behind device
dispatcher) speak these types.  Every way a request can fail carries an
explicit reason, because load shedding rejects with a reason instead of
growing latency without bound.  The clock and the quantiles are the obs
layer's (``obs/trace.py::monotonic_s``, ``obs/events.py::
latency_percentiles``), so spans and latencies read one clock.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, NamedTuple

import numpy as np

# One clock and one quantile implementation for spans, events and serve
# latencies.
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import latency_percentiles
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock


class ServeError(RuntimeError):
    """Base of everything the serve subsystem raises at the frontend."""


class RequestRejected(ServeError):
    """Admission control / load shedding: the request was NOT processed.

    ``reason`` is machine-readable: ``admission_queue_full``,
    ``bucket_queue_full``, ``shutting_down``, ``decode_error``, … — the
    shed counters key on it.
    """

    def __init__(self, reason: str, detail: str = ""):
        self.reason = reason
        super().__init__(
            f"request rejected ({reason})" + (f": {detail}" if detail else "")
        )


class RequestTimeout(ServeError):
    """The request's deadline expired before its result was produced."""


class ServerClosed(ServeError):
    """The server was closed (or drained past its budget) underneath the
    request."""


class ServerError(ServeError):
    """A serve worker thread crashed; the original exception is chained as
    ``__cause__`` (a crash re-raises at the frontend, never a silent hang)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frontend knobs.  Queue bounds are the load-shedding mechanism:
    every queue is bounded and a full queue sheds (rejects) instead of
    queueing without bound."""

    # Coalescing deadline: a partial batch fires at most this long after
    # its FIRST request reached the batcher.
    max_delay_ms: float = 10.0
    # Continuous in-flight batching: a partial batch seals the instant the
    # device can take it (the dispatch gate) or at the deadline, whichever
    # first.  False = deadline-only coalescing (seal only at full/deadline).
    # Both modes produce identical detections; only WHEN rows ride changes.
    continuous: bool = True
    # Bounded queues (admission = the front door; bucket = per-bucket
    # coalescing buffer; dispatch = assembled batches in flight to the
    # device, 2 = classic double buffering).
    admission_queue: int = 128
    bucket_queue: int = 64
    dispatch_depth: int = 2
    # Host decode/resize worker threads (the router).
    preprocess_workers: int = 2
    # Default per-request deadline (None = no deadline unless the caller
    # passes one to submit()).
    default_timeout_s: float | None = None
    # close(drain=True) waits this long for in-flight requests.
    drain_timeout_s: float = 30.0
    # Bounded window of recent request latencies the quantiles read.
    latency_window: int = 4096


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming-video session knobs (``serve/stream.py``): the frame-delta
    cache and the idle reaper, and the bounds that keep one stream a
    polite long-lived client of the slot pool."""

    # Frame-delta short-circuit: a frame whose decoded pixels differ from
    # the session's reference frame by LESS than this mean absolute delta
    # (uint8 counts, averaged over every pixel) returns the previous
    # frame's detections, track ids kept, without touching the device.
    # 0.0 disables the cache: every frame rides the device, and the stream
    # answers as the single-image path does.
    delta_threshold: float = 2.0
    # A session with no frame activity for this long (and nothing in
    # flight) is reaped by the delivery thread.
    idle_timeout_s: float = 30.0
    # Bounded session table: opens past this shed with stream_limit.
    max_streams: int = 64
    # Bounded per-stream in-flight frames (stream_backlogged past it).
    max_inflight: int = 8
    # Track stitching (host-side IoU matching over consecutive frames).
    track_iou: float = 0.3
    # A track unmatched for this many consecutive device-served frames is
    # dropped (its id is never reused within the session).
    track_max_misses: int = 5
    # Bounded window of recent frame latencies per session (p99 source).
    latency_window: int = 2048


class DetectionFuture:
    """The caller-side handle ``submit()`` returns.

    ``result()`` blocks until the request finishes and returns its
    COCO-style detection dicts (original-image coordinates), or raises the
    request's failure (``RequestRejected`` / ``RequestTimeout`` /
    ``ServerError`` / ``ServerClosed``).
    """

    __slots__ = ("_event", "_result", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._result: list[dict] | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> list[dict]:
        if not self._event.wait(timeout):
            raise TimeoutError("detection result not ready")
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise ServerError("future resolved without a result")
        return self._result

    # internal (frontend only)
    def _set_result(self, result: list[dict]) -> None:
        self._result = result
        self._event.set()

    def _set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()


class ServeRequest:
    """One request's internal record as it moves through the stages."""

    __slots__ = (
        "id", "payload", "deadline_t", "future", "t_submit", "span",
        "trace_id", "image", "scale", "orig_wh", "bucket",
    )

    def __init__(
        self,
        request_id: int,
        payload: Any,
        deadline_t: float | None,
        trace_id: str | None = None,
    ):
        self.id = request_id
        self.payload = payload  # encoded bytes or an HWC uint8 array
        self.deadline_t = deadline_t
        self.future = DetectionFuture()
        self.t_submit = monotonic_s()
        self.span = None  # the serve_request trace handle (frontend owns it)
        # The X-Retinanet-Trace id, tagged onto the serve_request span.
        self.trace_id = trace_id
        # set by the router's preprocess:
        self.image: np.ndarray | None = None
        self.scale: np.float32 = np.float32(1.0)
        self.orig_wh: tuple[int, int] = (0, 0)
        self.bucket: tuple[int, int] | None = None

    def expired(self, now: float | None = None) -> bool:
        if self.deadline_t is None:
            return False
        return (monotonic_s() if now is None else now) > self.deadline_t


class AssembledBatch(NamedTuple):
    """One padded device-ready batch (the batcher → dispatcher handoff)."""

    hw: tuple[int, int]
    images: np.ndarray  # (B, bh, bw, 3) uint8, pad rows = pad pixel
    requests: list  # the ≤B live ServeRequests, row-aligned
    scales: np.ndarray  # (B,) float32; 1.0 on pad rows
    valid: np.ndarray  # (B,) bool; False on pad rows
    # Per live row: ms between its slot claim and the seal (the
    # serve_slot_wait_ms telemetry source).
    slot_wait_ms: tuple = ()


class OccupancyStats:
    """Thread-safe bounded window of per-batch device occupancy (live rows
    / padded batch size)."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._window = max(16, window)
        self._values: list[float] = []
        self._batches = 0

    def record(self, occupancy: float) -> None:
        with self._lock:
            self._batches += 1
            self._values.append(float(occupancy))
            if len(self._values) > self._window:
                del self._values[: -self._window]

    def snapshot(self) -> dict:
        """{mean, last, batches} over the recent window ({} before the
        first batch)."""
        with self._lock:
            if not self._values:
                return {}
            return {
                "mean": round(sum(self._values) / len(self._values), 4),
                "last": round(self._values[-1], 4),
                "batches": self._batches,
            }


class LatencyStats:
    """Thread-safe serve counters + a bounded latency window; quantiles are
    computed lazily at ``snapshot()``, never on the request path."""

    def __init__(self, window: int = 4096):
        self._lock = make_lock("serve.common.LatencyStats._lock")
        self._window = max(16, window)
        self._latencies: list[float] = []
        self.completed = 0
        self.timeouts = 0
        self.failed = 0
        self.shed: dict[str, int] = {}

    def record(self, latency_s: float) -> None:
        with self._lock:
            self.completed += 1
            self._latencies.append(latency_s)
            if len(self._latencies) > self._window:
                del self._latencies[: -self._window]

    def record_shed(self, reason: str) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + 1

    def record_timeout(self) -> None:
        with self._lock:
            self.timeouts += 1

    def record_failure(self) -> None:
        with self._lock:
            self.failed += 1

    def window_ms(self) -> list[float]:
        """The raw recent-latency window in milliseconds (the sample set
        behind ``snapshot()``'s quantiles; the telemetry histogram's
        source)."""
        with self._lock:
            return [v * 1e3 for v in self._latencies]

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            out = {
                "completed": self.completed,
                "timeouts": self.timeouts,
                "failed": self.failed,
                "shed": dict(self.shed),
                "shed_total": sum(self.shed.values()),
            }
        if lat:
            pct = latency_percentiles(
                np.asarray(lat, dtype=np.float64) * 1e3, ps=(50, 99)
            )
            out.update(
                p50_ms=pct["p50_ms"],
                p99_ms=pct["p99_ms"],
                mean_ms=pct["mean_ms"],
                max_ms=pct["max_ms"],
                window=pct["count"],
            )
        return out
