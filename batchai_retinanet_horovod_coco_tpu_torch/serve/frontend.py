"""The serve frontend: admission control, request futures, stats, drain,
the HTTP frontend and the command line.

The JAX package's ``serve/frontend.py``: ``DetectionServer`` (``submit``,
``detect``, ``snapshot``, ``close`` and the context manager),
``serve_http`` (with the streaming sessions of ``serve/stream.py``) and
the serve CLI (with the stub engine of ``serve/stub.py``), with the obs
layer.  ``DetectionServer`` wires the four serve machines together::

    submit(image) ──► admission queue (bounded; full ⇒ shed)
                        │  router workers: decode → resize → bucket
                        ▼
    per-bucket queues (bounded; full ⇒ shed)
                        │  BucketBatcher: slot pool, seal on ready/full/deadline
                        ▼
    dispatch queue (bounded; full ⇒ backpressure)
                        │  DeviceDispatcher: one-behind device dispatch
                        ▼
    fetch → detections_to_coco per row → per-request futures fulfilled

Contracts:

- a served image's detections are exactly what ``make_detect_fn`` +
  ``detections_to_coco`` give for the same resized image in the same
  bucket (same resize, same row layout, same program, same conversion);
- every queue is bounded; overload surfaces as ``RequestRejected(reason)``;
- a crash in any serve thread fails every outstanding future with
  ``ServerError`` (original exception chained) and re-raises at the next
  ``submit()``;
- ``close()`` stops admission, waits (bounded) for in-flight requests,
  then stops the threads; it never hangs and is idempotent.

Observability: every request is a ``serve_request`` span from submit to
completion (tagged with its ``X-Retinanet-Trace`` id), each batch's
conversion a ``serve_convert`` span; ``self.telemetry`` is a pull-only
registry (the latency and slot-wait histograms, the ``snapshot()`` fields
and the watchdog's ages, all read at scrape time), served as ``GET
/metrics``, and ``GET /healthz`` is the watchdog's verdict; with an event
sink, ``serve_stats`` events land every ``STATS_EVERY_BATCHES`` batches.

The command line serves a ``convert_model`` export directory::

    python -m batchai_retinanet_horovod_coco_tpu_torch.serve --export-dir exported --http 8080
    python -m batchai_retinanet_horovod_coco_tpu_torch.serve --export-dir exported \
        --images photos/ --output detections.jsonl

    python -m batchai_retinanet_horovod_coco_tpu_torch.serve --stub-engine --http 0

Its flags are the JAX command line's, plus ``--device {cuda,cpu}``
(default ``cuda``, which raises without a card; the stub engine needs no
device); ``--platform`` is refused, naming ``ROADMAP.md``.  A replica that
the fleet spawns (``serve/replica.py``) carries ``--replica-id`` and joins
the fleet's trace through the ``RETINANET_OBS_DIR`` environment.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import signal
import socket
import sys
import threading

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import (
    detections_to_coco,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import BucketBatcher
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    AssembledBatch,
    DetectionFuture,
    LatencyStats,
    OccupancyStats,
    RequestRejected,
    RequestTimeout,
    ServeConfig,
    ServeError,
    ServeRequest,
    ServerClosed,
    ServerError,
    monotonic_s,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import (
    DetectEngine,
    DeviceDispatcher,
    DispatchGate,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.router import Router
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock

#: With an event sink, one ``serve_stats`` event every this many batches.
STATS_EVERY_BATCHES = 10


class DetectionServer:
    """Dynamic-batching inference server over a ``DetectEngine``."""

    def __init__(
        self,
        engine: DetectEngine,
        config: ServeConfig = ServeConfig(),
        warmup: bool = True,
        sink=None,
        replica_id: str | None = None,
    ):
        self.engine = engine
        self.config = config
        self.sink = sink  # an obs.events.EventSink (serve_stats events) or None
        # The identity the fleet router and canary gate attribute health
        # by: explicit (the fleet command line pins it across respawns so
        # the breaker readmits "the same" replica), else host-pid — stable
        # for the server's life, unique among a host's servers.  Tagged
        # onto every serve_request span.
        if replica_id is None:
            replica_id = f"{socket.gethostname()}-{os.getpid()}"
        self.replica_id = replica_id
        self.stats = LatencyStats(window=config.latency_window)
        # Pull-only registry: the quantiles read the latency window and the
        # collector reads snapshot(), at scrape time, so the request path
        # pays nothing for /metrics existing.
        self.telemetry = telemetry.Registry()
        self.telemetry.histogram(
            "serve_request_latency_ms",
            "request latency over the recent window (accepted requests)",
            source=self.stats.window_ms,
        )
        self._slot_waits: list[float] = []
        self.telemetry.histogram(
            "serve_slot_wait_ms",
            "ms a claimed slot waited between claim and seal (continuous "
            "in-flight batching admission latency)",
            source=self._slot_wait_window,
        )
        self.telemetry.register_collector(self._telemetry_samples)
        self.telemetry.register_collector(telemetry.watchdog_collector())
        # The card's allocator (nothing on the CPU): a fleet reads each
        # replica's peak memory from its /metrics.
        self.telemetry.register_collector(telemetry.device_memory_collector)
        if warmup:
            engine.warmup()

        self._stop = threading.Event()
        self._lock = make_lock("serve.frontend.DetectionServer._lock")
        self._drained = threading.Condition(self._lock)
        self._outstanding: dict[int, ServeRequest] = {}
        self._error: BaseException | None = None
        self._accepting = True
        self._closed = False
        self._ids = itertools.count()
        self._batches_done = 0
        self.occupancy = OccupancyStats()

        self._admission: queue.Queue = queue.Queue(
            maxsize=max(1, config.admission_queue)
        )
        self._bucket_queues = {
            hw: queue.Queue(maxsize=max(1, config.bucket_queue))
            for hw in engine.buckets
        }
        self._dispatch_queue: queue.Queue = queue.Queue(
            maxsize=max(1, config.dispatch_depth)
        )
        self._gate = DispatchGate() if config.continuous else None
        self._router = Router(
            engine,
            self._admission,
            self._bucket_queues,
            on_reject=self._reject,
            on_fatal=self._fail,
            stop=self._stop,
            workers=config.preprocess_workers,
        )
        self._batchers = [
            BucketBatcher(
                hw,
                engine,
                self._bucket_queues[hw],
                self._dispatch_queue,
                config.max_delay_ms,
                on_reject=self._reject,
                on_fatal=self._fail,
                stop=self._stop,
                gate=self._gate,
            )
            for hw in engine.buckets
        ]
        self._dispatcher = DeviceDispatcher(
            engine,
            self._dispatch_queue,
            on_batch=self._on_batch,
            on_fatal=self._fail,
            stop=self._stop,
            gate=self._gate,
        )

    # ---- client surface --------------------------------------------------

    def submit(
        self,
        image,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> DetectionFuture:
        """Enqueue one image (encoded JPEG/PNG bytes or an HWC uint8 RGB
        array); returns a future.  Raises
        ``RequestRejected`` when shed at admission, ``ServerClosed`` after
        close, ``ServerError`` after a crash.  ``trace_id`` tags the
        request's ``serve_request`` span (and a ``request`` flow step)."""
        self._raise_pending()
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        req = ServeRequest(
            next(self._ids),
            image,
            None if timeout_s is None else monotonic_s() + timeout_s,
            trace_id=trace_id,
        )
        if trace_id is None:
            req.span = trace.begin("serve_request", id=req.id, replica=self.replica_id)
        else:
            req.span = trace.begin(
                "serve_request", id=req.id, replica=self.replica_id, trace=trace_id
            )
            trace.flow_step("request", trace_id)
        # The accepting check and the registration share ONE lock
        # acquisition: close()/_fail() flip _accepting and then reject
        # everything registered, so a request registered after a lock-free
        # check could slip in after the reject sweep and never resolve.
        with self._lock:
            if not self._accepting:
                self.stats.record_shed("shutting_down")
                trace.end(req.span)
                raise ServerClosed("server is draining/closed")
            self._outstanding[req.id] = req
        try:
            self._admission.put_nowait(req)
        except queue.Full:
            exc = RequestRejected("admission_queue_full")
            self._reject(req, exc)
            raise exc from None
        if trace.enabled():
            trace.counter("serve.admission_qsize", self._admission.qsize())
        return req.future

    def detect(self, image, timeout_s: float | None = None) -> list[dict]:
        """Blocking convenience: ``submit()`` + ``result()``."""
        return self.submit(image, timeout_s=timeout_s).result()

    def snapshot(self) -> dict:
        """Stats + live queue depths."""
        snap = self.stats.snapshot()
        with self._lock:
            snap["outstanding"] = len(self._outstanding)
        snap["admission_qsize"] = self._admission.qsize()
        snap["bucket_qsize"] = {
            f"{hw[0]}x{hw[1]}": q.qsize()
            for hw, q in self._bucket_queues.items()
        }
        snap["dispatch_qsize"] = self._dispatch_queue.qsize()
        snap["batches"] = self._batches_done
        snap["deadline_fires"] = sum(b.deadline_fires for b in self._batchers)
        snap["full_fires"] = sum(b.full_fires for b in self._batchers)
        snap["ready_fires"] = sum(b.ready_fires for b in self._batchers)
        snap["slot_evictions"] = sum(b.pool.evictions for b in self._batchers)
        snap["free_slots"] = self.free_slots()
        snap["slot_capacity"] = sum(b.pool.capacity for b in self._batchers)
        occ = self.occupancy.snapshot()
        snap["occupancy_mean"] = occ.get("mean")
        snap["occupancy_last"] = occ.get("last")
        snap["continuous"] = self.config.continuous
        return snap

    def free_slots(self) -> int:
        """Unclaimed slots across every bucket's ASSEMBLING batch."""
        return sum(b.pool.free_slots() for b in self._batchers)

    def _slot_wait_window(self) -> list[float]:
        with self._lock:
            return list(self._slot_waits)

    def _telemetry_samples(self):
        """Scrape-time collector: the snapshot() fields as Prometheus
        families (counters for lifetime totals, gauges for live depths)."""
        snap = self.snapshot()
        yield ("serve_requests_completed_total", "counter",
               "requests completed successfully", None, snap["completed"])
        yield ("serve_requests_timeout_total", "counter",
               "requests that expired past their deadline", None,
               snap["timeouts"])
        yield ("serve_requests_failed_total", "counter",
               "requests failed by a server error", None, snap["failed"])
        for reason, n in sorted(snap["shed"].items()):
            yield ("serve_shed_total", "counter",
                   "requests shed by admission control, by reason",
                   {"reason": reason}, n)
        yield ("serve_batches_total", "counter",
               "device batches dispatched", None, snap["batches"])
        yield ("serve_deadline_fires_total", "counter",
               "partial batches fired by the coalescing deadline", None,
               snap["deadline_fires"])
        yield ("serve_ready_fires_total", "counter",
               "partial batches sealed by the dispatch gate (continuous "
               "in-flight batching)", None, snap["ready_fires"])
        yield ("serve_slot_evictions_total", "counter",
               "claimed slots freed by expired-deadline eviction at the "
               "dispatch window", None, snap["slot_evictions"])
        yield ("serve_free_slots", "gauge",
               "unclaimed slots across the assembling batches (idle "
               "device capacity the fleet router steers on)", None,
               snap["free_slots"])
        if snap["occupancy_mean"] is not None:
            yield ("serve_batch_occupancy_mean", "gauge",
                   "mean live-rows/batch-size over the recent batch "
                   "window", None, snap["occupancy_mean"])
            yield ("serve_batch_occupancy_last", "gauge",
                   "live-rows/batch-size of the last dispatched batch",
                   None, snap["occupancy_last"])
        yield ("serve_inflight", "gauge",
               "requests accepted and not yet resolved", None,
               snap["outstanding"])
        yield ("serve_queue_depth", "gauge", "live queue depths",
               {"queue": "admission"}, snap["admission_qsize"])
        yield ("serve_queue_depth", "gauge", "live queue depths",
               {"queue": "dispatch"}, snap["dispatch_qsize"])
        for bucket, depth in sorted(snap["bucket_qsize"].items()):
            yield ("serve_queue_depth", "gauge", "live queue depths",
                   {"queue": f"bucket_{bucket}"}, depth)
        yield ("serve_queue_capacity", "gauge",
               "configured queue bounds (the shed thresholds)",
               {"queue": "admission"}, max(1, self.config.admission_queue))
        yield ("serve_queue_capacity", "gauge",
               "configured queue bounds (the shed thresholds)",
               {"queue": "dispatch"}, max(1, self.config.dispatch_depth))

    def load_fields(self) -> dict:
        """The load summary the /healthz payload carries: identity,
        in-flight, queue depths against their bounds, the windowed p99 and
        the slot occupancy."""
        snap = self.snapshot()
        return {
            "replica_id": self.replica_id,
            "version": getattr(self.engine, "version", "live"),
            "inflight": snap["outstanding"],
            "admission_qsize": snap["admission_qsize"],
            "admission_capacity": max(1, self.config.admission_queue),
            "dispatch_qsize": snap["dispatch_qsize"],
            "bucket_qsize": snap["bucket_qsize"],
            "p99_ms": snap.get("p99_ms"),
            "completed": snap["completed"],
            "shed_total": snap["shed_total"],
            "free_slots": snap["free_slots"],
            "slot_capacity": snap["slot_capacity"],
            "occupancy": snap["occupancy_mean"],
            "accepting": self._accepting,
        }

    def close(self, drain: bool = True, timeout_s: float | None = None) -> None:
        """Stop accepting, optionally drain in-flight work, stop threads.

        Never hangs: the drain wait is bounded (``config.drain_timeout_s``
        unless overridden) and leftovers are rejected with
        ``ServerClosed``; idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._accepting = False
        if drain and self._error is None:
            budget = (
                self.config.drain_timeout_s if timeout_s is None else timeout_s
            )
            deadline = monotonic_s() + budget
            with self._drained:
                while self._outstanding:
                    remaining = deadline - monotonic_s()
                    if remaining <= 0:
                        break
                    self._drained.wait(timeout=min(remaining, 0.2))
        self._stop.set()
        self._reject_all(ServerClosed("server closed"))
        for t in (
            *self._router.threads,
            *(b.thread for b in self._batchers),
            self._dispatcher.thread,
        ):
            t.join(timeout=10)
        self._emit_stats(final=True)

    def __enter__(self) -> "DetectionServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))

    # ---- completion paths (any serve thread) -----------------------------

    def _finish(self, req: ServeRequest, *, result=None, error=None) -> bool:
        """Complete one request exactly once (both the fulfill and reject
        paths funnel here); False if it was already completed."""
        with self._lock:
            if self._outstanding.pop(req.id, None) is None:
                return False
            self._drained.notify_all()
        trace.end(req.span)
        if error is None:
            self.stats.record(monotonic_s() - req.t_submit)
            req.future._set_result(result)
        else:
            if isinstance(error, RequestRejected):
                self.stats.record_shed(error.reason)
            elif isinstance(error, RequestTimeout):
                self.stats.record_timeout()
            else:
                self.stats.record_failure()
            req.future._set_error(error)
        return True

    def _reject(self, req: ServeRequest, exc: BaseException) -> None:
        self._finish(req, error=exc)

    def _reject_all(self, exc: BaseException) -> None:
        with self._lock:
            pending = list(self._outstanding.values())
        for req in pending:
            self._finish(req, error=exc)

    def _fail(self, exc: BaseException) -> None:
        """Fatal error in any serve thread: record once, stop everything,
        fail every outstanding future."""
        with self._lock:
            if self._error is None:
                self._error = exc
            self._accepting = False
        self._stop.set()
        wrapped = ServerError("serve worker thread crashed")
        wrapped.__cause__ = exc
        self._reject_all(wrapped)

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise ServerError("serve worker thread crashed") from self._error

    # ---- batch completion (dispatcher thread) ----------------------------

    def _on_batch(self, assembled: AssembledBatch, det) -> None:
        """De-pad, convert and resolve ROW BY ROW: an early row's future
        resolves without waiting on its siblings' conversion.  The
        conversion is ``detections_to_coco`` on single-row views (strictly
        per-row math), so slicing cannot change any result; pad rows never
        convert."""
        reqs = assembled.requests
        n = assembled.images.shape[0]
        with trace.span(
            "serve_convert", bucket=f"{assembled.hw[0]}x{assembled.hw[1]}", n=len(reqs),
        ):
            for i, req in enumerate(reqs):
                row = type(det)(
                    det.boxes[i:i + 1], det.scores[i:i + 1],
                    det.labels[i:i + 1], det.valid[i:i + 1],
                )
                dets = detections_to_coco(
                    row,
                    np.array([req.id], dtype=np.int64),
                    assembled.scales[i:i + 1],
                    assembled.valid[i:i + 1],
                    self.engine.label_to_cat_id,
                    image_sizes={req.id: req.orig_wh},
                )
                for d in dets:
                    d.pop("image_id", None)  # request-scoped; transport
                if req.expired():
                    self._finish(req, error=RequestTimeout(
                        f"request {req.id} finished after its deadline"
                    ))
                else:
                    self._finish(req, result=dets)
        self._batches_done += 1
        self.occupancy.record(len(reqs) / max(1, n))
        if assembled.slot_wait_ms:
            with self._lock:
                self._slot_waits.extend(assembled.slot_wait_ms)
                if len(self._slot_waits) > 4096:
                    del self._slot_waits[:-4096]
        if telemetry.enabled():
            # Arguments built only when enabled: free_slots() takes a lock
            # a bucket pool.
            telemetry.record_serve_batch(
                occupancy=len(reqs) / max(1, n),
                free_slots=self.free_slots(),
                slot_wait_ms=assembled.slot_wait_ms,
            )
        if self.sink is not None and self._batches_done % STATS_EVERY_BATCHES == 0:
            self._emit_stats()

    def _emit_stats(self, final: bool = False) -> None:
        if self.sink is None:
            return
        try:
            self.sink.event("serve_stats", final=final, **_flatten(self.snapshot()))
            # The full latency distribution rides along for offline analysis.
            self.sink.histogram("serve.request_latency", self.stats.window_ms())
        except Exception:
            pass  # stats must never take the serving path down


def _flatten(snap: dict) -> dict:
    """Nested snapshot → JSONL-friendly flat fields."""
    out = {}
    for k, v in snap.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out[f"{k}.{kk}"] = vv
        else:
            out[k] = v
    return out


# ---- stdlib HTTP frontend ------------------------------------------------

#: Request header carrying a trace id, echoed on every /detect response.
TRACE_HEADER = trace.TRACE_HEADER


def serve_http(
    server: DetectionServer,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 60.0,
    stream=None,
):
    """Wrap a ``DetectionServer`` in a stdlib ``ThreadingHTTPServer``.

    POST /detect   (body = encoded image) → 200 ``{"detections": [...]}``;
                   400 on ``decode_error`` (the client's input, not
                   retryable), 503 with the reason on a shed (retryable),
                   504 on a deadline, 500 on a server error
    POST /stream/open   (JSON ``{width?, height?}``) → 200 ``{session,
                   bucket}``
    POST /stream/frame  (headers ``X-Retinanet-Stream`` and
                   ``X-Retinanet-Frame``, optional
                   ``X-Retinanet-Deadline-Ms``; body = encoded frame) → 200
                   ``{detections (with track_id), frame, cache_hit}``; 404
                   unknown session, 400 out of order or bad input, 503
                   backlogged or shed, 504 deadline (``serve/stream.py``)
    POST /stream/close  (header ``X-Retinanet-Stream``) → 200 final stats
    GET  /stream   → 200 JSON per-stream status snapshot
    GET  /stats    → 200 JSON stats snapshot
    GET  /metrics  → 200 Prometheus text exposition (``server.telemetry``)
    GET  /healthz  → 200 ``{"status": "ok", ...}`` with the load fields
                   while every watchdog component is within its budget,
                   503 naming the most-stalled component otherwise (a
                   read-only probe)
    anything else  → 404

    Every /detect and /stream response echoes the ``X-Retinanet-Trace``
    request header (an id is minted when it is absent) as that header and
    as a ``trace_id`` field; the id tags the request's ``serve_request``
    span.  ``request_timeout_s`` bounds each handler's wait on its future,
    so a client never hangs on a wedged pipeline.  The listen backlog is
    128 connections (the stdlib's is 5).  The stream manager (``stream``,
    else one made on the first ``/stream*`` request) is closed by
    ``server_close()``.  Returns the ``http.server`` instance; the caller
    owns ``serve_forever()`` and ``shutdown()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    # Made on first use: image-only servers never start its delivery
    # thread, and ``server_close`` below closes it if one was made.
    stream_lock = make_lock("serve.frontend.serve_http._stream_lock")
    stream_holder = [stream]

    def stream_manager():
        with stream_lock:
            if stream_holder[0] is None:
                from batchai_retinanet_horovod_coco_tpu_torch.serve.stream import (
                    StreamManager,
                )

                stream_holder[0] = StreamManager(server)
            return stream_holder[0]

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict, trace_id: str | None = None) -> None:
            if trace_id is not None:
                payload = {**payload, "trace_id": trace_id}
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            if trace_id is not None:
                self.send_header(TRACE_HEADER, trace_id)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/stats":
                self._json(200, server.snapshot())
            elif self.path == "/healthz":
                code, payload = telemetry.healthz()
                payload["load"] = server.load_fields()
                self._json(code, payload)
            elif self.path == "/stream":
                self._json(200, stream_manager().status())
            elif self.path == "/metrics":
                body = server.telemetry.prometheus_text().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not_found"})

        def _stream_rejected(self, exc: RequestRejected, trace_id: str) -> None:
            """The stream flavour of the status mapping: an unknown or
            retired session is 404 (re-open, do not retry), the client's
            protocol faults (bad input, a frame out of order) 400, anything
            transient 503."""
            if exc.reason == "unknown_stream":
                code = 404
            elif exc.reason in ("decode_error", "stream_out_of_order"):
                code = 400
            else:
                code = 503
            self._json(code, {"error": "rejected", "reason": exc.reason}, trace_id=trace_id)

        def _do_stream(self, trace_id: str) -> None:
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                if self.path == "/stream/open":
                    spec = json.loads(body) if body else {}
                    out = stream_manager().open_stream(
                        width=spec.get("width"), height=spec.get("height"), trace_id=trace_id,
                    )
                    self._json(200, out, trace_id=trace_id)
                elif self.path == "/stream/frame":
                    sid = self.headers.get("X-Retinanet-Stream", "")
                    try:
                        seq = int(self.headers.get("X-Retinanet-Frame", -1))
                        deadline_ms = self.headers.get("X-Retinanet-Deadline-Ms")
                        timeout_s = float(deadline_ms) / 1e3 if deadline_ms else None
                    except ValueError:
                        # A malformed header is the client's fault: 400,
                        # not a dropped connection.
                        raise RequestRejected("decode_error", "malformed stream header") from None
                    fut = stream_manager().submit_frame(
                        sid, seq, body, timeout_s=timeout_s, trace_id=trace_id,
                    )
                    dets = fut.result(timeout=request_timeout_s)
                    self._json(200, {"detections": dets, "frame": seq,
                                     "cache_hit": bool(getattr(fut, "cache_hit", False))},
                               trace_id=trace_id)
                elif self.path == "/stream/close":
                    sid = self.headers.get("X-Retinanet-Stream", "")
                    stats = stream_manager().close_stream(sid)
                    self._json(200, {"closed": sid, "stats": stats}, trace_id=trace_id)
                else:
                    self._json(404, {"error": "not_found"})
            except RequestRejected as exc:
                self._stream_rejected(exc, trace_id)
            except (RequestTimeout, TimeoutError):
                self._json(504, {"error": "deadline_exceeded"}, trace_id=trace_id)
            except Exception as exc:  # ServeError and anything unexpected
                # A handler fault answers 500 instead of closing the
                # connection mid-request.
                self._json(500, {"error": "server_error", "detail": str(exc)}, trace_id=trace_id)

        def do_POST(self):  # noqa: N802
            if self.path.startswith("/stream/"):
                self._do_stream(self.headers.get(TRACE_HEADER) or trace.new_trace_id())
                return
            if self.path != "/detect":
                self._json(404, {"error": "not_found"})
                return
            trace_id = self.headers.get(TRACE_HEADER) or trace.new_trace_id()
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                dets = server.submit(body, trace_id=trace_id).result(timeout=request_timeout_s)
            except RequestRejected as exc:
                code = 400 if exc.reason == "decode_error" else 503
                self._json(code, {"error": "rejected", "reason": exc.reason}, trace_id=trace_id)
            except (RequestTimeout, TimeoutError):
                self._json(504, {"error": "deadline_exceeded"}, trace_id=trace_id)
            except ServeError as exc:
                self._json(500, {"error": "server_error", "detail": str(exc)}, trace_id=trace_id)
            else:
                self._json(200, {"detections": dets}, trace_id=trace_id)

        def log_message(self, *args) -> None:
            pass  # the stats are the record

    class Server(ThreadingHTTPServer):
        # The listen backlog: at the stdlib's 5, a burst of clients gets
        # its connections dropped and retried a second later.
        request_queue_size = 128

        def server_close(self):
            with stream_lock:
                manager = stream_holder[0]
            if manager is not None:
                manager.close()
            super().server_close()

    return Server((host, port), Handler)


# ---- CLI -----------------------------------------------------------------

#: The JAX command line's flags that have no meaning here (``--device``
#: picks the device).
REFUSED_FLAGS = ("--platform",)
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def build_parser():
    import argparse

    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import (
        add_obs_flags,
        add_serve_flags,
    )

    p = argparse.ArgumentParser(
        description="Serve an exported detector (convert_model output) over "
                    "HTTP, or run it over a directory of images.",
    )
    p.add_argument("--export-dir", default=None,
                   help="export directory (manifest.json + .pt2 programs) "
                        "from convert_model; required unless --stub-engine")
    p.add_argument("--stub-engine", action="store_true",
                   help="serve the stub engine instead of an export: no "
                        "device work, one fixed detection per request "
                        "(serve/stub.py; the fleet's stub replicas)")
    p.add_argument("--stub-delay-ms", type=float, default=0.0,
                   help="stub engine per-dispatch delay (simulated device "
                        "time; lets harnesses shape p99)")
    p.add_argument("--stub-video", action="store_true",
                   help="stub engine video mode: each row's boxes derive "
                        "from that row's pixel brightness, so seeded drift "
                        "footage gives deterministic drifting boxes")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--http", type=int, metavar="PORT",
                      help="start the HTTP frontend on this port (0 = "
                           "ephemeral; serves until interrupted or SIGTERM)")
    mode.add_argument("--images", metavar="DIR",
                      help="offline mode: submit every image in DIR, write "
                           "detections JSONL, print stats, exit")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--output", default=None,
                   help="offline mode: detections JSONL path (default: "
                        "stdout summary only)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the programs run (the device they were "
                        "exported on); cuda raises without a card; the "
                        "stub engine ignores it")
    add_serve_flags(p)
    add_obs_flags(p)
    return p


def refuse_unported(argv: list[str]) -> None:
    """Raise ``SystemExit`` naming every flag of the JAX command line that
    the port refuses; ``argv`` is scanned before parsing."""
    refused = [a.split("=", 1)[0] for a in argv if a.split("=", 1)[0] in REFUSED_FLAGS]
    if refused:
        raise SystemExit(
            f"{', '.join(refused)}: not ported to the PyTorch package (pass --device "
            "for the device); see ROADMAP.md"
        )


def _run_offline(server: DetectionServer, image_dir: str, output: str | None) -> None:
    """Submit every image of ``image_dir`` in name order; on an admission
    shed block on the oldest in-flight future and retry, so a directory
    larger than the admission queue drains completely."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_writer

    names = sorted(n for n in os.listdir(image_dir) if n.lower().endswith(IMAGE_SUFFIXES))
    futures: list[tuple[str, DetectionFuture]] = []
    records: list[dict] = []

    def drain_one() -> None:
        name, fut = futures[len(records)]
        try:
            records.append({"file": name, "detections": fut.result()})
        except ServeError as exc:
            records.append({"file": name, "error": str(exc)})

    for name in names:
        with open(os.path.join(image_dir, name), "rb") as f:
            payload = f.read()
        while True:
            try:
                futures.append((name, server.submit(payload)))
                break
            except RequestRejected:
                if len(records) >= len(futures):
                    raise  # nothing in flight to wait on
                drain_one()
    while len(records) < len(futures):
        drain_one()
    if output:
        # Published complete or not at all.
        with atomic_writer(output) as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        print(f"wrote {len(records)} records to {output}")


def main(argv: list[str] | None = None) -> dict:
    """Run the command line ``argv``; returns the final stats snapshot.

    ``--obs-trace``/``--obs-dir`` trace the serve threads into the obs
    directory (``trace.json`` at exit, ``serve_stats``, ``watchdog_stall``
    and ``slo_violation`` events in its ``metrics.jsonl``); ``--obs-port``
    serves ``/metrics``, ``/healthz`` and ``/statusz`` on a port of its
    own and, like ``--slo-rule``, starts the SLO monitor (the watchdog
    stall rule always included).  A port that cannot bind raises.
    ``--numerics`` is the training step's and changes nothing here."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import (
        configure_obs,
        make_serve_config,
    )

    argv = list(sys.argv[1:] if argv is None else argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)
    if not args.stub_engine and args.export_dir is None:
        raise SystemExit("--export-dir is required (or pass --stub-engine)")
    # A fleet replica's process track in the merged trace carries its id.
    process_label = args.replica_id or "serve"
    obs_dir = configure_obs(args, process_label=process_label)
    # A replica that the fleet spawned joins the fleet's trace through the
    # RETINANET_OBS_DIR environment and exports its own fragment at exit;
    # explicit --obs-trace/--obs-dir flags win.
    joined_env = obs_dir is None and trace.maybe_configure_from_env(process_label)
    sink = None
    slo_monitor = None
    status_server = None
    server = None
    # SIGTERM exits through the same path as an interrupt: the server
    # drains instead of dying mid-request, and the trace is exported.
    def on_sigterm(_signum, _frame):
        raise KeyboardInterrupt

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, on_sigterm) if main_thread else None
    try:
        if args.stub_engine:
            from batchai_retinanet_horovod_coco_tpu_torch.serve.stub import StubDetectEngine

            engine = StubDetectEngine(delay_s=args.stub_delay_ms / 1e3, video=args.stub_video)
        else:
            engine = DetectEngine.from_export(args.export_dir, args.device)
        print(
            f"engine: buckets={engine.buckets} "
            f"batch_sizes={ {hw: engine.batch_sizes(hw) for hw in engine.buckets} } "
            f"resize={engine.min_side}/{engine.max_side} version={engine.version} "
            f"device={getattr(engine, 'device', 'none')}",
            flush=True,
        )
        if obs_dir is not None:
            from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog
            from batchai_retinanet_horovod_coco_tpu_torch.obs.events import EventSink

            sink = EventSink(obs_dir, stdout=False, run_config=vars(args))
            watchdog.default().sink = sink
        server = DetectionServer(engine, make_serve_config(args), sink=sink,
                                 replica_id=args.replica_id)
        if obs_dir is not None or args.slo_rule or args.obs_port is not None:
            telemetry.enable()  # the push record sites (record_serve_batch)
        if args.slo_rule or args.obs_port is not None:
            from batchai_retinanet_horovod_coco_tpu_torch.obs import slo

            slo_monitor = slo.SloMonitor(
                server.telemetry,
                [slo.stall_rule()] + [slo.parse_rule(r) for r in args.slo_rule or []],
                sink=sink,
                poll_interval=args.slo_poll_s,
            ).start()
        if args.obs_port is not None:
            # A scrape port apart from request traffic (and the only one
            # in the offline --images mode).
            status_server = telemetry.start_http_server(
                server.telemetry, port=args.obs_port, host=args.host
            )
            print(f"telemetry on http://{status_server.host}:{status_server.port} "
                  "(/metrics /healthz /statusz)", flush=True)
        if args.images is not None:
            _run_offline(server, args.images, args.output)
        else:
            httpd = serve_http(server, args.host, args.http)
            host, port = httpd.server_address[:2]
            print(f"serving on http://{host}:{port} (POST /detect /stream/*; "
                  "GET /stats /stream /metrics /healthz)", flush=True)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()
                # Drain before the socket closes: handlers still waiting
                # on their futures answer on their open connections.
                server.close()
                httpd.server_close()  # closes the stream manager too
        server.close()  # drained: the stats are final
        snap = server.snapshot()
        print(json.dumps({"serve_stats": snap}), flush=True)
        return snap
    finally:
        if slo_monitor is not None:
            slo_monitor.stop()
        if status_server is not None:
            status_server.close()
        if server is not None:
            server.close()
        if sink is not None:
            sink.close()
        if obs_dir is not None:
            from batchai_retinanet_horovod_coco_tpu_torch import obs

            merged = obs.finalize()
            if merged:
                print(f"obs: merged Chrome trace at {merged}", flush=True)
        elif joined_env:
            # A fleet-spawned replica exports its own fragment only; the
            # fleet process owns the merge.
            trace.export()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
