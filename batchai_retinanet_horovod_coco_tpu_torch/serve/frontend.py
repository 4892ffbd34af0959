"""The serve frontend: admission control, request futures, stats, drain,
the HTTP frontend and the command line.

The JAX package's ``serve/frontend.py``: ``DetectionServer`` (``submit``,
``detect``, ``snapshot``, ``close`` and the context manager),
``serve_http`` and the serve CLI, without the obs layer (telemetry,
tracing spans, watchdog, events, SLOs), streaming and the stub engine.
``DetectionServer`` wires the four serve machines together::

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

The command line serves a ``convert_model`` export directory::

    python -m batchai_retinanet_horovod_coco_tpu_torch.serve --export-dir exported --http 8080
    python -m batchai_retinanet_horovod_coco_tpu_torch.serve --export-dir exported \
        --images photos/ --output detections.jsonl

Its flags are the JAX command line's, plus ``--device {cuda,cpu}``
(default ``cuda``, which raises without a card); the stub engine, obs,
SLO and replica flags and ``--platform`` are refused, naming
``ROADMAP.md``.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import signal
import sys
import threading
import uuid

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import (
    detections_to_coco,
)
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


class DetectionServer:
    """Dynamic-batching inference server over a ``DetectEngine``."""

    def __init__(
        self,
        engine: DetectEngine,
        config: ServeConfig = ServeConfig(),
        warmup: bool = True,
    ):
        self.engine = engine
        self.config = config
        self.stats = LatencyStats(window=config.latency_window)
        if warmup:
            engine.warmup()

        self._stop = threading.Event()
        self._lock = threading.Lock()
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

    def submit(self, image, timeout_s: float | None = None) -> DetectionFuture:
        """Enqueue one image (encoded JPEG/PNG bytes or an HWC uint8 RGB
        array); returns a future.  Raises
        ``RequestRejected`` when shed at admission, ``ServerClosed`` after
        close, ``ServerError`` after a crash."""
        self._raise_pending()
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        req = ServeRequest(
            next(self._ids),
            image,
            None if timeout_s is None else monotonic_s() + timeout_s,
        )
        # The accepting check and the registration share ONE lock
        # acquisition: close()/_fail() flip _accepting and then reject
        # everything registered, so a request registered after a lock-free
        # check could slip in after the reject sweep and never resolve.
        with self._lock:
            if not self._accepting:
                self.stats.record_shed("shutting_down")
                raise ServerClosed("server is draining/closed")
            self._outstanding[req.id] = req
        try:
            self._admission.put_nowait(req)
        except queue.Full:
            exc = RequestRejected("admission_queue_full")
            self._reject(req, exc)
            raise exc from None
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
        snap["free_slots"] = sum(b.pool.free_slots() for b in self._batchers)
        snap["slot_capacity"] = sum(b.pool.capacity for b in self._batchers)
        occ = self.occupancy.snapshot()
        snap["occupancy_mean"] = occ.get("mean")
        snap["occupancy_last"] = occ.get("last")
        snap["continuous"] = self.config.continuous
        return snap

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


# ---- stdlib HTTP frontend ------------------------------------------------

#: Request header carrying a trace id, echoed on every /detect response.
TRACE_HEADER = "X-Retinanet-Trace"


def serve_http(
    server: DetectionServer,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 60.0,
):
    """Wrap a ``DetectionServer`` in a stdlib ``ThreadingHTTPServer``.

    POST /detect   (body = encoded image) → 200 ``{"detections": [...]}``;
                   400 on ``decode_error`` (the client's input, not
                   retryable), 503 with the reason on a shed (retryable),
                   504 on a deadline, 500 on a server error
    GET  /stats    → 200 JSON stats snapshot
    anything else  → 404 (``/healthz``, ``/metrics`` and ``/stream*`` wait
                   for their slices)

    Every /detect response echoes the ``X-Retinanet-Trace`` request header
    (an id is minted when it is absent) as that header and as a
    ``trace_id`` field.  ``request_timeout_s`` bounds each handler's wait
    on its future, so a client never hangs on a wedged pipeline.  The
    listen backlog is 128 connections (the stdlib's is 5).  Returns the
    ``http.server`` instance; the caller owns ``serve_forever()`` and
    ``shutdown()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
            else:
                self._json(404, {"error": "not_found"})

        def do_POST(self):  # noqa: N802
            if self.path != "/detect":
                self._json(404, {"error": "not_found"})
                return
            trace_id = self.headers.get(TRACE_HEADER) or uuid.uuid4().hex[:16]
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                dets = server.submit(body).result(timeout=request_timeout_s)
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

    return Server((host, port), Handler)


# ---- CLI -----------------------------------------------------------------

#: The JAX command line's flags whose machinery is not ported.
REFUSED_FLAGS = (
    "--stub-engine", "--stub-delay-ms", "--stub-video", "--platform", "--replica-id",
    "--obs-trace", "--obs-dir", "--obs-stall-timeout", "--obs-port", "--slo-rule",
    "--slo-poll-s", "--numerics",
)
IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def build_parser():
    import argparse

    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import add_serve_flags

    p = argparse.ArgumentParser(
        description="Serve an exported detector (convert_model output) over "
                    "HTTP, or run it over a directory of images.",
    )
    p.add_argument("--export-dir", required=True,
                   help="export directory (manifest.json + .pt2 programs) "
                        "from convert_model")
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
                        "exported on); cuda raises without a card")
    add_serve_flags(p)
    return p


def refuse_unported(argv: list[str]) -> None:
    """Raise ``SystemExit`` naming every flag of the JAX command line whose
    machinery is not ported; ``argv`` is scanned before parsing."""
    refused = [a.split("=", 1)[0] for a in argv if a.split("=", 1)[0] in REFUSED_FLAGS]
    if refused:
        raise SystemExit(
            f"{', '.join(refused)}: not ported to the PyTorch package yet (the stub "
            "engine, the obs and SLO layers, replicas and --platform; pass --device "
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
    """Run the command line ``argv``; returns the final stats snapshot."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import make_serve_config

    argv = list(sys.argv[1:] if argv is None else argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)
    engine = DetectEngine.from_export(args.export_dir, args.device)
    print(
        f"engine: buckets={engine.buckets} "
        f"batch_sizes={ {hw: engine.batch_sizes(hw) for hw in engine.buckets} } "
        f"resize={engine.min_side}/{engine.max_side} version={engine.version} "
        f"device={engine.device}",
        flush=True,
    )

    # SIGTERM exits through the same path as an interrupt: the server
    # drains instead of dying mid-request.
    def on_sigterm(_signum, _frame):
        raise KeyboardInterrupt

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, on_sigterm) if main_thread else None
    server = DetectionServer(engine, make_serve_config(args))
    try:
        if args.images is not None:
            _run_offline(server, args.images, args.output)
        else:
            httpd = serve_http(server, args.host, args.http)
            host, port = httpd.server_address[:2]
            print(f"serving on http://{host}:{port} (POST /detect; GET /stats)", flush=True)
            try:
                httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                httpd.shutdown()
                # Drain before the socket closes: handlers still waiting
                # on their futures answer on their open connections.
                server.close()
                httpd.server_close()
        server.close()  # drained: the stats are final
        snap = server.snapshot()
        print(json.dumps({"serve_stats": snap}), flush=True)
        return snap
    finally:
        server.close()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
