"""Streaming video detection over the continuous batcher; the JAX
package's ``serve/stream.py`` for the port.

A camera is a long-lived client sending ordered frames under per-frame
deadlines; consecutive frames are usually near-identical, and the caller
wants detections it can follow across time.  This module adds that
workload as a thin layer over the serve stack, WITHOUT touching the
batcher: a stream is a polite long-lived ``submit()`` client plus three
session-local machines:

- **Session admission + in-order delivery** (``StreamManager``): a session
  pins its shape bucket at ``open_stream()``, enforces monotonic frame
  ordering at submit (``stream_out_of_order``; an admitted frame's
  sequence number is consumed even if it is shed later), caps per-stream
  in-flight frames (``stream_backlogged``), and delivers results strictly
  in frame order per stream however the device interleaves batches.  Idle
  sessions are reaped on an injectable clock.

- **Track stitching** (``TrackStitcher``): host-side greedy IoU matching
  of each served frame's detections against the session's live tracks,
  with the pairwise IoU of ``ops/iou.py`` on f32 CPU tensors (the JAX
  package runs its ``ops/iou.py`` there, which computes in f32 without
  x64).  Matched detections inherit the track id; unmatched ones mint a
  fresh id; a track unmatched for ``track_max_misses`` served frames is
  dropped.  ``track_id`` is the ONLY field stitching adds to a detection:
  strip it and the stream answer is the single-image path's.

- **Frame-delta cache**: before touching the device, a frame is diffed
  against the session's *reference frame* — the last frame actually
  dispatched.  A mean absolute pixel delta under
  ``StreamConfig.delta_threshold`` returns the previous served detections
  (track ids intact) without claiming a slot, and the saved decoded bytes
  are counted (``serve_stream_cache_hits_total`` / ``_bytes_total``).
  ``delta_threshold=0`` disables the cache: every frame rides the device.

Cache-hit results still flow through the in-order delivery queue.  Spans:
one ``stream_session`` per session and one ``stream_frame`` per frame,
both carrying the fleet trace id.
"""

from __future__ import annotations

import collections
import threading
import uuid
from typing import Any

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import bucket_for_source
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import latency_percentiles
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.ops.iou import pairwise_iou
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    DetectionFuture,
    RequestRejected,
    RequestTimeout,
    ServerClosed,
    StreamConfig,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.router import decode_payload
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock


def _xywh_to_xyxy(boxes: np.ndarray) -> np.ndarray:
    """COCO [x, y, w, h] → corner [x1, y1, x2, y2] (float64 host math)."""
    out = np.asarray(boxes, dtype=np.float64).reshape(-1, 4).copy()
    out[:, 2] += out[:, 0]
    out[:, 3] += out[:, 1]
    return out


def _pairwise_iou_host(a_xyxy: np.ndarray, b_xyxy: np.ndarray) -> np.ndarray:
    """The anchor matcher's pairwise corner IoU (``ops/iou.py``) on f32
    CPU tensors: the JAX package evaluates its own on these host arrays
    in f32 too."""
    a = torch.as_tensor(np.asarray(a_xyxy), dtype=torch.float32)
    b = torch.as_tensor(np.asarray(b_xyxy), dtype=torch.float32)
    return pairwise_iou(a, b).numpy()


class TrackStitcher:
    """Greedy IoU association of per-frame detections into stable tracks.

    One instance per stream session; single-threaded (the delivery
    thread owns it).  ``update()`` mutates the detection dicts in place,
    adding ``track_id`` — matched detections keep their track's id
    across frames, which is the whole contract a downstream consumer
    needs to draw persistent boxes.  Ids are minted monotonically per
    session and never reused.
    """

    def __init__(self, iou_threshold: float = 0.3, max_misses: int = 5):
        self.iou_threshold = float(iou_threshold)
        self.max_misses = int(max_misses)
        self._next_id = 0
        # Live tracks: {"id", "box" (xyxy), "cat", "misses"}.
        self._tracks: list[dict] = []

    def update(self, detections: list[dict]) -> None:
        """Assign ``track_id`` to every detection of one served frame."""
        matched_tracks: set[int] = set()
        if self._tracks and detections:
            det_xyxy = _xywh_to_xyxy(
                np.asarray([d["bbox"] for d in detections])
            )
            trk_xyxy = np.asarray([t["box"] for t in self._tracks])
            iou = np.array(
                _pairwise_iou_host(trk_xyxy, det_xyxy), dtype=np.float64
            )
            # Category gate: a person never continues a car's track.
            for ti, t in enumerate(self._tracks):
                for di, d in enumerate(detections):
                    if d.get("category_id") != t["cat"]:
                        iou[ti, di] = -1.0
            # Greedy best-first: repeatedly take the global best pair —
            # ties broken by (track, det) index order via argmax, so the
            # assignment is deterministic for identical inputs.
            while True:
                ti, di = np.unravel_index(np.argmax(iou), iou.shape)
                if iou[ti, di] < self.iou_threshold:
                    break
                det = detections[di]
                t = self._tracks[ti]
                det["track_id"] = t["id"]
                t["box"] = det_xyxy[di]
                t["misses"] = 0
                matched_tracks.add(ti)
                iou[ti, :] = -1.0
                iou[:, di] = -1.0
        # Unmatched detections open fresh tracks.
        for d in detections:
            if "track_id" not in d:
                tid = self._next_id
                self._next_id += 1
                d["track_id"] = tid
                self._tracks.append(
                    {
                        "id": tid,
                        "box": _xywh_to_xyxy(np.asarray([d["bbox"]]))[0],
                        "cat": d.get("category_id"),
                        "misses": 0,
                    }
                )
                matched_tracks.add(len(self._tracks) - 1)
        # Unmatched tracks age out.
        survivors = []
        for ti, t in enumerate(self._tracks):
            if ti not in matched_tracks:
                t["misses"] += 1
                if t["misses"] > self.max_misses:
                    continue
            survivors.append(t)
        self._tracks = survivors

    @property
    def live_tracks(self) -> int:
        return len(self._tracks)


class StreamFrameFuture(DetectionFuture):
    """``submit_frame``'s handle: a ``DetectionFuture`` that also says
    whether this frame was served by the delta cache (``cache_hit`` is
    final the moment ``submit_frame`` returns — the hit/miss decision is
    made at admission, not delivery)."""

    __slots__ = ("cache_hit",)

    def __init__(self, cache_hit: bool):
        super().__init__()
        self.cache_hit = cache_hit


class _FrameEntry:
    """One frame's place in a session's in-order delivery queue."""

    __slots__ = (
        "seq", "raw_future", "future", "cache_hit", "t_submit",
        "deadline_t", "span", "nbytes",
    )

    def __init__(self, seq, raw_future, future, cache_hit, t_submit,
                 deadline_t, span, nbytes):
        self.seq = seq
        self.raw_future = raw_future  # None on cache hits
        self.future = future
        self.cache_hit = cache_hit
        self.t_submit = t_submit
        self.deadline_t = deadline_t
        self.span = span
        self.nbytes = nbytes


class _Session:
    """Per-stream state.  ``lock`` guards everything mutable; the
    delivery thread and submit callers are the only writers."""

    def __init__(self, sid: str, bucket, config: StreamConfig,
                 trace_id: str | None, now: float):
        self.sid = sid
        self.bucket = bucket
        self.trace_id = trace_id
        self.lock = make_lock("serve.stream._Session.lock")
        self.next_seq = 0
        self.inflight: collections.deque[_FrameEntry] = collections.deque()
        # Seqs consumed by submit_frame whose _admit has not yet appended
        # an entry (or failed).  Delivery never pops past min(admitting):
        # a pipelined later frame that finishes admission first (e.g. a
        # cache hit overtaking a frame still in decode) must wait for the
        # earlier frame's entry, and the reaper never retires a session
        # with an admission in progress.
        self.admitting: set[int] = set()
        self.stitcher = TrackStitcher(
            iou_threshold=config.track_iou,
            max_misses=config.track_max_misses,
        )
        # Frame-delta cache state: the reference frame is the last frame
        # actually DISPATCHED (not the last frame seen), so slow drift
        # accumulates delta against the frame whose detections we keep
        # returning and eventually forces a device pass.
        self.reference: np.ndarray | None = None
        self.reference_seq = -1  # highest seq that set the reference
        self.last_dets: list[dict] = []
        self.last_active = now
        self.closed = False
        self.span = None
        # Counters (under lock).
        self.frames = 0
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.latencies_ms: list[float] = []

    def snapshot(self) -> dict:
        with self.lock:
            out = {
                "bucket": list(self.bucket),
                "frames": self.frames,
                "cache_hits": self.hits,
                "cache_misses": self.misses,
                "errors": self.errors,
                "inflight": len(self.inflight),
                "next_seq": self.next_seq,
                "live_tracks": self.stitcher.live_tracks,
            }
            lat = list(self.latencies_ms)
        pct = latency_percentiles(lat, ps=(50, 99))
        if pct:
            out.update(p50_ms=pct["p50_ms"], p99_ms=pct["p99_ms"])
        return out


class StreamManager:
    """Session table + delivery thread over one ``DetectionServer``.

    The manager never touches batcher internals: frames enter through
    the same ``server.submit()`` every single-image client uses (decoded
    pixels go in, so the served bytes are identical to the single-image
    path), and the slot pool interleaves stream rows with one-shot rows
    on claim order.  What the manager adds is the session contract:
    ordered admission, bounded per-stream in-flight, in-order delivery
    with track stitching, the frame-delta cache, and idle reaping.

    ``now_fn`` is the injectable clock (tests drive reaping without
    sleeping).
    """

    _POLL_BUSY_S = 0.002
    _POLL_IDLE_S = 0.05

    def __init__(self, server, config: StreamConfig | None = None,
                 now_fn=monotonic_s):
        self.server = server
        self.config = config or StreamConfig()
        self._now = now_fn
        self._lock = make_lock("serve.stream.StreamManager._lock")
        self._sessions: dict[str, _Session] = {}
        self._closed = False
        # Manager-wide counters (under self._lock).
        self._frames = 0
        self._hits = 0
        self._misses = 0
        self._bytes_saved = 0
        self._reaped = 0
        self._opened = 0
        self._latencies_ms: list[float] = []
        # Pull-plane registration on the server's registry: the fleet
        # metrics federation scrapes these through /metrics for free.
        reg = getattr(server, "telemetry", None)
        if reg is not None:
            reg.register_collector(self._telemetry_samples)
            reg.histogram(
                "serve_stream_frame_latency_ms",
                "per-frame submit→deliver latency across all streams",
                source=self._latency_window,
            )
        self._stop = threading.Event()
        # watchdog: registers in _run() at thread start.
        self._thread = threading.Thread(
            target=self._run, name="serve-stream-delivery", daemon=True
        )
        self._thread.start()

    # ---- session lifecycle -----------------------------------------------

    def open_stream(self, width: int | None = None,
                    height: int | None = None,
                    trace_id: str | None = None) -> dict:
        """Open a session pinned to the shape bucket that would serve a
        ``height`` × ``width`` source (engine's first bucket when the
        client doesn't declare dimensions).  Returns ``{"session",
        "bucket"}``; sheds with ``stream_limit`` past ``max_streams``."""
        engine = self.server.engine
        if width and height:
            bucket = bucket_for_source(
                int(height), int(width),
                engine.min_side, engine.max_side, engine.buckets,
            )
        else:
            bucket = tuple(engine.buckets[0])
        sid = uuid.uuid4().hex[:12]
        now = self._now()
        with self._lock:
            if self._closed:
                raise ServerClosed("stream manager closed")
            if len(self._sessions) >= self.config.max_streams:
                raise RequestRejected(
                    "stream_limit",
                    f"{len(self._sessions)} open sessions (max "
                    f"{self.config.max_streams})",
                )
            sess = _Session(sid, bucket, self.config, trace_id, now)
            sess.span = trace.begin(
                "stream_session", stream=sid,
                bucket=f"{bucket[0]}x{bucket[1]}",
                **({"trace": trace_id} if trace_id else {}),
            )
            self._sessions[sid] = sess
            self._opened += 1
        trace.instant(
            "stream_opened", stream=sid, bucket=f"{bucket[0]}x{bucket[1]}"
        )
        return {"session": sid, "bucket": list(bucket)}

    def close_stream(self, session_id: str) -> dict:
        """Explicit close: the session stops admitting immediately;
        already-in-flight frames still deliver in order, and the session
        record is retired once its queue drains.  Returns the final
        per-session stats snapshot."""
        sess = self._get(session_id)
        summary = sess.snapshot()
        with sess.lock:
            sess.closed = True
            drained = not sess.inflight and not sess.admitting
        if drained:
            self._retire(sess, reason="closed")
        return summary

    def reap_idle(self) -> list[str]:
        """Retire every session idle past ``idle_timeout_s`` with nothing
        in flight (public so tests can drive it on a fake clock; the
        delivery thread calls it every poll)."""
        now = self._now()
        reaped = []
        with self._lock:
            candidates = list(self._sessions.values())
        for sess in candidates:
            with sess.lock:
                idle = (
                    not sess.inflight
                    and not sess.admitting
                    and not sess.closed
                    and now - sess.last_active > self.config.idle_timeout_s
                )
            if idle:
                self._retire(sess, reason="idle")
                reaped.append(sess.sid)
        return reaped

    def _retire(self, sess: _Session, reason: str) -> None:
        with self._lock:
            if self._sessions.pop(sess.sid, None) is None:
                return  # already retired by a racing path
            if reason == "idle":
                self._reaped += 1
        # Close the admission door and fail anything that slipped past
        # it: a submit racing the reaper may have fetched the session
        # before the pop above — its entry would otherwise sit on a
        # queue the delivery thread never visits again (mirrors what
        # close()/_fatal do).
        with sess.lock:
            sess.closed = True
            leftovers = list(sess.inflight)
            sess.inflight.clear()
        for entry in leftovers:
            trace.end(entry.span)
            entry.future._set_error(RequestRejected(
                "unknown_stream", f"{sess.sid} retired ({reason})"
            ))
        trace.instant("stream_session_reaped", stream=sess.sid,
                      reason=reason, frames=sess.frames)
        trace.end(sess.span)
        sess.span = None

    def _get(self, session_id: str) -> _Session:
        with self._lock:
            sess = self._sessions.get(session_id)
        if sess is None:
            raise RequestRejected("unknown_stream", session_id)
        return sess

    # ---- the frame path ---------------------------------------------------

    def submit_frame(self, session_id: str, seq: int, payload: Any,
                     timeout_s: float | None = None,
                     trace_id: str | None = None) -> DetectionFuture:
        """Admit one frame.  ``seq`` must be exactly the session's next
        expected sequence number (monotonic from 0); a frame that is
        admitted consumes its seq even if it is then shed downstream —
        video frames are droppable and the client moves on.  Returns a
        future resolving to the frame's detections (each carrying
        ``track_id``) in strict frame order per stream."""
        sess = self._get(session_id)
        now = self._now()
        trace_id = trace_id or sess.trace_id
        with sess.lock:
            if sess.closed:
                raise RequestRejected("unknown_stream",
                                      f"{session_id} closed")
            sess.last_active = now
            if seq != sess.next_seq:
                raise RequestRejected(
                    "stream_out_of_order",
                    f"got seq {seq}, expected {sess.next_seq}",
                )
            if len(sess.inflight) >= self.config.max_inflight:
                raise RequestRejected(
                    "stream_backlogged",
                    f"{len(sess.inflight)} frames in flight (max "
                    f"{self.config.max_inflight})",
                )
            # Admitted: the seq is consumed from here on, even if decode
            # or downstream admission sheds the frame.
            sess.next_seq += 1
            sess.admitting.add(seq)
        span = trace.begin(
            "stream_frame", stream=session_id, seq=seq,
            **({"trace": trace_id} if trace_id else {}),
        )
        try:
            entry = self._admit(sess, seq, payload, timeout_s, trace_id,
                                now, span)
        except BaseException:
            with sess.lock:
                sess.admitting.discard(seq)
            trace.end(span)
            raise
        self._count_frame(entry)
        return entry.future

    def _admit(self, sess: _Session, seq: int, payload: Any,
               timeout_s: float | None, trace_id: str | None,
               now: float, span) -> _FrameEntry:
        # Decode HERE (not in the router) because the delta cache needs
        # pixels before deciding whether the device is involved at all.
        # decode_payload passes ndarrays through untouched, so a miss
        # hands the router the exact array it would have decoded itself
        # — the answer is the single-image path's.
        try:
            image = decode_payload(payload)
        except Exception as exc:
            raise RequestRejected("decode_error", str(exc)) from exc
        hit = False
        thr = self.config.delta_threshold
        with sess.lock:
            reference = sess.reference
        if thr > 0.0 and reference is not None \
                and reference.shape == image.shape:
            delta = float(
                np.mean(
                    np.abs(
                        image.astype(np.int16)
                        - reference.astype(np.int16)
                    )
                )
            )
            hit = delta < thr
        deadline_t = None if timeout_s is None else now + timeout_s
        fut = StreamFrameFuture(hit)
        if hit:
            entry = _FrameEntry(seq, None, fut, True, now, deadline_t,
                                span, int(image.nbytes))
        else:
            # The one real device path: the same submit() every
            # single-image client uses, slot-pool admission included.
            raw = self.server.submit(
                image, timeout_s=timeout_s, trace_id=trace_id
            )
            entry = _FrameEntry(seq, raw, fut, False, now, deadline_t,
                                span, int(image.nbytes))
        with sess.lock:
            sess.admitting.discard(seq)
            if sess.closed:
                # The session was retired between admission and the
                # queue append (idle reap racing this submit): without
                # this re-check the entry would land on a queue the
                # delivery thread never visits again and the future
                # would hang.  An already-dispatched raw future resolves
                # harmlessly with no waiter.
                raise RequestRejected(
                    "unknown_stream", f"{sess.sid} closed"
                )
            # Concurrent admissions can complete out of seq order (a
            # cache hit overtakes a frame still in decode): insert in
            # seq position so delivery stays strictly frame-ordered.
            q = sess.inflight
            idx = len(q)
            while idx > 0 and q[idx - 1].seq > seq:
                idx -= 1
            q.insert(idx, entry)
            if not hit and seq > sess.reference_seq:
                # Monotonic by seq: a stale miss finishing late must not
                # roll the reference back behind a newer dispatch.
                sess.reference = image
                sess.reference_seq = seq
        return entry

    def _count_frame(self, entry: _FrameEntry) -> None:
        with self._lock:
            self._frames += 1
            if entry.cache_hit:
                self._hits += 1
                self._bytes_saved += entry.nbytes
            else:
                self._misses += 1

    # ---- delivery ---------------------------------------------------------

    def _run(self) -> None:
        hb = watchdog.register(
            "serve-stream-delivery",
            details=lambda: {
                "sessions": len(self._sessions),
                "frames": self._frames,
            },
        )
        try:
            while not self._stop.is_set():
                progressed, busy = self._deliver_ready()
                self.reap_idle()
                if progressed or busy:
                    hb.beat()
                    if not progressed:
                        self._stop.wait(self._POLL_BUSY_S)
                else:
                    hb.idle()
                    self._stop.wait(self._POLL_IDLE_S)
        except BaseException as exc:
            self._fatal(exc)
        finally:
            hb.close()

    def _fatal(self, exc: BaseException) -> None:
        """Delivery-loop crash channel (thread-error-contract): refuse
        new work and re-raise in every waiting client — a frame future
        must never outlive the thread that would have resolved it."""
        with self._lock:
            self._closed = True
            sessions = list(self._sessions.values())
            self._sessions.clear()
        self._stop.set()
        for sess in sessions:
            with sess.lock:
                pending = list(sess.inflight)
                sess.inflight.clear()
                sess.closed = True
            for entry in pending:
                trace.end(entry.span)
                entry.future._set_error(exc)
            trace.end(sess.span)
            sess.span = None

    def _deliver_ready(self) -> tuple[bool, bool]:
        """One pass over every session's queue head: pop and resolve
        every entry that is ready, strictly in order.  Returns
        (progressed, anything_in_flight)."""
        progressed = False
        busy = False
        with self._lock:
            sessions = list(self._sessions.values())
        for sess in sessions:
            while True:
                with sess.lock:
                    if not sess.inflight:
                        busy = busy or bool(sess.admitting)
                        break
                    head = sess.inflight[0]
                    if sess.admitting and min(sess.admitting) < head.seq:
                        # An earlier frame is still mid-admission (decode
                        # or slot wait): its entry will insert ahead of
                        # the current head — delivering now would break
                        # strict frame order.
                        busy = True
                        break
                    if not head.cache_hit and not head.raw_future.done():
                        busy = True
                        break
                    sess.inflight.popleft()
                    resolved = self._resolve(sess, head)
                progressed = True
                if resolved is not None:
                    # Resolve OUTSIDE the session lock: result() waiters
                    # wake immediately and a slow waiter callback can't
                    # block admission.
                    entry, result, error = resolved
                    self._finish(sess, entry, result, error)
            with sess.lock:
                drained_close = (
                    sess.closed and not sess.inflight and not sess.admitting
                )
            if drained_close:
                self._retire(sess, reason="closed")
        return progressed, busy

    def _resolve(self, sess: _Session, entry: _FrameEntry):
        """Under ``sess.lock``: turn a ready entry into (entry, result,
        error), updating stitcher / cache state."""
        now = self._now()
        if entry.cache_hit:
            if entry.deadline_t is not None and now > entry.deadline_t:
                return entry, None, RequestTimeout(
                    f"stream frame seq={entry.seq} deadline expired"
                )
            # The hit's payload is whatever the stream most recently
            # served — per-dict copies so callers can't mutate shared
            # session state.
            return entry, [dict(d) for d in sess.last_dets], None
        try:
            dets = entry.raw_future.result(timeout=0)
        except BaseException as exc:  # shed/timeout/server error
            sess.errors += 1
            return entry, None, exc
        sess.stitcher.update(dets)
        sess.last_dets = dets
        return entry, [dict(d) for d in dets], None

    def _finish(self, sess: _Session, entry: _FrameEntry, result, error):
        latency_ms = (self._now() - entry.t_submit) * 1e3
        with sess.lock:
            sess.frames += 1
            if entry.cache_hit:
                sess.hits += 1
            elif error is None:
                sess.misses += 1
            sess.latencies_ms.append(latency_ms)
            if len(sess.latencies_ms) > self.config.latency_window:
                del sess.latencies_ms[: -self.config.latency_window]
        with self._lock:
            self._latencies_ms.append(latency_ms)
            if len(self._latencies_ms) > 4096:
                del self._latencies_ms[:-4096]
        telemetry.record_stream_frame(
            cache_hit=entry.cache_hit, latency_ms=latency_ms
        )
        trace.end(entry.span)
        if error is not None:
            entry.future._set_error(error)
        else:
            entry.future._set_result(result)

    # ---- observability ----------------------------------------------------

    def _latency_window(self) -> list[float]:
        with self._lock:
            return list(self._latencies_ms)

    def _telemetry_samples(self):
        with self._lock:
            sessions = len(self._sessions)
            frames, hits, misses = self._frames, self._hits, self._misses
            saved, reaped = self._bytes_saved, self._reaped
        yield ("serve_stream_sessions", "gauge",
               "open streaming sessions", None, sessions)
        yield ("serve_stream_frames_total", "counter",
               "frames admitted across all streams", None, frames)
        yield ("serve_stream_cache_hits_total", "counter",
               "frames short-circuited by the frame-delta cache",
               None, hits)
        yield ("serve_stream_cache_misses_total", "counter",
               "frames dispatched to the device", None, misses)
        yield ("serve_stream_cache_bytes_total", "counter",
               "decoded bytes the delta cache kept off the device",
               None, saved)
        yield ("serve_stream_reaped_total", "counter",
               "idle sessions retired by the reaper", None, reaped)

    def status(self) -> dict:
        """The /stream status payload: manager counters + per-session
        snapshots (frames, hit rate, in-flight, live tracks, p50/p99)."""
        with self._lock:
            sessions = dict(self._sessions)
            out = {
                "sessions_open": len(sessions),
                "sessions_opened": self._opened,
                "frames": self._frames,
                "cache_hits": self._hits,
                "cache_misses": self._misses,
                "cache_bytes_saved": self._bytes_saved,
                "reaped": self._reaped,
            }
            lat = list(self._latencies_ms)
        pct = latency_percentiles(lat, ps=(50, 99))
        if pct:
            out.update(
                frame_p50_ms=pct["p50_ms"], frame_p99_ms=pct["p99_ms"]
            )
        out["streams"] = {sid: s.snapshot() for sid, s in sessions.items()}
        return out

    # ---- shutdown ---------------------------------------------------------

    def close(self) -> None:
        """Stop the delivery thread and fail every undelivered frame
        with ``ServerClosed`` (exactly-once: frames already delivered
        are untouched)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._thread.join(timeout=10.0)
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for sess in sessions:
            with sess.lock:
                pending = list(sess.inflight)
                sess.inflight.clear()
                sess.closed = True
            for entry in pending:
                trace.end(entry.span)
                entry.future._set_error(
                    ServerClosed("stream manager closed")
                )
            trace.end(sess.span)
            sess.span = None


__all__ = [
    "StreamManager",
    "StreamFrameFuture",
    "TrackStitcher",
    "StreamConfig",
]
