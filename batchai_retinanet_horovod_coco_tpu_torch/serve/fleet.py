"""Fault-tolerant serve fleet: replicated servers behind a health-weighted
router with circuit breaking, fleet admission control and an SLO-gated
canary; the JAX package's ``serve/fleet.py`` for the port.

``FleetRouter`` reads each replica's ``/healthz`` 200 payload, whose
``load`` block is the server's ``load_fields()`` (replica_id, version,
inflight, queue depth against its bound, windowed p99, free slots,
accepting), and turns it into routing weights — continuously, via a
health poller on an injectable clock, so the whole state machine is
testable without sleeping.

The machines:

- **Weighting** (``replica_weight``): queue headroom x inflight damping x
  slot occupancy x relative p99 — a loaded or slow replica takes
  proportionally less traffic *before* it is sick enough to shed.
- **Circuit breaker** (per replica): CLOSED → OPEN on a health-poll
  failure or 503, on a request that finds the replica dead, and on
  ``shed_trip`` *consecutive* request sheds; OPEN → HALF_OPEN when the
  breaker's bounded backoff (with deterministic per-replica jitter,
  ``utils/backoff.py``) elapses; the next health poll IS the half-open
  probe — success readmits (CLOSED, weight restored), failure re-opens
  with the next backoff step.
- **Re-dispatch**: a request on a replica that dies under it
  (``ReplicaUnavailable``) is re-dispatched to another replica AT MOST
  ``redispatch_limit`` times (default once), and only if its deadline
  allows.  A replica-level shed (503) is retried on another replica under
  the SAME budget; timeouts and ``decode_error`` are request outcomes,
  never retried.
- **Fleet admission control**: over ``max_inflight`` (default: the sum of
  the replicas' advertised admission capacities) the fleet sheds at the
  edge with ``fleet_overloaded``; with no routable replica it sheds
  ``no_replica_available``.
- **Canary gate** (``add_canary``): a replica of another export
  ``version`` takes ``canary_weight``-scaled traffic while a dedicated
  ``SloMonitor`` (``obs/slo.py``, on the same injectable clock) watches
  its p99 ratio against the fleet baseline and its shed rate.  A
  sustained breach drains it and returns the fleet to its base weights
  with exactly ONE ``canary_rollback`` event.
- **Stream pins**: a client stream is pinned to the replica its session
  was opened on (the delta cache and track stitcher are per-replica
  state) and re-pinned on replica death.

Everything observable lands in ``router.telemetry`` (fleet latency, per
replica weight and breaker gauges, shed, re-dispatch and rollback
counters), served as ``GET /metrics`` by the fleet frontend
(``serve_fleet_http``), next to every replica's own series scraped from
its ``/metrics`` and re-exposed with a ``replica`` label (federation) and
the fleet aggregates (``fleet_availability``, ``fleet_federated_p99_ms``,
``fleet_federated_shed_total``) the fleet SLO rules read.  Every fleet
state transition emits a structured event and a ``trace.instant`` with the
replica id.  The fleet edge mints one trace id a request
(``X-Retinanet-Trace``), spans the routing as ``fleet_request`` and passes
the id to the replica, whose ``serve_request`` span carries it.

The command line (``python -m
batchai_retinanet_horovod_coco_tpu_torch.serve.fleet``) spawns replicas
of the serve command line, supervises and respawns them, and arms the
canary and the autoscaler (``serve/autoscale.py``); its ``--device``
(default ``cuda``, which raises without a card) is where spawned
``--export-dir`` replicas serve.  Stub replicas (``--stub-engine``) need
no device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import random
import sys
import threading
import uuid
import zlib
from typing import Any

from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.telemetry import (
    Registry,
    parse_exposition_samples,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import emit_event
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    LatencyStats,
    RequestRejected,
    RequestTimeout,
    ServerError,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.replica import (
    ReplicaUnavailable,
)
from batchai_retinanet_horovod_coco_tpu_torch.utils.backoff import BackoffPolicy
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock

# Breaker states (also the fleet_breaker_state gauge encoding).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
DRAINED = "drained"  # canary rolled back / replica administratively out
_STATE_CODE = {CLOSED: 0.0, HALF_OPEN: 1.0, OPEN: 2.0, DRAINED: 3.0}


def replica_weight(load: dict | None, p99_ref: float | None = None) -> float:
    """One replica's routing weight from its advertised load fields.

    ``headroom / (1 + inflight/capacity)``, scaled down by
    ``p99_ref / p99`` when this replica's windowed p99 is worse than the
    fleet's best (``p99_ref``), and by the slot-occupancy factor
    ``(1 + free_slots/slot_capacity) / 2`` when the replica advertises
    its assembling-batch slots: a replica whose device slots
    are fully claimed takes half the traffic of one with an idle pool,
    so the fleet steers load AT idle device capacity before queues ever
    grow.  Replicas that don't advertise slots (older builds) get the
    neutral factor 1 — the deterministic tie-break is the formula
    itself: identical load fields always produce identical weights, and
    the router's candidate order is fixed by replica_id.  0 means
    unroutable: not accepting, or no admission headroom left (the edge
    sheds instead of queueing).  Pure.
    """
    if not load or not load.get("accepting", False):
        return 0.0
    cap = max(1, int(load.get("admission_capacity") or 1))
    qsize = max(0, int(load.get("admission_qsize") or 0))
    headroom = max(0.0, 1.0 - qsize / cap)
    inflight = max(0, int(load.get("inflight") or 0))
    w = headroom / (1.0 + inflight / cap)
    slot_cap = load.get("slot_capacity")
    if slot_cap and int(slot_cap) > 0:
        free = min(
            max(0, int(load.get("free_slots") or 0)), int(slot_cap)
        )
        w *= (1.0 + free / int(slot_cap)) / 2.0
    p99 = load.get("p99_ms")
    if p99 and p99_ref and float(p99) > 0 and float(p99_ref) > 0:
        w *= min(1.0, float(p99_ref) / float(p99))
    return round(w, 6)


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Router knobs.  The breaker backoff is a shared ``BackoffPolicy``;
    each replica derives a deterministic per-replica jitter seed from its
    id, so probe schedules are reproducible but decorrelated."""

    poll_interval_s: float = 1.0
    # Health-poll failures/503s before a CLOSED breaker opens (1 = the
    # first failed poll opens it — a poll failure is already a timeout's
    # worth of evidence).
    fail_threshold: int = 1
    # CONSECUTIVE request-level sheds before the breaker opens (sheds are
    # load signals first; a run of them is a sick replica).
    shed_trip: int = 3
    # Half-open probe cadence after the breaker opens.
    probe_backoff: BackoffPolicy = BackoffPolicy(
        max_tries=1_000_000, base_s=0.5, multiplier=2.0, ceiling_s=10.0,
        jitter=0.2,
    )
    # Fleet admission bound; None = sum of advertised admission
    # capacities of routable replicas (re-derived as replicas come/go).
    max_inflight: int | None = None
    # Default per-request deadline at the fleet edge.
    default_timeout_s: float | None = 30.0
    # A dead replica's in-flight requests are re-dispatched at most this
    # many times (deadline allowing).
    redispatch_limit: int = 1
    # Canary weight fraction while under SLO evaluation.
    canary_weight: float = 0.25
    # Canary gate rules: p99 ratio vs fleet baseline + shed-per-poll.
    canary_p99_factor: float = 1.5
    canary_shed_per_poll: float = 0.0
    canary_for_s: float = 5.0
    canary_poll_s: float = 1.0
    # Canary drain budget on rollback (LocalReplica close bound).
    canary_drain_timeout_s: float = 5.0
    latency_window: int = 4096
    seed: int = 0
    # Streaming affinity: a fleet-edge stream pin with no
    # frame activity for this long is dropped by the health-poll sweep
    # (the replica-side session reaps itself independently; a client
    # returning after a reap gets ``unknown_stream`` and re-opens).
    stream_idle_timeout_s: float = 60.0


# Backend rejection reasons raised BEFORE the replica's StreamManager
# consumes the frame's sequence number (its admission checks).  Anything
# else that surfaces after admission — decode_error, a queue-full shed
# landing on the frame's future, a deadline expiry — has already
# advanced the backend's expected seq, and the edge must advance with
# it or every later frame on the stream sheds ``stream_out_of_order``.
_STREAM_PRE_ADMISSION = frozenset({
    "unknown_stream", "stream_out_of_order", "stream_backlogged",
    "stream_limit", "shutting_down", "no_replica_available",
})


class _StreamPin:
    """One client stream's fleet-edge affinity record: the
    client-facing session id maps to a pinned replica plus the BACKEND
    session living on it.  ``lock`` serializes this stream's frames
    through the edge — monotonic ordering and re-pin atomicity come from
    the same mutex (concurrency across streams is untouched; one stream's
    frames are inherently sequential anyway)."""

    __slots__ = (
        "sid", "lock", "st", "backend_sid", "backend_seq", "next_seq",
        "width", "height", "trace_id", "last_active", "repins",
    )

    def __init__(self, sid, st, backend_sid, width, height, trace_id,
                 now: float):
        self.sid = sid
        self.lock = make_lock("serve.fleet._StreamPin.lock")
        self.st = st  # the pinned _ReplicaState
        self.backend_sid = backend_sid
        self.backend_seq = 0  # the PINNED replica's expected seq
        self.next_seq = 0  # the CLIENT-facing expected seq
        self.width = width
        self.height = height
        self.trace_id = trace_id
        self.last_active = now
        self.repins = 0


class _ReplicaState:
    __slots__ = (
        "replica", "state", "weight", "load", "poll_failures",
        "shed_strikes", "open_count", "next_probe_t", "is_canary",
    )

    def __init__(self, replica, is_canary: bool = False):
        self.replica = replica
        self.state = CLOSED
        self.weight = 0.0
        self.load: dict = {}
        self.poll_failures = 0
        self.shed_strikes = 0
        self.open_count = 0  # backoff step for the half-open probe
        self.next_probe_t = 0.0
        self.is_canary = is_canary


class FleetRouter:
    """N replicas behind one weighted, breaker-guarded ``detect()``.

    ``detect()`` is blocking and thread-safe (the fleet HTTP frontend
    calls it from per-request handler threads); ``poll_once(now=...)``
    advances the health/breaker state machine on an injectable clock —
    ``start_polling()`` runs it on a watchdog-registered thread in
    production, tests drive it directly.
    """

    def __init__(
        self,
        replicas: list,
        config: FleetConfig = FleetConfig(),
        sink: Any = None,
        auto_poll: bool = True,
        initial_poll: bool = True,
    ):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        self.config = config
        self.sink = sink
        self.stats = LatencyStats(window=config.latency_window)
        self._states = [_ReplicaState(r) for r in replicas]
        self._lock = make_lock("serve.fleet.FleetRouter._lock")
        self._rng = random.Random(config.seed)
        self._accepting = True
        self._inflight = 0
        self._error: BaseException | None = None
        self._redispatches = 0
        self._breaker_opens = 0
        self._rollbacks = 0
        # Streaming affinity: client session id → pin.
        self._streams: dict[str, _StreamPin] = {}
        self._stream_repins = 0
        # Canary machinery (armed by add_canary).
        self._canary: _ReplicaState | None = None
        self._canary_monitor = None
        self._canary_outcome: str | None = None  # None|rolled_back|promoted

        # Metrics federation: replica_id → (types, samples)
        # from the last successful scrape of that replica's /metrics;
        # re-exposed replica-labeled by _federation_samples.
        self._federated: dict[str, tuple[dict, list]] = {}
        self._fed_error: BaseException | None = None

        self.telemetry = Registry()
        self.telemetry.histogram(
            "fleet_request_latency_ms",
            "fleet-edge request latency over the recent window",
            source=self.stats.window_ms,
        )
        self.telemetry.register_collector(self._telemetry_samples)
        self.telemetry.register_collector(self._federation_samples)
        # The fleet process's own health (poller / scrape / supervisor
        # heartbeats) on the same scrape surface, so the built-in stall
        # SLO rule works at the fleet edge too.
        self.telemetry.register_collector(telemetry.watchdog_collector())

        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fed_thread: threading.Thread | None = None
        if initial_poll:
            self.poll_once()
        if auto_poll:
            self.start_polling()

    # ---- identity helpers ------------------------------------------------

    def _backoff_for(self, st: _ReplicaState) -> BackoffPolicy:
        """The shared probe policy, re-seeded per replica id so probe
        jitter is deterministic yet decorrelated across the fleet."""
        seed = zlib.crc32(str(st.replica.replica_id).encode())
        return dataclasses.replace(
            self.config.probe_backoff, seed=self.config.seed ^ seed
        )

    # ---- health poll + breaker state machine -----------------------------

    def poll_once(self, now: float | None = None) -> None:
        """One health sweep: poll every replica that is due, apply the
        breaker transitions, recompute weights.  Injectable ``now``."""
        now = monotonic_s() if now is None else now
        for st in list(self._states):
            probing = False
            with self._lock:
                if st.state == DRAINED:
                    continue
                if st.state == OPEN:
                    if now < st.next_probe_t:
                        continue  # still backing off
                    st.state = HALF_OPEN  # this poll IS the probe
                    probing = True
            if probing:
                # Half-open is a fleet decision too: on the
                # timeline it explains the probe traffic that follows.
                emit_event(
                    "fleet_breaker_half_open", sink=self.sink,
                    replica_id=st.replica.replica_id,
                )
            try:
                code, payload = st.replica.healthz()
            except Exception as exc:  # a poller can never crash on a replica
                code, payload = 0, {"status": "poll_error", "error": repr(exc)}
            self._apply_poll(st, code, payload, now)
        self._recompute_weights()
        self._reap_stale_pins(now)

    def _apply_poll(
        self, st: _ReplicaState, code: int, payload: dict, now: float
    ) -> None:
        with self._lock:
            if code == 200:
                st.load = dict(payload.get("load") or {})
                st.poll_failures = 0
                st.shed_strikes = 0
                if st.state in (OPEN, HALF_OPEN):
                    st.state = CLOSED
                    st.open_count = 0
                    emit_event(
                        "fleet_breaker_close", sink=self.sink,
                        replica_id=st.replica.replica_id,
                    )
                return
            # Unhealthy poll (503 / unreachable / crashed).
            st.poll_failures += 1
            if st.state == CLOSED:
                if st.poll_failures >= self.config.fail_threshold:
                    self._open_locked(
                        st, now,
                        reason=str(payload.get("status") or f"healthz_{code}"),
                    )
            elif st.state == HALF_OPEN:
                # Probe failed: back to OPEN with the next backoff step.
                self._open_locked(st, now, reason="half_open_probe_failed")

    def _open_locked(
        self, st: _ReplicaState, now: float, reason: str
    ) -> None:
        """Transition to OPEN and schedule the half-open probe (caller
        holds the lock).  EVERY open — including a failed half-open
        probe re-opening — emits the event pair (no silent fleet
        transitions)."""
        st.state = OPEN
        st.weight = 0.0
        delay = self._backoff_for(st).delay_s(st.open_count)
        st.open_count += 1
        st.next_probe_t = now + delay
        self._breaker_opens += 1
        emit_event(
            "fleet_breaker_open", sink=self.sink,
            replica_id=st.replica.replica_id,
            reason=reason,
            probe_in_s=round(delay, 3),
        )

    def _note_request_failure(self, st: _ReplicaState) -> None:
        """A request found this replica dead (``ReplicaUnavailable``):
        open the breaker immediately — don't wait for the next poll."""
        with self._lock:
            if st.state in (CLOSED, HALF_OPEN):
                self._open_locked(st, monotonic_s(), reason="request_failed")

    def _note_request_shed(self, st: _ReplicaState) -> None:
        """A request-level 503: a load signal first, a breaker signal
        after ``shed_trip`` CONSECUTIVE ones."""
        with self._lock:
            st.shed_strikes += 1
            if st.state == CLOSED and st.shed_strikes >= self.config.shed_trip:
                self._open_locked(
                    st, monotonic_s(), reason="consecutive_sheds"
                )

    def _recompute_weights(self) -> None:
        with self._lock:
            routable = [
                st for st in self._states
                if st.state == CLOSED and st.load.get("accepting", False)
            ]
            p99s = [
                float(st.load["p99_ms"]) for st in routable
                if st.load.get("p99_ms")
            ]
            p99_ref = min(p99s) if p99s else None
            for st in self._states:
                if st.state != CLOSED:
                    st.weight = 0.0
                    continue
                w = replica_weight(st.load, p99_ref)
                if st.is_canary and self._canary_outcome is None:
                    w *= self.config.canary_weight
                st.weight = w

    # ---- routing ---------------------------------------------------------

    def _pick(self, exclude: set[int]) -> _ReplicaState | None:
        with self._lock:
            candidates = [
                st for st in self._states
                if st.state == CLOSED and st.weight > 0.0
                and id(st) not in exclude
            ]
            if not candidates:
                return None
            # Deterministic tie-break: the weighted draw walks
            # candidates in replica_id order, never registration/arrival
            # order, so equal weights resolve identically across runs
            # given the seeded RNG.
            candidates.sort(key=lambda st: str(st.replica.replica_id))
            total = sum(st.weight for st in candidates)
            x = self._rng.random() * total
            for st in candidates:
                x -= st.weight
                if x <= 0.0:
                    return st
            return candidates[-1]

    def _fleet_capacity(self) -> int:
        if self.config.max_inflight is not None:
            return self.config.max_inflight
        with self._lock:
            caps = [
                int(st.load.get("admission_capacity") or 0)
                for st in self._states
                if st.state == CLOSED
            ]
        return max(1, sum(caps))

    def detect(
        self,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> list[dict]:
        """Route one request; blocking.  Raises the serve taxonomy:
        ``RequestRejected(reason)`` on any shed (fleet edge or replica),
        ``RequestTimeout`` past the deadline, ``ServerError`` when every
        eligible replica failed underneath it.

        ``trace_id`` is the fleet-wide span context: minted
        here when tracing is on and none was supplied, wrapped in a
        ``fleet_request`` span on the edge track, and propagated to the
        replica handles so each attempt's ``serve_request`` span parents
        under the SAME id — a re-dispatched request's spans land on both
        replicas' tracks, linked by one Perfetto flow."""
        self._raise_pending()
        t0 = monotonic_s()
        if trace_id is None and trace.enabled():
            trace_id = trace.new_trace_id()
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        deadline = None if timeout_s is None else t0 + timeout_s
        with self._lock:
            accepting = self._accepting
        if not accepting:
            self.stats.record_shed("shutting_down")
            raise RequestRejected("shutting_down")
        cap = self._fleet_capacity()
        with self._lock:
            if self._inflight >= cap:
                over = True
            else:
                over = False
                self._inflight += 1
        if over:
            self.stats.record_shed("fleet_overloaded")
            raise RequestRejected(
                "fleet_overloaded", f"fleet inflight at capacity {cap}"
            )
        span = (
            trace.begin("fleet_request", trace=trace_id)
            if trace_id is not None
            else None
        )
        if trace_id is not None:
            trace.flow_start("request", trace_id)
        try:
            return self._dispatch(payload, deadline, t0, trace_id)
        finally:
            # Terminate the flow on EVERY exit — failed and re-dispatched
            # requests are exactly the ones a post-mortem follows across
            # tracks, so their arrow chain must close too.
            if trace_id is not None:
                trace.flow_end("request", trace_id)
            trace.end(span)
            with self._lock:
                self._inflight -= 1

    def _dispatch(
        self, payload, deadline, t0: float, trace_id: str | None = None
    ) -> list[dict]:
        tried: set[int] = set()
        last_exc: BaseException | None = None
        attempts = self.config.redispatch_limit + 1
        for attempt in range(attempts):
            now = monotonic_s()
            if deadline is not None and now >= deadline:
                self.stats.record_timeout()
                raise RequestTimeout(
                    "fleet deadline expired before dispatch"
                ) from last_exc
            st = self._pick(tried)
            if st is None:
                if last_exc is None:
                    self.stats.record_shed("no_replica_available")
                    raise RequestRejected(
                        "no_replica_available",
                        "no routable replica (breakers open or zero headroom)",
                    )
                break  # a failure with no alternate left — classify below
            tried.add(id(st))
            if attempt > 0:
                with self._lock:
                    self._redispatches += 1
                # Sink event + trace instant: the re-dispatch
                # carries the trace id, so the hop from replica A's shed/
                # death to replica B's span is explicit on the timeline.
                emit_event(
                    "fleet_redispatch", sink=self.sink,
                    replica_id=st.replica.replica_id,
                    attempt=attempt,
                    **({"trace": trace_id} if trace_id else {}),
                )
            remaining = None if deadline is None else deadline - now
            try:
                if trace_id is None:
                    dets = st.replica.detect(payload, timeout_s=remaining)
                else:
                    dets = st.replica.detect(
                        payload, timeout_s=remaining, trace_id=trace_id
                    )
            except ReplicaUnavailable as exc:
                self._note_request_failure(st)
                self._recompute_weights()
                last_exc = exc
                continue  # deadline-checked at the top of the loop
            except RequestRejected as exc:
                if exc.reason == "decode_error":
                    # The client's fault — never a breaker/redispatch signal.
                    self.stats.record_shed(exc.reason)
                    raise
                self._note_request_shed(st)
                last_exc = exc
                continue
            except RequestTimeout:
                self.stats.record_timeout()
                raise
            with self._lock:
                st.shed_strikes = 0
            self.stats.record(monotonic_s() - t0)
            return dets
        # Exhausted: classify by the last replica-side outcome.
        if isinstance(last_exc, RequestRejected):
            self.stats.record_shed(last_exc.reason)
            raise last_exc
        self.stats.record_failure()
        err = ServerError(
            "every eligible replica failed this request "
            f"(redispatch limit {self.config.redispatch_limit})"
        )
        err.__cause__ = last_exc
        raise err

    def _raise_pending(self) -> None:
        if self._error is not None:
            raise ServerError("fleet health poller crashed") from self._error

    # ---- streaming session affinity ---------------------------

    def stream_open(
        self,
        width: int | None = None,
        height: int | None = None,
        trace_id: str | None = None,
    ) -> dict:
        """Open a client stream: pick a replica with the weighted draw,
        open a BACKEND session on it, and pin the stream there — every
        subsequent frame routes to the pin (the delta cache and track
        stitcher are per-replica state; affinity is what makes them
        work).  The client-facing session id is minted HERE, decoupled
        from the backend id, so a re-pin is invisible to the client."""
        self._raise_pending()
        with self._lock:
            accepting = self._accepting
        if not accepting:
            self.stats.record_shed("shutting_down")
            raise RequestRejected("shutting_down")
        if trace_id is None and trace.enabled():
            trace_id = trace.new_trace_id()
        tried: set[int] = set()
        last_exc: BaseException | None = None
        for _ in range(self.config.redispatch_limit + 1):
            st = self._pick(tried)
            if st is None:
                break
            tried.add(id(st))
            try:
                out = st.replica.stream_open(
                    width=width, height=height, trace_id=trace_id
                )
            except ReplicaUnavailable as exc:
                self._note_request_failure(st)
                self._recompute_weights()
                last_exc = exc
                continue
            except RequestRejected as exc:
                # A per-replica session-table limit: try elsewhere.
                self._note_request_shed(st)
                last_exc = exc
                continue
            sid = uuid.uuid4().hex[:12]
            pin = _StreamPin(
                sid, st, out["session"], width, height, trace_id,
                monotonic_s(),
            )
            with self._lock:
                self._streams[sid] = pin
            return {
                "session": sid,
                "bucket": out.get("bucket"),
                "replica_id": st.replica.replica_id,
            }
        if isinstance(last_exc, RequestRejected):
            self.stats.record_shed(last_exc.reason)
            raise last_exc
        self.stats.record_shed("no_replica_available")
        raise RequestRejected(
            "no_replica_available", "no routable replica for stream open"
        ) from last_exc

    def stream_frame(
        self,
        session_id: str,
        seq: int,
        payload,
        timeout_s: float | None = None,
        trace_id: str | None = None,
    ) -> tuple[list[dict], bool]:
        """Route one frame to the stream's pinned replica; returns
        ``(detections, cache_hit)``.  On replica death the frame is NOT
        dropped: the breaker path re-pins the stream to another replica
        (one structured ``stream_repinned`` event) and retries the frame
        there — the new backend session starts a fresh track/cache
        history, which is the documented continuity cost of a kill."""
        self._raise_pending()
        with self._lock:
            pin = self._streams.get(session_id)
        if pin is None:
            self.stats.record_shed("unknown_stream")
            raise RequestRejected("unknown_stream", session_id)
        if timeout_s is None:
            timeout_s = self.config.default_timeout_s
        with pin.lock:
            pin.last_active = monotonic_s()
            if seq != pin.next_seq:
                raise RequestRejected(
                    "stream_out_of_order",
                    f"got seq {seq}, expected {pin.next_seq}",
                )
            pin.next_seq += 1
            return self._stream_dispatch(
                pin, seq, payload, timeout_s, trace_id or pin.trace_id
            )

    def _stream_dispatch(
        self, pin: _StreamPin, seq: int, payload, timeout_s, trace_id
    ) -> tuple[list[dict], bool]:
        """Under ``pin.lock``: one frame's pin → (maybe re-pin) → retry
        arc.  Bounded attempts; client-fault rejections propagate
        immediately (never a re-pin signal)."""
        last_exc: BaseException | None = None
        reopened = False
        for _attempt in range(3):
            st = pin.st
            with self._lock:
                routable = st.state == CLOSED and st.weight > 0.0
            if routable:
                try:
                    dets, hit = st.replica.stream_frame(
                        pin.backend_sid, pin.backend_seq, payload,
                        timeout_s=timeout_s, trace_id=trace_id,
                    )
                except ReplicaUnavailable as exc:
                    last_exc = exc
                    self._note_request_failure(st)
                    self._recompute_weights()
                except RequestRejected as exc:
                    if (
                        exc.reason in ("unknown_stream",
                                       "stream_out_of_order")
                        and not reopened
                    ):
                        # unknown_stream: the pinned replica no longer
                        # knows our backend session (supervisor respawned
                        # it in place, or its idle reaper fired).
                        # stream_out_of_order: the edge's and backend's
                        # seq counters drifted (e.g. an ambiguous
                        # transport timeout whose frame did or did not
                        # reach the backend) — the edge enforces client
                        # ordering itself, so a backend ordering reject
                        # can only mean drift.  Both resync the same
                        # way: re-open on the SAME replica — affinity
                        # survives, history resets.
                        reopened = True
                        try:
                            out = st.replica.stream_open(
                                width=pin.width, height=pin.height,
                                trace_id=trace_id,
                            )
                            pin.backend_sid = out["session"]
                            pin.backend_seq = 0
                            continue
                        except (ReplicaUnavailable, RequestRejected) as e2:
                            last_exc = e2
                            self._note_request_failure(st)
                            self._recompute_weights()
                    else:
                        # Backlog/decode/etc: the frame's outcome, not a
                        # replica-death signal — surface it.
                        if exc.reason == "stream_backlogged":
                            self._note_request_shed(st)
                        elif exc.reason not in _STREAM_PRE_ADMISSION:
                            # Post-admission shed: the backend consumed
                            # this seq — advance ours in lockstep or the
                            # stream wedges on stream_out_of_order.
                            pin.backend_seq += 1
                        self.stats.record_shed(exc.reason)
                        raise
                except RequestTimeout:
                    # The frame was admitted and missed its deadline
                    # downstream: the backend's seq advanced.  (A
                    # transport-level timeout that never reached the
                    # backend leaves the edge one ahead — the
                    # stream_out_of_order resync above heals that on the
                    # next frame.)
                    pin.backend_seq += 1
                    self.stats.record_timeout()
                    raise
                else:
                    pin.backend_seq += 1
                    with self._lock:
                        st.shed_strikes = 0
                    return dets, hit
            if not self._repin(pin, seq, trace_id):
                self.stats.record_shed("no_replica_available")
                raise RequestRejected(
                    "no_replica_available",
                    "stream pin lost and no routable replica left",
                ) from last_exc
        self.stats.record_failure()
        err = ServerError(
            "stream frame failed after re-pin "
            f"(stream {pin.sid}, frame {seq})"
        )
        err.__cause__ = last_exc
        raise err

    def _repin(self, pin: _StreamPin, seq: int, trace_id) -> bool:
        """Move a stream whose pinned replica died: weighted-draw a new
        replica (excluding the dead pin), open a fresh backend session,
        emit exactly ONE structured ``stream_repinned`` event (trace
        instant + sink + stderr)."""
        old = pin.st
        exclude = {id(old)}
        while True:
            st = self._pick(exclude)
            if st is None:
                return False
            exclude.add(id(st))
            try:
                out = st.replica.stream_open(
                    width=pin.width, height=pin.height, trace_id=trace_id
                )
            except (ReplicaUnavailable, RequestRejected) as exc:
                if isinstance(exc, ReplicaUnavailable):
                    self._note_request_failure(st)
                    self._recompute_weights()
                continue
            pin.st = st
            pin.backend_sid = out["session"]
            pin.backend_seq = 0
            pin.repins += 1
            with self._lock:
                self._stream_repins += 1
            emit_event(
                "stream_repinned", sink=self.sink,
                stream=pin.sid,
                from_replica=old.replica.replica_id,
                to_replica=st.replica.replica_id,
                frame=seq,
                **({"trace": trace_id} if trace_id else {}),
            )
            return True

    def stream_close(self, session_id: str) -> dict:
        """Drop the pin and close the backend session (best-effort: the
        pin is gone either way, and the replica's idle reaper backstops
        a close that never reached it)."""
        with self._lock:
            pin = self._streams.pop(session_id, None)
        if pin is None:
            raise RequestRejected("unknown_stream", session_id)
        with pin.lock:
            try:
                return pin.st.replica.stream_close(pin.backend_sid)
            except (ReplicaUnavailable, RequestRejected):
                return {}

    def _reap_stale_pins(self, now: float) -> None:
        """Drop fleet-edge pins idle past ``stream_idle_timeout_s``
        (poll-thread housekeeping; the replica-side session reaps its own
        state independently)."""
        timeout = self.config.stream_idle_timeout_s
        with self._lock:
            stale = [
                sid for sid, pin in self._streams.items()
                if now - pin.last_active > timeout
            ]
            for sid in stale:
                self._streams.pop(sid, None)
        for sid in stale:
            emit_event("fleet_stream_reaped", sink=self.sink, stream=sid)

    # ---- elastic membership -----------------------------------

    def active_replica_count(self) -> int:
        """Non-drained replicas — the autoscaler's notion of capacity
        (a draining victim already stopped counting)."""
        with self._lock:
            return sum(1 for st in self._states if st.state != DRAINED)

    def add_replica(self, replica) -> None:
        """Admit a new replica at weight ZERO: it takes traffic only
        after its first successful health poll populates its load fields
        — the same admission a half-open probe applies to a readmitted
        replica, so a sick spawn never takes weight."""
        st = _ReplicaState(replica)
        with self._lock:
            self._states.append(st)
        emit_event(
            "fleet_replica_joined", sink=self.sink,
            replica_id=replica.replica_id,
            version=getattr(replica, "version", "unknown"),
        )

    def begin_drain(self, replica_id: str) -> bool:
        """Administratively drain one replica (the scale-down path): no
        new traffic routes to it, pinned streams re-pin on their next
        frame, and it drops out of the occupancy aggregates AND the
        federated view immediately — capacity being reclaimed must never
        be double-counted by the control loop."""
        with self._lock:
            st = next(
                (s for s in self._states
                 if s.replica.replica_id == replica_id), None,
            )
            if st is None or st.state == DRAINED:
                return False
            st.state = DRAINED
            st.weight = 0.0
            self._federated.pop(replica_id, None)
        emit_event("fleet_replica_draining", sink=self.sink, replica_id=replica_id)
        self._recompute_weights()
        return True

    def remove_replica(self, replica_id: str) -> bool:
        """Forget a replica entirely (drain finished, or the respawn
        budget abandoned its slot)."""
        with self._lock:
            st = next(
                (s for s in self._states
                 if s.replica.replica_id == replica_id), None,
            )
            if st is None:
                return False
            self._states.remove(st)
            self._federated.pop(replica_id, None)
            if self._canary is st:
                self._canary = None
        emit_event("fleet_replica_removed", sink=self.sink, replica_id=replica_id)
        self._recompute_weights()
        return True

    # ---- metrics federation -----------------------------------

    def scrape_metrics_once(self) -> None:
        """One federation sweep: pull every non-drained replica's
        ``/metrics`` (``metrics_text()`` on the handle — in-process or
        HTTP) and cache the parsed samples for re-exposition.  A replica
        that fails the scrape DROPS out of the federated view (stale
        series must not masquerade as live), and handles without a
        ``metrics_text`` surface are simply skipped — federation is
        read-only and strictly optional per replica."""
        with self._lock:
            handles = [
                (st.replica.replica_id, st.replica)
                for st in self._states
                if st.state != DRAINED
            ]
        for rid, replica in handles:
            scrape = getattr(replica, "metrics_text", None)
            text = None
            if scrape is not None:
                try:
                    text = scrape()
                except Exception:
                    text = None  # a scrape can never crash the sweep
            if text is None:
                with self._lock:
                    self._federated.pop(rid, None)
                continue
            parsed = parse_exposition_samples(text)
            with self._lock:
                self._federated[rid] = parsed

    def _federation_samples(self):
        """Scrape-time collector: the federated replica series,
        replica-labeled, plus the derived fleet aggregates the SLO
        monitor's fleet-level rules evaluate."""
        with self._lock:
            fed = dict(self._federated)
        p99s: list[float] = []
        shed_total = 0.0
        for rid in sorted(fed):
            types, samples = fed[rid]
            for name, labels, value in samples:
                kind = types.get(name, "untyped")
                if kind == "summary":
                    # Re-exposed quantile series are plain samples here
                    # (the replica owns the summary's _count/_sum pair,
                    # which ride through as their own untyped families).
                    kind = "gauge"
                lab = dict(labels)
                lab["replica"] = rid
                yield (
                    name, kind, "federated from the replica's /metrics",
                    lab, value,
                )
                if (
                    name == "serve_request_latency_ms"
                    and labels.get("quantile") == "0.99"
                ):
                    p99s.append(value)
                elif name == "serve_shed_total":
                    shed_total += value
        if p99s:
            yield (
                "fleet_federated_p99_ms", "gauge",
                "worst replica-local windowed p99 across the federated "
                "scrape (the fleet-level aggregate p99 ceiling input)",
                None, round(max(p99s), 4),
            )
        if fed:
            yield (
                "fleet_federated_shed_total", "gauge",
                "requests shed across all federated replicas (sum of "
                "the replica-local serve_shed_total series)",
                None, shed_total,
            )

    def federated_snapshot(self) -> dict[str, float]:
        """The flat fleet-scope metric view (``Registry.snapshot()`` over
        the fleet registry): edge series, per-replica federated series
        keyed ``name{...,replica="<id>"}``, and the fleet aggregates —
        exactly what the SLO monitor evaluates fleet rules on."""
        return self.telemetry.snapshot()

    def dump_federated(self, path: str) -> str:
        """Write FLEET_METRICS.json: the last federated scrape per
        replica (parsed samples + TYPEs), the flat fleet snapshot, and
        the router status, the JAX package's format (its ``obs/analyze
        --fleet`` reads it next to the merged trace)."""
        from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import (
            atomic_write_json,
        )

        with self._lock:
            fed = dict(self._federated)
        doc = {
            "replicas": {
                rid: {
                    "types": dict(types),
                    "samples": [
                        [name, dict(labels), value]
                        for name, labels, value in samples
                    ],
                }
                for rid, (types, samples) in sorted(fed.items())
            },
            "snapshot": self.federated_snapshot(),
            "status": self.status(),
        }
        atomic_write_json(path, doc, indent=2, sort_keys=True)
        return path

    def _federation_run(self, hb: watchdog.Heartbeat) -> None:
        try:
            while not self._stop.wait(self.config.poll_interval_s):
                hb.beat()
                self.scrape_metrics_once()
        except BaseException as e:
            # Crash channel (thread-error-contract): a dead federation
            # thread means frozen fleet metrics and silently disarmed
            # fleet SLO rules — announce, record, re-raise.
            self._fed_error = e
            print(
                json.dumps(
                    {
                        "event": "fleet_federation_crashed",
                        "error": repr(e),
                    }
                ),
                file=sys.stderr, flush=True,
            )
            raise
        finally:
            hb.close()

    # ---- canary gate -----------------------------------------------------

    def add_canary(self, replica, start_monitor: bool = False):
        """Admit ``replica`` as the canary: it takes ``canary_weight``-
        scaled traffic while a dedicated SloMonitor watches its p99
        ratio vs the fleet baseline and its shed rate.  Returns the
        monitor (tests drive ``canary_check_once``; production passes
        ``start_monitor=True`` for the poll thread)."""
        from batchai_retinanet_horovod_coco_tpu_torch.obs import slo as slo_lib

        if self._canary is not None:
            raise ValueError("a canary is already under evaluation")
        # A previous canary generation's monitor (rolled back — its
        # rollback handler could only request_stop from its own poll
        # thread) is fully stopped here, from a safe caller thread.
        if self._canary_monitor is not None:
            self._canary_monitor.stop()
            self._canary_monitor = None
        st = _ReplicaState(replica, is_canary=True)
        with self._lock:
            self._states.append(st)
        self._canary = st
        self._canary_outcome = None
        cfg = self.config
        self._canary_monitor = slo_lib.SloMonitor(
            self.telemetry,
            [
                slo_lib.SloRule(
                    name="canary-p99-regression",
                    metric="fleet_canary_p99_ratio",
                    op=">",
                    threshold=cfg.canary_p99_factor,
                    for_s=cfg.canary_for_s,
                    description=(
                        f"canary p99 above {cfg.canary_p99_factor}x the "
                        "fleet baseline"
                    ),
                ),
                slo_lib.SloRule(
                    name="canary-shed-rate",
                    metric="fleet_canary_shed_total",
                    delta=True,
                    op=">",
                    threshold=cfg.canary_shed_per_poll,
                    for_s=cfg.canary_for_s,
                    description=(
                        "canary shedding above "
                        f"{cfg.canary_shed_per_poll}/poll"
                    ),
                ),
            ],
            sink=self.sink,
            poll_interval=cfg.canary_poll_s,
            on_violation=self._canary_rollback,
        )
        self.poll_once()
        emit_event(
            "canary_started", sink=self.sink,
            replica_id=replica.replica_id,
            version=replica.version,
            weight_fraction=cfg.canary_weight,
        )
        if start_monitor:
            self._canary_monitor.start()
        return self._canary_monitor

    def canary_check_once(self, now: float | None = None) -> list[dict]:
        """One canary-gate evaluation (injectable clock — the SLO
        monitor's own anti-flap state machine underneath)."""
        if self._canary_monitor is None:
            return []
        return self._canary_monitor.check_once(now=now)

    def _canary_rollback(self, violation: dict) -> None:
        """A sustained canary breach: drain it, restore baseline weights,
        emit exactly ONE structured ``canary_rollback`` event.  The SLO
        monitor fires once per sustained breach; the outcome latch makes
        rollback terminal for this canary generation regardless."""
        with self._lock:
            if self._canary is None or self._canary_outcome is not None:
                return
            self._canary_outcome = "rolled_back"
            st = self._canary
            st.state = DRAINED
            st.weight = 0.0
            self._rollbacks += 1
            # Free the canary slot: a fixed v3 export can be admitted
            # without restarting the router (the drained replica stays
            # in _states for /fleet visibility, weight pinned 0).
            self._canary = None
        emit_event(
            "canary_rollback", sink=self.sink,
            replica_id=st.replica.replica_id,
            version=st.replica.version,
            rule=violation.get("rule"),
            value=violation.get("value"),
            threshold=violation.get("threshold"),
            sustained_s=violation.get("sustained_s"),
        )
        if self._canary_monitor is not None:
            # Rollback is terminal for this generation — stop the gate's
            # poll loop.  request_stop (not stop): this handler may be
            # running ON the monitor's own poll thread, which cannot
            # join itself; add_canary/close finish the join later.
            self._canary_monitor.request_stop()
        try:
            st.replica.drain(timeout_s=self.config.canary_drain_timeout_s)
        except Exception:
            pass  # the drain is best-effort; the weight is already zero
        self._recompute_weights()

    def promote_canary(self) -> None:
        """Manually graduate a green canary to full weight."""
        with self._lock:
            if self._canary is None or self._canary_outcome is not None:
                return
            self._canary_outcome = "promoted"
            st = self._canary
            st.is_canary = False
            self._canary = None
        emit_event(
            "canary_promoted", sink=self.sink,
            replica_id=st.replica.replica_id,
            version=st.replica.version,
        )
        if self._canary_monitor is not None:
            self._canary_monitor.stop()
            self._canary_monitor = None
        self._recompute_weights()

    # ---- observability ---------------------------------------------------

    def _canary_baseline_p99(self) -> float | None:
        """Median p99 over CLOSED non-canary replicas (the fleet
        baseline the canary regresses against)."""
        p99s = sorted(
            float(st.load["p99_ms"])
            for st in self._states
            if not st.is_canary and st.state == CLOSED
            and st.load.get("p99_ms")
        )
        if not p99s:
            return None
        mid = len(p99s) // 2
        return (
            p99s[mid] if len(p99s) % 2
            else (p99s[mid - 1] + p99s[mid]) / 2.0
        )

    def _telemetry_samples(self):
        snap = self.stats.snapshot()
        with self._lock:
            states = [
                (st.replica.replica_id, st.state, st.weight,
                 dict(st.load), st.is_canary)
                for st in self._states
            ]
            redispatches = self._redispatches
            opens = self._breaker_opens
            rollbacks = self._rollbacks
            inflight = self._inflight
            canary = self._canary
            outcome = self._canary_outcome
            streams_open = len(self._streams)
            stream_repins = self._stream_repins
        yield ("fleet_requests_completed_total", "counter",
               "requests completed through the fleet router", None,
               snap["completed"])
        yield ("fleet_requests_failed_total", "counter",
               "requests failed after exhausting re-dispatch", None,
               snap["failed"])
        yield ("fleet_requests_timeout_total", "counter",
               "requests expired at the fleet edge", None, snap["timeouts"])
        for reason, n in sorted(snap["shed"].items()):
            yield ("fleet_shed_total", "counter",
                   "requests shed at the fleet edge, by reason",
                   {"reason": reason}, n)
        yield ("fleet_redispatch_total", "counter",
               "requests retried on another replica (replica death or "
               "replica-level shed)", None,
               float(redispatches))
        yield ("fleet_breaker_open_total", "counter",
               "circuit-breaker open transitions", None, float(opens))
        yield ("fleet_canary_rollback_total", "counter",
               "canary rollbacks (exactly one per failed canary)", None,
               float(rollbacks))
        yield ("fleet_inflight", "gauge",
               "requests inside the fleet edge right now", None,
               float(inflight))
        yield ("fleet_streams_open", "gauge",
               "client streams pinned at the fleet edge",
               None, float(streams_open))
        yield ("fleet_stream_repinned_total", "counter",
               "streams moved to another replica after pin loss", None,
               float(stream_repins))
        # Fleet-level availability: the fraction of non-
        # drained replicas whose breaker is CLOSED — the metric the
        # built-in fleet availability-floor SLO rule
        # (obs.slo.fleet_availability_rule) evaluates.
        active = [s for s in states if s[1] != DRAINED]
        closed = sum(1 for s in active if s[1] == CLOSED)
        yield ("fleet_replicas_routable", "gauge",
               "replicas with a CLOSED breaker", None, float(closed))
        yield ("fleet_replicas_total", "gauge",
               "non-drained replicas in the fleet", None,
               float(len(active)))
        if active:
            yield ("fleet_availability", "gauge",
                   "routable replicas / non-drained replicas (1.0 = the "
                   "whole fleet is healthy; the availability-floor SLO "
                   "rule watches this)", None,
                   round(closed / len(active), 4))
        # Fleet occupancy aggregates: the autoscaler's primary
        # signal, from the health-poll advertised slot fields of CLOSED
        # accepting replicas ONLY — a draining or broken replica's
        # capacity is already being reclaimed and must not be counted.
        occ: list[float] = []
        free_total = 0.0
        for rid, state, weight, load, is_canary in states:
            if state != CLOSED or not load.get("accepting", False):
                continue
            cap = float(load.get("slot_capacity") or 0)
            if cap <= 0:
                continue
            free = float(load.get("free_slots") or 0)
            inflight_r = float(load.get("inflight") or 0)
            # Claimed device slots OR queued backlog, whichever reads
            # fuller — idle = 0.0, saturated = 1.0.
            occ.append(min(1.0, max((cap - free) / cap, inflight_r / cap)))
            free_total += free
        if occ:
            yield ("fleet_occupancy", "gauge",
                   "mean live slot occupancy across routable replicas "
                   "(draining replicas excluded; the autoscale band "
                   "signal)", None,
                   round(sum(occ) / len(occ), 4))
            yield ("fleet_free_slots", "gauge",
                   "idle device slots across routable replicas", None,
                   free_total)
        for rid, state, weight, load, is_canary in states:
            yield ("fleet_replica_weight", "gauge",
                   "routing weight from advertised load fields",
                   {"replica": rid}, round(weight, 6))
            yield ("fleet_breaker_state", "gauge",
                   "0=closed 1=half_open 2=open 3=drained",
                   {"replica": rid}, _STATE_CODE[state])
            yield ("fleet_replica_draining", "gauge",
                   "1 while this replica is administratively drained "
                   "(scale-down victim or rolled-back canary)",
                   {"replica": rid}, 1.0 if state == DRAINED else 0.0)
            if load.get("p99_ms"):
                yield ("fleet_replica_p99_ms", "gauge",
                       "replica-advertised windowed p99",
                       {"replica": rid}, float(load["p99_ms"]))
        if canary is not None and outcome is None:
            base = self._canary_baseline_p99()
            c_p99 = canary.load.get("p99_ms")
            if base and c_p99:
                yield ("fleet_canary_p99_ratio", "gauge",
                       "canary p99 / fleet-baseline p99 (the canary "
                       "gate's regression metric)", None,
                       round(float(c_p99) / base, 4))
            yield ("fleet_canary_shed_total", "counter",
                   "canary-advertised lifetime sheds (gate delta rule)",
                   None, float(canary.load.get("shed_total") or 0))

    def status(self) -> dict:
        """The /fleet debugging payload: per-replica identity, breaker
        state, weight, last load fields; canary outcome; counters."""
        with self._lock:
            replicas = [
                {
                    "replica_id": st.replica.replica_id,
                    "version": st.replica.version,
                    "state": st.state,
                    "weight": round(st.weight, 6),
                    "is_canary": st.is_canary,
                    "load": dict(st.load),
                }
                for st in self._states
            ]
            out = {
                "accepting": self._accepting,
                "inflight": self._inflight,
                "redispatches": self._redispatches,
                "breaker_opens": self._breaker_opens,
                "streams_open": len(self._streams),
                "stream_repins": self._stream_repins,
                "canary_rollbacks": self._rollbacks,
                "canary_outcome": self._canary_outcome,
                "federated_replicas": sorted(self._federated),
                "federation_error": (
                    repr(self._fed_error) if self._fed_error else None
                ),
            }
        out["replicas"] = replicas
        out["stats"] = self.stats.snapshot()
        return out

    def healthz(self) -> tuple[int, dict]:
        """Fleet liveness: 200 while at least one replica is routable
        (breaker CLOSED) — a degraded fleet still serves; 503 when none
        is."""
        with self._lock:
            closed = sum(1 for st in self._states if st.state == CLOSED)
            total = len(self._states)
        payload = {
            "status": "ok" if closed else "no_replicas",
            "replicas_closed": closed,
            "replicas_total": total,
        }
        return (200 if closed else 503), payload

    # ---- poll thread + lifecycle -----------------------------------------

    def _poll_run(self, hb: watchdog.Heartbeat) -> None:
        try:
            while not self._stop.wait(self.config.poll_interval_s):
                hb.beat()
                self.poll_once()
        except BaseException as e:
            # Crash channel (thread-error-contract): a dead poller means
            # frozen weights — store it so detect() re-raises, and say so.
            self._error = e
            print(
                json.dumps(
                    {"event": "fleet_poller_crashed", "error": repr(e)}
                ),
                file=sys.stderr, flush=True,
            )
            raise
        finally:
            hb.close()

    def start_polling(self) -> "FleetRouter":
        if self._thread is not None and self._thread.is_alive():
            return self
        hb = watchdog.register("fleet-health-poll")
        self._thread = threading.Thread(
            target=self._poll_run, args=(hb,), daemon=True,
            name="fleet-health-poll",
        )
        self._thread.start()
        # The federation scrape rides the same cadence on its own thread
        # (a slow replica /metrics must not delay weight updates);
        # watchdog-registered with the crash-announce contract above.
        fed_hb = watchdog.register("fleet-metrics-scrape")
        self._fed_thread = threading.Thread(
            target=self._federation_run, args=(fed_hb,), daemon=True,
            name="fleet-metrics-scrape",
        )
        self._fed_thread.start()
        return self

    def close(self, close_replicas: bool = False) -> None:
        """Stop accepting, stop the poller and canary monitor; bounded
        and idempotent.  Spawned replica processes belong to the caller
        (the CLI kills its children); ``close_replicas`` closes the
        replica HANDLES (in-process servers) too."""
        with self._lock:
            self._accepting = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._fed_thread is not None:
            self._fed_thread.join(timeout=5)
            self._fed_thread = None
        if self._canary_monitor is not None:
            self._canary_monitor.stop()
        if close_replicas:
            for st in self._states:
                try:
                    st.replica.close()
                except Exception:
                    pass  # teardown is best-effort by design

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Fleet HTTP frontend
# ---------------------------------------------------------------------------


def serve_fleet_http(
    router: FleetRouter,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 60.0,
):
    """The fleet edge as HTTP — same surface as a single replica's
    frontend, so clients and scrapers cannot tell one engine from N:

    POST /detect   → 200 detections; 503 + reason on shed; 504 on
                   deadline; 500 when every replica failed
    POST /stream/open|frame|close → the streaming session surface
                  , same wire shape as a single replica's
                   frontend — frames carry X-Retinanet-Stream and
                   X-Retinanet-Frame headers, the fleet pins each
                   stream to a replica and re-pins on replica death
    GET  /healthz  → 200 while >= 1 replica is routable, else 503
    GET  /metrics  → Prometheus text over ``router.telemetry``
    GET  /fleet    → per-replica status JSON (also /statusz)

    Returns the ``ThreadingHTTPServer``; the caller owns
    ``serve_forever()``/``shutdown()`` (the CLI below runs it).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def _json(
            self, code: int, payload: dict, trace_id: str | None = None
        ) -> None:
            if trace_id is not None:
                payload = {**payload, "trace_id": trace_id}
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            if trace_id is not None:
                self.send_header(trace.TRACE_HEADER, trace_id)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib casing)
            if self.path == "/healthz":
                code, payload = router.healthz()
                self._json(code, payload)
            elif self.path == "/metrics":
                body = router.telemetry.prometheus_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path in ("/fleet", "/statusz"):
                self._json(200, router.status())
            else:
                self._json(404, {"error": "not_found"})

        def _do_stream(self, trace_id):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                if self.path == "/stream/open":
                    spec = json.loads(body) if body else {}
                    out = router.stream_open(
                        width=spec.get("width"),
                        height=spec.get("height"),
                        trace_id=trace_id,
                    )
                    self._json(200, out, trace_id=trace_id)
                elif self.path == "/stream/frame":
                    sid = self.headers.get("X-Retinanet-Stream", "")
                    try:
                        seq = int(self.headers.get("X-Retinanet-Frame", -1))
                        deadline_ms = self.headers.get(
                            "X-Retinanet-Deadline-Ms"
                        )
                        timeout_s = (
                            float(deadline_ms) / 1e3
                            if deadline_ms else request_timeout_s
                        )
                    except ValueError:
                        # Malformed header → 400 via the taxonomy
                        # mapping, not the 500 catch-all.
                        raise RequestRejected(
                            "decode_error", "malformed stream header"
                        ) from None
                    dets, hit = router.stream_frame(
                        sid, seq, body,
                        timeout_s=timeout_s,
                        trace_id=trace_id,
                    )
                    self._json(
                        200,
                        {
                            "detections": dets,
                            "frame": seq,
                            "cache_hit": hit,
                        },
                        trace_id=trace_id,
                    )
                elif self.path == "/stream/close":
                    sid = self.headers.get("X-Retinanet-Stream", "")
                    stats = router.stream_close(sid)
                    self._json(
                        200, {"closed": sid, "stats": stats},
                        trace_id=trace_id,
                    )
                else:
                    self._json(404, {"error": "not_found"})
            except RequestRejected as exc:
                if exc.reason == "unknown_stream":
                    code = 404
                elif exc.reason in ("decode_error", "stream_out_of_order"):
                    code = 400
                else:
                    code = 503
                self._json(
                    code, {"error": "rejected", "reason": exc.reason},
                    trace_id=trace_id,
                )
            except (RequestTimeout, TimeoutError):
                self._json(
                    504, {"error": "deadline_exceeded"}, trace_id=trace_id
                )
            except Exception as exc:
                self._json(
                    500, {"error": "server_error", "detail": str(exc)},
                    trace_id=trace_id,
                )

        def do_POST(self):  # noqa: N802
            if self.path.startswith("/stream/"):
                trace_id = (
                    self.headers.get(trace.TRACE_HEADER)
                    or trace.new_trace_id()
                )
                self._do_stream(trace_id)
                return
            if self.path != "/detect":
                self._json(404, {"error": "not_found"})
                return
            # The fleet-wide trace id is minted HERE (or adopted from a
            # client-supplied header) and echoed on every response —
            # the whole request tree shares it.
            trace_id = (
                self.headers.get(trace.TRACE_HEADER) or trace.new_trace_id()
            )
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                dets = router.detect(
                    body, timeout_s=request_timeout_s, trace_id=trace_id
                )
            except RequestRejected as exc:
                code = 400 if exc.reason == "decode_error" else 503
                self._json(
                    code, {"error": "rejected", "reason": exc.reason},
                    trace_id=trace_id,
                )
            except (RequestTimeout, TimeoutError):
                self._json(
                    504, {"error": "deadline_exceeded"}, trace_id=trace_id
                )
            except Exception as exc:
                self._json(
                    500, {"error": "server_error", "detail": str(exc)},
                    trace_id=trace_id,
                )
            else:
                self._json(200, {"detections": dets}, trace_id=trace_id)

        def log_message(self, *args) -> None:
            pass  # request logging is the telemetry layer's job

    class Server(ThreadingHTTPServer):
        # The listen backlog, as the serve frontend's: at the stdlib's 5, a
        # burst of clients gets its connections dropped.
        request_queue_size = 128
        daemon_threads = True  # a wedged client can't hold exit hostage

    return Server((host, port), Handler)


# ---------------------------------------------------------------------------
# CLI: python -m batchai_retinanet_horovod_coco_tpu_torch.serve.fleet
# ---------------------------------------------------------------------------


class _SubprocessLauncher:
    """The fleet CLI's autoscale actuator (serve/autoscale.py launcher
    protocol) over the CLI's spawn/supervision machinery: ``launch``
    forks one more serve-CLI replica through the SAME ``spawn_one``
    path the startup fleet uses (so it is supervised and budget-bounded
    like any other slot), ``terminate`` removes the victim from the
    supervised set FIRST (the supervisor must not respawn an
    intentional scale-down) and SIGTERMs it into the serve frontend's
    bounded drain, and ``reap`` reports the process gone — escalating
    to SIGKILL only past ``kill_after_s``, so a wedged drain cannot
    pin a reclaiming slot forever."""

    def __init__(self, spawn_fn, procs: dict, abandoned: set,
                 kill_after_s: float = 30.0):
        self._spawn = spawn_fn  # (rid) -> replica; registers in procs
        self._procs = procs
        self._abandoned = abandoned
        self._kill_after_s = kill_after_s
        self._seq = 0
        self._terminated: dict[str, tuple] = {}  # rid -> (proc, t0)

    def launch(self):
        rid = f"scale-{self._seq}"
        self._seq += 1
        return self._spawn(rid)

    def owns(self, rid: str) -> bool:
        return rid in self._procs

    def terminate(self, rid: str) -> None:
        rec = self._procs.pop(rid, None)
        if rec is None:
            return
        proc = rec[0]
        if proc.poll() is None:
            proc.terminate()  # SIGTERM -> the serve CLI's drain path
        self._terminated[rid] = (proc, monotonic_s())

    def reap(self, rid: str) -> bool:
        rec = self._terminated.get(rid)
        if rec is None:
            return True
        proc, t0 = rec
        if proc.poll() is None:
            if monotonic_s() - t0 > self._kill_after_s:
                proc.kill()
            return False
        self._terminated.pop(rid, None)
        return True

    def prune(self) -> list[str]:
        out = sorted(self._abandoned)
        for rid in out:
            self._abandoned.discard(rid)
        return out

    def close(self) -> None:
        """Teardown: make sure no terminated-but-straggling child
        outlives the CLI (drain already had its bounded chance)."""
        from batchai_retinanet_horovod_coco_tpu_torch.serve.replica import (
            release_subprocess,
        )

        for rid, (proc, _t0) in list(self._terminated.items()):
            release_subprocess(proc, sigterm_timeout_s=5.0)
            self._terminated.pop(rid, None)


def build_parser():
    import argparse

    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import add_obs_flags

    p = argparse.ArgumentParser(
        description="Fleet router over N serve replicas: health-weighted "
                    "routing, circuit breaking, fleet admission control, "
                    "SLO-gated canary rollout.",
    )
    p.add_argument("--http", type=int, required=True, metavar="PORT",
                   help="fleet frontend port (0 = ephemeral, printed)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--replica", action="append", default=[],
                   metavar="URL",
                   help="attach an already-running replica frontend "
                        "(repeatable)")
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="spawn N replica subprocesses via the serve CLI "
                        "(pinned ports; supervised unless --no-respawn)")
    p.add_argument("--export-dir", default=None,
                   help="export directory for spawned replicas "
                        "(omit with --stub-engine)")
    p.add_argument("--stub-engine", action="store_true",
                   help="spawned replicas use the stub engine (no device "
                        "work, one fixed detection a request)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where spawned --export-dir replicas serve (the "
                        "device the programs were exported on); cuda "
                        "raises without a card; stub replicas ignore it")
    p.add_argument("--stub-delay-ms", type=float, default=None,
                   help="stub engine per-dispatch delay for spawned "
                        "replicas")
    p.add_argument("--no-respawn", action="store_true",
                   help="do not respawn dead spawned replicas")
    p.add_argument("--respawn-delay-s", type=float, default=1.0)
    p.add_argument("--respawn-budget", type=int, default=5,
                   help="respawns allowed per replica slot before the "
                        "supervisor gives up (deterministic-jitter "
                        "backoff between attempts; an exhausted slot "
                        "emits respawn_budget_exhausted once and is "
                        "left to the autoscaler)")
    # Autoscaling: a declarative policy evaluated by the
    # serve/autoscale.py control loop over the federated fleet signals.
    p.add_argument("--autoscale", action="store_true",
                   help="arm the autoscaler: scale spawned replicas "
                        "between --min-replicas and --max-replicas to "
                        "hold --target-occupancy")
    p.add_argument("--target-occupancy", default="0.25:0.75",
                   metavar="LOW:HIGH",
                   help="occupancy hysteresis band: scale up above "
                        "HIGH, down below LOW, never inside the band")
    p.add_argument("--min-replicas", type=int, default=1,
                   help="autoscale floor (0 = scale-to-zero: an idle "
                        "fleet drains every replica and respawns on "
                        "the first request)")
    p.add_argument("--max-replicas", type=int, default=4,
                   help="autoscale ceiling (a sustained breach at the "
                        "ceiling emits capped decisions — the "
                        "fleet:underprovisioned signal)")
    p.add_argument("--autoscale-policy", default=None, metavar="FILE",
                   help="JSON AutoscalePolicy file; overrides the "
                        "individual autoscale flags entirely")
    p.add_argument("--autoscale-for-s", type=float, default=5.0,
                   help="a band breach must sustain this long before "
                        "any scale decision fires")
    p.add_argument("--autoscale-up-cooldown-s", type=float, default=10.0)
    p.add_argument("--autoscale-down-cooldown-s", type=float,
                   default=30.0)
    p.add_argument("--autoscale-interval-s", type=float, default=None,
                   help="autoscaler poll cadence (default: "
                        "--poll-interval)")
    p.add_argument("--autoscale-p99-slo-ms", type=float, default=None,
                   help="optional federated-p99 ceiling: a sustained "
                        "breach scales up even inside the occupancy "
                        "band")
    p.add_argument("--poll-interval", type=float, default=1.0,
                   help="health-poll cadence (seconds)")
    p.add_argument("--fleet-timeout-s", type=float, default=30.0,
                   help="default per-request deadline at the fleet edge")
    p.add_argument("--canary-url", default=None,
                   help="attach a running replica as the canary")
    p.add_argument("--canary-export-dir", default=None,
                   help="spawn the canary from this export directory")
    p.add_argument("--canary-stub-delay-ms", type=float, default=None,
                   help="spawn a stub-engine canary with this dispatch "
                        "delay (a canary made slow on purpose)")
    p.add_argument("--canary-weight", type=float, default=0.25)
    p.add_argument("--canary-p99-factor", type=float, default=1.5)
    p.add_argument("--canary-for-s", type=float, default=5.0)
    p.add_argument("--canary-poll-s", type=float, default=1.0)
    p.add_argument("--shed-trip", type=int, default=3,
                   help="CONSECUTIVE request-level sheds before a "
                        "replica's breaker opens (sheds are load signals "
                        "first; raise this in harnesses that shed on "
                        "purpose so availability stays a death signal)")
    p.add_argument("--replica-start-timeout-s", type=float, default=60.0,
                   help="how long a spawned replica (at start-up, on a "
                        "respawn, a scale-up or as the canary) may take "
                        "to answer /healthz 200 before the spawn fails; "
                        "a replica loading full-width programs on a "
                        "host busy with traffic can need more than the "
                        "default")
    p.add_argument("--spawn-serve-args", default=None, metavar="ARGS",
                   help="extra serve-CLI arguments appended to EVERY "
                        "spawned replica, as one shell-quoted string "
                        "(e.g. '--serve-admission-queue 1'))")
    p.add_argument("--availability-floor", type=float, default=None,
                   metavar="FRAC",
                   help="fleet SLO: fire when fleet_availability "
                        "(routable/non-drained replicas) drops below "
                        "FRAC (default 0.999 when the monitor runs — "
                        "any replica loss pages exactly once per "
                        "sustained loss)")
    # Fleet observability: --obs-trace/--obs-dir enable the
    # merged fleet trace (spawned replicas join via the env contract and
    # export their own fragments, merged at exit) + the metrics.jsonl
    # sink every fleet event lands in; --slo-rule/--obs-port run the SLO
    # monitor / status server over the FEDERATED fleet registry.
    add_obs_flags(p)
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the fleet command line ``argv``; returns the router's final
    ``status()``.  SIGTERM (or an interrupt) stops the frontend, the
    supervisor, the canary and the autoscaler, and SIGTERMs every replica
    it spawned into its drain.  ``--device cuda`` (the default) raises
    without a card when replicas serve an export; stub replicas need no
    device."""
    import shlex
    import signal
    from concurrent.futures import ThreadPoolExecutor

    from batchai_retinanet_horovod_coco_tpu_torch.serve.replica import (
        HttpReplica,
        RespawnBudget,
        release_subprocess,
        spawn_http_replica,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import configure_obs
    from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

    args = build_parser().parse_args(argv)
    if args.spawn and not (args.export_dir or args.stub_engine):
        raise SystemExit("--spawn needs --export-dir or --stub-engine")
    if args.replica_start_timeout_s <= 0:
        raise SystemExit("--replica-start-timeout-s must be > 0")
    if (args.spawn and args.export_dir and not args.stub_engine) or args.canary_export_dir:
        resolve_device(args.device)  # no card for --device cuda: raise now

    # Obs bring-up BEFORE any spawn: replica subprocesses inherit the
    # RETINANET_OBS_DIR/RETINANET_OBS_RUN environment, trace under this
    # run's id, and export fragments the finalize below merges into ONE
    # fleet trace.json.
    obs_dir = configure_obs(args, process_label="fleet")
    sink = None
    if obs_dir is not None:
        from batchai_retinanet_horovod_coco_tpu_torch.obs.events import EventSink

        sink = EventSink(obs_dir, stdout=False, run_config=vars(args))
        watchdog.default().sink = sink

    spawn_extra = shlex.split(args.spawn_serve_args or "")
    replicas: list = [HttpReplica(url) for url in args.replica]
    procs: dict[str, tuple] = {}  # replica_id -> (proc, port)
    export_dir = None if args.stub_engine else args.export_dir

    # /healthz is probed every 0.5 s until the start timeout.
    start_wait = BackoffPolicy(
        max_tries=max(1, math.ceil(args.replica_start_timeout_s / 0.5)),
        base_s=0.5, multiplier=1.0, jitter=0.0,
    )

    def spawn(rid: str, port: int | None = None):
        return spawn_http_replica(
            rid, port=port, export_dir=export_dir,
            stub_delay_ms=args.stub_delay_ms if args.stub_engine else None,
            extra_args=spawn_extra, wait_policy=start_wait, device=args.device,
        )

    def spawn_one(rid: str, port: int | None = None):
        proc, rep = spawn(rid, port)
        port = int(rep.base_url.rsplit(":", 1)[1])
        procs[rid] = (proc, port)
        emit_event(
            "fleet_replica_spawned", sink=sink, file=sys.stdout,
            replica_id=rid, pid=proc.pid, port=port,
        )
        return rep

    router = None
    slo_monitor = None
    status_server = None
    canary_proc = None
    supervisor = None
    autoscaler = None
    launcher = None
    httpd = None
    stop_supervising = threading.Event()

    def on_sigterm(_signum, _frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, on_sigterm)
    try:
        # The startup replicas load their programs side by side: each
        # spawn blocks until its replica answers /healthz 200, and the
        # fleet starts once all have (a failed spawn raises here).
        if args.spawn:
            with ThreadPoolExecutor(args.spawn) as pool:
                replicas += list(pool.map(spawn_one, [f"replica-{k}" for k in range(args.spawn)]))
        if not replicas:
            raise SystemExit("no replicas: pass --replica and/or --spawn")

        config = FleetConfig(
            poll_interval_s=args.poll_interval,
            default_timeout_s=args.fleet_timeout_s,
            canary_weight=args.canary_weight,
            canary_p99_factor=args.canary_p99_factor,
            canary_for_s=args.canary_for_s,
            canary_poll_s=args.canary_poll_s,
            shed_trip=args.shed_trip,
        )
        router = FleetRouter(replicas, config, sink=sink)

        # Fleet SLO monitor over the FEDERATED registry: the availability
        # floor, the occupancy ceiling and the watchdog stall rule, plus
        # any --slo-rule specs, on router.federated_snapshot()'s keys.
        if obs_dir is not None or args.slo_rule or args.obs_port is not None:
            from batchai_retinanet_horovod_coco_tpu_torch.obs import slo as slo_lib

            slo_monitor = slo_lib.SloMonitor(
                router.telemetry,
                [
                    slo_lib.fleet_availability_rule(
                        args.availability_floor if args.availability_floor is not None else 0.999
                    ),
                    slo_lib.fleet_occupancy_rule(),
                    slo_lib.stall_rule(),
                ]
                + [slo_lib.parse_rule(r) for r in (args.slo_rule or [])],
                sink=sink,
                poll_interval=args.slo_poll_s,
            ).start()
        if args.obs_port is not None:
            status_server = telemetry.start_http_server(
                router.telemetry, port=args.obs_port, host=args.host
            )
            print(f"fleet telemetry on http://{status_server.host}:{status_server.port} "
                  "(/metrics /healthz /statusz)", flush=True)

        if args.canary_url or args.canary_export_dir or args.canary_stub_delay_ms is not None:
            if args.canary_url:
                canary = HttpReplica(args.canary_url, replica_id="canary")
            else:
                canary_proc, canary = spawn_http_replica(
                    "canary", export_dir=args.canary_export_dir,
                    stub_delay_ms=args.canary_stub_delay_ms, wait_policy=start_wait,
                    device=args.device,
                )
                emit_event(
                    "fleet_replica_spawned", sink=sink, file=sys.stdout,
                    replica_id="canary", pid=canary_proc.pid,
                    port=int(canary.base_url.rsplit(":", 1)[1]),
                )
            router.add_canary(canary, start_monitor=True)

        # Respawn supervision state: per-slot budgets, the slots waiting
        # out a backoff delay, and the slots the budget abandoned (shared
        # with the autoscaler's launcher, which prunes them).
        budgets: dict[str, RespawnBudget] = {}
        waiting: dict[str, int] = {}  # rid -> pinned port
        abandoned: set[str] = set()

        def budget_for(rid: str) -> RespawnBudget:
            b = budgets.get(rid)
            if b is None:
                # Deterministic per-slot jitter (the breaker's seeding):
                # reproducible schedules, decorrelated slots.
                b = RespawnBudget(BackoffPolicy(
                    max_tries=max(1, args.respawn_budget),
                    base_s=args.respawn_delay_s,
                    multiplier=2.0,
                    ceiling_s=30.0,
                    jitter=0.1,
                    seed=zlib.crc32(rid.encode()),
                ))
                budgets[rid] = b
            return b

        def note_death(rid: str, port: int, now: float) -> None:
            if budget_for(rid).note_death(now):
                waiting[rid] = port
            else:
                abandoned.add(rid)
                emit_event(
                    "respawn_budget_exhausted", sink=sink, file=sys.stdout,
                    replica_id=rid, deaths=budgets[rid].deaths,
                )

        def supervise(hb: watchdog.Heartbeat) -> None:
            """Respawn dead spawned replicas in place (same id, same
            port) so the breaker's half-open probe readmits them, BOUNDED
            by a per-slot ``RespawnBudget``: each death schedules the next
            respawn on a deterministic-jitter backoff, and an exhausted
            budget emits ``respawn_budget_exhausted`` once and leaves the
            slot to the autoscaler."""
            try:
                while not stop_supervising.wait(args.respawn_delay_s):
                    hb.beat()
                    now = monotonic_s()
                    for rid, (proc, port) in list(procs.items()):
                        if proc.poll() is None:
                            b = budgets.get(rid)
                            if b is not None:
                                b.note_alive(now)
                            continue
                        cur = procs.get(rid)
                        if cur is None or cur[0] is not proc:
                            continue  # scaled down / replaced under us
                        procs.pop(rid, None)
                        emit_event(
                            "fleet_replica_died", sink=sink, file=sys.stdout,
                            replica_id=rid, rc=proc.returncode,
                        )
                        note_death(rid, port, now)
                    for rid, port in list(waiting.items()):
                        if not budgets[rid].ready(now):
                            continue
                        waiting.pop(rid, None)
                        try:
                            new_proc, _rep = spawn(rid, port)
                        except Exception as exc:
                            emit_event(
                                "fleet_respawn_failed", sink=sink, file=sys.stdout,
                                replica_id=rid, error=repr(exc),
                            )
                            note_death(rid, port, monotonic_s())
                            continue
                        if stop_supervising.is_set():
                            release_subprocess(new_proc)  # the fleet is stopping
                            return
                        procs[rid] = (new_proc, port)
                        emit_event(
                            "fleet_replica_respawned", sink=sink, file=sys.stdout,
                            replica_id=rid, pid=new_proc.pid, port=port,
                        )
            except BaseException as e:
                # Crash channel: a silently dead supervisor means no
                # respawns.
                print(json.dumps({"event": "fleet_supervisor_crashed", "error": repr(e)}),
                      file=sys.stderr, flush=True)
                raise
            finally:
                hb.close()

        if procs and not args.no_respawn:
            hb = watchdog.register("fleet-supervisor")
            supervisor = threading.Thread(
                target=supervise, args=(hb,), daemon=True, name="fleet-supervisor",
            )
            supervisor.start()

        # Autoscaling: the declarative policy and the control loop over the
        # federated signals, actuating through the SAME spawn and
        # supervision machinery as everything above.
        if args.autoscale:
            from batchai_retinanet_horovod_coco_tpu_torch.serve.autoscale import (
                Autoscaler,
                AutoscalePolicy,
            )

            if args.autoscale_policy:
                policy = AutoscalePolicy.from_file(args.autoscale_policy)
            else:
                low, _, high = args.target_occupancy.partition(":")
                policy = AutoscalePolicy(
                    min_replicas=args.min_replicas,
                    max_replicas=args.max_replicas,
                    occupancy_low=float(low),
                    occupancy_high=float(high or low),
                    p99_slo_ms=args.autoscale_p99_slo_ms,
                    for_s=args.autoscale_for_s,
                    up_cooldown_s=args.autoscale_up_cooldown_s,
                    down_cooldown_s=args.autoscale_down_cooldown_s,
                    interval_s=(
                        args.autoscale_interval_s
                        if args.autoscale_interval_s is not None
                        else args.poll_interval
                    ),
                )
            launcher = _SubprocessLauncher(spawn_one, procs, abandoned)
            autoscaler = Autoscaler(router, policy, launcher, sink=sink)
            autoscaler.start()
            emit_event(
                "autoscaler_armed", sink=sink, file=sys.stdout,
                min_replicas=policy.min_replicas,
                max_replicas=policy.max_replicas,
                occupancy_band=[policy.occupancy_low, policy.occupancy_high],
                p99_slo_ms=policy.p99_slo_ms,
            )

        httpd = serve_fleet_http(router, args.host, args.http,
                                 request_timeout_s=args.fleet_timeout_s)
        print(f"fleet serving on http://{httpd.server_address[0]}:{httpd.server_address[1]} "
              "(POST /detect /stream/*; GET /healthz /metrics /fleet)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
    except KeyboardInterrupt:
        pass  # stopped while starting up
    finally:
        stop_supervising.set()
        if supervisor is not None:
            supervisor.join(timeout=60)
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if obs_dir is not None and router is not None:
            # Final federation sweep while the replicas are still alive,
            # then the metrics half of the fleet report (the trace half
            # merges below, after the replicas export their fragments).
            try:
                router.scrape_metrics_once()
                router.dump_federated(os.path.join(obs_dir, "FLEET_METRICS.json"))
            except Exception as exc:
                print(json.dumps({"event": "fleet_metrics_dump_error", "error": repr(exc)[:300]}),
                      file=sys.stderr, flush=True)
        if slo_monitor is not None:
            slo_monitor.stop()
        if autoscaler is not None:
            autoscaler.stop()
        if launcher is not None:
            launcher.close()
        if status_server is not None:
            status_server.close()
        if router is not None:
            router.close()
        for proc, _port in list(procs.values()):
            release_subprocess(proc)
        if canary_proc is not None:
            release_subprocess(canary_proc)
        if sink is not None:
            sink.close()
        if obs_dir is not None:
            # The replicas SIGTERMed above exported their trace fragments
            # under this run's id: the merge stitches the fleet and every
            # replica into one trace.json.
            from batchai_retinanet_horovod_coco_tpu_torch import obs

            obs.finalize()
    if router is None:
        return {}  # interrupted before the fleet started
    status = router.status()
    print(json.dumps({"fleet_stats": status["stats"]}), flush=True)
    return status


if __name__ == "__main__":
    main()
