"""Autoscaling control plane for the serve fleet; the JAX package's
``serve/autoscale.py`` for the port.

Every signal a control loop needs is on the fleet registry (occupancy,
free slots, federated p99, shed counters) and every actuator exists
(subprocess spawn and respawn supervision, drain on SIGTERM in the serve
frontend, the breaker's half-open readmit).  This module is the loop that
connects them:

- ``AutoscalePolicy`` — the declarative contract: a target occupancy band
  (hysteresis: no decision inside it), an optional federated-p99 ceiling,
  min/max replica bounds (``min_replicas=0`` ⇒ scale-to-zero),
  per-direction cooldowns, and step sizes.  Loadable from a JSON policy
  file (``AutoscalePolicy.from_file``).
- ``Autoscaler`` — ``check_once(now=...)`` on an injectable clock (the
  anti-flap state machine is testable without sleeping), a
  watchdog-registered poll thread with the crash-announce contract, and
  ONE structured ``autoscale_decision`` event per decision (trace instant
  + sink record + stderr JSON line) carrying the reason, the signal
  values it acted on, and the replica delta.

Decision semantics:

- **Scale-up** fires after the occupancy-high (or p99-ceiling) breach
  holds ``for_s`` AND the up-cooldown has elapsed — one decision per
  cooldown window while the breach sustains.  The launcher blocks until
  the new replica's ``/healthz`` answers 200, and the router gives it
  weight only after its OWN first successful health poll.  At
  ``max_replicas`` the breach emits a capped decision.
- **Scale-down** picks the LOWEST-weight routable replica the launcher
  owns, marks it draining in the router (``begin_drain``), and SIGTERMs it
  into the serve frontend's drain; the slot is reclaimed only once the
  launcher reports the process gone (``reap``).  In-flight work is never
  dropped.
- **Scale-to-zero** (``min_replicas=0``) requires STRICT idleness.  A
  request arriving at an empty fleet sheds ``no_replica_available`` at
  the edge; that shed is the demand signal that scales 1 replica up AT
  ONCE (no sustain, no cooldown).
- **Preemption** (a replica dying un-asked) is free scale-down: respawn
  supervision readmits it, and when the respawn budget is exhausted the
  abandoned slot is pruned here (``launcher.prune``).

The launcher is duck-typed (the fleet command line's subprocess launcher
and the in-process ``LocalLauncher`` below both satisfy it):
``launch() -> replica`` (blocking until healthy), ``terminate(replica_id)``,
``reap(replica_id) -> bool``, ``owns(replica_id) -> bool`` and
``prune() -> list[str]``.

Scaling never alters per-request results: the loop adds and removes
capacity; routing, batching and the engine are untouched.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
from typing import Any, Callable

from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import emit_event
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock

#: The federated-snapshot key whose per-poll increase signals demand at
#: an EMPTY fleet (a request shed because no replica was routable).
_DEMAND_KEY = 'fleet_shed_total{reason="no_replica_available"}'


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The declarative scaling contract (frozen; a policy change is a
    new policy object).  The occupancy band is a hysteresis band: above
    ``occupancy_high`` (sustained) scales up, below ``occupancy_low``
    (sustained) scales down, and INSIDE the band no decision ever fires
    — oscillating load between the thresholds produces zero decisions."""

    min_replicas: int = 1  # 0 = scale-to-zero (cold tier)
    max_replicas: int = 4
    occupancy_low: float = 0.25
    occupancy_high: float = 0.75
    # Optional federated-p99 SLO ceiling (ms): a sustained breach scales
    # up even while occupancy reads inside the band (queueing shows up
    # in latency before slot occupancy saturates).
    p99_slo_ms: float | None = None
    scale_up_step: int = 1
    scale_down_step: int = 1
    # A breach must hold this long before ANY decision fires.
    for_s: float = 5.0
    # Per-direction cooldowns: at most one decision per direction per
    # window while a breach sustains.
    up_cooldown_s: float = 10.0
    down_cooldown_s: float = 30.0
    # Poll cadence of the production thread (check_once is injectable).
    interval_s: float = 1.0

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError(
                f"min_replicas must be >= 0, got {self.min_replicas}"
            )
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                f"max_replicas must be >= max(1, min_replicas), got "
                f"{self.max_replicas} (min {self.min_replicas})"
            )
        if not 0.0 <= self.occupancy_low < self.occupancy_high <= 1.0:
            raise ValueError(
                "need 0 <= occupancy_low < occupancy_high <= 1, got "
                f"[{self.occupancy_low}, {self.occupancy_high}]"
            )
        if self.scale_up_step < 1 or self.scale_down_step < 1:
            raise ValueError("scale steps must be >= 1")
        for field in ("for_s", "up_cooldown_s", "down_cooldown_s"):
            if getattr(self, field) < 0:
                raise ValueError(f"{field} must be >= 0")

    @classmethod
    def from_json(cls, doc: dict) -> "AutoscalePolicy":
        """Build from a policy-file document; unknown keys are an error
        (a typo'd knob silently falling back to its default is exactly
        how a production policy lies)."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - known)
        if unknown:
            raise ValueError(
                f"unknown autoscale policy keys {unknown}; known: "
                f"{sorted(known)}"
            )
        return cls(**doc)

    @classmethod
    def from_file(cls, path: str) -> "AutoscalePolicy":
        with open(path) as f:
            return cls.from_json(json.load(f))


class Autoscaler:
    """The control loop: reads ``router.federated_snapshot()`` +
    ``router.status()``, decides against the policy, actuates through
    the launcher.  ``check_once(now=...)`` returns the decisions fired
    this tick (usually empty); ``start()`` runs it on a
    watchdog-registered poll thread in production."""

    MAX_KEPT = 1000  # bounded decision history, like SloMonitor

    def __init__(self, router, policy: AutoscalePolicy, launcher,
                 sink: Any | None = None):
        self.router = router
        self.policy = policy
        self.launcher = launcher
        self.sink = sink if sink is not None else getattr(
            router, "sink", None
        )
        self.decisions: list[dict] = []
        self._lock = make_lock("serve.autoscale.Autoscaler._lock")
        self._draining: dict[str, float] = {}  # rid -> drain start
        self._up_since: float | None = None
        self._down_since: float | None = None
        self._last_up_t = float("-inf")
        self._last_down_t = float("-inf")
        self._ups = 0
        self._downs = 0
        self._capped = 0
        self._desired = 0
        self._spawn_seq = 0
        self._last_snap: dict[str, float] = {}
        self._last_signals: dict = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Keep ONE bound-method object: attribute access mints a fresh
        # one each time, and unregister_collector matches by identity.
        self._collector = self._collect
        router.telemetry.register_collector(self._collector)

    # ---- metrics ---------------------------------------------------------

    def _collect(self):
        with self._lock:
            desired, draining = self._desired, len(self._draining)
            ups, downs, capped = self._ups, self._downs, self._capped
        yield ("fleet_replicas_desired", "gauge",
               "replica count the autoscale policy currently wants",
               None, float(desired))
        yield ("fleet_replicas_active", "gauge",
               "non-drained replicas the autoscaler counts as capacity",
               None, float(self.router.active_replica_count()))
        yield ("fleet_scale_up_total", "counter",
               "autoscale scale-up decisions", None, float(ups))
        yield ("fleet_scale_down_total", "counter",
               "autoscale scale-down decisions", None, float(downs))
        yield ("fleet_scale_capped_total", "counter",
               "scale-up breaches blocked at max_replicas (the "
               "fleet:underprovisioned signal)", None, float(capped))
        yield ("fleet_autoscale_draining", "gauge",
               "replicas currently draining toward removal", None,
               float(draining))

    # ---- one tick --------------------------------------------------------

    def check_once(self, now: float | None = None) -> list[dict]:
        """One evaluation: reap finished drains, prune abandoned slots,
        read the signals, fire at most one decision.  Injectable ``now``
        pins the sustain/cooldown machinery in tests."""
        now = monotonic_s() if now is None else now
        pol = self.policy
        self._finish_drains()
        for rid in self.launcher.prune():
            self.router.remove_replica(rid)

        snap = self.router.federated_snapshot()
        status = self.router.status()
        states = status["replicas"]
        active = sum(1 for r in states if r["state"] != "drained")
        occupancy = snap.get("fleet_occupancy")
        p99 = snap.get("fleet_federated_p99_ms")
        if p99 is None:
            # Without a federation scrape this tick, the health-poll
            # advertised worst replica p99 is the same ceiling input.
            p99 = snap.get("fleet_replica_p99_ms")
        with self._lock:
            prev = self._last_snap
            self._last_snap = snap
        # Labeled shed counters only materialize on their first
        # increment, so a key missing from a non-empty baseline IS a
        # zero baseline — the first-ever ``no_replica_available`` shed
        # must register as demand.  An empty prev (first tick) stays 0.
        if prev:
            demand = max(
                0.0,
                float(snap.get(_DEMAND_KEY) or 0.0)
                - float(prev.get(_DEMAND_KEY) or 0.0),
            )
        else:
            demand = 0.0
        completed = self._delta(
            prev, snap, "fleet_requests_completed_total"
        )
        inflight = snap.get("fleet_inflight") or 0.0
        streams = snap.get("fleet_streams_open") or 0.0
        idle = (
            completed == 0.0 and demand == 0.0
            and inflight == 0.0 and streams == 0.0
        )
        signals = {
            "occupancy": None if occupancy is None else round(occupancy, 4),
            "p99_ms": None if p99 is None else round(float(p99), 3),
            "inflight": inflight,
            "streams_open": streams,
            "demand_shed": demand,
            "active": active,
        }
        with self._lock:
            self._last_signals = signals

        fired: list[dict] = []
        decision = self._decide(now, active, occupancy, p99, idle,
                                demand, signals, states)
        if decision is not None:
            fired.append(decision)
        with self._lock:
            self._desired = min(
                pol.max_replicas,
                max(pol.min_replicas,
                    self.router.active_replica_count()),
            )
        return fired

    def _decide(self, now, active, occupancy, p99, idle, demand,
                signals, states) -> dict | None:
        pol = self.policy
        # Immediate paths — bypass sustain AND cooldown: capacity below
        # the declared floor (or demand hitting an empty fleet) is a
        # contract violation, never flap.
        if active == 0 and demand > 0:
            return self._scale_up(
                now, max(1, pol.min_replicas), "demand_scale_from_zero",
                signals, sustained_s=0.0,
            )
        if active < pol.min_replicas:
            return self._scale_up(
                now, pol.min_replicas - active, "below_min", signals,
                sustained_s=0.0,
            )

        up_reason = None
        if occupancy is not None and occupancy > pol.occupancy_high:
            up_reason = "occupancy_high"
        elif (pol.p99_slo_ms is not None and p99 is not None
              and float(p99) > pol.p99_slo_ms):
            up_reason = "p99_breach"
        if up_reason is not None:
            self._down_since = None
            if self._up_since is None:
                self._up_since = now
            sustained = now - self._up_since
            if sustained < pol.for_s or now - self._last_up_t < pol.up_cooldown_s:
                return None
            if active >= pol.max_replicas:
                # The breach the policy cannot act on: one capped
                # decision per cooldown window — the underprovisioned
                # evidence trail.
                self._last_up_t = now
                with self._lock:
                    self._capped += 1
                return self._emit_decision(
                    decision="scale_up_capped", reason=up_reason,
                    delta=0, active=active, signals=signals,
                    sustained_s=round(sustained, 3),
                )
            step = min(pol.scale_up_step, pol.max_replicas - active)
            return self._scale_up(now, step, up_reason, signals,
                                  sustained_s=round(sustained, 3))

        down_breach = (
            occupancy is not None and occupancy < pol.occupancy_low
        )
        if not down_breach:
            self._up_since = None
            self._down_since = None
            return None
        self._up_since = None
        if self._down_since is None:
            self._down_since = now
        sustained = now - self._down_since
        # The LAST replica goes only on strict idleness: a trickle of
        # traffic below the band keeps one replica alive even at min 0.
        floor = pol.min_replicas if (pol.min_replicas >= 1 or idle) else 1
        if (
            sustained < pol.for_s
            or now - self._last_down_t < pol.down_cooldown_s
            or active <= floor
        ):
            return None
        step = min(pol.scale_down_step, active - floor)
        return self._scale_down(
            now, step, "idle" if idle else "occupancy_low", signals,
            sustained_s=round(sustained, 3), states=states,
        )

    # ---- actuation -------------------------------------------------------

    def _scale_up(self, now, count, reason, signals, sustained_s):
        self._last_up_t = now
        launched, errors = 0, 0
        for _ in range(count):
            try:
                replica = self.launcher.launch()
            except Exception as exc:
                errors += 1
                emit_event(
                    "autoscale_launch_failed", sink=self.sink,
                    error=repr(exc)[:300],
                )
                continue
            self.router.add_replica(replica)
            launched += 1
        if launched:
            with self._lock:
                self._ups += 1
        return self._emit_decision(
            decision="scale_up", reason=reason, delta=launched,
            active=signals["active"], signals=signals,
            sustained_s=sustained_s,
            **({"launch_errors": errors} if errors else {}),
        )

    def _scale_down(self, now, count, reason, signals, sustained_s,
                    states):
        victims = self._pick_victims(states, count)
        if not victims:
            return None  # nothing the launcher owns — no decision
        self._last_down_t = now
        for rid in victims:
            self.router.begin_drain(rid)
            self.launcher.terminate(rid)
            self._draining[rid] = now
        with self._lock:
            self._downs += 1
        return self._emit_decision(
            decision="scale_down", reason=reason, delta=-len(victims),
            active=signals["active"], signals=signals,
            sustained_s=sustained_s, victims=victims,
        )

    def _pick_victims(self, states, count) -> list[str]:
        """Lowest-weight routable replicas the launcher owns (a canary
        under evaluation and attached foreign replicas are never scaled
        down).  Weight ties break on replica_id, like routing does."""
        cands = sorted(
            (
                (r["weight"], r["replica_id"])
                for r in states
                if r["state"] == "closed" and not r["is_canary"]
                and self.launcher.owns(r["replica_id"])
            ),
        )
        return [rid for _w, rid in cands[:count]]

    def _finish_drains(self) -> None:
        for rid in sorted(self._draining):
            if self.launcher.reap(rid):
                self._draining.pop(rid, None)
                self.router.remove_replica(rid)

    # ---- events ----------------------------------------------------------

    def _emit_decision(self, *, decision, reason, delta, active,
                       signals, sustained_s, **extra) -> dict:
        record = {
            "decision": decision,
            "reason": reason,
            "delta": delta,
            "replicas_before": active,
            "sustained_s": sustained_s,
            **{k: v for k, v in signals.items() if k != "active"},
            **extra,
        }
        self.decisions.append(record)
        if len(self.decisions) > self.MAX_KEPT:
            del self.decisions[: -self.MAX_KEPT]
        # Trace instant + sink record + ONE stderr JSON line.
        emit_event("autoscale_decision", sink=self.sink, **record)
        return record

    @staticmethod
    def _delta(prev: dict, snap: dict, key: str) -> float:
        """Per-tick increase of a cumulative counter key; 0 on the first
        sample (no baseline) — the SloMonitor delta-rule convention."""
        cur = snap.get(key)
        if cur is None:
            return 0.0
        base = prev.get(key)
        if base is None:
            return 0.0
        return max(0.0, float(cur) - float(base))

    # ---- status + lifecycle ----------------------------------------------

    def status(self) -> dict:
        """The /fleet debugging view of the loop's live state."""
        with self._lock:
            return {
                "policy": dataclasses.asdict(self.policy),
                "desired": self._desired,
                "draining": sorted(self._draining),
                "signals": dict(self._last_signals),
                "scale_ups": self._ups,
                "scale_downs": self._downs,
                "capped": self._capped,
                "breaching_up": self._up_since is not None,
                "breaching_down": self._down_since is not None,
                "decisions_tail": self.decisions[-5:],
            }

    def _run(self, hb: watchdog.Heartbeat) -> None:
        try:
            while not self._stop.wait(self.policy.interval_s):
                hb.beat()
                self.check_once()
        except BaseException as e:
            # Crash channel (thread-error-contract): a silently dead
            # autoscaler means capacity frozen at its last decision —
            # announce on stderr, re-raise so the thread death is loud.
            print(
                json.dumps(
                    {"event": "autoscaler_crashed", "error": repr(e)}
                ),
                file=sys.stderr, flush=True,
            )
            raise
        finally:
            hb.close()

    def start(self) -> "Autoscaler":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        hb = watchdog.register("fleet-autoscaler")
        self._thread = threading.Thread(
            target=self._run, args=(hb,), daemon=True,
            name="fleet-autoscaler",
        )
        self._thread.start()
        return self

    def request_stop(self) -> None:
        """Signal the poll loop without joining (safe from the poll
        thread itself — the SloMonitor contract)."""
        self._stop.set()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # Detach the gauges: a stopped control loop reporting frozen
        # desired/active counts on a live fleet registry would lie.
        self.router.telemetry.unregister_collector(self._collector)


class LocalLauncher:
    """In-process launcher over ``LocalReplica`` handles (the fleet
    command line uses its subprocess launcher).

    ``factory(replica_id)`` builds one replica handle; ``terminate`` is
    deliberately lazy (the router's ``begin_drain`` already unroutes the
    victim) and ``reap`` performs the BOUNDED drain: in-flight work on
    the victim completes before the slot is reclaimed — the zero-drop
    contract the scale-down tests pin."""

    def __init__(self, factory: Callable[[str], Any],
                 drain_timeout_s: float = 10.0, prefix: str = "scale"):
        self._factory = factory
        self._drain_timeout_s = drain_timeout_s
        self._prefix = prefix
        self._seq = 0
        self._live: dict[str, Any] = {}
        self._terminating: set[str] = set()

    def launch(self):
        rid = f"{self._prefix}-{self._seq}"
        self._seq += 1
        replica = self._factory(rid)
        self._live[rid] = replica
        return replica

    def adopt(self, replica) -> None:
        """Register a pre-existing replica as launcher-owned, so the
        seed replicas a harness builds by hand are scale-down eligible."""
        self._live[replica.replica_id] = replica

    def owns(self, rid: str) -> bool:
        return rid in self._live

    def terminate(self, rid: str) -> None:
        self._terminating.add(rid)

    def reap(self, rid: str) -> bool:
        if rid not in self._terminating:
            return False
        replica = self._live.get(rid)
        if replica is None:
            self._terminating.discard(rid)
            return True
        # Bounded drain: lets in-flight futures complete, then closes.
        replica.drain(timeout_s=self._drain_timeout_s)
        server = getattr(replica, "server", None)
        if server is not None and getattr(server, "_outstanding", 0):
            return False  # still draining — try again next tick
        try:
            replica.close()
        except Exception:
            pass  # release is best-effort; the handle is already out
        self._live.pop(rid, None)
        self._terminating.discard(rid)
        return True

    def prune(self) -> list[str]:
        return []


__all__ = ["AutoscalePolicy", "Autoscaler", "LocalLauncher"]
