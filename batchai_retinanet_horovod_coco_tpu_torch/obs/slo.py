"""SLO monitor: declarative rules over the telemetry registry; the JAX
package's ``obs/slo.py`` for the port.

The registry (obs/telemetry.py) answers "how loaded is this process right
now"; this module answers "is that within the budget we declared" —
continuously, during the run — with one structured ``slo_violation``
event into the run's JSONL sink, one ``slo_violation`` trace instant and
one stderr line per sustained breach.

Rule shapes (all evaluated on ``Registry.snapshot()`` keys):

- **static ceiling/floor** — ``value OP threshold`` (p99 ceiling, stall
  count, data_wait fraction);
- **delta** — per-poll increase of a cumulative counter (shed RATE from
  ``serve_shed_total`` without a rate gauge);
- **regression vs a rolling window** — breach when the value exceeds
  ``factor ×`` the rolling median of its own recent healthy samples
  (step-time regression with no hand-picked absolute ceiling).

Anti-flap contract: a rule fires EXACTLY ONCE per sustained breach — the
breach must hold for ``for_s`` before the event is emitted, the fired
latch holds through the rest of the breach, and only ``clear_s`` of
continuous health re-arms it.  ``check_once(now=...)`` is injectable so
all of that is testable without sleeping (the watchdog's pattern).

The monitor is read-only (it never sheds, kills, or throttles) and its
poll thread is watchdog-registered: a wedged SLO monitor is itself a
diagnosed stall.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import threading
from typing import Any, Callable

from batchai_retinanet_horovod_coco_tpu_torch.obs import trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.telemetry import Registry
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One declarative objective over a snapshot metric.

    ``baseline_window > 0`` selects regression mode: the threshold is
    ``factor × median`` of the last ``baseline_window`` HEALTHY samples
    (breaching samples never poison their own baseline), armed only
    after ``min_baseline`` samples.  ``delta`` evaluates the per-poll
    increase instead of the value (cumulative counters → rates).
    """

    name: str
    metric: str  # a Registry.snapshot() key, e.g. "serve_request_latency_ms.p99"
    op: str = ">"  # breach when  value OP threshold  holds
    threshold: float | None = None
    for_s: float = 0.0  # breach must hold this long before firing
    clear_s: float = 10.0  # continuous health needed to re-arm
    delta: bool = False  # evaluate per-poll increase, not the value
    baseline_window: int = 0  # >0: regression vs rolling-median baseline
    factor: float = 1.5
    min_baseline: int = 5
    description: str = ""


_OPS: dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
}


class _RuleState:
    __slots__ = (
        "breach_since", "healthy_since", "fired", "baseline", "last_raw",
        "last_value", "last_threshold",
    )

    def __init__(self):
        self.breach_since: float | None = None
        self.healthy_since: float | None = None
        self.fired = False
        self.baseline: list[float] = []
        self.last_raw: float | None = None  # previous cumulative (delta mode)
        self.last_value: float | None = None
        self.last_threshold: float | None = None


class SloMonitor:
    """Evaluate ``rules`` against ``registry.snapshot()`` on a poll loop.

    Violations are appended to ``self.violations`` (bounded), emitted to
    ``sink.event("slo_violation", ...)`` and ``trace.instant`` — plus one
    stderr line so an un-sinked run still shows the breach — and counted
    in the registry itself (``slo_violations_total{rule=...}``, scraped
    like everything else).
    """

    MAX_KEPT = 1000  # bounded memory over arbitrarily long runs

    def __init__(
        self,
        registry: Registry,
        rules: list[SloRule],
        sink: Any | None = None,
        poll_interval: float = 5.0,
        on_violation: Callable[[dict], None] | None = None,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names in {names}")
        self.registry = registry
        self.rules = list(rules)
        self.sink = sink
        self.poll_interval = poll_interval
        self.on_violation = on_violation
        self.violations: list[dict] = []
        self._fired_counts: dict[str, int] = {}
        self._states = {r.name: _RuleState() for r in self.rules}
        # Pull-based (a push counter would be gated on the global enable
        # bool, which a scrape-only serve monitor never sets).
        registry.register_collector(self._collect)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    def _collect(self):
        for rule, n in sorted(self._fired_counts.items()):
            yield (
                "slo_violations_total", "counter",
                "slo_violation events fired, by rule", {"rule": rule},
                float(n),
            )

    # ---- evaluation ------------------------------------------------------

    def _evaluate(
        self, rule: SloRule, state: _RuleState, snap: dict[str, float]
    ) -> tuple[float | None, float | None, bool]:
        """(value, threshold, breached) for one rule on one snapshot.
        value None = no data this poll (missing metric, or the first
        sample of a delta rule) — treated as healthy-but-unknown."""
        raw = snap.get(rule.metric)
        if raw is None:
            return None, None, False
        if rule.delta:
            prev, state.last_raw = state.last_raw, raw
            if prev is None:
                return None, None, False
            value = raw - prev
        else:
            value = raw
        if rule.baseline_window > 0:
            threshold = None
            if len(state.baseline) >= rule.min_baseline:
                threshold = rule.factor * _median(state.baseline)
        else:
            threshold = rule.threshold
        breached = threshold is not None and _OPS[rule.op](value, threshold)
        if rule.baseline_window > 0 and not breached:
            # Healthy samples only: a sustained regression must not drag
            # its own baseline up until the breach "heals" by definition.
            state.baseline.append(value)
            if len(state.baseline) > rule.baseline_window:
                del state.baseline[: -rule.baseline_window]
        return value, threshold, breached

    def check_once(self, now: float | None = None) -> list[dict]:
        """One poll: returns the violations that FIRED this poll (usually
        empty).  Injectable ``now`` makes the sustain/re-arm state machine
        testable without sleeping."""
        now = monotonic_s() if now is None else now
        snap = self.registry.snapshot()
        fired: list[dict] = []
        for rule in self.rules:
            state = self._states[rule.name]
            value, threshold, breached = self._evaluate(rule, state, snap)
            state.last_value, state.last_threshold = value, threshold
            if breached:
                state.healthy_since = None
                if state.breach_since is None:
                    state.breach_since = now
                if (
                    not state.fired
                    and now - state.breach_since >= rule.for_s
                ):
                    state.fired = True  # once per sustained breach
                    fired.append(
                        {
                            "rule": rule.name,
                            "metric": rule.metric,
                            "op": rule.op,
                            "value": round(float(value), 4),
                            "threshold": round(float(threshold), 4),
                            "sustained_s": round(now - state.breach_since, 3),
                            "description": rule.description,
                        }
                    )
            else:
                state.breach_since = None
                if state.fired:
                    if state.healthy_since is None:
                        state.healthy_since = now
                    if now - state.healthy_since >= rule.clear_s:
                        state.fired = False  # re-armed for the next breach
        for v in fired:
            self._emit(v)
        return fired

    def _emit(self, violation: dict) -> None:
        self.violations.append(violation)
        if len(self.violations) > self.MAX_KEPT:
            del self.violations[: -self.MAX_KEPT]
        self._fired_counts[violation["rule"]] = (
            self._fired_counts.get(violation["rule"], 0) + 1
        )
        # Timeline marker first (no-op while tracing is off), then the
        # JSONL record, then one unmissable stderr line — same layering
        # as the watchdog's stall dump.
        trace.instant(
            "slo_violation",
            rule=violation["rule"],
            metric=violation["metric"],
            value=violation["value"],
            threshold=violation["threshold"],
            sustained_s=violation["sustained_s"],
        )
        if self.sink is not None:
            try:
                self.sink.event("slo_violation", **violation)
            except Exception:
                pass  # a broken sink must not mask the stderr line
        print(
            json.dumps({"event": "slo_violation", **violation}),
            file=sys.stderr, flush=True,
        )
        if self.on_violation is not None:
            self.on_violation(violation)

    def status(self) -> dict:
        """Per-rule live state (the /statusz debugging view)."""
        out = {}
        for rule in self.rules:
            s = self._states[rule.name]
            out[rule.name] = {
                "metric": rule.metric,
                "value": s.last_value,
                "threshold": s.last_threshold,
                "breaching": s.breach_since is not None,
                "fired": s.fired,
            }
        return out

    # ---- poll thread -----------------------------------------------------

    def _run(self, hb: watchdog.Heartbeat) -> None:
        try:
            while not self._stop.wait(self.poll_interval):
                hb.beat()
                self.check_once()
        except BaseException as e:
            # The monitor must never die silently: a crashed poll thread
            # silently disarms every SLO for the rest of the run.
            print(
                json.dumps(
                    {"event": "slo_monitor_crashed", "error": repr(e)}
                ),
                file=sys.stderr, flush=True,
            )
            raise
        finally:
            hb.close()

    def start(self) -> "SloMonitor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        hb = watchdog.register("slo-monitor")
        self._thread = threading.Thread(
            target=self._run, args=(hb,), daemon=True, name="slo-monitor"
        )
        self._thread.start()
        return self

    def request_stop(self) -> None:
        """Signal the poll loop to exit WITHOUT joining — safe to call
        from the poll thread itself (e.g. an ``on_violation`` handler
        that terminally resolves the monitored condition).  ``stop()`` from another thread
        still performs the full join + final evaluation."""
        self._stop.set()

    def stop(self) -> None:
        started = self._thread is not None
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if started:
            # One final evaluation at drain: a run shorter than one poll
            # interval (offline serve mode, smoke configs) must still get
            # its rules evaluated at least once — an end-of-run breach is
            # a breach, not a race against the poll clock.
            self.check_once()


def _median(values: list[float]) -> float:
    s = sorted(values)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


# ---------------------------------------------------------------------------
# Built-in rules + the CLI grammar
# ---------------------------------------------------------------------------


def stall_rule(for_s: float = 0.0) -> SloRule:
    """Fires when the watchdog reports any non-idle component past its
    stall budget (the registry's ``watchdog_stalled`` gauge)."""
    return SloRule(
        name="watchdog-stall",
        metric="watchdog_stalled",
        op=">",
        threshold=0.0,
        for_s=for_s,
        description="a watchdog component is past its stall budget",
    )


def p99_ceiling(
    ceiling_ms: float,
    metric: str = "serve_request_latency_ms.p99",
    for_s: float = 10.0,
) -> SloRule:
    return SloRule(
        name="p99-ceiling",
        metric=metric,
        op=">",
        threshold=ceiling_ms,
        for_s=for_s,
        description=f"windowed p99 above the {ceiling_ms} ms ceiling",
    )


def shed_rate(
    max_per_poll: float,
    metric: str = "serve_shed_total",
    for_s: float = 0.0,
) -> SloRule:
    return SloRule(
        name="shed-rate",
        metric=metric,
        delta=True,
        op=">",
        threshold=max_per_poll,
        for_s=for_s,
        description=f"more than {max_per_poll} requests shed per poll",
    )


def step_time_regression(
    factor: float = 1.5,
    window: int = 32,
    metric: str = "train_step_time_ms",
    for_s: float = 30.0,
) -> SloRule:
    return SloRule(
        name="step-time-regression",
        metric=metric,
        op=">",
        baseline_window=window,
        factor=factor,
        for_s=for_s,
        description=(
            f"step time above {factor}x its rolling-median baseline"
        ),
    )


def nonfinite_rule(metric: str = "train_nonfinite_total") -> SloRule:
    """Fires IMMEDIATELY (no sustain, no baseline) on any non-finite
    gradient element or tripped finite-check (the loop's abort path and
    the in-step summary both feed the counter).  A NaN is
    never a transient — ``for_s=0`` and the fired latch never re-arms in
    practice because the counter is monotonic within a run."""
    return SloRule(
        name="train-nonfinite",
        metric=metric,
        op=">",
        threshold=0.0,
        for_s=0.0,
        description=(
            "non-finite values in the gradient/update stream "
            "(NUMERICS_DUMP.json has the provenance)"
        ),
    )


def ckpt_staleness_rule(
    factor: float = 2.0,
    metric: str = "ckpt_staleness",
    for_s: float = 0.0,
) -> SloRule:
    """Fires when training has ADVANCED ``factor ×`` the measured
    steps-between-saves past the last successful checkpoint:
    a silently wedged or crash-looping saver is otherwise invisible
    until the run dies and resume discovers hours of lost work.  The
    metric is the telemetry plane's STEP-based ``ckpt_staleness`` pull
    gauge (obs/telemetry.py, present once two saves have landed) — not
    the wall-clock age, which a legitimate multi-minute sync eval or
    cold compile inflates while no step runs; steps only advance when
    the loop is actually training past its save cadence."""
    return SloRule(
        name="ckpt-staleness",
        metric=metric,
        op=">",
        threshold=factor,
        for_s=for_s,
        description=(
            f"training advanced {factor}x the save cadence with no "
            "checkpoint landing (saver wedged/dying; see "
            "ckpt_write_error on stderr and the ckpt-writer watchdog "
            "component)"
        ),
    )


def grad_norm_spike(
    factor: float = 10.0,
    window: int = 32,
    metric: str = "train_grad_norm",
    for_s: float = 0.0,
) -> SloRule:
    """Pre-divergence tripwire: the pre-clip global gradient norm vs
    ``factor ×`` the rolling median of its own HEALTHY history (the SLO
    regression mode — no hand-picked absolute ceiling, and breaching
    samples never poison the baseline).  Loose factor by default: the
    clip chain absorbs ordinary spikes; a 10x sustained departure is the
    loss-about-to-diverge signature worth a page."""
    return SloRule(
        name="grad-norm-spike",
        metric=metric,
        op=">",
        baseline_window=window,
        factor=factor,
        for_s=for_s,
        description=(
            f"pre-clip grad norm above {factor}x its rolling-median "
            "baseline"
        ),
    )


def ef_residual_spike(
    factor: float = 10.0,
    window: int = 32,
    metric: str = "train_ef_residual",
    for_s: float = 0.0,
    hop: str | None = None,
) -> SloRule:
    """Gradient-compression health tripwire: the error-feedback residual
    norm against ``factor ×`` the rolling median of its own healthy
    history.  A spike means the per-block int8 scales stopped fitting the
    gradients (saturation): the quantizer now drops signal the optimizer
    needed.  Regression mode, as ``grad_norm_spike``; silent on runs
    without compression (the ``train_ef_residual`` gauge never exists), so
    the command line always arms it.

    ``hop="dcn"`` watches the cross-slice hop of the hierarchical tree
    (``train_ef_residual_dcn``, the only hop that quantizes) under the name
    ``ef_residual_spike_dcn``, silent without its gauge too."""
    if hop is not None:
        metric = f"train_ef_residual_{hop}"
    return SloRule(
        name="ef_residual_spike" if hop is None else f"ef_residual_spike_{hop}",
        metric=metric,
        op=">",
        baseline_window=window,
        factor=factor,
        for_s=for_s,
        description=(
            f"gradient-compression EF residual above {factor}x its "
            "rolling-median baseline (per-block scales saturating; "
            "compressed gradients dropping signal)"
            + (f" [{hop} hop of the hierarchical tree]" if hop else "")
        ),
    )


def fleet_availability_rule(
    floor: float = 0.999,
    metric: str = "fleet_availability",
    for_s: float = 0.0,
) -> SloRule:
    """Fleet availability floor: fires when the fraction of ROUTABLE
    replicas (breaker CLOSED) over non-drained replicas drops below
    ``floor`` — when ANY replica is lost, at the default.  The metric is
    the fleet router's ``fleet_availability`` gauge; the anti-flap
    machinery makes a replica death page exactly once per sustained loss
    (the breaker readmitting the respawned replica heals the breach and,
    after ``clear_s``, re-arms the rule).  Silent on registries without
    the gauge."""
    return SloRule(
        name="fleet-availability",
        metric=metric,
        op="<",
        threshold=floor,
        for_s=for_s,
        description=(
            f"routable-replica fraction below {floor} (a replica's "
            "breaker is open or the replica is gone; see the "
            "fleet_breaker_open events on the timeline)"
        ),
    )


def fleet_occupancy_rule(
    ceiling: float = 0.97,
    metric: str = "fleet_occupancy",
    for_s: float = 30.0,
) -> SloRule:
    """Fleet saturation tripwire: fires when mean live slot occupancy
    across ROUTABLE replicas (the fleet router's ``fleet_occupancy`` gauge,
    draining replicas excluded) stays at ``ceiling`` or above for
    ``for_s``.  With the autoscaler armed this can only sustain when
    scale-ups are capped at ``max_replicas`` (underprovisioned by policy);
    without it, it says to arm ``--autoscale`` or add replicas.  Silent on
    registries without the gauge."""
    return SloRule(
        name="fleet-occupancy-saturated",
        metric=metric,
        op=">=",
        threshold=ceiling,
        for_s=for_s,
        description=(
            f"fleet slot occupancy pinned at >= {ceiling} for {for_s:g}s "
            "(capacity saturated; autoscale capped or not armed — see "
            "the autoscale_decision events and fleet_scale_capped_total)"
        ),
    )


#: ``--slo-rule`` grammar:  METRIC OP THRESHOLD [@FOR_S]
#: where OP ∈ {>, >=, <, <=} and THRESHOLD is either a number (static
#: ceiling/floor) or ``xFACTOR`` (regression vs the rolling-median
#: baseline), e.g. ``serve_request_latency_ms.p99>250@30`` or
#: ``train_step_time_ms>x1.5@60``.
_RULE_RE = re.compile(
    r"^(?P<metric>[^<>=@\s]+)\s*(?P<op>>=|<=|>|<)\s*"
    r"(?P<thr>x?[-+0-9.eE]+)\s*(?:@\s*(?P<for>[0-9.]+))?$"
)


def parse_rule(spec: str) -> SloRule:
    """One ``--slo-rule`` spec → an ``SloRule`` (see ``_RULE_RE``)."""
    m = _RULE_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"bad SLO rule {spec!r}: expected METRIC{{>,>=,<,<=}}THRESHOLD"
            "[@FOR_S], e.g. 'serve_request_latency_ms.p99>250@30' or "
            "'train_step_time_ms>x1.5@60' (x = regression factor vs a "
            "rolling-median baseline)"
        )
    metric, op, thr = m.group("metric"), m.group("op"), m.group("thr")
    for_s = float(m.group("for") or 0.0)
    # The op spelled out in the generated name: sanitizing '>' and '<'
    # both to '_' would collide a floor and a ceiling on one metric into
    # "duplicate SLO rule names" at startup.
    op_name = {">": "gt", ">=": "ge", "<": "lt", "<=": "le"}[op]
    name = re.sub(
        r"[^A-Za-z0-9_.-]", "_", f"{metric}_{op_name}_{thr}@{for_s:g}"
    )
    if thr.startswith("x"):
        return SloRule(
            name=name, metric=metric, op=op, for_s=for_s,
            baseline_window=32, factor=float(thr[1:]),
            description=f"declared via --slo-rule {spec!r}",
        )
    return SloRule(
        name=name, metric=metric, op=op, threshold=float(thr), for_s=for_s,
        description=f"declared via --slo-rule {spec!r}",
    )
