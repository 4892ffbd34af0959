"""Live telemetry plane: the in-process metrics registry + exposition; the
JAX package's ``obs/telemetry.py`` for the port.

A lock-light registry the instrumentation feeds, a Prometheus-text
exposition encoder (byte-equal to the JAX package's for the same series,
so dashboards and ``parse_exposition`` read both), a snapshot API the SLO
monitor (obs/slo.py) evaluates rules on, and a drain-safe stdlib HTTP
status server (``train --obs-port``; the serve frontend mounts the same
payloads on its own port as ``GET /metrics`` / ``GET /healthz``).

Design constraints, in priority order:

1. **Nil disabled-path overhead.**  Hot-path *push* sites
   (``record_train_window``, ``record_compile``, ``Counter.inc`` ...)
   check ONE module-level bool and return; no allocation, no lock, no
   clock read while telemetry is off.  Most of the registry is *pull*:
   gauges/histograms take a callback evaluated only at scrape time, so
   wiring the serve stats or watchdog ages in costs the hot path nothing
   at all (the scrape itself is the opt-in).
2. **No torch import.**  Device memory is read through
   ``obs.events.device_memory_stats`` (nothing until CUDA is initialised
   by the program); everything else is stdlib + numpy.
3. **Read-only.**  Telemetry observes; it never alters numerics, queue
   behavior, or scheduling.  The /healthz verdict comes from the watchdog
   registry's read-only probe — it cannot trip the one-dump-per-stall
   latch the poll thread owns.

Clock: ``obs.trace.monotonic_s`` (THE clock), so ages/uptimes are
comparable against span and heartbeat timestamps.

Exposition: the Prometheus text format (``text/plain; version=0.0.4``).
Windowed histograms are encoded as *summary* families (quantile series
from ``obs.events.latency_percentiles`` — one quantile implementation)
plus ``_count``/``_sum`` over the window; counters and gauges are the
plain families.  ``parse_exposition`` is the matching reader.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Callable, Iterable, Iterator, Mapping

from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import (
    device_memory_stats,
    latency_percentiles,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Module-level push gate: with telemetry off, every record site is ONE
# bool check (the trace-span discipline; tests pin this structurally).
_enabled = False


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn the push-path record sites on (``--obs-port`` / tests).  Pull
    collectors never need this — scraping is its own opt-in."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


# Histogram-summary key translation: latency_percentiles' dict keys →
# (snapshot suffix, Prometheus quantile label).
_PCT_KEYS = (("p50_ms", "p50", "0.5"), ("p90_ms", "p90", "0.9"),
             ("p99_ms", "p99", "0.99"))


def _labels_key(labels: Mapping[str, str] | None) -> tuple[tuple[str, str], ...]:
    if not labels:
        return ()
    for k in labels:
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name {k!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class Metric:
    """Base: one named family.  Subclasses implement ``samples()`` →
    ``[(labels_tuple, value)]`` evaluated at scrape time."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help

    def samples(self) -> list[tuple[tuple[tuple[str, str], ...], float]]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonic cumulative count; optionally labeled children.

    ``inc()`` is gated on the module enable bool, then one lock-guarded
    float add (the lock covers exactly that add — "lock-light").
    """

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._lock = make_lock("obs.telemetry.Counter._lock")
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if not _enabled:
            return
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_labels_key(labels), 0.0)

    def samples(self):
        with self._lock:
            return sorted(self._values.items())


class Gauge(Metric):
    """A sampled quantity: ``set()`` (push, enable-gated) or ``fn``
    (pull — evaluated only at scrape; zero hot-path cost)."""

    kind = "gauge"

    def __init__(
        self,
        name: str,
        help: str = "",
        fn: Callable[[], float] | None = None,
    ):
        super().__init__(name, help)
        self._lock = make_lock("obs.telemetry.Gauge._lock")
        self._values: dict[tuple[tuple[str, str], ...], float] = {}
        self._fn = fn

    def set(self, value: float, **labels: str) -> None:
        if not _enabled:
            return
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = float(value)

    def samples(self):
        if self._fn is not None:
            try:
                return [((), float(self._fn()))]
            except Exception:
                return []  # a dead callback must not kill the scrape
        with self._lock:
            return sorted(self._values.items())


class Histogram(Metric):
    """A windowed latency distribution, exposed as a Prometheus summary.

    Quantiles come from ``obs.events.latency_percentiles`` (THE p50/p99
    implementation) over either a push window (``observe()``, bounded,
    newest-wins) or a pull ``source`` callback returning the raw window
    in milliseconds (the serve frontend hands ``LatencyStats.window_ms``
    straight in — scrape-time pull, no new hot-path work).
    """

    kind = "summary"

    def __init__(
        self,
        name: str,
        help: str = "",
        window: int = 4096,
        source: Callable[[], Iterable[float]] | None = None,
    ):
        super().__init__(name, help)
        self._lock = make_lock("obs.telemetry.Histogram._lock")
        self._window = max(16, int(window))
        self._values: list[float] = []
        self._source = source

    def observe(self, value_ms: float) -> None:
        if not _enabled:
            return
        with self._lock:
            self._values.append(float(value_ms))
            if len(self._values) > self._window:
                del self._values[: -self._window]

    def window_ms(self) -> list[float]:
        if self._source is not None:
            try:
                return [float(v) for v in self._source()]
            except Exception:
                return []
        with self._lock:
            return list(self._values)

    def summary(self) -> dict[str, float]:
        """{count, p50, p90, p99, mean, max, sum} over the window
        (empty window → {}); the snapshot/exposition payload."""
        values = self.window_ms()
        pct = latency_percentiles(values)
        if not pct:
            return {}
        out = {"count": float(pct["count"]), "sum": round(sum(values), 3)}
        for src, dst, _q in _PCT_KEYS:
            out[dst] = pct[src]
        out["mean"] = pct["mean_ms"]
        out["max"] = pct["max_ms"]
        return out

    def samples(self):  # quantile series (exposition assembles the rest)
        out = []
        summary = self.summary()
        for _src, dst, q in _PCT_KEYS:
            if dst in summary:
                out.append(((("quantile", q),), summary[dst]))
        return out


#: One scrape-time sample from a collector callback:
#: (family name, kind, help, labels dict | None, value).
CollectorSample = tuple[str, str, str, Mapping[str, str] | None, float]


class Registry:
    """Named metrics + scrape-time collector callbacks.

    ``snapshot()`` (flat name→float dict, the SLO monitor's input) and
    ``prometheus_text()`` (the /metrics payload) are both views over the
    same ``collect()`` pass, so they can never disagree.
    """

    def __init__(self):
        self._lock = make_lock("obs.telemetry.Registry._lock")
        self._metrics: dict[str, Metric] = {}
        self._collectors: list[Callable[[], Iterable[CollectorSample]]] = []

    # ---- registration ----------------------------------------------------

    def register(self, metric: Metric) -> Metric:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric
        return metric

    def _get_or_create(self, cls, name: str, **kwargs) -> Metric:
        with self._lock:
            have = self._metrics.get(name)
            if have is not None:
                if type(have) is not cls:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(have).__name__}, not {cls.__name__}"
                    )
                return have
            m = self._metrics[name] = cls(name, **kwargs)
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help=help)

    def gauge(
        self, name: str, help: str = "",
        fn: Callable[[], float] | None = None,
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help=help, fn=fn)

    def histogram(
        self, name: str, help: str = "", window: int = 4096,
        source: Callable[[], Iterable[float]] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help=help, window=window, source=source
        )

    def register_collector(
        self, fn: Callable[[], Iterable[CollectorSample]]
    ) -> None:
        """A scrape-time callback yielding ``CollectorSample`` tuples —
        the pull idiom for dynamic label sets (per-component watchdog
        ages, per-device memory) where fixed metric objects don't fit."""
        with self._lock:
            self._collectors.append(fn)

    def unregister_collector(
        self, fn: Callable[[], Iterable[CollectorSample]]
    ) -> None:
        """Drop a registered collector (identity match).  A component
        with a shorter lifetime than the registry it reports into must
        detach on stop, or its gauges outlive it as frozen lies."""
        with self._lock:
            self._collectors = [c for c in self._collectors if c is not fn]

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    # ---- the one collect pass --------------------------------------------

    def collect(self) -> dict[str, dict]:
        """family name → {"kind", "help", "samples": [(labels, value)],
        "summary": {...} (histograms only)} — deterministically ordered."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        families: dict[str, dict] = {}
        for m in metrics:
            fam = families.setdefault(
                m.name, {"kind": m.kind, "help": m.help, "samples": []}
            )
            fam["samples"].extend(m.samples())
            if isinstance(m, Histogram):
                fam["summary"] = m.summary()
        for fn in collectors:
            try:
                samples = list(fn())
            except Exception:
                continue  # a dead collector must not kill the scrape
            for name, kind, help_text, labels, value in samples:
                fam = families.setdefault(
                    name, {"kind": kind, "help": help_text, "samples": []}
                )
                fam["samples"].append((_labels_key(labels), float(value)))
        for fam in families.values():
            fam["samples"].sort()
        return dict(sorted(families.items()))

    # ---- views -----------------------------------------------------------

    def snapshot(self) -> dict[str, float]:
        """Flat name → value (the SLO monitor's rule input).

        Labeled samples key as ``name{label="v",...}``; an aggregate
        lands under the bare name too (counters: sum; gauges: max — the
        alert-conservative fold for ages/depths) unless an unlabeled
        sample already owns it.  Histograms key their summary as
        ``name.count`` / ``name.p50`` / ``name.p99`` / ``name.mean`` /
        ``name.max``.
        """
        out: dict[str, float] = {}
        for name, fam in self.collect().items():
            if fam["kind"] == "summary":
                for k, v in fam.get("summary", {}).items():
                    if k != "sum":
                        out[f"{name}.{k}"] = v
                continue
            labeled = [(ls, v) for ls, v in fam["samples"] if ls]
            for ls, v in fam["samples"]:
                out[f"{name}{_fmt_labels(ls)}" if ls else name] = v
            if labeled and name not in out:
                vals = [v for _, v in labeled]
                out[name] = (
                    sum(vals) if fam["kind"] == "counter" else max(vals)
                )
        return out

    def prometheus_text(self) -> str:
        """The Prometheus text exposition (``text/plain; version=0.0.4``)."""
        lines: list[str] = []
        for name, fam in self.collect().items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for ls, v in fam["samples"]:
                lines.append(f"{name}{_fmt_labels(ls)} {_fmt_value(v)}")
            if fam["kind"] == "summary":
                s = fam.get("summary", {})
                lines.append(f"{name}_count {_fmt_value(s.get('count', 0))}")
                lines.append(f"{name}_sum {_fmt_value(s.get('sum', 0))}")
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?P<labels>\{.*\})?\s+"
    r"(?P<value>\S+)$"
)


def parse_exposition(text: str) -> tuple[dict[str, str], dict[str, float]]:
    """The matching reader for ``prometheus_text``: returns
    ``(types, samples)`` where ``types`` maps family name → TYPE and
    ``samples`` maps the raw sample key (``name`` or ``name{...}``) →
    float value.  Consumed by the bench consistency check and the
    telemetry smoke's schema check; unparseable lines are skipped (a
    schema check then fails on the MISSING family, loudly)."""
    types: dict[str, str] = {}
    samples: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        samples[m.group("name") + (m.group("labels") or "")] = value
    return types, samples


_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label_value(v: str) -> str:
    return re.sub(
        r"\\(.)", lambda m: "\n" if m.group(1) == "n" else m.group(1), v
    )


def parse_exposition_samples(
    text: str,
) -> tuple[dict[str, str], list[tuple[str, dict[str, str], float]]]:
    """The STRUCTURED reader for ``prometheus_text``: ``(types,
    samples)`` where each sample is ``(family name, labels dict, value)``
    with label values unescaped — the labels as data, not as the raw
    brace string ``parse_exposition`` keeps (a federating reader
    re-labels each scraped series before re-exposing it)."""
    types: dict[str, str] = {}
    samples: list[tuple[str, dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {
            k: _unescape_label_value(v)
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")
        }
        samples.append((m.group("name"), labels, value))
    return types, samples


# ---------------------------------------------------------------------------
# Built-in collectors
# ---------------------------------------------------------------------------


def watchdog_collector(
    wd: watchdog.Watchdog | None = None,
) -> Callable[[], Iterator[CollectorSample]]:
    """Per-component heartbeat ages + the stall verdict from the (default)
    watchdog registry — the health half of the per-replica read surface."""

    def collect() -> Iterator[CollectorSample]:
        w = wd or watchdog.default()
        comps = w.components()
        stalled = w.stalled_components()
        yield (
            "watchdog_components", "gauge",
            "components registered with the stall watchdog", None,
            float(len(comps)),
        )
        yield (
            "watchdog_stalled", "gauge",
            "non-idle components currently past their stall budget "
            "(healthz flips 503 when > 0)", None, float(len(stalled)),
        )
        for name, age in sorted(comps.items()):
            yield (
                "watchdog_beat_age_seconds", "gauge",
                "seconds since each component's last heartbeat",
                {"component": name}, round(age, 3),
            )

    return collect


def device_memory_collector() -> Iterator[CollectorSample]:
    """Per-device memory occupancy via the events helper (reports nothing
    on the CPU or before the program initialises CUDA)."""
    for name, value in device_memory_stats():
        dev, _, kind = name.partition(".")
        yield (
            "device_memory_bytes", "gauge",
            "per-device memory occupancy from memory_stats()",
            {"device": dev, "kind": kind}, value,
        )


_START_T = monotonic_s()


def _process_collector() -> Iterator[CollectorSample]:
    yield (
        "process_uptime_seconds", "gauge",
        "seconds since the telemetry module loaded (monotonic)",
        None, round(monotonic_s() - _START_T, 3),
    )


# ---------------------------------------------------------------------------
# Checkpoint health (utils/checkpoint.py)
# ---------------------------------------------------------------------------

# Push half: the checkpoint writer records each landed save (enable-gated,
# one bool while off).  Pull half: staleness is computed at scrape time,
# so a WEDGED saver — the failure this exists for — keeps degrading with
# no further events; the built-in staleness SLO rule
# (obs/slo.py::ckpt_staleness_rule) fires on the STEP-based
# ckpt_staleness gauge > 2, i.e. training advanced 2x the measured
# steps-between-saves with no checkpoint landing.  (The wall-clock
# age gauges stay informational: a multi-minute sync eval inflates
# them while no step runs.)
_ckpt_lock = make_lock("obs.telemetry._ckpt_lock")
_ckpt_state = {
    "last_success_t": None,   # monotonic_s of the last landed save
    "interval_s": None,       # gap between the last two landed saves
    "last_save_s": None,      # write duration of the last landed save
    "last_bytes": None,
    "last_step": None,        # step of the last landed save
    "interval_steps": None,   # steps between the last two landed saves
    "saves_total": 0,
    "inflight": 0,
}


def record_ckpt_save(step: int, save_s: float, total_bytes: int) -> None:
    """The checkpoint writer's landed-save record site.  One bool check
    while telemetry is off."""
    if not _enabled:
        return
    now = monotonic_s()
    with _ckpt_lock:
        prev = _ckpt_state["last_success_t"]
        if prev is not None:
            _ckpt_state["interval_s"] = now - prev
        prev_step = _ckpt_state["last_step"]
        if prev_step is not None and step > prev_step:
            _ckpt_state["interval_steps"] = int(step) - int(prev_step)
        _ckpt_state["last_success_t"] = now
        _ckpt_state["last_save_s"] = float(save_s)
        _ckpt_state["last_bytes"] = float(total_bytes)
        _ckpt_state["last_step"] = int(step)
        _ckpt_state["saves_total"] += 1


def record_ckpt_inflight(n: int) -> None:
    """Writer-queue occupancy (0/1 under the one-behind contract)."""
    if not _enabled:
        return
    with _ckpt_lock:
        _ckpt_state["inflight"] = int(n)


def _ckpt_collector() -> Iterator[CollectorSample]:
    with _ckpt_lock:
        s = dict(_ckpt_state)
    if not s["saves_total"] and not s["inflight"]:
        return  # no checkpointing in this process — no metric noise
    yield (
        "ckpt_saves_total", "counter",
        "checkpoints successfully committed by this process", None,
        float(s["saves_total"]),
    )
    yield (
        "ckpt_inflight", "gauge",
        "checkpoint writes currently in flight (0/1: one-behind)", None,
        float(s["inflight"]),
    )
    if s["last_save_s"] is not None:
        yield (
            "ckpt_save_s", "gauge",
            "write seconds of the last committed checkpoint", None,
            round(s["last_save_s"], 4),
        )
    if s["last_step"] is not None:
        yield (
            "ckpt_last_step", "gauge",
            "train step of the last committed checkpoint (what resume "
            "would restore — the actionable half of a staleness page)",
            None, float(s["last_step"]),
        )
    if s["last_bytes"] is not None:
        yield (
            "ckpt_bytes", "gauge",
            "payload bytes of the last committed checkpoint", None,
            s["last_bytes"],
        )
    if s["last_success_t"] is not None:
        age = monotonic_s() - s["last_success_t"]
        yield (
            "ckpt_last_success_age_s", "gauge",
            "seconds since the last successfully committed checkpoint "
            "(informational: grows through legitimate pauses — evals, "
            "compiles — too)", None, round(age, 3),
        )
        if s["interval_s"] is not None and s["interval_s"] > 0:
            yield (
                "ckpt_age_over_interval", "gauge",
                "ckpt_last_success_age_s / measured save interval "
                "(informational; a long sync eval inflates it — the "
                "staleness SLO watches ckpt_staleness instead)", None,
                round(age / s["interval_s"], 3),
            )
        # The SLO-grade signal: STEPS since the last save over the
        # measured steps-between-saves.  Steps don't advance during
        # evals/compiles, so a healthy pause can't inflate it — > 2
        # genuinely means the loop is training past the save cadence
        # without checkpoints landing (wedged/dying saver).
        step_now = _current_train_step()
        if (
            step_now is not None
            and s["interval_steps"]
            and s["interval_steps"] > 0
        ):
            yield (
                "ckpt_staleness", "gauge",
                "(train_step - ckpt_last_step) / measured save interval "
                "in steps (> 2 = saves stopped landing while training "
                "advances; the built-in staleness SLO rule fires on it)",
                None,
                round(
                    max(0.0, step_now - s["last_step"])
                    / s["interval_steps"],
                    3,
                ),
            )


def _current_train_step() -> float | None:
    """The train_step gauge's last pushed value, if the loop has
    recorded one (scrape-time read; no lock beyond the gauge's own)."""
    if _train_gauges is None:
        return None
    samples = _train_gauges["step"].samples()
    return float(samples[0][1]) if samples else None


# ---------------------------------------------------------------------------
# The process-default registry + the train-loop record sites
# ---------------------------------------------------------------------------

_default: Registry | None = None
_default_lock = make_lock("obs.telemetry._default_lock")


def default() -> Registry:
    """The process-wide registry (train status server / --obs-port),
    preloaded with the watchdog, device-memory, and process collectors."""
    global _default
    with _default_lock:
        if _default is None:
            r = Registry()
            r.register_collector(watchdog_collector())
            r.register_collector(device_memory_collector)
            r.register_collector(_process_collector)
            r.register_collector(_ckpt_collector)
            _default = r
        return _default


def reset() -> None:
    """Test hook: disable and drop the default registry + train/serve
    handles."""
    global _default, _train_gauges, _serve_metrics, _stream_metrics
    disable()
    with _default_lock:
        _default = None
    _train_gauges = None
    _serve_metrics = None
    _stream_metrics = None
    with _ckpt_lock:
        _ckpt_state.update(
            last_success_t=None, interval_s=None, last_save_s=None,
            last_bytes=None, last_step=None, interval_steps=None,
            saves_total=0, inflight=0,
        )


# Lazily-created train metric handles on the default registry (the loop's
# record sites must not pay registration on the disabled path).
_train_gauges: dict[str, Any] | None = None


def _train_handles() -> dict[str, Any]:
    global _train_gauges
    if _train_gauges is None:
        r = default()
        _train_gauges = {
            "step": r.gauge("train_step", "last completed train step"),
            "images_per_s": r.gauge(
                "train_images_per_sec", "window-averaged images/sec"
            ),
            "step_time_ms": r.gauge(
                "train_step_time_ms", "window-averaged wall ms per step"
            ),
            "data_wait_ms": r.gauge(
                "train_data_wait_ms",
                "window-averaged ms/step the host blocked on input",
            ),
            "data_wait_fraction": r.gauge(
                "train_data_wait_fraction",
                "data_wait_ms / step_time_ms over the last window",
            ),
            "compiles": r.counter(
                "train_compiles_total", "train-step compiles by bucket"
            ),
            "last_compile_s": r.gauge(
                "train_last_compile_s", "build seconds of the last compile"
            ),
            # Numerics plane (obs/numerics.py): the SLO monitor's
            # built-in nonfinite + grad-norm-spike rules evaluate these.
            "grad_norm": r.gauge(
                "train_grad_norm",
                "pre-clip global gradient norm at the last log window",
            ),
            "update_ratio": r.gauge(
                "train_update_ratio",
                "update-norm / param-norm at the last log window",
            ),
            "replica_agreement": r.gauge(
                "train_replica_agreement",
                "min/max ratio of per-replica local grad norms "
                "(1 = replicas agree; collapsing = silent desync)",
            ),
            "nonfinite": r.counter(
                "train_nonfinite_total",
                "non-finite gradient elements observed + tripped "
                "finite-checks (any increase is an incident)",
            ),
            # Gradient-compression health (comm/compress.py): the
            # always-armed ef_residual_spike SLO rule evaluates
            # train_ef_residual, its hop="dcn" form train_ef_residual_dcn.
            "ef_residual": r.gauge(
                "train_ef_residual",
                "global L2 norm of the gradient-compression error-"
                "feedback residual at the last log window",
            ),
            "ef_saturation": r.gauge(
                "train_ef_saturation",
                "fraction of quantized elements at the int8 clip "
                "boundary (per-block scale saturation)",
            ),
            "comm_bytes": r.counter(
                "train_comm_compressed_bytes_total",
                "cumulative compressed gradient bytes-on-wire "
                "(per-device ring estimate, comm/compress plan)",
            ),
            # Per hop of the hierarchical tree: within a slice (ICI, exact
            # f32) and across slices (DCN, the compressed exchange); the
            # help texts are the JAX package's, byte for byte.
            "comm_ici_bytes": r.counter(
                "train_comm_ici_bytes_total",
                "cumulative gradient bytes-on-wire over the fast "
                "intra-slice (ICI) hops of the hierarchical tree "
                "(exact f32 by construction)",
            ),
            "comm_dcn_bytes": r.counter(
                "train_comm_dcn_bytes_total",
                "cumulative gradient bytes-on-wire over the slow "
                "cross-slice (DCN) hop of the hierarchical tree "
                "(the compressed exchange)",
            ),
            "ef_residual_dcn": r.gauge(
                "train_ef_residual_dcn",
                "global L2 norm of the DCN-hop error-feedback "
                "residual (hierarchical tree; the only hop that "
                "quantizes)",
            ),
        }
    return _train_gauges


def record_train_window(
    step: int,
    images_per_s: float,
    step_time_ms: float,
    data_wait_ms: float,
) -> None:
    """The train loop's per-log-window record site (train/loop.py).  One
    bool check while telemetry is off."""
    if not _enabled:
        return
    g = _train_handles()
    g["step"].set(step)
    g["images_per_s"].set(images_per_s)
    g["step_time_ms"].set(step_time_ms)
    g["data_wait_ms"].set(data_wait_ms)
    g["data_wait_fraction"].set(
        data_wait_ms / step_time_ms if step_time_ms > 0 else 0.0
    )


def record_compile(bucket: str, build_s: float) -> None:
    """The train loop's compile-point record site.  One bool check off."""
    if not _enabled:
        return
    g = _train_handles()
    g["compiles"].inc(bucket=bucket)
    g["last_compile_s"].set(round(build_s, 3))


def record_comm(
    ef_residual: float | None = None,
    ef_saturation: float | None = None,
    compressed_bytes: float | None = None,
    ici_bytes: float | None = None,
    dcn_bytes: float | None = None,
    ef_residual_dcn: float | None = None,
    steps: int = 1,
) -> None:
    """The train loop's gradient-compression record site (per log window).
    One bool check while telemetry is off; absent fields (compression off,
    EF off, the flat tree) are skipped.  The byte figures are the plan's
    static per-step numbers: the counters add them once per step of the
    window's ``steps``.  ``ici_bytes``, ``dcn_bytes`` and
    ``ef_residual_dcn`` exist on the hierarchical tree only."""
    if not _enabled:
        return
    g = _train_handles()
    if ef_residual is not None and math.isfinite(ef_residual):
        g["ef_residual"].set(float(ef_residual))
    if ef_saturation is not None and math.isfinite(ef_saturation):
        g["ef_saturation"].set(float(ef_saturation))
    if compressed_bytes is not None and math.isfinite(compressed_bytes):
        g["comm_bytes"].inc(float(compressed_bytes) * max(1, int(steps)))
    if ici_bytes is not None and math.isfinite(ici_bytes):
        g["comm_ici_bytes"].inc(float(ici_bytes) * max(1, int(steps)))
    if dcn_bytes is not None and math.isfinite(dcn_bytes):
        g["comm_dcn_bytes"].inc(float(dcn_bytes) * max(1, int(steps)))
    if ef_residual_dcn is not None and math.isfinite(ef_residual_dcn):
        g["ef_residual_dcn"].set(float(ef_residual_dcn))


def record_numerics(
    grad_norm: float | None = None,
    update_ratio: float | None = None,
    nonfinite: float | None = None,
    replica_agreement: float | None = None,
) -> None:
    """The train loop's numerics record site (per log window — the
    ``train_step`` gauge from ``record_train_window`` at the same call
    site carries the step).  One bool check while telemetry is off;
    absent fields (summary disabled, a single-process run) are skipped."""
    if not _enabled:
        return
    g = _train_handles()
    if grad_norm is not None and math.isfinite(grad_norm):
        g["grad_norm"].set(float(grad_norm))
    if update_ratio is not None and math.isfinite(update_ratio):
        g["update_ratio"].set(float(update_ratio))
    if replica_agreement is not None and math.isfinite(replica_agreement):
        g["replica_agreement"].set(float(replica_agreement))
    if nonfinite is not None and (
        not math.isfinite(nonfinite) or nonfinite > 0
    ):
        # A non-finite COUNT that is itself non-finite means the summary
        # was poisoned — count it as one incident rather than losing it.
        g["nonfinite"].inc(
            float(nonfinite) if math.isfinite(nonfinite) else 1.0
        )


_serve_metrics: dict[str, Any] | None = None


def _serve_handles() -> dict[str, Any]:
    """Lazily-created serve batching handles on the default registry —
    like the train handles, registration is never paid on the disabled
    path."""
    global _serve_metrics
    if _serve_metrics is None:
        r = default()
        _serve_metrics = {
            "occupancy": r.histogram(
                "serve_batch_occupancy",
                "per-dispatched-batch device occupancy "
                "(live rows / padded batch size)",
            ),
            "free_slots": r.gauge(
                "serve_free_slots",
                "unclaimed slots across the assembling batches at the "
                "last dispatch (idle device capacity)",
            ),
            "slot_wait": r.histogram(
                "serve_slot_wait_ms",
                "ms a claimed slot waited between claim and seal "
                "(continuous in-flight batching admission latency)",
            ),
        }
    return _serve_metrics


def record_serve_batch(
    occupancy: float,
    free_slots: float,
    slot_wait_ms=(),
) -> None:
    """The serve frontend's per-dispatched-batch record site
    (serve/frontend.py ``_on_batch``).  One bool check while telemetry is
    off."""
    if not _enabled:
        return
    g = _serve_handles()
    if math.isfinite(occupancy):
        g["occupancy"].observe(float(occupancy))
    if math.isfinite(free_slots):
        g["free_slots"].set(float(free_slots))
    for w in slot_wait_ms:
        if math.isfinite(w):
            g["slot_wait"].observe(float(w))


_stream_metrics: dict[str, Any] | None = None


def _stream_handles() -> dict[str, Any]:
    """Lazily-created streaming-detection handles on the default registry
    (the ``_serve_handles`` pattern: registration is never paid on the
    disabled path)."""
    global _stream_metrics
    if _stream_metrics is None:
        r = default()
        _stream_metrics = {
            "hits": r.counter(
                "serve_stream_cache_hits_total",
                "frames short-circuited by the frame-delta cache",
            ),
            "misses": r.counter(
                "serve_stream_cache_misses_total",
                "frames dispatched to the device",
            ),
            "latency": r.histogram(
                "serve_stream_frame_latency_ms",
                "per-frame submit→deliver latency across all streams",
            ),
        }
    return _stream_metrics


def record_stream_frame(cache_hit: bool, latency_ms: float) -> None:
    """The stream delivery thread's per-frame record site
    (``serve/stream.py`` ``_finish``).  One bool check while telemetry is
    off."""
    if not _enabled:
        return
    g = _stream_handles()
    (g["hits"] if cache_hit else g["misses"]).inc()
    if math.isfinite(latency_ms):
        g["latency"].observe(float(latency_ms))


def record_nonfinite_trip(metric: str) -> None:
    """The loop's abort-path record site: a tripped finite-check counts
    into ``train_nonfinite_total`` (labeled by the tripped metric) so the
    built-in nonfinite SLO rule fires even when the in-step summary was
    off.  One bool check while telemetry is off."""
    if not _enabled:
        return
    _train_handles()["nonfinite"].inc(metric=metric)


# ---------------------------------------------------------------------------
# Health
# ---------------------------------------------------------------------------


def healthz(wd: watchdog.Watchdog | None = None) -> tuple[int, dict]:
    """(status_code, payload) for a truthful liveness endpoint: 200 while
    every non-idle watchdog component is within its stall budget, 503
    naming the most-stalled component otherwise.  Read-only — it never
    touches the watchdog's one-dump-per-stall latch."""
    w = wd or watchdog.default()
    stalled = w.stalled_components()
    components = {n: round(a, 3) for n, a in sorted(w.components().items())}
    if stalled:
        return 503, {
            "status": "stalled",
            "component": stalled[0]["component"],
            "stalled": stalled,
            "components": components,
        }
    return 200, {"status": "ok", "components": components}


# ---------------------------------------------------------------------------
# The stdlib HTTP status server (train --obs-port)
# ---------------------------------------------------------------------------


class StatusServer:
    """A drain-safe stdlib HTTP status server over one registry.

    GET /metrics  → Prometheus text exposition (the scrape target)
    GET /healthz  → watchdog-backed liveness (200 ok / 503 + component)
    GET /statusz  → the full JSON snapshot (humans and tools)

    Drain safety (the pod-exit contract): the listener thread is a
    daemon, per-request handler threads are daemons, ``close()`` bounds
    its join and is idempotent — a wedged scraper can never hold a pod
    exit hostage.  The listener registers with the stall watchdog and
    parks idle (liveness is witnessed per request), so watchdog-coverage
    passes non-vacuously without false stall dumps.
    """

    def __init__(
        self,
        registry: Registry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        wd: watchdog.Watchdog | None = None,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = registry if registry is not None else default()
        self.registry = registry
        self._wd = wd
        self._error: BaseException | None = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (stdlib casing)
                if self.path == "/metrics":
                    self._send(
                        200,
                        registry.prometheus_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/healthz":
                    code, payload = healthz(outer._wd)
                    self._send(
                        code, json.dumps(payload).encode(), "application/json"
                    )
                elif self.path in ("/statusz", "/vars"):
                    self._send(
                        200,
                        json.dumps(
                            registry.snapshot(), sort_keys=True
                        ).encode(),
                        "application/json",
                    )
                else:
                    self._send(
                        404, b'{"error": "not_found"}', "application/json"
                    )

            def log_message(self, *args) -> None:
                pass  # scrape traffic is not stdout's business

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True  # handlers can't block pod exit
        self._thread: threading.Thread | None = None
        self._hb: watchdog.Heartbeat | None = None
        self._closed = False

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    def _run(self) -> None:
        try:
            self._httpd.serve_forever(poll_interval=0.2)
        except BaseException as e:
            # Crash channel (thread-error-contract): a dead status server
            # must be visible — stored for close() to re-raise, announced
            # on stderr either way (nobody may ever call close()).
            self._error = e
            import sys

            print(
                json.dumps(
                    {"event": "telemetry_server_crashed", "error": repr(e)}
                ),
                file=sys.stderr, flush=True,
            )
            raise

    def start(self) -> "StatusServer":
        if self._thread is not None:
            return self
        # Registered but immediately idle: the listener legitimately
        # sleeps between scrapes; a wedged HTTP stack shows up as the
        # scraper's timeout, not as a false stall dump.
        self._hb = watchdog.register("obs-telemetry-http")
        self._hb.idle()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-telemetry-http"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        """Bounded, idempotent teardown.  A listener crash was already
        announced on stderr at crash time (the crash channel); close()
        re-announces as a warning rather than raising — telemetry is
        read-only, and a dead scrape endpoint must never turn a
        successful run into a failed pod exit."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            # shutdown() blocks on serve_forever()'s exit handshake —
            # calling it on a never-started server would wait forever.
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._hb is not None:
            self._hb.close()
            self._hb = None
        if self._error is not None:
            import warnings

            warnings.warn(
                f"telemetry status server crashed mid-run: {self._error!r}"
            )

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def start_http_server(
    registry: Registry | None = None,
    port: int = 0,
    host: str = "127.0.0.1",
) -> StatusServer:
    """Convenience bring-up: construct + start a ``StatusServer`` (the
    ``--obs-port`` path; port 0 binds an ephemeral port, read it back
    from ``.port``)."""
    return StatusServer(registry, host=host, port=port).start()
