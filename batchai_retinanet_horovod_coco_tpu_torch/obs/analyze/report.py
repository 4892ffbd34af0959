"""The perf doctor: obs artifacts -> one machine-readable PERF_REPORT.json.

The port's copy of the JAX package's ``obs/analyze/report.py``, the read
side of the observability layer: a deterministic pure function from a
run's own artifacts (the merged Chrome trace, the events JSONL, the
watchdog markers, a NUMERICS_DUMP.json) to

- **a step-time decomposition**: data_wait / compile / step /
  metrics_fetch / eval fractions of the train-loop window, from the span
  vocabulary (the port's loop has no compile span: ``compile`` reads 0);
- **pipeline overlap efficiency** of the eval and serve drivers,
  ``1 - blocked_fetch_time / pipeline_wall`` over their dispatch/fetch
  span pairs;
- **queue-depth stall correlation**: the counter tracks against the
  ``data_wait`` spans (was the feed queue empty while the host waited?);
- **a memory trend** of every device ``bytes_in_use`` gauge;
- **an MFU estimate**: the step FLOPs the train loop records when it
  builds a step (``cost_analysis`` trace instants; the port counts them
  with ``torch.utils.flop_counter.FlopCounterMode`` over the first step of
  a shape, convolutions and matrix products forward and backward, and says
  so in ``flops_source``) against the card's peak TFLOP/s;
- **a ranked top-3 bottleneck verdict**, each naming the spans to read and
  the kernel problems (``nms``, ``focal``, ``matching``, ``batch``) that
  attack it;
- **a numerics section**: the grad-norm / update-ratio / replica-agreement
  series of the ``numerics`` JSONL records, the ``numerics_trip`` markers
  and the NUMERICS_DUMP.json cross-reference; any trip or non-finite count
  puts a ``numerics:divergence`` verdict at the head of the ranking;
- **an SLO violations section**: the ``slo_violation`` events of the live
  monitor (``obs/slo.py``) per rule, each a ``slo:<rule>`` verdict ahead
  of every inferred one.

The report's format is the JAX package's (``SCHEMA_VERSION`` 3, its section
and key names, the ranking, ``_TUNE_OPS``), so one report reads like the
other; the peak table holds NVIDIA cards only.

Determinism: the report is a pure function of the artifact files (the
peak-TFLOPs environment override excepted), floats rounded through one
helper, so the inline report the train command line writes at finalize
and the offline one (``python -m
batchai_retinanet_horovod_coco_tpu_torch.obs.analyze <obs_dir>``) are
byte-identical for the same directory.  It imports neither torch nor
numpy: it reads artifacts, never devices.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Any, Iterable

from batchai_retinanet_horovod_coco_tpu_torch.obs.events import (
    latency_percentiles,
    split_runs,
)

# v3: + the ``numerics`` section and its numerics:* verdicts; v2: + the
# ``violations`` section and its slo:* verdicts (the JAX package's schema).
SCHEMA_VERSION = 3

# Peak dense bf16 TFLOP/s per card, matched as a lower-case substring of
# ``torch.cuda.get_device_name`` (first match wins: PCIe before the SXM
# card's bare "h100").  NVIDIA H100 Tensor Core GPU data sheet: H100 SXM
# 989 TFLOP/s, H100 PCIe 756 TFLOP/s, BF16 Tensor Core without sparsity.
PEAK_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100", 989.0),
)

# Nominal per-host figure for CPU smokes: MFU against it is order-of-
# magnitude only (the report labels it ``peak_source: "nominal-cpu"``),
# but it keeps the roofline field populated end-to-end on dev boxes.
CPU_NOMINAL_PEAK_TFLOPS = 0.05

# The train loop's top-level span vocabulary (train/loop.py): these names
# partition the loop thread's wall clock, so their fractions + "other"
# sum to ~1 by construction.
_TRAIN_VOCAB = (
    "data_wait",
    "compile_train_step",
    "step",
    "metrics_fetch",
    "eval",
    "final_eval",
)

# Decomposition keys the report always carries (fixed set → stable schema).
_DECOMP_KEYS = ("data_wait", "compile", "step", "metrics_fetch", "eval", "other")

# Span families worth per-family latency stats when present (fixed list →
# deterministic report keys).
_SPAN_STAT_NAMES = (
    "data_wait",
    "step",
    "compile_train_step",
    "metrics_fetch",
    "eval",
    "final_eval",
    "async_eval",
    "detect_dispatch",
    "detect_fetch",
    "eval_convert",
    "eval_score",
    "eval_put_wait",
    "serve_dispatch",
    "serve_fetch",
    "serve_convert",
    "serve_preprocess",
    "pipe_decode_wait",
    "shm_head_wait",
    "shm_assemble",
    "decode",
    "device-prefetch",
    "eval-device-prefetch",
)

# The host-feed queue whose depth the stall correlation reads (the
# device-prefetch thread's counter, data/prefetch.py): data_wait with this
# at 0 is a STARVED pipeline (add workers); data_wait with depth > 0 is a
# transfer/dispatch hiccup.
_FEED_QUEUE = "device-prefetch.qsize"


class AnalyzeError(RuntimeError):
    """Artifact missing/unreadable in a way the caller should surface."""


def _r(x: float | None, nd: int = 6) -> float | None:
    return None if x is None else round(float(x), nd)


def device_peak_tflops(device_kind: str | None) -> tuple[float | None, str | None]:
    """(peak TFLOP/s, provenance) for a device kind.  Provenance is
    ``spec`` (public sheet), ``nominal-cpu`` (order-of-magnitude host
    figure), ``env`` (RETINANET_PEAK_TFLOPS override for kinds the table
    doesn't know), or None/None when unresolvable."""
    if not device_kind:
        return None, None
    kind = device_kind.lower()
    for sub, peak in PEAK_TFLOPS:
        if sub in kind:
            return peak, "spec"
    env = os.environ.get("RETINANET_PEAK_TFLOPS")
    if env:
        try:
            return float(env), "env"
        except ValueError:
            pass
    if "cpu" in kind:
        return CPU_NOMINAL_PEAK_TFLOPS, "nominal-cpu"
    return None, None


# ---------------------------------------------------------------------------
# Artifact loading
# ---------------------------------------------------------------------------


def load_trace(path: str) -> tuple[list[dict], dict]:
    """trace.json → (chrome events, health counters).  Raises AnalyzeError
    on a missing/unreadable file; a structurally odd but parseable file
    degrades to whatever events it carries."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise AnalyzeError(f"cannot read trace {path!r}: {e}") from e
    except ValueError as e:
        raise AnalyzeError(f"trace {path!r} is not valid JSON: {e}") from e
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise AnalyzeError(f"trace {path!r} has no traceEvents list")
    other = doc.get("otherData") or {}
    health = {
        "merged_partials": len(other.get("merged_from") or []),
        "skipped_trace_partials": len(other.get("skipped") or []),
    }
    return [e for e in events if isinstance(e, dict)], health


def _spans_by_name(events: Iterable[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for e in events:
        if e.get("ph") == "X":
            out.setdefault(e.get("name", "?"), []).append(e)
    return out


def _counters_by_name(events: Iterable[dict]) -> dict[str, list[tuple[float, float]]]:
    """counter name → [(t_s, value)] sorted by time."""
    out: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") == "C":
            try:
                v = float((e.get("args") or {})["value"])
            except (KeyError, TypeError, ValueError):
                continue
            out.setdefault(e.get("name", "?"), []).append((e["ts"] / 1e6, v))
    for series in out.values():
        series.sort()
    return out


def _instants(events: Iterable[dict], name: str) -> list[dict]:
    return [
        e for e in events if e.get("ph") == "i" and e.get("name") == name
    ]


def _dur_s(e: dict) -> float:
    return e.get("dur", 0) / 1e6


def _start_s(e: dict) -> float:
    return e["ts"] / 1e6


def _end_s(e: dict) -> float:
    return (e["ts"] + e.get("dur", 0)) / 1e6


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def _steps_section(spans: dict[str, list[dict]]) -> dict | None:
    """Step-time decomposition over the train-loop thread's window.

    The window is the extent of the loop's top-level spans on the track
    that carries the ``step`` spans; those spans never nest among
    themselves (train/loop.py), so their totals plus an explicit
    ``other`` remainder partition the window and the fractions sum to ~1.
    """
    steps = spans.get("step") or []
    if not steps:
        return None
    # The loop thread's track: where the step spans live (a merged trace
    # carries every process; per-(pid,tid) keying keeps e.g. an async-eval
    # thread's spans out of the loop's accounting).
    track_counts: dict[tuple, int] = {}
    for e in steps:
        track_counts[(e.get("pid"), e.get("tid"))] = (
            track_counts.get((e.get("pid"), e.get("tid")), 0) + 1
        )
    # Deterministic tie-break via str() — pid/tid may be absent in
    # hand-built traces and None does not order against ints.
    track = max(track_counts, key=lambda k: (track_counts[k], str(k)))

    def on_track(name: str) -> list[dict]:
        return [
            e
            for e in spans.get(name, [])
            if (e.get("pid"), e.get("tid")) == track
        ]

    vocab = {name: on_track(name) for name in _TRAIN_VOCAB}
    all_spans = [e for group in vocab.values() for e in group]
    window_start = min(_start_s(e) for e in all_spans)
    window_end = max(_end_s(e) for e in all_spans)
    window_s = max(window_end - window_start, 1e-9)

    totals = {name: sum(_dur_s(e) for e in group) for name, group in vocab.items()}
    eval_s = totals["eval"] + totals["final_eval"]
    attributed = {
        "data_wait": totals["data_wait"],
        "compile": totals["compile_train_step"],
        "step": totals["step"],
        "metrics_fetch": totals["metrics_fetch"],
        "eval": eval_s,
    }
    other = max(0.0, window_s - sum(attributed.values()))
    decomposition = {k: _r(v / window_s) for k, v in attributed.items()}
    decomposition["other"] = _r(other / window_s)

    step_track = vocab["step"]
    first_step = min(_start_s(e) for e in step_track)
    last_step = max(_end_s(e) for e in step_track)
    # Steady-state step cadence: everything between first and last step
    # minus the one-off gaps (compiles, in-loop evals) that are attributed
    # to their own verdicts.  MFU reads this, not the raw window.
    active_s = max(
        (last_step - first_step)
        - sum(
            _dur_s(e)
            for name in ("compile_train_step", "eval")
            for e in vocab[name]
            if _start_s(e) >= first_step and _end_s(e) <= last_step
        ),
        1e-9,
    )
    return {
        "count": len(step_track),
        "window_s": _r(window_s),
        "active_train_s": _r(active_s),
        "steps_per_s": _r(len(step_track) / active_s),
        "decomposition": decomposition,
        "fractions_sum": _r(sum(decomposition.values())),
        "totals_s": {k: _r(v, 4) for k, v in attributed.items()},
    }


def _span_stats(spans: dict[str, list[dict]]) -> dict:
    out = {}
    for name in _SPAN_STAT_NAMES:
        group = spans.get(name)
        if not group:
            continue
        stats = latency_percentiles([_dur_s(e) * 1e3 for e in group])
        stats["total_s"] = _r(sum(_dur_s(e) for e in group), 4)
        out[name] = stats
    return out


def _overlap_section(
    spans: dict[str, list[dict]],
    dispatch_name: str,
    fetch_name: str,
    convert_name: str | None,
) -> dict | None:
    """One-behind pipeline efficiency from a dispatch/fetch span pair.

    With perfect overlap the host's ``fetch`` (device_get) barely blocks:
    the device finished batch N−1 while the host dispatched/converted
    batch N.  With no overlap the host spends its whole non-dispatch time
    blocked in fetch.  ``overlap_efficiency = 1 − Σfetch / wall`` maps
    those extremes to ~1 and ~0 on the pipeline's own wall clock.
    """
    dispatch = spans.get(dispatch_name) or []
    fetch = spans.get(fetch_name) or []
    if not dispatch or not fetch:
        return None
    wall_start = min(_start_s(e) for e in dispatch + fetch)
    wall_end = max(_end_s(e) for e in dispatch + fetch)
    wall_s = max(wall_end - wall_start, 1e-9)
    dispatch_s = sum(_dur_s(e) for e in dispatch)
    fetch_s = sum(_dur_s(e) for e in fetch)
    out = {
        "batches": len(dispatch),
        "wall_s": _r(wall_s),
        "dispatch_s": _r(dispatch_s, 4),
        "fetch_blocked_s": _r(fetch_s, 4),
        "overlap_efficiency": _r(min(1.0, max(0.0, 1.0 - fetch_s / wall_s))),
    }
    if convert_name:
        convert = spans.get(convert_name) or []
        if convert:
            convert_s = sum(_dur_s(e) for e in convert)
            # Host conversion that ran while the driver stream was still
            # in flight (the consumer-thread overlap the pipelined eval
            # exists for).
            overlapped = sum(
                max(
                    0.0,
                    min(_end_s(e), wall_end) - max(_start_s(e), wall_start),
                )
                for e in convert
            )
            out["convert_s"] = _r(convert_s, 4)
            out["convert_overlap"] = _r(
                min(1.0, overlapped / max(convert_s, 1e-9))
            )
    return out


def _queue_section(
    counters: dict[str, list[tuple[float, float]]],
    data_wait_spans: list[dict],
) -> dict:
    out: dict[str, dict] = {}
    for name, series in sorted(counters.items()):
        if _is_memory_gauge(name):
            continue
        values = [v for _, v in series]
        out[name] = {
            "samples": len(values),
            "mean": _r(sum(values) / len(values), 3),
            "min": _r(min(values), 3),
            "max": _r(max(values), 3),
            "zero_fraction": _r(
                sum(1 for v in values if v == 0) / len(values)
            ),
        }
    feed = counters.get(_FEED_QUEUE)
    if feed and data_wait_spans:
        # Cross-reference: at each data_wait span's start, what depth did
        # the feed queue last report?  Time-weighted by span duration so
        # one long starvation outweighs many micro-waits.
        starved = 0.0
        total = 0.0
        times = [t for t, _ in feed]
        for e in data_wait_spans:
            t0 = _start_s(e)
            depth = None
            lo, hi = 0, len(times)
            while lo < hi:  # rightmost sample at/before t0
                mid = (lo + hi) // 2
                if times[mid] <= t0:
                    lo = mid + 1
                else:
                    hi = mid
            if lo > 0:
                depth = feed[lo - 1][1]
            total += _dur_s(e)
            if depth is not None and depth == 0:
                starved += _dur_s(e)
        if total > 0:
            out.setdefault(_FEED_QUEUE, {})["starved_data_wait_fraction"] = _r(
                starved / total
            )
    return out


def _is_memory_gauge(name: str) -> bool:
    return name.startswith("dev") and name.endswith(
        ("bytes_in_use", "peak_bytes_in_use")
    )


def _memory_section(counters: dict[str, list[tuple[float, float]]]) -> dict:
    gauges = {n: s for n, s in counters.items() if _is_memory_gauge(n)}
    if not gauges:
        return {"available": False}
    out: dict[str, Any] = {"available": True, "gauges": {}}
    for name, series in sorted(gauges.items()):
        (t0, v0), (t1, v1) = series[0], series[-1]
        g = {
            "samples": len(series),
            "first_bytes": _r(v0, 0),
            "last_bytes": _r(v1, 0),
            "peak_bytes": _r(max(v for _, v in series), 0),
        }
        if t1 > t0:
            g["trend_bytes_per_s"] = _r((v1 - v0) / (t1 - t0), 1)
        out["gauges"][name] = g
    return out


def _load_runs(
    events_path: str | None,
) -> tuple[list[dict] | None, str | None]:
    """ONE ``split_runs`` parse of metrics.jsonl, shared by the events,
    violations and numerics sections (a long run's JSONL is multi-MB —
    three per-section parses were pure waste).  Returns (runs, error)."""
    if not events_path or not os.path.exists(events_path):
        return None, None
    try:
        return split_runs(events_path), None
    except OSError as e:
        return None, repr(e)[:200]


def _events_section(
    runs: list[dict] | None, error: str | None = None
) -> dict:
    if error:
        return {"available": False, "error": error}
    if not runs:
        return {"available": False}
    run = runs[-1]  # the most recent run in an append-mode file
    header = run.get("header") or {}
    records = run.get("records") or []
    compiles = [r for r in records if r.get("event") == "compile"]
    stalls = [r for r in records if r.get("event") == "watchdog_stall"]
    dropped = sum(len(r.get("dropped_metrics") or []) for r in records)
    return {
        "available": True,
        "runs_in_file": len(runs),
        "corrupt_lines": sum(len(r.get("corrupt") or []) for r in runs),
        "header": {
            k: header.get(k)
            for k in (
                "run_id",
                "device_kind",
                "local_device_count",
                "process_count",
                "config_digest",
            )
        },
        "compile": {
            "count": len(compiles),
            "build_s_total": _r(
                sum(float(r.get("build_s") or 0.0) for r in compiles), 3
            ),
        },
        "watchdog_stalls": len(stalls),
        "dropped_metrics": dropped,
    }


def _mfu_section(
    events: list[dict], steps: dict | None, device_kind: str | None
) -> dict:
    cost = [
        e
        for e in _instants(events, "cost_analysis")
        if (e.get("args") or {}).get("target") == "train_step"
    ]
    flops_vals = [
        float((e.get("args") or {}).get("flops") or 0.0) for e in cost
    ]
    flops_vals = [v for v in flops_vals if v > 0]
    batches = [
        int((e.get("args") or {}).get("batch") or 0) for e in cost
    ]
    batches = [b for b in batches if b > 0]
    peak, peak_source = device_peak_tflops(device_kind)
    out: dict[str, Any] = {
        "flops_per_step": _r(
            sum(flops_vals) / len(flops_vals), 1
        )
        if flops_vals
        else None,
        # What the instants counted: their ``source`` (the port's loop
        # names torch's FLOP counter), else the JAX package's label.
        "flops_source": (
            str((cost[0].get("args") or {}).get("source") or "trace_cost_analysis")
            if flops_vals
            else None
        ),
        "steps_per_s": steps.get("steps_per_s") if steps else None,
        "images_per_s": None,
        "achieved_tflops": None,
        "peak_tflops": peak,
        "peak_source": peak_source,
        "mfu": None,
    }
    if flops_vals and steps and steps.get("steps_per_s"):
        achieved = (
            (sum(flops_vals) / len(flops_vals)) * steps["steps_per_s"] / 1e12
        )
        out["achieved_tflops"] = _r(achieved)
        if batches:
            out["images_per_s"] = _r(
                steps["steps_per_s"] * sum(batches) / len(batches), 3
            )
        if peak:
            out["mfu"] = _r(achieved / peak)
    if peak_source == "nominal-cpu":
        out["note"] = (
            "peak is a nominal CPU figure; mfu is order-of-magnitude only"
        )
    return out


def _violations_section(
    events: list[dict], runs: list[dict] | None
) -> dict:
    """The SLO read-back: ``slo_violation`` trace instants + JSONL events
    aggregated per rule.  The JSONL records are the richer source (they
    carry the description); the trace markers stand in when a run had no
    events half — per-rule aggregates prefer whichever source saw more
    of that rule (the monitor emits to both, so counts normally agree).
    """
    trace_v = [
        dict(e.get("args") or {}) for e in _instants(events, "slo_violation")
    ]
    jsonl_v: list[dict] = []
    if runs:
        jsonl_v = [
            r
            for r in runs[-1].get("records", [])
            if r.get("event") == "slo_violation"
        ]
    rules: dict[str, dict] = {}
    for source in (jsonl_v, trace_v):
        counts: dict[str, int] = {}
        for v in source:
            name = str(v.get("rule") or "?")
            counts[name] = counts.get(name, 0) + 1
            agg = rules.setdefault(
                name,
                {
                    "count": 0,
                    "metric": v.get("metric"),
                    "op": v.get("op"),
                    "max_sustained_s": 0.0,
                    "last_value": None,
                    "threshold": None,
                    "description": v.get("description"),
                },
            )
            agg["max_sustained_s"] = max(
                agg["max_sustained_s"], float(v.get("sustained_s") or 0.0)
            )
            agg["last_value"] = v.get("value")
            agg["threshold"] = v.get("threshold")
            if v.get("description"):
                agg["description"] = v.get("description")
        for name, n in counts.items():
            rules[name]["count"] = max(rules[name]["count"], n)
    out = {
        "trace_markers": len(trace_v),
        "jsonl_events": len(jsonl_v),
        "rules": {k: rules[k] for k in sorted(rules)},
    }
    # Self-healing resumes: an auto_resume is a survived
    # incident, not a violation, but it belongs in the same read-back —
    # a report whose run silently restarted mid-way must say so.  The
    # key is present only when such events exist, so healthy-run reports
    # (and the committed goldens) are byte-identical to schema v3.
    if runs:
        resumes = [
            r
            for r in runs[-1].get("records", [])
            if r.get("event") == "auto_resume"
        ]
        if resumes:
            out["auto_resumes"] = {
                "count": len(resumes),
                "restored_steps": [
                    r.get("restored_step") for r in resumes
                ],
                "excluded_ids": sorted(
                    {
                        int(i)
                        for r in resumes
                        for i in (r.get("exclude_ids") or [])
                    }
                ),
            }
    return out


def _series_stats(values: list[float]) -> dict | None:
    finite = [v for v in values if isinstance(v, (int, float))]
    if not finite:
        return None
    fin = [v for v in finite if math.isfinite(v)]
    out = {
        "samples": len(finite),
        "nonfinite_samples": len(finite) - len(fin),
        "last": _r(finite[-1]) if math.isfinite(finite[-1]) else None,
    }
    if fin:
        out["max"] = _r(max(fin))
        out["min"] = _r(min(fin))
        s = sorted(fin)
        mid = len(s) // 2
        out["median"] = _r(
            s[mid] if len(s) % 2 else (s[mid - 1] + s[mid]) / 2.0
        )
    return out


def _numerics_section(
    events: list[dict], runs: list[dict] | None, dump_path: str | None
) -> dict:
    """The numerics flight recorder's read-back: ``numerics``
    JSONL records (per-log-window grad/update health), ``numerics_trip``
    markers from BOTH the trace timeline and the JSONL, and the
    NUMERICS_DUMP.json the abort path landed (cross-referenced, never
    re-derived).  ``available`` is False only when no source exists at
    all — a run with the summary off but a tripped finite-check still
    gets its trip + dump surfaced."""
    def safe(v):
        # NaN/Inf values (a trip's whole point) must not leak bare NaN
        # tokens into the report JSON — stringify them.
        if isinstance(v, float) and not math.isfinite(v):
            return repr(v)
        return v

    records: list[dict] = []
    trips_jsonl: list[dict] = []
    metric_grad_norms: list[float] = []
    if runs:
        for r in runs[-1].get("records", []):
            if r.get("event") == "numerics":
                records.append(r)
            elif r.get("event") == "numerics_trip":
                trips_jsonl.append(r)
            elif "step" in r and "event" not in r:
                if isinstance(r.get("train/grad_norm"), (int, float)):
                    metric_grad_norms.append(r["train/grad_norm"])
    trips_trace = [
        dict(e.get("args") or {})
        for e in _instants(events, "numerics_trip")
    ]
    # The richer JSONL trips win; trace markers stand in for a run whose
    # events half is missing (the violations-section policy).
    trips = trips_jsonl or trips_trace
    dump = None
    if dump_path and os.path.exists(dump_path):
        try:
            with open(dump_path) as f:
                d = json.load(f)
            tripped = d.get("tripped")
            dump = {
                "present": True,
                "step": d.get("step"),
                "first_nonfinite": d.get("first_nonfinite"),
                "tripped": {k: safe(v) for k, v in tripped.items()}
                if isinstance(tripped, dict)
                else tripped,
            }
        except (OSError, ValueError) as e:
            dump = {"present": True, "error": repr(e)[:200]}
    grad_norms = [
        r["grad_norm"]
        for r in records
        if isinstance(r.get("grad_norm"), (int, float))
    ] or metric_grad_norms
    nonfinite_total = sum(
        float(r.get("nonfinite_grads") or 0.0)
        for r in records
        if isinstance(r.get("nonfinite_grads"), (int, float))
    )
    out: dict[str, Any] = {
        "available": bool(records or trips or dump or metric_grad_norms),
        "records": len(records),
        "grad_norm": _series_stats(grad_norms),
        "update_ratio": _series_stats(
            [
                r["update_ratio"]
                for r in records
                if isinstance(r.get("update_ratio"), (int, float))
            ]
        ),
        "replica_agreement": _series_stats(
            [
                r["replica_agreement"]
                for r in records
                if isinstance(r.get("replica_agreement"), (int, float))
            ]
        ),
        "nonfinite_total": _r(nonfinite_total, 1),
        "trips": {
            "count": max(len(trips_jsonl), len(trips_trace)),
            "trace_markers": len(trips_trace),
            "jsonl_events": len(trips_jsonl),
            "first": {
                k: safe(trips[0].get(k)) for k in ("metric", "step", "value")
            }
            if trips
            else None,
        },
        "dump": dump or {"present": False},
    }
    return out


def _stalls_section(events: list[dict], events_section: dict) -> dict:
    markers = _instants(events, "stall")
    components: dict[str, int] = {}
    for e in markers:
        c = str((e.get("args") or {}).get("component") or "?")
        components[c] = components.get(c, 0) + 1
    return {
        "trace_markers": len(markers),
        "jsonl_diagnoses": events_section.get("watchdog_stalls", 0)
        if events_section.get("available")
        else 0,
        "components": {k: components[k] for k in sorted(components)},
    }


# Bottleneck → the kernel problems that attack it, named as the JAX
# package's ``tune/`` registry names them (its ``tune --from-report`` reads
# them; the port's reports keep the names, so the two read alike).
_TUNE_OPS = {
    "device_step": ["focal", "matching", "nms"],
    "eval_pipeline": ["nms", "batch"],
    "eval_fetch_blocking": ["nms", "batch"],
    "serve_fetch_blocking": ["nms", "batch"],
    "host_input_pipeline": ["batch"],
}


def _slo_tune_ops(metric: str | None) -> list[str]:
    """Breached metric → the kernel problems that attack it, so an SLO
    verdict at rank 1 still names something to search (a stall/shed rule maps to nothing — those are capacity or
    wedge problems, not kernel-schedule problems)."""
    m = (metric or "").lower()
    if "latency" in m or "p99" in m or "p50" in m:
        return ["nms", "batch"]
    if "step_time" in m or "images_per_sec" in m:
        return ["focal", "matching", "nms"]
    if "data_wait" in m:
        return ["batch"]
    return []


def _bottlenecks(
    steps: dict | None,
    pipeline: dict,
    spans: dict[str, list[dict]],
    queues: dict,
    violations: dict | None = None,
    numerics: dict | None = None,
) -> list[dict]:
    """Ranked verdicts, scores all expressed as fractions of the main
    window so they are mutually comparable.  Non-empty whenever the trace
    carries any span at all (the generic fallback ranks raw span
    families when the train vocabulary is absent — serve traces).

    SLO violations outrank everything inferred: a breach of a DECLARED
    objective is evidence by fiat, so each violated rule contributes a
    ``slo:<rule>`` verdict at score 1.0 (inferred scores are window
    fractions ≤ 1) ON TOP of the top-3 inferred verdicts — the inferred
    ranking is never starved out of the report by a noisy SLO."""
    cands: list[dict] = []
    if steps is not None:
        d = steps["decomposition"]
        window_s = steps["window_s"]
        starved = (queues.get(_FEED_QUEUE) or {}).get(
            "starved_data_wait_fraction"
        )
        cands.append(
            {
                "name": "host_input_pipeline",
                "score": d["data_wait"],
                "spans": [
                    "data_wait",
                    "device-prefetch",
                    "pipe_decode_wait",
                    "shm_head_wait",
                    "decode",
                ],
                "evidence": (
                    f"host blocked on input {d['data_wait']:.1%} of the "
                    f"window"
                    + (
                        f"; feed queue empty for {starved:.1%} of that"
                        if starved is not None
                        else ""
                    )
                ),
                "suggestion": (
                    "raise --data-worker-procs/--workers (RUNBOOK 'Feeding "
                    "the chips'); starved feed queue = decode-bound host"
                ),
            }
        )
        cands.append(
            {
                "name": "compilation",
                "score": d["compile"],
                "spans": ["compile_train_step", "build_detect_fn"],
                "evidence": f"compiles took {d['compile']:.1%} of the window",
                "suggestion": (
                    "one-time cost on long runs; persistent compile cache / "
                    "AOT warmup if it dominates short ones"
                ),
            }
        )
        cands.append(
            {
                "name": "device_step",
                "score": d["step"],
                "spans": ["step"],
                "evidence": f"device step {d['step']:.1%} of the window",
                "suggestion": (
                    "the roofline lever: fused Pallas kernels for focal/"
                    "matching/NMS + a tune/ search on this device_kind"
                ),
            }
        )
        cands.append(
            {
                "name": "eval_pipeline",
                "score": d["eval"],
                "spans": ["eval", "final_eval", "detect_dispatch"],
                "evidence": f"in-loop eval {d['eval']:.1%} of the window",
                "suggestion": (
                    "--async-eval overlaps eval with the step stream; "
                    "tune/ batch axis raises detect throughput"
                ),
            }
        )
        cands.append(
            {
                "name": "logging_fetch",
                "score": d["metrics_fetch"],
                "spans": ["metrics_fetch"],
                "evidence": (
                    f"metric device_get {d['metrics_fetch']:.1%} of the "
                    "window"
                ),
                "suggestion": "raise --log-every",
            }
        )
    # Pipeline fetch-blocking verdicts exist with or WITHOUT a train loop
    # (an eval/serve trace has no `step` spans, but its fetch
    # blocking IS the detect-ceiling evidence tune/ exists to attack):
    # normalized by the loop window when one exists, else by the
    # pipeline's own wall.
    for key, name, span_list, suggestion in (
        (
            "eval",
            "eval_fetch_blocking",
            ["detect_fetch", "eval_put_wait"],
            "one-behind overlap is losing to device NMS time: tune/ nms "
            "+ per-bucket batch",
        ),
        (
            "serve",
            "serve_fetch_blocking",
            ["serve_fetch"],
            "tune/ nms + serve batch sizes",
        ),
    ):
        sec = pipeline.get(key)
        if sec is None:
            continue
        denom = (
            steps["window_s"] if steps is not None else sec["wall_s"]
        )
        if not denom:
            continue
        cands.append(
            {
                "name": name,
                "score": _r(min(1.0, sec["fetch_blocked_s"] / denom)),
                "spans": span_list,
                "evidence": (
                    f"{key} fetch blocked {sec['fetch_blocked_s']:.3f}s "
                    f"(overlap_efficiency "
                    f"{sec['overlap_efficiency']:.3f})"
                ),
                "suggestion": suggestion,
            }
        )
    if steps is None:
        # No train loop in this trace (serve artifacts): also
        # rank raw span families by their share of the span-covered
        # wall, skipping families a pipeline verdict already claims.
        claimed = {s for c in cands for s in c["spans"]}
        all_spans = [e for group in spans.values() for e in group]
        if all_spans:
            wall = max(_end_s(e) for e in all_spans) - min(
                _start_s(e) for e in all_spans
            )
            wall = max(wall, 1e-9)
            for name in sorted(spans):
                if name in claimed:
                    continue
                total = sum(_dur_s(e) for e in spans[name])
                cands.append(
                    {
                        "name": f"span:{name}",
                        "score": _r(min(1.0, total / wall)),
                        "spans": [name],
                        "evidence": f"{total:.3f}s across "
                        f"{len(spans[name])} spans",
                        "suggestion": "inspect this track in Perfetto",
                    }
                )
    cands = [c for c in cands if (c["score"] or 0) > 0]
    cands.sort(key=lambda c: (-c["score"], c["name"]))
    top = cands[:3]
    for c in top:
        c["tune_ops"] = _TUNE_OPS.get(c["name"], [])
    vio_cands: list[dict] = []
    for name, info in sorted(
        ((violations or {}).get("rules") or {}).items()
    ):
        vio_cands.append(
            {
                "name": f"slo:{name}",
                "score": 1.0,
                "spans": ["slo_violation"],
                "evidence": (
                    f"SLO {name!r} violated {info['count']}x "
                    f"({info.get('metric')} {info.get('op') or '>'} "
                    f"{info.get('threshold')}, last value "
                    f"{info.get('last_value')}, sustained "
                    f"{info.get('max_sustained_s')}s)"
                ),
                "suggestion": (
                    "a violated declared objective outranks inferred "
                    "bottlenecks: attack the breached metric first "
                    "(RUNBOOK 'Live telemetry')"
                ),
                "tune_ops": _slo_tune_ops(info.get("metric")),
            }
        )
    num_cands: list[dict] = []
    trips = ((numerics or {}).get("trips") or {}).get("count", 0)
    nonfinite = (numerics or {}).get("nonfinite_total") or 0
    if trips or nonfinite:
        # Numerical divergence outranks EVERYTHING — a run computing NaNs
        # has no performance question left to answer, so the verdict sits
        # above even declared-SLO breaches (which include the nonfinite
        # rule itself; acceptance pins rank 1 on the NaN smoke).
        first = ((numerics or {}).get("trips") or {}).get("first") or {}
        dump = (numerics or {}).get("dump") or {}
        located = (
            f"; first non-finite: {dump.get('first_nonfinite')}"
            if dump.get("first_nonfinite")
            else ""
        )
        num_cands.append(
            {
                "name": "numerics:divergence",
                "score": 1.0,
                "spans": ["numerics_trip"],
                "evidence": (
                    f"{int(trips)} tripped finite-check(s), "
                    f"{nonfinite:g} non-finite gradient element(s)"
                    + (
                        f" (tripped metric {first.get('metric')} at step "
                        f"{first.get('step')})"
                        if first.get("metric")
                        else ""
                    )
                    + located
                ),
                "suggestion": (
                    "read NUMERICS_DUMP.json (debug.py nans <dump>) for "
                    "the first non-finite layer/loss term — no "
                    "--debug-nans rerun needed (RUNBOOK 'Numerics "
                    "triage')"
                ),
                "tune_ops": [],
            }
        )
    top = num_cands + vio_cands + top
    for i, c in enumerate(top):
        c["rank"] = i + 1
    return top


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def analyze_events(
    events: list[dict],
    events_path: str | None = None,
    trace_health: dict | None = None,
    dump_path: str | None = None,
) -> dict:
    """Chrome events (+ optional events JSONL path + optional
    NUMERICS_DUMP.json path) → the report dict."""
    spans = _spans_by_name(events)
    counters = _counters_by_name(events)
    steps = _steps_section(spans)
    pipeline = {
        "eval": _overlap_section(
            spans, "detect_dispatch", "detect_fetch", "eval_convert"
        ),
        "serve": _overlap_section(
            spans, "serve_dispatch", "serve_fetch", "serve_convert"
        ),
    }
    queues = _queue_section(counters, spans.get("data_wait") or [])
    runs, runs_error = _load_runs(events_path)
    events_section = _events_section(runs, runs_error)
    violations = _violations_section(events, runs)
    numerics = _numerics_section(events, runs, dump_path)
    run_meta = _instants(events, "run_meta")
    meta_args = (run_meta[-1].get("args") or {}) if run_meta else {}
    device_kind = meta_args.get("device_kind") or (
        events_section.get("header", {}).get("device_kind")
        if events_section.get("available")
        else None
    )
    report = {
        "schema_version": SCHEMA_VERSION,
        "source": {
            "device_kind": device_kind,
            "local_device_count": meta_args.get("local_device_count"),
            "process_count": meta_args.get("process_count"),
            "events": bool(events_section.get("available")),
            "trace_events": len(events),
        },
        "steps": steps,
        "pipeline": pipeline,
        "queues": queues,
        "memory": _memory_section(counters),
        "mfu": _mfu_section(events, steps, device_kind),
        "stalls": _stalls_section(events, events_section),
        "violations": violations,
        "numerics": numerics,
        "events": events_section,
        "span_stats": _span_stats(spans),
        "bottlenecks": _bottlenecks(
            steps, pipeline, spans, queues, violations, numerics
        ),
        "health": dict(trace_health or {}),
    }
    return report


def _load_dir_inputs(
    obs_dir: str,
    trace_name: str,
    events_name: str | None,
    dump_name: str | None,
) -> tuple[list[dict], dict, str | None, str | None]:
    """The ONE obs-dir artifact resolver shared by ``analyze_dir`` and
    ``analyze_fleet_dir`` (a divergence here would silently fork plain
    and --fleet reports): (events, trace_health, events_path|None,
    dump_path|None), optional inputs resolved to None when absent."""
    events, health = load_trace(os.path.join(obs_dir, trace_name))
    events_path = (
        os.path.join(obs_dir, events_name) if events_name else None
    )
    if events_path and not os.path.exists(events_path):
        events_path = None
    dump_path = os.path.join(obs_dir, dump_name) if dump_name else None
    if dump_path and not os.path.exists(dump_path):
        dump_path = None
    return events, health, events_path, dump_path


def analyze_dir(
    obs_dir: str,
    trace_name: str = "trace.json",
    events_name: str | None = "metrics.jsonl",
    dump_name: str | None = "NUMERICS_DUMP.json",
) -> dict:
    """The offline entrypoint: an obs dir (as left by a --obs-trace run)
    → the report dict.  The trace is required; the events JSONL is
    enrichment (MFU falls back to trace instants, run metadata degrades
    to None).  ``events_name=None`` skips the JSONL entirely — for a
    trace written without events, where a shared obs dir
    may hold a PREVIOUS train run's metrics.jsonl whose header/compile
    records must not be attributed to this trace.  A NUMERICS_DUMP.json
    next to the trace (the loop's abort-path artifact) is
    cross-referenced into the numerics section when present."""
    events, health, events_path, dump_path = _load_dir_inputs(
        obs_dir, trace_name, events_name, dump_name
    )
    report = analyze_events(
        events,
        events_path=events_path,
        trace_health=health,
        dump_path=dump_path,
    )
    report["source"]["trace"] = trace_name
    return report


# ---------------------------------------------------------------------------
# Fleet mode: the merged multi-replica trace + federated metrics
# ---------------------------------------------------------------------------

# The fleet state transitions cross-referenced onto the report timeline —
# every one of these is emitted as BOTH a sink event and a trace instant
# carrying replica_id (serve/fleet.py), so the list is closed by design.
_FLEET_EVENT_NAMES = (
    "fleet_breaker_open",
    "fleet_breaker_half_open",
    "fleet_breaker_close",
    "fleet_redispatch",
    "canary_started",
    "canary_rollback",
    "canary_promoted",
    "fleet_replica_spawned",
    "fleet_replica_died",
    "fleet_replica_respawned",
    "fleet_respawn_failed",
    # The autoscaling control plane.
    "autoscaler_armed",
    "autoscale_decision",
    "autoscale_launch_failed",
    "respawn_budget_exhausted",
    "fleet_replica_joined",
    "fleet_replica_draining",
    "fleet_replica_removed",
)

# Serve stage-span families attributed per replica process track.
_FLEET_STAGE_NAMES = (
    "serve_preprocess",
    "serve_assemble",
    "serve_dispatch",
    "serve_fetch",
    "serve_convert",
)

_FLEET_TIMELINE_CAP = 500


def _process_labels(events: Iterable[dict]) -> dict[Any, str]:
    """pid → process label from the ``process_name`` metadata events
    (``p<idx>:<label> (pid N)`` as obs/trace.py writes them)."""
    out: dict[Any, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            label = str((e.get("args") or {}).get("name") or "")
            if " (pid " in label:
                label = label.split(" (pid ", 1)[0]
            if ":" in label:
                label = label.split(":", 1)[1]
            out[e.get("pid")] = label
    return out


def _fed_replica_metrics(metrics_doc: dict | None) -> dict[str, dict]:
    """FLEET_METRICS.json → per-replica {completed, shed, p99_ms} from
    the federated sample lists (serve/fleet.py ``dump_federated``)."""
    out: dict[str, dict] = {}
    for rid, rec in sorted(((metrics_doc or {}).get("replicas") or {}).items()):
        completed = shed = 0.0
        p99 = None
        for name, labels, value in rec.get("samples") or []:
            if name == "serve_requests_completed_total":
                completed += float(value)
            elif name == "serve_shed_total":
                shed += float(value)
            elif (
                name == "serve_request_latency_ms"
                and (labels or {}).get("quantile") == "0.99"
            ):
                p99 = float(value)
        out[rid] = {
            "completed": _r(completed, 1),
            "shed": _r(shed, 1),
            "p99_ms": _r(p99, 3),
        }
    return out


def _fleet_section(
    events: list[dict], metrics_doc: dict | None
) -> dict:
    """Per-replica decomposition + routing attribution + the fleet event
    timeline — the read-back of a multi-replica run."""
    spans = _spans_by_name(events)
    labels = _process_labels(events)
    reqs = spans.get("serve_request") or []

    by_replica: dict[str, list[dict]] = {}
    replica_pids: dict[str, set] = {}
    traces_by_replica: dict[str, set] = {}
    for e in reqs:
        args = e.get("args") or {}
        rid = str(
            args.get("replica") or labels.get(e.get("pid")) or "?"
        )
        by_replica.setdefault(rid, []).append(e)
        replica_pids.setdefault(rid, set()).add(e.get("pid"))
        if args.get("trace"):
            traces_by_replica.setdefault(rid, set()).add(
                str(args["trace"])
            )
    # A trace id whose spans landed on MORE THAN ONE replica is a
    # re-dispatched (or shed-then-retried) request — the cross-track
    # follow the tracing tentpole exists for.
    trace_owners: dict[str, set] = {}
    for rid, ids in traces_by_replica.items():
        for t in ids:
            trace_owners.setdefault(t, set()).add(rid)
    redispatched = sorted(
        t for t, owners in trace_owners.items() if len(owners) > 1
    )

    fed = _fed_replica_metrics(metrics_doc)
    busy = {
        rid: sum(_dur_s(e) for e in group)
        for rid, group in by_replica.items()
    }
    busy_total = sum(busy.values())
    # Stage spans carry no replica arg, only a pid: attribute a pid's
    # stage time to a replica ONLY when that pid hosts exactly one
    # replica (subprocess fleets).  An in-process LocalReplica fleet
    # shares one pid across replicas — crediting each with the shared
    # total would overcount N×, so those stages are skipped and flagged.
    pid_owners: dict[Any, set] = {}
    for rid, pids in replica_pids.items():
        for pid in pids:
            pid_owners.setdefault(pid, set()).add(rid)
    replicas: dict[str, dict] = {}
    for rid in sorted(set(by_replica) | set(fed)):
        group = by_replica.get(rid) or []
        entry: dict[str, Any] = {
            "requests": len(group),
            "busy_s": _r(busy.get(rid, 0.0), 4),
            # Time-weighted routing-share attribution: this replica's
            # share of all serve_request span time across the fleet.
            "routing_share": _r(
                busy.get(rid, 0.0) / busy_total if busy_total else 0.0
            ),
            "distinct_traces": len(traces_by_replica.get(rid) or ()),
        }
        if group:
            entry["latency"] = latency_percentiles(
                [_dur_s(e) * 1e3 for e in group]
            )
        all_pids = replica_pids.get(rid) or set()
        pids = {p for p in all_pids if len(pid_owners.get(p) or ()) == 1}
        if all_pids - pids:
            entry["stages_shared_process"] = True
        stages = {}
        for name in _FLEET_STAGE_NAMES:
            total = sum(
                _dur_s(e)
                for e in spans.get(name) or []
                if e.get("pid") in pids
            )
            if total:
                stages[name] = _r(total, 4)
        if stages:
            entry["stages_s"] = stages
        if rid in fed:
            entry["federated"] = fed[rid]
        replicas[rid] = entry

    timeline: list[dict] = []
    event_counts: dict[str, dict[str, int]] = {}
    for name in _FLEET_EVENT_NAMES:
        for e in _instants(events, name):
            args = e.get("args") or {}
            rid = str(args.get("replica_id") or "?")
            event_counts.setdefault(rid, {})
            event_counts[rid][name] = event_counts[rid].get(name, 0) + 1
            item = {"t_s": _r(_start_s(e), 3), "event": name}
            for k in (
                "replica_id", "reason", "trace", "rc", "rule",
                "decision", "delta",
            ):
                if args.get(k) is not None:
                    item[k] = args[k]
            timeline.append(item)
    timeline.sort(key=lambda x: (x["t_s"] or 0.0, x["event"]))
    truncated = max(0, len(timeline) - _FLEET_TIMELINE_CAP)
    return {
        "available": bool(reqs or timeline or fed),
        "replicas": replicas,
        "events_by_replica": {
            k: dict(sorted(v.items())) for k, v in sorted(event_counts.items())
        },
        "redispatched_traces": {
            "count": len(redispatched),
            "sample": redispatched[:10],
        },
        # The tail is what a post-mortem reads (the ring-buffer policy).
        "timeline": timeline[-_FLEET_TIMELINE_CAP:],
        "timeline_truncated": truncated,
    }


def _fleet_bottlenecks(fleet: dict) -> list[dict]:
    """Fleet verdicts, same shape as every other bottleneck entry so the
    schema-v3 machinery (the ranking, the checks) consumes
    them unchanged: the UNAVAILABLE replica first (a lost replica has no
    performance question left at fleet scope), then the most-shed and
    the slowest replica."""
    cands: list[dict] = []
    counts = fleet.get("events_by_replica") or {}
    death_score: dict[str, int] = {}
    for rid, evs in counts.items():
        if rid == "?":
            continue
        score = 2 * evs.get("fleet_replica_died", 0) + evs.get(
            "fleet_breaker_open", 0
        )
        if score:
            death_score[rid] = score
    if death_score:
        rid = max(sorted(death_score), key=lambda r: death_score[r])
        evs = counts[rid]
        cands.append(
            {
                "name": f"fleet:unavailable_replica:{rid}",
                "score": 1.0,
                "spans": ["fleet_breaker_open", "fleet_redispatch"],
                "evidence": (
                    f"replica {rid!r}: "
                    f"{evs.get('fleet_replica_died', 0)} death(s), "
                    f"{evs.get('fleet_breaker_open', 0)} breaker "
                    f"open(s), "
                    f"{evs.get('fleet_replica_respawned', 0)} respawn(s)"
                ),
                "suggestion": (
                    "follow this replica's track in the merged trace "
                    "around the breaker-open instants; the re-dispatch "
                    "markers carry the affected trace ids"
                ),
                "tune_ops": [],
            }
        )
    # Underprovisioned fleet: scale-up breaches the policy
    # could NOT act on because the fleet was already at max_replicas —
    # the capped autoscale_decision instants are the evidence trail.
    decisions = [
        it for it in fleet.get("timeline") or []
        if it.get("event") == "autoscale_decision"
    ]
    capped = [
        it for it in decisions if it.get("decision") == "scale_up_capped"
    ]
    if capped:
        ups = sum(
            1 for it in decisions if it.get("decision") == "scale_up"
        )
        reasons = sorted({str(it.get("reason")) for it in capped})
        cands.append(
            {
                "name": "fleet:underprovisioned",
                "score": _r(
                    min(1.0, len(capped) / max(1.0, len(capped) + ups))
                ),
                "spans": ["serve_request"],
                "evidence": (
                    f"{len(capped)} scale-up breach(es) "
                    f"({', '.join(reasons)}) blocked at max_replicas "
                    f"vs {ups} executed scale-up(s) — demand outgrew "
                    "the replica ceiling"
                ),
                "suggestion": (
                    "raise max_replicas (or per-replica slot capacity) "
                    "in the autoscale policy; each capped "
                    "autoscale_decision on the timeline carries the "
                    "breached signal values"
                ),
                "tune_ops": [],
            }
        )
    replicas = fleet.get("replicas") or {}
    sheds = {
        rid: float((r.get("federated") or {}).get("shed") or 0.0)
        for rid, r in replicas.items()
    }
    if any(sheds.values()):
        rid = max(sorted(sheds), key=lambda r: sheds[r])
        done = float(
            (replicas[rid].get("federated") or {}).get("completed") or 0.0
        )
        frac = sheds[rid] / max(1.0, sheds[rid] + done)
        cands.append(
            {
                "name": f"fleet:shed_replica:{rid}",
                "score": _r(min(1.0, frac)),
                "spans": ["serve_request"],
                "evidence": (
                    f"replica {rid!r} shed {sheds[rid]:g} requests "
                    f"({frac:.1%} of its traffic) — the fleet's worst"
                ),
                "suggestion": (
                    "raise this replica's queue bounds or lower its "
                    "routed share; a shedding replica under a healthy "
                    "fleet is a capacity mismatch, not a kernel problem"
                ),
                "tune_ops": [],
            }
        )
    p99s = {
        rid: float(
            (r.get("latency") or {}).get("p99_ms")
            or (r.get("federated") or {}).get("p99_ms")
            or 0.0
        )
        for rid, r in replicas.items()
    }
    p99s = {rid: v for rid, v in p99s.items() if v > 0}
    if len(p99s) > 1:
        rid = max(sorted(p99s), key=lambda r: p99s[r])
        rest = sorted(v for r, v in p99s.items() if r != rid)
        med = rest[len(rest) // 2]
        if med > 0 and p99s[rid] > med:
            cands.append(
                {
                    "name": f"fleet:slow_replica:{rid}",
                    "score": _r(
                        min(1.0, (p99s[rid] - med) / p99s[rid])
                    ),
                    "spans": ["serve_request", "serve_fetch"],
                    "evidence": (
                        f"replica {rid!r} p99 {p99s[rid]:.1f} ms vs "
                        f"{med:.1f} ms at the rest of the fleet"
                    ),
                    "suggestion": (
                        "compare this replica's serve stage spans "
                        "against a healthy track; tune/ nms + batch on "
                        "its device_kind if device-bound"
                    ),
                    "tune_ops": ["nms", "batch"],
                }
            )
    cands = [c for c in cands if (c["score"] or 0) > 0]
    cands.sort(key=lambda c: (-c["score"], c["name"]))
    return cands


def analyze_fleet_dir(
    obs_dir: str,
    trace_name: str = "trace.json",
    events_name: str | None = "metrics.jsonl",
    metrics_name: str | None = "FLEET_METRICS.json",
    dump_name: str | None = "NUMERICS_DUMP.json",
) -> dict:
    """``obs/analyze --fleet``: the standard report over the MERGED
    fleet trace, plus the ``fleet`` section (per-replica decomposition,
    time-weighted routing share, breaker/canary/re-dispatch timeline,
    federated metrics cross-reference) and fleet verdicts ranked into
    ``bottlenecks`` with the same schema-v3 machinery — below declared
    numerics/SLO breaches, above inferred single-process bottlenecks."""
    events, health, events_path, dump_path = _load_dir_inputs(
        obs_dir, trace_name, events_name, dump_name
    )
    report = analyze_events(
        events,
        events_path=events_path,
        trace_health=health,
        dump_path=dump_path,
    )
    metrics_doc = None
    metrics_path = (
        os.path.join(obs_dir, metrics_name) if metrics_name else None
    )
    if metrics_path and os.path.exists(metrics_path):
        try:
            with open(metrics_path) as f:
                metrics_doc = json.load(f)
        except (OSError, ValueError) as e:
            report["health"]["fleet_metrics_error"] = repr(e)[:200]
    fleet = _fleet_section(events, metrics_doc)
    report["fleet"] = fleet
    report["source"]["trace"] = trace_name
    report["source"]["fleet_metrics"] = bool(metrics_doc)
    def _is_head(b: dict) -> bool:
        return str(b.get("name", "")).startswith(("numerics:", "slo:"))

    heads = [b for b in report["bottlenecks"] if _is_head(b)]
    rest = [b for b in report["bottlenecks"] if not _is_head(b)]
    merged = heads + _fleet_bottlenecks(fleet) + rest
    for i, b in enumerate(merged):
        b["rank"] = i + 1
    report["bottlenecks"] = merged
    return report


def write_report(report: dict, path: str) -> str:
    """Serialize deterministically (sorted keys, trailing newline) so the
    inline and offline emitters produce byte-identical files."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_report(report: Any) -> list[str]:
    """Structural schema check → list of problems (empty = valid).  Used
    by the CLI, perf-report-check, and the fixture tests."""
    problems: list[str] = []
    if not isinstance(report, dict):
        return ["report is not an object"]
    if report.get("schema_version") != SCHEMA_VERSION:
        problems.append(
            f"schema_version {report.get('schema_version')!r} != "
            f"{SCHEMA_VERSION}"
        )
    for key in (
        "source",
        "steps",
        "pipeline",
        "queues",
        "memory",
        "mfu",
        "stalls",
        "violations",
        "numerics",
        "events",
        "span_stats",
        "bottlenecks",
        "health",
    ):
        if key not in report:
            problems.append(f"missing section {key!r}")
    violations = report.get("violations")
    if not isinstance(violations, dict) or not isinstance(
        violations.get("rules"), dict
    ):
        problems.append("violations section malformed (needs a rules map)")
    numerics = report.get("numerics")
    if not isinstance(numerics, dict) or "available" not in numerics or not (
        isinstance(numerics.get("trips"), dict)
    ):
        problems.append(
            "numerics section malformed (needs available + trips map)"
        )
    steps = report.get("steps")
    if isinstance(steps, dict):
        d = steps.get("decomposition")
        if not isinstance(d, dict) or set(d) != set(_DECOMP_KEYS):
            problems.append("steps.decomposition keys wrong")
        else:
            if any(
                not isinstance(v, (int, float)) or v < 0 or v > 1
                for v in d.values()
            ):
                problems.append("steps.decomposition fraction out of [0,1]")
            elif abs(sum(d.values()) - 1.0) > 0.02:
                problems.append(
                    f"steps.decomposition sums to {sum(d.values()):.4f}, "
                    "not ~1"
                )
    bn = report.get("bottlenecks")
    if not isinstance(bn, list):
        problems.append("bottlenecks is not a list")
    else:
        for i, b in enumerate(bn):
            if not isinstance(b, dict) or not {
                "rank",
                "name",
                "score",
                "spans",
            } <= set(b):
                problems.append(f"bottlenecks[{i}] malformed")
            elif b.get("rank") != i + 1:
                problems.append(f"bottlenecks[{i}] rank out of order")
    mfu = report.get("mfu")
    if isinstance(mfu, dict):
        missing = {"flops_per_step", "peak_tflops", "mfu"} - set(mfu)
        if missing:
            problems.append(f"mfu missing {sorted(missing)}")
    else:
        problems.append("mfu is not an object")
    return problems


def auto_emit(
    obs_dir: str,
    trace_name: str = "trace.json",
    out_name: str = "PERF_REPORT.json",
    sink: Any | None = None,
    events_name: str | None = "metrics.jsonl",
) -> str | None:
    """The finalize-path hook (the train command line): analyze + write the
    report next to the trace.  NEVER raises — a run that trained for
    hours must not die in its post-mortem; failure is ONE structured
    ``perf_report_error`` event (to ``sink`` when given, and stderr
    either way)."""
    try:
        report = analyze_dir(
            obs_dir, trace_name=trace_name, events_name=events_name
        )
        return write_report(report, os.path.join(obs_dir, out_name))
    except Exception as e:
        if sink is not None:
            try:
                sink.event(
                    "perf_report_error", obs_dir=obs_dir, error=repr(e)[:500]
                )
            except Exception:
                pass  # the stderr line below still lands
        print(
            json.dumps(
                {
                    "event": "perf_report_error",
                    "obs_dir": obs_dir,
                    "error": repr(e)[:500],
                }
            ),
            file=sys.stderr,
            flush=True,
        )
        return None
