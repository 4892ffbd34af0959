"""Unified structured-event sink: one JSONL stream for metrics AND events;
the JAX package's ``obs/events.py`` for the port.

- ``scalarize`` keeps non-finite values (a NaN loss is the single most
  important value a run ever logs: it is announced on stdout on top of
  the record; JSONL keeps it as a bare ``NaN`` token, which ``split_runs``
  reads back) and names the non-castable ones (``dropped_metrics``).
- Every sink opens with a ``run_header`` record (run id, wall time,
  device kind, process count/index, config digest, git rev), so a
  resumed or re-run directory splits back into its runs (``split_runs``).

Beyond ``log``, the sink carries ``event(kind, **fields)`` for structured
one-offs (watchdog stall diagnoses, auto-resumes, numerics records),
``gauge(name, value)`` for sampled quantities (mirrored into the trace as
Chrome counter tracks when tracing is on), ``histogram`` and
``log_device_memory`` (the CUDA caching allocator's occupancy).

Timestamps: ``wall_s`` is seconds since THIS sink opened, measured on
``obs.trace.monotonic_s`` — the same clock the trace spans use.

torch is never imported here: the device fields and memory stats are read
only when torch is already loaded AND CUDA already initialised, so a
header or a scrape never initialises the card on its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import uuid
from typing import Any, Mapping

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.obs import trace
from batchai_retinanet_horovod_coco_tpu_torch.utils.locks import make_lock


def scalarize(metrics: Mapping[str, Any]) -> tuple[dict[str, float], list[str]]:
    """metrics → (float scalars, names of non-castable drops).

    Non-finite values PASS THROUGH (the caller decides how loudly to
    announce them); only values ``float(np.asarray(v))`` cannot convert
    (arrays, strings, None) land in the drop list."""
    out: dict[str, float] = {}
    dropped: list[str] = []
    for k, v in metrics.items():
        try:
            out[k] = float(np.asarray(v))
        except (TypeError, ValueError):
            dropped.append(k)
    return out, dropped


def latency_percentiles(
    values_ms, ps: tuple[int, ...] = (50, 90, 99)
) -> dict[str, float]:
    """THE p50/p99 implementation: one summary shape shared by
    ``EventSink.histogram``, the serve ``LatencyStats`` snapshot and the
    telemetry histograms, so their quantile semantics (numpy linear
    interpolation) can never drift.  Empty input → ``{}`` (callers skip
    the record)."""
    arr = np.asarray(list(values_ms), dtype=np.float64)
    if arr.size == 0:
        return {}
    out: dict[str, float] = {"count": int(arr.size)}
    for p in ps:
        out[f"p{p}_ms"] = round(float(np.percentile(arr, p)), 3)
    out["mean_ms"] = round(float(arr.mean()), 3)
    out["max_ms"] = round(float(arr.max()), 3)
    return out


#: Serializes the parseable JSONL emit stream process-wide: concurrent
#: emitters must not interleave partial lines, because downstream
#: harnesses parse the stream as JSONL.
_EMIT_LOCK = make_lock("obs.events._EMIT_LOCK")


def emit_event(kind: str, *, sink=None, file=None, **fields) -> None:
    """THE structured-event emit layering: trace instant + guarded sink
    record + ONE serialized JSONL line on ``file`` (default stderr) per
    event.

    The output kwarg is named ``file`` (the ``print`` idiom) rather than
    ``stream`` because ``**fields`` must be able to hold a ``stream``
    field.

    The sink write is best-effort — a broken sink must not mask the
    parseable line.  The line is built outside the lock and written with
    a single ``write`` call under it."""
    trace.instant(kind, **fields)
    if sink is not None:
        try:
            sink.event(kind, **fields)
        except Exception:
            pass  # a broken sink must not mask the parseable line
    out = file if file is not None else sys.stderr
    line = json.dumps({"event": kind, **fields}) + "\n"
    with _EMIT_LOCK:
        out.write(line)
        out.flush()


def _git_rev() -> str | None:
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() or None if r.returncode == 0 else None


def config_digest(config: Mapping[str, Any] | None) -> str | None:
    """Stable short digest of a run's config (argparse namespace dict):
    two runs in one directory are the same experiment iff digests match."""
    if config is None:
        return None
    blob = json.dumps(
        {k: config[k] for k in sorted(config)}, default=str, sort_keys=True
    )
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _cuda():
    """``torch.cuda`` when torch is already imported and CUDA already
    initialised by the caller, else None: nothing here initialises it."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:
        return None
    return torch.cuda


def _device_header_fields() -> dict[str, Any]:
    """device_kind/process fields for the run header — ONLY when CUDA is
    already initialised (never force a device init from the logger).  One
    process drives the port's card: process index 0 of 1.  As a side
    effect, publishes the process index into the obs env contract, so
    children spawned later inherit it."""
    cuda = _cuda()
    if cuda is None:
        return {}
    try:
        fields = {
            "device_kind": cuda.get_device_name(cuda.current_device()),
            "local_device_count": cuda.device_count(),
            "process_index": 0,
            "process_count": 1,
        }
    except Exception:
        return {}
    os.environ[trace.OBS_PINDEX_ENV] = str(fields["process_index"])
    return fields


class EventSink:
    """The run's structured sink: JSONL + stdout (``log``, ``close``,
    ``event``, ``gauge``, ``histogram``, ``log_device_memory``); writes the
    ``run_header`` record on open.  TensorBoard is not ported (the CLI
    refuses ``--tensorboard``)."""

    def __init__(
        self,
        log_dir: str | None,
        stdout: bool = True,
        run_config: Mapping[str, Any] | None = None,
        filename: str = "metrics.jsonl",
    ):
        self._enabled = True
        self._stdout = stdout
        self._jsonl = None
        # Serializes JSONL appends: the loop thread logs metrics while the
        # watchdog thread may write a stall event — interleaved partial
        # lines would corrupt both records.
        self._write_lock = make_lock("obs.events.EventSink._write_lock")
        self._t0 = trace.monotonic_s()
        self.run_id = uuid.uuid4().hex[:8]
        self.dropped_metrics_total = 0
        if not self._enabled:
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, filename), "a")
            self._write(self._run_header(run_config))

    def _run_header(self, run_config) -> dict:
        rec = {
            "event": "run_header",
            "run_id": self.run_id,
            "t_wall": round(trace.to_wall(self._t0), 3),
            "argv": sys.argv,
            "config_digest": config_digest(run_config),
            "git_rev": _git_rev(),
        }
        rec.update(_device_header_fields())
        return rec

    def _write(self, rec: dict) -> None:
        with self._write_lock:
            if self._jsonl:
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()

    # ---- the MetricLogger surface ---------------------------------------

    def log(self, step: int, metrics: Mapping[str, Any], prefix: str = "train") -> None:
        if not self._enabled:
            return
        scalars, dropped = scalarize(metrics)
        nonfinite = {k: v for k, v in scalars.items() if not np.isfinite(v)}
        if self._jsonl:
            rec = {
                "step": step,
                "wall_s": round(trace.monotonic_s() - self._t0, 3),
            }
            rec.update({f"{prefix}/{k}": v for k, v in scalars.items()})
            if dropped:
                self.dropped_metrics_total += len(dropped)
                rec["dropped_metrics"] = sorted(dropped)
            self._write(rec)
        if self._stdout:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(scalars.items()))
            print(f"[{prefix} step {step}] {parts}", flush=True)
        if nonfinite:
            # The single most important value a run logs (a NaN loss) must
            # never be silent: one unmissable line per occurrence, on top
            # of the record above (the loop's sanitizer aborts separately).
            print(
                f"!! NON-FINITE metrics at {prefix} step {step}: "
                + ", ".join(f"{k}={v}" for k, v in sorted(nonfinite.items())),
                flush=True,
            )

    def close(self) -> None:
        with self._write_lock:  # a mid-write close must not race the file
            if self._jsonl:
                self._jsonl.close()
                self._jsonl = None

    # ---- the event/counter vocabulary -----------------------------------

    def event(self, kind: str, **fields: Any) -> None:
        """One structured record (compile events, watchdog diagnoses...):
        JSONL-only — events are machine food, not stdout chatter."""
        if not self._enabled or not self._jsonl:
            return
        rec = {
            "event": kind,
            "wall_s": round(trace.monotonic_s() - self._t0, 3),
        }
        rec.update(fields)
        self._write(rec)

    def gauge(self, name: str, value: float, step: int | None = None) -> None:
        """A sampled quantity (queue depth, occupancy): JSONL record plus a
        Chrome counter track when tracing is enabled."""
        trace.counter(name, value)
        if not self._enabled or not self._jsonl:
            return
        rec = {
            "event": "gauge",
            "wall_s": round(trace.monotonic_s() - self._t0, 3),
            "name": name,
            "value": float(value),
        }
        if step is not None:
            rec["step"] = step
        self._write(rec)

    def histogram(
        self, name: str, values_ms, step: int | None = None
    ) -> None:
        """One latency-distribution record: p50/p90/p99/mean/max over a
        window of millisecond samples (the serve frontend's per-window
        request latencies; any bounded sample list works).  Quantiles are
        computed here — the sink is the cold path — so callers just hand
        over the raw window; the math is ``latency_percentiles``, shared
        with the serve stats and the telemetry histograms."""
        if not self._enabled or not self._jsonl:
            return
        summary = latency_percentiles(values_ms)
        if not summary:
            return
        rec = {
            "event": "histogram",
            "wall_s": round(trace.monotonic_s() - self._t0, 3),
            "name": name,
        }
        rec.update(summary)
        if step is not None:
            rec["step"] = step
        self._write(rec)

    def log_device_memory(self, step: int | None = None) -> None:
        """Per-device memory occupancy (``device_memory_stats``; nothing
        on the CPU or before CUDA is initialised)."""
        for name, value in device_memory_stats():
            self.gauge(name, value, step=step)


def device_memory_stats() -> list[tuple[str, float]]:
    """[(gauge_name, bytes)] from each card's caching-allocator stats,
    under the JAX package's gauge names: ``allocated_bytes.all.current``
    as ``dev<i>.bytes_in_use`` and ``allocated_bytes.all.peak`` as
    ``dev<i>.peak_bytes_in_use``.  Empty on the CPU and when CUDA is not
    initialised (never initialises it)."""
    cuda = _cuda()
    if cuda is None:
        return []
    out: list[tuple[str, float]] = []
    try:
        for i in range(cuda.device_count()):
            stats = cuda.memory_stats(i)
            for src, key in (
                ("allocated_bytes.all.current", "bytes_in_use"),
                ("allocated_bytes.all.peak", "peak_bytes_in_use"),
            ):
                if src in stats:
                    out.append((f"dev{i}.{key}", float(stats[src])))
    except Exception:
        return []
    return out


def split_runs(path: str) -> list[dict]:
    """Read a (possibly multi-run, append-mode) metrics JSONL file back as
    ``[{"header": dict | None, "records": [dict, ...]}, ...]``.

    Runs are delimited by ``run_header`` records; lines before the first
    header (files of a writer without headers) form a leading run with
    ``header=None``.
    Bare ``NaN``/``Infinity`` tokens (the Python ``json`` writer's
    non-finite encoding) parse back as floats; unparseable lines are
    collected under ``"corrupt"`` rather than raising — a half-written
    tail must not make the whole history unreadable."""
    runs: list[dict] = []
    current: dict | None = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if current is None:
                    current = {"header": None, "records": [], "corrupt": []}
                    runs.append(current)
                current.setdefault("corrupt", []).append(line)
                continue
            if isinstance(rec, dict) and rec.get("event") == "run_header":
                current = {"header": rec, "records": []}
                runs.append(current)
                continue
            if current is None:
                current = {"header": None, "records": []}
                runs.append(current)
            current["records"].append(rec)
    return runs


def metric_records(run: dict) -> list[dict]:
    """A run's step-metric records only (drops gauges/events)."""
    return [r for r in run["records"] if "step" in r and "event" not in r]
