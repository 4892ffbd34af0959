"""Runtime observability: trace spans, structured events, the stall
watchdog, live telemetry, SLO rules and the numerics recorder — the JAX
package's ``obs/`` for the port.

- ``obs.trace`` — low-overhead spans (ring-buffered per thread, Chrome
  ``trace_event`` JSON export, cross-process merge) and the subsystem's
  ONE clock (``monotonic_s``);
- ``obs.events`` — the structured JSONL sink (run headers, metrics,
  events, gauges, device memory) and ``emit_event``;
- ``obs.watchdog`` — the heartbeat registry every long-lived thread
  registers with, and the stall diagnoser;
- ``obs.telemetry`` — the live metrics registry, Prometheus exposition,
  the watchdog-backed ``healthz`` and the status server behind
  ``train --obs-port`` and the serve frontend's ``GET /metrics``;
- ``obs.slo`` — the SLO monitor over that registry;
- ``obs.numerics`` — the in-step gradient/update summary and the NaN
  provenance dump (imports torch, so it is loaded lazily).

``enable``/``finalize`` are the run-scoped bring-up/teardown the CLI
flags (``--obs-trace``/``--obs-dir``, utils/cli.py) call; everything in
between is always-on instrumentation that costs nothing while disabled.
"""

from __future__ import annotations

import os

from batchai_retinanet_horovod_coco_tpu_torch.obs import events, trace, watchdog

__all__ = [
    "trace", "watchdog", "events", "telemetry", "slo", "numerics",
    "enable", "finalize",
]


def __getattr__(name: str):
    # Lazy submodule access: ``obs.numerics`` imports torch, and the
    # telemetry plane is not needed by every importer.
    if name in ("telemetry", "slo", "numerics"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def enable(
    obs_dir: str,
    process_label: str = "main",
    stall_after: float = 120.0,
) -> str:
    """Run-scoped bring-up: enable tracing into ``obs_dir`` (published to
    spawned children via the env contract) and start the stall watchdog
    (stack dumps land in ``obs_dir/watchdog_stacks.txt``)."""
    os.makedirs(obs_dir, exist_ok=True)
    trace.configure(obs_dir, process_label=process_label)
    watchdog.start(
        stall_after=stall_after,
        dump_path=os.path.join(obs_dir, "watchdog_stacks.txt"),
    )
    return obs_dir


def finalize() -> str | None:
    """Run-scoped teardown: export this process's trace, stop the
    watchdog, merge every per-process trace file of this run into
    ``trace.json``.  Returns the merged path (None when tracing was never
    enabled); the train command line then writes the perf report next to
    it (``obs/analyze``'s ``auto_emit``)."""
    watchdog.stop()
    if not trace.enabled():
        return None
    trace.export()
    return trace.merge_traces()
