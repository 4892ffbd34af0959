"""The perf doctor: the obs layer's read side, the port's copy of the JAX
package's ``obs/analyze``.

``report`` turns a run's own artifacts (the merged ``trace.json``, the
events JSONL through ``split_runs``, the watchdog markers) into one
machine-readable ``PERF_REPORT.json``: the step-time decomposition,
pipeline overlap, queue and stall correlation, the memory trend, an MFU
estimate from the step FLOPs the train loop records, and a ranked top-3
bottleneck verdict naming the spans and kernel problems to attack next.

Two entry points:

- the train command line's finalize writes the report next to the trace
  (``auto_emit``, which never raises: a failure is one
  ``perf_report_error`` event);
- offline: ``python -m batchai_retinanet_horovod_coco_tpu_torch.obs.analyze
  <obs_dir>`` (byte-identical to the inline report for the same
  directory; ``--fleet`` for a fleet run's directory).

Neither imports torch: the analyzer reads artifacts, never devices.
"""

from batchai_retinanet_horovod_coco_tpu_torch.obs.analyze.report import (
    AnalyzeError,
    CPU_NOMINAL_PEAK_TFLOPS,
    PEAK_TFLOPS,
    SCHEMA_VERSION,
    analyze_dir,
    analyze_events,
    analyze_fleet_dir,
    auto_emit,
    device_peak_tflops,
    load_trace,
    validate_report,
    write_report,
)

__all__ = [
    "AnalyzeError",
    "CPU_NOMINAL_PEAK_TFLOPS",
    "PEAK_TFLOPS",
    "SCHEMA_VERSION",
    "analyze_dir",
    "analyze_events",
    "analyze_fleet_dir",
    "auto_emit",
    "device_peak_tflops",
    "load_trace",
    "validate_report",
    "write_report",
]
