"""The event vocabulary: every span, flow, structured-event, trace-instant
and telemetry-series NAME the port emits, with its consumers — the JAX
package's ``obs/vocabulary.py`` cut to the port's names.

Each name is spelled as the JAX package spells it: a name of the JAX
``VOCABULARY`` carries that entry's kinds here; the others (spans, the
request flow, the collector families, the ``numerics`` and
``chaos_nan_injected`` events) are names the JAX package emits beyond its
registry.  ``tests/test_torch_obs.py`` checks both directions: every name
the port's code emits is listed here, and every name listed here is
emitted by the port and by the JAX package.

Entry shape: ``"name": {"kinds": (...), "consumers": (...)}``

- ``kinds`` — any of ``"span"`` (trace.span / begin), ``"flow"``
  (trace.flow_*), ``"event"`` (EventSink.event / emit_event JSONL),
  ``"instant"`` (trace.instant), ``"series"`` (telemetry counter / gauge /
  histogram families and trace.counter samples).
- ``consumers`` — repo-relative paths of the files that READ the name
  (SLO rules, the chip smoke run); empty means "emitted for ad-hoc
  analysis".
"""

from __future__ import annotations

#: name -> {"kinds": tuple[str, ...], "consumers": tuple[str, ...]}
VOCABULARY: dict[str, dict] = {
    "async_eval": {
        "kinds": ("span",),
        "consumers": (),
    },
    "auto_resume": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "build_detect_fn": {
        "kinds": ("span",),
        "consumers": (),
    },
    "chaos_nan_injected": {
        "kinds": ("event",),
        "consumers": (),
    },
    "ckpt_age_over_interval": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_bytes": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_inflight": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_last_step": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_last_success_age_s": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_restore": {
        "kinds": ("span",),
        "consumers": (),
    },
    "ckpt_save_s": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_saves_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "ckpt_snapshot": {
        "kinds": ("span",),
        "consumers": (),
    },
    "ckpt_staleness": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "ckpt_write": {
        "kinds": ("span",),
        "consumers": (),
    },
    "data_wait": {
        "kinds": ("span",),
        "consumers": (),
    },
    "detect_dispatch": {
        "kinds": ("span",),
        "consumers": (),
    },
    "detect_fetch": {
        "kinds": ("span",),
        "consumers": (),
    },
    "device_memory_bytes": {
        "kinds": ("series",),
        "consumers": ("chip_smoke.py",),
    },
    "eval": {
        "kinds": ("span",),
        "consumers": (),
    },
    "eval_consumer.qsize": {
        "kinds": ("series",),
        "consumers": (),
    },
    "eval_convert": {
        "kinds": ("span",),
        "consumers": (),
    },
    "eval_put_wait": {
        "kinds": ("span",),
        "consumers": (),
    },
    "eval_score": {
        "kinds": ("span",),
        "consumers": (),
    },
    "final_eval": {
        "kinds": ("span",),
        "consumers": (),
    },
    "metrics_fetch": {
        "kinds": ("span",),
        "consumers": (),
    },
    "numerics": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "numerics_trip": {
        "kinds": ("instant",),
        "consumers": (),
    },
    "pipe_assemble": {
        "kinds": ("span",),
        "consumers": (),
    },
    "pipe_decode_wait": {
        "kinds": ("span",),
        "consumers": (),
    },
    "process_uptime_seconds": {
        "kinds": ("series",),
        "consumers": (),
    },
    "request": {
        "kinds": ("flow",),
        "consumers": (),
    },
    "serve.admission_qsize": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve.dispatch_qsize": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve.request_latency": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_assemble": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_batch_occupancy": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_batch_occupancy_last": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_batch_occupancy_mean": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_batches_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_convert": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_deadline_fires_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_dispatch": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_fetch": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_free_slots": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_inflight": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_preprocess": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_queue_capacity": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_queue_depth": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_ready_fires_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_request": {
        "kinds": ("span",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_request_latency_ms": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "serve_requests_completed_total": {
        "kinds": ("series",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_requests_failed_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_requests_timeout_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_shed_total": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "serve_slot_evictions_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_slot_wait_ms": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stats": {
        "kinds": ("event",),
        "consumers": (),
    },
    "serve_warmup": {
        "kinds": ("span",),
        "consumers": (),
    },
    "slo_violation": {
        "kinds": ("event", "instant"),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "slo_violations_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "stall": {
        "kinds": ("instant",),
        "consumers": (),
    },
    "step": {
        "kinds": ("span",),
        "consumers": (),
    },
    "train_compiles_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_data_wait_fraction": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_data_wait_ms": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_grad_norm": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "train_images_per_sec": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_last_compile_s": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_nonfinite_total": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "train_step": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_step_time_ms": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py", "chip_smoke.py"),
    },
    "train_update_ratio": {
        "kinds": ("series",),
        "consumers": (),
    },
    "watchdog_beat_age_seconds": {
        "kinds": ("series",),
        "consumers": (),
    },
    "watchdog_components": {
        "kinds": ("series",),
        "consumers": (),
    },
    "watchdog_stall": {
        "kinds": ("event",),
        "consumers": (),
    },
    "watchdog_stalled": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
}


def names() -> tuple[str, ...]:
    """Every registered name (sorted)."""
    return tuple(sorted(VOCABULARY))
