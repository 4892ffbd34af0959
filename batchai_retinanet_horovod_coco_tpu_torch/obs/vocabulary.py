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
  (SLO rules, the autoscaler, the canary gate, the chip smoke run); empty
  means "emitted for ad-hoc analysis".
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
    "autoscale_decision": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "autoscale_launch_failed": {
        "kinds": ("event",),
        "consumers": (),
    },
    "autoscaler_armed": {
        "kinds": ("event",),
        "consumers": (),
    },
    "build_detect_fn": {
        "kinds": ("span",),
        "consumers": (),
    },
    "canary_promoted": {
        "kinds": ("event",),
        "consumers": (),
    },
    "canary_rollback": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "canary_started": {
        "kinds": ("event",),
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
    "cost_analysis": {
        "kinds": ("instant",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/analyze/report.py",),
    },
    "data_wait": {
        "kinds": ("span",),
        "consumers": (),
    },
    "decode": {
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
    "fleet_autoscale_draining": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_availability": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "fleet_breaker_close": {
        "kinds": ("event",),
        "consumers": (),
    },
    "fleet_breaker_half_open": {
        "kinds": ("event",),
        "consumers": (),
    },
    "fleet_breaker_open": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_breaker_open_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_breaker_state": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_canary_p99_ratio": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/fleet.py",),
    },
    "fleet_canary_rollback_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_canary_shed_total": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/fleet.py",),
    },
    "fleet_federated_p99_ms": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
    },
    "fleet_federated_shed_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_free_slots": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_inflight": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
    },
    "fleet_occupancy": {
        "kinds": ("series",),
        "consumers": (
            "batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",
            "batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",
        ),
    },
    "fleet_redispatch": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_redispatch_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_replica_died": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replica_draining": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replica_joined": {
        "kinds": ("event",),
        "consumers": (),
    },
    "fleet_replica_p99_ms": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
    },
    "fleet_replica_removed": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replica_respawned": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replica_spawned": {
        "kinds": ("event",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replica_weight": {
        "kinds": ("series",),
        "consumers": ("chip_smoke.py",),
    },
    "fleet_replicas_active": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_replicas_desired": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_replicas_routable": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_replicas_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_request": {
        "kinds": ("span",),
        "consumers": (),
    },
    "fleet_request_latency_ms": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_requests_completed_total": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
    },
    "fleet_requests_failed_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_requests_timeout_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_respawn_failed": {
        "kinds": ("event",),
        "consumers": (),
    },
    "fleet_scale_capped_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_scale_down_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_scale_up_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_shed_total": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
    },
    "fleet_stream_reaped": {
        "kinds": ("event",),
        "consumers": (),
    },
    "fleet_stream_repinned_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "fleet_streams_open": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/serve/autoscale.py",),
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
    "perf_report_error": {
        "kinds": ("event",),
        "consumers": (
            "batchai_retinanet_horovod_coco_tpu_torch/obs/analyze/report.py",
            "batchai_retinanet_horovod_coco_tpu_torch/train/__main__.py",
        ),
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
    "respawn_budget_exhausted": {
        "kinds": ("event",),
        "consumers": (),
    },
    "run_meta": {
        "kinds": ("instant",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/analyze/report.py",),
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
        "consumers": (
            "batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",
            "batchai_retinanet_horovod_coco_tpu_torch/serve/fleet.py",
        ),
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
        "consumers": (
            "batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",
            "batchai_retinanet_horovod_coco_tpu_torch/serve/fleet.py",
        ),
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
    "serve_stream_cache_bytes_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stream_cache_hits_total": {
        "kinds": ("series",),
        "consumers": ("chip_smoke.py",),
    },
    "serve_stream_cache_misses_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stream_frame_latency_ms": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stream_frames_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stream_reaped_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_stream_sessions": {
        "kinds": ("series",),
        "consumers": (),
    },
    "serve_warmup": {
        "kinds": ("span",),
        "consumers": (),
    },
    "shm.inflight_batches": {
        "kinds": ("series",),
        "consumers": (),
    },
    "shm.out_qsize": {
        "kinds": ("series",),
        "consumers": (),
    },
    "shm_assemble": {
        "kinds": ("span",),
        "consumers": (),
    },
    "shm_head_wait": {
        "kinds": ("span",),
        "consumers": (),
    },
    "shm_write": {
        "kinds": ("span",),
        "consumers": (),
    },
    "slo_violation": {
        "kinds": ("event", "instant"),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "slo_violations_total": {
        "kinds": ("series",),
        "consumers": ("chip_smoke.py",),
    },
    "stall": {
        "kinds": ("instant",),
        "consumers": (),
    },
    "step": {
        "kinds": ("span",),
        "consumers": (),
    },
    "stream_frame": {
        "kinds": ("span",),
        "consumers": (),
    },
    "stream_opened": {
        "kinds": ("instant",),
        "consumers": (),
    },
    "stream_repinned": {
        "kinds": ("event",),
        "consumers": (),
    },
    "stream_session": {
        "kinds": ("span",),
        "consumers": (),
    },
    "stream_session_reaped": {
        "kinds": ("instant",),
        "consumers": (),
    },
    "train_comm_compressed_bytes_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_comm_dcn_bytes_total": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_comm_ici_bytes_total": {
        "kinds": ("series",),
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
    "train_ef_residual": {
        "kinds": ("series",),
        "consumers": ("batchai_retinanet_horovod_coco_tpu_torch/obs/slo.py",),
    },
    "train_ef_residual_dcn": {
        "kinds": ("series",),
        "consumers": (),
    },
    "train_ef_saturation": {
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
    "train_replica_agreement": {
        "kinds": ("series",),
        "consumers": (),
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
