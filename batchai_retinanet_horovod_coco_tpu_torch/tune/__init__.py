"""The per-device schedule registry (``schedule``), the JAX package's
``tune/schedule.py`` for the port: one schema-validated JSON a device kind,
deep-merged over the built-in defaults, read by the detect path
(``pre_nms_size``) and recorded in the export manifest.  The measured
search that writes the files, and the kernels' launch-shape variants it
searches over, are still to port (``ROADMAP.md``)."""

from batchai_retinanet_horovod_coco_tpu_torch.tune.schedule import (
    DEFAULT_SCHEDULE,
    ScheduleError,
    device_slug,
    load_schedule,
    lookup,
    provenance,
    save_schedule,
    schedule_path,
    validate_schedule,
)

__all__ = [
    "DEFAULT_SCHEDULE",
    "ScheduleError",
    "device_slug",
    "load_schedule",
    "lookup",
    "provenance",
    "save_schedule",
    "schedule_path",
    "validate_schedule",
]
