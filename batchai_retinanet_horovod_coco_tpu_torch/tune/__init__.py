"""The measured schedule search and the per-device schedule registry, the
JAX package's ``tune/`` for the port:

- ``schedule``: the registry, one schema-validated JSON a device kind,
  deep-merged over the built-in defaults; read by the train step (the
  matching and focal kernels' launch shapes), the detect path (the NMS
  kernel's launch shapes, ``pre_nms_size``) and recorded in the export
  manifest.  Import-light;
- ``candidates``: each kernel's launch-shape variants (the menus of
  ``ops/cuda/shapes.py``);
- ``search``: each candidate's kernel timed on the card in two windows of
  device time, the winners composed into a registry file;
- ``python -m batchai_retinanet_horovod_coco_tpu_torch.tune``: the command
  line (``__main__``).
"""

from batchai_retinanet_horovod_coco_tpu_torch.tune.schedule import (
    DEFAULT_SCHEDULE,
    MENUS,
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
    "MENUS",
    "ScheduleError",
    "device_slug",
    "load_schedule",
    "lookup",
    "provenance",
    "save_schedule",
    "schedule_path",
    "validate_schedule",
]
