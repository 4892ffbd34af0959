"""The data world of one process per card: ``parallel/mesh.py``."""

from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import (
    average_over_ranks,
    local_batch_size,
    rank_device,
    replicate,
    world_devices,
)

__all__ = ["average_over_ranks", "local_batch_size", "rank_device", "replicate", "world_devices"]
