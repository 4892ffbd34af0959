"""Joining a multi-process world: ``launch/pod.py``."""

from batchai_retinanet_horovod_coco_tpu_torch.launch.pod import (
    DistributedConfig,
    World,
    initialize_distributed,
    run_local_world,
    shard_info,
    shutdown_distributed,
)

__all__ = [
    "DistributedConfig",
    "World",
    "initialize_distributed",
    "run_local_world",
    "shard_info",
    "shutdown_distributed",
]
