"""The gradient-communication subsystem, as the JAX package's ``comm/``:
how gradients (and ZeRO's weight updates) cross between the ranks.

- ``config.CommConfig``: the policy (compress mode, error feedback,
  overlap, bucket sizes, per-stage and per-hop modes);
- ``compress``: the plan and its bytes on the wire, the EF state, the
  bucketed int8/bf16 collectives (``reduce_tree`` for data parallelism,
  ``zero_gather_updates`` for ZeRO, the hierarchical tree) and the health
  metrics;
- ``overlap``: each schedule stage's collective issued inside the backward.

Consumers: ``train/step.py``, ``train/state.py``, ``utils/cli.py`` and the
command line, ``utils/checkpoint.py`` (the EF state), ``obs/`` (the EF
gauges and the ``ef_residual_spike`` SLO rule).
"""

from batchai_retinanet_horovod_coco_tpu_torch.comm.compress import (
    CommPlan,
    Hierarchy,
    bucket_state_key,
    bucketed_pmean,
    comm_metrics,
    init_comm_state,
    plan_buckets,
    reduce_bucket_hierarchical,
    reduce_tree,
    zero_gather_updates,
)
from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig, STAGES, stage_of

__all__ = [
    "STAGES",
    "CommConfig",
    "CommPlan",
    "Hierarchy",
    "bucket_state_key",
    "bucketed_pmean",
    "comm_metrics",
    "init_comm_state",
    "plan_buckets",
    "reduce_bucket_hierarchical",
    "reduce_tree",
    "stage_of",
    "zero_gather_updates",
]
