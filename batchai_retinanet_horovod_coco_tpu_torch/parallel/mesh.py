"""The data world of one process per card: the JAX package's
``parallel/mesh.py`` along its 1-D ``data`` axis, where each process holds
one replica and the axis is the process group (``launch/pod.py::World``).

- :func:`world_devices` and :func:`rank_device`: the cards a run asks for
  (``--num-devices``, 0 = every card) and the one a rank takes,
  ``cuda:<local rank>``; asking for more cards than are visible raises, as
  the JAX package's mesh construction does;
- :func:`local_batch_size`: the global batch split over the ranks, which
  must divide it;
- :func:`replicate`: the train step's model replica, a
  ``DistributedDataParallel`` wrapper whose all-reduce of each gradient
  bucket overlaps the backward.  Its communication hook first adds the
  bucket's local sum of squares to a :class:`GradProbe` (the local
  gradient norm that ``obs/numerics.py::replica_agreement`` compares over
  the ranks), then runs the plain averaging all-reduce.  Buffers are not
  synchronised at each forward, as DDP does by default: each rank updates
  its BatchNorm statistics from its own images, and the step averages them
  after (:func:`average_over_ranks`), as the JAX step's ``pmean`` of the
  batch statistics;
- :func:`average_over_ranks`: one all-reduce for the step's loss metrics
  (the mean over ranks; ``num_pos``, a count, summed) and the BatchNorm
  running statistics (the mean).
"""

from __future__ import annotations

import inspect

import torch
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
from torch.nn.parallel import DistributedDataParallel

from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

#: The step's metrics that are averaged over the ranks; ``num_pos`` is summed.
MEAN_METRICS = ("loss", "cls_loss", "box_loss")
_STAT_NAMES = ("running_mean", "running_var")


def world_devices(num_devices: int, device: str | torch.device = "cuda") -> int:
    """The processes of a ``--num-devices`` run: ``num_devices``, or (0)
    every visible card; one on the CPU.  Raises when a card is asked for
    and none, or fewer than asked, are visible."""
    dev = torch.device(device)
    if num_devices < 0:
        raise ValueError(f"--num-devices {num_devices}: not a device count")
    if dev.type != "cuda":
        return num_devices or 1
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    wanted = num_devices or visible
    if visible == 0 or wanted > visible:
        raise RuntimeError(
            f"--num-devices {num_devices} asks for {wanted or 'every'} CUDA card(s); "
            f"{visible} visible"
        )
    return wanted


def rank_device(local_rank: int, device: str | torch.device = "cuda") -> torch.device:
    """The device of the rank with ``local_rank``: ``cuda:<local rank>``
    (raising when no such card is visible), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    visible = torch.cuda.device_count()
    if not 0 <= local_rank < visible:
        raise RuntimeError(f"local rank {local_rank} needs card cuda:{local_rank}; {visible} visible")
    return torch.device("cuda", local_rank)


def local_batch_size(batch_size: int, world_size: int) -> int:
    """Each rank's share of the global ``batch_size``."""
    if batch_size % world_size:
        raise ValueError(
            f"--batch-size {batch_size} is not divisible by the data world's {world_size} ranks"
        )
    return batch_size // world_size


class GradProbe:
    """The local sum of squares of the gradients of one backward, added up
    bucket by bucket before each bucket's all-reduce."""

    def __init__(self, device: torch.device):
        self.sum_sq = torch.zeros((), dtype=torch.float32, device=device)

    def reset(self) -> None:
        self.sum_sq.zero_()

    def local_norm(self) -> torch.Tensor:
        return self.sum_sq.sqrt()


def _probe_then_average(probe: GradProbe, bucket):  # DDP rejects a string annotation
    probe.sum_sq += bucket.buffer().float().square().sum()
    return default_hooks.allreduce_hook(None, bucket)


def replicate(model: torch.nn.Module, world) -> DistributedDataParallel:
    """``model``'s replica in ``world``, made on first use and kept in the
    world (one model at a time); its ``grad_probe`` is the
    :class:`GradProbe` its hook feeds."""
    slot = world.replica_slot
    if slot and slot[0].module is model:
        return slot[0]
    # torch >= 2.13 renamed broadcast_buffers; either way, no buffer sync at
    # each forward (the initial sync from rank 0 stays).
    params = inspect.signature(DistributedDataParallel).parameters
    sync_off = {"forward_sync_buffers" if "forward_sync_buffers" in params
                else "broadcast_buffers": False}
    replica = DistributedDataParallel(
        model, device_ids=[world.device.index] if world.device.type == "cuda" else None,
        **sync_off,
    )
    probe = GradProbe(world.device)
    replica.register_comm_hook(probe, _probe_then_average)
    replica.grad_probe = probe
    slot[:] = [replica]
    return replica


def batch_statistics(model: torch.nn.Module) -> list[torch.Tensor]:
    """The BatchNorm running statistics (the JAX state's ``batch_stats``)."""
    return [b for name, b in model.named_buffers() if name.rsplit(".", 1)[-1] in _STAT_NAMES]


def average_over_ranks(world, metrics: dict[str, torch.Tensor], stats: list[torch.Tensor]) -> None:
    """In place: :data:`MEAN_METRICS` and ``stats`` become their means over
    the ranks, ``num_pos`` its sum; one all-reduce."""
    local = torch.stack([metrics[k].detach().float() for k in MEAN_METRICS]
                        + [metrics["num_pos"].detach().float()])
    flat = torch.cat([local] + [s.detach().reshape(-1).float() for s in stats])
    world.all_reduce(flat)
    n = len(MEAN_METRICS)
    for i, k in enumerate(MEAN_METRICS):
        metrics[k] = flat[i] / world.size
    metrics["num_pos"] = flat[n]
    offset = n + 1
    with torch.no_grad():
        for s in stats:
            s.copy_((flat[offset : offset + s.numel()] / world.size).view_as(s))
            offset += s.numel()
