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
  running statistics (the mean);
- :class:`DataAxis`: the ``data`` axis of a world or of one of its
  subgroups, and the collectives of the gradient-communication paths
  (``comm/``, ``parallel/zero.py``) over it: ``psum``, ``pmean``,
  ``psum_scatter`` (tiled) and ``all_gather``, as the JAX package's named-
  axis collectives.  They go through the world's communication device:
  with gloo a card's tensor is copied to the host around the collective
  and back (gloo's reduce-scatter and all-gather take host tensors), with
  NCCL it stays on the card;
- :class:`CommTopology`, :func:`derive_topology` and :func:`hop_axes`: the
  two-level grouping of the hierarchical tree.  A slice is a host (the
  JAX package's TPU slice): torchrun numbers ranks host-major, ``rank =
  node * L + local``, and ``LOCAL_WORLD_SIZE`` gives L; ``--comm-slices``
  and ``RETINANET_COMM_SLICES`` override it, so one host can stand for
  several.  The mesh position of a rank is ``local * S + node`` (the JAX
  package's interleaved convention: position ``d`` in slice ``d % S``),
  the chunk of every flat it owns;
- :func:`space_axis`: the (data, space) grid of spatial partitioning, the
  JAX package's ``make_mesh_2d`` with the space axis minor: rank ``r =
  d * S + s`` is data index d and space index s.  Its groups (the space
  groups and the data groups) are made on every rank in the same order,
  and a space group must not span hosts
  (:func:`assert_space_rows_single_host`, the JAX package's
  ``_assert_space_rows_single_process``).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from collections.abc import Mapping

import torch
import torch.distributed as dist
from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
from torch.nn.parallel import DistributedDataParallel

from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

#: The step's metrics that are averaged over the ranks; ``num_pos`` is summed.
MEAN_METRICS = ("loss", "cls_loss", "box_loss")
_STAT_NAMES = ("running_mean", "running_var")


def visible_devices(device: str | torch.device = "cuda") -> int:
    """The cards ``--num-devices 0`` would take (0 without any), one on the
    CPU; never raises."""
    if torch.device(device).type != "cuda":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


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


def copy_from_rank0(model: torch.nn.Module, world) -> None:
    """Give every rank rank 0's parameters and buffers (what DDP does at
    construction)."""
    with torch.no_grad():
        for tensor in list(model.parameters()) + list(model.buffers()):
            tensor.copy_(world.broadcast(tensor))


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


class DataAxis:
    """The ``data`` axis of ``world`` (``group`` None) or of one of its
    subgroups: ``size`` ranks, this rank at ``index`` along it.  The
    collectives return new tensors on the device of their input."""

    def __init__(self, world, group=None, size: int | None = None, index: int | None = None):
        self.world = world
        self.group = group
        self.size = world.size if size is None else size
        self.index = world.rank if index is None else index

    def _staged(self, tensor: torch.Tensor) -> torch.Tensor:
        staged = tensor.to(self.world.comm_device).contiguous()
        return staged.clone() if staged is tensor else staged

    def psum(self, tensor: torch.Tensor) -> torch.Tensor:
        """The sum over the axis (``lax.psum``)."""
        staged = self._staged(tensor)
        dist.all_reduce(staged, group=self.group)
        return staged.to(tensor.device)

    def pmean(self, tensor: torch.Tensor) -> torch.Tensor:
        """The mean over the axis (``lax.pmean``: the sum, then / size)."""
        return self.psum(tensor) / self.size

    def psum_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This index's chunk of the sum of a ``(size * chunk,)`` flat
        (``lax.psum_scatter(..., tiled=True)``)."""
        staged = self._staged(flat)
        chunk = staged.numel() // self.size
        if chunk * self.size != staged.numel():
            raise ValueError(f"a flat of {staged.numel()} does not tile over {self.size} ranks")
        out = torch.empty(chunk, dtype=staged.dtype, device=staged.device)
        dist.reduce_scatter(out, list(staged.split(chunk)), group=self.group)
        return out.to(flat.device)

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every index's ``tensor``, stacked in index order:
        ``(size, *tensor.shape)`` (``lax.all_gather``)."""
        staged = self._staged(tensor)
        out = [torch.empty_like(staged) for _ in range(self.size)]
        dist.all_gather(out, staged, group=self.group)
        return torch.stack(out).to(tensor.device)


#: Overrides the slice count, as ``--comm-slices`` does: one host can stand
#: for several slices (e.g. a world of 4 as 2 slices x 2).
COMM_SLICES_ENV = "RETINANET_COMM_SLICES"


@dataclasses.dataclass(frozen=True)
class CommTopology:
    """Two-level grouping for the hierarchical collectives, as the JAX
    package's: ``num_slices`` (S) slices of ``slice_size`` (L) ranks.

    Mesh positions are interleaved: position ``d`` belongs to slice
    ``d % S`` at intra-slice rank ``d // S``.  After the tree's two
    reduce-scatters (within the slice by intra-slice rank, then across
    slices by slice) position ``d`` owns chunk ``d`` of each bucket, so the
    per-hop residuals, laid out in position order, stay in global bucket
    order with zero padding, which ``parallel/zero.py::reshard_flat_leaf``
    needs to move a checkpoint between world sizes.
    """

    num_slices: int
    slice_size: int

    def __post_init__(self):
        if self.num_slices < 1 or self.slice_size < 1:
            raise ValueError(
                f"CommTopology needs num_slices >= 1 and slice_size >= 1, "
                f"got {self.num_slices} x {self.slice_size}"
            )

    @property
    def num_devices(self) -> int:
        return self.num_slices * self.slice_size

    def ici_groups(self) -> list:
        """Mesh positions grouped by slice, in intra-slice rank order."""
        S, L = self.num_slices, self.slice_size
        return [[r * S + s for r in range(L)] for s in range(S)]

    def dcn_groups(self) -> list:
        """Mesh positions grouped by intra-slice rank, in slice order."""
        S, L = self.num_slices, self.slice_size
        return [[r * S + s for s in range(S)] for r in range(L)]

    def position(self, rank: int) -> int:
        """The mesh position of the rank ``rank = node * L + local``:
        ``local * S + node``."""
        node, local = divmod(rank, self.slice_size)
        return local * self.num_slices + node

    def rank_at(self, position: int) -> int:
        """The rank at mesh ``position`` (the inverse of :meth:`position`)."""
        local, node = divmod(position, self.num_slices)
        return node * self.slice_size + local


def derive_topology(
    num_devices: int, num_slices: int | None = None,
    environ: Mapping[str, str] | None = None,
) -> CommTopology | None:
    """The CommTopology of a world of ``num_devices`` ranks, or None (flat).

    The slice count, first found first: ``num_slices`` (``--comm-slices``),
    ``RETINANET_COMM_SLICES``, then the hosts: torchrun's
    ``LOCAL_WORLD_SIZE`` ranks a host, where the world spans more than one
    host.  A world started without torchrun (``--num-devices N`` on one
    host) is flat unless overridden."""
    env = os.environ if environ is None else environ
    if num_slices is None:
        raw = env.get(COMM_SLICES_ENV, "").strip()
        if raw:
            try:
                num_slices = int(raw)
            except ValueError:
                raise ValueError(
                    f"{COMM_SLICES_ENV} must be an integer slice count, got {raw!r}"
                ) from None
    if num_slices is None:
        local = int(env.get("LOCAL_WORLD_SIZE", "0") or 0)
        if local <= 0 or local >= num_devices:
            return None
        num_slices = num_devices // local
        if num_slices * local != num_devices:
            return None
    if num_slices < 1:
        raise ValueError(f"comm slices must be >= 1, got {num_slices}")
    if num_devices % num_slices:
        raise ValueError(
            f"{num_devices} devices do not divide into {num_slices} "
            f"equal slices — pick a slice count dividing the data-axis "
            "width"
        )
    return CommTopology(num_slices=num_slices, slice_size=num_devices // num_slices)


def hop_axes(world, topology: CommTopology) -> tuple[DataAxis, DataAxis]:
    """``(ici, dcn)``: this rank's slice (the ranks of its host, by local
    rank) and its cross-slice group (the same local rank on every host, by
    host), as axes.  Every rank makes every group of the topology, in the
    same order, once per world (``torch.distributed.new_group`` is
    collective); the groups are kept in ``world.hop_groups``."""
    if topology.num_devices != world.size:
        raise ValueError(
            f"topology is {topology.num_slices}x{topology.slice_size} = "
            f"{topology.num_devices} devices but the world has {world.size}"
        )
    if topology not in world.hop_groups:
        S, L = topology.num_slices, topology.slice_size
        # new_group orders a group's ranks ascending: by local rank within
        # a slice, by host across slices, the orders the tiles follow.
        ici = [dist.new_group([s * L + r for r in range(L)]) for s in range(S)]
        dcn = [dist.new_group([s * L + r for s in range(S)]) for r in range(L)]
        node, local = divmod(world.rank, L)
        world.hop_groups[topology] = (DataAxis(world, ici[node], L, local),
                                      DataAxis(world, dcn[local], S, node))
    return world.hop_groups[topology]


#: The JAX package's name of the image-H axis of a 2-D mesh.
SPACE_AXIS = "space"


def assert_space_rows_single_host(world_size: int, num_space: int,
                                  environ: Mapping[str, str] | None = None) -> None:
    """Each space row (the ranks that hold one image's H shards) must live
    on one host, as the JAX package's ``_assert_space_rows_single_process``
    demands of a mesh row: every rank of a row reads the same images from
    its own host's pipeline.  torchrun numbers ranks host-major with
    ``LOCAL_WORLD_SIZE`` ranks a host, so the rows stay on their hosts
    exactly when the space size divides it.  A world started without
    torchrun is one host."""
    env = os.environ if environ is None else environ
    local = int(env.get("LOCAL_WORLD_SIZE", "0") or 0)
    if 0 < local < world_size and local % num_space:
        row = list(range(local - local % num_space, local - local % num_space + num_space))
        raise ValueError(
            f"space axis row {row} spans hosts {sorted({r // local for r in row})} — the space "
            "axis cannot span hosts: each image's H shards must sit on one host's ranks (pick "
            f"num_space dividing the per-host rank count {local})"
        )


def space_axis(world, num_space: int):
    """This rank's ``parallel/spatial.py::SpaceAxis`` in ``world`` as a
    (world.size // num_space) x num_space grid, space minor.  Every rank
    makes every space group, then every data group, in order, once per
    world (``torch.distributed.new_group`` is collective); the axis is kept
    in ``world.space_axes``."""
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.spatial import SpaceAxis

    if num_space < 1 or world.size % num_space:
        raise ValueError(f"space size {num_space} does not divide the world's {world.size} ranks")
    if num_space not in world.space_axes:
        assert_space_rows_single_host(world.size, num_space)
        num_data = world.size // num_space
        space = [dist.new_group([d * num_space + s for s in range(num_space)])
                 for d in range(num_data)]
        data = [dist.new_group([d * num_space + s for d in range(num_data)])
                for s in range(num_space)]
        d, s = divmod(world.rank, num_space)
        world.space_axes[num_space] = SpaceAxis(
            world=world, group=space[d], index=s, size=num_space,
            data_group=data[s], data_index=d, data_size=num_data)
    return world.space_axes[num_space]
