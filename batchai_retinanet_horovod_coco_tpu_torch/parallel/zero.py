"""ZeRO-style weight-update sharding over a world's ranks, as the JAX
package's ``parallel/zero.py``.

- The gradients leave the backward through one reduce-scatter: rank ``i``
  receives the 1/N shard of the mean gradient it owns.
- Rank ``i`` keeps only its 1/N shard of the optimizer state (momentum, or
  Adam's moments) and updates its 1/N of each parameter.
- The updated shards come back to every rank through one all-gather (or,
  with compression, the compressed gather of the update shards:
  ``comm/compress.py::zero_gather_updates``).

The layout is the JAX package's, so checkpoints move between the packages
and between world sizes: every parameter leaf is flattened in its flax
layout (``models/convert.py::to_flax``: conv kernels HWIO), zero-padded to
a multiple of N, and its optimizer state lives as a global ``(N *
chunk,)`` array of which rank ``i`` holds ``[i * chunk, (i + 1) *
chunk)``.  Scalars (counts, the plateau state) stay replicated.  This is
not ``ZeroRedundancyOptimizer`` or FSDP, which shard by whole parameter: a
JAX checkpoint could not be read back into them.  Because the padding is
zeros, a change of layout is shape surgery: :func:`reshard_flat_leaf`.

The clip takes the global norm from one all-reduce of the shards' square
sums; with ``freeze_backbone`` it takes the norm of the trained subtree
alone (the JAX package's ``use_precomputed=False``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_params, to_flax


def _chunk(size: int, n: int) -> int:
    return -(-size // n)


def _pad_flat(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten and zero-pad to ``n * chunk`` elements."""
    flat = x.reshape(-1)
    pad = n * _chunk(flat.numel(), n) - flat.numel()
    return torch.nn.functional.pad(flat, (0, pad)) if pad else flat


def _local_shard(x: torch.Tensor, n: int, index: int) -> torch.Tensor:
    """This rank's ``(chunk,)`` slice of a padded-flat leaf."""
    flat = _pad_flat(x, n)
    chunk = flat.numel() // n
    return flat[index * chunk:(index + 1) * chunk]


def sharded_global_norm(shards: Sequence[torch.Tensor], axis) -> torch.Tensor:
    """The global norm of a tree that lives as 1/N shards: the square root
    of the all-reduced shards' square sums (the padding adds zeros).  The
    ZeRO optimizer's clip takes it (the JAX package's
    ``clip_by_global_norm_sharded``)."""
    device = shards[0].device if shards else torch.device("cpu")
    sq = torch.zeros((), dtype=torch.float32, device=device)
    for s in shards:
        sq = sq + s.float().square().sum()
    return axis.psum(sq).sqrt()


def reshard_flat_leaf(saved, shape, dtype, path: str = "") -> np.ndarray:
    """Re-lay one leaf saved in one ZeRO or replicated layout into another
    (host-side numpy; the checkpoint restore path).

    A leaf is either its parameter's shape (replicated) or a flat
    zero-padded ``(N * chunk,)`` array (world N), whose prefix is the
    content.  So any conversion is: flatten, cut or zero-pad to the target
    size, reshape; it refuses to cut anything that is not zero.
    """
    saved = np.asarray(saved)
    shape = tuple(int(d) for d in shape)
    where = path or "<leaf>"
    if saved.dtype != np.dtype(dtype):
        raise ValueError(f"checkpoint leaf {where}: dtype {saved.dtype} != expected {np.dtype(dtype)}")
    if saved.shape == shape:
        return saved
    if saved.ndim != 1 and len(shape) != 1:
        raise ValueError(
            f"checkpoint leaf {where}: shape {saved.shape} != expected {shape} and "
            "neither is a flat ZeRO layout"
        )
    flat = saved.reshape(-1)
    target = int(np.prod(shape, dtype=np.int64))
    if flat.size > target:
        if np.count_nonzero(flat[target:]):
            raise ValueError(
                f"checkpoint leaf {where}: truncating {flat.size} -> {target} elements "
                "would drop non-zero state (not ZeRO padding): the checkpoint does not "
                "match this model/optimizer"
            )
        flat = flat[:target]
    elif flat.size < target:
        flat = np.pad(flat, (0, target - flat.size))
    return np.ascontiguousarray(flat.reshape(shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where this rank's slices of the world-sharded flat leaves lie: ``size``
    slices, this rank's at ``position``; ``ranks[d]`` is the rank holding
    slice ``d`` (the hierarchical tree's interleaved positions differ from
    the ranks)."""

    world: Any
    size: int
    position: int
    ranks: tuple[int, ...]

    @classmethod
    def of(cls, world, topology=None) -> Sharding:
        if topology is None:
            return cls(world, world.size, world.rank, tuple(range(world.size)))
        return cls(world, world.size, topology.position(world.rank),
                   tuple(topology.rank_at(d) for d in range(world.size)))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a ``(size * chunk,)`` flat."""
        chunk = full.numel() // self.size
        return full[self.position * chunk:(self.position + 1) * chunk]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole ``(size * chunk,)`` flat, in position order, on the
        host (a collective: every rank calls it)."""
        by_rank = self.world.all_gather(local.detach().float())
        return torch.cat([by_rank[r].cpu() for r in self.ranks])


class ShardedParams:
    """This rank's ``(chunk,)`` shard of every parameter (its flax-layout
    flat, zero-padded to N chunks), the tensors the ZeRO optimizer steps.

    ``leaves`` are ``(torch name, flax path, parameter)`` in the flax
    flatten order; :meth:`named` gives the shards under the parameters'
    names, so ``train/optim.py::Optimizer`` over them keeps the optax key
    paths of the checkpoint."""

    def __init__(self, model: torch.nn.Module, axis):
        self.leaves = flax_params(model)
        self.n, self.index = axis.size, axis.index
        self.shards = {
            name: torch.nn.Parameter(_local_shard(to_flax(p.detach()), self.n, self.index).clone())
            for name, _, p in self.leaves
        }
        self.chunks = [self.shards[name].numel() for name, _, _ in self.leaves]

    def named(self) -> list[tuple[str, torch.nn.Parameter]]:
        return [(name, self.shards[name]) for name, _, _ in self.leaves]

    def refresh(self) -> None:
        """Copy this rank's slice of the current parameters into the shards."""
        with torch.no_grad():
            for name, _, p in self.leaves:
                self.shards[name].copy_(_local_shard(to_flax(p.detach()), self.n, self.index))


def init_sharded_opt_state(model: torch.nn.Module, config, axis):
    """``(optimizer, shards)``: ``train/optim.py::Optimizer`` over this
    rank's :class:`ShardedParams` of ``model``, its clip's trained-subtree
    norm taken over the world."""
    from batchai_retinanet_horovod_coco_tpu_torch.train import optim

    shards = ShardedParams(model, axis)
    optimizer = optim.Optimizer(shards.named(), config)
    optimizer.norm_of = lambda grads: sharded_global_norm(grads, axis)
    return optimizer, shards


def sharded_update(optimizer, shards: ShardedParams, grads: Mapping[str, torch.Tensor], axis,
                   loss: torch.Tensor | None = None, gather_updates=None) -> dict[str, torch.Tensor]:
    """One weight update on this rank's shards, writing the new parameters
    into the model; returns ``{"grad_norm": ...}``, the pre-clip global
    norm of the mean gradient.

    ``grads`` are this rank's local gradients (``{flax path: tensor}``, flax
    layout).  One reduce-scatter carries every leaf: row ``r`` of the
    ``(N, total)`` matrix is the concat of each leaf's chunk ``r``, so each
    rank receives its shards of all the mean gradients at once.  The clip
    reuses the norm unless the backbone is frozen.

    ``gather_updates(updates) -> {path: new parameter}`` (optional) takes
    the optimizer's update shards and returns the new full parameters (the
    compressed gather); without it the updated shards are all-gathered in
    f32, again one collective for every leaf.
    """
    n = axis.size
    rows = [_pad_flat(grads[path].float(), n).view(n, -1) for _, path, _ in shards.leaves]
    mine = axis.psum_scatter(torch.cat(rows, dim=1).reshape(-1)) / n
    gshards = list(mine.split(shards.chunks))
    info = {"grad_norm": sharded_global_norm(gshards, axis)}
    shards.refresh()
    for (name, _, _), g in zip(shards.leaves, gshards):
        shards.shards[name].grad = g
    # With a gather of the updates, the shards end as the update itself
    # (``Optimizer.step(as_update=True)``): the difference of two
    # parameters would lose an update below half an ulp of its parameter.
    optimizer.step(info["grad_norm"], loss, as_update=gather_updates is not None)
    with torch.no_grad():
        if gather_updates is not None:
            trained = set(optimizer.names)  # a frozen leaf's update is zero
            updates = {path: shards.shards[name].detach() if name in trained
                       else torch.zeros_like(shards.shards[name])
                       for name, path, _ in shards.leaves}
            new = gather_updates(updates)
            for _, path, p in shards.leaves:
                to_flax(p).copy_(new[path])
        else:
            gathered = axis.all_gather(torch.cat([shards.shards[name].detach()
                                                  for name, _, _ in shards.leaves]))
            off = 0
            for (_, _, p), c in zip(shards.leaves, shards.chunks):
                full = gathered[:, off:off + c].reshape(-1)[: p.numel()]
                to_flax(p).copy_(full.reshape(to_flax(p).shape))
                off += c
    return info
