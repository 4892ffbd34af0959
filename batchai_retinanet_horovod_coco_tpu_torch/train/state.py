"""The train state, as the JAX package's ``train/state.py``.

JAX keeps params, BatchNorm statistics, optimizer state, the step count
and the gradient-compression residuals in one pytree.  Here the model
holds its parameters and, as buffers, its BatchNorm statistics; the
optimizer holds its own state; the state adds the step count and
``comm_state``, this rank's slice of each error-feedback residual
(``comm/compress.py``), keyed as the JAX state keys them.  With the ZeRO
weight update (``parallel/zero.py``) the optimizer steps this rank's
shards of the parameters, and its state is this rank's slice too;
``sharding`` says where the slices lie in the world.

:func:`saveable` is the JAX state's saveable view, ``{step, params,
batch_stats, opt_state, comm_state}``, as the flat leaves that the JAX
package's checkpoints hold: the key paths that ``jax.tree_util.keystr``
gives for the JAX package's state of the same model and
``OptimizerConfig``, in its flatten order, with conv kernels in HWIO and
the optax ``opt_state`` paths (``train/optim.py::Optimizer.optax_leaves``).
Each leaf reads a host copy and writes back onto the model's device, so a
checkpoint moves between the two packages in both directions.  A leaf
sharded over the world (a residual; ZeRO's optimizer slots) reads as the
whole ``(N * chunk,)`` flat, gathered from every rank (``collective``:
every rank must read it), and writes this rank's slice.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as compress_lib
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import (
    flax_params,
    flax_path,
    from_flax,
    keystr,
    to_flax,
)
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh
from batchai_retinanet_horovod_coco_tpu_torch.parallel import zero as zero_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: optim.Optimizer
    schedule: optim.Schedule
    step: int = 0
    # This rank's slice of each EF residual, keyed as the JAX state's
    # comm_state; empty without compression (or with it but no EF).
    comm_state: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # Where the world-sharded leaves lie; None when nothing is sharded.
    sharding: zero_lib.Sharding | None = None
    # ZeRO: this rank's parameter shards, which ``optimizer`` steps.
    shards: zero_lib.ShardedParams | None = None
    # ``(comm, shard_weight_update, topology)`` as given to
    # create_train_state in a world on the ZeRO or compressed paths (None
    # elsewhere): the step of those paths takes only a state built with its
    # own flags.
    comm_flags: tuple | None = None

    def apply_gradients(self, grad_norm: torch.Tensor, loss: torch.Tensor | None = None) -> None:
        """One optimizer update from the parameters' gradients;
        ``grad_norm`` is their global norm, which the clip reuses, and
        ``loss`` the step's loss (the plateau schedule reads it)."""
        self.optimizer.step(grad_norm, loss)
        self.step += 1


def create_train_state(
    model: torch.nn.Module,
    optimizer_config: optim.OptimizerConfig = optim.OptimizerConfig(),
    device: str | torch.device = "cuda",
    world=None,
    comm=None,
    shard_weight_update: bool = False,
    topology=None,
    spatial_shards: int = 1,
) -> TrainState:
    """``model`` moved to ``device`` (CUDA unless the caller asks for the
    CPU; raises without a card) with a fresh optimizer over its parameters.

    In a ``world`` with ``spatial_shards`` > 1 (``train/step.py::
    make_train_step_spatial``, which runs the model itself, no DDP replica)
    the model first takes rank 0's parameters and buffers.

    In a ``world`` with ``shard_weight_update`` or a compressing ``comm``
    (``comm/config.py::CommConfig``): the model first takes rank 0's
    parameters and buffers (no DDP replica makes that copy on these paths);
    with ``shard_weight_update`` the optimizer steps this rank's shards
    (``parallel/zero.py``); with error feedback ``comm_state`` holds this
    rank's zero residuals in the layout of ``comm/compress.py::
    init_comm_state`` (``topology``: the hierarchical tree's, where it
    engages; ZeRO's update gather stays flat).
    """
    model = model.to(resolve_device(device))
    comm_on = comm is not None and comm.enabled
    if world is None:
        if shard_weight_update:
            raise ValueError("shard_weight_update requires a mesh: pass world=")
        if comm_on:
            raise ValueError("comm compression requires a mesh: pass world=")
    elif shard_weight_update or comm_on or spatial_shards > 1:
        mesh.copy_from_rank0(model, world)
    if shard_weight_update:
        optimizer, shards = zero_lib.init_sharded_opt_state(model, optimizer_config,
                                                            mesh.DataAxis(world))
    else:
        optimizer, shards = optim.make_optimizer(model, optimizer_config)[0], None
    state = TrainState(model=model, optimizer=optimizer, schedule=optimizer.schedule, shards=shards)
    if world is not None and (shard_weight_update or comm_on):
        state.comm_flags = (comm, shard_weight_update, topology)
    if comm_on and comm.needs_state:
        hier = None if shard_weight_update or not comm.hierarchical_with(topology) else topology
        leaves = {path: to_flax(p.detach()) for _, path, p in flax_params(model)}
        full = compress_lib.init_comm_state(leaves, comm, world.size, zero=shard_weight_update,
                                            topology=hier)
        state.sharding = zero_lib.Sharding.of(world, hier)
        device = next(model.parameters()).device
        state.comm_state = {k: state.sharding.local(torch.from_numpy(v)).to(device).clone()
                            for k, v in full.items()}
    if shard_weight_update and state.sharding is None:
        state.sharding = zero_lib.Sharding.of(world)
    return state


class SaveableLeaf(NamedTuple):
    """One leaf of the saveable view: its key path, shape and dtype in the
    JAX layout, a ``read()`` that returns an owned host copy, and a
    ``write(array)`` that sets it in place on the model's device.  A
    ``collective`` leaf's read gathers it from every rank."""

    path: str
    shape: tuple[int, ...]
    dtype: np.dtype
    read: Callable[[], np.ndarray]
    write: Callable[[np.ndarray], None]
    collective: bool = False


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy, complete when this returns (the next in-place
    update cannot reach it)."""
    return to_flax(t.detach()).contiguous().to("cpu", copy=True).numpy()


def _leaf(path: str, read: Callable[[], torch.Tensor], write: Callable[[torch.Tensor], None]) -> SaveableLeaf:
    like = to_flax(read())

    def write_array(array: np.ndarray) -> None:
        t = torch.from_numpy(np.array(array, copy=True))
        write(from_flax(t))

    return SaveableLeaf(path, tuple(like.shape), np.dtype(str(like.dtype).removeprefix("torch.")),
                        lambda: _host(read()), write_array)


def _sharded_leaf(path: str, sharding: zero_lib.Sharding, read: Callable[[], torch.Tensor],
                  write: Callable[[torch.Tensor], None]) -> SaveableLeaf:
    """A leaf of which this rank holds the ``(chunk,)`` slice: read whole,
    written as this rank's slice."""
    local = read()

    def write_array(array: np.ndarray) -> None:
        write(sharding.local(torch.from_numpy(np.array(array, copy=True))))

    return SaveableLeaf(path, (sharding.size * local.numel(),), np.dtype("float32"),
                        lambda: sharding.gather(read()).numpy(), write_array, collective=True)


def saveable(state: TrainState) -> list[SaveableLeaf]:
    """The leaves of the JAX package's saveable state, in its flatten order."""
    named = state.model.state_dict(keep_vars=True)
    keys = {name: flax_path(name, t.dim()) for name, t in named.items()}
    order = sorted(named, key=lambda n: keys[n][1])

    def tensor_leaf(prefix: str, name: str) -> SaveableLeaf:
        t = named[name]

        def write(value: torch.Tensor) -> None:
            with torch.no_grad():
                t.copy_(value)

        return _leaf(prefix + keystr(keys[name][1]), lambda: t, write)

    params = [n for n in order if keys[n][0] == "params"]
    stats = [n for n in order if keys[n][0] == "batch_stats"]
    opt = state.optimizer.optax_leaves({n: keystr(keys[n][1]) for n in params})

    def write_step(value: torch.Tensor) -> None:
        state.step = int(value)

    def opt_leaf(leaf: optim.OptaxLeaf) -> SaveableLeaf:
        path = "['opt_state']" + leaf.path
        if state.shards is not None and leaf.read().dim():
            return _sharded_leaf(path, state.sharding, leaf.read, leaf.write)
        return _leaf(path, leaf.read, leaf.write)

    def comm_leaf(key: str) -> SaveableLeaf:
        def write(value: torch.Tensor) -> None:
            state.comm_state[key].copy_(value)

        return _sharded_leaf(f"['comm_state'][{key!r}]", state.sharding,
                             lambda: state.comm_state[key], write)

    return (
        [tensor_leaf("['batch_stats']", n) for n in stats]
        + [comm_leaf(k) for k in sorted(state.comm_state)]
        + [opt_leaf(leaf) for leaf in opt]
        + [tensor_leaf("['params']", n) for n in params]
        + [_leaf("['step']", lambda: torch.tensor(state.step, dtype=torch.int32), write_step)]
    )


def snapshot(state: TrainState, writer: bool = True) -> list[tuple[str, np.ndarray]]:
    """``(key path, host array)`` for every saveable leaf, complete when
    this returns.  A rank that does not write (``writer`` False) only joins
    the gathers of the collective leaves, and gets nothing."""
    leaves = saveable(state)
    if not writer:
        for leaf in leaves:
            if leaf.collective:
                leaf.read()
        return []
    return [(leaf.path, leaf.read()) for leaf in leaves]


def zero_world_size(state: TrainState) -> int | None:
    """The world size of a ZeRO optimizer state (the manifest's
    ``zero_world_size``), None when it is replicated."""
    return state.sharding.size if state.shards is not None else None
