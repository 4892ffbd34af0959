"""The train state, as the JAX package's ``train/state.py``.

JAX keeps params, BatchNorm statistics, optimizer state and the step count
in one pytree.  Here the model holds its parameters and, as buffers, its
BatchNorm statistics; the optimizer holds its own state; the state adds the
step count.

:func:`saveable` is the JAX state's saveable view, ``{step, params,
batch_stats, opt_state}``, as the flat leaves that the JAX package's
checkpoints hold: the key paths that ``jax.tree_util.keystr`` gives for the
JAX package's state of the same model and ``OptimizerConfig``, in its
flatten order, with conv kernels in HWIO and the optax ``opt_state`` paths
(``train/optim.py::Optimizer.optax_leaves``).  Each leaf reads a host copy
and writes back onto the model's device, so a checkpoint moves between
the two packages in both directions.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_path
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: optim.Optimizer
    schedule: optim.Schedule
    step: int = 0

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
) -> TrainState:
    """``model`` moved to ``device`` (CUDA unless the caller asks for the
    CPU; raises without a card) with a fresh optimizer over its parameters."""
    model = model.to(resolve_device(device))
    optimizer, schedule = optim.make_optimizer(model, optimizer_config)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)


class SaveableLeaf(NamedTuple):
    """One leaf of the saveable view: its key path, shape and dtype in the
    JAX layout, a ``read()`` that returns an owned host copy, and a
    ``write(array)`` that sets it in place on the model's device."""

    path: str
    shape: tuple[int, ...]
    dtype: np.dtype
    read: Callable[[], np.ndarray]
    write: Callable[[np.ndarray], None]


def _keystr(keys: tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _to_flax(t: torch.Tensor) -> torch.Tensor:
    """A tensor in the JAX layout: conv kernels OIHW → HWIO."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy, complete when this returns (the next in-place
    update cannot reach it)."""
    return _to_flax(t.detach()).contiguous().to("cpu", copy=True).numpy()


def _leaf(path: str, read: Callable[[], torch.Tensor], write: Callable[[torch.Tensor], None]) -> SaveableLeaf:
    like = _to_flax(read())

    def write_array(array: np.ndarray) -> None:
        t = torch.from_numpy(np.array(array, copy=True))
        write(t.permute(3, 2, 0, 1) if t.dim() == 4 else t)

    return SaveableLeaf(path, tuple(like.shape), np.dtype(str(like.dtype).removeprefix("torch.")),
                        lambda: _host(read()), write_array)


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

        return _leaf(prefix + _keystr(keys[name][1]), lambda: t, write)

    params = [n for n in order if keys[n][0] == "params"]
    stats = [n for n in order if keys[n][0] == "batch_stats"]
    opt = state.optimizer.optax_leaves({n: _keystr(keys[n][1]) for n in params})

    def write_step(value: torch.Tensor) -> None:
        state.step = int(value)

    return (
        [tensor_leaf("['batch_stats']", n) for n in stats]
        + [_leaf("['opt_state']" + leaf.path, leaf.read, leaf.write) for leaf in opt]
        + [tensor_leaf("['params']", n) for n in params]
        + [_leaf("['step']", lambda: torch.tensor(state.step, dtype=torch.int32), write_step)]
    )


def snapshot(state: TrainState) -> list[tuple[str, np.ndarray]]:
    """``(key path, host array)`` for every saveable leaf, complete when
    this returns."""
    return [(leaf.path, leaf.read()) for leaf in saveable(state)]
