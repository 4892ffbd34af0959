"""Carry a flax RetinaNet's variables into the port's ``RetinaNet``, and back.

Input: the JAX package's nested trees as numpy arrays — ``params`` and
``batch_stats`` as ``jax.device_get(model_variables(state))`` gives them
(``batch_stats`` is empty for GroupNorm models).  The torch submodules are
named after the flax scopes, so the mapping is mechanical:

    params/<scope...>/kernel   (H, W, I, O) → <scope...>.weight (O, I, H, W)
    params/<scope...>/bias                  → <scope...>.bias
    params/<scope...>/scale                 → <scope...>.weight
    batch_stats/<scope...>/mean             → <scope...>.running_mean
    batch_stats/<scope...>/var              → <scope...>.running_var

The conv transpose is the inverse of the JAX package's
``models/import_weights.py::_conv``; a depthwise kernel (k, k, 1, C)
becomes torch's grouped weight (C, 1, k, k) by the same transpose.  Every flax leaf is used exactly once
and every torch parameter and buffer is set exactly once: a leaf with no
torch counterpart, a torch tensor with no leaf, or a shape that differs
raises.

:func:`flax_from_state_dict` is the exact inverse (a torch ``weight`` of
four dimensions is a conv ``kernel``, of one a norm ``scale``), which the
checkpoint format shared with the JAX package is written through.
"""

from __future__ import annotations

from collections.abc import Iterator, Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _leaves(tree: Mapping[str, Any], path: tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def torch_name(collection: str, path: tuple[str, ...]) -> str:
    """The port's state-dict name of the flax leaf ``collection/path``."""
    leaf = _LEAF_NAMES.get((collection, path[-1]))
    if leaf is None:
        raise ValueError(f"no torch counterpart for {collection}/{'/'.join(path)}")
    return ".".join((*path[:-1], leaf))


def flax_path(name: str, ndim: int) -> tuple[str, tuple[str, ...]]:
    """``(collection, path)`` of the port's state-dict entry ``name`` of
    ``ndim`` dimensions: the inverse of :func:`torch_name`."""
    *scope, leaf = name.split(".")
    for (collection, flax_leaf), torch_leaf in _LEAF_NAMES.items():
        if torch_leaf != leaf:
            continue
        if leaf == "weight" and (flax_leaf == "kernel") != (ndim == 4):
            continue
        return collection, (*scope, flax_leaf)
    raise ValueError(f"no flax counterpart for {name} ({ndim} dimensions)")


def _convert_leaf(path: tuple[str, ...], value) -> np.ndarray:
    array = np.array(value, dtype=np.float32)  # a writable copy
    if path[-1] == "kernel":
        if array.ndim != 4:
            raise ValueError(f"{'/'.join(path)}: expected an HWIO conv kernel")
        array = np.transpose(array, (3, 2, 0, 1))  # HWIO → OIHW
    return np.ascontiguousarray(array)


def variables_from_flax(
    params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None = None
) -> dict[str, torch.Tensor]:
    """flax ``params`` / ``batch_stats`` trees → a torch state dict."""
    state: dict[str, torch.Tensor] = {}
    for collection, tree in (("params", params), ("batch_stats", batch_stats or {})):
        for path, value in _leaves(tree):
            name = torch_name(collection, path)
            if name in state:
                raise ValueError(f"two flax leaves map to {name}")
            state[name] = torch.from_numpy(_convert_leaf(path, value))
    return state


def flax_from_state_dict(
    state: Mapping[str, torch.Tensor],
) -> tuple[dict[str, Any], dict[str, Any]]:
    """A torch state dict → flax ``params`` and ``batch_stats`` trees of
    numpy f32 arrays (conv kernels OIHW → HWIO); the exact inverse of
    :func:`variables_from_flax`."""
    trees: dict[str, dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, tensor in state.items():
        array = tensor.detach().to("cpu", torch.float32, copy=True).numpy()
        collection, path = flax_path(name, array.ndim)
        if path[-1] == "kernel":
            array = np.ascontiguousarray(array.transpose(2, 3, 1, 0))  # OIHW → HWIO
        node = trees[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if path[-1] in node:
            raise ValueError(f"two torch tensors map to {collection}/{'/'.join(path)}")
        node[path[-1]] = array
    return trees["params"], trees["batch_stats"]


def load_flax_variables(
    model: nn.Module,
    params: Mapping[str, Any],
    batch_stats: Mapping[str, Any] | None = None,
) -> nn.Module:
    """Set every parameter and buffer of ``model`` from the flax trees;
    raises unless the two sides match one to one in names and shapes."""
    state = variables_from_flax(params, batch_stats)
    target = model.state_dict()
    missing = sorted(set(target) - set(state))
    extra = sorted(set(state) - set(target))
    if missing or extra:
        raise ValueError(
            f"flax variables do not match the model: missing {missing[:5]}, "
            f"unexpected {extra[:5]} ({len(missing)} / {len(extra)})"
        )
    for name, tensor in state.items():
        if tuple(tensor.shape) != tuple(target[name].shape):
            raise ValueError(
                f"shape mismatch at {name}: model {tuple(target[name].shape)} "
                f"vs flax {tuple(tensor.shape)}"
            )
    model.load_state_dict(state, strict=True)
    return model
