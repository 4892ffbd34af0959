"""ImageNet-pretrained backbone import: a torchvision-layout ResNet-50 state
dict into the port's ResNet backbone, the JAX package's
``models/import_weights.py``.

The reference initialised its backbone from ImageNet weights and fine-tuned
with frozen BatchNorm (``--pretrained-backbone ... --norm frozen_bn``).  No
weights ship with the repository; this module maps them when they are
there: ``.pth`` (a plain tensor state dict, read with
``torch.load(weights_only=True)``) or ``.npz``.  torchvision's convs are
OIHW already, as the port's are, so every tensor is carried as it is:

    conv1                      → stem_conv         bn1                → stem_norm
    layer{i}.{b}.conv{k}       → stage{i+1}_block{b}.conv{k}
    layer{i}.{b}.bn{k}         → stage{i+1}_block{b}.norm{k}
    layer{i}.{b}.downsample.0  → stage{i+1}_block{b}.proj
    layer{i}.{b}.downsample.1  → stage{i+1}_block{b}.proj_norm

with a BatchNorm's ``weight``, ``bias``, ``running_mean`` and
``running_var`` under the same names.  ``fc.*`` (the classifier) and
``num_batches_tracked`` are not read.  :func:`apply_backbone_weights`
refuses, with the JAX package's messages, a shape that differs, a tensor
the model has no place for, a backbone the file leaves partly uncovered
(a ResNet-50 file into a ResNet-101) and BatchNorm statistics for a
GroupNorm model; the model is changed only when nothing is refused.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch
from torch import nn

# torchvision's stage prefixes → the port's stage names.
_STAGE_OF_LAYER = {f"layer{i}": f"stage{i + 1}" for i in range(1, 5)}
_STATS = ("running_mean", "running_var")


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """Read a state dict from ``.npz`` or ``.pth`` (a plain tensor dict)
    into numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path} is not a plain tensor state dict (full pickled modules "
            "are not supported; save model.state_dict() instead)"
        ) from e
    return {k: v.numpy() for k, v in sd.items()}


def convert_torch_resnet50(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision ``resnet50`` state dict → the port's backbone entries
    (names under ``backbone.``), as f32 tensors."""
    out: dict[str, torch.Tensor] = {}

    def put(name: str, key: str) -> None:
        out[name] = torch.as_tensor(np.asarray(state_dict[key]), dtype=torch.float32)

    def bn(name: str, prefix: str) -> None:
        for leaf in ("weight", "bias", *_STATS):
            put(f"{name}.{leaf}", f"{prefix}.{leaf}")

    put("stem_conv.weight", "conv1.weight")
    bn("stem_norm", "bn1")
    for layer, stage in _STAGE_OF_LAYER.items():
        block = 0
        while f"{layer}.{block}.conv1.weight" in state_dict:
            ours, theirs = f"{stage}_block{block}", f"{layer}.{block}"
            for k in (1, 2, 3):
                put(f"{ours}.conv{k}.weight", f"{theirs}.conv{k}.weight")
                bn(f"{ours}.norm{k}", f"{theirs}.bn{k}")
            if f"{theirs}.downsample.0.weight" in state_dict:
                put(f"{ours}.proj.weight", f"{theirs}.downsample.0.weight")
                bn(f"{ours}.proj_norm", f"{theirs}.downsample.1")
            block += 1
        if block == 0:
            raise ValueError(f"state dict has no blocks for {layer}")
    return out


def _tree(flat: Mapping[str, Any]) -> dict:
    """Dotted names → nested dicts."""
    tree: dict = {}
    for name, value in flat.items():
        *scope, leaf = name.split(".")
        node = tree
        for key in scope:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _merge(dst: dict, src: Mapping, path: str) -> None:
    for k, v in src.items():
        if k not in dst:
            raise ValueError(f"unknown param {path}/{k} in imported weights")
        if isinstance(v, Mapping):
            _merge(dst[k], v, f"{path}/{k}")
        elif tuple(dst[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch at {path}/{k}: model {tuple(dst[k].shape)} "
                f"vs imported {tuple(v.shape)}"
            )


def _uncovered(dst: Mapping, src: Mapping, path: str) -> list[str]:
    """Leaves of ``dst`` that ``src`` does not provide (src keys ⊆ dst keys),
    in the JAX package's (sorted-key) order."""
    missing: list[str] = []
    for k, v in sorted(dst.items()):
        if k not in src:
            missing.append(f"{path}/{k}")
        elif isinstance(v, Mapping):
            missing.extend(_uncovered(v, src[k], f"{path}/{k}"))
    return missing


def apply_backbone_weights(model: nn.Module, imported: Mapping[str, torch.Tensor]) -> nn.Module:
    """Copy ``imported`` (:func:`convert_torch_resnet50`) into ``model``'s
    backbone, on whatever device it is; raises as the JAX package's
    ``apply_backbone_weights`` does, before anything is copied."""
    state = model.state_dict()
    backbone = {k[len("backbone."):]: v for k, v in state.items() if k.startswith("backbone.")}
    if not backbone:
        raise ValueError("model params have no 'backbone' subtree")
    is_stat = lambda name: name.rsplit(".", 1)[-1] in _STATS  # noqa: E731
    params = _tree({k: v for k, v in backbone.items() if not is_stat(k)})
    stats = _tree({k: v for k, v in backbone.items() if is_stat(k)})
    imported_params = _tree({k: v for k, v in imported.items() if not is_stat(k)})
    imported_stats = _tree({k: v for k, v in imported.items() if is_stat(k)})
    _merge(params, imported_params, "backbone")
    missing = _uncovered(params, imported_params, "backbone")
    if imported_stats:
        if not stats:
            raise ValueError(
                "imported weights carry BN stats but the model has none "
                "(use norm_kind='frozen_bn' or 'bn')"
            )
        _merge(stats, imported_stats, "backbone")
        missing += _uncovered(stats, imported_stats, "backbone")
    if missing:
        head = ", ".join(missing[:5])
        raise ValueError(
            f"imported weights leave {len(missing)} backbone leaves "
            f"uninitialized (model deeper than the checkpoint?): {head}"
            + ("..." if len(missing) > 5 else "")
        )
    with torch.no_grad():
        for name, tensor in imported.items():
            state[f"backbone.{name}"].copy_(tensor)
    return model


def import_pretrained_backbone(model: nn.Module, path: str) -> nn.Module:
    """``--pretrained-backbone``: the torchvision ResNet-50 file at ``path``
    into ``model``'s backbone."""
    return apply_backbone_weights(model, convert_torch_resnet50(load_state_dict(path)))
