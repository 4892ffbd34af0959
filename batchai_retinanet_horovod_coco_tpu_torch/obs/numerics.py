"""Numerics flight recorder: in-step gradient/update health + NaN provenance;
the JAX package's ``obs/numerics.py`` in PyTorch.

- **In-step summary** (``train/step.py`` with ``NumericsConfig(enabled=
  True)``): per-layer-group gradient norms, the update/param-norm ratio
  and a non-finite element count, computed on the device from tensors the
  step already holds.  The per-tensor gradient norms are computed ONCE and
  shared by the step's pre-clip ``grad_norm`` (which the clip reuses) and
  the group norms; the non-finite count reads the gradients laid end to
  end, and the update norm a snapshot of the parameters taken before the
  in-place update, each in a buffer the step allocates once.
  Nothing is read back to the host: the loop reads the summary with the
  other metrics, at its log cadence.  Disabled, the step is unchanged.
- **Provenance pass** (host-driven, failure path only): when the loop's
  finite-check trips, ``provenance`` localizes the first non-finite loss
  term / parameter / layer activation (one forward with a hook on every
  module) and ``write_dump`` lands ONE ``NUMERICS_DUMP.json`` (step,
  batch image ids, rng seed, per-layer stats) before the abort raises.

Names are the JAX package's: parameters under their flax leaf paths
(``models/convert.py``: ``['backbone']['stem_conv']['kernel']``), layers
under the path flax's ``capture_intermediates`` gives a module's output
(``['backbone']['stage3_block0']['conv2']['__call__'][0]``; a module
called once per pyramid level, like a head, counts its calls), so a dump
reads the same from either package.
- **Replica agreement** (a data-parallel step, ``replica_agreement``): the
  min/max ratio of the ranks' LOCAL gradient norms before the all-reduce;
  ~1 when the replicas agree, collapsing when one has silently diverged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from collections.abc import Iterable, Mapping, Sequence
from typing import Any

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Config + the metric-key vocabulary
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Gate for the in-step summary (train/step.py): ``enabled=False`` adds
    nothing to the step; the loop's record sites then cost one bool check
    each."""

    enabled: bool = False


#: Metric keys the summary contributes (the loop, telemetry and the dump
#: read these names — one vocabulary, defined here).
GRAD_NORM = "grad_norm"
UPDATE_RATIO = "update_ratio"
NONFINITE = "nonfinite_grads"
REPLICA_AGREEMENT = "replica_agreement"
# The gradient-communication health (comm/compress.py::comm_metrics).
EF_RESIDUAL = "ef_residual_norm"
EF_SATURATION = "ef_saturation"
COMM_BYTES = "comm_compressed_bytes"
# Per hop of the hierarchical tree.
EF_RESIDUAL_DCN = "ef_residual_norm_dcn"
COMM_ICI_BYTES = "comm_ici_bytes"
COMM_DCN_BYTES = "comm_dcn_bytes"
GROUP_PREFIX = "gnorm/"

#: Scalars whose non-finiteness the provenance pass attributes first, in
#: root-cause order (a NaN cls_loss names the classification path even
#: though the total loss is NaN too).
_SCALAR_ORDER = (
    "cls_loss",
    "box_loss",
    "loss",
    GRAD_NORM,
    "param_norm",
    UPDATE_RATIO,
)

_EPS = 1e-16


def numerics_metric_keys(scalars: Mapping[str, Any]) -> list[str]:
    """The summary's keys present in a metrics mapping (loop record site)."""
    fixed = {GRAD_NORM, UPDATE_RATIO, NONFINITE, REPLICA_AGREEMENT}
    return sorted(
        k for k in scalars if k in fixed or k.startswith(GROUP_PREFIX)
    )


# ---------------------------------------------------------------------------
# In-step helpers (train/step.py): device tensors in, 0-dim tensors out
# ---------------------------------------------------------------------------


def nonfinite_count(
    tensors: Sequence[torch.Tensor], buffer: torch.Tensor | None = None
) -> torch.Tensor:
    """Total non-finite elements across ``tensors`` (an f32 0-dim tensor),
    counted in one pass over their elements laid end to end: a few kernels
    whatever the number of tensors.  ``buffer``, 1-D and at least as long,
    holds them (the step's, made once), else a new tensor does."""
    if not tensors:
        return torch.zeros(())
    views = [t.reshape(-1) for t in tensors]
    if buffer is None:
        flat = torch.cat(views)
    else:
        flat = torch.cat(views, out=buffer[: sum(v.numel() for v in views)])
    return torch.isfinite(flat).logical_not_().sum().float()


def group_of(name: str) -> str:
    """A parameter's layer group: its top-level module (``backbone``,
    ``fpn``, ``cls_head``, ``box_head`` — the flax tree's top level)."""
    return name.split(".", 1)[0]


def group_norms(
    groups: Sequence[str], norms: Sequence[torch.Tensor]
) -> dict[str, torch.Tensor]:
    """L2 norm per group from per-tensor norms (``norms[i]`` is the norm of
    a tensor of group ``groups[i]``): the per-layer-group view that tells a
    diverging head from a diverging backbone."""
    members: dict[str, list[torch.Tensor]] = {}
    for group, norm in zip(groups, norms, strict=True):
        members.setdefault(group, []).append(norm)
    return {
        g: torch.linalg.vector_norm(torch.stack(ns))
        for g, ns in sorted(members.items())
    }


def update_norm(
    before: Sequence[torch.Tensor], after: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Global L2 norm of the applied update (after − before).  ``before``
    is a snapshot buffer and is overwritten with the difference: no
    allocation beside the per-tensor norms."""
    torch._foreach_sub_(list(before), list(after))
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(before)))


def update_ratio(
    before: Sequence[torch.Tensor],
    after: Sequence[torch.Tensor],
    param_norm: torch.Tensor,
) -> torch.Tensor:
    """||after − before|| / ||after|| — the classic step-health ratio (a
    healthy run sits around 1e-3; ~1 means the update is rewriting the
    model, ~0 under a finite loss means the optimizer has stalled)."""
    return update_norm(before, after) / torch.clamp_min(param_norm, _EPS)


def replica_agreement(local_norm: torch.Tensor, world) -> torch.Tensor:
    """min/max ratio of the ranks' local gradient norms over ``world``
    (``launch/pod.py::World``; one all-reduce), 1 where every norm is 0:
    the JAX package's ``pmin``/``pmax`` probe."""
    both = world.all_reduce(torch.stack([local_norm, -local_norm]).float(), op="max")
    mx, mn = both[0], -both[1]
    return torch.where(mx > 0, mn / torch.clamp_min(mx, _EPS), torch.ones_like(mx))


def step_summary(
    grads: Sequence[torch.Tensor],
    grad_norms: Sequence[torch.Tensor],
    groups: Sequence[str],
    buffer: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The gradient half of the per-step summary: the non-finite count and
    the group norms of the PRE-clip ``grads`` (the clip scales them in
    place, so call this before the update), from their per-tensor norms
    ``grad_norms`` (the ones the step's ``grad_norm`` came from).  The step
    adds ``UPDATE_RATIO`` (``update_ratio``) after the update.  ``buffer``
    is ``nonfinite_count``'s.  Returns metric entries to merge into the
    step's metrics."""
    out: dict[str, torch.Tensor] = {NONFINITE: nonfinite_count(grads, buffer)}
    for key, norm in group_norms(groups, grad_norms).items():
        out[f"{GROUP_PREFIX}{key}"] = norm
    return out


# ---------------------------------------------------------------------------
# Host-side finite checks (train/loop.py — cadence + pre-save share these)
# ---------------------------------------------------------------------------


def _to_float(value: Any) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.detach().float().cpu())
    return float(np.asarray(value))


def first_nonfinite_scalar(
    scalars: Mapping[str, Any]
) -> tuple[str, float] | None:
    """THE finite-check helper: first non-finite entry of a scalar map in
    root-cause order (``_SCALAR_ORDER`` first, then alphabetical), or
    None when everything is finite.  Both the loop's cadence check and
    its pre-save poisoned-state gate go through here."""
    order = [k for k in _SCALAR_ORDER if k in scalars] + sorted(
        k for k in scalars if k not in _SCALAR_ORDER
    )
    for name in order:
        try:
            value = _to_float(scalars[name])
        except (TypeError, ValueError, RuntimeError):
            continue
        if not np.isfinite(value):
            return name, value
    return None


def tree_all_finite(tensors: Iterable[torch.Tensor]) -> bool:
    """Host-side: every tensor finite (one read-back)."""
    flags = [torch.isfinite(t).all() for t in tensors]
    return bool(torch.stack(flags).all()) if flags else True


# ---------------------------------------------------------------------------
# Provenance pass (failure path)
# ---------------------------------------------------------------------------

# Coarse topological rank for the RetinaNet family: the first non-finite
# layer is the EARLIEST one in forward order, and module paths don't carry
# execution order — this heuristic does (backbone stem → stages → fpn →
# heads → root outputs).  The JAX package's, so both name the same layer.
_TOP_RANK = {"backbone": 0, "fpn": 1, "cls_head": 2, "box_head": 2}
_STAGE_RE = re.compile(r"stage(\d+)")


def key_path(*keys: Any) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys (str) and sequence
    indices (int): ``['backbone']['stem_conv']['kernel']``."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"['{k}']" for k in keys)


def _layer_sort_key(path: str) -> tuple:
    names = re.findall(r"'([^']+)'", path)
    top = names[0] if names else ""
    rank = _TOP_RANK.get(top, 3)
    stage = 99
    if rank == 0:
        m = _STAGE_RE.search(path)
        if "stem" in path:
            stage = 0
        elif m:
            stage = int(m.group(1))
    return (rank, stage, path)


@torch.no_grad()
def _leaf_stats(value: torch.Tensor) -> dict[str, Any]:
    """Size, non-finite/NaN/Inf counts and the finite min/max/absmax of a
    tensor, reduced where it lies (only the scalars reach the host)."""
    x = value.detach().double()
    size = x.numel()
    stats: dict[str, Any] = {"size": int(size)}
    if not size:
        stats["nonfinite"] = 0
        return stats
    finite = torch.isfinite(x)
    inf = torch.tensor(float("inf"), device=x.device)
    n_fin, n_nan, lo, hi, amax = torch.stack([
        finite.sum().double(),
        torch.isnan(x).sum().double(),
        torch.where(finite, x, inf).min(),
        torch.where(finite, x, -inf).max(),
        torch.where(finite, x.abs(), -inf).max(),
    ]).tolist()
    n_bad = size - int(n_fin)
    stats["nonfinite"] = n_bad
    stats["nan"] = int(n_nan)
    stats["inf"] = n_bad - stats["nan"]
    if n_fin:
        stats["min"], stats["max"], stats["absmax"] = lo, hi, amax
    return stats


def param_paths(model: torch.nn.Module) -> list[tuple[str, torch.Tensor]]:
    """``(flax leaf path, tensor)`` of each parameter (``models/convert.py``
    maps the names)."""
    from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_path

    out = []
    for name, p in model.named_parameters():
        _, path = flax_path(name, p.ndim)
        out.append((key_path(*path), p))
    return out


def tree_report(
    leaves: Iterable[tuple[str, torch.Tensor]], max_entries: int = 256
) -> dict[str, Any]:
    """Per-leaf non-finite/extremum stats of ``(path, tensor)`` leaves
    (``param_paths(model)``).

    Returns ``{"nonfinite_total", "leaves", "first_nonfinite",
    "entries": {path: stats}}``; ``entries`` keeps every non-finite leaf
    plus the largest-magnitude finite ones up to ``max_entries`` (a full
    ResNet-50 table would be noise, the extremes are the signal)."""
    rows = [(path, _leaf_stats(t)) for path, t in leaves]
    total_bad = sum(s["nonfinite"] for _, s in rows)
    bad = [(p, s) for p, s in rows if s["nonfinite"]]
    bad.sort(key=lambda r: _layer_sort_key(r[0]))
    good = [(p, s) for p, s in rows if not s["nonfinite"]]
    good.sort(key=lambda r: -r[1].get("absmax", 0.0))
    entries = dict(bad[:max_entries])
    for p, s in good[: max(0, max_entries - len(entries))]:
        entries[p] = s
    return {
        "leaves": len(rows),
        "nonfinite_total": total_bad,
        "first_nonfinite": bad[0][0] if bad else None,
        "entries": entries,
    }


def _output_leaves(prefix: tuple, out: Any) -> Iterable[tuple[tuple, torch.Tensor]]:
    if isinstance(out, torch.Tensor):
        yield prefix, out
    elif isinstance(out, Mapping):
        for k, v in out.items():
            yield from _output_leaves(prefix + (k,), v)
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            yield from _output_leaves(prefix + (i,), v)


@torch.no_grad()
def forward_provenance(
    model: torch.nn.Module, images: torch.Tensor, max_layers: int = 64
) -> dict[str, Any]:
    """One instrumented forward (a hook on every module, in eval mode, as
    the JAX package's ``train=False``) → per-layer activation stats,
    localizing the FIRST non-finite layer in (heuristic) forward order.
    Runs on the already-poisoned model and batch, where they lie; each
    hook reduces its output to a few scalars at once, so no activation is
    kept."""
    from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import normalize_images

    layers: list[tuple[str, dict]] = []
    calls: dict[str, int] = {}
    handles = []

    def hook(name: str):
        scope = tuple(name.split(".")) if name else ()

        def record(_module, _inputs, output) -> None:
            k = calls.get(name, 0)
            calls[name] = k + 1
            for path, t in _output_leaves(scope + ("__call__", k), output):
                layers.append((key_path(*path), _leaf_stats(t)))

        return record

    for name, module in model.named_modules():  # the root (name "") too, as flax
        handles.append(module.register_forward_hook(hook(name)))
    was_training = model.training
    model.eval()
    try:
        outputs = model(normalize_images(images))
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    bad = [(p, s) for p, s in layers if s["nonfinite"]]
    bad.sort(key=lambda r: _layer_sort_key(r[0]))
    out_stats = {
        k: _leaf_stats(v) for k, v in outputs.items() if isinstance(v, torch.Tensor)
    } if isinstance(outputs, Mapping) else {}
    return {
        "layers_inspected": len(layers),
        "nonfinite_layers": len(bad),
        "first_nonfinite_layer": bad[0][0] if bad else None,
        "layers": dict(bad[:max_layers]),
        "outputs": out_stats,
    }


def provenance(
    step: int,
    metrics: Mapping[str, Any] | None = None,
    model: torch.nn.Module | None = None,
    images: torch.Tensor | None = None,
    image_ids: Any | None = None,
    rng_seed: int | None = None,
    tripped: Mapping[str, Any] | None = None,
    cadence: str | None = None,
) -> dict[str, Any]:
    """Assemble the NUMERICS_DUMP payload: scalar loss terms, the
    parameter report, and (with a model and a batch) the instrumented
    forward — each section independent, so a partially available context
    still yields a useful dump."""
    dump: dict[str, Any] = {
        "event": "numerics_dump",
        "step": int(step),
        "tripped": dict(tripped) if tripped else None,
        "cadence": cadence,
        "rng_seed": rng_seed,
    }
    if image_ids is not None:
        dump["batch_image_ids"] = [int(i) for i in np.asarray(image_ids)]
        # The ids are the CHECK step's batch: the poison may have entered
        # up to a full cadence window earlier.
        dump["batch_image_ids_note"] = (
            "ids are from the step at which the finite-check TRIPPED; "
            "the non-finite value arose at or before this step"
            + (f" (checked {cadence})" if cadence else "")
        )
    scalars: dict[str, float] = {}
    if metrics:
        for k, v in metrics.items():
            try:
                scalars[k] = _to_float(v)
            except (TypeError, ValueError, RuntimeError):
                continue
        dump["metrics"] = scalars
        hit = first_nonfinite_scalar(scalars)
        dump["first_nonfinite_metric"] = hit[0] if hit else None
    if model is not None:
        dump["params"] = tree_report(param_paths(model))
        if images is not None:
            dump["forward"] = forward_provenance(model, images)
    # The headline: the most specific localization available.
    fwd = dump.get("forward") or {}
    prm = dump.get("params") or {}
    dump["first_nonfinite"] = (
        fwd.get("first_nonfinite_layer")
        or prm.get("first_nonfinite")
        or dump.get("first_nonfinite_metric")
    )
    return dump


DUMP_NAME = "NUMERICS_DUMP.json"


def write_dump(dump: Mapping[str, Any], dump_dir: str) -> str:
    """Write ONE ``NUMERICS_DUMP.json`` into ``dump_dir`` (atomic: a crash
    mid-abort never leaves a half-written dump)."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_writer

    os.makedirs(dump_dir, exist_ok=True)
    path = os.path.join(dump_dir, DUMP_NAME)
    with atomic_writer(path) as f:
        json.dump(dump, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_dump(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def format_dump(dump: Mapping[str, Any]) -> str:
    """Human triage view of a dump."""
    lines = [
        f"numerics dump: step {dump.get('step')}"
        + (f" (checked {dump['cadence']})" if dump.get("cadence") else ""),
    ]
    tripped = dump.get("tripped")
    if tripped:
        lines.append(
            f"tripped: {tripped.get('metric')} = {tripped.get('value')}"
        )
    if dump.get("first_nonfinite"):
        lines.append(f"first non-finite: {dump['first_nonfinite']}")
    if dump.get("batch_image_ids") is not None:
        ids = dump["batch_image_ids"]
        shown = ", ".join(str(i) for i in ids[:16])
        more = f" (+{len(ids) - 16} more)" if len(ids) > 16 else ""
        lines.append(f"batch image ids: {shown}{more}")
        if dump.get("batch_image_ids_note"):
            lines.append(f"  note: {dump['batch_image_ids_note']}")
    if dump.get("rng_seed") is not None:
        lines.append(f"rng seed: {dump['rng_seed']}")
    metrics = dump.get("metrics") or {}
    if metrics:
        bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
        lines.append(
            "non-finite metrics: "
            + (", ".join(f"{k}={v}" for k, v in sorted(bad.items())) or "none")
        )
    for section, label in (("params", "param leaves"), ("forward", "layers")):
        sec = dump.get(section) or {}
        n = sec.get("nonfinite_total", sec.get("nonfinite_layers"))
        if n is None:
            continue
        lines.append(f"{section}: {n} non-finite {label}")
        table = sec.get("entries") or sec.get("layers") or {}
        for path, stats in list(table.items())[:8]:
            if stats.get("nonfinite"):
                lines.append(
                    f"  {path}: {stats['nonfinite']}/{stats['size']} "
                    f"non-finite (nan={stats.get('nan')}, "
                    f"inf={stats.get('inf')})"
                )
    return "\n".join(lines)
