"""Communication overlapped with the backward: each schedule stage's
compressed collective issued inside the backward pass, as the JAX
package's ``comm/overlap.py``.

On the fused path (``compress.reduce_tree``) every gradient collective runs
after the whole backward.  Here each stage (heads, then fpn, then backbone:
the order the backward completes them) has a trigger: a post-accumulate
hook on each of its parameters counts the gradients that are complete, and
the last one runs the stage's ``compress.reduce_leaves`` at once, writing
the reduced gradients back into ``.grad``, while the backward goes on to
the earlier stages.  The JAX package stages the same reduce through an
identity with a custom VJP; a torch hook needs no cotangent channel, so the
new residuals and the saturated count go straight into the trigger.

The quantization is the shared ``compress.reduce_leaves`` on the same
buckets (each bucket lies within one stage), so overlap on and off give the
same values bit for bit; only the schedule differs.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

import torch

from batchai_retinanet_horovod_coco_tpu_torch.comm.compress import (
    CommPlan,
    Hierarchy,
    _top_key,
    bucket_state_key,
    reduce_leaves,
)
from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig, stage_of
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import to_flax


def group_tree(leaves: Mapping[str, Any]) -> dict[str, dict[str, Any]]:
    """Split ``{path: leaf}`` into per-stage maps, ``{stage: {path: leaf}}``
    (every leaf in exactly one stage, by its top-level key)."""
    groups: dict[str, dict[str, Any]] = {}
    for path, leaf in leaves.items():
        groups.setdefault(stage_of(_top_key(path)), {})[path] = leaf
    return groups


def merge_groups(leaves: Mapping[str, Any], groups: Mapping[str, Mapping[str, Any]]) -> dict[str, Any]:
    """The inverse of :func:`group_tree`, in ``leaves``' order."""
    merged: dict[str, Any] = {}
    for sub in groups.values():
        merged.update(sub)
    return {path: merged[path] for path in leaves}


class StageTap:
    """The backward-time trigger of one stage's reduce (the JAX package's
    ``make_stage_tap``; see the module docstring): ``params`` is the
    stage's ``{path: parameter}``.  Armed for one backward by :meth:`arm`,
    which registers a post-accumulate hook on each of them, and
    :meth:`release` removes the hooks after it; :meth:`finish` reduces the
    stage if its trigger has not fired (a parameter that got no gradient
    counts as a zero one, as in the JAX step)."""

    def __init__(self, stage: str, plan: CommPlan, config: CommConfig, axis,
                 params: Mapping[str, torch.nn.Parameter], hierarchy: Hierarchy | None = None):
        self.stage = stage
        self.buckets = plan.stage_buckets(stage)
        self.config, self.axis, self.hierarchy = config, axis, hierarchy
        self.params = dict(params)
        planned = {leaf.path for b in self.buckets for leaf in b.leaves}
        self.unplanned = [path for path in self.params if path not in planned]
        topology = None if hierarchy is None else hierarchy.topology
        self.keys = [bucket_state_key(b, topology) for b in self.buckets]
        self.armed = False
        self.pending = 0
        self.res_in: dict[str, torch.Tensor] = {}
        self.res_out: dict[str, torch.Tensor] = {}
        self.sat: torch.Tensor | None = None
        self.probe = None
        self.handles: list = []

    def arm(self, comm_state: Mapping[str, torch.Tensor], probe=None) -> None:
        self.res_in = {k: comm_state[k] for k in self.keys if k in comm_state}
        self.res_out, self.sat, self.probe = {}, None, probe
        self.pending = len(self.params)
        self.armed = True
        self.handles = [p.register_post_accumulate_grad_hook(self._accumulated)
                        for p in self.params.values()]

    def release(self) -> None:
        for handle in self.handles:
            handle.remove()
        self.handles = []

    def _accumulated(self, param: torch.Tensor) -> None:
        if not self.armed:
            return
        self.pending -= 1
        if self.pending == 0:
            self._reduce()

    def _reduce(self) -> None:
        self.armed = False
        with torch.no_grad():
            for p in self.params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            local = {path: to_flax(p.grad) for path, p in self.params.items()}
            if self.probe is not None:
                self.probe.sum_sq += sum(g.float().square().sum() for g in local.values())
            out, self.res_out, self.sat = reduce_leaves(local, self.res_in, self.buckets,
                                                        self.config, self.axis, self.hierarchy)
            for path in self.unplanned:
                out[path] = self.axis.pmean(local[path])
            for path, g in local.items():
                g.copy_(out[path])

    def finish(self) -> None:
        if self.armed:
            self._reduce()


def make_overlap_grad_fn(plan: CommPlan, config: CommConfig, axis,
                         params: Mapping[str, torch.nn.Parameter],
                         hierarchy: Hierarchy | None = None) -> Callable:
    """``grad_fn(backward, comm_state, probe=None) -> (new_comm_state,
    saturated count)``: runs ``backward()`` with each stage's reduce issued
    inside it, leaving the reduced gradients in ``.grad``.  ``params`` is
    the model's ``{path: parameter}`` (``models/convert.py::flax_params``);
    the stages' hooks are on them only while ``backward()`` runs.  ``probe`` (a
    ``parallel/mesh.py::GradProbe``) gets the local square sums before each
    stage's reduce."""
    taps = [StageTap(stage, plan, config, axis, sub, hierarchy)
            for stage, sub in group_tree(params).items()]

    def grad_fn(backward: Callable[[], None], comm_state: Mapping[str, torch.Tensor], probe=None):
        for tap in taps:
            tap.arm(comm_state, probe)
        try:
            backward()
        except BaseException:
            for tap in taps:
                tap.armed = False
            raise
        finally:
            for tap in taps:
                tap.release()
        for tap in taps:
            tap.finish()
        new_comm = dict(comm_state)
        sat = None
        for tap in taps:
            new_comm.update(tap.res_out)
            if tap.sat is not None:
                sat = tap.sat if sat is None else sat + tap.sat
        if sat is None:
            sat = torch.zeros((), dtype=torch.float32)
        return new_comm, sat

    return grad_fn
