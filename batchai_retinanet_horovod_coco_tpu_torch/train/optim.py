"""Optimizer and learning-rate schedule, as the JAX package's ``train/optim.py``.

The JAX chain is ``clip → add_decayed_weights → sgd(momentum)`` (or
``clip → adam``), optionally wrapped so the backbone gets no update.  Here:

- the schedule is a plain function of the update count, with optax's
  formulas (linear warmup, then constant, cosine or multistep, rebased to
  the end of warmup as ``optax.join_schedules`` does);
- the clip scales the gradients by ``max_norm / max(norm, max_norm)`` with
  the global norm that the step has already computed;
- decayed weights and momentum are ``torch.optim.SGD(momentum=0.9,
  dampening=0, weight_decay=wd)``: optax's trace ``g + 0.9 trace`` with
  ``g + wd p`` added first.  Decay applies to every trained parameter,
  biases and norm scales included, as in the JAX chain;
- ``freeze_backbone`` gives the backbone no update (no decay, no momentum)
  and clips the rest by their own norm, as ``optax.multi_transform`` does;
- the ``"plateau"`` schedule is a flat base LR times the scale of
  :class:`Plateau`, the port of ``optax.contrib.reduce_on_plateau``, which
  the JAX chain appends last and feeds each step's loss.  Its state stays
  in device tensors, so no step reads the loss back to the host.

:meth:`Optimizer.optax_leaves` gives the optimizer's state as the leaves of
the JAX chain's optax state (their key paths and flatten order), the
optimizer half of the checkpoint format shared with the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable, Mapping, Sequence
from typing import NamedTuple

import torch

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "sgd"  # "sgd" | "adam"
    base_lr: float = 0.01  # per-256-global-batch for sgd (detectron rule)
    # Linear-scaling rule: effective lr = base_lr * global_batch / 256 for
    # sgd, or base_lr * world_size for adam.
    global_batch_size: int = 16
    world_size: int = 1
    warmup_steps: int = 500
    total_steps: int = 90_000
    schedule: str = "multistep"  # "multistep" | "cosine" | "constant" | "plateau"
    # Multistep: decay 10x at these fractions of total_steps (detectron 1x).
    milestones: tuple[float, ...] = (2 / 3, 8 / 9)
    # "plateau": ReduceLROnPlateau on the training loss.  The mean loss of
    # each ``plateau_window`` steps is compared with the best so far; after
    # ``plateau_patience`` windows without an improvement of more than
    # ``plateau_min_delta`` the LR scale is multiplied by ``plateau_factor``.
    plateau_factor: float = 0.1
    plateau_patience: int = 2
    plateau_window: int = 1000
    plateau_min_delta: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_global_norm: float = 10.0
    freeze_backbone: bool = False


def peak_lr(config: OptimizerConfig) -> float:
    if config.optimizer == "adam":
        return config.base_lr * config.world_size
    return config.base_lr * config.global_batch_size / 256.0


def _linear(init: float, end: float, steps: int) -> Schedule:
    """``optax.linear_schedule``."""

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def make_schedule(config: OptimizerConfig) -> Schedule:
    """LR as a function of the update count (0 for the first update)."""
    peak = peak_lr(config)
    # "plateau": the base LR is flat; Plateau's scale supplies the decay.
    if config.schedule in ("constant", "plateau"):
        def after(count: int) -> float:
            return peak
    elif config.schedule == "cosine":
        horizon = max(1, config.total_steps - config.warmup_steps)

        def after(count: int) -> float:  # optax.cosine_decay_schedule, alpha 0
            return peak * (0.5 * (1.0 + math.cos(math.pi * min(count, horizon) / horizon)))
    elif config.schedule == "multistep":
        # Boundaries relative to the end of warmup, so that the milestones
        # land at their global step; optax's piecewise_constant_schedule
        # scales from the boundary step on.
        boundaries = sorted(
            {int(m * config.total_steps) - config.warmup_steps for m in config.milestones}
        )

        def after(count: int) -> float:
            value = peak
            for boundary in boundaries:
                if count >= boundary:
                    value *= 0.1
            return value
    else:
        raise ValueError(f"unknown schedule: {config.schedule!r}")
    if config.warmup_steps <= 0:
        return after
    warmup = _linear(peak / max(1, config.warmup_steps), peak, config.warmup_steps)

    def joined(count: int) -> float:  # optax.join_schedules
        if count < config.warmup_steps:
            return warmup(count)
        return after(count - config.warmup_steps)

    return joined


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all the tensors together (f32)."""
    tensors = [t.float() for t in tensors]
    if not tensors:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_precomputed(
    grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor
) -> None:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, with
    ``norm`` the global norm the caller has already computed."""
    scale = max_norm / torch.clamp_min(norm, max_norm)
    torch._foreach_mul_(list(grads), scale)


class Plateau:
    """``optax.contrib.reduce_on_plateau`` as the JAX chain configures it:
    ``rtol`` 0, ``atol = max(min_delta, 1e-12)``, ``accumulation_size`` the
    window, cooldown 0, ``min_scale`` 0.

    ``update(value)`` folds one step's loss into the window's running mean;
    when the window is full the mean is compared with the best so far and
    the scale drops by ``factor`` after ``patience`` windows without an
    improvement.  It returns the scale of this step's update.  The state is
    six 0-dim tensors on ``device``, named and ordered as optax's
    ``ReduceLROnPlateauState`` (``cooldown_count`` stays 0: with no
    cooldown optax never sets it).
    """

    FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count", "avg_value")

    def __init__(self, config: OptimizerConfig, device: torch.device):
        self.factor = config.plateau_factor
        self.patience = config.plateau_patience
        self.window = config.plateau_window
        self.atol = max(config.plateau_min_delta, 1e-12)
        f32, i32 = torch.float32, torch.int32
        self.state = {
            "scale": torch.ones((), dtype=f32, device=device),
            "best_value": torch.full((), math.inf, dtype=f32, device=device),
            "plateau_count": torch.zeros((), dtype=i32, device=device),
            "cooldown_count": torch.zeros((), dtype=i32, device=device),
            "count": torch.zeros((), dtype=i32, device=device),
            "avg_value": torch.zeros((), dtype=f32, device=device),
        }

    def update(self, value: torch.Tensor) -> torch.Tensor:
        s = self.state
        count = s["count"] + 1
        avg = (s["count"] * s["avg_value"] + value.to(torch.float32)) / count
        full = count == self.window
        improved = avg < s["best_value"] - self.atol
        plateau = torch.where(improved, 0, s["plateau_count"] + 1)
        reduce = plateau == self.patience
        s["best_value"] = torch.where(full & improved, avg, s["best_value"])
        s["plateau_count"] = torch.where(full, torch.where(reduce, 0, plateau), s["plateau_count"])
        s["scale"] = torch.where(full & reduce, s["scale"] * self.factor, s["scale"])
        s["count"] = torch.where(full, 0, count).to(torch.int32)
        s["avg_value"] = torch.where(full, 0.0, avg)
        return s["scale"]


class OptaxLeaf(NamedTuple):
    """One leaf of the optax state: its key path under ``opt_state``, and
    how to read it (a torch tensor) and write it (from a tensor)."""

    path: str
    read: Callable[[], torch.Tensor]
    write: Callable[[torch.Tensor], None]


class Optimizer:
    """The JAX chain over the model's parameters; see the module docstring.

    ``step(grad_norm, loss)`` applies one update from the parameters'
    ``.grad`` (a missing ``.grad`` counts as zero), with ``grad_norm`` the
    global norm of all the gradients, which the clip reuses unless the
    backbone is frozen; ``loss`` (a device scalar) feeds the plateau
    schedule.
    """

    def __init__(
        self, named_parameters: Iterable[tuple[str, torch.nn.Parameter]],
        config: OptimizerConfig,
    ):
        self.config = config
        self.schedule = make_schedule(config)
        named = [
            (name, p) for name, p in named_parameters
            if not (config.freeze_backbone and name.split(".")[0] == "backbone")
        ]
        self.names = [name for name, _ in named]
        self.params = [p for _, p in named]
        device = self.params[0].device if self.params else torch.device("cpu")
        self.plateau = Plateau(config, device) if config.schedule == "plateau" else None
        lr = self.schedule(0)
        # sgd with momentum 0: optax still keeps a trace, the last update
        # (the clipped gradient plus the decay term); torch's SGD keeps none.
        self.trace = None
        if config.optimizer == "sgd" and config.momentum == 0:
            self.trace = [torch.zeros_like(p) for p in self.params]
        if config.optimizer == "sgd":
            self.inner = torch.optim.SGD(
                self.params, lr=lr, momentum=config.momentum, dampening=0.0,
                weight_decay=config.weight_decay,
            )
        elif config.optimizer == "adam":
            self.inner = torch.optim.Adam(self.params, lr=lr)
        else:
            raise ValueError(f"unknown optimizer: {config.optimizer!r}")
        self.count = 0

    def step(self, grad_norm: torch.Tensor, loss: torch.Tensor | None = None) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        # The frozen chain clips the trained parameters by their own norm:
        # the step's norm also counts the frozen backbone's gradients.
        norm = global_norm(grads) if self.config.freeze_backbone else grad_norm
        clip_by_global_norm_precomputed(grads, self.config.clip_global_norm, norm)
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        if self.trace is not None:
            with torch.no_grad():
                self.trace = torch._foreach_add(grads, self.params, alpha=self.config.weight_decay)
        if self.plateau is None:
            self.inner.step()
        else:
            if loss is None:
                raise ValueError("the plateau schedule needs each step's loss")
            with torch.no_grad():
                before = torch._foreach_mul(self.params, 1.0)
                self.inner.step()
                # The scale multiplies the chain's whole update, as optax's
                # reduce_on_plateau does last in the JAX chain: p = p_before
                # + scale * (p - p_before).
                scale = self.plateau.update(loss.detach())
                torch._foreach_sub_(self.params, before)
                torch._foreach_mul_(self.params, scale)
                torch._foreach_add_(self.params, before)
        self.count += 1

    def optax_leaves(self, param_keys: Mapping[str, str]) -> list[OptaxLeaf]:
        """The state as the leaves of ``make_optimizer(config)[0].init(params)``
        of the JAX package, in its flatten order; ``param_keys`` maps each
        parameter name to its key path within the params tree, in the
        params tree's flatten order.

        SGD: torch's ``momentum_buffer`` is optax's ``trace`` (a buffer
        not made yet, before the first step, is a zero trace), or with
        momentum 0 the kept last update, and ``count`` the schedule's
        count.  Adam: ``exp_avg``, ``exp_avg_sq``
        and ``step`` are ``mu``, ``nu`` and ``count``.  ``freeze_backbone``
        nests them under the ``multi_transform`` state of the trained
        branch, and the plateau schedule under ``[0]`` beside the plateau
        state ``[1]``.
        """
        config = self.config
        prefix = ".inner_states['trained'].inner_state" if config.freeze_backbone else ""
        if self.plateau is not None:
            prefix = "[0]" + prefix
        rank = {name: i for i, name in enumerate(param_keys)}
        order = sorted(range(len(self.params)), key=lambda i: rank[self.names[i]])
        state = self.inner.state

        def count_leaf(path: str, on_write: Callable[[int], None] | None = None) -> OptaxLeaf:
            def write(value: torch.Tensor) -> None:
                self.count = int(value)
                if on_write is not None:
                    on_write(self.count)

            return OptaxLeaf(path, lambda: torch.tensor(self.count, dtype=torch.int32), write)

        def slot_leaves(path: str, key: str) -> list[OptaxLeaf]:
            leaves = []
            for i in order:
                p = self.params[i]

                def read(p=p) -> torch.Tensor:
                    return state[p][key] if key in state[p] else torch.zeros_like(p)

                def write(value: torch.Tensor, p=p) -> None:
                    state[p][key] = value.to(device=p.device, dtype=p.dtype).clone()

                leaves.append(OptaxLeaf(path + param_keys[self.names[i]], read, write))
            return leaves

        def trace_leaves(path: str) -> list[OptaxLeaf]:
            def write(value: torch.Tensor, i: int) -> None:
                p = self.params[i]
                self.trace[i] = value.to(device=p.device, dtype=p.dtype).clone()

            return [
                OptaxLeaf(path + param_keys[self.names[i]], lambda i=i: self.trace[i],
                          lambda value, i=i: write(value, i))
                for i in order
            ]

        if config.optimizer == "sgd" and self.trace is not None:
            leaves = trace_leaves(prefix + "[1][1][0].trace")
            leaves.append(count_leaf(prefix + "[1][1][1].count"))
        elif config.optimizer == "sgd":
            leaves = slot_leaves(prefix + "[1][1][0].trace", "momentum_buffer")
            leaves.append(count_leaf(prefix + "[1][1][1].count"))
        else:
            def set_steps(count: int) -> None:
                for p in self.params:
                    state[p]["step"] = torch.tensor(float(count), dtype=torch.float32)

            leaves = [count_leaf(prefix + "[1][0].count", set_steps)]
            leaves += slot_leaves(prefix + "[1][0].mu", "exp_avg")
            leaves += slot_leaves(prefix + "[1][0].nu", "exp_avg_sq")
            leaves.append(count_leaf(prefix + "[1][1].count"))
        if self.plateau is not None:
            for field in Plateau.FIELDS:
                def write(value: torch.Tensor, field=field) -> None:
                    like = self.plateau.state[field]
                    self.plateau.state[field] = value.to(device=like.device, dtype=like.dtype).clone()

                leaves.append(OptaxLeaf(f"[1].{field}", lambda field=field: self.plateau.state[field], write))
        return leaves


def plateau_scale(optimizer: Optimizer) -> float | None:
    """The plateau schedule's current LR scale (None without one); reads a
    device scalar back, so call it at log time only."""
    if optimizer.plateau is None:
        return None
    return float(optimizer.plateau.state["scale"])


def make_optimizer(
    model: torch.nn.Module, config: OptimizerConfig
) -> tuple[Optimizer, Schedule]:
    """(optimizer, schedule) over ``model``'s parameters; the schedule is
    returned separately for logging."""
    optimizer = Optimizer(model.named_parameters(), config)
    return optimizer, optimizer.schedule
