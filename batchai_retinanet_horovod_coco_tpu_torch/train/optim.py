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
  and clips the rest by their own norm, as ``optax.multi_transform`` does.

The ``"plateau"`` schedule is not ported yet (see ``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Iterable, Sequence

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
    schedule: str = "multistep"  # "multistep" | "cosine" | "constant"
    # Multistep: decay 10x at these fractions of total_steps (detectron 1x).
    milestones: tuple[float, ...] = (2 / 3, 8 / 9)
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
    if config.schedule == "plateau":
        raise NotImplementedError(
            "the plateau schedule is not ported yet; see ROADMAP.md"
        )
    if config.schedule == "constant":
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


class Optimizer:
    """The JAX chain over the model's parameters; see the module docstring.

    ``step(grad_norm)`` applies one update from the parameters' ``.grad``
    (a missing ``.grad`` counts as zero), with ``grad_norm`` the global norm
    of all the gradients, which the clip reuses unless the backbone is
    frozen.
    """

    def __init__(
        self, named_parameters: Iterable[tuple[str, torch.nn.Parameter]],
        config: OptimizerConfig,
    ):
        self.config = config
        self.schedule = make_schedule(config)
        self.params = [
            p for name, p in named_parameters
            if not (config.freeze_backbone and name.split(".")[0] == "backbone")
        ]
        lr = self.schedule(0)
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

    def step(self, grad_norm: torch.Tensor) -> None:
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
        self.inner.step()
        self.count += 1


def make_optimizer(
    model: torch.nn.Module, config: OptimizerConfig
) -> tuple[Optimizer, Schedule]:
    """(optimizer, schedule) over ``model``'s parameters; the schedule is
    returned separately for logging."""
    optimizer = Optimizer(model.named_parameters(), config)
    return optimizer, optimizer.schedule
