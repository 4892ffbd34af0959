"""The train state, as the JAX package's ``train/state.py``.

JAX keeps params, BatchNorm statistics, optimizer state and the step count
in one pytree.  Here the model holds its parameters and, as buffers, its
BatchNorm statistics; the optimizer holds its own state; the state adds the
step count.
"""

from __future__ import annotations

import dataclasses

import torch

from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: optim.Optimizer
    schedule: optim.Schedule
    step: int = 0

    def apply_gradients(self, grad_norm: torch.Tensor) -> None:
        """One optimizer update from the parameters' gradients;
        ``grad_norm`` is their global norm, which the clip reuses."""
        self.optimizer.step(grad_norm)
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
