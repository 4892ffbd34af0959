"""The training loop's core, as the JAX package's ``train/loop.py::run_training``.

Host batches go to the device, the step of their shape bucket runs (one
step is built per bucket), and every ``log_every`` steps (and at the last)
the metrics are read back, checked and logged.  A non-finite ``loss`` or
``param_norm`` at that check raises ``FloatingPointError``.  The JAX loop's
device prefetch, asynchronous eval, checkpoints, profiling window, numerics
recorder and its command line are not ported yet (see ``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from collections.abc import Callable, Iterable
from typing import Any

import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import to_device_images
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.train.state import TrainState
from batchai_retinanet_horovod_coco_tpu_torch.train.step import make_train_step

# Metrics whose non-finite value stops the run: the loss of the step, and
# the norm of the parameters its update produced.
_SENTINEL_METRICS = ("loss", "param_norm")


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    total_steps: int = 1000
    log_every: int = 20  # 0 = read the metrics at the last step only


def device_batch(batch: Batch, device: torch.device) -> dict[str, torch.Tensor]:
    """The arrays of a host ``Batch`` that the step reads, on ``device``."""
    return {
        name: to_device_images(getattr(batch, name), device)
        for name in ("images", "gt_boxes", "gt_labels", "gt_mask")
    }


def _print_log(step: int, scalars: dict[str, float]) -> None:
    print(json.dumps({"step": step, **scalars}), flush=True)


def run_training(
    state: TrainState,
    batches: Iterable[Batch],
    num_classes: int,
    config: LoopConfig,
    loss_config: losses_lib.LossConfig = losses_lib.LossConfig(),
    matching_config: matching_lib.MatchingConfig = matching_lib.MatchingConfig(),
    anchor_config: anchors_lib.AnchorConfig | None = None,
    log: Callable[[int, dict[str, float]], None] = _print_log,
) -> TrainState:
    """Run ``state`` on to step ``config.total_steps``; returns the state.

    ``log(step, scalars)`` receives the metrics of each logged step with
    ``images_per_sec`` and ``step_time_ms`` over the window since the last
    log (host clock, ending in the metrics read) and the ``lr`` of the step.
    """
    device = next(state.model.parameters()).device
    step_fns: dict[tuple[int, int], Callable[..., dict[str, Any]]] = {}
    it = iter(batches)
    window_t0, window_images, window_steps = time.perf_counter(), 0, 0
    for step in range(state.step + 1, config.total_steps + 1):
        batch = next(it)
        hw = tuple(batch.images.shape[1:3])
        step_fn = step_fns.get(hw)
        if step_fn is None:
            step_fn = step_fns[hw] = make_train_step(
                state.model, hw, num_classes, loss_config, matching_config,
                anchor_config, device,
            )
        metrics = step_fn(state, device_batch(batch, device))
        window_images += batch.images.shape[0]
        window_steps += 1
        if not (
            (config.log_every and step % config.log_every == 0)
            or step == config.total_steps
        ):
            continue
        scalars = {k: float(v) for k, v in metrics.items()}
        for name in _SENTINEL_METRICS:
            if not math.isfinite(scalars[name]):
                raise FloatingPointError(
                    f"non-finite {name} ({scalars[name]}) at or before step {step} "
                    f"(checked every {config.log_every or config.total_steps} steps)"
                )
        dt = time.perf_counter() - window_t0
        scalars["images_per_sec"] = window_images / max(dt, 1e-9)
        scalars["step_time_ms"] = dt / window_steps * 1e3
        scalars["lr"] = state.schedule(step - 1)
        log(step, scalars)
        window_t0, window_images, window_steps = time.perf_counter(), 0, 0
    return state
