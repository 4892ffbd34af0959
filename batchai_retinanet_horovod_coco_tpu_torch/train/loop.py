"""The training loop, as the JAX package's ``train/loop.py::run_training``
on one process.

In order: restore the latest valid checkpoint (``resume``); prefetch host
batches to the device; run the step of each batch's shape bucket (one step
is built per bucket); every ``log_every`` steps (and at the last) read the
metrics back, check them and log them; save every ``checkpoint_every``
steps; evaluate every ``eval_every`` steps, in line or, with
``async_eval``, on a snapshot of the weights in a background thread; at
the end, join the eval in flight, run a final synchronous eval and a final
save.  A non-finite ``loss`` or ``param_norm`` raises
``FloatingPointError``, checked at every log and before every save, so a
poisoned state never reaches disk.  On an error the eval in flight is
reaped and the checkpoint writer closed without masking the error.

The JAX loop's numerics recorder and its NaN provenance dump are not
ported (``ROADMAP.md``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import threading
import time
import warnings
from collections.abc import Callable, Iterable, Iterator
from typing import Any

import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch
from batchai_retinanet_horovod_coco_tpu_torch.data.prefetch import prefetch_map
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import to_device_images
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.train.state import TrainState
from batchai_retinanet_horovod_coco_tpu_torch.train.step import make_train_step
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import Staged, stage, take

# Metrics whose non-finite value stops the run: the loss of the step, and
# the norm of the parameters its update produced.
_SENTINEL_METRICS = ("loss", "param_norm")
# With log_every 0 the loss is still checked at this cadence.
_FINITE_CHECK_EVERY = 100
_STEP_ARRAYS = ("images", "gt_boxes", "gt_labels", "gt_mask")

EvalFn = Callable[[torch.nn.Module], dict[str, float]]
Log = Callable[[int, dict[str, float]], None]


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    total_steps: int = 1000
    log_every: int = 20  # 0 = read the metrics at the last step only
    checkpoint_every: int = 0  # 0 = no checkpoints
    eval_every: int = 0  # 0 = eval only at the end (if eval_fn is given)
    checkpoint_dir: str | None = None
    resume: bool = True  # restore the latest valid checkpoint if there is one
    max_to_keep: int = 3
    # A torch.profiler trace of steps [profile_start_step,
    # profile_start_step + profile_steps), clamped into the run's steps,
    # written under profile_dir.
    profile_dir: str | None = None
    profile_start_step: int = 10
    profile_steps: int = 5
    # Batches copied to the device this many steps ahead by a background
    # thread; 0 copies each in line.
    device_prefetch: int = 2
    # Mid-run evals on a snapshot of the weights in a background thread;
    # the final eval stays synchronous.
    async_eval: bool = False
    # Recorded in every checkpoint manifest.
    ckpt_metadata: dict | None = None


def device_batch(batch: Batch, device: torch.device) -> dict[str, torch.Tensor]:
    """The arrays of a host ``Batch`` that the step reads, on ``device``."""
    return {name: to_device_images(getattr(batch, name), device) for name in _STEP_ARRAYS}


def _prefetch_to_device(
    batches: Iterable[Batch], device: torch.device, depth: int
) -> Iterator[tuple[tuple[int, ...], Staged]]:
    """``(images shape, staged arrays)`` of each batch, ``depth`` ahead: the
    prefetch thread pins the arrays and starts their copy on a side stream
    (``utils/device.py::stage``); the step takes them with ``take``."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return prefetch_map(
        batches,
        lambda b: (b.images.shape, stage({k: getattr(b, k) for k in _STEP_ARRAYS}, device, stream)),
        depth=depth,
        thread_name="device-prefetch",
    )


def _print_log(step: int, scalars: dict[str, float]) -> None:
    print(json.dumps({"step": step, **scalars}), flush=True)


def _eval_scalars(metrics: dict[str, float]) -> dict[str, float]:
    """Eval metrics under the JAX package's ``eval`` prefix."""
    return {f"eval/{k}": float(v) for k, v in metrics.items()}


class _AsyncEvalRunner:
    """Runs the mid-run eval hook in a background thread on a snapshot of
    the weights, so the steps keep flowing while the eval runs.

    The snapshot is a second copy of the model (parameters and buffers; the
    optimizer's state is not copied, eval does not read it), made once and
    refreshed at each launch.  The step updates the live parameters in
    place, so the refresh is a device copy queued on the training stream
    before the next step; the eval runs on its own stream, which first
    waits on an event recorded after the copy.  At most one eval is in
    flight: a launch joins the previous one first.  The hook's exception
    re-raises in the loop at the next drain or join; completed ``(step,
    metrics)`` pairs are logged from the loop's thread, in step order.
    """

    def __init__(self, eval_fn: EvalFn, log: Log, device: torch.device):
        self._eval_fn = eval_fn
        self._log = log
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._snapshot: torch.nn.Module | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._done: list[tuple[int, dict[str, float]]] = []
        self._lock = threading.Lock()

    def launch(self, model: torch.nn.Module, step: int) -> None:
        self.join()  # one in flight; also surfaces a failure
        if self._snapshot is None:
            self._snapshot = copy.deepcopy(model).requires_grad_(False).eval()
        snapshot = self._snapshot
        with torch.no_grad():
            for dst, src in zip(snapshot.state_dict().values(), model.state_dict().values()):
                dst.copy_(src)
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record()

        def run() -> None:
            try:
                if self._stream is None:
                    metrics = self._eval_fn(snapshot)
                else:
                    with torch.cuda.stream(self._stream):
                        self._stream.wait_event(ready)
                        metrics = self._eval_fn(snapshot)
                    # The snapshot is refreshed in place at the next launch.
                    self._stream.synchronize()
                with self._lock:
                    self._done.append((step, metrics))
            except BaseException as exc:  # surfaced at the next drain or join
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True, name="async-eval")
        self._thread.start()

    def drain(self) -> None:
        """Log the finished evals (loop thread); re-raise a failed one."""
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("async eval hook failed") from error
        with self._lock:
            done, self._done = self._done, []
        for step, metrics in done:
            self._log(step, _eval_scalars(metrics))

    def join(self) -> None:
        """Wait for the eval in flight, if any, then drain."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.drain()

    def finalize_on_error(self) -> None:
        """The loop is unwinding with another exception: join the eval in
        flight and log what finished, but warn instead of raising."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        try:
            self.drain()
        except Exception as exc:
            warnings.warn(f"async eval failed during loop unwind: {exc!r}")


def _check_finite(scalars: dict[str, float], step: int, cadence: str) -> None:
    for name in _SENTINEL_METRICS:
        if name in scalars and not math.isfinite(scalars[name]):
            raise FloatingPointError(
                f"non-finite {name} ({scalars[name]}) at or before step {step} (checked {cadence})"
            )


def run_training(
    state: TrainState,
    batches: Iterable[Batch],
    num_classes: int,
    config: LoopConfig,
    loss_config: losses_lib.LossConfig = losses_lib.LossConfig(),
    matching_config: matching_lib.MatchingConfig = matching_lib.MatchingConfig(),
    anchor_config: anchors_lib.AnchorConfig | None = None,
    log: Log = _print_log,
    eval_fn: EvalFn | None = None,
) -> TrainState:
    """Run ``state`` on to step ``config.total_steps``; returns the state.

    ``log(step, scalars)`` receives the metrics of each logged step with
    ``images_per_sec``, ``step_time_ms`` and ``data_wait_ms`` (the host's
    wait for the next batch) over the window since the last log (host
    clock, ending in the metrics read), and the step's ``lr`` (times the
    plateau scale, with that schedule).  ``eval_fn(model) -> metrics`` is
    called every ``eval_every`` steps and at the end, with the live model
    or, for an asynchronous eval, a snapshot; its metrics are logged under
    ``eval/`` names.
    """
    device = next(state.model.parameters()).device
    ckpt = None
    if config.checkpoint_every and config.checkpoint_dir:
        ckpt = CheckpointManager(
            config.checkpoint_dir,
            max_to_keep=config.max_to_keep,
            save_interval_steps=config.checkpoint_every,
            metadata=config.ckpt_metadata,
        )
        if config.resume and ckpt.latest_step() is not None:
            try:
                ckpt.restore(state)
            except Exception as e:
                raise RuntimeError(
                    f"restoring {config.checkpoint_dir} failed (root cause chained): a shape "
                    "mismatch means another model or optimizer was checkpointed there; "
                    "otherwise every checkpoint in it is torn (ckpt_torn_skipped on stderr)"
                ) from e
            print(f"resumed from step {state.step}", flush=True)

    step_fns: dict[tuple[int, int], Callable[..., dict[str, Any]]] = {}
    start_step = state.step
    last_saved: int | None = None
    # The profile window, clamped into the steps this run takes.
    prof_start = min(
        max(config.profile_start_step, start_step + 1),
        max(start_step + 1, config.total_steps - config.profile_steps + 1),
    )
    prof_end = min(config.total_steps, prof_start + config.profile_steps - 1)
    profiler = None
    eval_runner = _AsyncEvalRunner(eval_fn, log, device) if config.async_eval and eval_fn else None
    window_t0, window_images, window_steps, window_wait = time.perf_counter(), 0, 0, 0.0
    check_every = config.log_every or _FINITE_CHECK_EVERY
    cadence = f"every {check_every} steps and before each checkpoint save"
    it = _prefetch_to_device(batches, device, config.device_prefetch)
    try:
        for step in range(start_step + 1, config.total_steps + 1):
            if eval_runner is not None:
                eval_runner.drain()
            t_data = time.perf_counter()
            shape, staged = next(it)
            arrays = take(staged)
            window_wait += time.perf_counter() - t_data
            hw = tuple(shape[1:3])
            step_fn = step_fns.get(hw)
            if step_fn is None:
                step_fn = step_fns[hw] = make_train_step(
                    state.model, hw, num_classes, loss_config, matching_config,
                    anchor_config, device,
                )
            if config.profile_dir and step == prof_start:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            metrics = step_fn(state, arrays)
            if profiler is not None and step == prof_end:
                if device.type == "cuda":  # the training stream only: not an eval in flight
                    torch.cuda.current_stream(device).synchronize()
                profiler.stop()
                os.makedirs(config.profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(config.profile_dir, f"trace-steps-{prof_start}-{prof_end}.json")
                )
                profiler = None
            window_images += shape[0]
            window_steps += 1

            is_log = (config.log_every and step % config.log_every == 0) or step == config.total_steps
            will_save = ckpt is not None and ckpt.should_save(step)
            if not is_log and (will_save or step % check_every == 0):
                _check_finite({k: float(metrics[k]) for k in _SENTINEL_METRICS}, step, cadence)
            if is_log:
                scalars = {k: float(v) for k, v in metrics.items()}
                _check_finite(scalars, step, cadence)
                dt = time.perf_counter() - window_t0
                scalars["images_per_sec"] = window_images / max(dt, 1e-9)
                scalars["step_time_ms"] = dt / window_steps * 1e3
                scalars["data_wait_ms"] = window_wait / window_steps * 1e3
                scalars["lr"] = state.schedule(step - 1)
                scale = optim.plateau_scale(state.optimizer)
                if scale is not None:
                    scalars["lr"] *= scale
                log(step, scalars)
                window_t0, window_images, window_steps, window_wait = time.perf_counter(), 0, 0, 0.0

            if will_save and ckpt.save(state, step=step):
                last_saved = step

            if eval_fn is not None and config.eval_every and step % config.eval_every == 0 \
                    and step < config.total_steps:
                if eval_runner is not None:
                    eval_runner.launch(state.model, step)
                else:
                    log(step, _eval_scalars(eval_fn(state.model)))
                    # The eval's time stays out of the next window's step time.
                    window_t0, window_images, window_steps, window_wait = time.perf_counter(), 0, 0, 0.0
    except BaseException:
        # Reap the eval in flight and let the write in flight land, warning
        # of their failures instead of raising: neither may mask this one.
        if eval_runner is not None:
            eval_runner.finalize_on_error()
        if ckpt is not None:
            try:
                ckpt.close()
            except Exception as ckpt_exc:
                warnings.warn(f"checkpoint writer close failed during loop unwind: {ckpt_exc!r}")
        raise
    finally:
        if profiler is not None:
            profiler.stop()
        it.close()  # stops the prefetch thread

    final_step = max(start_step, config.total_steps)
    if eval_runner is not None:
        eval_runner.join()  # logged before the final eval, in step order
    if eval_fn is not None:
        log(final_step, _eval_scalars(eval_fn(state.model)))
    if ckpt is not None:
        if last_saved != final_step:
            ckpt.save(state, step=final_step, force=True)
        ckpt.close()
    return state
