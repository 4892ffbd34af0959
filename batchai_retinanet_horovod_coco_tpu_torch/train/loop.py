"""The training loop, as the JAX package's ``train/loop.py::run_training``,
on one process or as one rank of a data-parallel world.

In order: restore the latest valid checkpoint (``resume``); prefetch host
batches to the device; run the step of each batch's shape bucket (one step
is built per bucket); every ``log_every`` steps (and at the last) read the
metrics back, check them and log them; save every ``checkpoint_every``
steps; evaluate every ``eval_every`` steps, in line or, with
``async_eval``, on a snapshot of the weights in a background thread; at
the end, join the eval in flight, run a final synchronous eval and a final
save.  A non-finite ``loss`` or ``param_norm`` raises
``NonFiniteError``, checked at every log and before every save, so a
poisoned state never reaches disk; before it raises, the provenance pass
of ``obs/numerics.py`` writes ``NUMERICS_DUMP.json`` (the tripped step's
image ids, the first non-finite layer, parameter and metric) into
``numerics_dump_dir`` or the trace directory.  On an error the eval in
flight is reaped and the checkpoint writer closed without masking the
error.

Observability, as the JAX loop: the spans ``data_wait``, ``step``,
``metrics_fetch``, ``eval``, ``final_eval``, ``ckpt_restore`` and
``async_eval``; the ``train-loop`` and ``async-eval`` heartbeats; and, at
the log cadence only, the telemetry record sites (``record_train_window``,
``record_compile``, ``record_numerics``) and a ``numerics`` event with the
summary of ``LoopConfig.numerics``.

In a world (``world``, ``launch/pod.py::World``) each rank feeds its shard
of every global batch to the world's step (``train/step.py``); the metrics
it reads are the world's (the mean loss over the ranks), so a non-finite
one stops every rank at the same step.  ``images_per_sec`` counts the
global batch.  Rank 0 alone logs and writes checkpoints; every rank
restores the same step.  The provenance dump names the image ids of the
global batch, gathered from the ranks, and rank 0 writes it.  An
``async_eval`` falls back to a synchronous one, with a warning: an eval
thread's gather of detections could interleave with the steps'
all-reduces.

``LoopConfig.spatial_shards`` > 1 selects the spatially partitioned step
(``train/step.py::make_train_step_spatial``, exclusive with the
gradient-communication flavors): each rank's batch is then its data
index's, the whole images, of which the step trains on its rows.

``LoopConfig.comm``, ``shard_weight_update`` and ``topology`` select the
gradient-communication flavors of the world's step (``train/step.py``);
the state comes from ``create_train_state`` with the same flags, so its
``comm_state`` (the EF residuals) and its optimizer's layout go into the
step and out of it, and through the checkpoints.  Each flavor needs a
world.  The EF health (``ef_residual_norm``, ``ef_saturation``,
``comm_compressed_bytes``, and per hop ``comm_ici_bytes``,
``comm_dcn_bytes``, ``ef_residual_norm_dcn``) reaches
``telemetry.record_comm`` at the log cadence, with the window's step count.
An eval reads the model alone: neither the optimizer's state nor the
residuals are copied into its snapshot.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys
import threading
import warnings
from collections.abc import Callable, Iterable, Iterator
from typing import Any

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch, normalize_images
from batchai_retinanet_horovod_coco_tpu_torch.data.prefetch import prefetch_map
from batchai_retinanet_horovod_coco_tpu_torch.obs import numerics as numerics_lib
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry, trace, watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import device_memory_stats
from batchai_retinanet_horovod_coco_tpu_torch.obs.trace import monotonic_s
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim
from batchai_retinanet_horovod_coco_tpu_torch.train.state import TrainState
from batchai_retinanet_horovod_coco_tpu_torch.train.step import (
    make_train_step,
    make_train_step_spatial,
)
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import Staged, stage, take, to_device_images

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
    # The in-step numerics summary (obs/numerics.py) in each step's
    # metrics.  The NaN provenance dump on a tripped finite-check is always
    # armed: it lands in numerics_dump_dir, else the trace directory, else
    # only the exception names the first non-finite value.
    numerics: bool = False
    numerics_dump_dir: str | None = None
    rng_seed: int | None = None  # recorded in the dump
    # The gradient-communication policy (comm/config.py::CommConfig), the
    # ZeRO weight update, and the two-level topology (parallel/mesh.py).
    comm: Any = None
    shard_weight_update: bool = False
    topology: Any = None
    # Spatial partitioning: each image's H over this many ranks of the world
    # (train/step.py::make_train_step_spatial), and its override of the JAX
    # data-axis envelope.
    spatial_shards: int = 1
    allow_data_axis_divergence: bool = False


def device_batch(batch: Batch, device: torch.device) -> dict[str, torch.Tensor]:
    """The arrays of a host ``Batch`` that the step reads, on ``device``."""
    return {name: to_device_images(getattr(batch, name), device) for name in _STEP_ARRAYS}


def _prefetch_to_device(
    batches: Iterable[Batch], device: torch.device, depth: int
) -> Iterator[tuple[tuple[int, ...], Any, Staged]]:
    """``(images shape, image ids, staged arrays)`` of each batch, ``depth``
    ahead: the prefetch thread pins the arrays and starts their copy on a
    side stream (``utils/device.py::stage``); the step takes them with
    ``take``."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return prefetch_map(
        batches,
        lambda b: (b.images.shape, b.image_ids,
                   stage({k: getattr(b, k) for k in _STEP_ARRAYS}, device, stream)),
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
            # Registered idle: an eval is minutes of legitimate silence,
            # and its liveness is witnessed by the components it starts
            # (its prefetch thread, driver and consumer).
            hb = watchdog.register("async-eval")
            hb.idle()
            try:
                with trace.span("async_eval", step=step):
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
            finally:
                hb.close()

        # watchdog: registers in run() at thread start.
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


class _Silent:
    """The ``log`` of a rank other than 0: records nothing."""

    def __call__(self, step: int, scalars: dict[str, float]) -> None:
        pass

    def event(self, kind: str, **fields) -> None:
        pass


class NonFiniteError(FloatingPointError):
    """A tripped finite-check: ``metric`` was non-finite at or before
    ``step``; ``dump_path`` is the ``NUMERICS_DUMP.json`` this trip wrote,
    or None when it wrote none."""

    def __init__(self, message: str, step: int, metric: str, dump_path: str | None):
        super().__init__(message)
        self.step, self.metric, self.dump_path = step, metric, dump_path


def _abort_nonfinite(
    name: str,
    value: float,
    step: int,
    cadence: str,
    *,
    model: torch.nn.Module,
    images: torch.Tensor,
    image_ids,
    metrics: dict[str, Any],
    config: LoopConfig,
    log: Log,
    world=None,
) -> None:
    """Raise ``NonFiniteError`` for a tripped finite-check, after the
    provenance pass (on the poisoned model and batch, where they lie) has
    written ONE ``NUMERICS_DUMP.json``.  A failing pass never replaces the
    error: it is printed as a ``numerics_dump_error`` line and chained as
    the error's cause.  In a world every rank trips at the same step: the
    dump holds the global batch's image ids, rank 0 writes it, and every
    rank's error names it once it has landed."""
    dump_path, first, dump_error = None, None, None
    if world is not None:
        image_ids = [int(i) for ids in world.all_gather(
            torch.as_tensor(np.asarray(image_ids, dtype=np.int64))) for i in ids.tolist()]
    writer = world is None or world.is_main
    try:
        dump = numerics_lib.provenance(
            step=step, metrics=metrics, model=model, images=images, image_ids=image_ids,
            rng_seed=config.rng_seed, tripped={"metric": name, "value": float(value)},
            cadence=cadence,
        )
        first = dump.get("first_nonfinite")
        # The file needs a configured home: a bare run gets the
        # localization in the message only.
        target_dir = config.numerics_dump_dir or trace.trace_dir()
        if target_dir and writer:
            dump_path = numerics_lib.write_dump(dump, target_dir)
        elif target_dir:
            dump_path = os.path.join(target_dir, numerics_lib.DUMP_NAME)
    except Exception as e:
        dump_error = e
        print(json.dumps({"event": "numerics_dump_error", "error": repr(e)[:500]}),
              file=sys.stderr, flush=True)
    if world is not None:
        world.barrier()
    # The trip lands on every read surface: the trace, the telemetry
    # counter (the nonfinite SLO rule), the run's event log.
    trace.instant("numerics_trip", metric=name, step=step, value=float(value))
    telemetry.record_nonfinite_trip(name)
    log_event = getattr(log, "event", None)
    if log_event is not None:
        try:
            log_event("numerics_trip", metric=name, step=step, value=float(value),
                      dump=dump_path, first_nonfinite=first)
        except Exception:
            pass  # a broken sink must not mask the abort
    located = f" (first non-finite: {first})" if first else ""
    if dump_path:
        where = f"provenance dump at {dump_path}{located}"
    elif first:
        where = (f"first non-finite: {first} (pass --obs-dir or --log-dir to keep the full "
                 f"{numerics_lib.DUMP_NAME})")
    else:
        where = "provenance dump failed — see numerics_dump_error on stderr"
    raise NonFiniteError(
        f"non-finite {name} ({float(value)}) at or before step {step} (checked {cadence}); {where}",
        step, name, dump_path,
    ) from dump_error


# What the ``cost_analysis`` instants count: torch's FlopCounterMode over
# the model's forward and backward (convolutions and matrix products, two
# operations a multiply-add); not XLA's cost analysis of the JAX step.
FLOPS_SOURCE = "torch_flop_counter"


def step_flops(model: torch.nn.Module, images_shape: tuple[int, ...]) -> float | None:
    """The FLOPs of a train step's forward and backward of ``model`` on
    uint8 images of ``images_shape``, counted by ``FlopCounterMode`` on
    meta tensors: nothing is computed, and the model's parameters, buffers
    and gradients are not touched (the counter's dispatch over the real
    step changed a bf16 convolution's weight gradient on the CPU).  None
    when the model cannot run on meta tensors: the report then carries no
    MFU rather than a guess."""
    from torch.func import functional_call
    from torch.utils.flop_counter import FlopCounterMode

    try:
        params = {n: torch.empty_like(p, device="meta").requires_grad_(p.requires_grad)
                  for n, p in model.named_parameters()}
        buffers = {n: torch.empty_like(b, device="meta") for n, b in model.named_buffers()}
        images = torch.empty(images_shape, dtype=torch.uint8, device="meta")
        counter = FlopCounterMode(display=False)
        with counter:
            outputs = functional_call(model, {**params, **buffers}, (normalize_images(images),))
            loss = sum(v.float().sum() for v in outputs.values())
            trainable = [p for p in params.values() if p.requires_grad]
            if trainable:
                torch.autograd.grad(loss, trainable)
    except Exception as e:  # the count must never stop a run
        warnings.warn(f"the step's FLOPs were not counted on meta tensors ({e!r}): no MFU")
        return None
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None


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
    world=None,
) -> TrainState:
    """Run ``state`` on to step ``config.total_steps``; returns the state.

    ``log(step, scalars)`` receives the metrics of each logged step with
    ``images_per_sec``, ``step_time_ms`` and ``data_wait_ms`` (the host's
    wait for the next batch) over the window since the last log (host
    clock, ending in the metrics read), and the step's ``lr`` (times the
    plateau scale, with that schedule).  A ``log`` with an ``event(kind,
    **fields)`` method (``obs/events.py::EventSink``'s) also receives the
    ``numerics`` and ``numerics_trip`` events.  ``eval_fn(model) ->
    metrics`` is called every ``eval_every`` steps and at the end, with the
    live model or, for an asynchronous eval, a snapshot; its metrics are
    logged under ``eval/`` names.  ``world``: this process is one rank of
    that data-parallel world (module docstring); ``batches`` are its
    shard, and only rank 0 calls ``log``.
    """
    device = next(state.model.parameters()).device
    comm_on = config.comm is not None and config.comm.enabled
    if world is None and (config.shard_weight_update or comm_on):
        raise ValueError(
            "--shard-weight-update and --comm-compress/--comm-overlap/--quantized-allreduce "
            "need a data-parallel world"
        )
    spatial = config.spatial_shards > 1
    if spatial and (world is None or config.shard_weight_update or comm_on):
        raise ValueError(
            "spatial partitioning is exclusive with --shard-weight-update "
            "and --comm-compress/--quantized-allreduce"
            if world is not None else "spatial partitioning needs a world"
        )
    is_main = world is None or world.is_main
    if not is_main:
        log = _Silent()
    ckpt = None
    if config.checkpoint_every and config.checkpoint_dir:
        ckpt = CheckpointManager(
            config.checkpoint_dir,
            max_to_keep=config.max_to_keep,
            save_interval_steps=config.checkpoint_every,
            metadata=config.ckpt_metadata,
            world=world,
        )
        resume_step = ckpt.latest_step() if config.resume else None
        if resume_step is not None:
            try:
                with trace.span("ckpt_restore"):
                    ckpt.restore(state, resume_step)
            except Exception as e:
                raise RuntimeError(
                    f"restoring {config.checkpoint_dir} failed (root cause chained): a shape "
                    "mismatch means another model or optimizer was checkpointed there; "
                    "otherwise every checkpoint in it is torn (ckpt_torn_skipped on stderr)"
                ) from e
            if is_main:
                print(f"resumed from step {state.step}", flush=True)

    if trace.enabled():
        # Run metadata into the trace: the perf doctor (obs/analyze) finds
        # the card's peak TFLOP/s and the topology in the artifacts alone.
        trace.instant(
            "run_meta",
            device_kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            local_device_count=torch.cuda.device_count() if device.type == "cuda" else 1,
            process_count=1 if world is None else world.size,
        )
    step_fns: dict[tuple[int, int], Callable[..., dict[str, Any]]] = {}
    numerics_config = numerics_lib.NumericsConfig(enabled=config.numerics)
    log_event = getattr(log, "event", None)
    start_step = state.step
    last_saved: int | None = None
    # The profile window, clamped into the steps this run takes.
    prof_start = min(
        max(config.profile_start_step, start_step + 1),
        max(start_step + 1, config.total_steps - config.profile_steps + 1),
    )
    prof_end = min(config.total_steps, prof_start + config.profile_steps - 1)
    profiler = None
    eval_runner = None
    if config.async_eval and eval_fn is not None:
        if world is not None:
            warnings.warn("async_eval in a data-parallel world: the evals run synchronously "
                          "(an eval thread's gather could interleave with the steps' all-reduces)")
        else:
            eval_runner = _AsyncEvalRunner(eval_fn, log, device)
    # Images a step: the batch of each data index (a space group shares one).
    images_per_batch = 1 if world is None else world.size // config.spatial_shards
    window_t0, window_images, window_steps, window_wait = monotonic_s(), 0, 0, 0.0
    check_every = config.log_every or _FINITE_CHECK_EVERY
    cadence = f"every {check_every} steps and before each checkpoint save"
    it = _prefetch_to_device(batches, device, config.device_prefetch)
    # The loop's heartbeat, one beat a step; a sync eval is bracketed with
    # idle(), so only a wedged step stream (or the data it waits on) trips
    # the watchdog.  The details read a host-side step count.
    last_step = [start_step]
    loop_hb = watchdog.register("train-loop", details=lambda: {"step": last_step[0]})

    def abort_if_nonfinite(metrics: dict[str, Any], step: int, images, image_ids) -> None:
        sentinels = {k: metrics[k] for k in _SENTINEL_METRICS if k in metrics}
        hit = numerics_lib.first_nonfinite_scalar(sentinels)
        if hit is not None:
            _abort_nonfinite(
                hit[0], hit[1], step, cadence, model=state.model, images=images,
                image_ids=image_ids, metrics=metrics, config=config, log=log, world=world,
            )

    try:
        for step in range(start_step + 1, config.total_steps + 1):
            if eval_runner is not None:
                eval_runner.drain()
            loop_hb.beat()
            last_step[0] = step
            t_data = monotonic_s()
            with trace.span("data_wait"):
                shape, image_ids, staged = next(it)
                arrays = take(staged)
            window_wait += monotonic_s() - t_data
            hw = tuple(shape[1:3])
            step_fn = step_fns.get(hw)
            if step_fn is None:
                t_build = monotonic_s()
                if spatial:
                    step_fn = step_fns[hw] = make_train_step_spatial(
                        state.model, hw, num_classes, world, config.spatial_shards,
                        loss_config, matching_config, anchor_config,
                        allow_data_axis_divergence=config.allow_data_axis_divergence,
                        numerics=numerics_config,
                    )
                else:
                    step_fn = step_fns[hw] = make_train_step(
                        state.model, hw, num_classes, loss_config, matching_config,
                        anchor_config, device, numerics=numerics_config, world=world,
                        comm=config.comm, shard_weight_update=config.shard_weight_update,
                        topology=config.topology,
                    )
                telemetry.record_compile(f"{hw[0]}x{hw[1]}", monotonic_s() - t_build)
                # A traced run records the step's FLOPs, the perf doctor's
                # MFU numerator (obs/analyze).
                flops = step_flops(state.model, tuple(shape)) if trace.enabled() else None
                if flops is not None:
                    trace.instant("cost_analysis", target="train_step", bucket=f"{hw[0]}x{hw[1]}",
                                  flops=flops, batch=int(shape[0]), source=FLOPS_SOURCE)
            if config.profile_dir and step == prof_start:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            with trace.span("step"):
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
            window_images += shape[0] * images_per_batch  # the global batch
            window_steps += 1

            is_log = (config.log_every and step % config.log_every == 0) or step == config.total_steps
            will_save = ckpt is not None and ckpt.should_save(step)
            if not is_log and (will_save or step % check_every == 0):
                abort_if_nonfinite(metrics, step, arrays["images"], image_ids)
            if is_log:
                with trace.span("metrics_fetch"):
                    scalars = {k: float(v) for k, v in metrics.items()}
                abort_if_nonfinite(scalars, step, arrays["images"], image_ids)
                dt = monotonic_s() - window_t0
                scalars["images_per_sec"] = window_images / max(dt, 1e-9)
                scalars["step_time_ms"] = dt / window_steps * 1e3
                scalars["data_wait_ms"] = window_wait / window_steps * 1e3
                scalars["lr"] = state.schedule(step - 1)
                scale = optim.plateau_scale(state.optimizer)
                if scale is not None:
                    scalars["lr"] *= scale
                log(step, scalars)
                # Telemetry record sites: one bool check each while off.
                telemetry.record_train_window(
                    step=step,
                    images_per_s=scalars["images_per_sec"],
                    step_time_ms=scalars["step_time_ms"],
                    data_wait_ms=scalars["data_wait_ms"],
                )
                telemetry.record_numerics(
                    grad_norm=scalars.get(numerics_lib.GRAD_NORM),
                    update_ratio=scalars.get(numerics_lib.UPDATE_RATIO),
                    nonfinite=scalars.get(numerics_lib.NONFINITE),
                    replica_agreement=scalars.get(numerics_lib.REPLICA_AGREEMENT),
                )
                # The EF health: the gauges the always-armed
                # ef_residual_spike rules watch, and the bytes on the wire.
                telemetry.record_comm(
                    ef_residual=scalars.get(numerics_lib.EF_RESIDUAL),
                    ef_saturation=scalars.get(numerics_lib.EF_SATURATION),
                    compressed_bytes=scalars.get(numerics_lib.COMM_BYTES),
                    ici_bytes=scalars.get(numerics_lib.COMM_ICI_BYTES),
                    dcn_bytes=scalars.get(numerics_lib.COMM_DCN_BYTES),
                    ef_residual_dcn=scalars.get(numerics_lib.EF_RESIDUAL_DCN),
                    steps=window_steps,
                )
                if config.numerics and log_event is not None:
                    num_keys = numerics_lib.numerics_metric_keys(scalars)
                    log_event("numerics", step=step, **{k: scalars[k] for k in num_keys})
                if trace.enabled():
                    for name, value in device_memory_stats():
                        trace.counter(name, value)
                window_t0, window_images, window_steps, window_wait = monotonic_s(), 0, 0, 0.0

            if will_save and ckpt.save(state, step=step):
                last_saved = step

            if eval_fn is not None and config.eval_every and step % config.eval_every == 0 \
                    and step < config.total_steps:
                # A launch may join the eval in flight, a sync eval runs
                # for minutes: legitimate silence of the step stream.
                loop_hb.idle()
                if eval_runner is not None:
                    eval_runner.launch(state.model, step)
                    loop_hb.beat()
                else:
                    with trace.span("eval", step=step):
                        eval_metrics = eval_fn(state.model)
                    loop_hb.beat()
                    log(step, _eval_scalars(eval_metrics))
                    # The eval's time stays out of the next window's step time.
                    window_t0, window_images, window_steps, window_wait = monotonic_s(), 0, 0, 0.0
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
        loop_hb.close()  # the epilogue has its own components

    final_step = max(start_step, config.total_steps)
    if eval_runner is not None:
        eval_runner.join()  # logged before the final eval, in step order
    if eval_fn is not None:
        with trace.span("final_eval", step=final_step):
            final_metrics = eval_fn(state.model)
        log(final_step, _eval_scalars(final_metrics))
    if ckpt is not None:
        if last_saved != final_step:
            ckpt.save(state, step=final_step, force=True)
        ckpt.close()
    return state
