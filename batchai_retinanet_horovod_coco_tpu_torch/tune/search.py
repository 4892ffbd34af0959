"""The timed schedule search: measure candidates, compose a winner (the JAX
package's ``tune/search.py`` for the port).

The searched knobs are the launch shapes of the three CUDA kernel
libraries (``tune/candidates.py``: a handful each, so every one is
measured), and ``pre_nms_size`` on request.

Measurement policy:

- **the kernel, not the program**: a trial calls the kernel's wrapper on
  inputs made once (the NMS keep mask on the post-processing's candidates,
  the focal forward and backward, the fused matching), so that the launch
  shape is what moves its time;
- **built first**: the kernel libraries are compiled (one ``nvcc`` each,
  side by side) before the first trial, so no trial times a build; each
  trial makes two warm-up calls before it is timed;
- **two disjoint timed windows** of ``steps // 2`` calls.  On the card the
  calls are captured once in a CUDA graph, replayed once untimed, and
  each window is one replay between two CUDA events, ended by a sync:
  device time, which the host's load and the wrappers' launch cost do
  not enter.  On the CPU each window is timed on the project clock
  (``obs.trace.monotonic_s``).  The point estimate is the windows' mean
  and their spread is the trial's noise;
- every trial runs under a ``tune_trial`` span (``tune_compile`` for the
  warm-up and the capture, ``tune_window`` for each window) inside the
  op's ``tune_search``, so a traced search is one track of spans a
  candidate;
- every knob of a trial is pinned in the call it makes, never read through
  the registry (whose lookups are cached by path).

Error policy: a candidate that fails (a variant that cannot launch, say for
too many resources) is a FAILED TRIAL, recorded and skipped, EXCEPT a
sticky CUDA error (an illegal address, a launch failure: the context is
gone and every later trial would fail too), which raises
:class:`DeviceUnavailable`, so that the command line exits 75 with one
structured line instead of composing a winner from a dead device.

Semantics policy: ``pre_nms_size`` other than 1000 changes detection
semantics; such trials are measured only on request, recorded as
``semantics: "approx"``, and never win.

On the CPU no kernel runs: only each op's default candidate is measured
(through the plain version, which has no launch shape); the others are
recorded as skipped, so a CPU file's entries are the defaults.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.obs import trace
from batchai_retinanet_horovod_coco_tpu_torch.tune import candidates as cand_lib
from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

# The flagship bucket: the search measures where training and serving spend.
DEFAULT_HW = (800, 1344)
DEFAULT_BATCH = 8
DEFAULT_STEPS = 30  # a trial's timed calls, split into two windows

# Texts of the CUDA errors after which the context is unusable (sticky
# errors): every later call fails too, so the search must stop.
STICKY_MARKERS = (
    "illegal memory access",
    "illegal instruction",
    "unspecified launch failure",
    "misaligned address",
    "device-side assert",
    "uncorrectable ecc error",
    "hardware stack error",
    "busy or unavailable",
    "no cuda gpus are available",
)


class DeviceUnavailable(RuntimeError):
    """The card's context died under a trial: the search stops, and the
    command line exits 75 instead of recording a winner."""


def is_sticky(err: BaseException) -> bool:
    """Whether ``err`` or any exception on its ``__cause__``/``__context__``
    chain reports a sticky CUDA error (a wrapper may re-raise it one link
    down)."""
    seen: set[int] = set()
    stack: list = [err]
    while stack:
        e = stack.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        text = str(e).lower()
        if any(m in text for m in STICKY_MARKERS):
            return True
        stack.extend((e.__cause__, e.__context__))
    return False


@dataclasses.dataclass
class Trial:
    """One measured candidate (the file's ``trials`` holds these)."""

    op: str
    params: dict[str, Any]
    ms_per_call: float | None
    window_ms: list[float]
    noise_pct: float | None
    semantics: str = "exact"
    status: str = "ok"  # "ok" | "failed" | "skipped"
    error: str | None = None

    def record(self) -> dict[str, Any]:
        return {
            "op": self.op,
            "params": self.params,
            "ms_per_call": self.ms_per_call,
            "window_ms": self.window_ms,
            "noise_pct": self.noise_pct,
            "semantics": self.semantics,
            "status": self.status,
            "error": self.error,
        }


def _sync() -> None:
    """Wait for the card, where this process uses one (a CPU run has
    nothing in flight)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


Windows = Callable[[Callable[[], Any], int], "tuple[float, list[float]]"]


def host_windows(fn: Callable[[], Any], steps: int) -> tuple[float, list[float]]:
    """Two disjoint windows of ``steps // 2`` calls of a warmed-up nullary
    ``fn`` on the project clock, each ended by a sync; returns (ms a call,
    [window ms, window ms])."""
    half = max(1, steps // 2)
    window_ms: list[float] = []
    for _ in range(2):
        with trace.span("tune_window", steps=half):
            t0 = trace.monotonic_s()
            for _ in range(half):
                fn()
            _sync()
            dt = trace.monotonic_s() - t0
        window_ms.append(dt / half * 1e3)
    return sum(window_ms) / len(window_ms), window_ms


def device_windows(fn: Callable[[], Any], steps: int) -> tuple[float, list[float]]:
    """Two disjoint windows of ``steps // 2`` calls of a warmed-up nullary
    ``fn`` in device time: the calls captured once in a CUDA graph and
    replayed once untimed (a graph's first replay is slower), then each
    window one replay between CUDA events, ended by a sync."""
    half = max(1, steps // 2)
    graph = torch.cuda.CUDAGraph()
    with trace.span("tune_compile", capture=half):
        with torch.cuda.graph(graph):
            for _ in range(half):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    window_ms: list[float] = []
    for _ in range(2):
        with trace.span("tune_window", steps=half):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
        window_ms.append(start.elapsed_time(stop) / half)
    return sum(window_ms) / len(window_ms), window_ms


def windows_for(device: torch.device) -> Windows:
    """Device time on a card, the host's clock on the CPU."""
    return device_windows if device.type == "cuda" else host_windows


def run_trial(
    op: str,
    params: dict[str, Any],
    build: Callable[[dict[str, Any]], Callable[[], Any]],
    steps: int,
    semantics: str = "exact",
    windows: Windows = host_windows,
) -> Trial:
    """Build, warm and time one candidate (``windows``: the clock); a
    failure is a failed trial unless the card's context died
    (:class:`DeviceUnavailable`)."""
    with trace.span("tune_trial", op=op, **{
        k: v for k, v in params.items() if isinstance(v, (int, str))
    }):
        try:
            with trace.span("tune_compile", op=op):
                fn = build(params)
                fn()  # warm-up call 1 (allocations, the library's first launch)
                fn()  # warm-up call 2 (caches settled)
                _sync()
            ms, window_ms = windows(fn, steps)
        except Exception as e:  # noqa: BLE001 — classified below
            if is_sticky(e):
                raise DeviceUnavailable(str(e)) from e
            return Trial(
                op=op, params=params, ms_per_call=None, window_ms=[],
                noise_pct=None, semantics=semantics, status="failed",
                error=str(e)[-500:],
            )
    noise = abs(window_ms[0] - window_ms[1]) / max(ms, 1e-9) * 100
    return Trial(
        op=op, params=params, ms_per_call=round(ms, 4),
        window_ms=[round(w, 4) for w in window_ms],
        noise_pct=round(noise, 2), semantics=semantics,
    )


# ---------------------------------------------------------------------------
# Per-op trial programs (the JAX package's input fields and seeds)
# ---------------------------------------------------------------------------


def _anchors(hw: tuple[int, int]) -> np.ndarray:
    from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib

    return np.array(anchors_lib.anchors_for_image_shape(hw), np.float32)


def _postprocess_inputs(batch: int, hw: tuple[int, int], device: torch.device):
    """The NMS search's field: sparse scores (sigmoid(-4 +- 1), about 2%
    foreground) and small deltas over the bucket's anchors, decoded and
    clipped as the detect path does: (boxes (B, A, 4), scores (B, A, 80))."""
    from batchai_retinanet_horovod_coco_tpu_torch.ops import boxes as boxes_lib

    anchors = _anchors(hw)
    rng = np.random.default_rng(1)
    cls = rng.normal(-4.0, 1.0, (batch, anchors.shape[0], 80)).astype(np.float32)
    deltas = rng.normal(0.0, 0.3, (batch, anchors.shape[0], 4)).astype(np.float32)
    anchors, cls, deltas = (torch.from_numpy(a).to(device) for a in (anchors, cls, deltas))
    boxes = boxes_lib.decode_boxes(anchors[None], deltas, boxes_lib.BoxCodecConfig())
    return boxes_lib.clip_boxes(boxes, hw), torch.sigmoid(cls)


def _nms_builder(batch: int, hw: tuple[int, int], device: torch.device):
    """The NMS keep mask on the detect path's candidates (the top
    ``pre_nms_size`` an image above the score threshold)."""
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
    from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
    from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda

    boxes, scores = _postprocess_inputs(batch, hw, device)
    config = detect_lib.DetectConfig()
    nms = schedule_lib.DEFAULT_SCHEDULE["nms"]

    def build(params: dict[str, Any]) -> Callable[[], Any]:
        # Every knob pinned: the trial measures THIS candidate, not the
        # registry's entry.
        pre = int(params.get("pre_nms_size", nms["pre_nms_size"]))
        cand = nms_lib.select_candidates(boxes, scores, config.score_threshold, pre)
        cand_boxes, cand_scores, class_idx = (t.contiguous() for t in cand)
        lanes = int(params.get("mask_lanes", nms["mask_lanes"]))
        threads = int(params.get("scan_threads", nms["scan_threads"]))

        def keep():
            return nms_cuda.nms_keep_mask(cand_boxes, cand_scores, class_idx,
                                          config.iou_threshold, lanes, threads)

        return keep

    return build


def _focal_builder(batch: int, hw: tuple[int, int], device: torch.device):
    """The focal loss's forward and backward kernels (the train step pays
    both); on the CPU the plain version and its autograd gradient."""
    from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda

    num_anchors = _anchors(hw).shape[0]
    rng = np.random.default_rng(2)
    logits = rng.normal(-4.0, 1.0, (batch, num_anchors, 80)).astype(np.float32)
    labels = rng.integers(0, 80, (batch, num_anchors)).astype(np.int32)
    # ~1% positive, ~4% ignored: a realistic assignment mix.
    state = rng.choice(np.array([-1, 0, 1], np.int32), (batch, num_anchors),
                       p=[0.04, 0.95, 0.01])
    logits, labels, state = (torch.from_numpy(a).to(device) for a in (logits, labels, state))
    cotangent = torch.ones((batch,), device=device)

    def build(params: dict[str, Any]) -> Callable[[], Any]:
        fwd, bwd = int(params["fwd_tile_a"]), int(params["bwd_tile_a"])

        def kernels():
            sums = focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0, fwd)
            return sums, focal_cuda.focal_bwd(logits, labels, state, cotangent, 0.25, 2.0, bwd)

        def plain():
            x = logits.detach().requires_grad_()
            sums = focal_cuda.focal_loss_per_image_sums(x, labels, state, 0.25, 2.0, fwd, bwd)
            return sums, torch.autograd.grad(sums, x, cotangent)[0]

        return kernels if device.type == "cuda" else plain

    return build


def _matching_builder(batch: int, hw: tuple[int, int], device: torch.device, num_gt: int = 32):
    """The fused matching of 32 padded gts an image."""
    from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda

    anchors = torch.from_numpy(_anchors(hw)).to(device)
    rng = np.random.default_rng(3)
    x1 = rng.uniform(0, hw[1] * 0.8, (batch, num_gt, 1))
    y1 = rng.uniform(0, hw[0] * 0.8, (batch, num_gt, 1))
    wh = rng.uniform(16, 256, (batch, num_gt, 2))
    gt_boxes = np.concatenate([x1, y1, x1 + wh[..., :1], y1 + wh[..., 1:]], -1).astype(np.float32)
    gt_labels = rng.integers(0, 80, (batch, num_gt)).astype(np.int32)
    gt_mask = np.arange(num_gt)[None, :] < rng.integers(1, num_gt, (batch, 1))
    gts = tuple(torch.from_numpy(a).to(device) for a in (gt_boxes, gt_labels, gt_mask))

    def build(params: dict[str, Any]) -> Callable[[], Any]:
        tile = int(params["tile_a"])
        return lambda: matching_cuda.assign_fused(anchors, *gts, tile)

    return build


_BUILDERS: dict[str, Callable[..., Callable]] = {
    "nms": _nms_builder,
    "focal": _focal_builder,
    "matching": _matching_builder,
}



def build_libraries(ops, device: torch.device) -> None:
    """Compile the kernel libraries that ``ops`` launch, side by side
    (CUDA only); a failed build raises."""
    if device.type != "cuda" or not ops:
        return
    from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build

    names = sorted(set(ops))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build.compile_library, names))


def _semantics(op: str, params: dict[str, Any]) -> str:
    if op == "nms" and params.get("pre_nms_size", cand_lib.DEFAULT_PRE_NMS_SIZE) != \
            cand_lib.DEFAULT_PRE_NMS_SIZE:
        return "approx"
    return "exact"


def search_op(
    op: str,
    batch: int = DEFAULT_BATCH,
    hw: tuple[int, int] = DEFAULT_HW,
    steps: int = DEFAULT_STEPS,
    include_semantic: bool = False,
    candidates: list[dict[str, Any]] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, Any], list[Trial]]:
    """Measure every candidate of ``op`` on ``device``; returns (winner
    entry, trials).  Only exact-semantics successful trials may win; the
    winner is a registry entry as it stands."""
    device = torch.device(device)
    if candidates is None:
        candidates = cand_lib.candidates_for(
            op, **({"include_semantic": True} if op == "nms" and include_semantic else {})
        )
    builder = _BUILDERS[op](batch, hw, device)
    windows = windows_for(device)
    trials: list[Trial] = []
    with trace.span("tune_search", op=op, candidates=len(candidates)):
        for params in candidates:
            semantics = _semantics(op, params)
            if device.type != "cuda" and not cand_lib.is_default(op, params):
                trials.append(Trial(
                    op=op, params=params, ms_per_call=None, window_ms=[],
                    noise_pct=None, semantics=semantics, status="skipped",
                    error="kernel variant skipped: no CUDA device (the plain version has "
                          "no launch shape)",
                ))
                continue
            trials.append(run_trial(op, params, builder, steps, semantics, windows))
    eligible = [t for t in trials if t.status == "ok" and t.semantics == "exact"]
    if not eligible:
        raise RuntimeError(
            f"search_op({op!r}): no successful exact-semantics trial "
            f"(statuses: {[t.status for t in trials]})"
        )
    winner = min(eligible, key=lambda t: t.ms_per_call)
    return dict(winner.params), trials


def compose_schedule(
    device_kind: str,
    entries: dict[str, dict[str, Any]],
    trials: list[Trial],
) -> dict[str, Any]:
    """Winner entries and trial records as a registry document, validated
    here, so that a faulty search can never write a file that poisons a
    consumer."""
    doc = {
        "format": schedule_lib.FORMAT,
        "device_kind": device_kind,
        "entries": entries,
        "trials": [t.record() for t in trials],
    }
    schedule_lib.validate_schedule(doc)
    return doc


def run_search(
    ops: tuple[str, ...] = ("nms", "focal", "matching"),
    batch: int = DEFAULT_BATCH,
    hw: tuple[int, int] = DEFAULT_HW,
    steps: int = DEFAULT_STEPS,
    include_semantic: bool = False,
    device_kind: str | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, Any]:
    """The whole search on ``device`` (``cuda`` unless the caller asks for
    the CPU; without a card it raises): every requested op, the winners
    composed into one registry document (not saved: the command line
    writes it, so that a dry run can print it instead)."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    unknown = [op for op in ops if op not in _BUILDERS]
    if unknown:
        raise ValueError(f"unknown ops {unknown}; known: focal, matching, nms")
    build_libraries(ops, device)
    if device_kind is None:
        device_kind = schedule_lib.resolve_kind(device)
    entries: dict[str, dict[str, Any]] = {}
    all_trials: list[Trial] = []
    for op in ops:
        winner, trials = search_op(op, batch=batch, hw=hw, steps=steps,
                                   include_semantic=include_semantic, device=device)
        entries[op] = winner
        all_trials.extend(trials)
    return compose_schedule(device_kind, entries, all_trials)
