"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``batchai_retinanet_horovod_coco_tpu_torch`` on the card, in ten
phases, and fails (non-zero exit, no result line) if any of them fails:

1. device: the card's name and power limit;
2. build: compiles every CUDA kernel (NMS, matching, focal) from the
   sources in this checkout, one ``nvcc`` each, all started together, and
   prints each ``-Xptxas -v`` report;
3. NMS kernel against plain: the NMS kernel and its plain PyTorch version
   on the same card tensors (B 8, K 1000: dup-heavy fields of three seeds,
   tied scores, an all-padding image; K 300; and aimed at the blocked
   scan: K 65 and K 129 with a ragged last word, one box repeated K times,
   K disjoint boxes, a suppression chain across words) must give EQUAL
   keep masks; the kernel is timed on the device (a replayed CUDA graph),
   its mask pass and scan apart, and the plain version with CUDA events;
4. serving: a full-width ResNet-50 RetinaNet (FPN 256, heads 256 x 4, 80
   classes, bf16 activations, weights from a seeded generator) behind
   ``DetectEngine.from_state`` on both default buckets at batch 8 and a
   ``DetectionServer`` answers 24 requests of mixed sizes and orientations.
   The NMS counters are zeroed just before and read just after: the
   kernel must have launched at least once per dispatched batch and the
   plain version never.  One batch's forward outputs, re-run through the
   plain NMS, must give Detections identical to the kernel path's.  That
   batch's time is split into device forward, device post-processing,
   host resize, fetch and result conversion;
5. serving reference: a small f32 model (cuDNN TF32 off) gives the same
   forward outputs on the card as on the CPU within 1e-4 of their range,
   and the card's kernel-path Detections equal the CPU plain path's bit
   for bit on the same decoded boxes and scores;
6. matching kernel against plain: at B 16, A 201 600 (the (800, 1344)
   bucket; not a multiple of the kernel's anchor tile), G 100, on fields
   with ragged gt counts and padded rows, an image with no gt, duplicated
   gts and tiny gts, and fields aimed at the kernel's culling (real rows
   after padded ones, real gts that overlap no anchor or lie outside the
   image, gt edges on tile box edges, G 1000 all real at B 2, an image
   whose only gt overlaps only the last tile), all five outputs must be
   EQUAL; on the first training batch it prints the share of (tile, gt)
   rows the kernel walks and times the kernel and the plain version;
7. focal kernels against plain: at B 16, A 201 600, K 80 with logits in
   [-12, 12] and some beyond +-20, the forward sums agree within rel 1e-5
   and repeat bit for bit, the backward with f64 autograd of the plain
   version within 1e-6 of the largest gradient; all four are timed;
8. training: the full-width model (GroupNorm, bf16 activations, f32
   parameters) with ``OptimizerConfig()`` at global batch 16 (8 if 16
   does not fit) runs ``train/loop.py`` for 6 steps of seeded synthetic
   batches at (800, 1344), 0-40 boxes an image padded to 100.  The
   counters are zeroed just before and read just after: each training
   kernel launched once a step, the plain versions never.  Every loss is
   finite, and the first equals the same step through the plain versions
   on the card within rel 1e-4.  Two more steps are split by CUDA events
   into forward, targets, loss, backward and optimizer;
9. training reference: the golden configuration of the JAX package's
   tests (resnet_test, 64 x 64, 3 classes, FPN and heads 16 x 1, sgd 1e-2
   with momentum 0.9) in f32 with TF32 off takes 5 steps on the card and
   on the CPU: the loss falls every step and the trajectories agree within
   rel 1e-4;
10. a training run with checkpoints, eval and resume: the full-width model
   with ``OptimizerConfig()`` runs ``train/loop.py`` for 6 steps of phase
   8's batches with a checkpoint and an asynchronous COCO eval every 3
   steps (12 seeded validation images of 600-800 x 900-1344 pixels, 0-40
   boxes each, some crowd, and 5 detections of the initial model each so
   that the stats are not all 0, read through ``data/coco.py``, batched
   at 8 so the second batch has padding rows), device prefetch 2, 2 checkpoints
   kept, and a profiler trace of step 5.  The counters are zeroed just
   before and read just after: each training kernel launched once a step,
   NMS once for each eval batch, the plain versions never.  The async eval
   of step 3 gives the same 12 COCO stats, within 1e-6, and the same
   weights as a synchronous ``run_coco_eval`` of ``ckpt-3`` restored into
   a model built from other weights, whose every leaf equals the saved one
   bit for bit; ``collect_detections`` pipelined and sequential give
   identical results on the final state; a state built from other weights
   and resumed from ``ckpt-3`` takes steps 4-6 with the uninterrupted
   run's losses within rel 1e-4; only ``ckpt-3`` and ``ckpt-6`` remain.
   It prints the checkpoint's size, save time (host snapshot and write
   apart) and restore time, eval seconds and a detect batch's device ms,
   ``data_wait_ms``, peak memory, step ms (to a sync of the training
   stream) with an async eval in flight against without one, the async
   eval's wall time against the same steps and a synchronous eval, the
   training stream's kernel time a step in profiled steps with and
   without an eval in flight (the card's share of the slowdown, the rest
   the host's), and the 10 CUDA kernels that took the most device time in
   the loop's profiled step (which overlaps step 3's eval) and in steps
   with no eval in flight.

Then it prints one JSON line with each kernel's launches, error, times and
bound, and as its last line ``{"ok": true, "device": {...}}``.  A kernel's
``ms`` there is CUDA events around wrapper calls made back to back, as the
plain version's ``plain_ms``; ``device_ms`` is the same call's device time
from a replayed CUDA graph, without the host's time to launch it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.data.coco import CocoDataset
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    default_buckets,
    normalize_images,
)
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
    RetinaNetConfig,
    build_retinanet,
)
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import cases as cases_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as loop_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as optim_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import state as state_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import step as step_lib
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import assemble_requests
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import ServeRequest
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.serve.frontend import DetectionServer
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    bucket_for_source,
    resize_for_bucket,
)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of one IoU-vs-threshold test (areas counted per box).
OPS_PER_PAIR = 15
OPS_PER_BOX = 5
IOU_THRESHOLD = 0.5
# f32 operations of one (anchor, real gt) pair in the matching kernel: the
# IoU (14, with the gt's area counted once per gt) and the two running
# max/argmax compares.
MATCH_OPS_PER_PAIR = 16
# f32 operations of one logit in the focal kernels, counting each exp and
# log1p as one: forward softplus 5, focal term 8, sum 1; backward softplus
# pair 6, three exps, closed form 9, cotangent 1.
FOCAL_FWD_OPS = 14
FOCAL_BWD_OPS = 19
TRAIN_HW = (800, 1344)  # the landscape bucket of the (800, 1333) resize rule
MAX_GT = 100
GOLDEN_HW = (64, 64)
GOLDEN_MODEL = dict(num_classes=3, backbone="resnet_test", fpn_channels=16,
                    head_width=16, head_depth=1, dtype=torch.float32)
# optax.sgd(1e-2, momentum=0.9): no decay, no warmup, a clip that never engages.
GOLDEN_OPT = dict(base_lr=0.01, global_batch_size=256, warmup_steps=0,
                  schedule="constant", weight_decay=0.0, clip_global_norm=1e9)
VAL_IMAGES = 12
VAL_FOUND = 5  # detections of the initial model added to each image's gts
EVAL_BATCH = 8
COCO_STATS = ("AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge",
              "AR1", "AR10", "AR100", "ARsmall", "ARmedium", "ARlarge")
SERVE_SIZES = [  # (h, w) of the served images: both orientations, some as-is
    (480, 640), (640, 480), (800, 1200), (1200, 800), (375, 500), (500, 375),
    (600, 900), (900, 600), (427, 640), (640, 427), (768, 1024), (1024, 768),
    (333, 1000), (1000, 333), (720, 1280), (1280, 720), (512, 512), (800, 1000),
    (300, 400), (400, 300), (900, 1400), (1400, 900), (612, 612), (256, 320),
]


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


_PHASE_START: list[float] = []


def phase(n: int, title: str) -> None:
    """Start phase ``n``, printing how long the one before it took."""
    now = time.perf_counter()
    if _PHASE_START:
        print(f"(phase {n - 1}: {now - _PHASE_START[0]:.1f} s)")
        _PHASE_START.clear()
    _PHASE_START.append(now)
    print(f"== phase {n}: {title}", flush=True)


def end_phases() -> None:
    print(f"(last phase: {time.perf_counter() - _PHASE_START.pop():.1f} s)")


def random_candidates(batch, k, num_classes, seed, device, tied=False, pad_images=()):
    """Sorted (boxes, scores, class ids) candidates from a dup-heavy field."""
    rng = np.random.default_rng(seed)
    num = 2 * k
    xy = rng.uniform(0, 1200, (batch, num, 2)).astype(np.float32)
    wh = rng.uniform(8, 300, (batch, num, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    ndup = int(num * 0.3)
    src = rng.integers(0, num, (batch, ndup))
    jitter = rng.normal(0, 6, (batch, ndup, 4)).astype(np.float32)
    for b in range(batch):
        boxes[b, :ndup] = boxes[b, src[b]] + jitter[b]
    scores = rng.uniform(0, 1, (batch, num, num_classes)).astype(np.float32)
    if tied:
        scores = np.round(scores * 16.0) / 16.0
    for b in pad_images:
        scores[b] = 0.0  # below the threshold: every slot becomes padding
    sel = nms_lib.select_candidates(
        torch.from_numpy(boxes).to(device),
        torch.from_numpy(scores.astype(np.float32)).to(device),
        0.05,
        k,
    )
    return tuple(t.contiguous() for t in sel)


def time_ms(fn, reps: int, warmup: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the
    host's time to launch them (ctypes, allocation) does not enter."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def nms_pass_ms(cb: torch.Tensor, cs: torch.Tensor, ci: torch.Tensor) -> tuple[float, float]:
    """Device ms of the NMS kernel's mask pass and of its scan, each through
    its own C launch function on preallocated buffers."""
    lib = nms_cuda._library()
    b, k = cs.shape
    mask = torch.empty((b, k, -(-k // nms_cuda._BLOCK)), dtype=torch.int64, device=cs.device)
    keep = torch.empty((b, k), dtype=torch.bool, device=cs.device)

    def mask_pass():
        require(lib.nms_mask_launch(cb.data_ptr(), ci.data_ptr(), b, k, IOU_THRESHOLD, mask.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream) == 0, "NMS mask launch")

    def scan():
        require(lib.nms_scan_launch(cs.data_ptr(), mask.data_ptr(), b, k, nms_cuda._PAD_SCORE,
                                    keep.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0,
                "NMS scan launch")

    mask_ms = device_ms(mask_pass)  # also leaves the mask that the scan reads
    scan_ms = device_ms(scan)
    require(torch.equal(keep, nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD)),
            "the scan launched on its own differs from the plain version")
    return mask_ms, scan_ms


def nms_case(kind: str, device) -> tuple[torch.Tensor, ...]:
    """Sorted candidates aimed at the NMS kernel's blocked scan."""
    arrays = {
        "one box repeated": lambda: cases_lib.one_box_repeated(8, 1000),
        "disjoint boxes": lambda: cases_lib.disjoint_boxes(8, 1000),
        "cross-word chain": cases_lib.suppression_chain,
    }[kind]()
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def nms_bound_ms(cand_scores: torch.Tensor, class_idx: torch.Tensor) -> tuple[float, str]:
    """Least time for this input: each input read once and the mask written
    once over HBM, or the IoU tests this data needs (valid same-class pairs
    j < i) over the f32 peak, whichever is larger."""
    b, k = cand_scores.shape
    bytes_moved = b * k * (16 + 4 + 4 + 1)
    valid = cand_scores > nms_cuda._PAD_SCORE
    same = (class_idx[:, :, None] == class_idx[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    pairs = int(torch.triu(same, diagonal=1).sum().item())
    ops = OPS_PER_PAIR * pairs + OPS_PER_BOX * int(valid.sum().item())
    return bound(bytes_moved, ops)


def gt_scene(batch, num_gt, seed, hw=TRAIN_HW, counts=(1, 40), empty=(), dup=(), tiny=()):
    """Padded gts at ``hw``: boxes (B, G, 4) f32, labels (B, G) int32 in
    0..79, mask (B, G) bool, with ``counts`` real rows an image (none for
    ``empty`` images), junk in the padded rows, the first box repeated
    under other labels on ``dup`` images, and 2-4 pixel boxes on ``tiny``
    images."""
    rng = np.random.default_rng(seed)
    h, w = hw
    boxes = rng.uniform(0, 60, (batch, num_gt, 4)).astype(np.float32)
    labels = rng.integers(0, 80, (batch, num_gt)).astype(np.int32)
    mask = np.zeros((batch, num_gt), bool)
    for b in range(batch):
        n = 0 if b in empty else int(rng.integers(counts[0], counts[1] + 1))
        size = (2.0, 4.0) if b in tiny else (8.0, 500.0)
        xy = rng.uniform(0, [w - 10, h - 10], (n, 2))
        wh = rng.uniform(*size, (n, 2))
        boxes[b, :n] = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
        if b in dup and n >= 3:
            boxes[b, 1:3] = boxes[b, 0]
            labels[b, 1:3] = (labels[b, 0] + np.array([1, 2])) % 80
        mask[b, :n] = True
    return boxes, labels, mask


def train_batch(batch_size: int, seed: int) -> pipeline_lib.Batch:
    """A seeded synthetic batch at TRAIN_HW: uint8 images of 600-800 by
    900-1344 pixels padded by the pipeline's ``assemble``, 0-40 boxes an
    image with labels 0-79, padded to MAX_GT rows."""
    rng = np.random.default_rng(1000 + seed)
    boxes, labels, mask = gt_scene(batch_size, 40, seed, counts=(0, 40))
    examples = []
    for b in range(batch_size):
        h, w = int(rng.integers(600, 801)), int(rng.integers(900, 1345))
        n = int(mask[b].sum())
        img_boxes = np.minimum(boxes[b, :n], [w, h, w, h]).astype(np.float32)
        examples.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), img_boxes,
                         labels[b, :n], 1.0))
    return pipeline_lib.assemble(examples, list(range(batch_size)), TRAIN_HW, max_gt=MAX_GT)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def matching_bound_ms(num_anchors: int, gt_mask: torch.Tensor) -> tuple[float, str]:
    """Anchors and gts read once, the five outputs written once; the IoU
    work of the real (unmasked) gts, which is all the kernel computes."""
    b, g = gt_mask.shape
    bytes_moved = num_anchors * 16 + b * g * (16 + 4 + 1) + b * num_anchors * (16 + 4 + 4) + b * g * 8
    ops = MATCH_OPS_PER_PAIR * num_anchors * int(gt_mask.sum().item())
    return bound(bytes_moved, ops)


def focal_bound_ms(logits: torch.Tensor, state: torch.Tensor, backward: bool) -> tuple[float, str]:
    """States read for every anchor, labels and logits only for the
    non-ignored ones (the kernels skip the rest), the sums (forward) or the
    whole gradient (backward) written once."""
    b, a, k = logits.shape
    live = int((state != matching_lib.IGNORE).sum().item())
    bytes_moved = b * a * 4 + live * 4 + live * k * 4 + b * 4
    if backward:
        bytes_moved += b * 4 + b * a * k * 4
    ops = (FOCAL_BWD_OPS if backward else FOCAL_FWD_OPS) * live * k
    return bound(bytes_moved, ops)


def check_results(results: list[list[dict]], sizes) -> None:
    for dets, (h, w) in zip(results, sizes):
        require(isinstance(dets, list) and 0 < len(dets) <= 300, f"{len(dets)} detections")
        for d in dets:
            x, y, bw, bh = d["bbox"]
            require(set(d) == {"category_id", "bbox", "score"}, f"keys {sorted(d)}")
            require(0 <= d["category_id"] < 80, f"category {d['category_id']}")
            require(0.001 < d["score"] <= 1.0, f"score {d['score']}")
            require(np.isfinite([x, y, bw, bh]).all() and bw > 0 and bh > 0, f"bbox {d['bbox']}")
            require(x >= 0 and y >= 0 and x + bw <= w + 1e-3 and y + bh <= h + 1e-3,
                    f"bbox {d['bbox']} outside {w}x{h}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")

    phase(1, "device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind}; {smi}")

    phase(2, "build")
    t0 = time.perf_counter()
    sources = ("nms", "matching", "focal")
    # watchdog: the nvcc builds started together and joined right here; a
    # failed build raises through result(), and no thread outlives the phase.
    with ThreadPoolExecutor(len(sources)) as pool:
        for future in [pool.submit(build.compile_library, name) for name in sources]:
            future.result()
    print(f"built ops/cuda/{{{','.join(sources)}}}.cu in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        print(f"-- {name}.cu\n{build.build_logs.get(name, '(already built)')}")

    phase(3, "NMS kernel against its plain version")
    cases = [
        ("dup-heavy seed 0", dict(batch=8, k=1000, num_classes=8, seed=0)),
        ("dup-heavy seed 1", dict(batch=8, k=1000, num_classes=8, seed=1)),
        ("dup-heavy seed 2", dict(batch=8, k=1000, num_classes=8, seed=2)),
        ("tied scores", dict(batch=8, k=1000, num_classes=8, seed=3, tied=True)),
        ("image 0 all padding", dict(batch=8, k=1000, num_classes=8, seed=4, pad_images=(0,))),
        ("K 300", dict(batch=8, k=300, num_classes=8, seed=5)),
        # Aimed at the blocked scan: a ragged last word, one kept of K, all
        # kept, and suppression across words.
        ("K 65", dict(batch=8, k=65, num_classes=3, seed=6)),
        ("K 129", dict(batch=8, k=129, num_classes=3, seed=7)),
        ("one box repeated", None),
        ("disjoint boxes", None),
        ("cross-word chain", None),
    ]
    max_err = 0
    for name, kw in cases:
        cb, cs, ci = random_candidates(device=device, **kw) if kw else nms_case(name, device)
        got = nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD)
        want = nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max().item())
        max_err = max(max_err, err)
        kernel_ms = time_ms(lambda: nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD), 200, 10)
        kernel_device_ms = device_ms(lambda: nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD))
        mask_ms, scan_ms = nms_pass_ms(cb, cs, ci)
        plain_ms = time_ms(lambda: nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD), 10, 2)
        print(f"{name}: B {cb.shape[0]} K {cb.shape[1]} kept {int(got.sum())} "
              f"of {int((cs > nms_cuda._PAD_SCORE).sum())} valid; mismatches "
              f"{int((got != want).sum())}; kernel {kernel_ms:.4f} ms a wrapper call back to back, "
              f"{kernel_device_ms:.4f} ms on the device (mask pass {mask_ms:.4f}, scan "
              f"{scan_ms:.4f}); plain {plain_ms:.3f} ms")
        require(torch.equal(got, want), f"kernel and plain keep masks differ ({name})")
        if "padding" in name:
            require(not got[0].any().item(), "an all-padding image kept a candidate")
        if name == "one box repeated":
            require(bool((got.sum(-1) == 1).all()), "a repeated box was kept more than once")
        if name == "disjoint boxes":
            require(bool(got.all()), "a disjoint box was suppressed")

    phase(4, "serving: ResNet-50 RetinaNet behind DetectionServer")
    cfg = RetinaNetConfig()  # ResNet-50, FPN 256, heads 256 x 4, 80 classes, bf16
    t0 = time.perf_counter()
    model = build_retinanet(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params} parameters, built in {time.perf_counter() - t0:.1f} s")
    buckets = default_buckets(800, 1333)
    dconfig = detect_lib.DetectConfig(score_threshold=0.001)
    engine = DetectEngine.from_state(model, buckets, (8,), dconfig, device)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"buckets {buckets}, batch 8: warm-up {time.perf_counter() - t0:.1f} s")

    per_bucket = Counter(bucket_for_source(h, w, 800, 1333, buckets) for h, w in SERVE_SIZES)
    require(set(per_bucket) == set(buckets), f"requests reach buckets {dict(per_bucket)}")
    print(f"requests per bucket: {dict(per_bucket)}")

    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in SERVE_SIZES]
    nms_cuda.reset_counts()
    t0 = time.perf_counter()
    with DetectionServer(engine, warmup=False) as server:
        futures = [server.submit(img) for img in images]
        results = [f.result(timeout=600) for f in futures]
        snap = server.snapshot()
    wall = time.perf_counter() - t0
    launches, plain = nms_cuda.kernel_launches, nms_cuda.plain_calls
    print(f"served {len(results)} requests in {snap['batches']} batches; NMS kernel "
          f"launches {launches}, plain calls {plain}; detections per request "
          f"{[len(r) for r in results]}")
    require(snap["completed"] == len(images), f"completed {snap['completed']}")
    check_results(results, SERVE_SIZES)
    require(launches >= snap["batches"] > 0, f"{launches} launches for {snap['batches']} batches")
    require(plain == 0, f"the plain NMS ran {plain} times on the card")
    p50, ips = snap["p50_ms"], len(images) / wall
    print(f"p50 request latency {p50} ms, {ips:.2f} images/s "
          f"(all {len(images)} submitted at once; {kind}, {smi})")

    # One batch: kernel path against the plain NMS on the same forward outputs.
    hw = buckets[0]
    reqs = []
    for i, img in enumerate(images[:8]):
        if bucket_for_source(*img.shape[:2], 800, 1333, buckets) != hw:
            continue
        req = ServeRequest(i, None, None)
        req.image, scale = resize_for_bucket(img, hw, 800, 1333)
        req.scale = np.float32(scale)
        reqs.append(req)
    batch = assemble_requests(reqs, hw, 8)
    anchors = detect_lib.anchors_on(hw, dconfig.anchor, device)
    with torch.inference_mode():
        x = detect_lib.to_device_images(batch.images, device)
        outputs = model(normalize_images(x))
        kernel_det = detect_lib.postprocess(outputs, anchors, hw, dconfig)
        plain_det = detect_lib.postprocess(
            outputs, anchors, hw, dconfig, nms=nms_lib.batched_multiclass_nms
        )
        scores = torch.sigmoid(outputs["cls_logits"])
        boxes = detect_lib.boxes_lib.clip_boxes(
            detect_lib.boxes_lib.decode_boxes(anchors[None], outputs["box_deltas"]), hw
        )
        cb, cs, ci = (t.contiguous() for t in nms_lib.select_candidates(
            boxes, scores, dconfig.score_threshold, dconfig.pre_nms_size
        ))
    for field in nms_lib.Detections._fields:
        a, b = getattr(kernel_det, field), getattr(plain_det, field)
        require(a.dtype == b.dtype and torch.equal(a, b), f"Detections.{field} differ")
    valid = cs > nms_cuda._PAD_SCORE
    print(f"bucket {hw}: {len(reqs)} live rows; {int(valid.sum())} candidates reached NMS "
          f"(K {cs.shape[1]} per image), {int(kernel_det.valid.sum())} kept; kernel and "
          f"plain Detections identical")

    # The kernel's row of the result line: this batch's candidates.
    kernel_ms = time_ms(lambda: nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD), 200, 10)
    kernel_device_ms = device_ms(lambda: nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD))
    mask_ms, scan_ms = nms_pass_ms(cb, cs, ci)
    plain_ms = time_ms(lambda: nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD), 10, 2)
    keep_k = nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD)
    keep_p = nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD)
    max_err = max(max_err, int((keep_k.int() - keep_p.int()).abs().max().item()))
    require(torch.equal(keep_k, keep_p), "kernel and plain differ on the served batch")
    bound_ms, bound_by = nms_bound_ms(cs, ci)
    print(f"NMS at the served shapes (B {cs.shape[0]}, K {cs.shape[1]}, {int(keep_k.sum())} kept): "
          f"kernel {kernel_ms:.4f} ms a wrapper call back to back, {kernel_device_ms:.4f} ms on the "
          f"device (mask pass {mask_ms:.4f}, scan {scan_ms:.4f}); plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); {kind}, {smi}")

    # Where a served batch's time goes: device forward and post-processing
    # (CUDA events), host resize and result conversion (host clock).
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(normalize_images(x)), 10, 2)
        post_ms = time_ms(lambda: detect_lib.postprocess(outputs, anchors, hw, dconfig), 20, 3)
    t0 = time.perf_counter()
    for img in images:
        resize_for_bucket(img, bucket_for_source(*img.shape[:2], 800, 1333, buckets), 800, 1333)
    resize_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    t0 = time.perf_counter()
    det_np = engine.fetch(kernel_det)
    fetch_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    detect_lib.detections_to_coco(
        det_np, np.arange(8), batch.scales, batch.valid, engine.label_to_cat_id
    )
    convert_ms = (time.perf_counter() - t0) * 1e3
    print(f"batch of 8 at {hw}: device forward {forward_ms:.3f} ms, device post-processing "
          f"{post_ms:.3f} ms; host: resize {resize_ms:.3f} ms an image, fetch {fetch_ms:.3f} ms, "
          f"conversion {convert_ms:.3f} ms a batch; {kind}, {smi}")

    phase(5, "reference: the card against the CPU in f32")
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    small = RetinaNetConfig(
        num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32,
        head_depth=2, dtype=torch.float32,
    )
    hw_small = (96, 128)
    cpu_model = build_retinanet(small, device="cpu", seed=1)
    gpu_model = build_retinanet(small, device=device, seed=1)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, *hw_small, 3), dtype=np.uint8))
    with torch.inference_mode():
        out_cpu = cpu_model(normalize_images(imgs))
        out_gpu = gpu_model(normalize_images(imgs.to(device)))
    for key in ("cls_logits", "box_deltas"):
        a, b = out_gpu[key].cpu(), out_cpu[key]
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        print(f"{key}: {tuple(a.shape)}, card vs CPU max abs err {err:.3e} (range {scale:.3f})")
        require(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale, f"{key} differs")
    # The same decoded boxes and scores (made on the CPU: the card's exp may
    # differ by an ulp) through the kernel path on the card and the plain
    # path on the CPU.
    anchors_cpu = detect_lib.anchors_on(hw_small, dconfig.anchor, torch.device("cpu"))
    scores = torch.sigmoid(out_cpu["cls_logits"])
    boxes = detect_lib.boxes_lib.clip_boxes(
        detect_lib.boxes_lib.decode_boxes(anchors_cpu[None], out_cpu["box_deltas"]), hw_small
    )
    det_cpu = nms_cuda.batched_multiclass_nms_cuda(boxes, scores, score_threshold=0.001)
    det_gpu = nms_cuda.batched_multiclass_nms_cuda(
        boxes.to(device), scores.to(device), score_threshold=0.001
    )
    for field in nms_lib.Detections._fields:
        require(torch.equal(getattr(det_gpu, field).cpu(), getattr(det_cpu, field)),
                f"card Detections.{field} differ from the CPU's")
    print(f"Detections on the card equal the CPU's: {int(det_cpu.valid.sum())} kept")

    nms_row = {
        "name": "nms_keep_mask",
        "route": "cuda",
        "source": "batchai_retinanet_horovod_coco_tpu_torch/ops/cuda/nms.cu",
        "replaces": "batchai_retinanet_horovod_coco_tpu/ops/pallas/nms.py:191",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "device_ms": kernel_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }
    del engine, model, outputs, x, scores, boxes, kernel_det, plain_det, cpu_model, gpu_model
    torch.cuda.empty_cache()

    batches = [train_batch(16, seed) for seed in range(6)]
    anchors = detect_lib.anchors_on(TRAIN_HW, AnchorConfig(), device)
    phase(6, "matching kernel against its plain version")
    match_row = matching_phase(anchors, batches[0], device)
    phase(7, "focal kernels against their plain versions")
    fwd_row, bwd_row = focal_phase(anchors, batches[0], device)
    phase(8, "training: ResNet-50 RetinaNet, train/loop.py")
    launches_by_kernel, batch_size = training_phase(anchors, batches, device, kind, smi)
    phase(9, "training reference: the card against the CPU in f32")
    golden_phase(device)
    phase(10, "a training run with checkpoints, eval and resume")
    run_launches = run_phase([cut_batch(b, batch_size) for b in batches], device, kind, smi)
    for row, key in ((match_row, "matching"), (fwd_row, "focal_fwd"), (bwd_row, "focal_bwd")):
        row["launches"] = launches_by_kernel[key] + run_launches[key]
    nms_row["launches"] = launches + run_launches["nms"]
    end_phases()

    print(smi)
    print(json.dumps({"kernels": [nms_row, match_row, fwd_row, bwd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def culling_field(edit: str, seed: int, anchors: torch.Tensor):
    """B 16, G 100 at TRAIN_HW, 1-60 real gts an image, reshaped by the
    culling edit ``edit`` of ``ops/cuda/cases.py`` against the kernel's
    tiles."""
    boxes, labels, mask = gt_scene(16, MAX_GT, seed, counts=(1, 60))
    rng = np.random.default_rng(seed)
    cases_lib.CULLING_EDITS[edit](boxes, mask, rng, anchors.cpu().numpy(), matching_cuda.kernel_tile())
    return boxes, labels, mask


def matching_phase(anchors: torch.Tensor, batch: pipeline_lib.Batch, device) -> dict:
    """Kernel and plain version on seeded fields and on the first training
    batch's gts: all five outputs equal; times and the culled share on the
    training batch."""
    num_anchors = anchors.shape[0]
    fields = [
        ("ragged 1-100 gts, image 3 without gt, dups on 4-5, tiny on 6-7",
         gt_scene(16, MAX_GT, 0, counts=(1, 100), empty=(3,), dup=(4, 5), tiny=(6, 7))),
        ("ragged 0-40 gts, dups on 0-7", gt_scene(16, MAX_GT, 1, counts=(0, 40), dup=range(8))),
        ("real rows after padded ones", culling_field("scatter", 2, anchors)),
        ("real gts that overlap no anchor or lie outside the image",
         culling_field("off anchors", 3, anchors)),
        ("gt edges on tile box edges", culling_field("tile edges", 4, anchors)),
        ("G 1000, every row real", gt_scene(2, 1000, 5, counts=(1000, 1000))),
        ("image 0's only gt overlaps only the last, ragged tile", culling_field("last tile", 6, anchors)),
        ("first training batch", (batch.gt_boxes, batch.gt_labels, batch.gt_mask)),
    ]
    max_err = 0.0
    tile = matching_cuda.kernel_tile()
    for name, arrays in fields:
        gts = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)
        got = matching_cuda.assign_fused(anchors, *gts)
        want = matching_cuda.assign_fused_plain(anchors, *gts)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            require(g.dtype == w.dtype and g.shape == w.shape, f"matching output {g.dtype} {g.shape}")
            max_err = max(max_err, float((g.double() - w.double()).abs().max()))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        walked = int(matching_cuda.tile_gt_lists(anchors, gts[0], gts[2], tile).sum())
        print(f"{name}: B {gts[0].shape[0]} A {num_anchors} G {gts[0].shape[1]}, "
              f"{int(gts[2].sum())} real gts, {walked} (tile, gt) pairs walked; outputs equal: {equal}")
        require(equal, f"matching kernel and plain version differ ({name})")
    # gts and want: the first training batch, the last field.
    b, g = gts[0].shape[:2]
    chunk = torch.arange(num_anchors, device=device) // 32  # a warp's chunk of anchors
    chunk_lists = matching_cuda.tile_gt_lists(anchors, gts[0], gts[2], 32)[:, chunk]
    for size in (tile, 1024):  # the kernel's tile and the first port's
        lists = matching_cuda.tile_gt_lists(anchors, gts[0], gts[2], size)
        rows, walked = lists.shape[1] * b * g, int(lists.sum())
        ious = int((lists[:, torch.arange(num_anchors, device=device) // size] & chunk_lists).sum())
        print(f"culling on the first training batch at {size}-anchor tiles: blocks walk {walked} of "
              f"{rows} (tile, gt row) pairs ({walked / rows:.2%}; {lists.shape[1] * int(gts[2].sum())} "
              f"are real gts), and {ious} (anchor, gt) IoUs in chunks the gt overlaps")
    del chunk_lists

    kernel_ms = time_ms(lambda: matching_cuda.assign_fused(anchors, *gts), 50, 5)
    kernel_device_ms = device_ms(lambda: matching_cuda.assign_fused(anchors, *gts))
    plain_ms = time_ms(lambda: matching_cuda.assign_fused_plain(anchors, *gts), 5, 1)
    bound_ms, bound_by = matching_bound_ms(num_anchors, gts[2])
    print(f"matching at the training shapes ({tile}-anchor tiles): kernel {kernel_ms:.4f} ms a wrapper "
          f"call back to back, {kernel_device_ms:.4f} ms on the device; plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by})")
    return {
        "name": "assign_fused",
        "route": "cuda",
        "source": "batchai_retinanet_horovod_coco_tpu_torch/ops/cuda/matching.cu",
        "replaces": "batchai_retinanet_horovod_coco_tpu/ops/pallas/matching.py:177",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "device_ms": kernel_device_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def focal_phase(anchors: torch.Tensor, batch: pipeline_lib.Batch, device) -> tuple[dict, dict]:
    """Forward and backward kernels against the plain version and autograd,
    on the first training batch's targets with random logits."""
    gts = tuple(torch.from_numpy(a).to(device) for a in (batch.gt_boxes, batch.gt_labels, batch.gt_mask))
    targets = matching_lib.anchor_targets_compact_batched(anchors, *gts)
    labels, state = targets.matched_labels.contiguous(), targets.state.contiguous()
    b, a = state.shape
    gen = torch.Generator(device=device).manual_seed(0)
    logits = torch.rand((b, a, 80), generator=gen, device=device) * 24 - 12
    far = torch.rand(logits.shape, generator=gen, device=device) < 0.01
    logits = torch.where(far, torch.sign(logits) * 25, logits).contiguous()
    weights = torch.linspace(0.5, 2.0, b, device=device)
    print(f"B {b} A {a} K 80: {int((state == 1).sum())} positive, "
          f"{int((state == -1).sum())} ignored anchors; {int(far.sum())} logits at +-25")

    sums = focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0)
    again = focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0)
    with torch.no_grad():
        plain = focal_cuda.focal_sums_plain(logits, labels, state)
    torch.cuda.synchronize()
    rel = float(((sums - plain).abs() / plain.abs()).max())
    print(f"forward: max rel err {rel:.3e} (limit 1e-05); two launches identical: "
          f"{torch.equal(sums, again)}")
    require(torch.equal(sums, again), "the focal forward kernel is not deterministic")
    require(rel <= 1e-5, f"focal forward differs from the plain version by rel {rel}")

    # The reference gradient is autograd of the plain version in f64: in f32
    # its own rounding (about 1e-6 of the largest gradient) exceeds the
    # kernel's closed form's.
    grad = focal_cuda.focal_bwd(logits, labels, state, weights, 0.25, 2.0)
    x64 = logits.double().requires_grad_()
    (want_grad,) = torch.autograd.grad(
        focal_cuda.focal_sums_plain(x64, labels, state), x64, weights.double()
    )
    x = logits.clone().requires_grad_()
    plain_sums = focal_cuda.focal_sums_plain(x, labels, state)
    (grad32,) = torch.autograd.grad(plain_sums, x, weights, retain_graph=True)
    torch.cuda.synchronize()
    err = float((grad.double() - want_grad).abs().max())
    err32 = float((grad32.double() - want_grad).abs().max())
    scale = float(want_grad.abs().max())
    del x64, want_grad
    print(f"backward against f64 autograd of the plain version: max abs err {err:.3e}, "
          f"{err / scale:.3e} of max |grad| {scale:.3f} (limit 1e-06); f32 autograd's own "
          f"{err32 / scale:.3e}")
    require(err <= 1e-6 * scale, "focal backward differs from autograd of the plain version")

    def fwd():
        return focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0)

    def bwd():
        return focal_cuda.focal_bwd(logits, labels, state, weights, 0.25, 2.0)

    fwd_ms, bwd_ms = time_ms(fwd, 50, 5), time_ms(bwd, 50, 5)
    fwd_device_ms, bwd_device_ms = device_ms(fwd, 5, 4), device_ms(bwd, 5, 4)
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: focal_cuda.focal_sums_plain(logits, labels, state), 5, 1)
    plain_bwd_ms = time_ms(
        lambda: torch.autograd.grad(plain_sums, x, weights, retain_graph=True), 5, 1
    )
    del plain_sums, x
    rows = []
    for name, line, ms, dms, pms, backward, e in (
        ("focal_fwd", 143, fwd_ms, fwd_device_ms, plain_fwd_ms, False, float((sums - plain).abs().max())),
        ("focal_bwd", 183, bwd_ms, bwd_device_ms, plain_bwd_ms, True, err),
    ):
        bound_ms, bound_by = focal_bound_ms(logits, state, backward)
        print(f"{name}: kernel {ms:.4f} ms a wrapper call back to back, {dms:.4f} ms on the device; "
              f"plain {pms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by})")
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "batchai_retinanet_horovod_coco_tpu_torch/ops/cuda/focal.cu",
            "replaces": f"batchai_retinanet_horovod_coco_tpu/ops/pallas/focal.py:{line}",
            "launches": None,
            "max_abs_err": e,
            "ms": ms,
            "device_ms": dms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    return rows[0], rows[1]


def plain_step_loss(model, arrays: dict, anchors: torch.Tensor) -> float:
    """The first step's loss through the plain versions on the card: the
    same forward, the plain matching and the plain focal sums."""
    with torch.no_grad():
        out = model(normalize_images(arrays["images"]))
        t = matching_lib.anchor_targets_compact(
            anchors, arrays["gt_boxes"], arrays["gt_labels"], arrays["gt_mask"]
        )
        cls = losses_lib._normalize_per_image(
            losses_lib.focal_sums_compact(out["cls_logits"], t.matched_labels, t.state), t.state
        )
        box = losses_lib.smooth_l1_loss(out["box_deltas"], t.box_targets, t.state)
    return float(cls + box)


def cut_batch(batch: pipeline_lib.Batch, batch_size: int) -> pipeline_lib.Batch:
    return batch._replace(**{f: getattr(batch, f)[:batch_size] for f in batch._fields})


def training_phase(anchors, batches, device, kind: str, smi: str) -> tuple[dict[str, int], int]:
    """6 steps of train/loop.py at full width; returns each training
    kernel's launches in that run, and the global batch that fitted."""
    for batch_size in (16, 8):
        cut = [cut_batch(b, batch_size) for b in batches]
        try:
            return train_full_width(anchors, cut, device, kind, smi), batch_size
        except torch.cuda.OutOfMemoryError:
            print(f"global batch {batch_size} does not fit in the card's memory")
        torch.cuda.empty_cache()  # outside the handler: its frames are gone
    raise SystemExit("chip_smoke: FAILED: training fits at neither batch 16 nor 8")


def train_full_width(anchors, batches, device, kind: str, smi: str) -> dict[str, int]:
    batch_size = batches[0].images.shape[0]
    t0 = time.perf_counter()
    model = build_retinanet(RetinaNetConfig(), device=device, seed=0)  # gn, bf16
    state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(), device)
    model.train()
    plain_loss = plain_step_loss(model, loop_lib.device_batch(batches[0], device), anchors)
    print(f"model built in {time.perf_counter() - t0:.1f} s; global batch {batch_size} at "
          f"{TRAIN_HW}, {[int(b.gt_mask.sum()) for b in batches]} gts a batch; first-step "
          f"loss through the plain versions {plain_loss:.6f}")

    logged: list[dict] = []
    matching_cuda.reset_counts()
    focal_cuda.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop_lib.run_training(
        state, iter(batches), 80, loop_lib.LoopConfig(total_steps=len(batches), log_every=1),
        log=lambda step, scalars: logged.append(scalars),
    )
    wall = time.perf_counter() - t0
    launches = {
        "matching": matching_cuda.kernel_launches,
        "focal_fwd": focal_cuda.fwd_launches,
        "focal_bwd": focal_cuda.bwd_launches,
    }
    plain = {"matching": matching_cuda.plain_calls, "focal": focal_cuda.plain_calls}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps = len(batches)
    print(f"{steps} steps in {wall:.2f} s; kernel launches {launches}, plain calls {plain}")
    for i, sc in enumerate(logged, 1):
        print(f"step {i}: loss {sc['loss']:.6f} (cls {sc['cls_loss']:.6f}, box {sc['box_loss']:.6f}), "
              f"num_pos {sc['num_pos']:.0f}, grad_norm {sc['grad_norm']:.4f}, param_norm "
              f"{sc['param_norm']:.4f}, lr {sc['lr']:.3e}, {sc['step_time_ms']:.1f} ms")
    require(all(n == steps for n in launches.values()), f"launches {launches} for {steps} steps")
    require(all(n == 0 for n in plain.values()), f"the plain versions ran on the card: {plain}")
    require(all(np.isfinite([sc["loss"], sc["grad_norm"], sc["param_norm"]]).all() for sc in logged),
            "a non-finite loss or norm")
    rel = abs(logged[0]["loss"] - plain_loss) / abs(plain_loss)
    print(f"first-step loss {logged[0]['loss']:.6f} against the plain versions' {plain_loss:.6f}: "
          f"rel err {rel:.3e} (limit 1e-04)")
    require(rel <= 1e-4, "the first step's loss differs from the plain versions'")

    # Two more steps, split by CUDA events at the step's phase boundaries.
    step_fn = step_lib.make_train_step(model, TRAIN_HW, 80, device=device)
    totals = dict.fromkeys(step_lib.PHASES, 0.0)
    timed = 2
    for batch in batches[:timed]:
        arrays = loop_lib.device_batch(batch, device)
        torch.cuda.synchronize()
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def mark(name):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append((name, event))

        step_fn(state, arrays, mark)
        torch.cuda.synchronize()
        for (_, a), (name, b) in zip(marks, marks[1:]):
            totals[name] += a.elapsed_time(b) / timed
    step_ms = sum(totals.values())
    rates = [sc["images_per_sec"] for sc in logged[1:]]
    print("step split (ms, mean of 2 steps, CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in totals.items()) + f"; total {step_ms:.3f}")
    print(f"images/s: {batch_size * 1e3 / step_ms:.2f} from the split, median "
          f"{float(np.median(rates)):.2f} over steps 2-{steps} of the loop (host clock, with "
          f"the metrics read every step); peak memory {peak_gb:.2f} GiB; {kind}, {smi}")
    del state, model, step_fn
    torch.cuda.empty_cache()
    return launches


def golden_phase(device) -> None:
    """The golden configuration, 5 steps on the card and on the CPU, f32."""
    rng = np.random.default_rng(42)
    batch = pipeline_lib.Batch(
        images=rng.normal(0, 1, (4, *GOLDEN_HW, 3)).astype(np.float32),
        gt_boxes=np.tile(np.array([[[10.0, 10.0, 50.0, 50.0]]], np.float32), (4, 1, 1)),
        gt_labels=np.ones((4, 1), np.int32),
        gt_mask=np.ones((4, 1), bool),
        image_ids=np.arange(4), scales=np.ones(4, np.float32), valid=np.ones(4, bool),
    )
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    trajectories = {}
    for dev in (torch.device("cpu"), device):
        model = build_retinanet(RetinaNetConfig(**GOLDEN_MODEL), device=dev, seed=42)
        state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(**GOLDEN_OPT), dev)
        losses = []
        loop_lib.run_training(state, iter([batch] * 5), 3, loop_lib.LoopConfig(total_steps=5, log_every=1),
                              log=lambda step, scalars: losses.append(scalars["loss"]))
        trajectories[dev.type] = losses
    cpu, gpu = np.array(trajectories["cpu"]), np.array(trajectories["cuda"])
    rel = float(np.max(np.abs(gpu - cpu) / np.abs(cpu)))
    print(f"losses on the card {[f'{v:.7f}' for v in gpu]}, on the CPU "
          f"{[f'{v:.7f}' for v in cpu]}: max rel err {rel:.3e} (limit 1e-04)")
    require(bool(np.all(np.diff(gpu) < 0)), "the loss does not fall every step on the card")
    require(rel <= 1e-4, "the card's trajectory differs from the CPU's")


def validation_set(root: str, model: torch.nn.Module, dconfig, device) -> tuple[CocoDataset, list[pipeline_lib.Batch]]:
    """VAL_IMAGES seeded uint8 images of 600-800 by 900-1344 pixels with
    0-40 boxes each (about a tenth crowd) of 80 categories: the COCO
    annotations are written to ``root`` and read back by the port's
    ``CocoDataset``; the images are resized into TRAIN_HW and batched at
    EVAL_BATCH, the last batch padded with ``valid=False`` rows.

    Random weights find none of those boxes, and every COCO stat would be
    0 whatever the weights: so each image also gets, as ground truth, its
    VAL_FOUND highest-scored detections of ``model`` (jittered by up to
    10%), and the stats depend on the weights."""
    rng = np.random.default_rng(2000)
    images, annotations, pixels = [], [], {}
    for img_id in range(1, VAL_IMAGES + 1):
        h, w = int(rng.integers(600, 801)), int(rng.integers(900, 1345))
        images.append({"id": img_id, "file_name": f"{img_id:012d}.jpg", "width": w, "height": h})
        pixels[img_id] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(int(rng.integers(0, 41))):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                "category_id": int(rng.integers(1, 81)), "bbox": [x, y, bw, bh],
                                "area": bw * bh, "iscrowd": int(rng.random() < 0.1)})
    blob = {"images": images, "annotations": annotations,
            "categories": [{"id": c, "name": f"class{c}"} for c in range(1, 81)]}
    path = os.path.join(root, "instances_val.json")

    def write() -> CocoDataset:
        with open(path, "w") as f:
            json.dump(blob, f)
        return CocoDataset(path, keep_empty=True)

    dataset = write()
    examples = []
    for rec in dataset.records:
        image, scale = resize_for_bucket(pixels[rec.image_id], TRAIN_HW, 800, 1333)
        examples.append((rec.image_id, (image, rec.boxes * scale, rec.labels, scale)))
    batches = []
    for i in range(0, len(examples), EVAL_BATCH):
        chunk = examples[i:i + EVAL_BATCH]
        batch = pipeline_lib.assemble([e for _, e in chunk], [k for k, _ in chunk], TRAIN_HW, MAX_GT)
        batches.append(pipeline_lib.pad_batch(batch, EVAL_BATCH))
    found: dict[int, list[dict]] = {}
    for d in detect_lib.collect_detections(model, dataset, batches, dconfig, device):
        found.setdefault(d["image_id"], []).append(d)
    for dets in found.values():
        for d in sorted(dets, key=lambda d: -d["score"])[:VAL_FOUND]:
            x, y, w, h = (float(v) for v in np.asarray(d["bbox"]) * rng.uniform(0.9, 1.1, 4))
            annotations.append({"id": len(annotations) + 1, "image_id": d["image_id"],
                                "category_id": d["category_id"], "bbox": [x, y, w, h],
                                "area": w * h, "iscrowd": 0})
    return write(), batches


def weights_digest(model: torch.nn.Module) -> float:
    """The sum of every parameter and buffer in f64: equal weights give an
    equal digest (the reduction's order is fixed)."""
    with torch.no_grad():
        return float(sum(t.double().sum() for t in model.state_dict().values()))


def saved_leaves(ckpt_dir: str) -> list[tuple[str, np.ndarray]]:
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    return [(e["path"], np.load(os.path.join(ckpt_dir, e["file"]))) for e in manifest["leaves"]]


def run_phase(batches, device, kind: str, smi: str) -> dict[str, int]:
    """Phase 10 at the global batch of ``batches`` (8 if that does not
    fit); returns each kernel's launches in the run."""
    for batch_size in sorted({batches[0].images.shape[0], 8}, reverse=True):
        root = tempfile.mkdtemp(prefix="chip_smoke_run_")
        try:
            return train_eval_resume([cut_batch(b, batch_size) for b in batches], root, device, kind, smi)
        except torch.cuda.OutOfMemoryError:
            print(f"global batch {batch_size} does not fit in the card's memory with an eval")
        finally:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    raise SystemExit("chip_smoke: FAILED: the training run fits at neither batch 16 nor 8")


def train_eval_resume(batches, root: str, device, kind: str, smi: str) -> dict[str, int]:
    steps, every = len(batches), 3
    dconfig = detect_lib.DetectConfig(score_threshold=0.001)
    t0 = time.perf_counter()
    state = state_lib.create_train_state(
        build_retinanet(RetinaNetConfig(), device=device, seed=0), optim_lib.OptimizerConfig(), device
    )
    print(f"model built in {time.perf_counter() - t0:.1f} s; global batch {batches[0].images.shape[0]}")
    dataset, val_batches = validation_set(root, state.model, dconfig, device)
    eval_spans: list[tuple[float, float]] = []

    def eval_fn(model: torch.nn.Module) -> dict[str, float]:
        t0 = time.perf_counter()
        metrics = detect_lib.run_coco_eval(model, dataset, val_batches, dconfig, device)
        metrics["weights_digest"] = weights_digest(model)
        eval_spans.append((t0, time.perf_counter()))
        return metrics

    ckpt_dir, prof_dir = os.path.join(root, "ckpt"), os.path.join(root, "profile")
    config = loop_lib.LoopConfig(
        total_steps=steps, log_every=1, checkpoint_every=every, eval_every=every, async_eval=True,
        device_prefetch=2, max_to_keep=2, checkpoint_dir=ckpt_dir, profile_dir=prof_dir,
        profile_start_step=5, profile_steps=1,
    )
    gts = sum(len(r.boxes) + len(r.crowd_boxes) for r in dataset.records)
    print(f"validation set: {len(dataset)} images, {gts} gt boxes ({VAL_FOUND} an image from the "
          f"initial model's detections), batches of {[int(b.valid.sum()) for b in val_batches]} real "
          f"rows in {EVAL_BATCH}")

    logged: list[tuple[int, dict]] = []
    matching_cuda.reset_counts()
    focal_cuda.reset_counts()
    nms_cuda.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loop_lib.run_training(state, iter(batches), 80, config, log=lambda step, sc: logged.append((step, sc)),
                          eval_fn=eval_fn)
    wall = time.perf_counter() - t0
    launches = {"matching": matching_cuda.kernel_launches, "focal_fwd": focal_cuda.fwd_launches,
                "focal_bwd": focal_cuda.bwd_launches, "nms": nms_cuda.kernel_launches}
    plain = {"matching": matching_cuda.plain_calls, "focal": focal_cuda.plain_calls,
             "nms": nms_cuda.plain_calls}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    train_logs = {step: sc for step, sc in logged if "loss" in sc}
    eval_logs = {step: sc for step, sc in logged if "eval/AP" in sc}
    eval_batches = len(eval_logs) * len(val_batches)
    print(f"{steps} steps with evals at {sorted(eval_logs)} in {wall:.2f} s; kernel launches {launches} "
          f"({eval_batches} eval batches dispatched), plain calls {plain}")
    for step, sc in sorted(train_logs.items()):
        print(f"step {step}: loss {sc['loss']:.6f}, {sc['step_time_ms']:.1f} ms, data wait "
              f"{sc['data_wait_ms']:.3f} ms, lr {sc['lr']:.3e}")
    for step, sc in sorted(eval_logs.items()):
        print(f"eval at step {step}: " + ", ".join(f"{k} {sc['eval/' + k]:.6f}" for k in COCO_STATS))
    require(sorted(train_logs) == list(range(1, steps + 1)) and sorted(eval_logs) == [every, steps],
            f"logged steps {sorted(train_logs)}, evals {sorted(eval_logs)}")
    require(all(launches[k] == steps for k in ("matching", "focal_fwd", "focal_bwd")),
            f"launches {launches} for {steps} steps")
    require(launches["nms"] == eval_batches, f"{launches['nms']} NMS launches for {eval_batches} eval batches")
    require(all(n == 0 for n in plain.values()), f"the plain versions ran on the card: {plain}")
    require(sorted(os.listdir(ckpt_dir)) == [f"ckpt-{every}", f"ckpt-{steps}"],
            f"checkpoints {sorted(os.listdir(ckpt_dir))} with max_to_keep 2")
    waits = [train_logs[s]["data_wait_ms"] for s in range(2, steps + 1)]
    print(f"data_wait_ms over steps 2-{steps}: median {float(np.median(waits)):.3f}, max {max(waits):.3f}; "
          f"peak memory {peak_gb:.2f} GiB; {kind}, {smi}")

    # The async eval of step 3 against a synchronous eval of ckpt-3 restored
    # into a model built from other weights.
    fresh = state_lib.create_train_state(
        build_retinanet(RetinaNetConfig(), device=device, seed=1), optim_lib.OptimizerConfig(), device
    )
    t0 = time.perf_counter()
    CheckpointManager(ckpt_dir).restore(fresh, step=every)
    restore_s = time.perf_counter() - t0
    saved = saved_leaves(os.path.join(ckpt_dir, f"ckpt-{every}"))
    got = state_lib.snapshot(fresh)
    require([p for p, _ in got] == [p for p, _ in saved], "restored leaves differ in their paths")
    unequal = [p for (p, a), (_, b) in zip(got, saved) if a.dtype != b.dtype or not np.array_equal(a, b)]
    require(not unequal, f"restored leaves differ from the saved ones: {unequal[:3]}")
    t0 = time.perf_counter()
    sync = eval_fn(fresh.model)
    eval_s = time.perf_counter() - t0
    async_metrics = eval_logs[every]
    gap = max(abs(sync[k] - async_metrics["eval/" + k]) for k in COCO_STATS)
    print(f"ckpt-{every} restored in {restore_s:.3f} s, all {len(saved)} leaves equal to the saved ones "
          f"bit for bit; synchronous eval of it in {eval_s:.2f} s: max stat gap to the async eval "
          f"{gap:.3e} (limit 1e-06), weights digest {sync['weights_digest']!r} against "
          f"{async_metrics['eval/weights_digest']!r}")
    require(gap <= 1e-6, "the async eval differs from a synchronous eval of its checkpoint")
    require(async_metrics["eval/AP"] > 0, "every COCO stat is 0: the eval compares nothing")
    require(sync["weights_digest"] == async_metrics["eval/weights_digest"],
            "the async eval saw other weights than its step's checkpoint")
    del fresh

    # Resume from ckpt-3 on a state built from other weights.
    resume_dir = os.path.join(root, "resume")
    shutil.copytree(os.path.join(ckpt_dir, f"ckpt-{every}"), os.path.join(resume_dir, f"ckpt-{every}"))
    resumed = state_lib.create_train_state(
        build_retinanet(RetinaNetConfig(), device=device, seed=1), optim_lib.OptimizerConfig(), device
    )
    resumed_logs: dict[int, dict] = {}
    loop_lib.run_training(
        resumed, iter(batches[every:]), 80,
        loop_lib.LoopConfig(total_steps=steps, log_every=1, checkpoint_every=every, checkpoint_dir=resume_dir),
        log=lambda step, sc: resumed_logs.setdefault(step, sc),
    )
    rel = max(abs(resumed_logs[s]["loss"] - train_logs[s]["loss"]) / abs(train_logs[s]["loss"])
              for s in range(every + 1, steps + 1))
    print(f"resumed from ckpt-{every}: losses {[round(resumed_logs[s]['loss'], 6) for s in sorted(resumed_logs)]} "
          f"against {[round(train_logs[s]['loss'], 6) for s in range(every + 1, steps + 1)]}: max rel err "
          f"{rel:.3e} (limit 1e-04)")
    require(sorted(resumed_logs) == list(range(every + 1, steps + 1)) and rel <= 1e-4,
            "the resumed run's losses differ from the uninterrupted run's")
    del resumed

    # Pipelined and sequential eval drivers on the final state.
    t0 = time.perf_counter()
    pipelined = detect_lib.collect_detections(state.model, dataset, val_batches, dconfig, device)
    t1 = time.perf_counter()
    sequential = detect_lib.collect_detections(state.model, dataset, val_batches, dconfig, device,
                                               pipelined=False)
    t2 = time.perf_counter()
    print(f"collect_detections: {len(pipelined)} results pipelined in {t1 - t0:.3f} s, sequential in "
          f"{t2 - t1:.3f} s; identical: {pipelined == sequential}")
    require(pipelined == sequential, "pipelined and sequential eval drivers differ")
    require(all(d["image_id"] >= 1 for d in pipelined), "a padding row produced a detection")

    # Where the time goes: the checkpoint, a detect batch, the eval.
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt_dir, f"ckpt-{steps}", n))
                     for n in os.listdir(os.path.join(ckpt_dir, f"ckpt-{steps}")))
    manager = CheckpointManager(os.path.join(root, "timing"))
    t0 = time.perf_counter()
    manager.save(state, step=state.step)
    t1 = time.perf_counter()
    manager.close()
    t2 = time.perf_counter()
    detect = detect_lib.make_detect_fn(state.model, TRAIN_HW, dconfig, device)
    images = detect_lib.to_device_images(val_batches[0].images, device)
    detect_ms = time_ms(lambda: detect(images), 10, 2)
    async_s = eval_spans[0][1] - eval_spans[0][0]
    print(f"checkpoint: {ckpt_bytes} bytes in {len(saved)} leaves; save: host snapshot {t1 - t0:.3f} s, "
          f"write {t2 - t1:.3f} s; restore {restore_s:.3f} s; eval: async at step {every} "
          f"{async_s:.2f} s, synchronous {eval_s:.2f} s for {len(val_batches)} batches; detect batch of "
          f"{EVAL_BATCH} {detect_ms:.3f} ms on the device; {kind}, {smi}")

    # A step's time with an async eval in flight against without one, each
    # step timed to a sync of the training stream alone (the eval runs on
    # its own stream), and the async eval against a synchronous one.
    step_fn = step_lib.make_train_step(state.model, TRAIN_HW, 80, device=device)
    arrays = [loop_lib.device_batch(b, device) for b in batches[:3]]

    def one_step(i: int) -> float:
        t = time.perf_counter()
        step_fn(state, arrays[i % len(arrays)])
        torch.cuda.current_stream(device).synchronize()
        return (time.perf_counter() - t) * 1e3

    done = threading.Event()
    runner = loop_lib._AsyncEvalRunner(lambda m: (eval_fn(m), done.set())[0], lambda *_: None, device)

    def async_eval(during_eval) -> float:
        """Launch an async eval, call ``during_eval()`` until it ends;
        returns the seconds from the launch to the eval's join."""
        done.clear()
        t0 = time.perf_counter()
        runner.launch(state.model, state.step)
        while not done.is_set():
            during_eval()
        runner.join()
        return time.perf_counter() - t0

    async_eval(lambda: time.sleep(0.01))  # the runner makes its snapshot model at its first launch
    t0 = time.perf_counter()
    eval_fn(state.model)
    sync_eval_s = time.perf_counter() - t0
    alone = [one_step(i) for i in range(5)]
    during: list[float] = []
    async_wall = async_eval(lambda: during.append(one_step(len(during))))
    alone_ms, during_ms = float(np.mean(alone)), float(np.mean(during))
    sync_wall = len(during) * alone_ms / 1e3 + sync_eval_s
    print(f"step ms (host clock to a sync of the training stream): {alone_ms:.3f} without an eval in "
          f"flight ({len(alone)} steps), {during_ms:.3f} with one ({len(during)} steps); {kind}, {smi}")
    print(f"async eval: {len(during)} steps and the eval in {async_wall:.3f} s (the eval "
          f"{eval_spans[-1][1] - eval_spans[-1][0]:.3f} s); the same steps alone and a synchronous eval "
          f"({sync_eval_s:.3f} s): {sync_wall:.3f} s; async_eval is {'faster' if async_wall < sync_wall else 'slower'} by "
          f"{abs(sync_wall - async_wall):.3f} s at this eval size; {kind}, {smi}")
    require(len(during) > 0, "no step ran while the async eval was in flight")

    # The same, profiled: 3 steps without an eval in flight, and every step
    # of one async eval.  The card's share of the slowdown is the growth of
    # the training stream's kernel time a step; the rest is the host's.
    alone_steps: list[float] = []
    during_steps: list[float] = []
    steps_ms = {"no eval in flight": alone_steps, "an eval in flight": during_steps}
    splits = {
        "no eval in flight": profiled(lambda: alone_steps.extend(one_step(i) for i in range(3)),
                                      os.path.join(root, "alone.json")),
        "an eval in flight": profiled(lambda: async_eval(lambda: during_steps.append(one_step(len(during_steps)))),
                                      os.path.join(root, "during.json")),
    }
    for label, sp in splits.items():
        n = sp["n"] = len(steps_ms[label])
        sp["step_ms"] = float(np.mean(steps_ms[label]))
        print(f"profiled, {label}: {n} steps of {sp['step_ms']:.3f} ms on the host clock; training stream "
              f"{sp['train_ms'] / n:.3f} ms of kernels a step ({sp['train_ms'] / n / sp['step_ms']:.1%} busy), "
              f"other streams {sp['other_ms']:.3f} ms of kernels in all; {kind}, {smi}")
    a, d = splits["no eval in flight"], splits["an eval in flight"]
    require(d["other_ms"] > 0, "no eval kernel ran during the profiled steps")
    extra, card = d["step_ms"] - a["step_ms"], d["train_ms"] / d["n"] - a["train_ms"] / a["n"]
    print(f"eval in flight: a step takes {extra:.3f} ms more, of which the training stream's kernels "
          f"{card:.3f} ms (the card) and the rest {extra - card:.3f} ms (the host)")

    loop_split = dict(stream_split(os.path.join(prof_dir, "trace-steps-5-5.json")), n=1)
    print(f"train/loop.py's profiled step 5 ran with step {every}'s eval in flight: "
          f"{loop_split['other_ms']:.3f} ms of kernels on other streams during it")
    top_kernels(loop_split, "the loop's profiled step 5", kind, smi)
    top_kernels(a, "a step with no eval in flight (mean of 3)", kind, smi)
    return launches


def profiled(run, path: str) -> dict:
    """``run()`` under ``torch.profiler`` (CPU and CUDA), its trace written
    to ``path``; returns ``stream_split`` of it."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run()
    prof.export_chrome_trace(path)
    return stream_split(path)


def stream_split(path: str) -> dict:
    """Kernel device time in a trace: on the training stream (the stream
    of the focal kernels) by name, and on every other stream in all."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    streams = {e.get("args", {}).get("stream") for e in kernels if "focal" in e.get("name", "")}
    require(len(streams) == 1, f"{path}: focal kernels on streams {streams}, not on one training stream")
    by_name: dict[str, float] = {}
    other_ms = 0.0
    for e in kernels:
        if e.get("args", {}).get("stream") in streams:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
        else:
            other_ms += e["dur"] / 1e3
    return {"by_name": by_name, "train_ms": sum(by_name.values()), "other_ms": other_ms}


def top_kernels(split: dict, label: str, kind: str, smi: str) -> None:
    """The 10 CUDA kernels with the most device time on the training
    stream, a step."""
    n = split["n"]
    total = split["train_ms"] / n
    print(f"{label}: {total:.3f} ms of device time a step on the training stream; the 10 kernels that "
          f"took the most ({kind}, {smi}):")
    for name, ms in sorted(split["by_name"].items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms / n:9.3f} ms {ms / n / total:6.1%}  {name[:150]}")


if __name__ == "__main__":
    sys.exit(main())
