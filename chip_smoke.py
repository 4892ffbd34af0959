"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``batchai_retinanet_horovod_coco_tpu_torch`` on the card, in twelve
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
   with no eval in flight;
11. from image files through the command line: (a) builds the image codec
   (``native/imagecodec.cpp``) with g++, decodes every JPEG fixture of
   ``tests/fixtures/jpeg`` to the sha256 of PIL's pixels that
   ``digests.json`` holds (the progressive one must raise), times one
   640 x 480 decode on the host, and sweeps ``build_pipeline``'s images/s
   at 1, 2, 4 and 8 decode threads (batch 16, buckets (800, 1344) and
   (1344, 800)) over a COCO JSON that names the four 640 x 480 fixtures 64
   times; (b) ``train.main`` at the defaults (ResNet-50, GN, bf16, batch
   16, sides 800/1333) on that JSON for 6 steps with a checkpoint every 3
   and a final COCO eval of 16 records, then ``evaluate.main`` on the
   snapshot, whose 12 stats must equal the run's final eval exactly; it
   prints images/s and ``data_wait_ms`` from files; (c) the convergence
   gate of ``tests/integration/test_convergence_gate.py``: 300 steps of
   its recipe through ``train.main`` on 64 synthetic images, then
   ``--preset eval``, which must reach AP50 > 0.15.  The counters are
   zeroed before each run and read after it: the training kernels
   launched once a step, NMS at least once an eval, the plain versions
   never;
12. the deployable server: ``convert_model.main`` exports phase 11's
   snapshot (ResNet-50, GN, bf16) for the bucket that the fixture JPEGs
   route to, (800, 1344), at batch sizes 1 and 8, and prints the seconds
   a program and the bytes an artifact; a fresh process that imports
   torch and the NMS op only loads one program and runs it (its load
   seconds; no ``models`` module, the kernel launched, the plain version
   not); ``DetectEngine.from_export`` behind ``DetectionServer`` and
   ``serve_http`` answers the fixture JPEGs from 8 and from 32 client
   threads, every answer equal, bit for bit, to the live
   ``DetectEngine.from_state`` engine's on the same weights at an
   exported batch size, then the same load through in-process
   ``submit``: images/s and p50/p99 latency of both.  The counters are
   zeroed before each load and read after it: NMS launched at least once
   a served batch, the plain version never.  A progressive JPEG is
   answered 400, an unknown path 404, and the trace header is echoed;
   ``python -m ...serve --images`` writes records equal to the live
   answers, and ``--http 0`` drains and exits 0 on SIGTERM.

Then it prints one JSON line with each kernel's launches, error, times and
bound, and as its last line ``{"ok": true, "device": {...}}``.  A kernel's
``ms`` there is CUDA events around wrapper calls made back to back, as the
plain version's ``plain_ms``; ``device_ms`` is the same call's device time
from a replayed CUDA graph, without the host's time to launch it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch import convert_model as convert_cli
from batchai_retinanet_horovod_coco_tpu_torch import losses as losses_lib
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.data.coco import CocoDataset
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    default_buckets,
    normalize_images,
)
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import __main__ as evaluate_cli
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
    RetinaNet,
    RetinaNetConfig,
    build_retinanet,
)
from batchai_retinanet_horovod_coco_tpu_torch.native import build as native_build
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import cases as cases_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as train_cli
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as loop_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as optim_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import state as state_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import step as step_lib
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import assemble_requests
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as serve_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import ServeConfig, ServeRequest
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
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "jpeg"
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
    root = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        phase(11, "from image files through the command line")
        file_launches = files_phase(root, device, kind, smi)
        phase(12, "the deployable server: export, load without model code, serve over HTTP")
        served_launches = deployable_phase(os.path.join(root, "snap"), root, device, kind, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for row, key in ((match_row, "matching"), (fwd_row, "focal_fwd"), (bwd_row, "focal_bwd")):
        row["launches"] = launches_by_kernel[key] + run_launches[key] + file_launches[key]
    nms_row["launches"] = launches + run_launches["nms"] + file_launches["nms"] + served_launches
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



def counts() -> dict[str, int]:
    """Every kernel's launches and every plain version's calls since the
    counters were last zeroed."""
    return {
        "matching": matching_cuda.kernel_launches,
        "focal_fwd": focal_cuda.fwd_launches,
        "focal_bwd": focal_cuda.bwd_launches,
        "nms": nms_cuda.kernel_launches,
        "plain": matching_cuda.plain_calls + focal_cuda.plain_calls + nms_cuda.plain_calls,
    }


def reset_all_counts() -> None:
    matching_cuda.reset_counts()
    focal_cuda.reset_counts()
    nms_cuda.reset_counts()


def fixture_coco(root: str, images: int, seed: int) -> str:
    """A COCO instances JSON naming the four 640 x 480 fixtures ``images``
    times over, 80 categories, 1-12 seeded boxes an image."""
    rng = np.random.default_rng(seed)
    names = [str(JPEG_FIXTURES / f"coco_{i}.jpg") for i in range(4)]
    blob = {"images": [], "annotations": [],
            "categories": [{"id": k + 1, "name": f"class{k}"} for k in range(80)]}
    for image_id in range(1, images + 1):
        blob["images"].append({"id": image_id, "file_name": names[image_id % 4], "width": 640,
                               "height": 480})
        for _ in range(int(rng.integers(1, 13))):
            w, h = rng.uniform(16, 320), rng.uniform(16, 240)
            x, y = rng.uniform(0, 640 - w), rng.uniform(0, 480 - h)
            blob["annotations"].append({
                "id": len(blob["annotations"]) + 1, "image_id": image_id,
                "category_id": int(rng.integers(1, 81)), "bbox": [x, y, w, h], "area": w * h,
                "iscrowd": 0,
            })
    path = os.path.join(root, f"instances_{seed}.json")
    with open(path, "w") as f:
        json.dump(blob, f)
    return path


def add_found_boxes(val_json: str, device) -> None:
    """Random weights find none of the fixtures' random boxes, and every
    COCO stat would be 0 whatever the weights: so each validation record
    also gets, as ground truth, VAL_FOUND of the highest-scored detections
    of the model that ``train.main`` starts from (the defaults' seed 0),
    jittered by up to 10%, and the stats depend on the weights."""
    rng = np.random.default_rng(3000)
    dataset = CocoDataset(val_json, str(JPEG_FIXTURES), keep_empty=True)
    model = build_retinanet(RetinaNetConfig(), device=device, seed=0)
    batches = pipeline_lib.build_pipeline(dataset, pipeline_lib.PipelineConfig(
        batch_size=16, buckets=default_buckets(800, 1333), max_gt=16, shuffle=False,
        hflip_prob=0.0), train=False)
    try:
        found: dict[int, list[dict]] = {}
        for d in detect_lib.collect_detections(
                model, dataset, batches, detect_lib.DetectConfig(score_threshold=0.001), device):
            found.setdefault(d["image_id"], []).append(d)
    finally:
        batches.close()
    with open(val_json) as f:
        blob = json.load(f)
    for dets in found.values():
        for d in sorted(dets, key=lambda d: -d["score"])[:VAL_FOUND]:
            x, y, w, h = (float(v) for v in np.asarray(d["bbox"]) * rng.uniform(0.9, 1.1, 4))
            blob["annotations"].append({"id": len(blob["annotations"]) + 1, "image_id": d["image_id"],
                                        "category_id": d["category_id"], "bbox": [x, y, w, h],
                                        "area": w * h, "iscrowd": 0})
    with open(val_json, "w") as f:
        json.dump(blob, f)
    del model
    torch.cuda.empty_cache()


def read_log(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def files_phase(root: str, device, kind: str, smi: str) -> dict[str, int]:
    """Phase 11 under ``root`` (its snapshot stays for phase 12); returns
    each kernel's launches in its runs."""
    codec_and_pipeline(root, kind, smi)
    return cli_runs(root, device, kind, smi)


def codec_and_pipeline(root: str, kind: str, smi: str) -> None:
    """(a) the codec against the fixtures' digests, one decode's time, and
    the pipeline's images/s by decode threads."""
    t0 = time.perf_counter()
    native_build.compile_library("imagecodec")
    print(f"built native/imagecodec.cpp with g++ in {time.perf_counter() - t0:.1f} s")
    digests = json.loads((JPEG_FIXTURES / "digests.json").read_text())
    for name, want in digests.items():
        path = JPEG_FIXTURES / name
        if want["progressive"]:
            try:
                image_io.read_rgb(path)
            except ValueError as e:
                print(f"{name}: refused as it must be ({e})")
                continue
            require(False, f"{name}: a progressive JPEG decoded")
        pixels = image_io.read_rgb(path)
        digest = hashlib.sha256(pixels.tobytes()).hexdigest()
        require(list(pixels.shape) == want["shape"] and digest == want["sha256"],
                f"{name}: decoded pixels differ from PIL's (sha256 {digest})")
    print(f"{len(digests) - 1} fixtures decode to their PIL digests bit for bit")
    data = (JPEG_FIXTURES / "coco_0.jpg").read_bytes()
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        image_io.decode(data)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"decode of a 640 x 480 4:2:0 JPEG ({len(data)} bytes): median {np.median(times):.3f} ms, "
          f"min {min(times):.3f} ms over 30 on the host ({os.cpu_count()} cores); {kind}, {smi}")

    dataset = CocoDataset(fixture_coco(root, 64, 0), str(JPEG_FIXTURES))
    for workers in (1, 2, 4, 8):
        it = pipeline_lib.build_pipeline(dataset, pipeline_lib.PipelineConfig(
            batch_size=16, buckets=default_buckets(800, 1333), max_gt=16, num_workers=workers))
        try:
            next(it)  # warm-up
            batches = 3 if workers == 1 else 6
            t0 = time.perf_counter()
            for _ in range(batches):
                batch = next(it)
            rate = 16 * batches / (time.perf_counter() - t0)
        finally:
            it.close()
        require(batch.images.shape == (16, *TRAIN_HW, 3), f"pipeline batch {batch.images.shape}")
        print(f"build_pipeline, {workers} decode thread(s): {rate:.2f} images/s at batch 16 into "
              f"{TRAIN_HW} (decode, flip, resize 640x480 -> 1067x800, pad), against the step's "
              f"72.46 images/s (PERF.md section 5); {kind}, {smi}")


def cli_runs(root: str, device, kind: str, smi: str) -> dict[str, int]:
    """(b) a full-width run from JPEG files through ``train.main`` and the
    snapshot's ``evaluate.main``, and the same steps on 4 decode threads;
    (c) the convergence gate."""
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)
    train_json = fixture_coco(root, 64, 0)
    val_json = fixture_coco(root, 16, 1)
    add_found_boxes(val_json, device)
    snap, logs = os.path.join(root, "snap"), os.path.join(root, "logs")
    files = ["coco", root, "--train-annotations", os.path.basename(train_json), "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", os.path.basename(val_json), "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", snap, "--score-threshold", "0.001"]
    reset_all_counts()
    t0 = time.perf_counter()
    out = train_cli.main(files + ["--steps", "6", "--checkpoint-every", "3", "--eval-every", "6",
                                  "--log-every", "1", "--log-dir", logs])
    wall = time.perf_counter() - t0
    used = counts()
    print(f"train.main: 6 steps, checkpoints and a final eval in {wall:.1f} s; launches {used}")
    require(out["final_step"] == 6.0, f"final step {out['final_step']}")
    require(used["plain"] == 0 and all(used[k] == 6 for k in ("matching", "focal_fwd", "focal_bwd"))
            and used["nms"] >= 1, f"launches {used} in 6 steps and an eval")
    for k in launches:
        launches[k] += used[k]
    records = [r for r in read_log(logs) if "loss" in r]
    require([r["step"] for r in records] == list(range(1, 7)), "a step's log is missing")
    require(all(np.isfinite(r["loss"]) for r in records), "a non-finite loss")
    rates = [r["images_per_sec"] for r in records[1:]]
    waits = [r["data_wait_ms"] for r in records[1:]]
    print(f"from JPEG files: {float(np.median(rates)):.2f} images/s, step "
          f"{float(np.median([r['step_time_ms'] for r in records[1:]])):.1f} ms, data_wait_ms "
          f"median {float(np.median(waits)):.3f} (max {max(waits):.3f}) over steps 2-6, against "
          f"0.35-0.69 ms from memory (PERF.md section 5); losses "
          f"{[round(r['loss'], 4) for r in records]}; {kind}, {smi}")

    final = {k.removeprefix("eval/"): v for k, v in out.items() if k.startswith("eval/")}
    reset_all_counts()
    metrics = evaluate_cli.main(files)
    used = counts()
    for k in launches:
        launches[k] += used[k]
    gap = max(abs(metrics[k] - final[k]) for k in COCO_STATS)
    print(f"evaluate.main on the snapshot: {', '.join(f'{k} {metrics[k]:.6f}' for k in COCO_STATS)}; "
          f"largest gap to the run's final eval {gap}; NMS launches {used['nms']}")
    require(set(COCO_STATS) <= set(final) and gap == 0, "evaluate differs from the run's final eval")
    require(final["AR100"] > 0, "every stat is 0: the comparison would hold for any weights")
    require(used["nms"] >= 1 and used["plain"] == 0, f"evaluate launches {used}")

    # The same steps with 4 decode threads instead of --workers' 16: how
    # much do the decode threads cost the step beside them?
    logs4 = os.path.join(root, "logs4")
    reset_all_counts()
    train_cli.main(files + ["--steps", "6", "--workers", "4", "--log-every", "1",
                            "--log-dir", logs4, "--snapshot-path", os.path.join(root, "snap4")])
    used = counts()
    for k in launches:
        launches[k] += used[k]
    records = [r for r in read_log(logs4) if "loss" in r]
    print(f"the same 6 steps on 4 decode threads: "
          f"{float(np.median([r['images_per_sec'] for r in records[1:]])):.2f} images/s, step "
          f"{float(np.median([r['step_time_ms'] for r in records[1:]])):.1f} ms, data_wait_ms median "
          f"{float(np.median([r['data_wait_ms'] for r in records[1:]])):.3f} over steps 2-6; "
          f"{kind}, {smi}")
    require(used["matching"] == 6 and used["plain"] == 0, f"launches {used}")

    # (c) tests/integration/test_convergence_gate.py's recipe on the card.
    gate = ["synthetic", "--synthetic-root", os.path.join(root, "synthetic"), "--synthetic-images",
            "64", "--synthetic-size", "64", "--image-min-side", "64", "--image-max-side", "64",
            "--backbone", "resnet_test", "--f32", "--batch-size", "8", "--workers", "8",
            "--snapshot-path", os.path.join(root, "gate"), "--schedule", "multistep",
            "--warmup-steps", "30", "--lr", "0.32", "--weight-decay", "1e-4"]
    reset_all_counts()
    t0 = time.perf_counter()
    out = train_cli.main(gate + ["--steps", "300", "--log-every", "50", "--checkpoint-every", "100",
                                 "--eval-every", "300"])  # a final eval; the recipe is unchanged
    metrics = train_cli.main(gate + ["--preset", "eval"])
    used = counts()
    gap = max(abs(metrics[k] - out[f"eval/{k}"]) for k in COCO_STATS)
    require(gap == 0, f"--preset eval differs from the run's final eval by {gap}")
    for k in launches:
        launches[k] += used[k]
    print(f"convergence gate: 300 steps and an eval in {time.perf_counter() - t0:.1f} s; AP "
          f"{metrics['AP']:.4f}, AP50 {metrics['AP50']:.4f}, AR100 {metrics['AR100']:.4f} "
          f"(the JAX package's calibration on the CPU: 0.136 / 0.301 / 0.284; threshold AP50 "
          f"0.15); equal to the run's final eval (gap {gap}); launches {used}; {kind}, {smi}")
    require(out["final_step"] == 300.0, f"final step {out['final_step']}")
    require(used["plain"] == 0 and used["matching"] == 300 and used["nms"] >= 2, f"launches {used}")
    require(metrics["AP50"] > 0.15, f"the recipe did not converge: AP50 {metrics['AP50']:.4f}")
    return launches


# ---- phase 12: the deployable server --------------------------------------

LOAD_ALONE = """
import json, sys, time
t0 = time.perf_counter()
import torch
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms
t1 = time.perf_counter()
program = torch.export.load(sys.argv[1]).module()
t2 = time.perf_counter()
x = torch.zeros(tuple(json.loads(sys.argv[2])), dtype=torch.uint8, device=sys.argv[3])
with torch.inference_mode():
    out = program(x)
    kept = int(out[3].sum())  # waits for the device
t3 = time.perf_counter()
print(json.dumps({"import_s": t1 - t0, "load_s": t2 - t1, "first_run_s": t3 - t2,
                  "launches": nms.kernel_launches, "plain": nms.plain_calls, "kept": kept,
                  "models": sorted(m for m in sys.modules if ".models" in m),
                  "modules": sorted({m.split(".")[0] for m in sys.modules} & {"jax", "PIL", "cv2"})}))
"""


HTTP_CLIENT = """
import json, sys, threading, time, urllib.error, urllib.request
url, clients, per_client = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
files = [(path.rsplit("/", 1)[-1], open(path, "rb").read()) for path in sys.argv[4:]]
results, lock = [], threading.Lock()

def client(i):
    for j in range(per_client):
        name, data = files[(i + j) % len(files)]
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                        timeout=300) as r:
                code, body = r.status, json.load(r)
        except urllib.error.HTTPError as e:
            code, body = e.code, json.load(e)
        except Exception as e:  # a connection that failed is a result too
            code, body = 0, {"error": repr(e)}
        with lock:
            results.append([name, [code, body], time.perf_counter() - t0])

t0 = time.perf_counter()
threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump({"wall": time.perf_counter() - t0, "results": results}, sys.stdout)
"""


def http_load(url: str, clients: int, per_client: int) -> tuple[list, float]:
    """``client_load`` over HTTP from another process (stdlib only), so
    that the clients do not share the server's interpreter lock; returns
    [(name, (status, body), seconds)] and the wall time."""
    paths = [str(JPEG_FIXTURES / n) for n, _ in served_files()]
    proc = subprocess.run([sys.executable, "-c", HTTP_CLIENT, url, str(clients), str(per_client), *paths],
                          capture_output=True, text=True, timeout=900)
    require(proc.returncode == 0, f"the HTTP client failed:\n{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout)
    return [(n, tuple(r), secs) for n, r, secs in out["results"]], out["wall"]


def served_files() -> list[tuple[str, bytes]]:
    """The fixture JPEGs that the codec decodes, by name."""
    names = sorted(n for n in os.listdir(JPEG_FIXTURES) if n.endswith(".jpg") and n != "progressive.jpg")
    return [(n, (JPEG_FIXTURES / n).read_bytes()) for n in names]


def live_answer(engine: DetectEngine, image: np.ndarray, batch: int, row: int = 0) -> list[dict]:
    """What the server answers for ``image`` served in row ``row`` of a
    batch of ``batch`` rows (the others padding): resize, pad, the
    engine's program, ``detections_to_coco``; through JSON, as an HTTP
    client reads it."""
    h, w = image.shape[:2]
    hw = bucket_for_source(h, w, engine.min_side, engine.max_side, engine.buckets)
    req = ServeRequest(0, None, None)
    req.image, scale = resize_for_bucket(image, hw, engine.min_side, engine.max_side)
    req.scale = np.float32(scale)
    assembled = assemble_requests([req], hw, batch)

    def at_row(a: np.ndarray) -> np.ndarray:
        return np.roll(a, row, axis=0)

    det = engine.fetch(engine.dispatch(hw, at_row(assembled.images)))
    dets = detect_lib.detections_to_coco(det, np.zeros(batch, np.int64), at_row(assembled.scales),
                                         at_row(assembled.valid), engine.label_to_cat_id,
                                         image_sizes={0: (w, h)})
    for d in dets:
        d.pop("image_id")
    return json.loads(json.dumps(dets))


def answer_gap(a: list[dict], b: list[dict]) -> float:
    """Largest gap between two answers of equal length and labels (inf
    otherwise)."""
    if len(a) != len(b) or any(x["category_id"] != y["category_id"] for x, y in zip(a, b)):
        return float("inf")
    return max([abs(x["score"] - y["score"]) for x, y in zip(a, b)]
               + [abs(u - v) for x, y in zip(a, b) for u, v in zip(x["bbox"], y["bbox"])] + [0.0])


def post(url: str, body: bytes, trace: str | None = None) -> tuple[int, dict, str | None, float]:
    """(status, JSON body, echoed trace id, seconds) of one POST."""
    import urllib.error
    import urllib.request

    headers = {serve_frontend.TRACE_HEADER: trace} if trace else {}
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, headers=headers,
                                                           method="POST"), timeout=300) as r:
            out = r.status, json.load(r), r.headers.get(serve_frontend.TRACE_HEADER)
    except urllib.error.HTTPError as e:
        out = e.code, json.load(e), e.headers.get(serve_frontend.TRACE_HEADER)
    return (*out, time.perf_counter() - t0)


def client_load(call, files: list[tuple[str, bytes]], clients: int, per_client: int) -> tuple[list, float]:
    """``clients`` threads each calling ``call(name, data)`` on
    ``per_client`` files in turn; returns [(name, result, seconds)] and the
    wall time."""
    results: list = []
    errors: list[BaseException] = []
    lock = threading.Lock()

    def client(i: int) -> None:
        try:
            for j in range(per_client):
                name, data = files[(i + j) % len(files)]
                t0 = time.perf_counter()
                out = call(name, data)
                with lock:
                    results.append((name, out, time.perf_counter() - t0))
        except BaseException as exc:  # re-raised below, in the phase
            with lock:
                errors.append(exc)

    t0 = time.perf_counter()
    # watchdog: the client threads are joined right here with a bound, and
    # a crash in one is re-raised below.
    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    require(not any(t.is_alive() for t in threads), "a client thread hangs")
    if errors:
        raise errors[0]
    return results, time.perf_counter() - t0


def latency_line(label: str, results: list, wall: float, kind: str, smi: str) -> dict:
    ms = np.array([r[2] for r in results]) * 1e3
    stats = {"images_per_s": len(results) / wall, "p50_ms": float(np.percentile(ms, 50)),
             "p99_ms": float(np.percentile(ms, 99))}
    print(f"{label}: {len(results)} requests in {wall:.3f} s, {stats['images_per_s']:.2f} images/s, "
          f"p50 {stats['p50_ms']:.3f} ms, p99 {stats['p99_ms']:.3f} ms ({kind}, {smi})")
    return stats


def deployable_phase(snapshot: str, root: str, device, kind: str, smi: str,
                     config: RetinaNetConfig = RetinaNetConfig(), sides=(800, 1333)) -> int:
    """Phase 12 on phase 11's snapshot (a model of ``config``, trained at
    image ``sides``); returns the NMS kernel's launches by the served
    exported programs."""
    export_dir = os.path.join(root, "export")
    files = served_files()
    images = {n: image_io.decode(data) for n, data in files}
    buckets = sorted({bucket_for_source(*img.shape[:2], *sides, default_buckets(*sides))
                      for img in images.values()})
    batch_sizes = (1, 8)
    on = ["--device", device.type]
    t0 = time.perf_counter()
    convert_cli.main(["--snapshot-path", snapshot, "--output", export_dir, "--num-classes",
                      str(config.num_classes), "--backbone", config.backbone,
                      "--image-min-side", str(sides[0]), "--image-max-side", str(sides[1]),
                      "--buckets", ",".join(f"{h}x{w}" for h, w in buckets),
                      "--batch-sizes", ",".join(map(str, batch_sizes)), "--score-threshold", "0.001",
                      *on, *([] if config.dtype == torch.bfloat16 else ["--f32"])])
    programs = len(buckets) * len(batch_sizes)
    convert_s = time.perf_counter() - t0
    manifest = json.loads(Path(export_dir, "manifest.json").read_text())
    sizes = {e["file"]: os.path.getsize(os.path.join(export_dir, e["file"])) for e in manifest["artifacts"]}
    print(f"convert_model: {programs} programs (buckets {buckets}, batch sizes {batch_sizes}) in "
          f"{convert_s:.1f} s, {convert_s / programs:.2f} s a program (restore included); bytes an "
          f"artifact {sizes}; {kind}, {smi}")
    require(manifest["format"] == "torch.export.pt2.v1" and manifest["device"] == device.type
            and len(sizes) == programs, f"manifest {manifest['format']} {manifest['device']} {sizes}")

    # Load one program in a process that imports torch and the op only.
    first = manifest["artifacts"][0]
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ALONE, os.path.join(export_dir, first["file"]),
         json.dumps([first["batch_size"], first["height"], first["width"], 3]), device.type],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
    )
    require(proc.returncode == 0, f"loading a program alone failed:\n{proc.stderr[-3000:]}")
    alone = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{first['file']} alone in a fresh process (torch and the NMS op only): import "
          f"{alone['import_s']:.2f} s, load {alone['load_s']:.2f} s, first run (cuDNN's start-up "
          f"included) {alone['first_run_s']:.2f} s; NMS launches {alone['launches']}, plain {alone['plain']}; "
          f"models imported {alone['models']}, jax/PIL/cv2 {alone['modules']}; {kind}, {smi}")
    require(alone["models"] == [] and alone["modules"] == [], "the loader imported model code")
    require(alone["launches"] >= 1 and alone["plain"] == 0, f"NMS in the loaded program: {alone}")

    # The live engine on the same weights, buckets and batch sizes.
    model = RetinaNet(config)
    saved = CheckpointManager(snapshot).restore_arrays()
    load_flax_variables(model, saved["params"], saved["batch_stats"])
    dconfig = detect_lib.DetectConfig(score_threshold=0.001)
    live = DetectEngine.from_state(model, tuple(buckets), batch_sizes, dconfig, device, *sides)
    t0 = time.perf_counter()
    engine = DetectEngine.from_export(export_dir, device)
    engine.warmup()
    print(f"DetectEngine.from_export with warm-up: {time.perf_counter() - t0:.2f} s; version "
          f"{engine.version}; {kind}, {smi}")
    # An answer depends on the batch size and on the row the request rides
    # in (cuDNN may tile the last row apart), not on the other rows: each
    # fixture alone at every (batch size, row).
    slots = [(b, r) for b in batch_sizes for r in range(b)]
    want = {(n, *k): live_answer(live, images[n], *k) for n in images for k in slots}
    exported = {(n, *k): live_answer(engine, images[n], *k) for n in images for k in slots}
    gaps = [answer_gap(want[k], exported[k]) for k in want]
    by_slot = {n: len({json.dumps(want[(n, *k)]) for k in slots}) for n in images}
    print(f"exported against live, each fixture alone at every (batch size, row) of {slots[:2]}...: "
          f"{sum(g == 0 for g in gaps)} of {len(gaps)} equal bit for bit, largest gap {max(gaps)}")
    first = next(iter(images))
    hw0 = buckets[0]
    req = ServeRequest(0, None, None)
    req.image, _ = resize_for_bucket(images[first], hw0, *sides)
    batch = torch.from_numpy(assemble_requests([req], hw0, 8).images).to(device)
    with torch.inference_mode():
        row0 = model(normalize_images(batch))["cls_logits"][0]
        row7 = model(normalize_images(torch.roll(batch, 7, 0)))["cls_logits"][7]
    print(f"distinct live answers of a fixture over those {len(slots)} slots: {by_slot}; {first}'s class "
          f"logits in row 7 of 8 against row 0: largest gap {float((row0 - row7).abs().max()):.4e} "
          f"(a gap is cuDNN rounding the last row of a batch otherwise); {kind}, {smi}")
    require(all(want[k] for k in want), "a fixture has no detections: the comparison would be vacuous")
    require(max(gaps) == 0, f"an exported program's answer differs from the live engine's by {max(gaps)}")

    def check(name: str, answer: list[dict]) -> float:
        """0 when ``answer`` is the live answer at an exported batch size and
        a row."""
        return min(answer_gap(answer, want[(name, *k)]) for k in slots)

    server = DetectionServer(engine, ServeConfig(), warmup=False)
    httpd = serve_frontend.serve_http(server, "127.0.0.1", 0)
    # watchdog: serve_forever returns at httpd.shutdown() in the finally below.
    threading.Thread(target=httpd.serve_forever, daemon=True, name="chip-smoke-http").start()
    url = "http://%s:%d" % httpd.server_address[:2]
    launches = 0
    http_answers: dict[str, list] = {n: [] for n, _ in files}
    try:
        # Warm-up: the first batches allocate pinned host memory.
        http_load(f"{url}/detect", 8, 2)
        client_load(lambda n, d: server.detect(d, timeout_s=300), files, 8, 2)
        stats = {}
        for clients, per_client in ((8, 8), (32, 4)):
            batches0 = server.snapshot()["batches"]
            nms_cuda.reset_counts()
            results, wall = http_load(f"{url}/detect", clients, per_client)
            used, plain = nms_cuda.kernel_launches, nms_cuda.plain_calls
            batches = server.snapshot()["batches"] - batches0
            launches += used
            require(len(results) == clients * per_client and all(r[1][0] == 200 for r in results),
                    f"{len(results)} answers, statuses {Counter(r[1][0] for r in results)}")
            worst = max(check(n, r[1]["detections"]) for n, r, _ in results)
            for n, r, _ in results:
                http_answers[n].append(r[1]["detections"])
            stats[("http", clients)] = latency_line(
                f"HTTP POST /detect, {clients} client threads in another process", results, wall, kind, smi)
            print(f"  {batches} batches, NMS launches {used}, plain {plain}; answers against the live "
                  f"engine at the same batch size: largest gap {worst}")
            require(used >= batches > 0 and plain == 0, f"NMS launches {used} for {batches} batches")
            require(worst == 0, f"a served answer differs from the live engine's by {worst}")
            nms_cuda.reset_counts()
            results, wall = client_load(lambda n, d: server.detect(d, timeout_s=300), files, clients,
                                        per_client)
            launches += nms_cuda.kernel_launches
            require(nms_cuda.plain_calls == 0, "the plain NMS ran in process")
            require(max(check(n, r) for n, r, _ in results) == 0, "an in-process answer differs")
            stats[("in-process", clients)] = latency_line(f"in-process submit, {clients} clients", results,
                                                          wall, kind, smi)
        for clients in (8, 32):
            h, p = stats[("http", clients)], stats[("in-process", clients)]
            print(f"HTTP cost at {clients} clients: {h['images_per_s']:.2f} against {p['images_per_s']:.2f} "
                  f"images/s, p50 {h['p50_ms'] - p['p50_ms']:+.3f} ms, p99 {h['p99_ms'] - p['p99_ms']:+.3f} ms")

        # The error answers and the trace header, then one answer a file.
        nms_cuda.reset_counts()
        progressive = (JPEG_FIXTURES / "progressive.jpg").read_bytes()
        code, body, trace, _ = post(f"{url}/detect", progressive, trace="chip-smoke-trace")
        require(code == 400 and body.get("reason") == "decode_error" and trace == "chip-smoke-trace"
                and body.get("trace_id") == trace, f"progressive JPEG: {code} {body} {trace}")
        code, body, trace, _ = post(f"{url}/detect", files[0][1])
        require(code == 200 and trace and len(trace) == 16 and body["trace_id"] == trace,
                f"minted trace id {trace!r}")
        code, body, _, _ = post(f"{url}/nowhere", files[0][1])
        require(code == 404, f"unknown path answered {code}")
        print(f"progressive JPEG answered 400 decode_error, unknown path 404, trace header echoed "
              f"(given and minted)")
        for n, data in files:  # one at a time: each alone in a batch of 1
            code, body, _, _ = post(f"{url}/detect", data)
            require(code == 200 and check(n, body["detections"]) == 0, f"{n} answered alone")
            http_answers[n].append(body["detections"])
        launches += nms_cuda.kernel_launches
        require(nms_cuda.plain_calls == 0, "the plain NMS ran behind HTTP")
    finally:
        httpd.shutdown()
        server.close()
        httpd.server_close()

    # The command line: offline over the fixtures, then --http and SIGTERM.
    out_jsonl = os.path.join(root, "served.jsonl")
    cli = [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve", "--export-dir", export_dir,
           *on]
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["--images", str(JPEG_FIXTURES), "--output", out_jsonl],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"serve --images failed:\n{proc.stderr[-3000:]}")
    records = {r["file"]: r for r in map(json.loads, Path(out_jsonl).read_text().splitlines())}
    require(sorted(records) == sorted([n for n, _ in files] + ["progressive.jpg"]), f"records {sorted(records)}")
    require("decode_error" in records["progressive.jpg"].get("error", ""), "progressive.jpg was not refused")
    worst = max(check(n, records[n]["detections"]) for n, _ in files)
    same = sum(records[n]["detections"] in http_answers[n] for n, _ in files)
    print(f"serve --images: {len(records)} records in {time.perf_counter() - t0:.1f} s (process included); "
          f"against the live engine: largest gap {worst}; equal to an HTTP answer for the same file "
          f"(served at the same batch size) for {same} of {len(files)}")
    require(worst == 0 and same == len(files), "a CLI record differs from the HTTP answers")

    proc = subprocess.Popen(cli + ["--http", "0"], cwd=Path(__file__).resolve().parent,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("serving on "):
                break
        if not line.startswith("serving on "):
            require(False, f"serve --http did not start:\n{proc.stderr.read()[-3000:]}")
        code, body, _, _ = post(f"{line.split()[2]}/detect", files[0][1])
        require(code == 200 and check(files[0][0], body["detections"]) == 0, "the CLI server's answer")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(proc.returncode == 0, f"serve --http exited {proc.returncode} on SIGTERM:\n{err[-3000:]}")
    served = json.loads(out.strip().splitlines()[-1])["serve_stats"]
    print(f"serve --http 0: answered, drained on SIGTERM and exited 0; serve_stats completed "
          f"{served['completed']}, outstanding {served['outstanding']}")
    require(served["completed"] == 1 and served["outstanding"] == 0, f"serve_stats {served}")
    print(f"NMS launches by the served exported programs in this phase: {launches}")
    del live, engine, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


if __name__ == "__main__":
    sys.exit(main())
