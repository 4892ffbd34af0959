"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``batchai_retinanet_horovod_coco_tpu_torch`` on the card, in
nineteen phases, and fails (non-zero exit, no result line) if any of them fails:

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
   with no eval in flight; the final state's detections scored through
   the native COCOeval helper and through its numpy oracle must give equal
   stats, and it prints each one's host ms;
11. from image files through the command line: (a) builds the image codec
   (``native/imagecodec.cpp``) with g++, decodes every fixture of
   ``tests/fixtures/jpeg``, ``tests/fixtures/formats`` and
   ``tests/fixtures/formats_more`` (progressive, block-smoothed cut
   progressive, CMYK, YCCK and RGB-coded JPEG, interlaced and 16-bit PNG,
   BMP with RLE8 and RLE4; GIF; TIFF uncompressed, PackBits, LZW, Deflate
   and JPEG in strips, tiles and planes; WebP lossy, lossless, with alpha
   and animated) to the sha256 of PIL's pixels that their ``digests.json``
   hold, times a 640 x 480 baseline and a progressive JPEG decode, and a
   640 x 480 GIF, LZW TIFF, lossy and lossless WebP decode, on the host, and sweeps
   ``build_pipeline``'s images/s at 1, 2, 4 and 8 decode threads and at
   1, 2 and 4 worker processes over shared memory (batch 16, buckets
   (800, 1344) and (1344, 800)) over a COCO JSON that names the four
   640 x 480 fixtures 64 times: each one's first two batches equal 1
   thread's, no worker initialized CUDA, and no worker or shared-memory
   segment outlives its pipeline; (b) ``train.main`` at the defaults
   (ResNet-50, GN, bf16, batch 16, sides 800/1333) on that JSON for 6
   steps with a checkpoint every 3 and a final COCO eval of 16 records,
   then ``evaluate.main`` on the snapshot, whose 12 stats must equal the
   run's final eval exactly, then the same 6 steps on 4 decode threads and
   on 4 worker processes (``--data-worker-procs 4``: the training kernels
   launched once a step, no worker or segment left after); it prints
   images/s, step ms and ``data_wait_ms`` of the three; (c) the convergence
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
   a served batch, the plain version never.  A GIF that ends after its
   screen descriptor, which the codec refuses as PIL does, is answered
   400, an unknown path 404, and the trace header is echoed; a 640 x 480
   GIF, LZW TIFF and lossy WebP are each answered as the live engine
   answers their decoded pixels at an exported slot, NMS launched;
   each fixture posted 8 times at once to a server that seals only full
   batches is answered at every row of a batch of 8 as the live engine
   answers there; ``python -m ...serve --images`` writes records equal
   to the live answers and each to an HTTP answer for the same file (and
   an ``error`` record for the truncated GIF), and
   ``--http 0`` drains and exits 0 on SIGTERM;
13. observability at full width: (a) phase 8's model and batches, 6 steps
   of ``train/loop.py`` without and 6 with the numerics summary: every
   ``gnorm/*``, ``update_ratio`` and ``nonfinite_grads`` finite, no
   non-finite gradient element, the mean step ms of both, the training
   kernels launched each step; (c) meanwhile ``--obs-port``'s status
   server (the train command line's ``_start_telemetry``) is scraped over
   HTTP: ``/healthz`` 200, ``train_step_time_ms`` and the ``dev0`` memory
   gauges on ``/metrics``, the peak within 1% of
   ``torch.cuda.max_memory_allocated()``; (b) ``train coco`` on phase
   11's fixture JSONs at the defaults with ``--numerics --inject-nan-step
   2 --auto-resume --checkpoint-every 1``: ``NUMERICS_DUMP.json`` holds the
   poisoned batch's image ids and a first non-finite value, an
   ``auto_resume`` event excluding those ids lands in ``metrics.jsonl``,
   and the healed run reaches its last step; (d) the ``serve`` command
   line in this process over phase 12's exported programs, 8 HTTP client
   threads in another process, four runs in turn without and with
   ``--obs-trace --obs-port`` (off, on, on, off), each stopped by SIGTERM:
   ``/healthz`` 200, the ``/metrics`` request count equal to the requests
   sent, a ``serve_request`` span in the exported trace for every
   request, NMS launched once a served batch; it prints the median ms of
   each serve span and the mean images/s with tracing off and on; (e) a watchdog component
   with a 1 s budget that never beats turns ``/healthz`` 503, naming it;
   (f) ``train coco`` at the defaults on phase 11's fixture JSONs, 6 steps
   and a final eval, with ``--obs-trace --obs-dir``: the PERF_REPORT.json
   the command line writes at finalize passes ``validate_report``, its
   step-time decomposition sums to 1 within 0.02, its step FLOPs (torch's
   FLOP counter) are 2.5-3.5 times the same model's forward alone on a
   batch of 16, its MFU against the card's peak row lies in (0, 1], the
   offline ``obs.analyze`` writes the same bytes, and the training kernels
   launched once a step; it prints the report's summary;
14. the serve fleet on one card, over phase 12's exported programs: (a) a
   ``FleetRouter`` over two ``LocalReplica``s (``DetectionServer`` over
   ``DetectEngine.from_export`` on the card) answers the fixtures from 8
   client threads, every answer the live engine's at an exported (batch
   size, row) slot, bit for bit, and NMS launched once a batch the two
   replicas dispatched; (b) ``python -m ...serve.fleet --spawn 2
   --export-dir`` answers 8 and 32 HTTP client threads in another process
   (the same check), reads each replica's peak device memory from its
   ``/metrics``, and has replica-0 SIGKILLed under 32 clients: every
   request answered (re-dispatched at most once), one first
   ``fleet_breaker_open`` for it, the respawned replica readmitted with its
   weight and ``/healthz`` 200, one fleet-availability SLO violation on the
   fleet's ``/metrics``; (c) a stub fleet whose stub canary is slowed to
   250 ms a batch gets exactly one ``canary_rollback`` and its base
   replica's weight back; (d) the fixtures, each 3 times, as the frames of
   one stream through ``/stream/open``, ``/stream/frame`` and
   ``/stream/close``: in order, each frame's answer without ``track_id``
   the live engine's at an exported slot, with the frame-delta cache off
   (the in-process fleet edge over HTTP replicas; NMS once a batch) and on
   (the fleet command line's edge; its hits counted, the frame p50/p99);
   (e) ``--autoscale --min-replicas 1 --max-replicas 2``: a burst of 32
   clients scales up to 2 replicas, the new one takes weighted requests,
   and a trickle of 1 client through idle time drains back to 1, no request
   failing.  Each fleet runs in a process group of its own, killed
   whatever happens;
15. the model family on one card, each at its published widths, FPN 256,
   heads 256 x 4, 80 classes, 9 anchors: (a) ``mobilenet``,
   ``mobilenet050``, ``vgg16``, ``vgg19``, ``densenet121``, ``densenet169``
   and ``densenet201`` build on the card, and one f32 forward of a 256 x
   256 image (TF32 off since phase 5) equals the same model's on the CPU
   within 1e-3 of the output's range; (b) ``mobilenet``, ``vgg16`` and
   ``densenet121`` each take 3 steps of ``train/loop.py`` on phase 8's
   batches at (800, 1344), global batch 8, GroupNorm, bf16: the counters
   zeroed before and read after, the training kernels launched once a
   step, the plain versions never; step ms, images/s and peak memory each;
   (c) the DenseNet's state goes through ``convert_model`` at (800, 1344)
   and batch 1: the program alone in a fresh process imports no model code
   and launches NMS, and ``DetectEngine.from_export`` answers a fixture
   JPEG as the live engine on the same weights, bit for bit, NMS launched;
   (d) ``train coco --pretrained-backbone`` with a seeded random state dict
   in torchvision's ResNet-50 layout and ``--norm frozen_bn`` runs 2 steps
   on the fixture JPEGs: every imported tensor equals the file's on the
   card before the first step, the frozen statistics are still the file's
   after it, the training kernels launched once a step.  The phase must
   take at most 240 s.
16. data-parallel training on one card (``launch/``, ``parallel/``; it
   prints the torch version, whether NCCL and gloo are available and which
   DDP flag turns the per-forward buffer sync off): (a) one f32 step (TF32
   off) of the full-width ResNet-50 RetinaNet (GroupNorm) on phase 8's
   first 4 images at (800, 1344) in this process, then a world of 2 ranks
   over gloo on the one card (NCCL refuses two ranks a card), each a
   process of its own with 2 of the images, through the package API
   (``initialize_distributed``, ``make_train_step(world=...)``): the
   world's first loss within rel 1e-4 and its ``num_pos`` equal to the one
   process's, every parameter within 3e-2 of how far the step moved it;
   each rank's step ms and ``replica_agreement`` for 3 steps, its matching
   and focal kernels launched every step, the plain versions never, and
   equal parameter digests on both ranks after the 3 steps; (b) ``train
   coco`` on phase 11's fixture JPEGs joined to a world of 1 over NCCL
   (``--coordinator-address 127.0.0.1:<free port> --num-processes 1
   --process-id 0``) for 3 steps with ``--checkpoint-every 3``: the
   checkpoint of step 3 written with ``shard_count`` 1, the final eval's
   detections through ``allgather_process_detections`` with a world, the
   training kernels launched once a step and NMS at least once, and no
   process group left after.  The phase must take at most 240 s.
17. gradient communication on one card (``comm/``, ``parallel/zero.py``):
   (a) a world of 2 gloo ranks on the card, f32 with TF32 off and
   deterministic kernels, ResNet-50 RetinaNet (GroupNorm) at full width, 2
   of phase 8's images a rank at (800, 1344), 3 steps each of exact DP,
   ``--comm-compress int8`` with error feedback, the same with
   ``--comm-overlap``, ``--shard-weight-update`` and ZeRO with int8, from
   the same weights: each rank's step ms, ``ef_residual_norm``,
   ``ef_saturation`` and ``comm_compressed_bytes`` beside the exact
   schedule's bytes, the gap to the exact world's parameters, peak memory,
   optimizer-state bytes and launches; the ranks' digests equal, overlap's
   equal to fused int8's, ZeRO's optimizer state about half the exact
   world's, and the EF identity (summed applied means plus the residual
   equal the summed exact means) within 1e-6 on the card; (b) a world of 4
   as 2 slices x 2 (``--comm-dcn-mode int8``), one (512, 512) image a rank,
   2 steps, against the flat int8 world: ``comm_ici_bytes``, ``comm_dcn_bytes``,
   ``ef_residual_norm_dcn``, the interleaved mesh positions, equal digests;
   (c) ``train coco --shard-weight-update --comm-compress int8`` in a world
   of 1 over NCCL (bf16, batch 16): 3 steps, a checkpoint with
   ``zero_world_size`` 1, and its residuals restored through the package
   equal to the saved ones.  Every rank's matching and focal kernels
   launched every step, the plain versions never.  The phase must take at
   most 240 s;
18. the schedule registry (``tune/schedule.py``) on the card, in a
   temporary directory named by ``RETINANET_TORCH_SCHEDULE_DIR``: with no
   file, a process prints exactly one ``schedule_fallback`` line naming the
   card and resolves ``pre_nms_size`` 1000; with a file for the card
   (``nms.pre_nms_size`` 500), a process resolves 500 with no fallback
   line, ``postprocess`` on the card hands the NMS kernel 500 candidates,
   ``train synthetic`` (resnet_test, 64 x 64) runs 3 steps through the
   matching and focal kernels and a final eval through the NMS kernel, and
   ``convert_model`` writes a manifest whose ``schedule.found`` is true and
   ``pre_nms_size`` 500; a malformed file gives the fallback line with
   reason ``invalid_schedule_artifact`` and resolves 1000, and
   ``load_schedule`` on it names every problem.  The phase must take at
   most 150 s;
19. the schedule search (``tune/``) over the kernels' launch shapes (the
   menus of ``ops/cuda/shapes.py``): (a) every variant against its plain
   version on the card: NMS at every (lanes a mask row, scan threads) on
   phase 3's cases and at K 4200 and 8192 (where the scan's later words
   outnumber half its threads), and matching at every tile on phase 6's
   fields (each culling edit aimed at the tile; the last-tile field at
   (768, 1344) where the tile divides the bucket's anchors), EQUAL; the
   focal forward at every tile within rel 1e-5 of the plain version and
   repeating bit for bit, the backward at every tile equal to the default
   tile's bit for bit; each variant's device ms; (b) ``python -m
   batchai_retinanet_horovod_coco_tpu_torch.tune --ops nms,focal,matching
   --steps 10`` into a temporary registry (its ``main`` in this process),
   whose file validates, with every trial ``ok`` or ``failed`` with its
   error; it prints the winners and each trial's device ms; (c) a fresh
   process over that registry: ``train synthetic`` (resnet_test, 64 x 64,
   3 steps and an eval) launches the winning matching and focal variants
   only, ``postprocess`` the winning NMS variant and no other (the
   per-variant counters), and ``convert_model``'s manifest records the
   winning NMS shape; (d) ``tune --check`` reads the search's record,
   measures its winner again and prints a verdict (a timing verdict, which
   does not fail the smoke); (e) ``tune --from-report`` on phase 13's
   ``PERF_REPORT.json`` prints the ops it derived.  The phase must take at
   most 150 s.

Then it prints one JSON line with each kernel's launches, error, times,
bound and its variants' device ms, and as its last line ``{"ok": true,
"device": {...}}``.  A kernel's ``ms`` there is CUDA events around wrapper
calls made back to back, as the plain version's ``plain_ms``;
``device_ms`` is the same call's device time from a replayed CUDA graph,
without the host's time to launch it.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import multiprocessing
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
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
from batchai_retinanet_horovod_coco_tpu_torch.data import shm_pipeline as shm_lib
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import __main__ as evaluate_cli
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import coco_eval as coco_eval_lib
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as detect_lib
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
    RetinaNet,
    RetinaNetConfig,
    build_retinanet,
)
from batchai_retinanet_horovod_coco_tpu_torch.native import build as native_build
from batchai_retinanet_horovod_coco_tpu_torch.obs import analyze as analyze_lib
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as obs_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs.analyze import __main__ as analyze_cli
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as obs_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as obs_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import metric_records, split_runs
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as matching_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import cases as cases_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import shapes
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as train_cli
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as loop_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as optim_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import state as state_lib
from batchai_retinanet_horovod_coco_tpu_torch.train import step as step_lib
from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import assemble_requests
from batchai_retinanet_horovod_coco_tpu_torch.serve import fleet as serve_fleet
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as serve_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import (
    ServeConfig,
    ServeRequest,
    StreamConfig,
)
from batchai_retinanet_horovod_coco_tpu_torch.serve.replica import HttpReplica, LocalReplica
from batchai_retinanet_horovod_coco_tpu_torch.serve.stream import StreamManager
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.serve.frontend import DetectionServer
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager, read_manifest
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
FORMAT_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "formats"
# GIF, TIFF and WebP; the 640 x 480 ones are timed and served.
MORE_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "formats_more"
NEW_FORMAT_FILES = ("gif_640x480.gif", "tiff_640x480_lzw.tif", "webp_640x480.webp")
# CCITT fax, LZMA, Zstandard, float and signed samples, orientations, YCbCr.
TIFF_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "formats_tiff"
TIFF_TIMED_FILES = ("tiff_640x480_ccitt_g4.tif", "tiff_640x480_zstd.tif")
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


_SCRIPT_START = time.perf_counter()
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
                                    nms_cuda.DEFAULT_MASK_LANES,
                                    torch.cuda.current_stream().cuda_stream) == 0, "NMS mask launch")

    def scan():
        require(lib.nms_scan_launch(cs.data_ptr(), mask.data_ptr(), b, k, nms_cuda._PAD_SCORE,
                                    keep.data_ptr(), nms_cuda.DEFAULT_SCAN_THREADS,
                                    torch.cuda.current_stream().cuda_stream) == 0,
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
            boxes, scores, dconfig.score_threshold,
            detect_lib.resolve_detect_config(dconfig, device).pre_nms_size,
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
        served = deployable_phase(os.path.join(root, "snap"), root, device, kind, smi)
        phase(13, "observability at full width")
        obs_launches = obs_phase(root, [cut_batch(b, batch_size) for b in batches], device, kind, smi)
        phase(14, "the serve fleet on one card")
        fleet_launches = fleet_phase(root, served, device, kind, smi)
        phase(15, "the model family on one card")
        family_launches = model_family_phase(root, batches, device, kind, smi)
        phase(16, "data-parallel training on one card")
        dp_launches = data_parallel_phase(root, batches, device, kind, smi)
        phase(17, "gradient communication on one card")
        comm_launches = comm_phase(root, batches, device, kind, smi)
        phase(18, "the schedule registry")
        schedule_launches = schedule_phase(root, device, kind)
        phase(19, "the schedule search over the kernels' launch shapes")
        tune_launches, variants = tune_phase(root, device, kind, smi, anchors, batches[0])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for row, key in ((match_row, "matching"), (fwd_row, "focal_fwd"), (bwd_row, "focal_bwd")):
        row["launches"] = (launches_by_kernel[key] + run_launches[key] + file_launches[key]
                           + obs_launches[key] + family_launches[key] + dp_launches[key]
                           + comm_launches[key] + schedule_launches[key] + tune_launches[key])
    nms_row["launches"] = (launches + run_launches["nms"] + file_launches["nms"] + served["launches"]
                           + obs_launches["nms"] + fleet_launches + family_launches["nms"]
                           + dp_launches["nms"] + comm_launches["nms"] + schedule_launches["nms"]
                           + tune_launches["nms"])
    for row in (nms_row, match_row, fwd_row, bwd_row):
        row["variants"] = variants[row["name"]]
    end_phases()
    print(f"chip_smoke: all 19 phases in {time.perf_counter() - _SCRIPT_START:.1f} s (the build included)")

    print(smi)
    print(json.dumps({"kernels": [nms_row, match_row, fwd_row, bwd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def culling_field(edit: str, seed: int, anchors: torch.Tensor, tile: int | None = None):
    """B 16, G 100 at TRAIN_HW, 1-60 real gts an image, reshaped by the
    culling edit ``edit`` of ``ops/cuda/cases.py`` against the tiles of
    ``tile`` anchors (the kernel's default tile where None)."""
    boxes, labels, mask = gt_scene(16, MAX_GT, seed, counts=(1, 60))
    rng = np.random.default_rng(seed)
    cases_lib.CULLING_EDITS[edit](boxes, mask, rng, anchors.cpu().numpy(),
                                  tile or matching_cuda.kernel_tile())
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

    # The same detections scored through the native COCOeval helper and
    # through its numpy oracle: equal stats, and each one's host time.
    gt, img_ids = detect_lib.coco_gt_from_dataset(dataset)
    scored, score_ms = {}, {}
    for label, (iou_fn, match_fn) in {
        "native helper": (coco_eval_lib.bbox_iou_xywh, coco_eval_lib.match_detections),
        "numpy oracle": (coco_eval_lib.numpy_bbox_iou_xywh, coco_eval_lib.numpy_match_detections),
    }.items():
        saved_fns = coco_eval_lib.bbox_iou_xywh, coco_eval_lib.match_detections
        coco_eval_lib.bbox_iou_xywh, coco_eval_lib.match_detections = iou_fn, match_fn
        try:
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                scored[label] = coco_eval_lib.evaluate_detections(gt, pipelined, img_ids=img_ids)
                times.append((time.perf_counter() - t0) * 1e3)
            score_ms[label] = float(np.median(times))
        finally:
            coco_eval_lib.bbox_iou_xywh, coco_eval_lib.match_detections = saved_fns
    print(f"scoring {len(pipelined)} detections of {len(img_ids)} images on the host, median of 3: native "
          f"helper {score_ms['native helper']:.3f} ms, numpy oracle {score_ms['numpy oracle']:.3f} ms; "
          f"stats equal: {scored['native helper'] == scored['numpy oracle']}; {kind}, {smi}")
    require(scored["native helper"] == scored["numpy oracle"], "the native COCOeval helper's stats differ")

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
          f"flight ({len(alone)} steps), {during_ms:.3f} with one ({len(during)} steps; the eval scores "
          f"through the native COCOeval helper; PERF.md records 394-483 ms with numpy scoring); "
          f"{kind}, {smi}")
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
    """The train records of a run's ``metrics.jsonl`` (the EventSink
    stream), ``train/`` stripped from their keys."""
    records = []
    for run in split_runs(os.path.join(log_dir, "metrics.jsonl")):
        for r in metric_records(run):
            train = {k.removeprefix("train/"): v for k, v in r.items() if k.startswith("train/")}
            if train:
                records.append({"step": r["step"], **train})
    return records


def files_phase(root: str, device, kind: str, smi: str) -> dict[str, int]:
    """Phase 11 under ``root`` (its snapshot stays for phase 12); returns
    each kernel's launches in its runs."""
    codec_and_pipeline(root, kind, smi)
    return cli_runs(root, device, kind, smi)


def decode_ms(data: bytes, reps: int = 30) -> tuple[float, float]:
    """Median and min ms of decoding ``data`` on the host."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        image_io.decode(data)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), min(times)


def leftover_workers(processes: list | None = None) -> tuple[list[str], list]:
    """This process's shared-memory segments and its live decode worker
    processes (``processes``, else its children of the pipeline's worker
    name): both must be none once a pipeline is closed."""
    own = f"{shm_lib.SHM_PREFIX}{os.getpid()}_"
    segments = sorted(f for f in os.listdir("/dev/shm") if f.startswith(own))
    if processes is None:
        processes = [p for p in multiprocessing.active_children() if p.name.startswith("shm-pipe-worker-")]
    return segments, [p for p in processes if p.is_alive()]


def codec_and_pipeline(root: str, kind: str, smi: str) -> None:
    """(a) the codec against the fixtures' digests, decode times, and the
    pipeline's images/s by decode threads and by worker processes."""
    t0 = time.perf_counter()
    native_build.compile_library("imagecodec")
    print(f"built native/imagecodec.cpp with g++ in {time.perf_counter() - t0:.1f} s")
    checked = 0
    for folder in (JPEG_FIXTURES, FORMAT_FIXTURES, MORE_FIXTURES, TIFF_FIXTURES):
        digests = json.loads((folder / "digests.json").read_text())
        for name, want in digests.items():
            path = folder / name
            pixels = image_io.read_rgb(path)
            digest = hashlib.sha256(pixels.tobytes()).hexdigest()
            require(list(pixels.shape) == want["shape"] and digest == want["sha256"],
                    f"{name}: decoded pixels differ from PIL's (sha256 {digest})")
            if "size" in want:
                require(list(image_io.read_size(path)) == want["size"], f"{name}: read_size differs from PIL's")
            checked += 1
    print(f"{checked} fixtures of tests/fixtures/jpeg, formats, formats_more and formats_tiff "
          f"(progressive, cut and block-smoothed progressive, CMYK, YCCK, Adobe RGB JPEG; interlaced "
          f"and 16-bit PNG; BMP, RLE8 and RLE4; GIF; TIFF uncompressed, PackBits, LZW, Deflate, JPEG, "
          f"CCITT RLE, Group 3 and Group 4, LZMA and Zstandard, in strips, tiles and planes, float and "
          f"signed samples, the eight orientations, YCbCr not JPEG-compressed; WebP lossy, lossless, "
          f"with alpha and animated) decode to their PIL digests bit for bit")
    baseline = (JPEG_FIXTURES / "coco_0.jpg").read_bytes()
    progressive = (FORMAT_FIXTURES / "progressive_640x480.jpg").read_bytes()
    (b_med, b_min), (p_med, p_min) = decode_ms(baseline), decode_ms(progressive)
    print(f"decode of a 640 x 480 4:2:0 JPEG on the host ({os.cpu_count()} cores), median (min) over 30: "
          f"baseline ({len(baseline)} bytes) {b_med:.3f} ({b_min:.3f}) ms, progressive ({len(progressive)} "
          f"bytes) {p_med:.3f} ({p_min:.3f}) ms, {p_med / b_med:.2f}x; {kind}, {smi}")
    timed = [MORE_FIXTURES / n for n in (*NEW_FORMAT_FILES, "webp_640x480_lossless.webp")]
    for path in timed + [TIFF_FIXTURES / n for n in TIFF_TIMED_FILES]:
        name, data = path.name, path.read_bytes()
        med, low = decode_ms(data)
        print(f"decode of {name} (640 x 480, {len(data)} bytes) on the host, median (min) over 30: "
              f"{med:.3f} ({low:.3f}) ms, {med / b_med:.2f}x the baseline JPEG; {kind}, {smi}")

    dataset = CocoDataset(fixture_coco(root, 64, 0), str(JPEG_FIXTURES))
    reference: list = []
    for workers, procs in ((1, 0), (2, 0), (4, 0), (8, 0), (1, 1), (1, 2), (1, 4)):
        it = pipeline_lib.build_pipeline(dataset, pipeline_lib.PipelineConfig(
            batch_size=16, buckets=default_buckets(800, 1333), max_gt=16, num_workers=workers,
            num_worker_procs=procs))
        try:
            first = [next(it), next(it)]  # warm-up (the workers' start), and kept for the comparison
            batches = 3 if workers + procs == 1 else 6
            t0 = time.perf_counter()
            for _ in range(batches):
                batch = next(it)
            rate = 16 * batches / (time.perf_counter() - t0)
        finally:
            it.close()
        require(batch.images.shape == (16, *TRAIN_HW, 3), f"pipeline batch {batch.images.shape}")
        if not reference:
            reference = first
        same = all(np.array_equal(getattr(a, f), getattr(b, f)) for a, b in zip(first, reference)
                   for f in pipeline_lib.Batch._fields)
        require(same, f"the first batches with {workers} threads, {procs} processes differ from 1 thread's")
        if procs:
            require(not it.workers_touched_cuda, "a decode worker process initialized CUDA")
            segments, children = leftover_workers(it.processes)
            require(not segments and not children, f"after close(): segments {segments}, children {children}")
        label = f"{procs} worker process(es)" if procs else f"{workers} decode thread(s)"
        print(f"build_pipeline, {label}: {rate:.2f} images/s at batch 16 into {TRAIN_HW} (decode, flip, "
              f"resize 640x480 -> 1067x800, pad), first 2 batches equal to 1 thread's; against the step's "
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
    by_feed = {"16 decode threads": records[1:]}

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
    by_feed["4 decode threads"] = [r for r in read_log(logs4) if "loss" in r][1:]
    require(used["matching"] == 6 and used["plain"] == 0, f"launches {used}")

    # The same steps with the decodes in 4 worker processes over shared
    # memory (data/shm_pipeline.py): the step's process keeps only assembly.
    logs_procs = os.path.join(root, "logs_procs")
    reset_all_counts()
    out = train_cli.main(files + ["--steps", "6", "--data-worker-procs", "4", "--log-every", "1",
                                  "--log-dir", logs_procs, "--snapshot-path", os.path.join(root, "snap_procs")])
    used = counts()
    for k in launches:
        launches[k] += used[k]
    require(out["final_step"] == 6.0, f"final step {out['final_step']} with worker processes")
    require(used["plain"] == 0 and all(used[k] == 6 for k in ("matching", "focal_fwd", "focal_bwd")),
            f"launches {used} in 6 steps with worker processes")
    segments, children = leftover_workers()
    require(not segments and not children, f"after the run: segments {segments}, children {children}")
    by_feed["4 worker processes"] = [r for r in read_log(logs_procs) if "loss" in r][1:]
    for feed, recs in by_feed.items():
        require(len(recs) == 5 and all(np.isfinite(r["loss"]) for r in recs), f"{feed}: steps {recs}")
        print(f"train coco from JPEG files, {feed}: {float(np.median([r['images_per_sec'] for r in recs])):.2f} "
              f"images/s, step {float(np.median([r['step_time_ms'] for r in recs])):.1f} ms, data_wait_ms "
              f"median {float(np.median([r['data_wait_ms'] for r in recs])):.3f} (max "
              f"{max(r['data_wait_ms'] for r in recs):.3f}) over steps 2-6; {kind}, {smi}")

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
# json.dumps, not json.dump: the latter encodes in Python, a minute for
# the tens of MB of a long load's answers.
sys.stdout.write(json.dumps({"wall": time.perf_counter() - t0, "results": results}))
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
    """The fixture JPEGs, by name (the progressive one among them)."""
    names = sorted(n for n in os.listdir(JPEG_FIXTURES) if n.endswith(".jpg"))
    return [(n, (JPEG_FIXTURES / n).read_bytes()) for n in names]


def truncated_gif() -> bytes:
    """A GIF that ends after its screen descriptor: there is no image in
    it, and the codec refuses it as PIL does."""
    return b"GIF89a" + bytes(32)


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


def answers_at_every_row(engine: DetectEngine, files: list[tuple[str, bytes]], batch: int) -> dict[str, list]:
    """Each file's HTTP answers at every row of a batch of ``batch``:
    ``batch`` copies of it posted at once to a server that seals a batch
    only when it is full, so that each copy rides in a row of its own
    whatever the timing."""
    server = DetectionServer(engine, ServeConfig(max_delay_ms=120_000, continuous=False), warmup=False)
    httpd = serve_frontend.serve_http(server, "127.0.0.1", 0)
    # watchdog: serve_forever returns at httpd.shutdown() in the finally below.
    threading.Thread(target=httpd.serve_forever, daemon=True, name="chip-smoke-http-rows").start()
    url = "http://%s:%d/detect" % httpd.server_address[:2]
    out = {}
    try:
        with ThreadPoolExecutor(batch) as pool:
            for name, data in files:
                answers = list(pool.map(lambda _: post(url, data), range(batch)))
                require(all(a[0] == 200 for a in answers), f"{name}: statuses {[a[0] for a in answers]}")
                out[name] = [a[1]["detections"] for a in answers]
    finally:
        httpd.shutdown()
        server.close()
        httpd.server_close()
    batches = server.snapshot()["batches"]  # final once closed
    require(batches == len(files), f"{len(files)} files of {batch} copies rode in {batches} batches")
    return out


def deployable_phase(snapshot: str, root: str, device, kind: str, smi: str,
                     config: RetinaNetConfig = RetinaNetConfig(), sides=(800, 1333)) -> dict:
    """Phase 12 on phase 11's snapshot (a model of ``config``, trained at
    image ``sides``); returns the NMS kernel's launches by the served
    exported programs (``launches``), the live engine's answer for each
    fixture at each exported (batch size, row) (``want``, keyed (name,
    batch size, row)) and the images/s and latencies of the HTTP and
    in-process loads (``stats``), which phase 14 reuses."""
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
    # GIF, TIFF and WebP reach the same exported bucket (640 x 480 each).
    more = {n: (MORE_FIXTURES / n).read_bytes() for n in NEW_FORMAT_FILES}
    more_want = {(n, *k): live_answer(live, image_io.decode(data), *k) for n, data in more.items()
                 for k in slots}
    require(all(more_want.values()), "a GIF, TIFF or WebP fixture has no detections")
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
        code, body, trace, _ = post(f"{url}/detect", truncated_gif(), trace="chip-smoke-trace")
        require(code == 400 and body.get("reason") == "decode_error" and trace == "chip-smoke-trace"
                and body.get("trace_id") == trace, f"truncated GIF: {code} {body} {trace}")
        code, body, trace, _ = post(f"{url}/detect", files[0][1])
        require(code == 200 and trace and len(trace) == 16 and body["trace_id"] == trace,
                f"minted trace id {trace!r}")
        code, body, _, _ = post(f"{url}/nowhere", files[0][1])
        require(code == 404, f"unknown path answered {code}")
        print(f"truncated GIF answered 400 decode_error, unknown path 404, trace header echoed "
              f"(given and minted)")
        # A GIF, an LZW TIFF and a lossy WebP: each answered as the live
        # engine answers its decoded pixels at an exported slot.
        for n in NEW_FORMAT_FILES:
            before = nms_cuda.kernel_launches
            code, body, _, _ = post(f"{url}/detect", more[n])
            gap = min(answer_gap(body.get("detections", []), more_want[(n, *k)]) for k in slots)
            print(f"{n} over HTTP: {code}, {len(body.get('detections', []))} detections, gap to the live "
                  f"engine at its slot {gap}, NMS launches {nms_cuda.kernel_launches - before}")
            require(code == 200 and gap == 0 and nms_cuda.kernel_launches > before,
                    f"{n}: answered {code}, gap {gap}")
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

    # Every slot over HTTP: alone above, and every row of the largest batch
    # here, so a CLI record meets an HTTP answer at its slot however the
    # CLI's requests were batched.
    nms_cuda.reset_counts()
    full = max(batch_sizes)
    rows = answers_at_every_row(engine, files, full)
    launches += nms_cuda.kernel_launches
    require(nms_cuda.plain_calls == 0, "the plain NMS ran behind HTTP")
    for n, _ in files:
        left = list(rows[n])
        for r in range(full):
            hit = next((i for i, a in enumerate(left) if answer_gap(a, want[(n, full, r)]) == 0), None)
            require(hit is not None, f"{n}: no HTTP answer equals the live engine's at row {r} of {full}")
            left.pop(hit)
        http_answers[n] += rows[n]
    print(f"each fixture posted {full} times at once to a server that seals only full batches: "
          f"{full} answers equal to the live engine's at rows 0-{full - 1}, bit for bit, for all {len(files)}")

    # The command line: offline over the fixtures, then --http and SIGTERM.
    out_jsonl = os.path.join(root, "served.jsonl")
    cli = [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve", "--export-dir", export_dir,
           *on]
    images_dir = os.path.join(root, "serve_images")  # the fixtures and a file the codec refuses
    os.makedirs(images_dir, exist_ok=True)
    for n, data in files:
        Path(images_dir, n).write_bytes(data)
    # A GIF without an image under a suffix the command line lists.
    Path(images_dir, "truncated_gif.jpg").write_bytes(truncated_gif())
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["--images", images_dir, "--output", out_jsonl],
                          cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"serve --images failed:\n{proc.stderr[-3000:]}")
    records = {r["file"]: r for r in map(json.loads, Path(out_jsonl).read_text().splitlines())}
    require(sorted(records) == sorted([n for n, _ in files] + ["truncated_gif.jpg"]), f"records {sorted(records)}")
    require("decode_error" in records["truncated_gif.jpg"].get("error", ""), "the truncated GIF was not refused")
    worst = max(check(n, records[n]["detections"]) for n, _ in files)
    # The HTTP answers above cover every exported slot, so this holds
    # whichever slot the CLI's batching put a file in.
    same = sum(records[n]["detections"] in http_answers[n] for n, _ in files)
    print(f"serve --images: {len(records)} records in {time.perf_counter() - t0:.1f} s (process included); "
          f"against the live engine: largest gap {worst}; equal to an HTTP answer for the same file "
          f"for {same} of {len(files)}")
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
    return {"launches": launches, "want": want, "stats": stats}


# ---- phase 13: observability at full width ---------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def get(url: str) -> tuple[int, bytes]:
    """(status, body) of one GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_phase(root: str, batches, device, kind: str, smi: str) -> dict[str, int]:
    """Phase 13: the obs layer on phase 8's model and batches, phase 11's
    fixture files and phase 12's exported programs; returns each kernel's
    launches in its runs."""
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)
    for part in (numerics_and_telemetry(batches, device, kind, smi), nan_provenance(root, kind, smi),
                 traced_serving(root, device, kind, smi)):
        for k in launches:
            launches[k] += part.get(k, 0)
    stall_check()
    for k, v in perf_report(root, device, kind, smi).items():
        if k in launches:
            launches[k] += v
    return launches


def numerics_and_telemetry(batches, device, kind: str, smi: str) -> dict[str, int]:
    """(a) phase 8's 6 steps without the numerics summary, with it, with it
    and without it again (turns, so that drift spreads over both); (c) the
    whole time ``--obs-port``'s status server is up (the train command
    line's ``_start_telemetry``), scraped over HTTP during the first run
    with the summary."""
    model = build_retinanet(RetinaNetConfig(), device=device, seed=0)  # gn, bf16
    state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(), device)
    steps = len(batches)
    args = train_cli.parse_args(["synthetic", "--obs-port", "0"])
    server, monitor = train_cli._start_telemetry(args, None)
    url = f"http://127.0.0.1:{server.port}"
    scraped: dict = {}

    def scrape(after_step: int) -> None:
        # Polls until a log window of this run lands, then reads both
        # endpoints and the allocator's peak at once.
        try:
            deadline = time.perf_counter() + 300
            while time.perf_counter() < deadline and scraped.get("samples", {}).get("train_step", 0) <= after_step:
                code, body = get(f"{url}/metrics")
                scraped["samples"] = obs_telemetry.parse_exposition(body.decode())[1] if code == 200 else {}
                scraped["max_allocated"] = torch.cuda.max_memory_allocated()
                time.sleep(0.05)
            scraped["healthz"] = get(f"{url}/healthz")
        except BaseException as exc:  # re-raised below, in the phase
            scraped["error"] = exc

    runs: dict[bool, list[dict]] = {False: [], True: []}
    ms: dict[bool, list[float]] = {False: [], True: []}
    used = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms", "plain"), 0)
    try:
        for turn, numerics in enumerate((False, True, True, False)):
            logged: list[dict] = []
            reset_all_counts()
            scraper = None
            if turn == 1:
                # watchdog: the scraper is joined below with a bound.
                scraper = threading.Thread(target=scrape, args=(state.step,), name="chip-smoke-scraper")
                scraper.start()
            loop_lib.run_training(
                state, iter(batches), 80,
                loop_lib.LoopConfig(total_steps=state.step + steps, log_every=1, numerics=numerics),
                log=lambda step, scalars: logged.append(scalars),
            )
            if scraper is not None:
                scraper.join(300)
                require(not scraper.is_alive(), "the /metrics scraper hangs")
                if "error" in scraped:
                    raise scraped["error"]
            got = counts()
            for k in used:
                used[k] += got[k]
            require(got["plain"] == 0 and all(got[k] == steps for k in ("matching", "focal_fwd", "focal_bwd")),
                    f"launches {got} in {steps} steps with numerics {numerics}")
            runs[numerics] += logged
            ms[numerics].append(float(np.mean([sc["step_time_ms"] for sc in logged[1:]])))
    finally:
        monitor.stop()
        server.close()
        obs_telemetry.disable()
    keys = sorted(k for k in runs[True][-1] if k.startswith("gnorm/") or k in ("update_ratio", "nonfinite_grads"))
    last = runs[True][-1]
    print(f"numerics summary, last step: " + ", ".join(f"{k} {last[k]:.6g}" for k in keys))
    off, on = float(np.mean(ms[False])), float(np.mean(ms[True]))
    print(f"mean step ms over steps 2-{steps} of each run (host clock, metrics read every step), runs "
          f"off/on/on/off: off {ms[False]}, on {ms[True]}; off {off:.3f}, on {on:.3f} "
          f"({on / off - 1:+.2%}); {kind}, {smi}")
    require(keys == ["gnorm/backbone", "gnorm/box_head", "gnorm/cls_head", "gnorm/fpn",
                     "nonfinite_grads", "update_ratio"], f"numerics keys {keys}")
    require(all(np.isfinite(sc[k]) for sc in runs[True] for k in keys), "a non-finite numerics value")
    require(all(sc["nonfinite_grads"] == 0 for sc in runs[True]), "non-finite gradient elements")
    require(not any(k in sc for sc in runs[False] for k in keys), "numerics keys in a step without the summary")

    samples = scraped["samples"]
    code, body = scraped["healthz"]
    peak = samples.get('device_memory_bytes{device="dev0",kind="peak_bytes_in_use"}')
    in_use = samples.get('device_memory_bytes{device="dev0",kind="bytes_in_use"}')
    print(f"--obs-port during the first run with the summary: /healthz {code} {json.loads(body)['status']}; "
          f"train_step {samples.get('train_step')}, train_step_time_ms {samples.get('train_step_time_ms')}, "
          f"train_update_ratio {samples.get('train_update_ratio')}; dev0 bytes_in_use {in_use}, "
          f"peak_bytes_in_use {peak} against max_memory_allocated {scraped['max_allocated']}")
    require(code == 200, f"/healthz answered {code} during training: {body[:300]!r}")
    require(samples.get("train_step", 0) > steps and "train_step_time_ms" in samples
            and in_use is not None and peak is not None,
            f"/metrics lacks this run's train or memory gauges: {sorted(samples)[:20]}")
    require(abs(peak - scraped["max_allocated"]) <= 0.01 * scraped["max_allocated"],
            f"peak_bytes_in_use {peak} against max_memory_allocated {scraped['max_allocated']}")
    del state, model
    torch.cuda.empty_cache()
    return used


def nan_provenance(root: str, kind: str, smi: str) -> dict[str, int]:
    """(b) ``train coco`` on phase 11's fixture JSONs at full width, a NaN
    injected into batch 2: the run writes NUMERICS_DUMP.json, heals from
    ckpt-1 without the poisoned batch's images, and reaches its last
    step."""
    logs = os.path.join(root, "nan_logs")
    flags = ["coco", root, "--train-annotations", "instances_0.json", "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", "instances_1.json", "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", os.path.join(root, "nan_snap"), "--steps", "3",
             "--checkpoint-every", "1", "--log-every", "1", "--log-dir", logs, "--numerics",
             "--inject-nan-step", "2", "--auto-resume"]
    reset_all_counts()
    t0 = time.perf_counter()
    out = train_cli.main(flags)
    used = counts()
    dump = json.loads(Path(logs, "NUMERICS_DUMP.json").read_text())
    (run,) = split_runs(os.path.join(logs, "metrics.jsonl"))
    events = {r["event"]: r for r in run["records"] if "event" in r}
    injected, healed = events.get("chaos_nan_injected"), events.get("auto_resume")
    print(f"train coco, NaN in batch 2, --auto-resume: final step {out['final_step']:.0f} in "
          f"{time.perf_counter() - t0:.1f} s; dump step {dump['step']}, first non-finite "
          f"{dump['first_nonfinite']}, tripped {dump['tripped']}; batch ids {dump['batch_image_ids']}; "
          f"auto_resume {healed}; launches {used}; {kind}, {smi}")
    require(out["final_step"] == 3.0, f"the healed run stopped at {out['final_step']}")
    require(injected is not None and dump["batch_image_ids"] == injected["image_ids"],
            f"the dump's ids {dump.get('batch_image_ids')} are not the poisoned batch's {injected}")
    require(dump["first_nonfinite"] is not None, "the dump names no first non-finite value")
    require(healed is not None and healed["exclude_ids"] == sorted(set(injected["image_ids"])),
            f"auto_resume {healed}")
    require(used["plain"] == 0 and used["matching"] >= 3 and used["nms"] >= 1, f"launches {used}")
    return used


def traced_serving(root: str, device, kind: str, smi: str) -> dict[str, int]:
    """(d) ``serve`` over phase 12's exported programs, in this process,
    at 8 HTTP clients, four times: without tracing, with ``--obs-trace
    --obs-port``, with them again and without again, so that a drift of
    the host falls on both settings alike.  Each traced run: the requests
    counted on ``/metrics`` and a ``serve_request`` span for each in the
    exported trace; then the median of each serve span over both traced
    runs, and the mean images/s of each setting.  Each run is stopped by
    SIGTERM as a deployment stops it."""
    export_dir = os.path.join(root, "export")
    used = {"nms": 0}
    rates: dict[bool, list[float]] = {False: [], True: []}
    spans: dict[str, list[float]] = {}
    for i, traced in enumerate((False, True, True, False)):
        http_port, obs_port = free_port(), free_port()
        obs_dir = os.path.join(root, f"serve_obs_{i}")
        argv = ["--export-dir", export_dir, "--http", str(http_port), "--device", device.type]
        if traced:
            argv += ["--obs-trace", "--obs-dir", obs_dir, "--obs-port", str(obs_port)]
        seen: dict = {}
        stopped = threading.Event()

        def drive() -> None:
            try:
                url = f"http://127.0.0.1:{http_port}"
                deadline = time.perf_counter() + 300
                while not stopped.is_set():
                    try:
                        if get(f"{url}/healthz")[0] == 200:
                            break
                    except OSError:
                        pass  # not listening yet
                    require(time.perf_counter() < deadline, "serve did not come up")
                    time.sleep(0.2)
                http_load(f"{url}/detect", 8, 2)  # warm-up
                seen["results"], seen["wall"] = http_load(f"{url}/detect", 8, 8)
                if traced:
                    seen["healthz"] = get(f"http://127.0.0.1:{obs_port}/healthz")
                    seen["metrics"] = obs_telemetry.parse_exposition(
                        get(f"http://127.0.0.1:{obs_port}/metrics")[1].decode())[1]
            except BaseException as exc:  # re-raised below, in the phase
                seen["error"] = exc
            finally:
                if not stopped.is_set():
                    os.kill(os.getpid(), signal.SIGTERM)  # the serve CLI drains and returns

        reset_all_counts()
        # watchdog: the driver ends by stopping the server and is joined below.
        driver = threading.Thread(target=drive, name="chip-smoke-serve-driver")
        driver.start()
        try:
            snap = serve_frontend.main(argv)
        except KeyboardInterrupt:  # stopped before it served: the driver says why
            snap = None
        finally:
            stopped.set()
            # The next run starts untraced: tracing and the push record
            # sites stay on in this process after a traced run otherwise.
            obs_trace.reset()
            obs_telemetry.disable()
        driver.join(300)
        require(not driver.is_alive(), "the serve driver hangs")
        if "error" in seen:
            raise seen["error"]
        require(snap is not None, "serve stopped before it served")
        got = counts()
        used["nms"] += got["nms"]
        results = seen["results"]
        require(all(r[1][0] == 200 for r in results), "a request failed")
        require(got["plain"] == 0 and got["nms"] >= snap["batches"] > 0,
                f"NMS launches {got['nms']} for {snap['batches']} batches")
        rates[traced].append(latency_line(
            f"serve CLI, HTTP, 8 clients, run {i + 1} of 4, tracing {'on' if traced else 'off'}",
            results, seen["wall"], kind, smi)["images_per_s"])
        sent = snap["completed"]
        require(sent == 8 * 2 + 8 * 8, f"{sent} requests completed of {8 * 2 + 8 * 8} sent")
        if not traced:
            continue
        code, body = seen["healthz"]
        counted = seen["metrics"].get("serve_requests_completed_total")
        print(f"--obs-port: /healthz {code}, /metrics serve_requests_completed_total {counted} for {sent} "
              f"requests sent")
        require(code == 200 and counted == sent, f"/healthz {code}, {counted} counted for {sent} sent")
        events = json.loads(Path(obs_dir, "trace.json").read_text())["traceEvents"]
        traced_ids = set()
        n_requests = 0
        for e in events:
            if e["ph"] == "X":
                spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
                if e["name"] == "serve_request":
                    n_requests += 1
                    traced_ids.add((e.get("args") or {}).get("trace"))
        answered = {r[1][1]["trace_id"] for r in results}
        require(n_requests == sent and answered <= traced_ids,
                f"{n_requests} serve_request spans for {sent} requests")
    print("median ms a span, tracing on (all requests of both traced runs; 8 clients): " + ", ".join(
        f"{name} {float(np.median(spans[name])):.3f} (n {len(spans[name])})"
        for name in ("serve_request", "serve_preprocess", "serve_assemble", "serve_dispatch",
                     "serve_fetch", "serve_convert") if name in spans) + f"; {kind}, {smi}")
    off, on = float(np.mean(rates[False])), float(np.mean(rates[True]))
    print(f"images/s at 8 clients, runs in turn off/on/on/off: tracing off {rates[False]} (mean {off:.2f}), "
          f"on {rates[True]} (mean {on:.2f}), on against off {100 * (on / off - 1):+.2f}%; {kind}, {smi}")
    return used


def stall_check() -> None:
    """(e) A watchdog component with a 1 s budget that never beats makes
    the status server's /healthz answer 503 naming it."""
    obs_telemetry.enable()
    server = obs_telemetry.start_http_server(obs_telemetry.default(), port=0)
    hb = obs_watchdog.register("chip-smoke-stalled", stall_after=1.0)
    try:
        time.sleep(1.5)
        code, body = get(f"http://127.0.0.1:{server.port}/healthz")
        payload = json.loads(body)
        print(f"a component silent for 1.5 s of its 1 s budget: /healthz {code} {payload.get('status')} "
              f"naming {payload.get('component')}")
        require(code == 503 and payload.get("component") == "chip-smoke-stalled",
                f"/healthz {code} {payload}")
        hb.beat()
        code, _ = get(f"http://127.0.0.1:{server.port}/healthz")
        require(code == 200, f"/healthz {code} after the beat")
    finally:
        hb.close()
        server.close()
        obs_telemetry.disable()


def perf_report(root: str, device, kind: str, smi: str, steps: int = 6,
                config: RetinaNetConfig = RetinaNetConfig(), batch: int = 16, hw=TRAIN_HW) -> dict[str, int]:
    """(f) ``train coco`` at the defaults on phase 11's fixture JSONs with
    ``--obs-trace --obs-dir``: the PERF_REPORT.json that the command line
    writes at finalize passes ``validate_report``, its decomposition sums
    to 1 within 0.02, the step FLOPs are counted and the MFU against the
    card's peak row lies in (0, 1], and the offline command line writes
    the same bytes; the training kernels launched once a step."""
    obs_dir = os.path.join(root, "perf_obs")
    flags = ["coco", root, "--train-annotations", "instances_0.json", "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", "instances_1.json", "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", os.path.join(root, "perf_snap"), "--steps",
             str(steps), "--log-every", "1", "--obs-trace", "--obs-dir", obs_dir]
    reset_all_counts()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(flags)
    finally:
        obs_trace.reset()
        obs_telemetry.disable()
    wall = time.perf_counter() - t0
    used = counts()
    inline = Path(obs_dir, "PERF_REPORT.json").read_bytes()
    report = json.loads(inline)
    problems = analyze_lib.validate_report(report)
    steps_sec, mfu = report.get("steps") or {}, report.get("mfu") or {}
    decomposition = steps_sec.get("decomposition") or {}
    peak, peak_source = analyze_lib.device_peak_tflops(kind)
    offline = os.path.join(root, "PERF_REPORT.offline.json")
    rc = analyze_cli.main([obs_dir, "--out", offline])
    # The count covers the backward: the same model's forward alone on a
    # batch of 16 at the bucket counts about a third of it.
    from torch.utils.flop_counter import FlopCounterMode

    model = build_retinanet(config, device=device, seed=0)
    images = torch.zeros((batch, *hw, 3), dtype=torch.uint8, device=device)
    forward = FlopCounterMode(display=False)
    with forward, torch.no_grad():
        model(normalize_images(images))
    forward_flops = float(forward.get_total_flops())
    del model, images
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = {"perf_report": "PERF_REPORT.json", "device_kind": report["source"]["device_kind"],
               "steps": steps_sec.get("count"), "decomposition": decomposition,
               "flops_per_step": mfu.get("flops_per_step"), "flops_source": mfu.get("flops_source"),
               "achieved_tflops": mfu.get("achieved_tflops"), "peak_tflops": mfu.get("peak_tflops"),
               "mfu": mfu.get("mfu"), "forward_flops": forward_flops,
               "top_bottlenecks": [b["name"] for b in report["bottlenecks"]]}
    print(f"train coco --obs-trace, {steps} steps and a final eval in {wall:.1f} s; launches {used}; "
          f"{kind}, {smi}")
    print(json.dumps(summary, sort_keys=True))
    require(out["final_step"] == float(steps), f"final step {out['final_step']}")
    require(problems == [], f"PERF_REPORT.json fails its schema: {problems}")
    require(abs(sum(decomposition.values()) - 1.0) <= 0.02, f"decomposition {decomposition}")
    require(report["source"]["device_kind"] == kind and peak is not None
            and peak_source == ("spec" if device.type == "cuda" else "nominal-cpu"), f"no peak row for {kind!r}")
    require((mfu.get("flops_per_step") or 0) > 0 and mfu.get("flops_source") == loop_lib.FLOPS_SOURCE,
            f"step FLOPs {mfu}")
    require(mfu.get("peak_tflops") == peak and 0 < (mfu.get("mfu") or 0) <= 1, f"mfu {mfu}")
    ratio = mfu["flops_per_step"] / forward_flops
    require(2.5 < ratio < 3.5, f"the step's FLOPs are {ratio:.3f}x the forward's: the backward is not counted")
    require(rc == 0 and Path(offline).read_bytes() == inline, "the offline report differs from the inline one")
    require(used["plain"] == 0 and all(used[k] == steps for k in ("matching", "focal_fwd", "focal_bwd"))
            and used["nms"] >= 1, f"launches {used} in {steps} steps and an eval")
    return used


# ---- phase 14: the serve fleet on one card ----------------------------------

# Client threads in another process that post the fixtures in turn until a
# stop file appears (or a time limit passes); each result carries its
# start on the system-wide monotonic clock.
STOPPABLE_CLIENT = """
import json, os, sys, threading, time, urllib.error, urllib.request
url, clients, stop_file, limit_s = sys.argv[1], int(sys.argv[2]), sys.argv[3], float(sys.argv[4])
files = [(path.rsplit("/", 1)[-1], open(path, "rb").read()) for path in sys.argv[5:]]
results, lock = [], threading.Lock()
t_start = time.monotonic()

def client(i):
    j = 0
    while not os.path.exists(stop_file) and time.monotonic() - t_start < limit_s:
        name, data = files[(i + j) % len(files)]
        j += 1
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"),
                                        timeout=300) as r:
                code, body = r.status, json.load(r)
        except urllib.error.HTTPError as e:
            code, body = e.code, json.load(e)
        except Exception as e:  # a connection that failed is a result too
            code, body = 0, {"error": repr(e)}
        with lock:
            results.append([name, [code, body], time.monotonic() - t0, t0])

threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
sys.stdout.write(json.dumps({"wall": time.monotonic() - t_start, "results": results}))
"""


class Load:
    """``clients`` HTTP client threads in another process, posting the
    fixtures to ``url`` until ``stop()``."""

    def __init__(self, url: str, clients: int, root: str, limit_s: float = 300.0):
        self.stop_file = os.path.join(root, f"stop-load-{time.monotonic_ns()}")
        paths = [str(JPEG_FIXTURES / n) for n, _ in served_files()]
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", STOPPABLE_CLIENT, url, str(clients), self.stop_file, str(limit_s),
             *paths], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop(self) -> tuple[list, float]:
        """[(name, (status, body), seconds, start)] and the wall time."""
        Path(self.stop_file).touch()
        out, err = self.proc.communicate(timeout=600)
        require(self.proc.returncode == 0, f"the load's clients failed:\n{err[-3000:]}")
        got = json.loads(out)
        return [(n, tuple(r), secs, t0) for n, r, secs, t0 in got["results"]], got["wall"]


class Tail:
    """The lines a child process writes to ``path``, each with the
    monotonic time a reader thread first saw it (every 0.05 s)."""

    def __init__(self, path: str):
        self.path = path
        self.lines: list[tuple[float, str]] = []
        self.error: BaseException | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # watchdog: the reader ends at close(), which joins it.
        self._thread = threading.Thread(target=self._run, daemon=True, name="chip-smoke-tail")
        self._thread.start()

    def _run(self) -> None:
        try:
            with open(self.path) as f:
                pending = ""
                while True:
                    chunk = f.read()
                    if chunk:
                        *full, pending = (pending + chunk).split("\n")
                        now = time.monotonic()
                        with self._lock:
                            self.lines += [(now, line) for line in full]
                    elif self._stop.is_set():
                        return
                    else:
                        time.sleep(0.05)
        except BaseException as exc:  # re-raised by close(), in the phase
            self.error = exc

    def events(self, kind: str | None = None) -> list[tuple[float, dict]]:
        """The JSON events of the lines.  The fleet and its replicas share
        one output file, and one process's event can land on another's line
        before its newline: each line is read as a run of JSON objects."""
        with self._lock:
            lines = list(self.lines)
        decoder, out = json.JSONDecoder(), []
        for t, line in lines:
            pos = 0
            while line.startswith('{"event"', pos):
                try:
                    event, pos = decoder.raw_decode(line, pos)
                except json.JSONDecodeError:
                    break  # the rest of the line is another process's text
                out.append((t, event))
        return [(t, e) for t, e in out if kind is None or e["event"] == kind]

    def text(self) -> str:
        with self._lock:
            return "\n".join(line for _, line in self.lines)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(30)
        if self.error is not None:
            raise self.error


class FleetCli:
    """``python -m ...serve.fleet --http 0 *args`` in a process group of its
    own (the fleet and the replicas it spawns), its standard output and
    error tailed from files under ``root``."""

    def __init__(self, root: str, name: str, args: list[str], wait: bool = True):
        self.name = name
        paths = [os.path.join(root, f"{name}.{s}") for s in ("out", "err")]
        files = [open(p, "w") for p in paths]
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve.fleet", "--http", "0",
             *args], cwd=Path(__file__).resolve().parent, stdout=files[0], stderr=files[1],
            start_new_session=True)
        for f in files:
            f.close()
        self.out, self.err = Tail(paths[0]), Tail(paths[1])
        if wait:
            self.ready()

    def ready(self) -> "FleetCli":
        """Wait until it serves; its URLs and seconds to come up."""
        self.url = self._line("fleet serving on ").split()[3]
        self.up_s = next(t for t, line in self.out.lines if line.startswith("fleet serving on ")) - self.t0
        obs = [line for _, line in self.out.lines if line.startswith("fleet telemetry on ")]
        self.obs_url = obs[0].split()[3] if obs else None
        return self

    def _line(self, prefix: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = next((line for _, line in list(self.out.lines) if line.startswith(prefix)), None)
            if line is not None:
                return line
            require(self.proc.poll() is None,
                    f"the {self.name} fleet exited {self.proc.returncode}:\n{self.err.text()[-3000:]}")
            time.sleep(0.05)
        require(False, f"the {self.name} fleet did not print {prefix!r}:\n{self.err.text()[-3000:]}")

    def events(self, kind: str | None = None) -> list[tuple[float, dict]]:
        """Its supervision events (standard output) and its router's and
        autoscaler's (standard error), in the order seen."""
        return sorted(self.out.events(kind) + self.err.events(kind), key=lambda te: te[0])

    def status(self) -> dict:
        code, body = get(f"{self.url}/fleet")
        require(code == 200, f"/fleet answered {code}")
        return json.loads(body)

    def replica(self, rid: str) -> dict | None:
        return next((r for r in self.status()["replicas"] if r["replica_id"] == rid), None)

    def metrics(self, url: str | None = None) -> dict[str, float]:
        code, body = get(f"{url or self.url}/metrics")
        require(code == 200, f"/metrics answered {code}")
        return obs_telemetry.parse_exposition(body.decode())[1]

    def wait(self, what: str, cond, timeout: float) -> float:
        """Poll ``cond()`` every 0.1 s; the monotonic time it first held."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return time.monotonic()
            require(self.proc.poll() is None, f"the {self.name} fleet exited while waiting for {what}")
            time.sleep(0.1)
        require(False, f"{self.name} fleet: {what} within {timeout} s; stderr:\n{self.err.text()[-3000:]}")

    def stop(self) -> dict:
        """SIGTERM: the fleet drains its replicas and exits 0; its final
        ``fleet_stats``."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=180)
        finally:
            self.kill()
        require(self.proc.returncode == 0, f"the {self.name} fleet exited {self.proc.returncode} on SIGTERM:\n"
                f"{self.err.text()[-3000:]}")
        stats = [line for _, line in self.out.lines if line.startswith('{"fleet_stats"')]
        require(len(stats) == 1, f"the {self.name} fleet printed no fleet_stats")
        return json.loads(stats[0])["fleet_stats"]

    def kill(self) -> None:
        """Whatever of the group is left: gone (a no-op after a clean stop)."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        if self.proc.poll() is None:
            self.proc.wait(timeout=60)
        self.out.close()
        self.err.close()


def slot_gap(want: dict, name: str, answer: list[dict]) -> float:
    """0 when ``answer`` is the live engine's for ``name`` at one of the
    exported (batch size, row) slots."""
    return min(answer_gap(answer, w) for (n, *_slot), w in want.items() if n == name)


# How long a spawned full-width replica may take to answer /healthz: it
# imports torch and loads two 157 MB programs, in 25-43 s on a quiet card
# host and in more than the fleet's default 60 s once, under (e)'s burst
# of 32 clients (NVIDIA H100 80GB HBM3, 700 W).
REPLICA_START_S = 180


def fleet_phase(root: str, served: dict, device, kind: str, smi: str) -> int:
    """Phase 14 over phase 12's exported programs; returns the NMS kernel's
    launches by this process's servers ((a) and (d) in process)."""
    export_dir = os.path.join(root, "export")
    launches = in_process_fleet(export_dir, served, device, kind, smi)
    fleet_cli(root, export_dir, served, device, kind, smi)
    # (e)'s replica loads its programs while (c)'s stub fleet runs.
    scaled = FleetCli(root, "autoscale", [
        "--spawn", "1", "--export-dir", export_dir, "--device", device.type, "--autoscale",
        "--min-replicas", "1", "--max-replicas", "2", "--autoscale-for-s", "1",
        "--autoscale-up-cooldown-s", "5", "--autoscale-down-cooldown-s", "5",
        "--autoscale-interval-s", "0.5", "--poll-interval", "0.5", "--fleet-timeout-s", "300",
        "--replica-start-timeout-s", str(REPLICA_START_S)], wait=False)
    try:
        canary_cli(root, kind, smi)
        autoscale_cli(scaled.ready(), root, served, kind, smi)
    finally:
        scaled.kill()
    return launches


def stream_frames(url: str, want: dict, label: str, kind: str, smi: str) -> dict:
    """The decodable fixtures, each 3 times in a row, as the frames of one
    stream through ``url``'s /stream/open, /stream/frame and
    /stream/close: every frame answered 200, in order, and its detections
    without ``track_id`` the live engine's at an exported slot.  Returns
    the session's final stats."""
    files = served_files()
    code, opened, _, _ = post(f"{url}/stream/open", b"")
    require(code == 200, f"/stream/open answered {code} {opened}")
    head = {"X-Retinanet-Stream": opened["session"]}
    hits, worst, ms = 0, 0.0, []
    for seq, (name, data) in enumerate((n, d) for n, d in files for _ in range(3)):
        t0 = time.perf_counter()
        req = urllib.request.Request(f"{url}/stream/frame", data=data, method="POST",
                                     headers={**head, "X-Retinanet-Frame": str(seq)})
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, json.load(r)
        ms.append((time.perf_counter() - t0) * 1e3)
        require(code == 200 and body["frame"] == seq, f"frame {seq}: {code} {body.get('frame')}")
        require(all("track_id" in d for d in body["detections"]), f"frame {seq} has no track ids")
        stripped = [{k: v for k, v in d.items() if k != "track_id"} for d in body["detections"]]
        worst = max(worst, slot_gap(want, name, stripped))
        hits += bool(body["cache_hit"])
    req = urllib.request.Request(f"{url}/stream/close", data=b"", method="POST", headers=head)
    with urllib.request.urlopen(req, timeout=60) as r:
        stats = json.load(r)["stats"]
    print(f"{label}: {len(ms)} frames in order, cache hits {hits} (session's count "
          f"{stats['cache_hits']}), client p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} "
          f"ms, session frame p50 {stats.get('p50_ms')} ms p99 {stats.get('p99_ms')} ms; answers against "
          f"the live engine at an exported slot: largest gap {worst}; {kind}, {smi}")
    require(worst == 0, f"{label}: a frame's answer differs from the live engine's by {worst}")
    require(stats["frames"] == len(ms) and stats["cache_hits"] == hits, f"{label}: session stats {stats}")
    return stats


def settled_batches(servers) -> int:
    """The servers' finished batches, read once the last batch's count
    has landed (its futures resolve just before the count moves)."""
    time.sleep(0.2)
    return sum(s.snapshot()["batches"] for s in servers)


def in_process_fleet(export_dir: str, served: dict, device, kind: str, smi: str) -> int:
    """(a) A ``FleetRouter`` over two ``LocalReplica``s, each a
    ``DetectionServer`` over ``DetectEngine.from_export`` on the card, at
    8 client threads; (d, cache off) the same two servers behind
    ``serve_http`` with a stream manager whose frame-delta cache is off,
    behind ``serve_fleet_http``: the stream's answers are the live
    engine's."""
    want, files = served["want"], served_files()
    servers = [DetectionServer(DetectEngine.from_export(export_dir, device), ServeConfig(),
                               replica_id=f"in-process-{k}") for k in range(2)]
    router = serve_fleet.FleetRouter([LocalReplica(s) for s in servers],
                                     serve_fleet.FleetConfig(default_timeout_s=300))
    launches = 0
    try:
        client_load(lambda n, d: router.detect(d), files, 8, 2)  # warm-up
        batches0 = sum(s.snapshot()["batches"] for s in servers)
        nms_cuda.reset_counts()
        results, wall = client_load(lambda n, d: router.detect(d), files, 8, 8)
        batches = settled_batches(servers) - batches0
        used, plain = nms_cuda.kernel_launches, nms_cuda.plain_calls
        launches += used
        worst = max(slot_gap(want, n, r) for n, r, _ in results)
        stats = latency_line("(a) in-process fleet of 2, 8 client threads", results, wall, kind, smi)
        base = served["stats"][("in-process", 8)]
        print(f"  against phase 12's one in-process server at 8 clients: {stats['images_per_s']:.2f} / "
              f"{base['images_per_s']:.2f} images/s, p50 {stats['p50_ms']:.3f} / {base['p50_ms']:.3f} ms, "
              f"p99 {stats['p99_ms']:.3f} / {base['p99_ms']:.3f} ms; {batches} batches over "
              f"{[s.snapshot()['batches'] for s in servers]} per replica, NMS launches {used}, plain {plain}; "
              f"answers against the live engine at an exported slot: largest gap {worst}")
        require(worst == 0, f"an in-process fleet answer differs from the live engine's by {worst}")
        require(used == batches > 0 and plain == 0, f"NMS launches {used} for {batches} batches")
    finally:
        router.close()

    # (d), cache off: the fleet edge over HTTP replicas whose streams ride
    # the device every frame.
    https = [serve_frontend.serve_http(s, "127.0.0.1", 0,
                                       stream=StreamManager(s, StreamConfig(delta_threshold=0.0)))
             for s in servers]
    for httpd in https:
        # watchdog: serve_forever returns at httpd.shutdown() in the finally below.
        threading.Thread(target=httpd.serve_forever, daemon=True, name="chip-smoke-replica-http").start()
    router = serve_fleet.FleetRouter(
        [HttpReplica("http://%s:%d" % h.server_address[:2], timeout_s=300) for h in https],
        serve_fleet.FleetConfig(default_timeout_s=300))
    edge = serve_fleet.serve_fleet_http(router, "127.0.0.1", 0, request_timeout_s=300)
    # watchdog: serve_forever returns at edge.shutdown() in the finally below.
    threading.Thread(target=edge.serve_forever, daemon=True, name="chip-smoke-fleet-http").start()
    try:
        batches0 = sum(s.snapshot()["batches"] for s in servers)
        nms_cuda.reset_counts()
        stats = stream_frames("http://%s:%d" % edge.server_address[:2], want,
                              "(d) a stream through the in-process fleet edge, frame-delta cache off",
                              kind, smi)
        batches = settled_batches(servers) - batches0
        used = nms_cuda.kernel_launches
        launches += used
        require(stats["cache_hits"] == 0, "a frame hit the cache with the cache off")
        require(used == batches > 0 and nms_cuda.plain_calls == 0,
                f"NMS launches {used} for {batches} stream batches")
    finally:
        edge.shutdown()
        edge.server_close()
        router.close()
        for httpd in https:
            httpd.shutdown()
            httpd.server_close()  # closes its stream manager
        for s in servers:
            s.close()
    del servers
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def gib(v: float | None) -> str:
    return "not measured" if v is None else f"{v / 2**30:.3f} GiB"


def replica_peaks(fleet: FleetCli) -> dict[str, float]:
    """Each spawned replica's peak device memory, from its own /metrics."""
    peaks = {}
    ports = {e["replica_id"]: e["port"] for _, e in fleet.events("fleet_replica_spawned")}
    for rid, port in sorted(ports.items()):
        if fleet.replica(rid) is None:
            continue  # scaled down
        samples = fleet.metrics(f"http://127.0.0.1:{port}")
        peaks[rid] = samples.get('device_memory_bytes{device="dev0",kind="peak_bytes_in_use"}')
    return peaks


def fleet_cli(root: str, export_dir: str, served: dict, device, kind: str, smi: str) -> None:
    """(b) The fleet command line over 2 spawned replicas of the export;
    8 and 32 client threads in another process; one replica SIGKILLed
    under load: every request answered (re-dispatched at most once), one
    breaker open, the respawned replica readmitted with its weight, one
    fleet-availability SLO violation; then (d, cache on) a stream through
    its edge."""
    want = served["want"]
    fleet = FleetCli(root, "fleet", [
        "--spawn", "2", "--export-dir", export_dir, "--device", device.type, "--obs-port", "0",
        "--poll-interval", "0.5", "--slo-poll-s", "0.5", "--respawn-delay-s", "0.5",
        "--fleet-timeout-s", "300", "--replica-start-timeout-s", str(REPLICA_START_S)])
    try:
        spawned = {e["replica_id"]: e for _, e in fleet.events("fleet_replica_spawned")}
        print(f"(b) fleet CLI with 2 replicas of the export up in {fleet.up_s:.1f} s (the replicas start "
              f"side by side); {kind}, {smi}")
        http_load(f"{fleet.url}/detect", 8, 2)  # warm-up
        for clients, per_client in ((8, 8), (32, 4)):
            results, wall = http_load(f"{fleet.url}/detect", clients, per_client)
            require(all(r[1][0] == 200 for r in results), f"statuses {Counter(r[1][0] for r in results)}")
            worst = max(slot_gap(want, n, r[1]["detections"]) for n, r, _ in results)
            stats = latency_line(f"(b) fleet CLI, 2 replicas, HTTP, {clients} client threads", results, wall,
                                 kind, smi)
            base = served["stats"][("http", clients)]
            print(f"  against phase 12's one server over HTTP: {stats['images_per_s']:.2f} / "
                  f"{base['images_per_s']:.2f} images/s, p50 {stats['p50_ms']:.3f} / {base['p50_ms']:.3f} ms, "
                  f"p99 {stats['p99_ms']:.3f} / {base['p99_ms']:.3f} ms; answers against the live engine at an "
                  f"exported slot: largest gap {worst}")
            require(worst == 0, f"a fleet answer differs from the live engine's by {worst}")
        peaks = replica_peaks(fleet)
        print(f"(b) each replica's peak device memory (its /metrics device_memory_bytes): "
              + ", ".join(f"{rid} {gib(v)}" for rid, v in peaks.items()) + f"; {kind}, {smi}")
        require(len(peaks) == 2 and (device.type != "cuda" or all(peaks.values())), f"peaks {peaks}")

        # SIGKILL replica-0 under 32 clients, at an instant when it holds
        # requests: the router scales a replica's weight by the fleet's best
        # windowed p99 over its own, so a replica that drew a slow request
        # can take a small share and hold none at a given instant.
        load = Load(f"{fleet.url}/detect", 32, root)
        time.sleep(2.0)
        r0_url = f"http://127.0.0.1:{spawned['replica-0']['port']}/healthz"
        deadline = time.monotonic() + 60.0
        while (inflight := json.loads(get(r0_url)[1])["load"]["inflight"]) < 2:
            require(time.monotonic() < deadline, "replica-0 held fewer than 2 requests at every instant of "
                                                 "60 s under 32 client threads")
            time.sleep(0.02)
        t_kill = time.monotonic()
        os.kill(spawned["replica-0"]["pid"], signal.SIGKILL)
        time.sleep(3.0)
        results, wall = load.stop()
        codes = Counter(r[1][0] for r in results)
        killed_worst = max(slot_gap(want, n, r[1]["detections"]) for n, r, _, _ in results if r[0] == 200)
        redispatches = fleet.status()["redispatches"]
        print(f"(b) replica-0 SIGKILLed {t_kill - load.t0:.1f} s into 32 client threads, with {inflight} requests "
              f"in flight on it: {len(results)} requests in {wall:.1f} s, statuses {dict(codes)}, fleet "
              f"re-dispatches {redispatches}; largest gap {killed_worst}")
        require(set(codes) == {200} and killed_worst == 0, f"a request failed across the kill: {dict(codes)}")
        require(redispatches >= 1, "no request was re-dispatched across the kill")
        t_back = fleet.wait("replica-0 readmitted with its weight", lambda: (
            (r := fleet.replica("replica-0")) is not None and r["state"] == "closed" and r["weight"] > 0
            and fleet.events("fleet_replica_respawned")), timeout=240)
        (t_respawned, respawned), = fleet.events("fleet_replica_respawned")
        (t_died, died), = fleet.events("fleet_replica_died")
        require(died["replica_id"] == "replica-0", f"died {died}")
        code, body = get(f"http://127.0.0.1:{respawned['port']}/healthz")
        opens = [e for _, e in fleet.events("fleet_breaker_open") if e["replica_id"] == "replica-0"]
        first = [e for e in opens if e["reason"] != "half_open_probe_failed"]
        violations = fleet.metrics(fleet.obs_url).get('slo_violations_total{rule="fleet-availability"}')
        weight = fleet.replica("replica-0")["weight"]
        print(f"(b) respawn: the supervisor saw replica-0 die {t_died - t_kill:.1f} s after the kill (rc "
              f"{died['rc']}); the new process healthy {t_respawned - t_kill:.1f} s after the kill, readmitted with weight "
              f"{weight} {t_back - t_kill:.1f} s after it; its /healthz {code}; fleet_breaker_open events "
              f"{len(opens)} ({[e['reason'] for e in opens]}), the first {first}; fleet-availability SLO "
              f"violations on the fleet's /metrics {violations}; {kind}, {smi}")
        require(len(first) == 1 and code == 200 and violations == 1.0,
                f"breaker opens {first}, /healthz {code}, violations {violations}")
        results, wall = http_load(f"{fleet.url}/detect", 8, 2)
        require(all(r[1][0] == 200 for r in results)
                and max(slot_gap(want, n, r[1]["detections"]) for n, r, _ in results) == 0,
                "the fleet's answers after the respawn")

        # (d), cache on: the replicas' stream managers at their defaults.
        stats = stream_frames(fleet.url, want, "(d) a stream through the fleet CLI's edge, frame-delta cache on",
                              kind, smi)
        require(stats["cache_hits"] == 2 * len(served_files()), f"cache hits {stats['cache_hits']}")
        t_stop = time.monotonic()
        final = fleet.stop()
        print(f"(b) SIGTERM: the fleet drained and exited 0 in {time.monotonic() - t_stop:.1f} s; fleet_stats "
              f"completed {final['completed']}, "
              f"failed {final['failed']}, shed {final['shed']}")
        require(final["failed"] == 0 and not final["shed"], f"fleet_stats {final}")
    finally:
        fleet.kill()


def canary_cli(root: str, kind: str, smi: str) -> None:
    """(c) A stub fleet with a stub canary slowed to 250 ms a batch: exactly
    one ``canary_rollback``, the canary drained at weight 0, the base
    replica's weight the formula's on its own load again."""
    fleet = FleetCli(root, "canary", [
        "--spawn", "1", "--stub-engine", "--stub-delay-ms", "20", "--canary-stub-delay-ms", "250",
        "--canary-for-s", "2", "--canary-poll-s", "0.5", "--poll-interval", "0.5"])
    try:
        before = {r["replica_id"]: r["weight"] for r in fleet.status()["replicas"]}
        t0 = time.monotonic()
        results, wall = http_load(f"{fleet.url}/detect", 8, 6)
        require(all(r[1][0] == 200 for r in results), f"statuses {Counter(r[1][0] for r in results)}")
        fleet.wait("the canary rolled back", lambda: (
            fleet.status()["canary_outcome"] == "rolled_back" and fleet.events("canary_rollback")), 90)
        status = fleet.status()
        by_id = {r["replica_id"]: r for r in status["replicas"]}
        (t_rb, rollback), = fleet.events("canary_rollback")
        base = by_id["replica-0"]
        formula = serve_fleet.replica_weight(base["load"], base["load"].get("p99_ms"))
        print(f"(c) canary (stub, 250 ms a batch) weights {before} before; one canary_rollback "
              f"{t_rb - t0:.1f} s after the load began: rule {rollback['rule']}, value {rollback['value']}, "
              f"threshold {rollback['threshold']}; then canary {by_id['canary']['state']} at weight "
              f"{by_id['canary']['weight']}, replica-0 at {base['weight']} (the formula on its load: {formula}); "
              f"{kind}, {smi}")
        require(status["canary_rollbacks"] == 1 and by_id["canary"]["state"] == "drained"
                and by_id["canary"]["weight"] == 0.0 and base["weight"] == formula > 0,
                f"after the rollback: {status['canary_rollbacks']} {by_id}")
        results, _ = http_load(f"{fleet.url}/detect", 8, 2)
        require(all(r[1][0] == 200 for r in results), "a request failed after the rollback")
        fleet.stop()
        require(len(fleet.events("canary_rollback")) == 1, "more than one canary_rollback")
    finally:
        fleet.kill()


def autoscale_cli(fleet: FleetCli, root: str, served: dict, kind: str, smi: str) -> None:
    """(e) ``--autoscale --min-replicas 1 --max-replicas 2`` (``fleet``): a
    burst of 32 client threads scales up to 2 replicas on the card, the new
    one takes weighted requests, and a trickle of 1 client through idle
    time drains the fleet back to 1; no request fails."""
    want = served["want"]
    try:
        burst = Load(f"{fleet.url}/detect", 32, root)
        t_burst = time.monotonic()
        t_decision = fleet.wait("a scale-up decision", lambda: fleet.events("autoscale_decision"),
                                REPLICA_START_S + 60)
        new = fleet.status()["replicas"][-1]["replica_id"]
        t_first = fleet.wait(f"{new}'s first weighted request", lambda: (
            (r := fleet.replica(new)) is not None and r["weight"] > 0
            and (r["load"].get("completed") or 0) > 0), 120)
        time.sleep(2.0)
        peaks = replica_peaks(fleet)
        results, wall = burst.stop()
        trickle = Load(f"{fleet.url}/detect", 1, root)
        fleet.wait("the fleet back to 1 replica", lambda: (
            len(fleet.status()["replicas"]) == 1
            and any(d["decision"] == "scale_down" for _, d in fleet.events("autoscale_decision"))), 180)
        time.sleep(1.0)
        slow, _ = trickle.stop()
        t_stop = time.monotonic()
        final = fleet.stop()
        t_stop = time.monotonic() - t_stop
        decisions = fleet.events("autoscale_decision")
        for t, d in decisions:
            print(f"(e) {t - t_burst:+.1f} s after the burst began: {d['decision']} ({d['reason']}), delta "
                  f"{d['delta']}, occupancy {d['occupancy']}, replicas before {d['replicas_before']}"
                  + (f", victims {d['victims']}" if "victims" in d else ""))
        failed_launches = [d for _, d in fleet.events("autoscale_launch_failed")]
        for d in failed_launches:
            print(f"(e) a scale-up's replica failed to start: {d['error']}")
        every = results + slow
        codes = Counter(r[1][0] for r in every)
        worst = max(slot_gap(want, n, r[1]["detections"]) for n, r, _, _ in every if r[0] == 200)
        served_by_new = sum(t0 >= t_first for _, _, _, t0 in results)
        (t_drained, _), = fleet.events("fleet_replica_draining")
        (t_removed, _), = fleet.events("fleet_replica_removed")
        trickle_ms = np.array([r[2] for r in slow]) * 1e3
        print(f"(e) the victim drained {t_drained - t_burst:+.1f} s and removed {t_removed - t_burst:+.1f} s after "
              f"the burst began; the trickle's requests p50 {np.percentile(trickle_ms, 50):.3f} ms, max "
              f"{trickle_ms.max():.3f} ms; SIGTERM stopped the fleet in {t_stop:.1f} s")
        print(f"(e) fleet up {fleet.up_s:.1f} s; burst of 32 clients: {len(results)} requests in {wall:.1f} s "
              f"({len(results) / wall:.2f} images/s), scale-up decision {t_decision - t_burst:.1f} s in (the "
              f"new replica's start included), its first weighted request {t_first - t_decision:.1f} s after "
              f"the decision ({served_by_new} requests began after it); back to 1 replica "
              f"{t_removed - t_burst:.1f} s after the burst began, with a trickle of {len(slow)} requests; statuses "
              f"{dict(codes)}, largest gap {worst}; peak device memory "
              + ", ".join(f"{rid} {gib(v)}" for rid, v in peaks.items()) + f"; {kind}, {smi}")
        # A breach that outlasts the scale-up at max_replicas is a capped
        # decision, which changes nothing.
        require([d["decision"] for _, d in decisions if d["decision"] != "scale_up_capped"]
                == ["scale_up", "scale_down"],
                f"decisions {[d for _, d in decisions]}, failed launches {failed_launches}")
        require(set(codes) == {200} and worst == 0 and final["failed"] == 0 and not final["shed"],
                f"statuses {dict(codes)}, gap {worst}, fleet_stats {final}")
    finally:
        fleet.kill()


# Phase 15: the backbones the port added to the ResNets, and one a family
# for training (the DenseNet also through the converter).
NEW_BACKBONES = ("mobilenet", "mobilenet050", "vgg16", "vgg19", "densenet121", "densenet169",
                 "densenet201")
FAMILY_TRAINED = ("mobilenet", "vgg16", "densenet121")
FAMILY_HW = (256, 256)
FAMILY_SIDES = (800, 1333)  # the resize rule of the DenseNet's export: bucket (800, 1344)
FAMILY_BATCH = 8
FAMILY_STEPS = 3
FAMILY_TIMED = 7  # steps after the loop's, each timed alone by CUDA events
# A full-width f32 forward of the card (TF32 off) against the CPU's, of
# the output's range: the two sum the convolutions in other orders.  The
# seven backbones' gaps read at most 6.446e-06 (NVIDIA H100 80GB HBM3,
# 700 W); TF32 convolutions would exceed this.
FAMILY_FWD_RTOL = 1e-4


def torchvision_resnet_layout(stage_sizes=(3, 4, 6, 3), classes: int = 1000) -> dict[str, tuple]:
    """The names and shapes of a torchvision bottleneck ResNet's state dict
    (``resnet50`` by default), ``fc.*`` and ``num_batches_tracked`` among
    them: what ``--pretrained-backbone`` reads.  Phase 15 (d) and the
    import tests fill it with seeded random values."""
    layout: dict[str, tuple] = {"conv1.weight": (64, 3, 7, 7)}

    def bn(prefix: str, n: int) -> None:
        layout.update({f"{prefix}.{k}": (n,) for k in ("weight", "bias", "running_mean", "running_var")})
        layout[f"{prefix}.num_batches_tracked"] = ()

    bn("bn1", 64)
    inplanes = 64
    for i, blocks in enumerate(stage_sizes, 1):
        planes = 64 * 2 ** (i - 1)
        for b in range(blocks):
            p = f"layer{i}.{b}"
            layout[f"{p}.conv1.weight"] = (planes, inplanes, 1, 1)
            bn(f"{p}.bn1", planes)
            layout[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            layout[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
            bn(f"{p}.bn3", planes * 4)
            if b == 0:
                layout[f"{p}.downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    layout.update({"fc.weight": (classes, inplanes), "fc.bias": (classes,)})
    return layout


def model_family_phase(root: str, batches, device, kind: str, smi: str) -> dict[str, int]:
    """Phase 15: (a) each new backbone at full width, one f32 forward on the
    card against the CPU; (b) one a family trains 3 steps through
    ``train/loop.py`` at (800, 1344), global batch 8, GN, bf16; (c) the
    DenseNet through ``convert_model`` and ``DetectEngine.from_export``; (d)
    ``train coco --pretrained-backbone --norm frozen_bn``.  Returns the
    kernels' launches."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)

    def add(used: dict) -> None:
        for k in launches:
            launches[k] += used[k]

    # (a) Every new name builds on the card; the card's f32 forward equals
    # the CPU's within FAMILY_FWD_RTOL of the range.
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    images = torch.from_numpy(np.random.default_rng(15).integers(0, 256, (1, *FAMILY_HW, 3), dtype=np.uint8))
    for name in NEW_BACKBONES:
        config = RetinaNetConfig(backbone=name, dtype=torch.float32)  # FPN 256, heads 256 x 4, 80 classes
        cpu_model = build_retinanet(config, device="cpu", seed=3)
        gpu_model = build_retinanet(config, device=device, seed=3)
        with torch.inference_mode():
            want = cpu_model(normalize_images(images))
            got = gpu_model(normalize_images(images.to(device)))
        errs = []
        for key in ("cls_logits", "box_deltas"):
            a, b = got[key].cpu(), want[key]
            errs.append(float((a - b).abs().max()) / float(b.abs().max()))
            require(bool(torch.isfinite(a).all()) and errs[-1] <= FAMILY_FWD_RTOL,
                    f"{name}: the card's {key} differ from the CPU's by {errs[-1]:.3e} of the range")
        print(f"{name}: widths C3-C5 {gpu_model.backbone.widths}, "
              f"{sum(p.numel() for p in gpu_model.parameters())} parameters; f32 forward at {FAMILY_HW}, "
              f"card against CPU: cls {errs[0]:.3e}, box {errs[1]:.3e} of the range (limit {FAMILY_FWD_RTOL})")
        del cpu_model, gpu_model, want, got
    torch.cuda.empty_cache()

    # (b) Three steps of train/loop.py for one backbone a family, then
    # FAMILY_TIMED more through the same step, each between two CUDA events
    # after a sync: the device's span of a step, and the host's time to
    # issue it (a span no longer than the issue time is the host's).
    cut = [cut_batch(b, FAMILY_BATCH) for b in batches[:FAMILY_STEPS]]
    print(f"host: load average {os.getloadavg()}, {threading.active_count()} threads in this process, "
          f"{os.cpu_count()} cores")
    snapshot = os.path.join(root, "densenet_snap")
    for name in FAMILY_TRAINED:
        model = build_retinanet(RetinaNetConfig(backbone=name), device=device, seed=0)  # gn, bf16
        state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(), device)
        logged: list[dict] = []
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loop_lib.run_training(
            state, iter(cut), 80, loop_lib.LoopConfig(total_steps=FAMILY_STEPS, log_every=1),
            log=lambda step, scalars: logged.append(scalars),
        )
        wall = time.perf_counter() - t0
        used = counts()
        add(used)
        peak = torch.cuda.max_memory_allocated() / 2**30
        require(used["plain"] == 0 and all(used[k] == FAMILY_STEPS for k in ("matching", "focal_fwd", "focal_bwd")),
                f"{name}: launches {used} in {FAMILY_STEPS} steps")
        require(all(np.isfinite([sc["loss"], sc["grad_norm"]]).all() for sc in logged), f"{name}: a non-finite loss")
        loop_ms = float(np.median([sc["step_time_ms"] for sc in logged[1:]]))
        step_fn = step_lib.make_train_step(model, TRAIN_HW, 80, device=device)
        spans, issues = [], []
        for i in range(FAMILY_TIMED):
            arrays = loop_lib.device_batch(cut[i % len(cut)], device)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            step_fn(state, arrays)
            stop.record()
            issues.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            spans.append(start.elapsed_time(stop))
        step_ms, issue_ms = float(np.median(spans)), float(np.median(issues))
        print(f"{name}: {FAMILY_STEPS} steps at {TRAIN_HW}, global batch {FAMILY_BATCH}, GN, bf16 in {wall:.1f} s; "
              f"losses {[round(sc['loss'], 4) for sc in logged]}; loop step {loop_ms:.1f} ms (median of steps "
              f"2-{FAMILY_STEPS}, host clock); then {FAMILY_TIMED} steps: span {step_ms:.1f} ms (median; "
              f"{min(spans):.1f}-{max(spans):.1f}, CUDA events), issued by the host in {issue_ms:.1f} ms (median), "
              f"{FAMILY_BATCH * 1e3 / step_ms:.2f} images/s; peak memory {peak:.2f} GiB; launches {used}; "
              f"{kind}, {smi}")
        if name == "densenet121":
            manager = CheckpointManager(snapshot)
            require(manager.save(state), "the DenseNet snapshot was not saved")
            manager.close()
        del state, model
        torch.cuda.empty_cache()

    # (c) The DenseNet's snapshot through the converter at one bucket and
    # batch 1; loaded without model code (a fresh process) and in this one.
    export_dir = os.path.join(root, "densenet_export")
    bucket = default_buckets(*FAMILY_SIDES)[0]
    t0 = time.perf_counter()
    convert_cli.main(["--snapshot-path", snapshot, "--output", export_dir, "--num-classes", "80",
                      "--backbone", "densenet121", "--buckets", f"{bucket[0]}x{bucket[1]}",
                      "--image-min-side", str(FAMILY_SIDES[0]), "--image-max-side", str(FAMILY_SIDES[1]),
                      "--batch-sizes", "1", "--score-threshold", "0.001", "--device", device.type])
    convert_s = time.perf_counter() - t0
    manifest = json.loads(Path(export_dir, "manifest.json").read_text())
    (artifact,) = manifest["artifacts"]
    proc = subprocess.run(
        [sys.executable, "-c", LOAD_ALONE, os.path.join(export_dir, artifact["file"]),
         json.dumps([1, *bucket, 3]), device.type],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600,
    )
    require(proc.returncode == 0, f"loading the DenseNet program alone failed:\n{proc.stderr[-3000:]}")
    alone = json.loads(proc.stdout.strip().splitlines()[-1])
    require(alone["models"] == [] and alone["modules"] == [] and alone["launches"] >= 1
            and alone["plain"] == 0, f"the DenseNet program alone: {alone}")
    model = RetinaNet(RetinaNetConfig(backbone="densenet121"))
    saved = CheckpointManager(snapshot).restore_arrays()
    load_flax_variables(model, saved["params"], saved["batch_stats"])
    dconfig = detect_lib.DetectConfig(score_threshold=0.001)
    live = DetectEngine.from_state(model, (bucket,), (1,), dconfig, device, *FAMILY_SIDES)
    engine = DetectEngine.from_export(export_dir, device)
    name, data = served_files()[0]
    image = image_io.decode(data)
    reset_all_counts()
    answer = live_answer(engine, image, 1)
    used = counts()
    add(used)
    gap = answer_gap(answer, live_answer(live, image, 1))
    print(f"convert_model: DenseNet-121 at {bucket}, batch 1 in {convert_s:.1f} s, "
          f"{os.path.getsize(os.path.join(export_dir, artifact['file']))} bytes; alone in a fresh process: "
          f"load {alone['load_s']:.2f} s, first run {alone['first_run_s']:.2f} s, NMS launches "
          f"{alone['launches']}, models imported {alone['models']}; from_export answered {name} with "
          f"{len(answer)} detections, largest gap to the live engine {gap}; launches {used}; {kind}, {smi}")
    require(used["nms"] >= 1 and used["plain"] == 0, f"the DenseNet export's launches {used}")
    require(gap == 0 and len(answer) > 0, f"the DenseNet export's answer differs from the live engine's: {gap}")
    del model, live, engine
    torch.cuda.empty_cache()

    # (d) The reference's recipe: a torchvision-layout ResNet-50 (random,
    # seeded) imported by --pretrained-backbone under --norm frozen_bn; the
    # imported tensors equal the file's on the card before the first step.
    from batchai_retinanet_horovod_coco_tpu_torch.models import import_weights

    rng = np.random.default_rng(16)
    weights = {}
    for k, shape in torchvision_resnet_layout().items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            weights[k] = torch.tensor(int(rng.integers(1, 1000)))
            continue
        if len(shape) == 4:  # variance 1 / fan-in, so the frozen network's activations stay small
            value = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
        elif leaf in ("weight", "running_var") and not k.startswith("fc."):
            value = rng.uniform(0.5, 1.5, shape)
        else:
            value = rng.normal(0.0, 0.05, shape)
        weights[k] = torch.from_numpy(value.astype(np.float32))
    pth = os.path.join(root, "resnet50_torchvision.pth")
    torch.save(weights, pth)
    expected = import_weights.convert_torch_resnet50(weights)
    checked: list[int] = []
    real_create = state_lib.create_train_state

    def create_and_check(model, *args, **kwargs):
        card = {k: v for k, v in model.state_dict().items()}
        checked.append(sum(torch.equal(card[f"backbone.{k}"], v.to(device)) for k, v in expected.items()))
        return real_create(model, *args, **kwargs)

    train_json, val_json = fixture_coco(root, 32, 15), fixture_coco(root, 4, 16)
    flags = ["coco", root, "--train-annotations", os.path.basename(train_json), "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", os.path.basename(val_json), "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", os.path.join(root, "pretrained_snap"),
             "--pretrained-backbone", pth, "--norm", "frozen_bn", "--steps", "2", "--log-every", "1"]
    state_lib.create_train_state = create_and_check
    reset_all_counts()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(flags)
    finally:
        state_lib.create_train_state = real_create
    used = counts()
    add(used)
    stats = CheckpointManager(os.path.join(root, "pretrained_snap")).restore_arrays()["batch_stats"]
    frozen = np.array_equal(stats["backbone"]["stage5_block2"]["norm3"]["var"],
                            weights["layer4.2.bn3.running_var"].numpy())
    print(f"train coco --pretrained-backbone (torchvision ResNet-50 layout, {len(weights)} tensors, "
          f"{len(expected)} imported) --norm frozen_bn: 2 steps in {time.perf_counter() - t0:.1f} s; "
          f"imported tensors equal to the file's on the card before the first step: {checked} of "
          f"{len(expected)}; frozen statistics unchanged after the steps: {frozen}; launches {used}")
    require(out["final_step"] == 2.0, f"final step {out['final_step']}")
    require(checked == [len(expected)], f"imported tensors equal on the card: {checked} of {len(expected)}")
    require(frozen, "the frozen BatchNorm statistics moved or were not imported")
    require(used["plain"] == 0 and all(used[k] == 2 for k in ("matching", "focal_fwd", "focal_bwd")),
            f"--pretrained-backbone launches {used}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 15 in {phase_s:.1f} s (limit 240 s); launches {launches}")
    require(phase_s <= 240, f"phase 15 took {phase_s:.1f} s")
    return launches


DP_RANKS = 2  # phase 16 (a): gloo ranks on the one card
DP_PER_RANK = 2  # images a rank: a global batch of 4
DP_STEPS = 3
DP_OPT = dict(base_lr=0.01, global_batch_size=256, warmup_steps=0, schedule="constant",
              weight_decay=0.0, clip_global_norm=1e9)  # the golden run's sgd: every step moves
DP_DEADLINE_S = 240
DP_MOVED_RTOL = 3e-2  # of how far the step moved a tensor: tests/test_torch_train.py's rule


def dp_rank(job_path: str, rank: int) -> None:
    """Phase 16 (a), one rank: join the world over gloo, load the shared
    initial weights, take DP_STEPS steps of this rank's rows of the global
    batch (numerics on, for ``replica_agreement``) and write the results:
    each step's metrics and ms, the kernels' launches, the parameters'
    digest and, on rank 0, the largest gap of the first step's parameters
    to the one-process step's."""
    from batchai_retinanet_horovod_coco_tpu_torch.launch import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.obs.numerics import NumericsConfig

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False  # f32 in full f32, as phases 5 and 9
    torch.backends.cuda.matmul.allow_tf32 = False
    world = initialize_distributed(DistributedConfig(
        coordinator_address=f"file://{job['store']}", num_processes=job["ranks"], process_id=rank,
        local_rank=0, backend="gloo", device=job["device"], timeout_s=job["timeout_s"],
    ))
    try:
        device = world.device
        model = build_retinanet(RetinaNetConfig(**job["model"], dtype=torch.float32), device=device,
                                seed=0)
        model.load_state_dict(torch.load(job["initial"]))
        initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
        state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(**DP_OPT), device)
        hw = tuple(job["hw"])
        step = step_lib.make_train_step(model, hw, 80, device=device,
                                        numerics=NumericsConfig(enabled=True), world=world)
        batch = dict(np.load(job["batch"]))
        n = batch["images"].shape[0] // world.size
        mine = pipeline_lib.Batch(**{k: v[rank * n:(rank + 1) * n] for k, v in batch.items()})
        arrays = loop_lib.device_batch(mine, device)
        reset_all_counts()
        history, gap = [], None
        for i in range(DP_STEPS):
            _sync(device)
            t0 = time.perf_counter()
            metrics = step(state, arrays)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            history.append({"ms": ms, **{k: float(v) for k, v in metrics.items()}})
            if i == 0 and rank == 0:
                reference = torch.load(job["reference"])
                gaps = []
                for key, got in model.state_dict().items():
                    want = reference[key].to(device)
                    moved = float(torch.linalg.vector_norm(want - initial[key]))
                    err = float(torch.linalg.vector_norm(got - want))
                    gaps.append((err / moved if moved > 0 else err, key))
                gap = max(gaps)
        used = counts()
        digest = hashlib.sha256()
        for key, value in sorted(model.state_dict().items()):
            digest.update(value.detach().cpu().contiguous().numpy().tobytes())
        with open(os.path.join(os.path.dirname(job_path), f"rank{rank}.json"), "w") as f:
            json.dump({"history": history, "launches": used, "digest": digest.hexdigest(),
                       "gap": gap}, f)
    finally:
        shutdown_distributed(world)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_ranks(job_path: str, ranks: int, root: str, target: str = "dp_rank",
               deadline_s: float = DP_DEADLINE_S) -> list[dict]:
    """``ranks`` processes of ``target`` (``dp_rank`` or ``comm_rank``),
    each in a session of its own, against one deadline; past it, or on a
    failed rank, all are killed and the phase fails with their output
    tails."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (here, os.environ.get("PYTHONPATH")) if p))
    logs = [os.path.join(root, f"dp_rank{r}.log") for r in range(ranks)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.{target}({job_path!r}, {r})"],
                cwd=here, env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True))
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * ranks:
        tails = "\n".join(f"--- rank {r} ---\n{Path(log).read_text(errors='replace')[-3000:]}"
                          for r, log in enumerate(logs))
        print(tails)
        require(False, f"the {target} ranks exited with {codes}")
    results = []
    for r in range(ranks):
        with open(os.path.join(os.path.dirname(job_path), f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def data_parallel_phase(root: str, batches, device, kind: str, smi: str,
                        hw=TRAIN_HW, model: dict | None = None) -> dict[str, int]:
    """Phase 16: (a) a world of two ranks over gloo on the one card against
    one process on the same global batch; (b) ``train coco`` joined to a
    world of 1 over NCCL, checkpointing and evaluating through the gather.
    Returns the kernels' launches."""
    import inspect

    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    t_phase = time.perf_counter()
    model = model or {}
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)
    buffer_flag = ("forward_sync_buffers"
                   if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                   else "broadcast_buffers")
    print(f"torch {torch.__version__}: NCCL available {dist.is_nccl_available()}, gloo available "
          f"{dist.is_gloo_available()}; DDP takes {buffer_flag}=False")

    # (a) The one-process reference step on the global batch, then the world.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = os.path.join(root, "dp")
    os.makedirs(work, exist_ok=True)
    global_batch = cut_batch(batches[0], DP_RANKS * DP_PER_RANK)
    np.savez(os.path.join(work, "batch.npz"), **global_batch._asdict())
    single = build_retinanet(RetinaNetConfig(**model, dtype=torch.float32), device=device, seed=0)
    torch.save(single.state_dict(), os.path.join(work, "initial.pt"))
    state = state_lib.create_train_state(single, optim_lib.OptimizerConfig(**DP_OPT), device)
    step = step_lib.make_train_step(single, hw, 80, device=device)
    arrays = loop_lib.device_batch(global_batch, device)
    step(state, arrays)  # the first call builds what a step needs
    single.load_state_dict(torch.load(os.path.join(work, "initial.pt")))
    state = state_lib.create_train_state(single, optim_lib.OptimizerConfig(**DP_OPT), device)
    step = step_lib.make_train_step(single, hw, 80, device=device)
    _sync(device)
    t0 = time.perf_counter()
    want = {k: float(v) for k, v in step(state, arrays).items()}
    _sync(device)
    single_ms = (time.perf_counter() - t0) * 1e3
    torch.save(single.state_dict(), os.path.join(work, "reference.pt"))
    del single, state, step, arrays
    if device.type == "cuda":
        torch.cuda.empty_cache()
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"store": os.path.join(work, "store"), "ranks": DP_RANKS, "device": device.type,
                   "timeout_s": DP_DEADLINE_S, "model": model, "hw": list(hw),
                   "initial": os.path.join(work, "initial.pt"),
                   "reference": os.path.join(work, "reference.pt"),
                   "batch": os.path.join(work, "batch.npz")}, f)
    t0 = time.perf_counter()
    ranks = _run_ranks(job, DP_RANKS, work)
    world_s = time.perf_counter() - t0
    first = ranks[0]["history"][0]
    rel = abs(first["loss"] - want["loss"]) / abs(want["loss"])
    gap, gap_key = ranks[0]["gap"]
    for r, res in enumerate(ranks):
        print(f"rank {r}: step ms {[round(h['ms'], 1) for h in res['history']]}, replica_agreement "
              f"{[round(h['replica_agreement'], 6) for h in res['history']]}, losses "
              f"{[round(h['loss'], 6) for h in res['history']]}, num_pos "
              f"{[h['num_pos'] for h in res['history']]}, launches {res['launches']}, digest "
              f"{res['digest'][:16]}")
    print(f"a world of {DP_RANKS} over gloo on one card, {DP_PER_RANK} images a rank at {hw} in f32 "
          f"(TF32 off), {world_s:.1f} s with start-up; one process on the global batch: step "
          f"{single_ms:.1f} ms, loss {want['loss']:.6f} against the world's {first['loss']:.6f} "
          f"(rel {rel:.3e}, limit 1e-04), num_pos {want['num_pos']:.0f} against "
          f"{first['num_pos']:.0f}; largest parameter gap after one step {gap:.3e} of how far the "
          f"step moved it ({gap_key}; limit {DP_MOVED_RTOL}); {kind}, {smi}")
    require(rel <= 1e-4 and first["num_pos"] == want["num_pos"],
            "the world's first step differs from one process's")
    require(gap <= DP_MOVED_RTOL, f"the world's parameters differ from one process's: {gap_key}")
    require(len({r["digest"] for r in ranks}) == 1, "the ranks' parameters differ")
    for res in ranks:
        used = res["launches"]
        require(used["plain"] == 0 and all(used[k] >= DP_STEPS for k in ("matching", "focal_fwd", "focal_bwd")),
                f"a rank's launches {used}")
        require(all(0 < h["replica_agreement"] <= 1 for h in res["history"]), "replica_agreement")
        for k in launches:
            launches[k] += used[k]

    # (b) train coco, joined explicitly to a world of 1 over NCCL.
    gathers = []
    real_gather = detect_lib.allgather_process_detections

    def gather(results, world):
        gathers.append(world)
        return real_gather(results, world)

    train_json, val_json = fixture_coco(root, 16, 31), fixture_coco(root, 8, 32)
    snap = os.path.join(root, "dp_snap")
    flags = ["coco", root, "--train-annotations", os.path.basename(train_json), "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", os.path.basename(val_json), "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", snap, "--steps", "3", "--checkpoint-every", "3",
             "--log-every", "1", "--coordinator-address", f"127.0.0.1:{free_port()}",
             "--num-processes", "1", "--process-id", "0", "--score-threshold", "0.001"]
    detect_lib.allgather_process_detections = gather
    reset_all_counts()
    t0 = time.perf_counter()
    try:
        out = train_cli.main(flags)
    finally:
        detect_lib.allgather_process_detections = real_gather
    cli_s = time.perf_counter() - t0
    used = counts()
    manifest = read_manifest(snap)
    print(f"train coco in a world of 1 over NCCL: 3 steps, a checkpoint and the final eval in "
          f"{cli_s:.1f} s; ckpt step {manifest and manifest['step']}, shard_count "
          f"{manifest and manifest['metadata'].get('shard_count')}; gathers through a world "
          f"{sum(w is not None for w in gathers)}; AP50 {out.get('eval/AP50')}; launches {used}; "
          f"process group left {dist.is_initialized()}")
    require(out["final_step"] == 3.0 and manifest is not None and manifest["step"] == 3
            and manifest["metadata"]["shard_count"] == 1, "the NCCL run did not checkpoint step 3")
    require(any(w is not None for w in gathers) and "eval/AP" in out,
            "the NCCL run's eval did not go through the gather")
    require(not dist.is_initialized(), "the CLI left its process group")
    require(used["plain"] == 0 and all(used[k] == 3 for k in ("matching", "focal_fwd", "focal_bwd"))
            and used["nms"] >= 1, f"the NCCL run's launches {used}")
    for k in launches:
        launches[k] += used[k]
    phase_s = time.perf_counter() - t_phase
    print(f"phase 16 in {phase_s:.1f} s (limit {DP_DEADLINE_S} s); launches {launches}")
    require(phase_s <= DP_DEADLINE_S, f"phase 16 took {phase_s:.1f} s")
    return launches


# ---- phase 17: gradient communication on one card ---------------------------

COMM_STEPS = 3
COMM_DEADLINE_S = 240
# (a), in this order: the exact world first, the others measured against it.
# (name, CommConfig fields or None, ZeRO, EF identity checked after it)
COMM_FLAVORS = (
    ("exact", None, False, False),
    ("int8", dict(compress="int8"), False, True),
    ("int8 overlap", dict(compress="int8", overlap=True), False, False),
    ("zero", None, True, False),
    ("zero int8", dict(compress="int8"), True, False),
)
HIER_RANKS = 4  # (b): 2 slices x 2 gloo ranks, one image a rank, 2 steps
HIER_STEPS = 2
# (b)'s images: four full-width models time-slice the one card, so smaller
# than TRAIN_HW to keep the phase near 90 s.
HIER_HW = (512, 512)
HIER_FLAVORS = (
    ("flat int8", dict(compress="int8"), None),
    ("2x2, int8 across slices", dict(dcn_mode="int8"), 2),
)
EF_RTOL = 1e-6  # of the largest summed exact mean: f32 rounding of 3 steps


def small_batch(batch_size: int, seed: int, hw: tuple[int, int]) -> pipeline_lib.Batch:
    """A seeded synthetic batch at ``hw``: uint8 images of that size, 1-40
    boxes an image."""
    rng = np.random.default_rng(2000 + seed)
    boxes, labels, mask = gt_scene(batch_size, 40, seed, hw=hw)
    examples = [(rng.integers(0, 256, (*hw, 3), dtype=np.uint8), boxes[b, :int(mask[b].sum())],
                 labels[b, :int(mask[b].sum())], 1.0) for b in range(batch_size)]
    return pipeline_lib.assemble(examples, list(range(batch_size)), hw, max_gt=MAX_GT)


def _telescope(world, model, config, device, steps: int = 3) -> float:
    """Error feedback on the card over ``steps`` reduces of seeded random
    gradients shaped as ``model``'s leaves (its full-width plan): the
    largest |sum of applied means + final residual - sum of exact means|
    over the largest |sum of exact means| (f32 rounding: about 1e-7)."""
    from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as compress_lib
    from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_params, to_flax
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import DataAxis
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.zero import Sharding

    leaves = {path: to_flax(p.detach()) for _, path, p in flax_params(model)}
    plan = compress_lib.plan_buckets(leaves, config)
    sharding, axis = Sharding.of(world), DataAxis(world)
    res = {k: sharding.local(torch.from_numpy(v)).to(device)
           for k, v in compress_lib.init_comm_state(leaves, config, world.size).items()}
    gen = torch.Generator(device=device).manual_seed(17 + world.rank)
    applied = {p: torch.zeros(t.shape, dtype=torch.float64, device=device) for p, t in leaves.items()}
    exact = {p: torch.zeros(t.shape, dtype=torch.float64, device=device) for p, t in leaves.items()}
    for _ in range(steps):
        grads = {p: torch.randn(t.shape, generator=gen, device=device) * 1e-3
                 for p, t in leaves.items()}
        out, res, _ = compress_lib.reduce_tree(grads, res, plan, config, axis)
        mean = axis.pmean(torch.cat([g.reshape(-1) for g in grads.values()]))
        for (p, g), m in zip(grads.items(), mean.split([g.numel() for g in grads.values()])):
            applied[p] += out[p].double()
            exact[p] += m.view_as(g).double()
    worst, scale = 0.0, 0.0
    for bucket in plan.buckets:
        a = torch.cat([applied[leaf.path].reshape(-1) for leaf in bucket.leaves])
        e = torch.cat([exact[leaf.path].reshape(-1) for leaf in bucket.leaves])
        if bucket.mode != "exact":
            a = a + sharding.gather(res[bucket.key]).to(device).double()[: bucket.size]
        worst = max(worst, float((a - e).abs().max()))
        scale = max(scale, float(e.abs().max()))
    return worst / scale


def _comm_flavor(spec: dict, world, job: dict, batch: dict, initial: dict,
                 reference) -> tuple[dict, dict]:
    """One flavor in this rank: ``spec["steps"]`` steps from ``initial``;
    its numbers, and its final parameters (for the flavors after it)."""
    from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as compress_lib
    from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig
    from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_params, to_flax
    from batchai_retinanet_horovod_coco_tpu_torch.obs.numerics import NumericsConfig
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import CommTopology

    device = world.device
    comm = CommConfig(**spec["comm"]) if spec["comm"] else None
    topology = CommTopology(spec["slices"], world.size // spec["slices"]) if spec["slices"] else None
    model = build_retinanet(RetinaNetConfig(**job["model"], dtype=torch.float32), device=device,
                            seed=0)
    model.load_state_dict(initial)
    state = state_lib.create_train_state(model, optim_lib.OptimizerConfig(**DP_OPT), device,
                                         world=world, comm=comm, shard_weight_update=spec["zero"],
                                         topology=topology)
    hw = tuple(job["hw"])
    step = step_lib.make_train_step(model, hw, 80, device=device,
                                    numerics=NumericsConfig(enabled=True), world=world, comm=comm,
                                    shard_weight_update=spec["zero"], topology=topology)
    hier = topology if comm is not None and comm.hierarchical_with(topology) else None
    pos = hier.position(world.rank) if hier is not None else world.rank
    n = batch["images"].shape[0] // world.size
    arrays = loop_lib.device_batch(
        pipeline_lib.Batch(**{k: v[pos * n:(pos + 1) * n] for k, v in batch.items()}), device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_all_counts()
    history = []
    for _ in range(spec["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        metrics = step(state, arrays)
        _sync(device)
        history.append({"ms": (time.perf_counter() - t0) * 1e3,
                        **{k: float(v) for k, v in metrics.items()}})
    used = counts()
    slots = [t for st in state.optimizer.inner.state.values() for t in st.values()
             if torch.is_tensor(t) and t.dim()]
    out = {"name": spec["name"], "position": pos, "history": history, "launches": used,
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else 0.0),
           "opt_bytes": sum(t.numel() * t.element_size() for t in slots)}
    if comm is not None:
        leaves = {path: to_flax(p.detach()) for _, path, p in flax_params(model)}
        plan = compress_lib.plan_buckets(leaves, comm, hier)
        out["exact_bytes"] = plan.exact_bytes(world.size)
        if hier is not None:  # the exact tree routed through the two hops
            out["hop_bytes_exact"] = plan.hop_bytes_exact(hier)
            out["exact_bytes"] = sum(out["hop_bytes_exact"].values())
    digest = hashlib.sha256()
    for key, value in sorted(model.state_dict().items()):
        digest.update(value.detach().cpu().contiguous().numpy().tobytes())
    out["digest"] = digest.hexdigest()
    final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    if reference is not None:
        # Per tensor, and over all of them: a conv bias that feeds a
        # GroupNorm gets only rounding noise as its gradient, so its own
        # share measures the noise.
        gaps, err_sq, moved_sq = [], 0.0, 0.0
        for key, want in reference.items():
            moved = float(torch.linalg.vector_norm(want - initial[key]))
            err = float(torch.linalg.vector_norm(final[key] - want))
            gaps.append((err / max(moved + 1e-6 * float(torch.linalg.vector_norm(want)), 1e-30), key))
            err_sq, moved_sq = err_sq + err**2, moved_sq + moved**2
        out["gap"] = (*max(gaps), (err_sq / max(moved_sq, 1e-60)) ** 0.5)
    if spec["telescope"]:
        out["ef_identity"] = _telescope(world, model, comm, device)
    del model, state, step
    world.replica_slot.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, final


def comm_rank(job_path: str, rank: int) -> None:
    """Phase 17, one rank: join the world over gloo and run the job's
    flavors in order, each from the shared initial weights on this rank's
    rows of the global batch (by mesh position); the first flavor's final
    parameters are the others' reference."""
    from batchai_retinanet_horovod_coco_tpu_torch.launch import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Deterministic kernels (cuDNN's convolutions, the FPN upsample's
    # index_add backward), so that two flavors that compute the same values
    # give the same bits: the overlap against the fused reduce.  cuBLAS reads
    # its workspace setting when it starts, after this.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    world = initialize_distributed(DistributedConfig(
        coordinator_address=f"file://{job['store']}", num_processes=job["ranks"], process_id=rank,
        local_rank=0, backend="gloo", device=job["device"], timeout_s=job["timeout_s"],
    ))
    try:
        batch = dict(np.load(job["batch"]))
        initial = {k: v.to(world.device) for k, v in torch.load(job["initial"]).items()}
        results, reference = [], None
        for spec in job["flavors"]:
            result, final = _comm_flavor(spec, world, job, batch, initial, reference)
            results.append(result)
            if reference is None:
                reference = final
        with open(os.path.join(os.path.dirname(job_path), f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        shutdown_distributed(world)


def _comm_world(work: str, device, model: dict, batch, flavors: list[dict], ranks: int,
                hw) -> list[list[dict]]:
    """Run ``flavors`` in a world of ``ranks`` gloo ranks on the card;
    returns each flavor's results, by rank."""
    os.makedirs(work, exist_ok=True)
    np.savez(os.path.join(work, "batch.npz"), **batch._asdict())
    initial = build_retinanet(RetinaNetConfig(**model, dtype=torch.float32), device=device, seed=0)
    torch.save(initial.state_dict(), os.path.join(work, "initial.pt"))
    del initial
    job = os.path.join(work, "job.json")
    with open(job, "w") as f:
        json.dump({"store": os.path.join(work, "store"), "ranks": ranks, "device": device.type,
                   "timeout_s": COMM_DEADLINE_S, "model": model, "hw": list(hw),
                   "initial": os.path.join(work, "initial.pt"),
                   "batch": os.path.join(work, "batch.npz"), "flavors": flavors}, f)
    by_rank = _run_ranks(job, ranks, work, target="comm_rank", deadline_s=COMM_DEADLINE_S)
    return [[by_rank[r][i] for r in range(ranks)] for i in range(len(flavors))]


def _print_flavor(ranks: list[dict], kind: str, smi: str) -> None:
    first = ranks[0]
    last = first["history"][-1]
    line = (f"{first['name']}: step ms by rank {[[round(h['ms'], 1) for h in r['history']] for r in ranks]}; "
            f"loss {last['loss']:.6f}")
    if "comm_compressed_bytes" in last:
        line += (f"; ef_residual_norm {[round(h['ef_residual_norm'], 9) for h in first['history']]}, "
                 f"ef_saturation {[round(h['ef_saturation'], 6) for h in first['history']]}, "
                 f"comm_compressed_bytes {last['comm_compressed_bytes']:.0f} against exact_bytes "
                 f"{first['exact_bytes']} ({last['comm_compressed_bytes'] / first['exact_bytes']:.4f})")
    for key in ("comm_ici_bytes", "comm_dcn_bytes", "ef_residual_norm_dcn"):
        if key in last:
            line += f"; {key} {last[key]}"
    if "hop_bytes_exact" in first:
        line += f"; exact tree by hop {first['hop_bytes_exact']}"
    if "gap" in first:
        line += (f"; gap to the first world {first['gap'][2]:.3e} of the move over all parameters, "
                 f"{first['gap'][0]:.3e} at most a tensor ({first['gap'][1]})")
    if "ef_identity" in first:
        line += f"; EF identity {[r['ef_identity'] for r in ranks]} of the largest sum (limit {EF_RTOL})"
    line += (f"; peak GiB {[round(r['peak_gib'], 2) for r in ranks]}, optimizer-state bytes "
             f"{[r['opt_bytes'] for r in ranks]}; launches {[r['launches'] for r in ranks]}; "
             f"digests {[r['digest'][:16] for r in ranks]}; {kind}, {smi}")
    print(line, flush=True)


def comm_phase(root: str, batches, device, kind: str, smi: str, hw=TRAIN_HW, hier_hw=HIER_HW,
               model: dict | None = None) -> dict[str, int]:
    """Phase 17: (a) a world of 2 gloo ranks on the one card through the
    flavors of COMM_FLAVORS; (b) a world of 4 as 2 slices x 2; (c) ``train
    coco --shard-weight-update --comm-compress int8`` in a world of 1 over
    NCCL, its checkpoint restored through the package.  Returns the
    kernels' launches.  ``hw``, ``hier_hw`` and ``model`` shrink (a) and (b)
    for a rehearsal on the CPU."""
    import torch.distributed as dist

    from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig
    from batchai_retinanet_horovod_coco_tpu_torch.launch import (
        DistributedConfig,
        initialize_distributed,
        shutdown_distributed,
    )

    t_phase = time.perf_counter()
    model = model or {}
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def check_world(flavors: list[list[dict]], steps: int) -> None:
        for ranks in flavors:
            name = ranks[0]["name"]
            require(len({r["digest"] for r in ranks}) == 1, f"{name}: the ranks' parameters differ")
            for r in ranks:
                used = r["launches"]
                require(used["plain"] == 0 and all(used[k] >= steps
                                                   for k in ("matching", "focal_fwd", "focal_bwd")),
                        f"{name}: a rank's launches {used}")
                require(all(np.isfinite(h["loss"]) and np.isfinite(h["param_norm"])
                            for h in r["history"]), f"{name}: non-finite metrics")
                for k in launches:
                    launches[k] += used[k]

    # (a) Five flavors in one world of 2.
    specs = [dict(name=n, comm=c, zero=z, slices=None, telescope=t, steps=COMM_STEPS)
             for n, c, z, t in COMM_FLAVORS]
    t0 = time.perf_counter()
    flavors = _comm_world(os.path.join(root, "comm2"), device, model,
                          cut_batch(batches[0], DP_RANKS * DP_PER_RANK), specs, DP_RANKS, hw)
    print(f"(a) a world of {DP_RANKS} over gloo on one card, {DP_PER_RANK} images a rank at {hw} "
          f"in f32 (TF32 off), {COMM_STEPS} steps a flavor: {time.perf_counter() - t0:.1f} s with "
          "start-up")
    for ranks in flavors:
        _print_flavor(ranks, kind, smi)
    check_world(flavors, COMM_STEPS)
    by_name = {ranks[0]["name"]: ranks for ranks in flavors}
    require([r["digest"] for r in by_name["int8 overlap"]] == [r["digest"] for r in by_name["int8"]],
            "overlap's parameters differ from the fused int8 run's")
    # Two ranks: the reduce-scatter's and the all-reduce's sums are exact.
    require([r["digest"] for r in by_name["zero"]] == [r["digest"] for r in by_name["exact"]],
            "ZeRO's parameters differ from the exact world's")
    require(all(r["ef_identity"] <= EF_RTOL for r in by_name["int8"]),
            "the EF identity does not hold on the card")
    share = by_name["zero"][0]["opt_bytes"] / by_name["exact"][0]["opt_bytes"]
    print(f"ZeRO's optimizer-state bytes a rank: {share:.4f} of the exact world's", flush=True)
    require(0.45 <= share <= 0.55, f"ZeRO keeps {share:.4f} of the exact world's optimizer state")

    # (b) 2 slices x 2 ranks, one image a rank.
    specs = [dict(name=n, comm=c, zero=False, slices=s, telescope=False, steps=HIER_STEPS)
             for n, c, s in HIER_FLAVORS]
    t0 = time.perf_counter()
    flavors = _comm_world(os.path.join(root, "comm4"), device, model,
                          small_batch(HIER_RANKS, 5, hier_hw), specs, HIER_RANKS, hier_hw)
    print(f"(b) a world of {HIER_RANKS} over gloo on one card as 2 slices x 2, one image a rank at "
          f"{hier_hw} (smaller than {TRAIN_HW}: four full-width models share the card), f32, "
          f"{HIER_STEPS} steps a flavor: "
          f"{time.perf_counter() - t0:.1f} s with start-up")
    for ranks in flavors:
        _print_flavor(ranks, kind, smi)
    check_world(flavors, HIER_STEPS)
    hier = flavors[1]
    require(all(k in hier[0]["history"][-1] for k in ("comm_ici_bytes", "comm_dcn_bytes",
                                                       "ef_residual_norm_dcn")),
            "the 2x2 world did not run the hierarchical tree")
    require([r["position"] for r in hier] == [0, 2, 1, 3], f"mesh positions {[r['position'] for r in hier]}")

    # (c) train coco, ZeRO + int8, a world of 1 over NCCL: 3 steps, a
    # checkpoint, and a restore of it through the package.
    train_json, val_json = fixture_coco(root, 16, 41), fixture_coco(root, 8, 42)
    snap = os.path.join(root, "comm_snap")
    flags = ["coco", root, "--train-annotations", os.path.basename(train_json), "--train-images",
             str(JPEG_FIXTURES), "--val-annotations", os.path.basename(val_json), "--val-images",
             str(JPEG_FIXTURES), "--snapshot-path", snap, "--steps", "3", "--checkpoint-every", "3",
             "--log-every", "1", "--coordinator-address", f"127.0.0.1:{free_port()}",
             "--num-processes", "1", "--process-id", "0", "--score-threshold", "0.001",
             "--shard-weight-update", "--comm-compress", "int8"]
    reset_all_counts()
    t0 = time.perf_counter()
    out = train_cli.main(flags)
    cli_s = time.perf_counter() - t0
    used = counts()
    manifest = read_manifest(snap)
    saved = dict(saved_leaves(os.path.join(snap, f"ckpt-{manifest['step']}")))
    residuals = {k: v for k, v in saved.items() if k.startswith("['comm_state']")}
    world = initialize_distributed(DistributedConfig(
        coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
        device=device.type))
    try:
        dataset = CocoDataset(train_json, str(JPEG_FIXTURES))
        restored_model = build_retinanet(RetinaNetConfig(num_classes=dataset.num_classes),
                                         device=device, seed=1)
        state = state_lib.create_train_state(
            restored_model, optim_lib.OptimizerConfig(global_batch_size=16), device, world=world,
            comm=CommConfig(compress="int8"), shard_weight_update=True)
        CheckpointManager(snap, world=world).restore(state)
        restored = {path: arr for path, arr in state_lib.snapshot(state)
                    if path.startswith("['comm_state']")}
    finally:
        shutdown_distributed(world)
    equal = set(restored) == set(residuals) and all(np.array_equal(restored[k], residuals[k])
                                                    for k in residuals)
    norm = float(np.sqrt(sum(np.square(v.astype(np.float64)).sum() for v in residuals.values())))
    print(f"(c) train coco --shard-weight-update --comm-compress int8 in a world of 1 over NCCL, "
          f"batch 16, bf16: 3 steps, a checkpoint and the final eval in {cli_s:.1f} s; ckpt step "
          f"{manifest['step']}, zero_world_size {manifest['zero_world_size']}, {len(residuals)} "
          f"residuals (norm {norm:.6e}); restored through the package equal: {equal}; launches "
          f"{used}; process group left {dist.is_initialized()}", flush=True)
    require(out["final_step"] == 3.0 and manifest["step"] == 3 and manifest["zero_world_size"] == 1,
            "the ZeRO + int8 run did not checkpoint step 3")
    require(residuals and norm > 0 and equal, "the restored comm_state differs from the saved one")
    require(not dist.is_initialized(), "a process group was left")
    require(used["plain"] == 0 and all(used[k] == 3 for k in ("matching", "focal_fwd", "focal_bwd"))
            and used["nms"] >= 1, f"the ZeRO + int8 run's launches {used}")
    for k in launches:
        launches[k] += used[k]
    phase_s = time.perf_counter() - t_phase
    print(f"phase 17 in {phase_s:.1f} s (limit {COMM_DEADLINE_S} s); launches {launches}")
    require(phase_s <= COMM_DEADLINE_S, f"phase 17 took {phase_s:.1f} s")
    return launches


# ---- phase 18: the schedule registry ---------------------------------------

SCHEDULE_DEADLINE_S = 150
SCHEDULE_PROBE = """
import json
import torch
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect
torch.cuda.init()
for _ in range(3):
    size = detect.resolve_detect_config(detect.DetectConfig(), "cuda").pre_nms_size
print(json.dumps({"kind": torch.cuda.get_device_name(0), "pre_nms_size": size}))
"""


def schedule_probe(registry: str) -> tuple[dict, list[dict]]:
    """SCHEDULE_PROBE in a process of its own over ``registry``: what it
    resolved, and the ``schedule_fallback`` lines on its stderr."""
    env = {**os.environ, schedule_lib.ENV_DIR: registry}
    proc = subprocess.run([sys.executable, "-c", SCHEDULE_PROBE], capture_output=True, text=True,
                          timeout=120, env=env, cwd=str(Path(__file__).resolve().parent))
    require(proc.returncode == 0, f"the schedule probe failed: {proc.stderr[-2000:]}")
    lines = [json.loads(line) for line in proc.stderr.splitlines()
             if line.startswith("{") and '"schedule_fallback"' in line]
    return json.loads(proc.stdout.strip().splitlines()[-1]), lines


def schedule_phase(root: str, device, kind: str) -> dict[str, int]:
    """Phase 18; returns each kernel's launches in its runs."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(("matching", "focal_fwd", "focal_bwd", "nms"), 0)
    registry = os.path.join(root, "schedules")
    os.makedirs(registry)
    resolved, lines = schedule_probe(registry)
    print(f"no file: resolved {resolved}; fallback lines {lines}")
    require(len(lines) == 1 and lines[0]["device_kind"] == kind
            and lines[0]["reason"] == "no_schedule_artifact", f"fallback lines {lines}")
    require(resolved["pre_nms_size"] == 1000, "with no file pre_nms_size is not 1000")

    doc = {"format": schedule_lib.FORMAT, "device_kind": kind,
           "entries": {"nms": {"pre_nms_size": 500}}}
    path = schedule_lib.save_schedule(doc, registry)
    resolved, lines = schedule_probe(registry)
    print(f"a file for the card: resolved {resolved}; fallback lines {lines}")
    require(resolved == {"kind": kind, "pre_nms_size": 500} and not lines,
            f"the file for the card was not read: {resolved}, {lines}")
    previous = os.environ.get(schedule_lib.ENV_DIR)
    os.environ[schedule_lib.ENV_DIR] = registry
    try:
        # The detect path reads the file where the config leaves the size
        # None: the NMS kernel is handed the registry's candidate count.
        tiny = build_retinanet(RetinaNetConfig(num_classes=3, backbone="resnet_test"), device=device)
        hw = (64, 64)
        anchors = detect_lib.anchors_on(hw, AnchorConfig(), device)
        handed = []

        def nms(*args, **kwargs):
            handed.append(kwargs["pre_nms_size"])
            return nms_cuda.batched_multiclass_nms_cuda(*args, **kwargs)

        with torch.inference_mode():
            outputs = tiny(torch.zeros((2, *hw, 3), device=device))
            det = detect_lib.postprocess(outputs, anchors, hw, detect_lib.DetectConfig(), nms=nms)
            torch.cuda.synchronize()
        print(f"postprocess on the card with DetectConfig(): pre_nms_size handed to the NMS "
              f"kernel {handed}, detections {tuple(det.boxes.shape)}")
        require(handed == [500], f"postprocess handed the NMS kernel {handed}")
        del tiny, outputs, det

        small = ["--synthetic-root", os.path.join(root, "sched_synthetic"), "--synthetic-images", "16",
                 "--synthetic-size", "64", "--image-min-side", "64", "--image-max-side", "64",
                 "--backbone", "resnet_test", "--batch-size", "8", "--workers", "4"]
        snap = os.path.join(root, "sched_snap")
        reset_all_counts()
        out = train_cli.main(["synthetic", *small, "--snapshot-path", snap, "--steps", "3",
                              "--eval-every", "3", "--score-threshold", "0.001"])
        used = counts()
        for k in launches:
            launches[k] += used[k]
        print(f"train synthetic with the file: final step {out['final_step']}, loss "
              f"{out.get('loss')}; launches {used}")
        require(out["final_step"] == 3.0, f"final step {out['final_step']}")
        require(all(used[k] == 3 for k in ("matching", "focal_fwd", "focal_bwd"))
                and used["nms"] >= 1 and used["plain"] == 0, f"the registry's run launched {used}")
        export = os.path.join(root, "sched_export")
        reset_all_counts()
        convert_cli.main(["--snapshot-path", snap, "--output", export, "--num-classes", "3",
                          "--backbone", "resnet_test", "--image-min-side", "64",
                          "--image-max-side", "64", "--batch-sizes", "1"])
        for k in launches:
            launches[k] += counts()[k]
        manifest = json.loads(Path(export, "manifest.json").read_text())
        print(f"convert_model: schedule {manifest['schedule']}, pre_nms_size "
              f"{manifest['detect_config']['pre_nms_size']}")
        require(manifest["schedule"]["found"] is True
                and manifest["schedule"]["device_kind"] == kind
                and manifest["detect_config"]["pre_nms_size"] == 500, "the manifest's schedule")
    finally:
        if previous is None:
            os.environ.pop(schedule_lib.ENV_DIR, None)
        else:
            os.environ[schedule_lib.ENV_DIR] = previous

    bad = {"format": schedule_lib.FORMAT, "device_kind": kind, "entries": {
        "nms": {"pre_nms_size": 100000, "block_k": 256}, "focal": {"impl": "nhwc"},
        "matching": {"tile_a": 8192}}}
    Path(path).write_text(json.dumps(bad))
    resolved, lines = schedule_probe(registry)
    try:
        schedule_lib.load_schedule(path)
        problems = "load_schedule accepted it"
    except schedule_lib.ScheduleError as e:
        problems = str(e)
    print(f"a malformed file: resolved {resolved}; fallback lines {lines}; load_schedule: {problems}")
    require(len(lines) == 1 and lines[0]["reason"] == "invalid_schedule_artifact"
            and resolved["pre_nms_size"] == 1000, "a malformed file did not fall back to the defaults")
    require(all(w in problems for w in ("pre_nms_size", "block_k", "focal", "matching")),
            f"load_schedule did not name every problem: {problems}")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 18 in {phase_s:.1f} s (limit {SCHEDULE_DEADLINE_S} s); launches {launches}")
    require(phase_s <= SCHEDULE_DEADLINE_S, f"phase 18 took {phase_s:.1f} s")
    return launches



# ---- phase 19: the schedule search over the kernels' launch shapes ---------

TUNE_DEADLINE_S = 150
# 201 600 anchors, the (800, 1344) bucket's, are a multiple of 128: the last
# 128-anchor tile is ragged at this bucket instead.
RAGGED_HW = (768, 1344)
TUNE_CONSUMERS = """
import json, os, sys
import torch
from batchai_retinanet_horovod_coco_tpu_torch import convert_model as convert_cli
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import RetinaNetConfig, build_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal, matching, nms
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as train_cli

root = sys.argv[1]
kernels = (matching, focal, nms)


def counts():
    return {"matching": dict(matching.variant_launches),
            "focal_fwd": dict(focal.fwd_variant_launches),
            "focal_bwd": dict(focal.bwd_variant_launches),
            "nms": {f"{l},{t}": n for (l, t), n in nms.variant_launches.items()},
            "plain": sum(k.plain_calls for k in kernels)}


def reset():
    for k in kernels:
        k.reset_counts()


out = {}
small = ["--synthetic-root", os.path.join(root, "synthetic"), "--synthetic-images", "16",
         "--synthetic-size", "64", "--image-min-side", "64", "--image-max-side", "64",
         "--backbone", "resnet_test", "--batch-size", "8", "--workers", "4"]
snap = os.path.join(root, "snap")
reset()
run = train_cli.main(["synthetic", *small, "--snapshot-path", snap, "--steps", "3",
                      "--eval-every", "3", "--score-threshold", "0.001"])
out["train"] = dict(counts(), final_step=run["final_step"])
model = build_retinanet(RetinaNetConfig(num_classes=3, backbone="resnet_test"), device="cuda")
hw = (64, 64)
anchors = detect.anchors_on(hw, AnchorConfig(), torch.device("cuda"))
reset()
with torch.inference_mode():
    det = detect.postprocess(model(torch.zeros((2, *hw, 3), device="cuda")), anchors, hw,
                             detect.DetectConfig(score_threshold=0.001))
    torch.cuda.synchronize()
out["postprocess"] = counts()
reset()
manifest = convert_cli.main(["--snapshot-path", snap, "--output", os.path.join(root, "export"),
                             "--num-classes", "3", "--backbone", "resnet_test",
                             "--image-min-side", "64", "--image-max-side", "64",
                             "--batch-sizes", "1"])
out["convert"] = counts()
out["manifest"] = json.loads(open(manifest).read())
print(json.dumps(out))
"""


def variant_label(params: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(params.items()))


def variant_checks(anchors: torch.Tensor, batch: pipeline_lib.Batch, device) -> dict[str, dict]:
    """Phase 19 (a): every variant agrees with its plain version on the
    fields of phases 3, 6 and 7.  Returns each kernel row's variants'
    device ms."""
    menus = shapes.MENUS
    require(matching_cuda.kernel_tile() == shapes.DEFAULTS[("matching", "tile_a")],
            "the matching library's default tile is not the one of ops/cuda/shapes.py")
    rows: dict[str, dict] = {}

    # NMS: phase 3's cases, every (lanes, scan threads) equal to plain.
    nms_shapes = [(lanes, threads) for lanes in menus[("nms", "mask_lanes")]
                  for threads in menus[("nms", "scan_threads")]]
    cases = [dict(batch=8, k=1000, num_classes=8, seed=0), dict(batch=8, k=1000, num_classes=8, seed=1),
             dict(batch=8, k=1000, num_classes=8, seed=2),
             dict(batch=8, k=1000, num_classes=8, seed=3, tied=True),
             dict(batch=8, k=1000, num_classes=8, seed=4, pad_images=(0,)),
             dict(batch=8, k=300, num_classes=8, seed=5), dict(batch=8, k=65, num_classes=3, seed=6),
             dict(batch=8, k=129, num_classes=3, seed=7),
             "one box repeated", "disjoint boxes", "cross-word chain",
             # More later words than half the scan's threads, up to its
             # largest K.
             dict(batch=2, k=4200, num_classes=8, seed=8), dict(batch=2, k=8192, num_classes=8, seed=9)]
    timed = None
    for case in cases:
        cb, cs, ci = random_candidates(device=device, **case) if isinstance(case, dict) \
            else nms_case(case, device)
        timed = timed or (cb, cs, ci)
        want = nms_cuda.nms_keep_mask_plain(cb, cs, ci, IOU_THRESHOLD)
        for lanes, threads in nms_shapes:
            got = nms_cuda.nms_keep_mask(cb, cs, ci, IOU_THRESHOLD, lanes, threads)
            require(torch.equal(got, want), f"NMS at lanes {lanes}, scan threads {threads} differs "
                                            f"from the plain version ({case})")
    rows["nms_keep_mask"] = {
        variant_label({"mask_lanes": lanes, "scan_threads": threads}): device_ms(
            lambda: nms_cuda.nms_keep_mask(*timed, IOU_THRESHOLD, lanes, threads))
        for lanes, threads in nms_shapes}
    print(f"(a) NMS: {len(nms_shapes)} shapes x {len(cases)} cases (phase 3's, K 4200 and 8192) equal "
          f"to the plain version; device ms at B 8, K 1000: {rows['nms_keep_mask']}")

    # Matching: phase 6's fields, each culling edit aimed at the tile.
    num_anchors = anchors.shape[0]
    ragged = detect_lib.anchors_on(RAGGED_HW, AnchorConfig(), device)
    rows["assign_fused"] = {}
    for tile in menus[("matching", "tile_a")]:
        fields = [
            (anchors, gt_scene(16, MAX_GT, 0, counts=(1, 100), empty=(3,), dup=(4, 5), tiny=(6, 7))),
            (anchors, gt_scene(16, MAX_GT, 1, counts=(0, 40), dup=range(8))),
            (anchors, culling_field("scatter", 2, anchors, tile)),
            (anchors, culling_field("off anchors", 3, anchors, tile)),
            (anchors, culling_field("tile edges", 4, anchors, tile)),
            (anchors, gt_scene(2, 1000, 5, counts=(1000, 1000))),
            (ragged, culling_field("last tile", 6, ragged, tile)) if num_anchors % tile == 0
            else (anchors, culling_field("last tile", 6, anchors, tile)),
            (anchors, (batch.gt_boxes, batch.gt_labels, batch.gt_mask)),
        ]
        for i, (a, arrays) in enumerate(fields):
            gts = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in arrays)
            got = matching_cuda.assign_fused(a, *gts, tile)
            want = matching_cuda.assign_fused_plain(a, *gts)
            require(all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)),
                    f"matching at tile {tile} differs from the plain version (field {i})")
        rows["assign_fused"][variant_label({"tile_a": tile})] = device_ms(
            lambda: matching_cuda.assign_fused(anchors, *gts, tile))
    print(f"(a) matching: {len(menus[('matching', 'tile_a')])} tiles x {len(fields)} fields of phase 6 "
          f"equal to the plain version (the last tile's field at {RAGGED_HW} where 128 divides "
          f"{num_anchors}); device ms on the first training batch: {rows['assign_fused']}")

    # Focal: phase 7's field.
    gts = tuple(torch.from_numpy(a).to(device) for a in (batch.gt_boxes, batch.gt_labels, batch.gt_mask))
    targets = matching_lib.anchor_targets_compact_batched(anchors, *gts)
    labels, state = targets.matched_labels.contiguous(), targets.state.contiguous()
    b, a = state.shape
    gen = torch.Generator(device=device).manual_seed(0)
    logits = torch.rand((b, a, 80), generator=gen, device=device) * 24 - 12
    far = torch.rand(logits.shape, generator=gen, device=device) < 0.01
    logits = torch.where(far, torch.sign(logits) * 25, logits).contiguous()
    weights = torch.linspace(0.5, 2.0, b, device=device)
    with torch.no_grad():
        plain = focal_cuda.focal_sums_plain(logits, labels, state)
    rows["focal_fwd"], rows["focal_bwd"], rels = {}, {}, {}
    for tile in menus[("focal", "fwd_tile_a")]:
        sums = focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0, tile)
        again = focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0, tile)
        rels[tile] = float(((sums - plain).abs() / plain.abs()).max())
        require(torch.equal(sums, again), f"the focal forward at tile {tile} does not repeat")
        require(rels[tile] <= 1e-5, f"the focal forward at tile {tile} is rel {rels[tile]} off")
        rows["focal_fwd"][variant_label({"fwd_tile_a": tile})] = device_ms(
            lambda: focal_cuda.focal_fwd(logits, labels, state, 0.25, 2.0, tile), 5, 4)
    base = focal_cuda.focal_bwd(logits, labels, state, weights, 0.25, 2.0)
    for tile in menus[("focal", "bwd_tile_a")]:
        grad = focal_cuda.focal_bwd(logits, labels, state, weights, 0.25, 2.0, tile)
        require(torch.equal(grad, base), f"the focal backward at tile {tile} differs from the default's")
        rows["focal_bwd"][variant_label({"bwd_tile_a": tile})] = device_ms(
            lambda: focal_cuda.focal_bwd(logits, labels, state, weights, 0.25, 2.0, tile), 5, 4)
    print(f"(a) focal: forward rel err by tile {rels} (limit 1e-05), each repeating bit for bit; "
          f"every backward tile equal to the default's bit for bit; device ms "
          f"{rows['focal_fwd']} and {rows['focal_bwd']}")
    return rows


def tune_phase(root: str, device, kind: str, smi: str, anchors: torch.Tensor,
               batch: pipeline_lib.Batch) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 19; returns each kernel's launches in its consumers' run and
    each kernel row's variants' device ms."""
    from batchai_retinanet_horovod_coco_tpu_torch.tune import __main__ as tune_cli

    t_phase = time.perf_counter()
    variants = variant_checks(anchors, batch, device)

    registry = os.path.join(root, "tuned")
    record = os.path.join(registry, "tunebench.json")
    here = str(Path(__file__).resolve().parent)
    env = {k: v for k, v in os.environ.items() if k != schedule_lib.ENV_DIR}
    # The command line's main in this process, as (d)'s --check after it.
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tune_cli.main(["--ops", "nms,focal,matching", "--steps", "10",
                            "--out-root", registry, "--bench-out", record])
    require(rc == 0, f"the search exited {rc}: {out.getvalue()[-3000:]}")
    summary = json.loads([line for line in out.getvalue().splitlines() if line.startswith("{")][-1])
    doc = schedule_lib.load_schedule(summary["artifact"])  # validates
    print(f"(b) the search in {time.perf_counter() - t0:.1f} s: {len(doc['trials'])} trials, "
          f"{summary['failed']} failed, {summary['skipped']} skipped; winners {doc['entries']} "
          f"({smi})")
    for t in doc["trials"]:
        require(t["status"] == "ok" or (t["status"] == "failed" and t["error"]),
                f"a trial is {t['status']} without an error: {t}")
        print(f"  {t['op']} {variant_label(t['params'])}: {t['ms_per_call']} device ms a call, windows "
              f"{t['window_ms']}, noise {t['noise_pct']}% ({t['status']})")
    require(set(doc["entries"]) == {"nms", "focal", "matching"} and doc["device_kind"] == kind,
            f"the search's file {doc['entries']}")
    win = doc["entries"]

    work = os.path.join(root, "tune_consumers")
    os.makedirs(work)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", TUNE_CONSUMERS, work], capture_output=True, text=True,
                          timeout=300, env={**env, schedule_lib.ENV_DIR: registry}, cwd=here)
    require(proc.returncode == 0, f"the consumers' process failed: {proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    nms_key = f"{win['nms']['mask_lanes']},{win['nms']['scan_threads']}"
    train = got["train"]
    print(f"(c) a fresh process over the file, {time.perf_counter() - t0:.1f} s: train synthetic "
          f"launched matching {train['matching']}, focal forward {train['focal_fwd']}, backward "
          f"{train['focal_bwd']}, NMS {train['nms']} (tile / shape: launches); postprocess NMS "
          f"{got['postprocess']['nms']}; the manifest's launch shapes {got['manifest']['launch_shapes']}, schedule "
          f"{got['manifest']['schedule']}")
    require(train["final_step"] == 3.0 and train["plain"] == 0, f"the training run: {train}")
    require(train["matching"] == {str(win["matching"]["tile_a"]): 3}
            and train["focal_fwd"] == {str(win["focal"]["fwd_tile_a"]): 3}
            and train["focal_bwd"] == {str(win["focal"]["bwd_tile_a"]): 3},
            f"the training run did not launch the winning variants only: {train}")
    require(set(train["nms"]) == {nms_key}, f"the training run's eval launched NMS {train['nms']}")
    require(got["postprocess"]["nms"] == {nms_key: 1} and got["postprocess"]["plain"] == 0,
            f"postprocess launched {got['postprocess']}, not the winning NMS variant only")
    manifest = got["manifest"]
    require(manifest["launch_shapes"]["nms"] == {k: win["nms"][k] for k in ("mask_lanes", "scan_threads")}
            and manifest["schedule"]["found"] is True and manifest["schedule"]["device_kind"] == kind,
            f"the manifest's launch shapes {manifest['launch_shapes']}, schedule {manifest['schedule']}")
    require(set(got["convert"]["nms"]) <= {nms_key} and got["convert"]["plain"] == 0,
            f"convert_model launched {got['convert']}")
    launches = {
        "matching": sum(train["matching"].values()),
        "focal_fwd": sum(train["focal_fwd"].values()),
        "focal_bwd": sum(train["focal_bwd"].values()),
        "nms": sum(train["nms"].values()) + sum(got["postprocess"]["nms"].values())
        + sum(got["convert"]["nms"].values()),
    }

    # --check reads the record and measures its winner again.  Its verdict
    # is a timing, printed and not gated on here.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tune_cli.main(["--check", "--bench-out", record, "--steps", "10"])
    verdict = out.getvalue().strip()
    print(f"(d) {verdict} (exit {rc})")
    require((rc, verdict.endswith(": ok")) in ((0, True), (1, False)) and "vs recorded" in verdict,
            f"tune --check did not measure the record's winner: exit {rc}, {verdict!r}")

    report = os.path.join(root, "perf_obs", "PERF_REPORT.json")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tune_cli.main(["--from-report", report, "--smoke", "--steps", "2", "--dry-run",
                            "--out-root", os.path.join(root, "tuned_dry")])
    derived = [line for line in out.getvalue().splitlines() if line.startswith("# tune: --from-report")]
    print(f"(e) {derived[0] if derived else out.getvalue()[:500]}")
    require(rc == 0 and derived, "tune --from-report did not derive its ops from phase 13's report")
    phase_s = time.perf_counter() - t_phase
    print(f"phase 19 in {phase_s:.1f} s (limit {TUNE_DEADLINE_S} s); launches {launches}")
    require(phase_s <= TUNE_DEADLINE_S, f"phase 19 took {phase_s:.1f} s")
    return launches, variants


if __name__ == "__main__":
    sys.exit(main())
