"""Greedy NMS suppression on Hopper: the wrapper of ``ops/cuda/nms.cu``.

Replaces the TPU kernel ``batchai_retinanet_horovod_coco_tpu/ops/pallas/
nms.py::nms_keep_mask`` (its ``pl.pallas_call`` at line 191, body
``_kernel``) and, like ``batched_multiclass_nms_pallas``, only the
suppression stage of the NMS pipeline: candidate selection and compaction
are the shared stages of ``ops/nms.py``.

What bounds it on this card: the inputs and output are ~25 bytes a
candidate (200 KB at B 8, K 1000) and the IoU work is ~15 f32 operations a
same-class pair, a few microseconds of the card at most; what is left is
the greedy order itself, one decision after another.  The design splits
the work in two launches (``nms_mask_launch``, ``nms_scan_launch``): a
parallel pass writes every "j suppresses i" bit of the upper block
triangle as uint64 words, then one block per image scans the candidates a
64-candidate word at a time, with the suppressed set in shared memory.
One thread resolves a word from its 64 diagonal words (the only serial
part) while the other warps stage the next word's mask rows in shared
memory; then the block ORs the kept rows' later words into the
suppressed set with shared atomics.  No device memory read waits on the
serial chain.  The TPU kernel's blocked fixed point and identity-matmul
transposes are not carried over: they exist for the TPU's (8, 128) tiles.

The keep mask is the PyTorch custom op ``retinanet_torch::nms_keep_mask``
(registered when this module is imported): its CUDA kernel launches the
two passes, its CPU kernel is the plain version (the ported
``greedy_keep``), and its fake implementation gives the output's shape, so
that ``torch.export`` records a call to the op, not the plain body, and an
exported detect program runs the hand kernel on a card.  On a CUDA tensor
the op launches the kernel or raises.  The counters ``kernel_launches``
and ``plain_calls`` let a run show which of the two it went through.

The launch shapes are choices (their menus and defaults, ``ops/cuda/
shapes.py``): the lanes (threads) sharing one row of the mask pass's
64 x 64 block (2, 4 or 8; 4 by default) and the scan's threads (256 or 512;
256 by default).  Every shape gives the same keep mask.  They are arguments
of the op, with those defaults, so a program exported before they existed
still loads and runs, and an export bakes in the shape it was traced with.
The schedule registry's ``nms.mask_lanes`` and ``nms.scan_threads`` pick
them (``DetectConfig``); ``variant_launches`` counts the launches by
``(mask_lanes, scan_threads)``.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build, shapes

#: The custom op that ``batched_multiclass_nms_cuda`` calls.
OP_NAME = "retinanet_torch::nms_keep_mask"

#: Launches of the CUDA kernel pair, one per call on CUDA tensors.
kernel_launches = 0
#: Calls that took the plain version because the tensors were on the CPU.
plain_calls = 0
#: Launches by (mask_lanes, scan_threads).
variant_launches: collections.Counter = collections.Counter()

_BLOCK = 64  # candidates per mask word, as kBlock in nms.cu
_PAD_SCORE = nms_lib._NEG_INF / 2  # scores at or below this are padding
# The defaults of the op's launch-shape arguments: the kernel's shapes
# before the menus.
DEFAULT_MASK_LANES = shapes.DEFAULTS[("nms", "mask_lanes")]
DEFAULT_SCAN_THREADS = shapes.DEFAULTS[("nms", "scan_threads")]


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    variant_launches.clear()


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = build.load("nms")
    lib.nms_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nms_mask_launch.restype = ctypes.c_int
    lib.nms_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.nms_scan_launch.restype = ctypes.c_int
    lib.nms_max_k.argtypes = []
    lib.nms_max_k.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib


def check_shape(mask_lanes: int, scan_threads: int) -> None:
    """Raise unless the shape is on the menus."""
    shapes.resolve("nms", "mask_lanes", mask_lanes)
    shapes.resolve("nms", "scan_threads", scan_threads)


def _check(lib: ctypes.CDLL, which: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"NMS {which} kernel launch failed: {lib.nms_error_string(err).decode()}"
        )


def _check_inputs(
    cand_boxes: torch.Tensor, cand_scores: torch.Tensor, class_idx: torch.Tensor
) -> None:
    if cand_scores.dim() != 2:
        raise ValueError(f"scores must be (B, K), got {tuple(cand_scores.shape)}")
    b, k = cand_scores.shape
    if tuple(cand_boxes.shape) != (b, k, 4):
        raise ValueError(f"boxes must be (B, K, 4), got {tuple(cand_boxes.shape)}")
    if tuple(class_idx.shape) != (b, k):
        raise ValueError(f"class ids must be (B, K), got {tuple(class_idx.shape)}")
    for name, t, dtype in (
        ("boxes", cand_boxes, torch.float32),
        ("scores", cand_scores, torch.float32),
        ("class ids", class_idx, torch.int32),
    ):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != cand_scores.device:
            raise ValueError(f"{name} on {t.device}, scores on {cand_scores.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def nms_keep_mask_plain(
    cand_boxes: torch.Tensor,
    cand_scores: torch.Tensor,
    class_idx: torch.Tensor,
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """The plain version: the ported ``greedy_keep`` over the batch."""
    return nms_lib.greedy_keep(cand_boxes, cand_scores, iou_threshold, class_idx)


@torch.library.custom_op(OP_NAME, mutates_args=(), device_types="cpu")
def _keep_mask_op(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_threshold: float,
    mask_lanes: int = DEFAULT_MASK_LANES, scan_threads: int = DEFAULT_SCAN_THREADS,
) -> torch.Tensor:
    """The op's CPU kernel: the plain version (it has no launch shape)."""
    global plain_calls
    _check_inputs(boxes, scores, classes)
    check_shape(mask_lanes, scan_threads)
    plain_calls += 1
    return nms_keep_mask_plain(boxes, scores, classes, iou_threshold)


@_keep_mask_op.register_kernel("cuda")
def _keep_mask_cuda(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_threshold: float,
    mask_lanes: int = DEFAULT_MASK_LANES, scan_threads: int = DEFAULT_SCAN_THREADS,
) -> torch.Tensor:
    """The op's CUDA kernel: the mask pass, then the blocked scan."""
    global kernel_launches
    _check_inputs(boxes, scores, classes)
    check_shape(mask_lanes, scan_threads)
    device = scores.device
    b, k = scores.shape
    lib = _library()
    if k > lib.nms_max_k():
        raise ValueError(f"K = {k} exceeds the kernel's {lib.nms_max_k()}")
    keep = torch.empty((b, k), dtype=torch.bool, device=device)
    if b == 0 or k == 0:
        return keep
    words = -(-k // _BLOCK)
    with torch.cuda.device(device):
        mask = torch.empty((b, k, words), dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib, "mask", lib.nms_mask_launch(
            boxes.data_ptr(), classes.data_ptr(), b, k, float(iou_threshold),
            mask.data_ptr(), mask_lanes, stream,
        ))
        _check(lib, "scan", lib.nms_scan_launch(
            scores.data_ptr(), mask.data_ptr(), b, k, _PAD_SCORE, keep.data_ptr(),
            scan_threads, stream,
        ))
    kernel_launches += 1
    variant_launches[(mask_lanes, scan_threads)] += 1
    return keep


@_keep_mask_op.register_fake
def _keep_mask_fake(
    boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, iou_threshold: float,
    mask_lanes: int = DEFAULT_MASK_LANES, scan_threads: int = DEFAULT_SCAN_THREADS,
) -> torch.Tensor:
    _check_inputs(boxes, scores, classes)
    check_shape(mask_lanes, scan_threads)
    return scores.new_empty(scores.shape, dtype=torch.bool)


def nms_keep_mask(
    cand_boxes: torch.Tensor,
    cand_scores: torch.Tensor,
    class_idx: torch.Tensor,
    iou_threshold: float = 0.5,
    mask_lanes: int | None = None,
    scan_threads: int | None = None,
) -> torch.Tensor:
    """(B, K) bool greedy keep mask over candidates SORTED by descending
    score per image (``select_candidates`` output): boxes (B, K, 4) f32,
    scores (B, K) f32, class ids (B, K) int32, all contiguous.  Scores at
    or below ``_NEG_INF / 2`` are padding, never kept and never
    suppressing.  Equal, bit for bit, to :func:`nms_keep_mask_plain`, at
    every launch shape (None: the default).  A call of the custom op: the
    kernel on a card, the plain version on the CPU."""
    return torch.ops.retinanet_torch.nms_keep_mask.default(
        cand_boxes, cand_scores, class_idx, float(iou_threshold),
        DEFAULT_MASK_LANES if mask_lanes is None else int(mask_lanes),
        DEFAULT_SCAN_THREADS if scan_threads is None else int(scan_threads),
    )


def batched_multiclass_nms_cuda(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    pre_nms_size: int = 1000,
    max_detections: int = 300,
    mask_lanes: int | None = None,
    scan_threads: int | None = None,
) -> nms_lib.Detections:
    """``ops.nms.batched_multiclass_nms`` with the suppression stage on
    :func:`nms_keep_mask` at the given launch shape — the CUDA kernel on a
    card, the plain version on the CPU.  Selection and compaction are the
    shared stages, so the output equals the plain pipeline's bit for
    bit."""
    cand_boxes, cand_scores, class_idx = nms_lib.select_candidates(
        boxes, cls_scores, score_threshold, pre_nms_size
    )
    keep = nms_keep_mask(
        cand_boxes.contiguous(), cand_scores.contiguous(),
        class_idx.contiguous(), iou_threshold, mask_lanes, scan_threads,
    )
    sel, valid = nms_lib.compact_keep(cand_scores, keep, max_detections)
    return nms_lib.build_detections(cand_boxes, cand_scores, class_idx, sel, valid)
