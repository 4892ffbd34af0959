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

On a CPU tensor the wrapper runs the plain version (the ported
``greedy_keep``); on a CUDA tensor it launches the kernel or raises.  The
counters ``kernel_launches`` and ``plain_calls`` let a run show which of
the two it went through.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build

#: Launches of the CUDA kernel pair, one per call on CUDA tensors.
kernel_launches = 0
#: Calls that took the plain version because the tensors were on the CPU.
plain_calls = 0

_BLOCK = 64  # candidates per mask word, as kBlock in nms.cu
_PAD_SCORE = nms_lib._NEG_INF / 2  # scores at or below this are padding


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = build.load("nms")
    lib.nms_mask_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.nms_mask_launch.restype = ctypes.c_int
    lib.nms_scan_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.nms_scan_launch.restype = ctypes.c_int
    lib.nms_max_k.argtypes = []
    lib.nms_max_k.restype = ctypes.c_int
    lib.nms_error_string.argtypes = [ctypes.c_int]
    lib.nms_error_string.restype = ctypes.c_char_p
    return lib


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


def nms_keep_mask(
    cand_boxes: torch.Tensor,
    cand_scores: torch.Tensor,
    class_idx: torch.Tensor,
    iou_threshold: float = 0.5,
) -> torch.Tensor:
    """(B, K) bool greedy keep mask over candidates SORTED by descending
    score per image (``select_candidates`` output): boxes (B, K, 4) f32,
    scores (B, K) f32, class ids (B, K) int32, all contiguous.  Scores at
    or below ``_NEG_INF / 2`` are padding, never kept and never
    suppressing.  Equal, bit for bit, to :func:`nms_keep_mask_plain`."""
    global kernel_launches, plain_calls
    _check_inputs(cand_boxes, cand_scores, class_idx)
    device = cand_scores.device
    if device.type == "cpu":
        plain_calls += 1
        return nms_keep_mask_plain(cand_boxes, cand_scores, class_idx, iou_threshold)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    b, k = cand_scores.shape
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
            cand_boxes.data_ptr(), class_idx.data_ptr(), b, k, float(iou_threshold),
            mask.data_ptr(), stream,
        ))
        _check(lib, "scan", lib.nms_scan_launch(
            cand_scores.data_ptr(), mask.data_ptr(), b, k, _PAD_SCORE, keep.data_ptr(), stream,
        ))
    kernel_launches += 1
    return keep


def batched_multiclass_nms_cuda(
    boxes: torch.Tensor,
    cls_scores: torch.Tensor,
    score_threshold: float = 0.05,
    iou_threshold: float = 0.5,
    pre_nms_size: int = 1000,
    max_detections: int = 300,
) -> nms_lib.Detections:
    """``ops.nms.batched_multiclass_nms`` with the suppression stage on
    :func:`nms_keep_mask` — the CUDA kernel on a card, the plain version on
    the CPU.  Selection and compaction are the shared stages, so the
    output equals the plain pipeline's bit for bit."""
    cand_boxes, cand_scores, class_idx = nms_lib.select_candidates(
        boxes, cls_scores, score_threshold, pre_nms_size
    )
    keep = nms_keep_mask(
        cand_boxes.contiguous(), cand_scores.contiguous(),
        class_idx.contiguous(), iou_threshold,
    )
    sel, valid = nms_lib.compact_keep(cand_scores, keep, max_detections)
    return nms_lib.build_detections(cand_boxes, cand_scores, class_idx, sel, valid)
