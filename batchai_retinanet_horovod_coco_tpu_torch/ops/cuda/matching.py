"""Fused anchor→gt assignment on Hopper: the wrapper of ``ops/cuda/matching.cu``.

Replaces the TPU kernel ``batchai_retinanet_horovod_coco_tpu/ops/pallas/
matching.py::assign_fused`` (its ``pl.pallas_call`` at line 177, body
``_kernel``): the IoU of every anchor against the G padded gts of each
image, reduced per anchor (max IoU, first argmax gt, that gt's box and
label) and per gt (best IoU, lowest anchor reaching it).  Thresholds, the
force-match patch and the encode stay in ``ops/matching.py``.

What bounds it on this card: its bytes, the anchors, the gts and the
outputs (some 81 MB at B 16, A 201 600, G 100, about 0.024 ms).  The
kernel keeps anchors in registers and the gts in shared memory, so the
pair loop reads no device memory.  Each block of 256 anchors (a run of
positions along one row of a pyramid level) first lists the gts that are real
and overlap its anchors' bounding box, and walks only those, and for each
listed gt only the warps' chunks of 32 anchors whose box it overlaps: a
skipped pair has an IoU of exactly 0 (the argument is in the source
note), so the outputs stay equal to the plain version's.
:func:`tile_gt_lists` states that test in plain PyTorch.  The per-gt
argmax is a 64-bit (IoU bits, ~anchor) key and ``atomicMax``:
deterministic, no float atomics.

The tile (anchors a block) is a launch choice (its menu and default,
``ops/cuda/shapes.py``: 128 or 256; 256 by default), every tile gives the
same outputs, and the schedule registry's ``matching.tile_a`` picks one
(``MatchingConfig.tile_a``).

On a CPU tensor the wrapper runs the plain version (which has no tile); on
a CUDA tensor it launches the kernel or raises.  ``kernel_launches`` and
``plain_calls`` count which of the two ran, ``variant_launches`` the
launches by tile.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build, shapes
from batchai_retinanet_horovod_coco_tpu_torch.ops.iou import pairwise_iou

#: Launches of the CUDA kernel pair, one per call on CUDA tensors.
kernel_launches = 0
#: Calls that took the plain version because the tensors were on the CPU.
plain_calls = 0
#: Launches by tile (anchors a block).
variant_launches: collections.Counter = collections.Counter()


def reset_counts() -> None:
    global kernel_launches, plain_calls
    kernel_launches = 0
    plain_calls = 0
    variant_launches.clear()


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = build.load("matching")
    lib.match_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.match_launch.restype = ctypes.c_int
    lib.match_max_gt.argtypes = []
    lib.match_max_gt.restype = ctypes.c_int
    lib.match_tile.argtypes = []
    lib.match_tile.restype = ctypes.c_int
    lib.match_error_string.argtypes = [ctypes.c_int]
    lib.match_error_string.restype = ctypes.c_char_p
    return lib


def kernel_tile() -> int:
    """The default tile (anchors a block), which a call naming none
    launches, read from the library, which this builds on first use."""
    return _library().match_tile()


def check_tile(tile_a: int | None) -> int:
    """``tile_a`` checked against the menu; None is the default."""
    return shapes.resolve("matching", "tile_a", tile_a)


def _check_inputs(anchors, gt_boxes, gt_labels, gt_mask) -> None:
    if anchors.dim() != 2 or anchors.shape[1] != 4:
        raise ValueError(f"anchors must be (A, 4), got {tuple(anchors.shape)}")
    if gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4:
        raise ValueError(f"gt boxes must be (B, G, 4), got {tuple(gt_boxes.shape)}")
    b, g = gt_boxes.shape[:2]
    if g == 0 or anchors.shape[0] == 0:
        raise ValueError("need at least one anchor and one (padded) gt row")
    for name, t, shape, dtype in (
        ("anchors", anchors, tuple(anchors.shape), torch.float32),
        ("gt boxes", gt_boxes, (b, g, 4), torch.float32),
        ("gt labels", gt_labels, (b, g), torch.int32),
        ("gt mask", gt_mask, (b, g), torch.bool),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != gt_boxes.device:
            raise ValueError(f"{name} on {t.device}, gt boxes on {gt_boxes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def assign_fused_plain(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """The plain version: the ported ``pairwise_iou`` over the batch, with
    max and first argmax on both axes."""
    iou = pairwise_iou(anchors, gt_boxes)  # (B, A, G)
    iou = torch.where(gt_mask[:, None, :], iou, 0.0)
    max_iou, matched_gt = iou.max(dim=-1)
    gt_best_iou, gt_best_anchor = iou.max(dim=-2)
    matched_boxes = torch.gather(gt_boxes, 1, matched_gt[..., None].expand(*matched_gt.shape, 4))
    matched_labels = torch.gather(gt_labels, 1, matched_gt)
    return matched_boxes, matched_labels, max_iou, gt_best_iou, gt_best_anchor.to(torch.int32)


def tile_gt_lists(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    tile: int,
) -> torch.Tensor:
    """(B, T, G) bool: the gt rows that the kernel's block for each tile of
    ``tile`` anchors (:func:`kernel_tile` for the kernel's own) walks: real,
    and overlapping the bounding box of the tile's anchors strictly on both
    axes.  The last tile may be ragged.  The kernel computes this itself;
    this is its test in plain PyTorch."""
    a = anchors.shape[0]
    t = -(-a // tile)
    pad = t * tile - a
    lo = torch.cat([anchors[:, :2], anchors.new_full((pad, 2), float("inf"))])
    hi = torch.cat([anchors[:, 2:], anchors.new_full((pad, 2), float("-inf"))])
    lo = lo.view(t, tile, 2).amin(1)[None, :, None]  # (1, T, 1, 2)
    hi = hi.view(t, tile, 2).amax(1)[None, :, None]
    g = gt_boxes[:, None]  # (B, 1, G, 4)
    overlap = (torch.minimum(hi, g[..., 2:]) > torch.maximum(lo, g[..., :2])).all(-1)
    return overlap & gt_mask[:, None, :]


def assign_fused(
    anchors: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_mask: torch.Tensor,
    tile_a: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """Batched fused assignment: anchors (A, 4) f32, gt boxes (B, G, 4) f32,
    labels (B, G) int32, mask (B, G) bool, all contiguous on one device;
    ``tile_a`` anchors a block (on the menu; None is the default).

    Returns matched boxes (B, A, 4) f32, matched labels (B, A) int32, max
    IoU (B, A) f32, per-gt best IoU (B, G) f32 and best anchor (B, G)
    int32, equal to :func:`assign_fused_plain`'s."""
    global kernel_launches, plain_calls
    _check_inputs(anchors, gt_boxes, gt_labels, gt_mask)
    device = gt_boxes.device
    tile = check_tile(tile_a)
    if device.type == "cpu":
        plain_calls += 1
        return assign_fused_plain(anchors, gt_boxes, gt_labels, gt_mask)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    (b, g), a = gt_boxes.shape[:2], anchors.shape[0]
    lib = _library()
    if g > lib.match_max_gt():
        raise ValueError(f"G = {g} exceeds the kernel's {lib.match_max_gt()}")
    for name, t in (("anchors", anchors), ("gt boxes", gt_boxes)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as float4)")
    matched_boxes = torch.empty((b, a, 4), dtype=torch.float32, device=device)
    matched_labels = torch.empty((b, a), dtype=torch.int32, device=device)
    max_iou = torch.empty((b, a), dtype=torch.float32, device=device)
    gt_best_iou = torch.empty((b, g), dtype=torch.float32, device=device)
    gt_best_anchor = torch.empty((b, g), dtype=torch.int32, device=device)
    out = (matched_boxes, matched_labels, max_iou, gt_best_iou, gt_best_anchor)
    if b == 0:
        return out
    with torch.cuda.device(device):
        keys = torch.empty((b, g), dtype=torch.int64, device=device)
        err = lib.match_launch(
            anchors.data_ptr(), gt_boxes.data_ptr(), gt_labels.data_ptr(),
            gt_mask.data_ptr(), b, a, g,
            matched_boxes.data_ptr(), matched_labels.data_ptr(), max_iou.data_ptr(),
            keys.data_ptr(), gt_best_iou.data_ptr(), gt_best_anchor.data_ptr(),
            tile, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"matching kernel launch failed: {lib.match_error_string(err).decode()}"
        )
    kernel_launches += 1
    variant_launches[tile] += 1
    return out
