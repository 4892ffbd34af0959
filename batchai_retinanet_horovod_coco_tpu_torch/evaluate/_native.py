"""ctypes bindings of the COCOeval helpers in ``native/cocoeval.cpp``: the
pairwise IoU and the greedy matching that ``evaluate/coco_eval.py`` scores
with.  The library is built by ``native/build.py`` at the first call; a
missing ``g++`` or a failed build raises.  There is no fallback: the numpy
functions of ``coco_eval.py`` (``numpy_bbox_iou_xywh``,
``numpy_match_detections``) are the oracle the tests hold these to, bit
for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.native import build

_i64 = ctypes.POINTER(ctypes.c_int64)
_f64 = ctypes.POINTER(ctypes.c_double)
_u8 = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _library() -> ctypes.CDLL:
    """The helper library, built at the first call, with its C signatures."""
    lib = build.load("cocoeval")
    lib.iou_matrix_xywh.argtypes = [_f64, ctypes.c_int64, _f64, ctypes.c_int64, _u8, _f64]
    lib.iou_matrix_xywh.restype = None
    lib.match_detections.argtypes = [
        _f64, ctypes.c_int64, ctypes.c_int64, _f64, ctypes.c_int64, _u8, _u8, _i64, _i64, _u8,
    ]
    lib.match_detections.restype = None
    return lib


def _as(arr: np.ndarray, dtype, ptr_type):
    a = np.ascontiguousarray(arr, dtype=dtype)
    return a, a.ctypes.data_as(ptr_type)


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """(D, G) crowd-aware IoU of xywh boxes ``dt`` (D, 4) and ``gt`` (G, 4)."""
    d, g = len(dt), len(gt)
    out = np.zeros((d, g), dtype=np.float64)
    if d and g:
        # The contiguous copies stay referenced (``*_a``) across the call.
        dt_a, dt_p = _as(dt, np.float64, _f64)
        gt_a, gt_p = _as(gt, np.float64, _f64)
        cr_a, cr_p = _as(iscrowd, np.uint8, _u8)
        _library().iou_matrix_xywh(dt_p, d, gt_p, g, cr_p, out.ctypes.data_as(_f64))
    return out


def match_detections(
    ious: np.ndarray, iou_thrs: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The greedy matcher over score-sorted dets and ignore-sorted gts:
    ``(dtm (T, D), gtm (T, G), dt_ignore (T, D))``."""
    d, g = ious.shape
    t = len(iou_thrs)
    dtm = np.empty((t, d), dtype=np.int64)
    gtm = np.empty((t, g), dtype=np.int64)
    dt_ignore = np.empty((t, d), dtype=np.uint8)
    io_a, io_p = _as(ious, np.float64, _f64)
    th_a, th_p = _as(iou_thrs, np.float64, _f64)
    gi_a, gi_p = _as(g_ignore, np.uint8, _u8)
    gc_a, gc_p = _as(g_crowd, np.uint8, _u8)
    _library().match_detections(
        io_p, d, g, th_p, t, gi_p, gc_p,
        dtm.ctypes.data_as(_i64), gtm.ctypes.data_as(_i64), dt_ignore.ctypes.data_as(_u8),
    )
    return dtm, gtm, dt_ignore.astype(bool)
