"""Fused focal loss on Hopper: the wrapper of ``ops/cuda/focal.cu``.

Replaces the TPU kernels ``batchai_retinanet_horovod_coco_tpu/ops/pallas/
focal.py::_call_fwd`` (``pl.pallas_call`` at line 143, body ``_fwd_kernel``)
and ``_call_bwd`` (line 183, body ``_bwd_kernel``), and their
``custom_vjp`` (``focal_loss_per_image_sums``) with a
``torch.autograd.Function``: the forward kernel gives the per-image sums
(B,) of the exp-form focal loss over non-ignored anchors, the backward
kernel dL/dlogits from the closed form scaled by the incoming per-image
cotangent, recomputed from the inputs (no other residuals).  The one-hot
target ``(state == 1) & (label == k)`` is rebuilt inside both kernels.

What bounds them on this card: bytes.  The forward reads the (B, A, K) f32
logits once (1.03 GB at B 16, A 201 600, K 80: some 0.32 ms at 3.35 TB/s)
and the backward reads them and writes the gradient (some 0.62 ms).  Both
stream the logits with 16-byte loads when K is a multiple of 4; the forward
reduces per block and then per image in a fixed order, so its sums repeat
bit for bit.

On CPU tensors the wrapper runs the plain version (``losses.
focal_sums_compact``, differentiated by autograd); on CUDA tensors it
launches the kernels or raises.  ``fwd_launches``, ``bwd_launches`` and
``plain_calls`` count which ran.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import build

#: Launches of the forward kernel pair (partials + reduce), one per call.
fwd_launches = 0
#: Launches of the backward kernel, one per backward pass.
bwd_launches = 0
#: Calls that took the plain version because the tensors were on the CPU.
plain_calls = 0


def reset_counts() -> None:
    global fwd_launches, bwd_launches, plain_calls
    fwd_launches = 0
    bwd_launches = 0
    plain_calls = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernel library (built on first use) with its C signatures."""
    lib = build.load("focal")
    common = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_float, ctypes.c_float, ctypes.c_float]
    lib.focal_fwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, *common,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.focal_fwd_launch.restype = ctypes.c_int
    lib.focal_bwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, *common,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.focal_bwd_launch.restype = ctypes.c_int
    for name in ("focal_threads", "focal_items"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.focal_error_string.argtypes = [ctypes.c_int]
    lib.focal_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(logits, labels, state) -> None:
    if logits.dim() != 3:
        raise ValueError(f"logits must be (B, A, K), got {tuple(logits.shape)}")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise TypeError(f"logits must be contiguous float32, got {logits.dtype}")
    b, a, _ = logits.shape
    for name, t in (("labels", labels), ("state", state)):
        if tuple(t.shape) != (b, a):
            raise ValueError(f"{name} must be {(b, a)}, got {tuple(t.shape)}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32, got {t.dtype}")
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")


def focal_sums_plain(logits, labels, state, alpha: float = 0.25, gamma: float = 2.0):
    """The plain version: ``losses.focal_sums_compact`` (f64 for f64 logits)."""
    from batchai_retinanet_horovod_coco_tpu_torch import losses  # losses imports this module

    config = losses.LossConfig(focal_alpha=alpha, focal_gamma=gamma)
    return losses.focal_sums_compact(logits, labels, state, config)


def _launch_args(logits, alpha, gamma):
    b, a, k = logits.shape
    vec = 4 if k % 4 == 0 and logits.data_ptr() % 16 == 0 else 1
    return (b, a, k, vec, float(alpha), 1.0 - float(alpha), float(gamma))


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"focal {what} kernel launch failed: "
                           f"{lib.focal_error_string(err).decode()}")


def focal_fwd(logits, labels, state, alpha: float, gamma: float) -> torch.Tensor:
    """Per-image sums (B,) from the forward kernel (CUDA tensors only)."""
    global fwd_launches
    lib = _library()
    b, a, k, vec, *consts = _launch_args(logits, alpha, gamma)
    per_block = lib.focal_threads() * lib.focal_items()
    blocks = -(-(a * k // vec) // per_block)
    device = logits.device
    sums = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0 or a == 0:
        return sums.zero_()
    with torch.cuda.device(device):
        partials = torch.empty((b, blocks), dtype=torch.float32, device=device)
        err = lib.focal_fwd_launch(
            logits.data_ptr(), labels.data_ptr(), state.data_ptr(), b, a, k, vec, *consts,
            partials.data_ptr(), sums.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check(lib, err, "forward")
    fwd_launches += 1
    return sums


def focal_bwd(logits, labels, state, cotangent, alpha: float, gamma: float) -> torch.Tensor:
    """dL/dlogits (B, A, K) scaled by ``cotangent`` (B,), from the backward
    kernel (CUDA tensors only)."""
    global bwd_launches
    lib = _library()
    b, a, k, vec, *consts = _launch_args(logits, alpha, gamma)
    device = logits.device
    grad = torch.empty_like(logits)
    if b == 0 or a == 0:
        return grad
    cotangent = cotangent.to(device=device, dtype=torch.float32).contiguous()
    with torch.cuda.device(device):
        err = lib.focal_bwd_launch(
            logits.data_ptr(), labels.data_ptr(), state.data_ptr(), cotangent.data_ptr(),
            b, a, k, vec, *consts, grad.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check(lib, err, "backward")
    bwd_launches += 1
    return grad


class _FocalSums(torch.autograd.Function):
    """The kernels under autograd; gradients flow to the logits only."""

    @staticmethod
    def forward(ctx, logits, labels, state, alpha, gamma):
        ctx.save_for_backward(logits, labels, state)
        ctx.alpha, ctx.gamma = alpha, gamma
        return focal_fwd(logits, labels, state, alpha, gamma)

    @staticmethod
    def backward(ctx, cotangent):
        logits, labels, state = ctx.saved_tensors
        grad = focal_bwd(logits, labels, state, cotangent, ctx.alpha, ctx.gamma)
        return grad, None, None, None, None


def focal_loss_per_image_sums(
    logits: torch.Tensor,
    labels: torch.Tensor,
    state: torch.Tensor,
    alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Per-image focal-loss sums (B,) over non-ignored anchors, differentiable
    in ``logits``.  logits (B, A, K) contiguous f32; labels and state (B, A)
    contiguous int32, state in {-1 ignore, 0 negative, 1 positive}."""
    global plain_calls
    _check_inputs(logits, labels, state)
    device = logits.device
    if device.type == "cpu":
        plain_calls += 1
        return focal_sums_plain(logits, labels, state, alpha, gamma)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _FocalSums.apply(logits, labels, state, alpha, gamma)
