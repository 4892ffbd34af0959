"""Device resolution for the port's entry points: CUDA by default, never a
silent fallback to the CPU."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is present (callers that want the CPU ask for it explicitly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=256)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor on ``device``, made once and shared (do not
    write to it): made anew on every call it would be copied from pageable
    host memory, which on a card waits for the stream.  It is made outside
    inference mode even when first asked for inside it (serving), so that
    autograd may save it later (training)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
