"""Device resolution for the port's entry points (CUDA by default, never a
silent fallback to the CPU), and the staged host-to-device copy that the
training loop's and the eval driver's prefetch threads share."""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
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


class Staged(NamedTuple):
    """Tensors whose copy to the device was started on a side stream;
    ``ready`` is recorded after the copy (None on the CPU)."""

    tensors: dict[str, torch.Tensor]
    ready: torch.cuda.Event | None


def stage(arrays: Mapping[str, np.ndarray], device: torch.device,
          stream: torch.cuda.Stream | None) -> Staged:
    """Start copying host ``arrays`` to ``device`` without waiting: on a
    card each is pinned (a copy from pageable memory would be synchronous)
    and copied on ``stream``.  Meant for a prefetch thread; the consumer
    calls :func:`take`."""
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    if device.type != "cuda":
        return Staged({k: v.to(device) for k, v in host.items()}, None)
    with torch.cuda.stream(stream):
        tensors = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
        ready = torch.cuda.Event()
        ready.record(stream)
    return Staged(tensors, ready)


def take(staged: Staged) -> dict[str, torch.Tensor]:
    """The staged tensors, for use on the current stream: it waits for the
    copy, and each tensor is recorded as used there, so that the caching
    allocator does not hand its memory out again while that stream may
    still read it."""
    if staged.ready is not None:
        current = torch.cuda.current_stream()
        current.wait_event(staged.ready)
        for t in staged.tensors.values():
            t.record_stream(current)
    return staged.tensors
