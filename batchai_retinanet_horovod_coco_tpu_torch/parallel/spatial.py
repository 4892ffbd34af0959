"""Spatial partitioning by hand: each image's H axis over the S ranks of a
space group, what XLA's GSPMD compiles for the JAX package's
``PartitionSpec(DATA_AXIS, SPACE_AXIS)`` images (its ``parallel/mesh.py``,
``make_mesh_2d``; ``train/step.py::make_train_step_spatial``,
``evaluate/detect.py::make_detect_fn_spatial``).

A map of height h lies over the group as GSPMD splits a dimension: rank s
owns the global rows ``[s*c, min((s+1)*c, h))`` with ``c = ceil(h/S)``
(:func:`rows_of`), so trailing ranks may own no rows at all (at H 96 over
4 ranks P7 has 1 row).  The model's own modules (``models/resnet.py``'s
``Conv2d``, pools and norms, ``models/fpn.py``'s upsample) consult
:func:`current` and, inside a :func:`sharded` block, compute on their rows
through this module; outside one they run exactly as in one process.

- :func:`exchange` is the one row-exchange primitive.  Every rank of the
  group sends its row count and its first and last ``margin`` rows to every
  other (one all-gather, through the world's communication device), and
  :func:`assemble` then hands the rank the global rows it asks for,
  wherever they live, with the fill rows (0 for a conv, -inf for a max
  pool) above row 0 and below row h only: between shards there is no
  padding, only halo rows.  A row that is in no rank's margin raises.  Its
  backward sends each halo row's gradient back to its owner (an all-reduce
  of the gathered rows' gradients over the group) and adds it there.
- :func:`windowed` runs a conv or a pool on a rank's rows: the output rows
  it owns are its share of the output height, which the global h and the
  global padding give, and its first input row is ``o0*stride - pad_top``
  in global rows, so a shard boundary on an odd row never shifts the
  sampling grid.
- :func:`group_sum` and :func:`world_sum` are differentiable sums over the
  space group and over the whole world, for the norms' statistics.

The global height of a map is never carried with the tensor: each exchange
gathers the row counts with the rows, and h is their sum.  Every rank runs
the same sequence of collectives in the same order, forward and backward,
whatever rows it owns: an empty shard still exchanges, and its conv runs on
a window of fill rows whose output it cuts to zero rows, so the autograd
graph has the same shape on every rank (a rank that skipped an exchange
would leave the others waiting for ever).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist

from batchai_retinanet_horovod_coco_tpu_torch.utils.device import constant


@dataclasses.dataclass(frozen=True)
class SpaceAxis:
    """This rank's place in a (data, space) world of ``data_size`` x
    ``size`` ranks: rank ``r = data_index * size + index``.  ``group`` is
    its space group (the ``size`` ranks that hold the rows of the same
    images), ``data_group`` the ranks at its space index (one per data
    index); ``world`` is the ``launch/pod.py::World``, whose default group
    spans both axes."""

    world: object
    group: object
    index: int
    size: int
    data_group: object
    data_index: int
    data_size: int

    @property
    def comm_device(self) -> torch.device:
        return self.world.comm_device


def rows_of(h: int, size: int, index: int) -> tuple[int, int]:
    """The global rows ``[start, stop)`` of a height-``h`` map that rank
    ``index`` of ``size`` owns: GSPMD's split, ``c = ceil(h / size)`` rows
    each, the last ones short or empty."""
    c = -(-h // size)
    return min(index * c, h), min((index + 1) * c, h)


_local = threading.local()


def current() -> SpaceAxis | None:
    """The space axis of the :func:`sharded` block this thread is in, or
    None: the modules then compute as in one process."""
    return getattr(_local, "axis", None)


@contextlib.contextmanager
def sharded(axis: SpaceAxis):
    """Within the block, this thread's modules compute on row shards over
    ``axis`` (thread-local: an eval thread on a weight snapshot is not
    affected)."""
    previous = current()
    _local.axis = axis
    try:
        yield axis
    finally:
        _local.axis = previous


# Trap: the collectives on a card.  Two ranks on one card need gloo (NCCL
# refuses them a device), and gloo's collectives take host tensors: every
# collective here goes through the world's communication device (the host
# for gloo, the card for NCCL), and the exchange is an all-gather on every
# backend alike (gloo's all_to_all is not relied on for card tensors).
def _all_reduce(tensor: torch.Tensor, axis: SpaceAxis, group) -> torch.Tensor:
    staged = tensor.detach().to(axis.comm_device).contiguous()
    if staged is tensor:
        staged = staged.clone()
    dist.all_reduce(staged, group=group)
    return staged.to(tensor.device)


class _Sum(torch.autograd.Function):
    """The sum over a group, on every rank; its backward is the sum of the
    ranks' gradients (every rank's copy depends on each rank's input)."""

    @staticmethod
    def forward(ctx, tensor, axis, group):
        ctx.axis, ctx.group = axis, group
        return _all_reduce(tensor, axis, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.axis, ctx.group), None, None


def group_sum(tensor: torch.Tensor, axis: SpaceAxis) -> torch.Tensor:
    """The differentiable sum of ``tensor`` over the space group."""
    return _Sum.apply(tensor, axis, axis.group)


def world_sum(tensor: torch.Tensor, axis: SpaceAxis) -> torch.Tensor:
    """The differentiable sum of ``tensor`` over the whole world (data and
    space)."""
    return _Sum.apply(tensor, axis, None)


def psum(tensor: torch.Tensor, axis: SpaceAxis) -> torch.Tensor:
    """The plain (not differentiated) sum over the space group, as a new
    tensor on ``tensor``'s device."""
    return _all_reduce(tensor, axis, axis.group)


def all_gather(tensor: torch.Tensor, axis: SpaceAxis) -> torch.Tensor:
    """Every space rank's ``tensor`` (the same shape on each), stacked in
    index order: ``(size, *shape)`` on ``tensor``'s device."""
    staged = tensor.detach().to(axis.comm_device).contiguous()
    out = [torch.empty_like(staged) for _ in range(axis.size)]
    dist.all_gather(out, staged, group=axis.group)
    return torch.stack(out).to(tensor.device)


class _Exchange(torch.autograd.Function):
    """Forward: every rank's row count (and ``extra`` counts) and its first
    and last ``margin`` rows, gathered over the group in one all-gather of
    an f32 buffer.  Backward: the gathered rows' gradients summed over the
    group, each rank's own added back into its rows."""

    @staticmethod
    def forward(ctx, x, margin: int, axis: SpaceAxis, extra: tuple[int, ...]):
        b, c, n, w = x.shape
        k = min(margin, n)
        edges = x.new_zeros((b, c, 2 * margin, w))
        edges[:, :, :k] = x[:, :, :k]
        edges[:, :, 2 * margin - k:] = x[:, :, n - k:]
        head = torch.tensor([n, *extra], dtype=torch.float32, device=x.device)
        flat = torch.cat([head, edges.float().reshape(-1)])
        gathered = all_gather(flat, axis)
        counts = gathered[:, : head.numel()].to(torch.int64).cpu()
        edges = gathered[:, head.numel():].reshape(axis.size, b, c, 2 * margin, w).to(x.dtype)
        ctx.axis, ctx.margin, ctx.n, ctx.k = axis, margin, n, k
        ctx.mark_non_differentiable(counts)
        return edges, counts

    @staticmethod
    def backward(ctx, grad_edges, _grad_counts):
        axis, m, n, k = ctx.axis, ctx.margin, ctx.n, ctx.k
        total = _all_reduce(grad_edges.float(), axis, axis.group)[axis.index]
        grad = total.new_zeros((*total.shape[:2], n, total.shape[3]))
        grad[:, :, :k] += total[:, :, :k]
        grad[:, :, n - k:] += total[:, :, 2 * m - k:]
        return grad.to(grad_edges.dtype), None, None, None


def exchange(
    x: torch.Tensor, axis: SpaceAxis, margin: int, extra: Sequence[int] = ()
) -> tuple[torch.Tensor, list[list[int]]]:
    """The group's edge rows ``(size, B, C, 2*margin, W)`` and each rank's
    ``[rows, *extra]``; see the module docstring."""
    edges, counts = _Exchange.apply(x, int(margin), axis, tuple(int(e) for e in extra))
    return edges, counts.tolist()


def height(counts: list[list[int]], axis: SpaceAxis, column: int = 0) -> int:
    """The global height that the gathered ``counts`` give, checked against
    the split every rank must hold (a shard out of place raises)."""
    h = sum(row[column] for row in counts)
    for index, row in enumerate(counts):
        start, stop = rows_of(h, axis.size, index)
        if row[column] != stop - start:
            raise RuntimeError(
                f"space rank {index} holds {row[column]} rows of a map of height {h}; its "
                f"share over {axis.size} ranks is {stop - start}"
            )
    return h


def assemble(
    x: torch.Tensor,
    edges: torch.Tensor,
    counts: list[list[int]],
    rows: Sequence[int],
    fill: float,
    axis: SpaceAxis,
) -> torch.Tensor:
    """The global ``rows`` of the map (B, C, len(rows), W), from this rank's
    own rows ``x``, the gathered ``edges`` and ``fill`` for rows outside
    [0, h).  One gather from one pool (fill row, own rows, every rank's
    edge rows), so the graph is the same on every rank."""
    h = height(counts, axis)
    margin = edges.shape[3] // 2
    size, b, c, _, w = edges.shape
    own0, own1 = rows_of(h, axis.size, axis.index)
    base = 1 + x.shape[2]
    index = []
    for g in rows:
        if g < 0 or g >= h:
            index.append(0)
            continue
        if own0 <= g < own1:
            index.append(1 + g - own0)
            continue
        t = min(g // -(-h // axis.size), size - 1)
        t0, t1 = rows_of(h, axis.size, t)
        k = min(margin, t1 - t0)
        if g - t0 < k:
            index.append(base + t * 2 * margin + g - t0)
        elif t1 - g <= k:
            index.append(base + t * 2 * margin + 2 * margin - (t1 - g))
        else:
            raise RuntimeError(
                f"row {g} of a map of height {h} lies {g - t0} rows inside space rank {t}'s "
                f"{t1 - t0}, beyond the exchange's margin of {margin}"
            )
    pool = torch.cat([
        x.new_full((b, c, 1, w), fill),
        x,
        edges.permute(1, 2, 0, 3, 4).reshape(b, c, size * 2 * margin, w),
    ], dim=2)
    return pool.index_select(2, constant(tuple(index), torch.int64, x.device))


def windowed(
    x: torch.Tensor,
    axis: SpaceAxis,
    kernel: int,
    stride: int,
    pads: Callable[[int], tuple[int, int]],
    fill: float,
    fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """This rank's output rows of a window op (a conv or a pool) of
    ``kernel`` rows and ``stride`` over the row-sharded ``x``.  ``pads(h)``
    gives the (top, bottom) padding for the global height h (XLA's SAME
    pads (0, 1) on an even height at the image's bottom only; a symmetric
    pad applies at the global edges only), and ``fn`` applies the op to the
    assembled global rows with no padding along H.

    The margin covers every row a rank can need from another: the stride
    shifts a rank's first output row by at most ``stride - 1`` input rows
    a rank before it (``stride * ceil(h_out / S)`` exceeds ``ceil(h / S)``
    by less than ``stride``)."""
    margin = kernel + (stride - 1) * axis.size
    edges, counts = exchange(x, axis, margin)
    h = height(counts, axis)
    top, bottom = pads(h)
    h_out = max((h + top + bottom - kernel) // stride + 1, 0)
    o0, o1 = rows_of(h_out, axis.size, axis.index)
    n_out = o1 - o0
    if n_out:
        first = o0 * stride - top  # global rows: the grid stays the global one
        rows = range(first, first + (n_out - 1) * stride + kernel)
    else:
        # No rows to own: one window of fill rows, its output cut to
        # nothing (the graph keeps its shape; see the module docstring).
        rows = [-1] * kernel
    return fn(assemble(x, edges, counts, rows, fill, axis))[:, :, :n_out]

