"""Feature Pyramid Network producing P3..P7 from C3..C5, in NCHW.

The JAX package's ``models/fpn.py``: lateral 1x1 convs, a nearest-neighbour
top-down pathway resized to the exact lateral shape, 3x3 output convs, P6 a
stride-2 conv on C5 and P7 a stride-2 conv on relu(P6).  Every conv uses
XLA's SAME padding, which for the stride-2 P6/P7 convs on an even size pads
(0, 1) (``Conv2d(padding="same")``).

Inside a ``parallel/spatial.py::sharded`` block the maps are row shards
and the top-down resize reads its source rows through the row exchange
(:func:`upsample_like`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import Conv2d
from batchai_retinanet_horovod_coco_tpu_torch.parallel import spatial
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import constant


def _nearest_indices(src: int, dst: int) -> tuple[int, ...]:
    """Source index of each output position of a half-pixel nearest resize,
    in f32 as XLA compiles ``jax.image.resize``: its floor((i + 0.5) * src
    / dst) becomes a multiply by the folded constant src * (1 / dst).  In
    exact arithmetic this is torch's ``"nearest-exact"`` (not
    ``"nearest"``), but the f32 rounding picks another source row on some
    sizes (50 -> 99: a C5 -> C4 upsample of a 1584-row input)."""
    i = np.arange(dst, dtype=np.float32) + np.float32(0.5)
    step = np.float32(np.float32(src) * (np.float32(1.0) / np.float32(dst)))
    return tuple(np.floor(i * step).astype(int).tolist())


def upsample_to(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``x`` to spatial size ``hw``."""
    for dim, (src, dst) in ((2, (x.shape[2], hw[0])), (3, (x.shape[3], hw[1]))):
        if src != dst:
            idx = constant(_nearest_indices(src, dst), torch.int64, x.device)
            x = x.index_select(dim, idx)
    return x


def upsample_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """:func:`upsample_to` ``ref``'s spatial size, on row shards too.

    Trap: the source rows are ``_nearest_indices`` of the *global* heights
    (its f32 folded constant differs from exact arithmetic on some sizes),
    and a rank's output rows (its share of ``ref``'s height) may read
    source rows that another rank owns: they come through the exchange,
    which also gathers ``ref``'s row counts for its global height."""
    axis = spatial.current()
    if axis is None:
        return upsample_to(x, ref.shape[2:])
    # Source rows lie within S + 1 rows of the owner's edge: a rank's first
    # output row maps to s * ceil(h_ref / S) * h_x / h_ref, at most s rows
    # from s * ceil(h_x / S).
    edges, counts = spatial.exchange(x, axis, axis.size + 2, extra=(ref.shape[2],))
    src = spatial.height(counts, axis)
    dst = spatial.height(counts, axis, column=1)
    o0, o1 = spatial.rows_of(dst, axis.size, axis.index)
    rows = _nearest_indices(src, dst)[o0:o1] if src != dst else range(o0, o1)
    y = spatial.assemble(x, edges, counts, rows, 0.0, axis)
    return upsample_to(y, (o1 - o0, ref.shape[3]))


class FPN(nn.Module):
    """C3..C5 → P3..P7, all with ``channels`` features."""

    def __init__(
        self,
        in_channels: tuple[int, int, int] = (512, 1024, 2048),
        channels: int = 256,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        c3, c4, c5 = in_channels

        def conv(cin: int, k: int, s: int) -> Conv2d:
            return Conv2d(cin, channels, k, s, "same", True, dtype)

        self.lateral_c5 = conv(c5, 1, 1)
        self.lateral_c4 = conv(c4, 1, 1)
        self.lateral_c3 = conv(c3, 1, 1)
        self.out_p3 = conv(channels, 3, 1)
        self.out_p4 = conv(channels, 3, 1)
        self.out_p5 = conv(channels, 3, 1)
        self.out_p6 = conv(c5, 3, 2)
        self.out_p7 = conv(channels, 3, 2)

    def forward(self, features: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        c3, c4, c5 = features["c3"], features["c4"], features["c5"]
        m5 = self.lateral_c5(c5)
        m4 = self.lateral_c4(c4)
        m3 = self.lateral_c3(c3)
        m4 = m4 + upsample_like(m5, m4)
        m3 = m3 + upsample_like(m4, m3)
        p6 = self.out_p6(c5)
        return {
            "p3": self.out_p3(m3),
            "p4": self.out_p4(m4),
            "p5": self.out_p5(m5),
            "p6": p6,
            "p7": self.out_p7(torch.relu(p6)),
        }
