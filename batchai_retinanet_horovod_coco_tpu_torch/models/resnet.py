"""ResNet backbone (v1.5 bottleneck) exposing C3, C4, C5, in NCHW.

The JAX package's ``models/resnet.py``: symmetric k//2 padding (torch
geometry, spatial sizes ceil(H/stride)), a plain 7x7/2 stem with (3, 3)
padding and a 3x3/2 max pool with (1, 1) padding, and a pluggable norm:

- ``"gn"``: GroupNorm(32), eps 1e-6 (flax's default, not torch's 1e-5);
- ``"bn"``: BatchNorm, eps 1e-5; in training mode (``module.train()``) it
  normalizes with the batch's statistics and updates the running ones as
  flax does (momentum 0.9, the biased variance), in eval mode it uses the
  running statistics;
- ``"frozen_bn"``: BatchNorm over the running statistics in either mode.

The JAX package's ``space_to_depth`` stems and ``pack_width`` stage are
exact TPU reformulations of the plain stem and stage 2 over the same
parameter tree (its ``models/resnet.py``, ``StemConv`` and the
width-packing block), so the one plain stem and stage here compute every
``stem`` and ``pack_width`` setting of a checkpoint.  The shapes the JAX
model refuses for a setting (H or W not divisible by the fold, an odd
stage-2 width when packed) raise the same ``ValueError`` here, so a command
line behaves the same in both packages.

``Conv2d``, the norms, ``NormFactory``, :func:`max_pool` and
:func:`avg_pool` are shared by the other backbones (``mobilenet.py``,
``vgg.py``, ``densenet.py``), as in the JAX package.  ``stem_pool="avg"``
is the JAX package's tie-free diagnostic stem: flax's ``avg_pool`` with
(1, 1) padding, whose pads count in the divisor (``count_include_pad``).

Inside a ``parallel/spatial.py::sharded`` block each of them computes on
this rank's rows of a map whose H axis lies over a space group: the convs
and pools through the row exchange, the norms with their statistics summed
over the ranks that share the images.  Outside one they are the one-process
code, unchanged.

Parameters stay f32; activations follow ``dtype`` (bf16 by default): each
conv casts its input and weights to ``dtype``, each norm computes in f32
and casts back, as flax does.  Submodules are named after the flax scopes
(``stem_conv``, ``stage2_block0.conv1``, ``proj_norm``, ...) so weights map
mechanically (models/convert.py).
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.parallel import spatial


def same_pads(h: int, w: int, kernel_size: int, stride: int) -> tuple[int, int, int, int]:
    """XLA's SAME padding of an (h, w) input as (left, right, top, bottom)
    for ``F.pad``: ceil(n / stride) outputs, the odd pixel after (so a
    stride-2 3x3 window on an even size pads (0, 1))."""
    pads = []
    for n in (w, h):
        total = max((-(-n // stride) - 1) * stride + kernel_size - n, 0)
        pads += [total // 2, total - total // 2]
    return tuple(pads)


class Conv2d(nn.Module):
    """Conv with f32 parameters computing in ``dtype``.

    ``padding`` is ((top, bottom), (left, right)), or ``"same"`` for XLA's
    SAME rule (for stride 2 on an even size that pads (0, 1), where torch's
    symmetric ``padding=1`` would pad (1, 1)).  ``groups`` is flax's
    ``feature_group_count``: ``groups == in_channels`` is a depthwise conv,
    whose flax kernel (k, k, 1, C) is this weight (C, 1, k, k).
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        stride: int = 1,
        padding: tuple[tuple[int, int], tuple[int, int]] | str = ((0, 0), (0, 0)),
        bias: bool = True,
        dtype: torch.dtype = torch.bfloat16,
        groups: int = 1,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def _pads(self, h: int, w: int) -> tuple[int, int, int, int]:
        """(left, right, top, bottom) for ``F.pad``."""
        if self.padding != "same":
            (top, bottom), (left, right) = self.padding
            return left, right, top, bottom
        return same_pads(h, w, self.kernel_size, self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = spatial.current()
        if axis is not None:
            return self._forward_rows(x, axis)
        left, right, top, bottom = self._pads(x.shape[-2], x.shape[-1])
        x = x.to(self.dtype)
        if left == right and top == bottom:
            pad = (top, left)
        else:
            x = F.pad(x, (left, right, top, bottom))
            pad = (0, 0)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride, pad, 1, self.groups)

    def _forward_rows(self, x: torch.Tensor, axis: spatial.SpaceAxis) -> torch.Tensor:
        """This rank's output rows of the conv of the row-sharded ``x``.

        Trap: SAME and symmetric padding are in global coordinates.  The
        (top, bottom) pads come from the global height (SAME pads (0, 1) on
        an even height, at the image's bottom only; the stem's 3 and a 3x3's
        1 at the global edges only); between shards there are halo rows, no
        padding (``spatial.windowed``).  W is not sharded and pads as in
        one process."""
        x = x.to(self.dtype)
        weight = self.weight.to(self.dtype)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        width = x.shape[-1]
        left, right = self._pads(1, width)[:2]

        def conv(rows: torch.Tensor) -> torch.Tensor:
            if left == right:
                return F.conv2d(rows, weight, bias, self.stride, (0, left), 1, self.groups)
            return F.conv2d(F.pad(rows, (left, right, 0, 0)), weight, bias, self.stride, 0, 1,
                            self.groups)

        if self.kernel_size == 1 and self.stride == 1 and self._pads(1, width)[2:] == (0, 0):
            # A 1x1 conv needs no other rank's rows.  Trap: a rank that owns
            # no rows still runs it, on one zero row cut away after, so its
            # input stays in the graph (the exchanges before it must run
            # their backward on every rank).
            if x.shape[2]:
                return conv(x)
            return conv(F.pad(x, (0, 0, 0, 1)))[:, :, :0]
        return spatial.windowed(x, axis, self.kernel_size, self.stride,
                                lambda h: self._pads(h, width)[2:], 0.0, conv)


def max_pool(x: torch.Tensor, kernel_size: int, stride: int, padding: str = "valid") -> torch.Tensor:
    """flax's ``nn.max_pool`` over NCHW ``x``: ``"valid"`` (no padding,
    floor(n / stride) windows) or ``"same"`` (XLA's SAME rule, padded with
    -inf so padding never wins the max)."""
    axis = spatial.current()
    if axis is not None:
        if padding not in ("same", "valid"):
            raise ValueError(f"unknown pooling padding: {padding!r}")
        width = x.shape[-1]
        pads = same_pads(1, width, kernel_size, stride) if padding == "same" else (0, 0)

        def pool(rows: torch.Tensor) -> torch.Tensor:
            rows = F.pad(rows, (pads[0], pads[1], 0, 0), value=float("-inf"))
            return F.max_pool2d(rows, kernel_size, stride)

        def vertical(h: int) -> tuple[int, int]:
            return same_pads(h, width, kernel_size, stride)[2:] if padding == "same" else (0, 0)

        return spatial.windowed(x, axis, kernel_size, stride, vertical, float("-inf"), pool)
    if padding == "same":
        x = F.pad(x, same_pads(x.shape[-2], x.shape[-1], kernel_size, stride), value=float("-inf"))
    elif padding != "valid":
        raise ValueError(f"unknown pooling padding: {padding!r}")
    return F.max_pool2d(x, kernel_size, stride)


def avg_pool(x: torch.Tensor, kernel_size: int, stride: int) -> torch.Tensor:
    """``F.avg_pool2d(x, kernel_size, stride)``: a VALID average pool (the
    DenseNet transitions'), on row shards too."""
    axis = spatial.current()
    if axis is None:
        return F.avg_pool2d(x, kernel_size, stride)
    return spatial.windowed(x, axis, kernel_size, stride, lambda h: (0, 0), 0.0,
                            lambda rows: F.avg_pool2d(rows, kernel_size, stride))


#: The ResNet stem's downsample: the 3x3/2 max pool, or the JAX package's
#: tie-free diagnostic average pool.
STEM_POOLS = ("max", "avg")


def stem_pool(x: torch.Tensor, kind: str = "max") -> torch.Tensor:
    """The ResNet stem's 3x3/2 pool with (1, 1) padding: ``"max"`` pads
    with -inf (padding never wins the max), ``"avg"`` with zeros that count
    in the divisor (flax's ``avg_pool``, ``count_include_pad``).

    Trap: a max window that straddles a shard boundary sees the same values
    in the same order as in one process, so its gradient goes to the same
    element there."""
    axis = spatial.current()
    if kind == "max":
        if axis is None:
            return F.max_pool2d(x, 3, 2, 1)
        return spatial.windowed(x, axis, 3, 2, lambda h: (1, 1), float("-inf"),
                                lambda rows: F.max_pool2d(rows, 3, 2, (0, 1)))
    if axis is None:
        return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
    return spatial.windowed(x, axis, 3, 2, lambda h: (1, 1), 0.0,
                            lambda rows: F.avg_pool2d(rows, 3, 2, (0, 1), count_include_pad=True))


def symmetric(k: int) -> tuple[tuple[int, int], tuple[int, int]]:
    return ((k // 2, k // 2), (k // 2, k // 2))


class GroupNorm(nn.Module):
    """GroupNorm(32), eps 1e-6, computed in f32, output in ``dtype``."""

    def __init__(self, channels: int, dtype: torch.dtype, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = spatial.current()
        if axis is not None:
            return self._forward_rows(x.float(), axis).to(self.dtype)
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, 1e-6)
        return y.to(self.dtype)

    def _forward_rows(self, x: torch.Tensor, axis: spatial.SpaceAxis) -> torch.Tensor:
        """GroupNorm of the row-sharded ``x``.  Trap: ``F.group_norm``
        cannot be called on a shard.  Each image's statistics over (C/G, H,
        W) are sums over the space group (f64 on the wire, the element
        count with them): the mean first, then the centred sum of squares,
        as ``F.group_norm`` takes them; the backward goes through both
        sums."""
        b, c, n, w = x.shape
        xg = x.reshape(b, self.num_groups, -1)
        local = torch.cat([xg.sum(-1).reshape(-1).double(),
                           torch.tensor([float(xg.shape[-1])], dtype=torch.float64,
                                        device=x.device)])
        total = spatial.group_sum(local, axis)
        count = total[-1]
        mean = (total[:-1] / count).float().reshape(b, self.num_groups, 1)
        centred = xg - mean
        var = (spatial.group_sum((centred * centred).sum(-1).reshape(-1).double(), axis)
               / count).float().reshape(b, self.num_groups, 1)
        y = (centred * torch.rsqrt(var + 1e-6)).reshape(b, c, n, w)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class BatchNorm(nn.Module):
    """BatchNorm, eps 1e-5, computed in f32, output in ``dtype``.

    In training mode (unless ``frozen``) the statistics are the batch's, as
    flax's ``nn.BatchNorm`` computes them: ``mean`` and ``mean(x^2) - mean^2``
    (the biased variance, floored at 0) over (B, H, W), and the running
    statistics move by ``0.9 * running + 0.1 * batch``.  The update is done
    here by hand: ``F.batch_norm(training=True)`` would weight the batch by
    its ``momentum`` (torch's 0.1 is flax's 1 - 0.9) and store the unbiased
    variance, n / (n - 1) times flax's.
    """

    MOMENTUM = 0.9

    def __init__(self, channels: int, dtype: torch.dtype, frozen: bool = False):
        super().__init__()
        self.dtype = dtype
        self.frozen = frozen
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.frozen or not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axis = spatial.current()
            if axis is None:
                mean = xf.mean(dim=(0, 2, 3))
                var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            else:
                mean, var = self._batch_statistics(xf, axis)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)

    @staticmethod
    def _batch_statistics(xf: torch.Tensor, axis: spatial.SpaceAxis
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """Trap: in training the statistics are over (B, H, W) of the global
        batch, data and space together: the sums of x and x^2 and the
        element count summed over the whole world, in the ``E[x^2] -
        mean^2`` form of the one-process path, so every rank makes the same
        running-statistics update."""
        c = xf.shape[1]
        local = torch.cat([xf.sum(dim=(0, 2, 3)).double(), (xf * xf).sum(dim=(0, 2, 3)).double(),
                           torch.tensor([float(xf.numel() // c)], dtype=torch.float64,
                                        device=xf.device)])
        total = spatial.world_sum(local, axis)
        mean = (total[:c] / total[-1]).float()
        var = torch.clamp_min((total[c:2 * c] / total[-1]).float() - mean * mean, 0.0)
        return mean, var


class NormFactory:
    """Builds the configured norm layer; see the module docstring."""

    def __init__(self, kind: str, dtype: torch.dtype):
        if kind not in ("gn", "bn", "frozen_bn"):
            raise ValueError(f"unknown norm kind: {kind!r}")
        self.kind = kind
        self.dtype = dtype

    def __call__(self, channels: int) -> nn.Module:
        if self.kind == "gn":
            return GroupNorm(channels, self.dtype)
        return BatchNorm(channels, self.dtype, frozen=self.kind == "frozen_bn")


class BottleneckBlock(nn.Module):
    """1x1 → 3x3(stride) → 1x1(x4) with a projection shortcut on block 0."""

    def __init__(
        self,
        in_channels: int,
        filters: int,
        stride: int,
        norm: NormFactory,
        project: bool,
    ):
        super().__init__()
        dtype = norm.dtype
        out = filters * 4
        self.conv1 = Conv2d(in_channels, filters, 1, 1, symmetric(1), False, dtype)
        self.norm1 = norm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, symmetric(3), False, dtype)
        self.norm2 = norm(filters)
        self.conv3 = Conv2d(filters, out, 1, 1, symmetric(1), False, dtype)
        self.norm3 = norm(out)
        if project:
            self.proj = Conv2d(in_channels, out, 1, stride, symmetric(1), False, dtype)
            self.proj_norm = norm(out)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        residual = x if self.proj is None else self.proj_norm(self.proj(x))
        return F.relu(y + residual)


# The JAX package's stem formulations (one parameter layout, one math).
STEMS = ("conv", "space_to_depth", "space_to_depth4")


class ResNet(nn.Module):
    """ResNet exposing {"c3", "c4", "c5"} (strides 8/16/32) in NCHW.

    ``stem`` and ``pack_width`` name the JAX package's formulations; each
    is computed here with the plain stem and stage 2, after the JAX model's
    shape checks.  ``stem_pool`` is ``"max"`` or the diagnostic ``"avg"``
    (:func:`stem_pool`), which the JAX model takes with ``stem="conv"``
    only."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        norm_kind: str = "gn",
        dtype: torch.dtype = torch.bfloat16,
        stem: str = "conv",
        pack_width: bool = False,
        stem_pool: str = "max",
    ):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem: {stem!r}")
        if stem_pool not in STEM_POOLS:
            raise ValueError(f"unknown stem_pool: {stem_pool!r}")
        if stem_pool == "avg" and stem != "conv":
            raise ValueError(
                "stem_pool='avg' (the tie-free diagnostic pool) is only "
                "supported with stem='conv' — the packed stem layouts bake "
                "in the maxpool (maxpool_packed_w)"
            )
        norm = NormFactory(norm_kind, dtype)
        self.dtype = dtype
        self.stem = stem
        self.pack_width = pack_width
        self.stem_pool = stem_pool
        self.widths = tuple(64 * 4 * 2**i for i in range(1, 4))  # C3, C4, C5
        self.stem_conv = Conv2d(3, 64, 7, 2, symmetric(7), False, dtype)
        self.stem_norm = norm(64)
        self.stage_names: list[list[str]] = []
        in_channels, filters = 64, 64
        for stage, num_blocks in enumerate(stage_sizes):
            names = []
            for block in range(num_blocks):
                name = f"stage{stage + 2}_block{block}"
                self.add_module(name, BottleneckBlock(
                    in_channels,
                    filters,
                    stride=(1 if stage == 0 else 2) if block == 0 else 1,
                    norm=norm,
                    project=block == 0,
                ))
                names.append(name)
                in_channels = filters * 4
            self.stage_names.append(names)
            filters *= 2

    def check_shape(self, h: int, w: int) -> None:
        """The JAX model's refusal of an image shape its ``stem`` cannot
        fold; the spatial factories call it with the global shape."""
        if self.stem != "conv":
            block = 4 if self.stem == "space_to_depth4" else 2
            if h % block or w % block:
                raise ValueError(
                    f"space_to_depth({block}) stem needs H, W divisible by "
                    f"{block}; got {(h, w)}"
                )

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        if spatial.current() is None:  # a shard's H is not the image's
            self.check_shape(*x.shape[-2:])
        x = F.relu(self.stem_norm(self.stem_conv(x.to(self.dtype))))
        x = stem_pool(x, self.stem_pool)
        if self.pack_width and x.shape[-1] % 2:
            raise ValueError(
                f"pack_width needs an even stage2 width; got "
                f"{x.shape[-1]} (make W divisible by 8)"
            )
        features: dict[str, torch.Tensor] = {}
        for stage, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            if stage >= 1:  # C3 at stride 8, C4 at 16, C5 at 32
                features[f"c{stage + 2}"] = x
        return features


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default conv init: truncated normal, variance 1 / fan_in."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    # std of a unit normal truncated to [-2, 2], as flax's variance_scaling.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)
