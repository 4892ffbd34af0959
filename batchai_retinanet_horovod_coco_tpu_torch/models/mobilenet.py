"""MobileNetV1 backbone exposing C3, C4, C5 (strides 8/16/32), in NCHW.

The JAX package's ``models/mobilenet.py`` (keras-retinanet's mobilenet
family): a 3x3/2 stem and 13 depthwise-separable blocks, ``alpha`` the
width multiplier with every width rounded down to a multiple of 32 (at
least 32, so GroupNorm(32) holds), relu6 after each norm.  Every 3x3 conv
pads by XLA's SAME rule, (0, 1) at stride 2 on an even size, unlike the
ResNet's symmetric padding.  Submodules carry the flax names (``stem``,
``stem_norm``, ``block{i}.dw``, ``.dw_norm``, ``.pw``, ``.pw_norm``); a
depthwise kernel (3, 3, 1, C) maps to the weight (C, 1, 3, 3).  f32
parameters, ``dtype`` activations, norms in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import Conv2d, NormFactory

# (filters, stride) of the 13 blocks; C3/C4/C5 are blocks 5, 11 and 13.
BLOCKS = ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1), (512, 1),
          (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1))
TAPS = {5: "c3", 11: "c4", 13: "c5"}


class DepthwiseSeparable(nn.Module):
    """3x3 depthwise (stride) → norm → relu6 → 1x1 pointwise → norm → relu6."""

    def __init__(self, in_channels: int, filters: int, stride: int, norm: NormFactory):
        super().__init__()
        dtype = norm.dtype
        self.dw = Conv2d(in_channels, in_channels, 3, stride, "same", False, dtype, groups=in_channels)
        self.dw_norm = norm(in_channels)
        self.pw = Conv2d(in_channels, filters, 1, 1, "same", False, dtype)
        self.pw_norm = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu6(self.dw_norm(self.dw(x)))
        return F.relu6(self.pw_norm(self.pw(x)))


class MobileNetV1(nn.Module):
    """The 13-block MobileNetV1 body; returns {"c3", "c4", "c5"}."""

    def __init__(self, alpha: float = 1.0, norm_kind: str = "gn", dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        norm = NormFactory(norm_kind, dtype)

        def width(ch: int) -> int:
            return max(32, (int(ch * alpha) // 32) * 32)

        self.dtype = dtype
        self.stem = Conv2d(3, width(32), 3, 2, "same", False, dtype)
        self.stem_norm = norm(width(32))
        in_channels = width(32)
        for i, (filters, stride) in enumerate(BLOCKS, 1):
            self.add_module(f"block{i}", DepthwiseSeparable(in_channels, width(filters), stride, norm))
            in_channels = width(filters)
        self.widths = tuple(width(BLOCKS[i - 1][0]) for i in TAPS)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu6(self.stem_norm(self.stem(x.to(self.dtype))))
        features: dict[str, torch.Tensor] = {}
        for i in range(1, len(BLOCKS) + 1):
            x = getattr(self, f"block{i}")(x)
            if i in TAPS:
                features[TAPS[i]] = x
        return features
