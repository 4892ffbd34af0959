"""DenseNet-BC backbone exposing C3, C4, C5 (strides 8/16/32), in NCHW.

The JAX package's ``models/densenet.py`` (keras-retinanet's densenet
family): growth 32, a 64-wide 7x7/2 stem and a 3x3/2 max pool, both
padded by XLA's SAME rule ((2, 3) and (0, 1) on an even size; the pool's
padding is -inf), dense layers of norm → relu → 1x1 (4 · growth) → norm →
relu → 3x3 (growth) whose output is concatenated to their input, and
transitions of a 1x1 conv to half the width and a 2x2/2 average pool.
Each block ends in a shared ``block{n}_out_norm`` and relu, which feeds
both the C-tap (blocks 2-4) and the transition.  Submodules carry the
flax names (``stem_conv``, ``block{n}_layer{l}.conv1``, ``transition{n}_conv``,
...).  f32 parameters, ``dtype`` activations, norms in f32.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import Conv2d, NormFactory, max_pool

# Layers per dense block of each variant (growth 32, init 64, compression 0.5).
DENSENET_STAGES = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}


class DenseLayer(nn.Module):
    """norm → relu → 1x1 (4 · growth) → norm → relu → 3x3 (growth); concat."""

    def __init__(self, in_channels: int, growth: int, norm: NormFactory):
        super().__init__()
        dtype = norm.dtype
        self.norm1 = norm(in_channels)
        self.conv1 = Conv2d(in_channels, 4 * growth, 1, 1, "same", False, dtype)
        self.norm2 = norm(4 * growth)
        self.conv2 = Conv2d(4 * growth, growth, 3, 1, "same", False, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        y = self.conv2(F.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class DenseNet(nn.Module):
    """DenseNet-BC; ``stage_sizes`` = layers per dense block (4 blocks)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        growth: int = 32,
        init_features: int = 64,
        norm_kind: str = "gn",
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        norm = NormFactory(norm_kind, dtype)
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        self.stem_conv = Conv2d(3, init_features, 7, 2, "same", False, dtype)
        self.stem_norm = norm(init_features)
        width = init_features
        widths = []
        for block, num_layers in enumerate(self.stage_sizes, 1):
            for layer in range(num_layers):
                self.add_module(f"block{block}_layer{layer}", DenseLayer(width, growth, norm))
                width += growth
            self.add_module(f"block{block}_out_norm", norm(width))
            widths.append(width)
            if block < len(self.stage_sizes):
                self.add_module(f"transition{block}_conv", Conv2d(width, width // 2, 1, 1, "same", False, dtype))
                width //= 2
        self.widths = tuple(widths[1:])

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.relu(self.stem_norm(self.stem_conv(x.to(self.dtype))))
        x = max_pool(x, 3, 2, "same")  # stride 4
        features: dict[str, torch.Tensor] = {}
        for block, num_layers in enumerate(self.stage_sizes, 1):
            for layer in range(num_layers):
                x = getattr(self, f"block{block}_layer{layer}")(x)
            x = F.relu(getattr(self, f"block{block}_out_norm")(x))
            if block >= 2:  # blocks 2/3/4 at strides 8/16/32
                features[f"c{block + 1}"] = x
            if block < len(self.stage_sizes):
                x = F.avg_pool2d(getattr(self, f"transition{block}_conv")(x), 2, 2)
        return features
