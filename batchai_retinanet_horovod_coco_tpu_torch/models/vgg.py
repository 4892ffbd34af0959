"""VGG-16/19 backbone exposing C3, C4, C5 (strides 8/16/32), in NCHW.

The JAX package's ``models/vgg.py`` (keras-retinanet's vgg backbone): five
blocks of 3x3 convs with biases and relu, no norm layers (the model's
``norm_kind`` is accepted and ignored, as in JAX), each block closed by a
2x2/2 VALID max pool; C3-C5 are the pools after blocks 3-5.  Submodules
carry the flax names (``block{b}_conv{i}``).  f32 parameters, ``dtype``
activations.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import Conv2d, max_pool

WIDTHS = (64, 128, 256, 512, 512)
VGG_STAGES = {"vgg16": (2, 2, 3, 3, 3), "vgg19": (2, 2, 4, 4, 4)}


class VGG(nn.Module):
    """VGG body; returns {"c3", "c4", "c5"} = pooled blocks 3/4/5."""

    def __init__(self, stage_sizes: Sequence[int], dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stage_sizes = tuple(stage_sizes)
        in_channels = 3
        for block, (n_convs, width) in enumerate(zip(self.stage_sizes, WIDTHS), 1):
            for i in range(n_convs):
                self.add_module(f"block{block}_conv{i + 1}", Conv2d(in_channels, width, 3, 1, "same", True, dtype))
                in_channels = width
        self.widths = WIDTHS[2:]

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        features: dict[str, torch.Tensor] = {}
        for block, n_convs in enumerate(self.stage_sizes, 1):
            for i in range(n_convs):
                x = F.relu(getattr(self, f"block{block}_conv{i + 1}")(x))
            x = max_pool(x, 2, 2)
            if block >= 3:  # pool3 /8, pool4 /16, pool5 /32
                features[f"c{block}"] = x
        return features
