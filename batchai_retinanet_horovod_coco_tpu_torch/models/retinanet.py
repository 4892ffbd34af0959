"""RetinaNet assembly: backbone → FPN → shared heads → concatenated outputs.

The JAX package's ``models/retinanet.py`` for the ResNet backbones.  The
public layout is the JAX one: images in (B, H, W, 3), outputs
``{"cls_logits": (B, A, K), "box_deltas": (B, A, 4)}`` in f32, anchors in
the order of ``ops.anchors.anchors_for_image_shape`` (level-major, then
(y, x), then the 9 anchors of a location).  Inside, the modules run in
NCHW.  Parameters are f32; activations follow ``RetinaNetConfig.dtype``
(bf16 by default) and the outputs are cast to f32 once, at the end.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from batchai_retinanet_horovod_coco_tpu_torch.models.fpn import FPN
from batchai_retinanet_horovod_coco_tpu_torch.models.heads import (
    BoxHead,
    ClassificationHead,
)
from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import (
    BatchNorm,
    Conv2d,
    GroupNorm,
    ResNet,
    lecun_normal_,
)
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    num_classes: int = 80
    backbone: str = "resnet50"
    norm_kind: str = "gn"  # "gn" | "bn" | "frozen_bn"  (see models/resnet.py)
    fpn_channels: int = 256
    head_width: int = 256
    head_depth: int = 4
    prior_prob: float = 0.01
    anchor: AnchorConfig = AnchorConfig()
    dtype: torch.dtype = torch.bfloat16

    @property
    def anchors_per_location(self) -> int:
        return self.anchor.num_anchors_per_location


BACKBONE_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    # One block per stage: for fast tests only.
    "resnet_test": (1, 1, 1, 1),
}

# The JAX package's backbone names; the command lines refuse those outside
# BACKBONE_STAGES.
BACKBONES = ("resnet50", "resnet101", "resnet152", "resnet_test", "mobilenet", "mobilenet050",
             "vgg16", "vgg19", "densenet121", "densenet169", "densenet201")
# The JAX package's stem formulations (one parameter layout); the port
# computes the default's math with a plain conv and refuses the others.
STEMS = ("conv", "space_to_depth", "space_to_depth4")
DEFAULT_STEM = "space_to_depth"


class RetinaNet(nn.Module):
    def __init__(self, config: RetinaNetConfig):
        super().__init__()
        stages = BACKBONE_STAGES.get(config.backbone)
        if stages is None:
            raise ValueError(
                f"unsupported backbone {config.backbone!r}; this port has "
                f"{sorted(BACKBONE_STAGES)}"
            )
        self.config = config
        self.backbone = ResNet(stages, config.norm_kind, config.dtype)
        self.fpn = FPN((512, 1024, 2048), config.fpn_channels, config.dtype)
        self.cls_head = ClassificationHead(
            config.num_classes,
            config.anchors_per_location,
            config.fpn_channels,
            config.head_width,
            config.head_depth,
            config.prior_prob,
            config.dtype,
        )
        self.box_head = BoxHead(
            config.anchors_per_location,
            config.fpn_channels,
            config.head_width,
            config.head_depth,
            config.dtype,
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initializers, drawn from ``generator``: lecun
        normal for backbone and FPN convs, normal(0.01) for the head convs,
        zero biases except the classification prior, unit norm scales."""
        heads = {id(m) for h in (self.cls_head, self.box_head) for m in h.modules()}
        with torch.no_grad():
            for module in self.modules():
                if isinstance(module, Conv2d):
                    if id(module) in heads:
                        module.weight.normal_(0.0, 0.01, generator=generator)
                    else:
                        lecun_normal_(module.weight, generator)
                    if module.bias is not None:
                        module.bias.zero_()
                elif isinstance(module, (GroupNorm, BatchNorm)):
                    module.weight.fill_(1.0)
                    module.bias.zero_()
            self.cls_head.logits.bias.fill_(self.cls_head.prior_bias)

    def forward(
        self, images: torch.Tensor, return_levels: bool = False
    ) -> dict[str, torch.Tensor | tuple[torch.Tensor, ...]]:
        """(B, H, W, 3) normalized images → {"cls_logits": (B, A, K),
        "box_deltas": (B, A, 4)} in f32; ``return_levels=True`` returns the
        per-level outputs ({"cls_levels", "box_levels"}, P3→P7) instead."""
        x = images.permute(0, 3, 1, 2)
        pyramid = self.fpn(self.backbone(x))
        cls_out, box_out = [], []
        for level in self.config.anchor.levels:  # P3 → P7, the anchor order
            feat = pyramid[f"p{level}"]
            cls_out.append(self.cls_head(feat))
            box_out.append(self.box_head(feat))
        if return_levels:
            return {
                "cls_levels": tuple(o.float() for o in cls_out),
                "box_levels": tuple(o.float() for o in box_out),
            }
        return {
            "cls_logits": torch.cat(cls_out, dim=1).float(),
            "box_deltas": torch.cat(box_out, dim=1).float(),
        }


def build_retinanet(
    config: RetinaNetConfig | None = None,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> RetinaNet:
    """A RetinaNet with weights drawn from ``torch.Generator`` seeded with
    ``seed`` (on the CPU, so a seed gives the same weights on every
    device), moved to ``device`` in eval mode.  The default device is
    ``cuda``; without a card it raises instead of falling back."""
    device = resolve_device(device)
    model = RetinaNet(config or RetinaNetConfig())
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
