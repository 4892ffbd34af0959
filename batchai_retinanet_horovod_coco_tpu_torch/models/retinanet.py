"""RetinaNet assembly: backbone → FPN → shared heads → concatenated outputs.

The JAX package's ``models/retinanet.py`` with its whole backbone registry
(:func:`build_backbone`: the ResNets, MobileNetV1 at widths 1 and 0.5,
VGG-16/19 and DenseNet-121/169/201), each module named ``backbone`` and
producing C3-C5, whose widths the FPN takes.  The public layout is the JAX
one: images in (B, H, W, 3), outputs
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
from batchai_retinanet_horovod_coco_tpu_torch.models import densenet, mobilenet, vgg
from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import (
    BatchNorm,
    Conv2d,
    GroupNorm,
    ResNet,
    lecun_normal_,
)
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

DEFAULT_STEM = "space_to_depth"  # the JAX package's default; the same math as "conv"


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    num_classes: int = 80
    backbone: str = "resnet50"
    norm_kind: str = "gn"  # "gn" | "bn" | "frozen_bn"  (see models/resnet.py)
    # The JAX package's ResNet stem formulation and width-packed stage 2:
    # computed here by the plain stem and stage, with the JAX model's shape
    # checks (models/resnet.py).  ResNet backbones only.
    stem: str = DEFAULT_STEM
    pack_width: bool = False
    # The ResNet stem's downsample: "max", or the JAX package's tie-free
    # diagnostic "avg" (models/resnet.py::stem_pool; stem="conv" only).
    stem_pool: str = "max"
    fpn_channels: int = 256
    head_width: int = 256
    head_depth: int = 4
    prior_prob: float = 0.01
    anchor: AnchorConfig = AnchorConfig()
    dtype: torch.dtype = torch.bfloat16

    @property
    def anchors_per_location(self) -> int:
        return self.anchor.num_anchors_per_location


# ResNet blocks per stage.
BACKBONE_STAGES = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    # One block per stage: for fast tests only.
    "resnet_test": (1, 1, 1, 1),
}

# The JAX package's backbone names, every one built here.
BACKBONES = tuple(BACKBONE_STAGES) + (
    "mobilenet", "mobilenet050", "vgg16", "vgg19", "densenet121", "densenet169", "densenet201",
)


def build_backbone(config: RetinaNetConfig) -> nn.Module:
    """The backbone registry, as the JAX package's: a module producing
    {"c3", "c4", "c5"} at strides 8/16/32 in NCHW, with their widths in
    ``.widths``.  ``norm_kind`` applies where the architecture has norms
    (not VGG); ``stem``, ``pack_width`` and ``stem_pool`` are ResNet
    settings, and ``pack_width`` and a ``stem_pool`` other than ``"max"``
    raise the JAX package's ``ValueError`` on any other backbone."""
    name = config.backbone
    stages = BACKBONE_STAGES.get(name)
    if config.pack_width and stages is None:
        raise ValueError(
            f"pack_width is a ResNet-stage2 reformulation; backbone "
            f"{name!r} does not support it"
        )
    if config.stem_pool != "max" and stages is None:
        raise ValueError(
            f"stem_pool={config.stem_pool!r} is only supported by ResNet "
            f"backbones, not {name!r}"
        )
    if stages is not None:
        return ResNet(stages, config.norm_kind, config.dtype, config.stem, config.pack_width,
                      config.stem_pool)
    if name in ("mobilenet", "mobilenet050"):
        return mobilenet.MobileNetV1(0.5 if name == "mobilenet050" else 1.0, config.norm_kind, config.dtype)
    if name in vgg.VGG_STAGES:
        return vgg.VGG(vgg.VGG_STAGES[name], config.dtype)
    if name in densenet.DENSENET_STAGES:
        return densenet.DenseNet(densenet.DENSENET_STAGES[name], norm_kind=config.norm_kind,
                                 dtype=config.dtype)
    raise ValueError(f"unsupported backbone: {name!r}")


class RetinaNet(nn.Module):
    def __init__(self, config: RetinaNetConfig):
        super().__init__()
        self.config = config
        self.backbone = build_backbone(config)
        self.fpn = FPN(self.backbone.widths, config.fpn_channels, config.dtype)
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
        normal for backbone and FPN convs (a depthwise kernel's fan-in is
        its k * k taps), normal(0.01) for the head convs, zero biases (VGG's
        too) except the classification prior, unit norm scales."""
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
