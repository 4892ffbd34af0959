"""The rest of the model family against the JAX package: MobileNetV1 (widths
1 and 0.5), VGG-16/19 and DenseNet (``models/{mobilenet,vgg,densenet}.py``,
``models/retinanet.py::build_backbone``), and the ResNet's stem settings.

The port's seeded weights, with every norm scale and bias and every conv
bias redrawn at random, are carried into flax trees by
``models/convert.py::flax_from_state_dict`` (no flax ``init`` compile), and
the same numpy images go through both.  The DenseNet here has two layers a
block (``DENSENET_STAGES`` patched in both packages), so its widths stay
multiples of 32 for GroupNorm(32); FPN 64 and heads 64 x 1 keep GN(32) too.

Tolerances, of the largest output magnitude (``RTOL · max|want|``, as
tests/test_torch_models.py): f32 1e-4 (the frameworks sum convolutions and
norms in different orders; measured at most 8.3e-6); bf16 ``BF16_RTOL``
1e-1, both sides in bf16 and compared in f32: the two round activations at
other places (torch's bf16 convolutions and pools accumulate in f32, flax's
``avg_pool`` sums in bf16), up to a bf16 step (2^-8) a layer, and the gap
grows with depth: measured at most 4.8e-2 for MobileNet (its C5, after 27
conv-norm layers), 1.8e-2 for the DenseNet and 1.2e-2 for VGG-16.  Names
and shapes of every backbone's tree come from
``jax.eval_shape`` of ``init``, which traces and does not compile (a full
DenseNet-121 compiles for about a minute on this CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.models import densenet as j_densenet
from batchai_retinanet_horovod_coco_tpu.models import resnet as j_resnet
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models import convert
from batchai_retinanet_horovod_coco_tpu_torch.models import densenet as t_densenet
from batchai_retinanet_horovod_coco_tpu_torch.models import resnet as t_resnet
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet

HW = (64, 64)
HEADS = dict(num_classes=3, fpn_channels=64, head_width=64, head_depth=1)
RTOL = 1e-4
BF16_RTOL = 1e-1
NEW = ("mobilenet", "mobilenet050", "vgg16", "vgg19", "densenet121", "densenet169", "densenet201")
SMALL_DENSENET = (2, 2, 2, 2)


@pytest.fixture(autouse=True)
def small_densenet(monkeypatch):
    monkeypatch.setitem(j_densenet.DENSENET_STAGES, "densenet121", SMALL_DENSENET)
    monkeypatch.setitem(t_densenet.DENSENET_STAGES, "densenet121", SMALL_DENSENET)


def port_model(backbone: str, dtype: torch.dtype, seed: int = 0) -> t_retinanet.RetinaNet:
    model = t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(backbone=backbone, **HEADS, dtype=dtype), device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (t_resnet.GroupNorm, t_resnet.BatchNorm)):
                module.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, module.weight.shape)))
                module.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, module.bias.shape)))
            elif isinstance(module, t_resnet.Conv2d) and module.bias is not None:
                module.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.1, module.bias.shape)))
    return model


def jax_apply(backbone: str, dtype, variables, images):
    """The JAX RetinaNet's outputs and its backbone's features (NHWC)."""
    model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(backbone=backbone, **HEADS, stem="conv", dtype=dtype))

    @jax.jit
    def apply(v, x):
        out, inter = model.apply(v, x, capture_intermediates=lambda m, _: m.name == "backbone",
                                 mutable=["intermediates"])
        return out, inter["intermediates"]["backbone"]["__call__"][0]

    return apply(variables, images)


def port_apply(model, images):
    with torch.no_grad():
        x = torch.from_numpy(images)
        out = model(x)
        feats = model.backbone(x.permute(0, 3, 1, 2).to(model.config.dtype))
    return out, {k: v.permute(0, 2, 3, 1).float() for k, v in feats.items()}


def gap(got: torch.Tensor, want) -> float:
    """max|got - want| over max|want|, in f32."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def compare(backbone: str, t_dtype, j_dtype, rtol: float) -> None:
    model = port_model(backbone, t_dtype)
    params, _ = convert.flax_from_state_dict(model.state_dict())
    images = np.random.default_rng(1).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    j_out, j_feats = jax_apply(backbone, j_dtype, {"params": params}, images)
    t_out, t_feats = port_apply(model, images)
    assert set(t_feats) == set(j_feats) == {"c3", "c4", "c5"}
    assert tuple(t_feats[k].shape[-1] for k in ("c3", "c4", "c5")) == model.backbone.widths
    for key in ("c3", "c4", "c5"):
        assert gap(t_feats[key], j_feats[key]) <= rtol, key
    for key in ("cls_logits", "box_deltas"):
        assert gap(t_out[key], j_out[key]) <= rtol, key
    assert t_out["cls_logits"].shape == (2, t_retinanet.AnchorConfig().num_anchors(HW), 3)


@pytest.mark.parametrize("backbone", ["mobilenet", "mobilenet050", "vgg16", "vgg19", "densenet121"])
def test_forward_matches_flax(backbone):
    """Features C3-C5 and the whole RetinaNet in f32 (DenseNet: two layers
    a block)."""
    compare(backbone, torch.float32, jnp.float32, RTOL)


@pytest.mark.parametrize("backbone", ["mobilenet", "vgg16", "densenet121"])
def test_bf16_forward_is_close(backbone):
    """One case a family with bf16 activations on both sides."""
    compare(backbone, torch.bfloat16, jnp.bfloat16, BF16_RTOL)


@pytest.mark.parametrize("backbone", NEW)
def test_state_dict_is_the_flax_tree(backbone, monkeypatch):
    """Every name and shape of the port's state dict is a leaf of the flax
    variables (BatchNorm, so the statistics are there too), and back."""
    monkeypatch.setitem(j_densenet.DENSENET_STAGES, "densenet121", (6, 12, 24, 16))
    monkeypatch.setitem(t_densenet.DENSENET_STAGES, "densenet121", (6, 12, 24, 16))
    config = dict(backbone=backbone, norm_kind="bn", num_classes=80)
    j_model = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**config, dtype=jnp.float32))
    shapes = jax.eval_shape(j_model.init, jax.random.key(0), jnp.zeros((1, *HW, 3)))
    want = {}
    for collection, tree in shapes.items():
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            keys = tuple(p.key for p in path)
            shape = leaf.shape
            if keys[-1] == "kernel":
                shape = (shape[3], shape[2], shape[0], shape[1])  # HWIO -> OIHW
            want[convert.torch_name(collection, keys)] = tuple(shape)
    model = t_retinanet.RetinaNet(t_retinanet.RetinaNetConfig(**config, dtype=torch.float32))
    got = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    assert got == want
    assert any(".running_var" in n for n in got) == (not backbone.startswith("vgg"))


def resnet_features(stem: str, pack_width: bool, images: np.ndarray):
    """The JAX ResNet (one block a stage) with ``stem`` and ``pack_width``,
    and the port's from the same weights, on ``images``."""
    port = t_resnet.ResNet((1, 1, 1, 1), "gn", torch.float32, stem, pack_width)
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for name, p in port.named_parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.2 if p.ndim == 4 else 0.5, p.shape)))
    params, _ = convert.flax_from_state_dict(port.state_dict())
    j_model = j_resnet.ResNet(stage_sizes=(1, 1, 1, 1), norm_kind="gn", dtype=jnp.float32,
                              stem=stem, pack_width=pack_width)
    want = jax.jit(j_model.apply)({"params": params}, images)
    with torch.no_grad():
        got = port(torch.from_numpy(images).permute(0, 3, 1, 2))
    return {k: v.permute(0, 2, 3, 1) for k, v in got.items()}, want


@pytest.mark.parametrize("pack_width", [False, True], ids=["plain", "pack_width"])
@pytest.mark.parametrize("stem", t_resnet.STEMS)
def test_stem_settings_match_jax(stem, pack_width):
    """Each JAX stem formulation, packed or not, is the plain stem's math:
    the port's one plain stem and stage 2 give its features in f32."""
    images = np.random.default_rng(3).normal(0, 1, (2, 32, 48, 3)).astype(np.float32)
    got, want = resnet_features(stem, pack_width, images)
    for key in ("c3", "c4", "c5"):
        assert gap(got[key], want[key]) <= RTOL, key


# (config, image H x W) that the JAX model refuses, with the message.
REFUSED = {
    "space_to_depth-odd-H": (dict(stem="space_to_depth"), (33, 32), r"space_to_depth\(2\) stem needs"),
    "space_to_depth4-W": (dict(stem="space_to_depth4"), (32, 34), r"space_to_depth\(4\) stem needs"),
    "pack_width-odd-stage2": (dict(stem="conv", pack_width=True), (32, 36), r"pack_width needs an even"),
    "pack_width-mobilenet": (dict(backbone="mobilenet", pack_width=True), (32, 32),
                             r"pack_width is a ResNet-stage2 reformulation"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_settings_raise_in_both_packages(case):
    overrides, hw, message = REFUSED[case]
    config = dict(backbone="resnet_test", **HEADS) | overrides
    j_model = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**config, dtype=jnp.float32))
    with pytest.raises(ValueError, match=message) as want:
        jax.eval_shape(j_model.init, jax.random.key(0), jnp.zeros((1, *hw, 3)))
    with pytest.raises(ValueError, match=message) as got:
        model = t_retinanet.RetinaNet(t_retinanet.RetinaNetConfig(**config, dtype=torch.float32))
        with torch.no_grad():
            model(torch.zeros(1, *hw, 3))
    assert str(got.value) == str(want.value)
