"""The port's RetinaNet forward against the JAX package's ``RetinaNet.apply``,
with the flax weights carried across by ``models/convert.py``.

Both sides run in f32 at a small width (resnet_test backbone, FPN and heads
32 wide, 3 classes) on 80 x 112 images, whose pyramid has odd sizes (C4
5 x 7, C5 3 x 4): the FPN's non-2x nearest upsample and its stride-2 SAME
padding on even and odd sizes are both on the path.  Norm scales, biases
and BatchNorm statistics are random, so a mis-mapped leaf shows.

Tolerance: 1e-4 of the largest output magnitude.  The two frameworks sum
convolutions in different orders (and GroupNorm variance by different
formulas), which moves f32 results by a few ulps per layer; measured
agreement is about 3e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models import fpn as t_fpn
from batchai_retinanet_horovod_coco_tpu_torch.models import resnet as t_resnet
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables

HW = (80, 112)
SMALL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=2)
RTOL = 1e-4


def random_flax_variables(norm_kind: str, seed: int = 0):
    """Initialised flax variables with every norm scale/bias, conv bias and
    BatchNorm statistic redrawn at random (numpy trees)."""
    model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**SMALL, norm_kind=norm_kind, stem="conv", dtype=jnp.float32)
    )
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.key(seed), jnp.zeros((1, *HW, 3)))
    )
    rng = np.random.default_rng(seed)

    def redraw(path, x):
        x = np.asarray(x)
        draw = {
            "scale": lambda: rng.uniform(0.5, 1.5, x.shape),
            "bias": lambda: rng.normal(0.0, 0.1, x.shape),
            "mean": lambda: rng.normal(0.0, 0.1, x.shape),
            "var": lambda: rng.uniform(0.5, 2.0, x.shape),
        }.get(path[-1].key)
        return x if draw is None else draw().astype(np.float32)

    return jax.tree_util.tree_map_with_path(redraw, variables)


def port_model(norm_kind: str, variables) -> t_retinanet.RetinaNet:
    model = t_retinanet.RetinaNet(
        t_retinanet.RetinaNetConfig(**SMALL, norm_kind=norm_kind, dtype=torch.float32)
    )
    return load_flax_variables(model, variables["params"], variables.get("batch_stats")).eval()


def assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.fixture(scope="module", params=["gn", "frozen_bn"])
def pair(request):
    variables = random_flax_variables(request.param)
    return request.param, variables, port_model(request.param, variables)


@pytest.mark.parametrize("stem", ["conv", "space_to_depth"])
def test_forward_matches_flax(pair, stem):
    norm_kind, variables, model = pair
    j_model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**SMALL, norm_kind=norm_kind, stem=stem, dtype=jnp.float32)
    )
    images = np.random.default_rng(1).normal(0, 1, (2, *HW, 3)).astype(np.float32)

    @jax.jit
    def apply(v, x):
        return j_model.apply(v, x), j_model.apply(v, x, return_levels=True)

    j_out, j_levels = apply(variables, images)
    with torch.no_grad():
        t_out = model(torch.from_numpy(images))
        t_levels = model(torch.from_numpy(images), return_levels=True)
    for key in ("cls_levels", "box_levels"):
        assert len(t_levels[key]) == len(j_levels[key]) == 5
        for got, want in zip(t_levels[key], j_levels[key]):
            assert_close(got, want)
    assert_close(t_out["cls_logits"], j_out["cls_logits"])
    assert_close(t_out["box_deltas"], j_out["box_deltas"])
    num_anchors = t_retinanet.AnchorConfig().num_anchors(HW)
    assert t_out["cls_logits"].shape == (2, num_anchors, 3)


@pytest.mark.parametrize("src,dst", [(3, 5), (4, 7), (2, 3), (5, 10), (13, 25)])
def test_upsample_is_jax_nearest(src, dst):
    """jax.image.resize "nearest" samples half-pixel centres (torch's
    "nearest-exact"); plain torch "nearest" differs on non-2x sizes."""
    x = np.arange(src * src, dtype=np.float32).reshape(1, src, src, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 1), "nearest"))
    got = t_fpn.upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    if dst != 2 * src:
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, dst), mode="nearest"
        )
        assert not torch.equal(plain, got)


@pytest.mark.parametrize(
    "src,dst,exact_differs",
    [(14, 23, True), (42, 83, True), (50, 99, False)],
)
def test_upsample_follows_jax_f32_rounding(src, dst, exact_differs):
    """XLA compiles jax.image.resize's (i + 0.5) * src / dst into a multiply
    by the f32 constant src * (1 / dst).  On some sizes (42 -> 83 is the
    C5 -> C4 upsample of a 1328-row input) that picks another source row
    than torch's "nearest-exact"; on others (50 -> 99) a plain f32
    multiply-then-divide does."""
    x = np.arange(src, dtype=np.float32).reshape(1, src, 1, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, 1, 1), "nearest"))
    got = t_fpn.upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, 1))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    exact = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=(dst, 1), mode="nearest-exact"
    )
    assert torch.equal(exact, got) != exact_differs


@pytest.mark.parametrize("size", [8, 9])
def test_stride2_same_padding(size):
    """XLA's SAME pads (0, 1) for a stride-2 3x3 conv on an even size and
    (1, 1) on an odd one; torch's symmetric padding=1 would shift the grid."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(1, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    conv = t_resnet.Conv2d(4, 5, 3, 2, "same", bias=False, dtype=torch.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_kind", ["gn", "frozen_bn"])
def test_norm_epsilons(norm_kind):
    """flax GroupNorm's eps is 1e-6 (torch's default 1e-5), BatchNorm's
    1e-5; with a variance near 1e-6 the choice dominates the output."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 4, 4, 64)) * 1e-3).astype(np.float32)
    if norm_kind == "gn":
        layer = fnn.GroupNorm(num_groups=32)
        variables = layer.init(jax.random.key(0), x)
        port = t_resnet.GroupNorm(64, torch.float32)
    else:
        layer = fnn.BatchNorm(use_running_average=True)
        variables = {
            "params": {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)},
            "batch_stats": {"mean": np.zeros(64, np.float32), "var": np.full(64, 1e-6, np.float32)},
        }
        port = t_resnet.BatchNorm(64, torch.float32, frozen=True)
        port.running_var.fill_(1e-6)
    want = np.asarray(layer.apply(variables, x))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3, atol=1e-3)


def test_build_retinanet_is_seeded():
    cfg = t_retinanet.RetinaNetConfig(**SMALL, dtype=torch.float32)
    a = t_retinanet.build_retinanet(cfg, device="cpu", seed=3).state_dict()
    b = t_retinanet.build_retinanet(cfg, device="cpu", seed=3).state_dict()
    c = t_retinanet.build_retinanet(cfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.stem_conv.weight"], c["backbone.stem_conv.weight"])
    prior = -np.log(99.0)
    assert torch.allclose(a["cls_head.logits.bias"], torch.tensor(prior, dtype=torch.float32))
