"""The pretrained-backbone import (``models/import_weights.py``) against the
JAX package's ``models/import_weights.py``.

A random state dict in torchvision's ResNet-50 layout (``fc.*`` and
``num_batches_tracked`` among its keys), written as ``.pth`` and as
``.npz``, goes into the same ResNet-50 RetinaNet (frozen BatchNorm, the
reference's recipe) in both packages: the JAX trees, carried across by
``models/convert.py``, equal the port's tensors bit for bit.  Each refusal
raises in both packages with the same message, and the port's model is left
as it was.
"""

import shutil

import jax
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.models import import_weights as j_import
from batchai_retinanet_horovod_coco_tpu_torch.models import convert
from batchai_retinanet_horovod_coco_tpu_torch.models import import_weights as t_import
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from chip_smoke import torchvision_resnet_layout
from test_torch_train import drop_tmp_path  # noqa: F401

SMALL = dict(num_classes=3, fpn_channels=32, head_width=32, head_depth=1, dtype=torch.float32)


def torchvision_state_dict(stage_sizes=(3, 4, 6, 3), seed: int = 0) -> dict[str, torch.Tensor]:
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in torchvision_resnet_layout(stage_sizes).items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(int(rng.integers(1, 1000)))
        elif name.endswith("running_var"):
            out[name] = torch.from_numpy(rng.uniform(0.5, 2.0, shape).astype(np.float32))
        else:
            out[name] = torch.from_numpy(rng.normal(0.0, 0.1, shape).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("weights")
    sd = torchvision_state_dict()
    torch.save(sd, root / "resnet50.pth")
    np.savez(root / "resnet50.npz", **{k: v.numpy() for k, v in sd.items()})
    yield sd, {"pth": str(root / "resnet50.pth"), "npz": str(root / "resnet50.npz")}
    shutil.rmtree(root, ignore_errors=True)


def port_model(backbone="resnet50", norm_kind="frozen_bn") -> t_retinanet.RetinaNet:
    return t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(backbone=backbone, norm_kind=norm_kind, **SMALL), device="cpu", seed=0)


def jax_import(model: t_retinanet.RetinaNet, path: str) -> dict[str, torch.Tensor]:
    """The JAX package's import into the model's weights as flax trees,
    carried back into a torch state dict."""
    params, stats = convert.flax_from_state_dict(model.state_dict())
    imp_params, imp_stats = j_import.convert_torch_resnet50(j_import.load_state_dict(path))
    new_params, new_stats = j_import.apply_backbone_weights(params, stats, imp_params, imp_stats)
    return convert.variables_from_flax(jax.device_get(new_params), jax.device_get(new_stats))


@pytest.mark.parametrize("kind", ["pth", "npz"])
def test_both_packages_import_the_same_tensors(files, kind):
    sd, paths = files
    model = port_model()
    want = jax_import(model, paths[kind])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    t_import.import_pretrained_backbone(model, paths[kind])
    got = model.state_dict()
    assert set(got) == set(want)
    for name, tensor in got.items():
        assert torch.equal(tensor, want[name]), name
    assert torch.equal(got["backbone.stage5_block2.conv3.weight"], sd["layer4.2.conv3.weight"])
    assert torch.equal(got["backbone.stage2_block0.proj_norm.running_var"], sd["layer1.0.downsample.1.running_var"])
    changed = {k for k in got if not torch.equal(got[k], before[k])}
    assert changed == {k for k in got if k.startswith("backbone.")}  # the heads and FPN untouched
    imported = t_import.convert_torch_resnet50(t_import.load_state_dict(paths[kind]))
    assert len(imported) == len(sd) - 2 - sum(k.endswith("num_batches_tracked") for k in sd)  # fc.*


def shape_mismatch(sd):
    sd = dict(sd)
    sd["layer2.0.conv2.weight"] = torch.zeros(128, 128, 1, 1)
    return sd


def pickled_module(path):
    torch.save(torch.nn.Linear(2, 2), path)


# (case, the state dict, the model, the message both packages give)
REFUSALS = {
    "shape-mismatch": (shape_mismatch, dict(), r"shape mismatch at backbone/stage3_block0/conv2/"),
    "unknown-key": (lambda sd: sd, dict(backbone="resnet_test"),
                    r"^unknown param backbone/stage2_block1 in imported weights$"),
    "partial-coverage": (lambda sd: sd, dict(backbone="resnet101"),
                         r"imported weights leave 34 backbone leaves uninitialized \(model deeper than the "
                         r"checkpoint\?\): backbone/stage4_block"),
    "stats-into-groupnorm": (lambda sd: sd, dict(norm_kind="gn"),
                             r"^imported weights carry BN stats but the model has none"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_in_both_packages(files, tmp_path, case):
    edit, model_kwargs, message = REFUSALS[case]
    sd, _ = files
    path = str(tmp_path / "weights.pth")
    torch.save(edit(sd), path)
    model = port_model(**model_kwargs)
    with pytest.raises(ValueError, match=message) as want:
        jax_import(model, path)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=message) as got:
        t_import.import_pretrained_backbone(model, path)
    if case != "shape-mismatch":  # there the layouts differ: HWIO against OIHW
        assert str(got.value) == str(want.value)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_a_pickled_module_is_refused_in_both_packages(tmp_path):
    path = str(tmp_path / "module.pth")
    pickled_module(path)
    for load in (j_import.load_state_dict, t_import.load_state_dict):
        with pytest.raises(ValueError, match="not a plain tensor state dict"):
            load(path)
