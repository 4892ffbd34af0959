"""The port's numerics recorder (``obs/numerics.py``, ``train/step.py``'s
summary, ``train/loop.py``'s provenance dump) against the JAX package's.

The summary runs the golden configuration of ``tests/test_torch_train.py``
(resnet_test, 64 x 64, 3 classes, f32) from the same seeded weights and
batch through both steps with numerics on: the same keys, and values
within that file's tolerance for ``grad_norm`` (rel 1e-4).  With numerics
off the port's step is unchanged: the keys it had without the summary, and
the same losses and weights bit for bit as with numerics on.  The
provenance pass runs on both
packages' models with a NaN written into the same conv kernel: the same
first non-finite layer, parameter and scalar, and the same layer paths.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.obs import numerics as j_numerics
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu_torch.obs import numerics as t_numerics
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step

from test_torch_train import GOLDEN, GOLDEN_OPT, HW, RTOL, flax_variables, golden_batch, small_model

STEP_KEYS = {"loss", "cls_loss", "box_loss", "num_pos", "grad_norm", "param_norm"}
SUMMARY_KEYS = {"nonfinite_grads", "update_ratio", "gnorm/backbone", "gnorm/fpn",
                "gnorm/cls_head", "gnorm/box_head"}
# A conv of the third stage: its NaN reaches every later layer.
POISONED = "backbone.stage3_block0.conv2.weight"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model and its numerics-on train step (jitted once; weights
    are arguments, so the poisoned run reuses the compile)."""
    model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**GOLDEN, norm_kind="gn", stem="conv", dtype=jnp.float32)
    )
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**GOLDEN_OPT))
    step = j_step.make_train_step(
        model, HW, 3,
        loss_config=j_losses.LossConfig(pallas_focal=True, pallas_interpret=True),
        matching_config=j_matching.MatchingConfig(fused_pallas=True, pallas_interpret=True),
        donate_state=False,
        numerics=j_numerics.NumericsConfig(enabled=True),
    )
    return model, tx, step


def jax_step_metrics(jax_side, torch_model, batch):
    model, tx, step = jax_side
    params = jax.tree.map(jnp.asarray, flax_variables(torch_model)[0])
    state = j_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
        opt_state=tx.init(params), tx=tx,
    )
    arrays = {k: jnp.asarray(getattr(batch, k)) for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    _, metrics = step(state, arrays)
    return {k: float(v) for k, v in jax.device_get(metrics).items()}, params


def port_step(model, numerics: bool, batch):
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    step = t_step.make_train_step(
        model, HW, 3, device="cpu", numerics=t_numerics.NumericsConfig(enabled=numerics)
    )
    return {k: float(v) for k, v in step(state, t_loop.device_batch(batch, torch.device("cpu"))).items()}


def test_summary_matches_jax(jax_side):
    batch = golden_batch()
    want, _ = jax_step_metrics(jax_side, small_model(), batch)
    got = port_step(small_model(), True, batch)
    assert set(got) == set(want) == STEP_KEYS | SUMMARY_KEYS
    for key in sorted(SUMMARY_KEYS | {"grad_norm", "param_norm", "loss"}):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert got["nonfinite_grads"] == want["nonfinite_grads"] == 0.0
    assert 0.0 < got["update_ratio"] < 1.0


def test_numerics_off_leaves_the_step_unchanged():
    """Off: the step's keys are those it had before the summary.  On: the same losses, norms and
    updated weights, bit for bit — the summary only reads."""
    batch = golden_batch()
    off_model, on_model = small_model(), small_model()
    off = port_step(off_model, False, batch)
    on = port_step(on_model, True, batch)
    assert set(off) == STEP_KEYS
    assert {k: on[k] for k in STEP_KEYS} == off
    for (name, a), b in zip(off_model.state_dict().items(), on_model.state_dict().values()):
        assert torch.equal(a, b), name


def test_nonfinite_count_counts_elements():
    grads = [torch.tensor([1.0, float("nan"), float("inf")]), torch.full((2, 2), -float("inf")),
             torch.zeros(5)]
    want = j_numerics.nonfinite_count([jnp.asarray(g.numpy()) for g in grads])
    assert float(t_numerics.nonfinite_count(grads)) == float(want) == 6.0


def test_first_nonfinite_scalar_order_matches_jax():
    scalars = {"loss": float("nan"), "box_loss": 1.0, "cls_loss": float("inf"), "aaa": float("nan")}
    assert t_numerics.first_nonfinite_scalar(scalars) == j_numerics.first_nonfinite_scalar(scalars)
    tensors = {k: torch.tensor(v) for k, v in scalars.items()}
    name, value = t_numerics.first_nonfinite_scalar(tensors)
    assert name == "cls_loss" and value == float("inf")
    assert t_numerics.first_nonfinite_scalar({"loss": 1.0}) is None


def test_leaf_stats_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 5, 6)).astype(np.float32)
    x[0, 0, :3] = [np.nan, np.inf, -np.inf]
    for array in (x, np.full((3,), np.nan, np.float32), np.zeros((0,), np.float32)):
        assert t_numerics._leaf_stats(torch.from_numpy(array)) == j_numerics._leaf_stats(array)


@pytest.fixture(scope="module")
def poisoned(jax_side):
    """Both packages' provenance dumps of the golden model with a NaN in
    ``POISONED``, on the metrics of a step with those weights."""
    batch = golden_batch()
    model = small_model()
    with torch.no_grad():
        model.state_dict()[POISONED][0, 0, 0, 0] = float("nan")
    metrics, params = jax_step_metrics(jax_side, model, batch)
    j_model = jax_side[0]
    want = j_numerics.provenance(
        step=3, metrics=metrics, params=params, model=j_model, variables={"params": params},
        images=jnp.asarray(batch.images), image_ids=batch.image_ids, rng_seed=0,
        tripped={"metric": "loss", "value": metrics["loss"]}, cadence="every 1 steps",
    )
    got = t_numerics.provenance(
        step=3, metrics=metrics, model=model, images=torch.from_numpy(batch.images),
        image_ids=batch.image_ids, rng_seed=0,
        tripped={"metric": "loss", "value": metrics["loss"]}, cadence="every 1 steps",
    )
    return got, want


def test_provenance_localizes_as_jax(poisoned):
    got, want = poisoned
    assert want["forward"]["first_nonfinite_layer"] is not None
    assert got["forward"]["first_nonfinite_layer"] == want["forward"]["first_nonfinite_layer"]
    assert got["params"]["first_nonfinite"] == want["params"]["first_nonfinite"] \
        == "['backbone']['stage3_block0']['conv2']['kernel']"
    assert got["first_nonfinite_metric"] == want["first_nonfinite_metric"] is not None
    assert got["first_nonfinite"] == want["first_nonfinite"]
    for key in ("layers_inspected", "nonfinite_layers"):
        assert got["forward"][key] == want["forward"][key], key
    assert list(got["forward"]["layers"]) == list(want["forward"]["layers"])
    assert got["forward"]["outputs"].keys() == want["forward"]["outputs"].keys()
    assert got["params"]["leaves"] == want["params"]["leaves"]
    assert got["params"]["nonfinite_total"] == want["params"]["nonfinite_total"] == 1
    assert got["batch_image_ids"] == want["batch_image_ids"]
    assert t_numerics.format_dump(got).splitlines()[:3] == j_numerics.format_dump(want).splitlines()[:3]


def test_dump_round_trip(poisoned, tmp_path):
    got, _ = poisoned
    path = t_numerics.write_dump(got, str(tmp_path))
    assert path.endswith("NUMERICS_DUMP.json")
    loaded = t_numerics.load_dump(path)
    assert loaded == json.loads(json.dumps(got))
    assert t_numerics.format_dump(loaded) == j_numerics.format_dump(loaded)


def test_loop_writes_the_dump_before_raising(tmp_path):
    state = t_state.create_train_state(small_model(), t_optim.OptimizerConfig(**GOLDEN_OPT), "cpu")
    batch = golden_batch()
    bad = batch._replace(images=np.full(batch.images.shape, np.nan, np.float32),
                         image_ids=np.array([7, 8, 9, 10]))
    config = t_loop.LoopConfig(total_steps=2, log_every=1, numerics_dump_dir=str(tmp_path), rng_seed=5)
    with pytest.raises(FloatingPointError, match="provenance dump at .*NUMERICS_DUMP.json"):
        t_loop.run_training(state, iter([batch, bad]), 3, config, log=lambda *_: None)
    dump = t_numerics.load_dump(str(tmp_path / "NUMERICS_DUMP.json"))
    assert dump["step"] == 2 and dump["batch_image_ids"] == [7, 8, 9, 10] and dump["rng_seed"] == 5
    assert dump["first_nonfinite"] == "['backbone']['stem_conv']['__call__'][0]"
    assert dump["tripped"]["metric"] == "loss"


def test_a_failing_provenance_pass_never_replaces_the_error(tmp_path, monkeypatch):
    def broken(**_):
        raise RuntimeError("provenance broke")

    monkeypatch.setattr(t_numerics, "provenance", broken)
    state = t_state.create_train_state(small_model(), t_optim.OptimizerConfig(**GOLDEN_OPT), "cpu")
    batch = golden_batch()
    bad = batch._replace(images=np.full(batch.images.shape, np.nan, np.float32))
    config = t_loop.LoopConfig(total_steps=1, log_every=1, numerics_dump_dir=str(tmp_path))
    with pytest.raises(FloatingPointError, match="provenance dump failed") as info:
        t_loop.run_training(state, iter([bad]), 3, config, log=lambda *_: None)
    assert isinstance(info.value.__cause__, RuntimeError)
    assert not (tmp_path / "NUMERICS_DUMP.json").exists()
