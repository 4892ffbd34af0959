"""The port's checkpoints (``utils/checkpoint.py``, ``train/state.py``'s
saveable view, ``train/optim.py``'s optax mapping, ``models/convert.py``'s
inverse) within the port and across the two packages.

The model is the golden configuration of tests/test_torch_train.py
(resnet_test, 64 x 64, 3 classes, FPN and heads 16 x 1, f32).  Across
packages the JAX side is the JAX package's own ``CheckpointManager`` and
train step (its plain jnp path: the Pallas kernels are held against the
port's by tests/test_torch_train.py), and each next step's loss agrees with
the other side's within that file's ``RTOL`` (rel 1e-4: the two frameworks
sum convolutions in different orders).  Within the port a round trip is
bit for bit.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu.parallel.zero import reshard_flat_leaf as j_reshard
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu.utils import checkpoint as j_ckpt
from batchai_retinanet_horovod_coco_tpu_torch.models import convert
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_train import GOLDEN, GOLDEN_OPT, HW, RTOL, drop_tmp_path, golden_batch, small_model  # noqa: F401

CPU = torch.device("cpu")
# sgd as the golden run; adam at a small LR; the plateau schedule with a
# window of 2 steps and a patience of 1, so that its state moves within a
# few steps.
OPTS = {
    "sgd": GOLDEN_OPT,
    "adam": dict(GOLDEN_OPT, optimizer="adam", base_lr=1e-4, global_batch_size=16),
    "plateau": dict(GOLDEN_OPT, schedule="plateau", plateau_window=2, plateau_patience=1),
    "adam-plateau": dict(GOLDEN_OPT, optimizer="adam", base_lr=1e-4, global_batch_size=16,
                         schedule="plateau", plateau_window=2, plateau_patience=1),
    "sgd-frozen-backbone": dict(GOLDEN_OPT, weight_decay=1e-4, freeze_backbone=True),
    # optax keeps a trace (the last update) even without momentum.
    "sgd-momentum0": dict(GOLDEN_OPT, momentum=0.0, weight_decay=1e-4),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_state(norm_kind: str, opt: str, seed: int = 42, backbone: str = "resnet_test") -> t_state.TrainState:
    return t_state.create_train_state(small_model(norm_kind, seed, backbone),
                                      t_optim.OptimizerConfig(**OPTS[opt]), device="cpu")


def port_steps(state: t_state.TrainState, seeds) -> list[float]:
    step = t_step.make_train_step(state.model, HW, 3, device="cpu")
    return [float(step(state, t_loop.device_batch(golden_batch(s), CPU))["loss"]) for s in seeds]


def jax_state(norm_kind: str, opt: str, weights_from: t_state.TrainState, backbone: str = "resnet_test"):
    """The JAX model, its TrainState (weights copied from the port's model
    through ``flax_from_state_dict``) and its train step."""
    model = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(
        **dict(GOLDEN, backbone=backbone), norm_kind=norm_kind, stem="conv", dtype=jnp.float32))
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**OPTS[opt]))
    params, stats = convert.flax_from_state_dict(weights_from.model.state_dict())
    params = jax.tree.map(jnp.asarray, params)
    # Through numpy, so that no leaf is weakly typed: the plateau state's
    # initial scalars are, and its first update would compile the step again.
    opt_state = jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tx.init(params))
    state = j_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, stats), opt_state=opt_state, tx=tx,
    )
    step = j_step.make_train_step(
        model, HW, 3, loss_config=j_losses.LossConfig(pallas_focal=False),
        matching_config=j_matching.MatchingConfig(fused_pallas=False), donate_state=False,
    )
    return state, step


def jax_step(step, state, seed):
    batch = golden_batch(seed)
    arrays = {k: jnp.asarray(getattr(batch, k)) for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    state, metrics = step(state, arrays)
    return state, float(metrics["loss"])


def save_now(directory: str, state: t_state.TrainState) -> None:
    """A synchronous save: the manager's ``save()``, then ``close()``."""
    manager = t_ckpt.CheckpointManager(directory)
    assert manager.save(state)
    manager.close()


def leaves_equal(a, b) -> None:
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize(
    "config",
    [OPTS["sgd"], dict(optimizer="adam"), dict(schedule="plateau"), dict(freeze_backbone=True),
     dict(optimizer="adam", schedule="plateau", freeze_backbone=True), {}, OPTS["sgd-momentum0"]],
    ids=["golden-sgd", "adam", "plateau", "frozen-backbone", "adam-plateau-frozen", "default",
         "sgd-momentum0"],
)
def test_saveable_view_is_the_jax_state(config):
    """Key paths, flatten order, shapes and dtypes of the port's saveable
    view equal the JAX package's checkpoint leaves for the same model and
    ``OptimizerConfig`` (``make_optimizer(config)[0].init(params)``)."""
    port = port_state("bn", "sgd")
    port = t_state.create_train_state(port.model, t_optim.OptimizerConfig(**config), device="cpu")
    params, stats = convert.flax_from_state_dict(port.model.state_dict())
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**config))
    want_state = j_state.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                    opt_state=tx.init(params), tx=tx)
    want = [(p, tuple(np.shape(x)), np.dtype(x.dtype))
            for p, x in j_ckpt._flatten_with_paths(j_ckpt._saveable(want_state))]
    got = [(leaf.path, leaf.shape, leaf.dtype) for leaf in t_state.saveable(port)]
    assert got == want
    assert any(p.startswith("['opt_state']") for p, _, _ in got)


def test_sgd_without_momentum_has_no_mapping():
    """sgd with momentum 0 keeps optax's trace, the last update: zero
    before the first step, then the clipped gradient plus the decay term,
    which moved each parameter by the LR times itself."""
    port = port_state("gn", "sgd-momentum0")
    traces = [leaf for leaf in t_state.saveable(port) if leaf.path.startswith("['opt_state'][1][1][0].trace")]
    assert len(traces) == len(port.optimizer.params)
    assert all(not leaf.read().any() for leaf in traces)
    before = [p.detach().clone() for p in port.optimizer.params]
    port_steps(port, [0])
    lr = t_optim.peak_lr(port.optimizer.config)
    for trace, p, p0 in zip(port.optimizer.trace, port.optimizer.params, before):
        assert torch.equal(p.detach(), p0.add(trace, alpha=-lr))  # torch's SGD update
    assert any(leaf.read().any() for leaf in traces)


@pytest.mark.parametrize("norm_kind", ["gn", "bn"])
def test_convert_inverse_is_exact(norm_kind):
    """torch → flax → torch and flax → torch → flax give back the same bits."""
    model = port_state(norm_kind, "sgd").model
    params, stats = convert.flax_from_state_dict(model.state_dict())
    back = convert.variables_from_flax(params, stats)
    ours = model.state_dict()
    assert set(back) == set(ours)
    for name, t in ours.items():
        assert torch.equal(back[name], t), name
    params2, stats2 = convert.flax_from_state_dict(back)
    for a, b in ((params, params2), (stats, stats2)):
        flat_a, flat_b = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (p, x), (_, y) in zip(flat_a, flat_b):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(p))
    assert (len(stats) > 0) == (norm_kind == "bn")


@pytest.mark.parametrize(
    "norm_kind,opt,close",
    [("bn", "sgd", True), ("gn", "adam", False), ("bn", "plateau", True),
     ("gn", "sgd-frozen-backbone", False)],
)
def test_round_trip_is_bit_exact(tmp_path, norm_kind, opt, close):
    """Params, buffers, momentum (or Adam's moments), counts, plateau state
    and step come back bit for bit, onto a state built from other weights,
    and the next step's loss is the same bit for bit.  The checkpoint is
    complete after ``close()``, and after ``wait()`` with the writer still
    running."""
    state = port_state(norm_kind, opt)
    port_steps(state, [0])
    manager = t_ckpt.CheckpointManager(str(tmp_path))
    assert manager.save(state)
    if close:
        manager.close()
    else:
        manager.wait()
    saved = t_state.snapshot(state)
    fresh = port_state(norm_kind, opt, seed=7)
    assert not np.array_equal(saved[-2][1], t_state.snapshot(fresh)[-2][1])
    t_ckpt.CheckpointManager(str(tmp_path)).restore(fresh)
    assert fresh.step == 1 and fresh.optimizer.count == 1
    leaves_equal(t_state.snapshot(fresh), saved)
    assert port_steps(fresh, [1]) == port_steps(state, [1])
    manager.close()


def test_torn_checkpoints_are_skipped(tmp_path, capfd):
    state = port_state("gn", "sgd")
    manager = t_ckpt.CheckpointManager(str(tmp_path), max_to_keep=10)
    for step in (2, 4, 6):
        state.step = step
        manager.save(state)
    manager.close()
    os.remove(tmp_path / "ckpt-6" / "manifest.json")  # killed before the commit
    with open(tmp_path / "ckpt-4" / "leaf_00003.npy", "ab") as f:  # files differ from the manifest
        f.write(b"\0")
    os.makedirs(tmp_path / ".tmp-8-123")  # a write in flight elsewhere
    assert t_ckpt.scan_checkpoints(str(tmp_path)) == [(2, str(tmp_path / "ckpt-2"))]
    err = capfd.readouterr().err
    assert err.count("ckpt_torn_skipped") == 2 and "no manifest" in err and "truncated" in err
    fresh = port_state("gn", "sgd", seed=3)
    t_ckpt.CheckpointManager(str(tmp_path)).restore(fresh)
    assert fresh.step == 2


def test_restore_checks_each_leaf_crc(tmp_path):
    """A leaf damaged in place (its size unchanged, so the scan cannot see
    it) fails the restore, and nothing is written."""
    state = port_state("gn", "sgd")
    save_now(str(tmp_path), state)
    leaf = tmp_path / "ckpt-0" / "leaf_00000.npy"
    data = bytearray(leaf.read_bytes())
    data[-1] ^= 0xFF
    leaf.write_bytes(bytes(data))
    fresh = port_state("gn", "sgd", seed=3)
    before = t_state.snapshot(fresh)
    with pytest.raises(ValueError, match="fails its crc32"):
        t_ckpt.CheckpointManager(str(tmp_path)).restore(fresh)
    leaves_equal(t_state.snapshot(fresh), before)


def test_max_to_keep_holds(tmp_path):
    state = port_state("gn", "sgd")
    manager = t_ckpt.CheckpointManager(str(tmp_path), max_to_keep=2, save_interval_steps=1)
    for step in range(1, 6):
        state.step = step
        assert manager.save(state)
        assert not manager.save(state)  # once a step
    manager.close()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-4", "ckpt-5"]
    assert manager.latest_step() == 5


def test_writer_failure_is_raised_at_the_next_save(tmp_path, monkeypatch):
    state = port_state("gn", "sgd")
    manager = t_ckpt.CheckpointManager(str(tmp_path))

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt, "_write_step_dir", fail)
    assert manager.save(state, step=1)  # queued; the write fails in the writer thread
    with pytest.raises(RuntimeError, match="checkpoint write failed") as info:
        manager.save(state, step=2)
    assert isinstance(info.value.__cause__, OSError)
    monkeypatch.undo()
    assert manager.save(state, step=3)
    manager.close()
    assert t_ckpt.latest_step(str(tmp_path)) == 3
    assert not any(t.name == "ckpt-writer" for t in threading.enumerate())


def test_restore_refuses_another_model(tmp_path):
    state = port_state("gn", "sgd")
    save_now(str(tmp_path), state)
    other = port_state("bn", "sgd")  # BatchNorm statistics the checkpoint lacks
    before = t_state.snapshot(other)
    with pytest.raises(ValueError, match="missing leaves"):
        t_ckpt.CheckpointManager(str(tmp_path)).restore(other)
    leaves_equal(t_state.snapshot(other), before)  # nothing written


@pytest.mark.parametrize(
    "norm_kind,opt,backbone",
    [("gn", "sgd", "resnet_test"), ("bn", "adam-plateau", "resnet_test"),
     ("gn", "sgd-momentum0", "resnet_test"), ("gn", "sgd", "mobilenet")],
    ids=["gn-sgd", "bn-adam-plateau", "gn-sgd-momentum0", "gn-sgd-mobilenet"],
)
def test_checkpoints_move_between_the_packages(tmp_path, norm_kind, opt, backbone):
    """JAX trains 2 steps and its CheckpointManager saves; the port restores
    that onto other weights and its step 3 gives JAX's step-3 loss.  Then
    the port saves its step-3 state, JAX's CheckpointManager restores it
    into a fresh JAX state, and step 4 agrees the same way.  The MobileNet
    case carries depthwise kernels, (3, 3, 1, C) in the checkpoint."""
    seeded = port_state(norm_kind, opt, backbone=backbone)
    j_st, j_step_fn = jax_state(norm_kind, opt, seeded, backbone)
    template = j_st
    for seed in (0, 1):
        j_st, _ = jax_step(j_step_fn, j_st, seed)
    j_manager = j_ckpt.CheckpointManager(str(tmp_path / "jax"), async_save=False)
    j_manager.save(j_st, step=2)
    j_manager.close()
    j_st, want3 = jax_step(j_step_fn, j_st, 2)

    port = port_state(norm_kind, opt, seed=7, backbone=backbone)
    t_ckpt.CheckpointManager(str(tmp_path / "jax")).restore(port)
    assert port.step == 2
    (got3,) = port_steps(port, [2])
    np.testing.assert_allclose(got3, want3, rtol=RTOL)

    save_now(str(tmp_path / "port"), port)
    restored = j_ckpt.CheckpointManager(str(tmp_path / "port")).restore(template)
    restored = jax.tree.map(jnp.asarray, restored)
    assert int(restored.step) == 3
    _, want4 = jax_step(j_step_fn, restored, 3)
    (got4,) = port_steps(port, [3])
    np.testing.assert_allclose(got4, want4, rtol=RTOL)
    assert got4 != got3


def test_pod_checkpoint_restores_on_one_card(tmp_path, capfd):
    """A checkpoint in the JAX package's ZeRO layout for world 4 (flat
    zero-padded optimizer leaves, ``zero_world_size`` 4) with gradient-
    compression residuals restores into the port: the momentum equals the
    replicated checkpoint's, and the residuals are dropped with one
    ``ef_reset`` line."""
    state = port_state("gn", "sgd")
    port_steps(state, [0])
    leaves = t_state.snapshot(state)
    world = 4
    pod = []
    for path, arr in leaves:
        if path.startswith("['opt_state']") and arr.ndim:
            chunk = -(-arr.size // world)
            arr = j_reshard(arr, (world * chunk,), arr.dtype, path)
        pod.append((path, arr))
    pod.append(("['comm_state']['bucket_0']", np.ones(8, np.float32)))
    j_ckpt._write_step_dir(str(tmp_path), 1, pod, world, {})
    assert t_ckpt.read_manifest(str(tmp_path))["zero_world_size"] == world
    fresh = port_state("gn", "sgd", seed=7)
    t_ckpt.CheckpointManager(str(tmp_path)).restore(fresh)
    leaves_equal(t_state.snapshot(fresh), leaves)
    assert capfd.readouterr().err.count('"event": "ef_reset"') == 1


def test_restore_arrays_nests_params(tmp_path):
    state = port_state("bn", "plateau")
    save_now(str(tmp_path), state)
    tree = t_ckpt.CheckpointManager(str(tmp_path)).restore_arrays()
    params, stats = convert.flax_from_state_dict(state.model.state_dict())
    np.testing.assert_array_equal(tree["params"]["fpn"]["out_p3"]["kernel"], params["fpn"]["out_p3"]["kernel"])
    np.testing.assert_array_equal(tree["batch_stats"]["backbone"]["stem_norm"]["var"],
                                  stats["backbone"]["stem_norm"]["var"])
    assert int(tree["step"]) == 0 and "['opt_state'][1].scale" in tree["opt_state"]
