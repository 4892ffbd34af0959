"""The port's training slice (``train/``, ``models/resnet.py::BatchNorm``,
``data/pipeline.py::assemble``) against the JAX package's.

The train step runs the golden configuration of
tests/integration/test_golden.py (resnet_test, 64 x 64, 3 classes, FPN and
heads 16 x 1, f32, sgd 1e-2 with momentum 0.9) on both sides from the same
flax weights (carried across by ``models/convert.py``), the JAX step with
its fused Pallas kernels in interpret mode.  Three steps' losses agree
within rel 1e-4.  Each parameter tensor (and, for ``"bn"``, each BatchNorm
statistic) agrees within 3e-2 of how far the three steps moved it, in L2.
The two frameworks sum convolutions and norms in different orders, which
moves f32 results by a few ulps a layer, and the norms over the 2 x 2 maps
at C5 make this tiny model's backbone gradients ill-conditioned: f32
rounding alone (the port in f32 against the port in f64) moves those
updates by about as much.  Both sides start from the port's seeded
weights, carried into flax trees and back through ``models/convert.py``.
The optimizer's schedules and clip are held against
optax's, and its updates, with weight decay, momentum, clipping and a
frozen backbone, against the JAX chain's.
"""

import copy
import dataclasses
import functools
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.data.prefetch import prefetch_map
from batchai_retinanet_horovod_coco_tpu_torch.models import resnet as t_resnet
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import (
    load_flax_variables,
    variables_from_flax,
)
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step

HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These models are tiny: torch's intra-op threads only contend with
    the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

GOLDEN = dict(num_classes=3, backbone="resnet_test", fpn_channels=16, head_width=16, head_depth=1)
# sgd 1e-2, momentum 0.9, as the golden run's optax.sgd: no decay, no
# warmup, and a clip far above any norm (its scale is then exactly 1).
GOLDEN_OPT = dict(
    base_lr=0.01, global_batch_size=256, warmup_steps=0, schedule="constant",
    weight_decay=0.0, clip_global_norm=1e9,
)
STEPS = 3
RTOL = 1e-4


def golden_batch(seed=0, batch=4, max_gt=4):
    """uint8 images and 0..max_gt gts an image (one image with none)."""
    rng = np.random.default_rng(seed)
    examples = []
    for i in range(batch):
        n = 0 if i == batch - 1 else int(rng.integers(1, max_gt + 1))
        xy = rng.uniform(0, 40, (n, 2))
        wh = rng.uniform(6, 30, (n, 2))
        boxes = np.concatenate([xy, np.minimum(xy + wh, 64)], 1).astype(np.float32)
        image = rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
        examples.append((image, boxes, rng.integers(0, 3, n).astype(np.int32), 1.0))
    return t_pipeline.assemble(examples, list(range(batch)), HW, max_gt=max_gt)


def flax_variables(model: torch.nn.Module):
    """The port model's weights as flax ``params`` / ``batch_stats`` trees
    (the inverse of ``models/convert.py``, which the port loads them back
    through): seeded weights without a flax ``init`` compile."""
    params, batch_stats = {}, {}
    for name, value in model.state_dict().items():
        *scope, leaf = name.split(".")
        array = value.numpy()
        if leaf in ("running_mean", "running_var"):
            tree, leaf = batch_stats, leaf.removeprefix("running_")
        elif leaf == "weight" and array.ndim == 4:
            tree, leaf, array = params, "kernel", array.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            tree, leaf = params, {"weight": "scale"}.get(leaf, leaf)
        for key in scope:
            tree = tree.setdefault(key, {})
        tree[leaf] = np.ascontiguousarray(array)
    return params, batch_stats


def run_jax(norm_kind, opt, batch):
    model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm_kind, stem="conv", dtype=jnp.float32)
    )
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**opt))
    seeded = t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm_kind, dtype=torch.float32),
        device="cpu", seed=42,
    )
    initial = flax_variables(seeded)
    params = jax.tree.map(jnp.asarray, initial[0])
    state = j_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, initial[1]),
        opt_state=tx.init(params), tx=tx,
    )
    step = j_step.make_train_step(
        model, HW, 3,
        loss_config=j_losses.LossConfig(pallas_focal=True, pallas_interpret=True),
        matching_config=j_matching.MatchingConfig(fused_pallas=True, pallas_interpret=True),
        donate_state=False,
    )
    arrays = {k: jnp.asarray(getattr(batch, k)) for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    history = []
    for _ in range(STEPS):
        state, metrics = step(state, arrays)
        history.append({k: float(v) for k, v in jax.device_get(metrics).items()})
    return initial, history, jax.device_get((state.params, state.batch_stats))


def run_port(norm_kind, opt, batch, initial):
    model = t_retinanet.RetinaNet(
        t_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm_kind, dtype=torch.float32)
    )
    load_flax_variables(model, *initial)
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**opt), device="cpu")
    step = t_step.make_train_step(model, HW, 3, device="cpu")
    arrays = t_loop.device_batch(batch, torch.device("cpu"))
    history = [
        {k: float(v) for k, v in step(state, arrays).items()} for _ in range(STEPS)
    ]
    assert state.step == STEPS
    return history, model


@pytest.mark.parametrize(
    "norm_kind,opt",
    [
        ("gn", GOLDEN_OPT),
        ("bn", GOLDEN_OPT),
    ],
    ids=["gn-golden", "bn-golden"],
)
def test_train_steps_match_jax(norm_kind, opt):
    batch = golden_batch()
    initial, want, final = run_jax(norm_kind, opt, batch)
    got, model = run_port(norm_kind, opt, batch, initial)
    for g, w in zip(got, want):
        for key in ("loss", "cls_loss", "box_loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        assert g["num_pos"] == w["num_pos"]
    assert [g["loss"] for g in got] != [got[0]["loss"]] * STEPS
    start, end = variables_from_flax(*initial), variables_from_flax(*final)
    ours = model.state_dict()
    assert set(end) == set(ours)
    for name, want_v in end.items():
        err = torch.linalg.vector_norm(ours[name] - want_v)
        moved = torch.linalg.vector_norm(want_v - start[name])
        assert err <= 3e-2 * moved + 1e-6 * torch.linalg.vector_norm(want_v), name
    if norm_kind == "bn":  # the statistics moved, as flax moved them
        assert any(".running_var" in n for n in end)
        assert not torch.equal(
            ours["backbone.stem_norm.running_var"], torch.ones_like(ours["backbone.stem_norm.running_var"])
        )


def test_batchnorm_trains_like_flax():
    """Batch statistics, biased variance and momentum 0.9, as flax; torch's
    own ``F.batch_norm(training=True)`` stores n/(n-1) times the variance
    and weights the batch by its momentum argument."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, (2, 3, 3, 8)).astype(np.float32)  # n = 18 a channel
    layer = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    variables = layer.init(jax.random.key(0), x)
    want, updated = layer.apply(variables, x, mutable=["batch_stats"])
    port = t_resnet.BatchNorm(8, torch.float32).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    mean, var = torch.zeros(8), torch.ones(8)
    torch.nn.functional.batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), mean, var, training=True, momentum=0.1
    )
    batch_var = (np.asarray(stats["var"]) - 0.9) / 0.1
    np.testing.assert_allclose(var.numpy(), 0.9 + 0.1 * batch_var * 18 / 17, rtol=1e-5)
    frozen = t_resnet.BatchNorm(8, torch.float32, frozen=True).train()
    frozen(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert torch.equal(frozen.running_var, torch.ones(8))


SCHEDULES = {
    "multistep": dict(schedule="multistep", warmup_steps=50, total_steps=900),
    "multistep, no warmup": dict(schedule="multistep", warmup_steps=0, total_steps=900),
    "cosine": dict(schedule="cosine", warmup_steps=50, total_steps=900),
    "constant": dict(schedule="constant", warmup_steps=50, total_steps=900),
    "adam constant": dict(optimizer="adam", base_lr=1e-4, world_size=4, schedule="constant",
                          warmup_steps=5, total_steps=100),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_equals_optax(name):
    cfg = SCHEDULES[name]
    want = j_optim.make_schedule(j_optim.OptimizerConfig(**cfg))
    got = t_optim.make_schedule(t_optim.OptimizerConfig(**cfg))
    total, warmup = cfg["total_steps"], cfg["warmup_steps"]
    steps = {0, 1, warmup - 1, warmup, warmup + 1, total - 1, total, total + 10}
    for m in (2 / 3, 8 / 9):
        steps |= {int(m * total) - 1, int(m * total), int(m * total) + 1}
    for s in sorted(x for x in steps if x >= 0):
        # optax computes in f32 (its warmup ramp rounds to ~2e-6, its cosine
        # near the end to ~1e-11 absolute), the port in f64.
        np.testing.assert_allclose(
            got(s), float(want(s)), rtol=1e-5, atol=1e-6 * t_optim.peak_lr(t_optim.OptimizerConfig(**cfg)),
            err_msg=f"step {s}",
        )


def test_plateau_is_not_ported():
    """The plateau schedule's base LR is optax's (a flat peak after the
    warmup); its decay is the optimizer's ``Plateau`` scale
    (test_plateau_equals_optax)."""
    cfg = dict(schedule="plateau", warmup_steps=50, total_steps=900)
    want = j_optim.make_schedule(j_optim.OptimizerConfig(**cfg))
    got = t_optim.make_schedule(t_optim.OptimizerConfig(**cfg))
    for s in (0, 1, 49, 50, 51, 899, 900):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-5, err_msg=f"step {s}")


def plateau_losses(n=200, seed=0):
    """A loss that falls, then plateaus, then falls again, with noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    trend = np.where(t < 60, 3.0 - 0.02 * t, np.where(t < 140, 1.8, 1.8 - 0.01 * (t - 140)))
    return (trend + rng.normal(0, 0.05, n)).astype(np.float32)


@pytest.mark.parametrize(
    "window,patience,min_delta",
    [(1, 3, 1e-4), (5, 2, 1e-2), (10, 1, 0.0)],
    ids=["window-1", "window-5", "min-delta-0"],
)
def test_plateau_equals_optax(window, patience, min_delta):
    """The port's controller and ``optax.contrib.reduce_on_plateau`` as the
    JAX chain configures it, fed the same 200 losses: identical scales."""
    cfg = dict(schedule="plateau", plateau_factor=0.5, plateau_patience=patience,
               plateau_window=window, plateau_min_delta=min_delta)
    tx = optax.contrib.reduce_on_plateau(
        factor=0.5, patience=patience, rtol=0.0, atol=max(min_delta, 1e-12), accumulation_size=window
    )
    params = {"w": jnp.zeros(3)}
    opt_state = tx.init(params)
    update = jax.jit(lambda state, value: tx.update(params, state, params, value=value)[1])
    plateau = t_optim.Plateau(t_optim.OptimizerConfig(**cfg), torch.device("cpu"))
    want, got = [], []
    for loss in plateau_losses():
        opt_state = update(opt_state, jnp.float32(loss))
        want.append(float(opt_state.scale))
        got.append(float(plateau.update(torch.tensor(loss))))
    assert got == want
    assert len(set(got)) > 2  # the scale did fall, more than once
    for field in t_optim.Plateau.FIELDS:
        np.testing.assert_array_equal(plateau.state[field].numpy(), np.asarray(getattr(opt_state, field)))


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e9])
def test_clip_equals_jax(max_norm):
    rng = np.random.default_rng(0)
    grads = [rng.normal(0, 1, s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    norm = float(optax.global_norm(grads))
    want, _ = j_optim.clip_by_global_norm_precomputed(max_norm).update(
        grads, optax.EmptyState(), grad_norm=jnp.float32(norm)
    )
    got = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = t_optim.global_norm(got)
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
    t_optim.clip_by_global_norm_precomputed(got, max_norm, got_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize(
    "opt",
    [
        dict(weight_decay=1e-2, clip_global_norm=1.0, warmup_steps=2),
        dict(weight_decay=1e-2, clip_global_norm=1.0, freeze_backbone=True),
        dict(optimizer="adam", base_lr=1e-3, warmup_steps=2, clip_global_norm=2.0),
        dict(weight_decay=1e-2, clip_global_norm=1.0, schedule="plateau", plateau_window=1,
             plateau_patience=1, plateau_factor=0.5),
    ],
    ids=["sgd", "sgd-frozen-backbone", "adam", "sgd-plateau"],
)
def test_updates_equal_the_jax_chain(opt):
    """Four updates of a small tree with random gradients and a rising loss
    (which the plateau schedule reads): the port's optimizer and the JAX
    chain give the same parameters."""
    rng = np.random.default_rng(1)
    shapes = {"backbone": {"w": (4, 3), "b": (3,)}, "fpn": {"w": (5, 2)}, "cls_head": {"b": (7,)}}
    params = {k: {n: rng.normal(0, 1, s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    config = dict(opt, total_steps=100)
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**config))
    opt_state = tx.init(params)
    named = [(f"{k}.{n}", torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, sub in params.items() for n, v in sub.items()]
    optimizer = t_optim.Optimizer(named, t_optim.OptimizerConfig(**config))
    for i in range(4):
        grads = jax.tree.map(lambda p: rng.normal(0, 2, p.shape).astype(np.float32), params)
        norm = optax.global_norm(grads)
        loss = np.float32(1.0 + i)
        updates, opt_state = tx.update(grads, opt_state, params, grad_norm=norm, value=loss)
        params = jax.device_get(optax.apply_updates(params, updates))
        for name, p in named:
            k, n = name.split(".")
            p.grad = torch.from_numpy(grads[k][n].copy())
        optimizer.step(t_optim.global_norm([p.grad for _, p in named]), torch.tensor(loss))
    if optimizer.plateau is not None:
        assert float(optimizer.plateau.state["scale"]) == 0.125  # halved at updates 2-4
    for name, p in named:
        k, n = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), params[k][n], rtol=1e-5, atol=1e-6)


def test_assemble_equals_jax():
    rng = np.random.default_rng(0)
    examples = []
    for n, (h, w) in zip((3, 0, 7), ((60, 50), (64, 64), (40, 64))):
        boxes = rng.uniform(0, 40, (n, 4)).astype(np.float32)
        examples.append((rng.integers(0, 256, (h, w, 3), dtype=np.uint8), boxes,
                         rng.integers(0, 80, n).astype(np.int32), 0.5))
    want_stats, got_stats = j_pipeline.PipelineStats(), t_pipeline.PipelineStats()
    want = j_pipeline._assemble(
        examples, [5, 6, 7], HW, j_pipeline.PipelineConfig(max_gt=5), want_stats
    )
    got = t_pipeline.assemble(examples, [5, 6, 7], HW, max_gt=5, stats=got_stats)
    for field in t_pipeline.Batch._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert dataclasses.asdict(got_stats) == dataclasses.asdict(want_stats)
    assert got_stats.truncated_boxes == 2 and got_stats.truncated_images == 1


@functools.lru_cache(maxsize=None)
def _seeded_model(norm_kind: str, seed: int) -> torch.nn.Module:
    return t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm_kind, dtype=torch.float32),
        device="cpu", seed=seed,
    )


def small_model(norm_kind: str = "gn", seed: int = 0) -> torch.nn.Module:
    """The golden model from seeded weights: built once per (norm, seed),
    a fresh deep copy for each caller."""
    return copy.deepcopy(_seeded_model(norm_kind, seed))


def small_state(norm_kind="gn", opt=GOLDEN_OPT, seed=0):
    return t_state.create_train_state(small_model(norm_kind, seed), t_optim.OptimizerConfig(**opt), device="cpu")


def test_loop_logs_and_steps():
    state = small_state()
    assert not state.model.training  # build_retinanet serves; the step trains
    logged = []
    batches = (golden_batch(seed=s) for s in range(5))
    t_loop.run_training(state, batches, 3, t_loop.LoopConfig(total_steps=5, log_every=2),
                        log=lambda step, scalars: logged.append((step, scalars)))
    assert state.step == 5 and state.model.training
    assert [s for s, _ in logged] == [2, 4, 5]
    for _, scalars in logged:
        assert {"loss", "cls_loss", "box_loss", "num_pos", "grad_norm", "param_norm",
                "images_per_sec", "step_time_ms", "data_wait_ms", "lr"} <= set(scalars)
        assert np.isfinite(scalars["loss"]) and scalars["lr"] == 0.01


def test_loop_raises_on_a_non_finite_loss():
    state = small_state()
    batch = golden_batch()
    bad = batch._replace(images=np.full(batch.images.shape, np.nan, np.float32))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t_loop.run_training(state, iter([batch, bad]), 3, t_loop.LoopConfig(total_steps=2, log_every=1),
                            log=lambda *_: None)


def test_training_after_serving_in_one_process():
    """Constants cached while serving under ``torch.inference_mode`` (the
    FPN's upsample indices on a non-2x size, the normalization) must stay
    usable by autograd in a later train step."""
    state = small_state()
    hw = (80, 112)  # C5 3 x 4 -> C4 5 x 7: a non-2x upsample
    with torch.inference_mode():
        state.model(torch.zeros((1, *hw, 3)))
    step = t_step.make_train_step(state.model, hw, 3, device="cpu")
    batch = golden_batch()
    images = np.zeros((4, *hw, 3), np.uint8)
    images[:, :64, :64] = batch.images
    arrays = t_loop.device_batch(batch._replace(images=images), torch.device("cpu"))
    assert np.isfinite(float(step(state, arrays)["loss"]))


def test_step_checks_classes_model_and_shape():
    state = small_state()
    with pytest.raises(ValueError, match="classes"):
        t_step.make_train_step(state.model, HW, 80, device="cpu")
    step = t_step.make_train_step(state.model, HW, 3, device="cpu")
    arrays = t_loop.device_batch(golden_batch(), torch.device("cpu"))
    with pytest.raises(ValueError, match="another model"):
        step(small_state(), arrays)
    with pytest.raises(ValueError, match="do not match"):
        step(state, dict(arrays, images=arrays["images"][:, :32]))


@pytest.mark.parametrize("async_eval", [False, True], ids=["sync", "async"])
def test_loop_evaluates_at_its_steps(tmp_path, async_eval):
    """The eval hook runs after steps 2 and 4 and at the end, on the
    weights of its step (an asynchronous one on a snapshot, though it runs
    while later steps change the live weights), and its metrics are logged
    under ``eval/`` in step order, after their step's own log.  The
    profile window [4, 7) is clamped into the run's steps 3-5."""
    state = small_state()
    logged, seen, weights = [], [], {}
    probe = "fpn.out_p3.weight"

    def log(step, scalars):
        logged.append((step, scalars))
        if "loss" in scalars:
            weights[step] = state.model.state_dict()[probe].clone()

    def eval_fn(model):
        time.sleep(0.2)  # later steps run meanwhile
        seen.append(model.state_dict()[probe].clone())
        return {"AP": float(len(seen))}

    config = t_loop.LoopConfig(total_steps=5, log_every=1, eval_every=2, async_eval=async_eval,
                               profile_dir=str(tmp_path), profile_start_step=4, profile_steps=3)
    t_loop.run_training(state, (golden_batch(seed=s) for s in range(5)), 3, config, log=log,
                        eval_fn=eval_fn)
    evals = [(i, step, sc) for i, (step, sc) in enumerate(logged) if "eval/AP" in sc]
    assert [step for _, step, _ in evals] == [2, 4, 5]
    assert [sc["eval/AP"] for _, _, sc in evals] == [1.0, 2.0, 3.0]
    for i, step, _ in evals:
        assert i > next(j for j, (s, sc) in enumerate(logged) if s == step and "loss" in sc)
    for snapshot, step in zip(seen, (2, 4, 5)):
        assert torch.equal(snapshot, weights[step])
    assert not torch.equal(weights[2], weights[4])
    assert os.listdir(tmp_path) == ["trace-steps-3-5.json"]
    assert not any(t.name in ("async-eval", "device-prefetch") for t in threading.enumerate())


def test_loop_resumes_bit_for_bit(tmp_path):
    """A run stopped after step 2 and resumed from its checkpoint, on a
    state built from other weights, logs the losses of the uninterrupted
    run bit for bit (BatchNorm statistics, momentum and the plateau state
    included)."""
    opt = dict(GOLDEN_OPT, schedule="plateau", plateau_window=1, plateau_patience=1)
    batches = [golden_batch(seed=s) for s in range(4)]

    def run(state, start, total, **kw):
        losses = {}
        t_loop.run_training(state, iter(batches[start:]), 3,
                            t_loop.LoopConfig(total_steps=total, log_every=1, **kw),
                            log=lambda step, sc: losses.setdefault(step, (sc["loss"], sc["lr"])))
        return losses

    want = run(small_state("bn", opt), 0, 4)
    first = run(small_state("bn", opt), 0, 2, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    assert first == {k: want[k] for k in (1, 2)}
    resumed = small_state("bn", opt, seed=1)
    got = run(resumed, 2, 4, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    assert got == {k: want[k] for k in (3, 4)}
    assert want[4][1] < want[1][1]  # the plateau scale fell and was restored
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-4"]


def test_loop_async_eval_error_surfaces():
    state = small_state()

    def eval_fn(model):
        raise ValueError("eval crashed")

    config = t_loop.LoopConfig(total_steps=4, log_every=1, eval_every=1, async_eval=True)
    with pytest.raises(RuntimeError, match="async eval hook failed") as info:
        t_loop.run_training(state, (golden_batch(seed=s) for s in range(4)), 3, config,
                            log=lambda *_: None, eval_fn=eval_fn)
    assert isinstance(info.value.__cause__, ValueError)
    assert state.step < 4


def test_loop_error_closes_the_writer_and_the_prefetch_thread(tmp_path):
    """A step that raises (a batch of 4-channel images) ends the run with
    its own error; the checkpoint in flight lands, and neither the writer
    nor the prefetch thread outlives the run."""
    state = small_state()
    batch = golden_batch()
    bad = batch._replace(images=np.zeros((*batch.images.shape[:3], 4), np.uint8))
    config = t_loop.LoopConfig(total_steps=4, log_every=1, checkpoint_every=1,
                               checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="must match the size"):
        t_loop.run_training(state, iter([batch, batch, bad, batch]), 3, config, log=lambda *_: None)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-1", "ckpt-2"]
    names = {t.name for t in threading.enumerate()}
    assert not names & {"ckpt-writer", "device-prefetch"}, names


def test_prefetch_map_reraises_and_stops():
    def failing():
        yield 1
        yield 2
        raise OSError("decode worker died")

    it = prefetch_map(failing(), lambda x: x * 10, depth=2)
    assert [next(it), next(it)] == [10, 20]
    with pytest.raises(OSError, match="decode worker died"):
        next(it)
    assert list(prefetch_map(range(5), lambda x: -x, depth=0)) == [0, -1, -2, -3, -4]

    produced = []

    def endless():
        while True:
            produced.append(len(produced))
            yield produced[-1]

    it = prefetch_map(endless(), lambda x: x, depth=2, thread_name="test-prefetch")
    assert next(it) == 0
    it.close()  # the producer is blocked on the full queue
    assert not any(t.name == "test-prefetch" for t in threading.enumerate())
    count = len(produced)
    time.sleep(0.3)
    assert len(produced) == count <= 5
