"""The JAX package's per-level loss paths (``total_loss_compact_levels``
and ``total_loss_compact_nhwc``, the latter its default arm,
``pallas_focal=False``) and its model's ``return_levels="nhwc"`` outputs,
against the port's one path: the concatenated (B, A, K) outputs into
``losses.total_loss_compact``.

Tolerances: the loss values within rel 1e-5 (f32 sums in another order) of
the JAX functions' on the same seeded inputs, f32 or bf16 logits; the
gradients of the logits within 2e-6 of the largest for f32 logits (autograd
of the port's formula against the JAX closed form: about ten f32 ulps), and
for bf16 logits within one bf16 ulp (2^-7 of the value) plus 1e-6 of the
largest, since the two f32 gradients may round to neighbouring bf16 values
and the smallest ones (1e-18) keep few exact bits in f32; the box gradients
within rel 1e-5.  The port's per-level outputs match the JAX
model's raw NHWC outputs within 1e-5 of their range in f32, and one step of
the port matches the JAX step with ``LossConfig(pallas_focal=False)``, its
NHWC path and its CPU default, within rel 1e-4 (the tolerance of
``test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu_torch import losses as t_losses
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step

from test_torch_train import GOLDEN, GOLDEN_OPT, HW, flax_variables, golden_batch

A_LOC = 9
LEVELS = ((4, 6), (2, 3), (1, 2))  # (h, w) of each level, P3 first
RTOL = 1e-5


def inputs(k: int, dtype: str, seed: int):
    """Per-level NHWC logits and deltas, and (B, A) targets: image 0 mixed,
    image 1 without positives, image 2 all ignored."""
    rng = np.random.default_rng(seed)
    b, a = 3, sum(h * w for h, w in LEVELS) * A_LOC
    cls = [rng.normal(0, 3, (b, h, w, A_LOC * k)).astype(np.float32) for h, w in LEVELS]
    cls[0][0, 0, 0, :3] = (0.0, 25.0, -25.0)
    box = [rng.normal(0, 0.5, (b, h, w, A_LOC * 4)).astype(np.float32) for h, w in LEVELS]
    labels = rng.integers(0, k, (b, a)).astype(np.int32)
    state = rng.choice([-1, 0, 1], (b, a), p=[0.2, 0.6, 0.2]).astype(np.int32)
    state[1][state[1] == 1] = 0
    state[2] = -1
    targets = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    if dtype == "bf16":
        cls = [np.asarray(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32)) for c in cls]
    return cls, box, labels, state, targets


def as_jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def anchor_major(levels, per_anchor):
    """(B, h, w, A·n) levels as (B, h·w·A, n), as the port's heads flatten
    them."""
    return [x.reshape(x.shape[0], -1, per_anchor) for x in levels]


def port_loss(cls_levels, box_levels, labels, targets, state, k):
    """The port's step path on per-level NHWC tensors: each level flattened
    anchor-major and cast to f32, as the model's forward does, then
    concatenated into ``total_loss_compact``."""
    cls = torch.cat([c.float() for c in anchor_major(cls_levels, k)], 1)
    box = torch.cat([b.float() for b in anchor_major(box_levels, 4)], 1)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    return t_losses.total_loss_compact(cls, box, t(labels), t(targets), t(state))


@pytest.mark.parametrize("k", [80, 300])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_concatenated_loss_and_gradient_equal_jax_nhwc(k, dtype):
    cls, box, labels, state, targets = inputs(k, dtype, seed=k)
    config = j_losses.LossConfig()

    def j_loss(cls_levels, box_levels):
        out = j_losses.total_loss_compact_nhwc(
            cls_levels, box_levels, jnp.asarray(labels), jnp.asarray(targets), jnp.asarray(state),
            A_LOC, config)
        return out["loss"], out

    j_cls = tuple(as_jax(c, dtype) for c in cls)
    j_box = tuple(jnp.asarray(x) for x in box)
    (_, want), (want_dcls, want_dbox) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(j_cls, j_box)
    torch_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32
    t_cls = [torch.from_numpy(np.array(c)).to(torch_dtype).requires_grad_() for c in cls]
    t_box = [torch.from_numpy(x).requires_grad_() for x in box]
    got = port_loss(t_cls, t_box, labels, targets, state, k)
    got["loss"].backward()
    for key in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(float(got[key].detach()), float(want[key]), rtol=RTOL, err_msg=key)
    for g, w in zip(t_cls, want_dcls):
        assert g.grad.dtype == g.dtype  # the gradient comes back in the logits' dtype
        gw = np.asarray(w.astype(jnp.float32))
        gg = g.grad.float().numpy()
        if dtype == "f32":
            assert np.abs(gg - gw).max() <= 2e-6 * np.abs(gw).max()
        else:
            assert np.all(np.abs(gg - gw) <= 2.0**-7 * np.abs(gw) + 1e-6 * np.abs(gw).max())
    for g, w in zip(t_box, want_dbox):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("k", [80, 300])
def test_concatenated_loss_equals_jax_levels(k):
    cls, box, labels, state, targets = inputs(k, "f32", seed=k + 1)
    flat_cls, flat_box = anchor_major(cls, k), anchor_major(box, 4)
    want = jax.jit(j_losses.total_loss_compact_levels)(
        tuple(jnp.asarray(c) for c in flat_cls), tuple(jnp.asarray(b) for b in flat_box),
        jnp.asarray(labels), jnp.asarray(targets), jnp.asarray(state))
    got = port_loss([torch.from_numpy(c) for c in cls], [torch.from_numpy(b) for b in box],
                    labels, targets, state, k)
    for key in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, err_msg=key)


def test_level_outputs_equal_the_jax_models_nhwc_outputs():
    config = dict(GOLDEN, norm_kind="gn")
    port = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(**config, dtype=torch.float32),
                                       device="cpu", seed=7)
    params, batch_stats = flax_variables(port)
    jmodel = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**config, stem="conv",
                                                                     dtype=jnp.float32))
    images = np.random.default_rng(7).normal(0, 1, (2, *HW, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, return_levels="nhwc"))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images), return_levels=True)
    for key, per_anchor in (("cls_levels", 3), ("box_levels", 4)):
        assert len(got[key]) == len(want[key]) == 5
        for g, w in zip(got[key], want[key]):
            w = np.asarray(w).reshape(w.shape[0], -1, per_anchor)
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_one_step_equals_the_jax_default_step():
    batch = golden_batch(seed=5)
    config = dict(GOLDEN, norm_kind="gn")
    seeded = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(**config, dtype=torch.float32),
                                         device="cpu", seed=42)
    params, batch_stats = flax_variables(seeded)
    jmodel = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**config, stem="conv",
                                                                     dtype=jnp.float32))
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**GOLDEN_OPT))
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = j_state.TrainState(step=jnp.zeros((), jnp.int32), params=jparams,
                                batch_stats=jax.tree.map(jnp.asarray, batch_stats),
                                opt_state=tx.init(jparams), tx=tx)
    jstep = j_step.make_train_step(
        jmodel, HW, 3, loss_config=j_losses.LossConfig(pallas_focal=False),
        matching_config=j_matching.MatchingConfig(fused_pallas=False), donate_state=False)
    arrays = {k: jnp.asarray(getattr(batch, k)) for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    _, want = jstep(jstate, arrays)
    want = {k: float(v) for k, v in jax.device_get(want).items()}

    model = t_retinanet.RetinaNet(t_retinanet.RetinaNetConfig(**config, dtype=torch.float32))
    load_flax_variables(model, params, batch_stats)
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    step = t_step.make_train_step(model, HW, 3, device="cpu")
    got = {k: float(v) for k, v in step(state, t_loop.device_batch(batch, torch.device("cpu"))).items()}
    for key in ("loss", "cls_loss", "box_loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got["num_pos"] == want["num_pos"]
