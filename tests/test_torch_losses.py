"""The port's losses (``losses.py``) and focal wrapper (``ops/cuda/focal.py``)
against the JAX package's, with its fused focal kernels in interpret mode.

On the CPU ``focal_loss_per_image_sums`` takes its plain version (counted):
the exp-form sums under autograd.  Its per-image sums must agree with the
Pallas forward kernel within rel 1e-5 (the two sum ~1e5 terms in different
orders), and its gradient, from autograd, with the Pallas backward kernel's
closed form within 1e-6 of the largest gradient.  Logits reach beyond
+-20, where torch's ``softplus`` (which returns x above 20) and
``jax.nn.softplus`` (``logaddexp(x, 0)``) part ways.  Tests marked ``gpu``
hold the CUDA kernels against the plain version on a card
(``python -m pytest -m gpu --noconftest tests/test_torch_losses.py``).
"""

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as t_losses
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as t_matching
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda

RTOL_SUMS = 1e-5
GRAD_TOL = 1e-6  # of max |grad|


def jax_modules():
    """(jax, jax.numpy, the JAX package's losses, its Pallas focal)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from batchai_retinanet_horovod_coco_tpu import losses as j_losses
    from batchai_retinanet_horovod_coco_tpu.ops.pallas import focal as j_focal

    return jax, jnp, j_losses, j_focal


def loss_inputs(batch, anchors, classes, seed, wide=True):
    """Logits uniform in [-12, 12] with some beyond +-20 and some exactly
    0, labels, states (about 2% positive, 10% ignored) and box predictions
    and targets."""
    rng = np.random.default_rng(seed)
    logits = rng.uniform(-12, 12, (batch, anchors, classes)).astype(np.float32)
    if wide:
        far = rng.random(logits.shape) < 0.02
        logits[far] = rng.choice([-30.0, -21.0, 0.0, 21.0, 30.0], far.sum())
    labels = rng.integers(0, classes, (batch, anchors)).astype(np.int32)
    state = rng.choice([-1, 0, 1], (batch, anchors), p=[0.1, 0.88, 0.02]).astype(np.int32)
    state[-1] = np.where(state[-1] == 1, 0, state[-1])  # an image with no positive
    box_preds = rng.normal(0, 1, (batch, anchors, 4)).astype(np.float32)
    box_targets = rng.normal(0, 1, (batch, anchors, 4)).astype(np.float32)
    box_targets[state != 1] = 0.0
    return logits, labels, state, box_preds, box_targets


CASES = {  # (batch, anchors, classes)
    "K 80": (2, 1500, 80),
    "K 3": (3, 700, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_focal_sums_and_grad_match_pallas(case):
    jax, jnp, _, j_focal = jax_modules()
    logits, labels, state, *_ = loss_inputs(*CASES[case], seed=0)
    weights = np.random.default_rng(1).uniform(0.5, 2.0, logits.shape[0]).astype(np.float32)

    def jax_weighted(x):
        sums = j_focal.focal_loss_per_image_sums(
            x, jnp.asarray(labels), jnp.asarray(state), 0.25, 2.0, True
        )
        return jnp.sum(sums * weights), sums

    (_, want), want_grad = jax.value_and_grad(jax_weighted, has_aux=True)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    before = focal_cuda.plain_calls
    got = focal_cuda.focal_loss_per_image_sums(
        x, torch.from_numpy(labels), torch.from_numpy(state), 0.25, 2.0
    )
    assert focal_cuda.plain_calls == before + 1
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL_SUMS)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(
        x.grad.numpy(), want_grad, rtol=0, atol=GRAD_TOL * np.abs(want_grad).max()
    )
    ignored = state == t_matching.IGNORE
    assert not x.grad.numpy()[ignored].any()


@pytest.mark.parametrize("pallas_focal", [True, False])
def test_total_loss_compact_matches_jax(pallas_focal):
    _, jnp, j_losses, _ = jax_modules()
    logits, labels, state, box_preds, box_targets = loss_inputs(*CASES["K 80"], seed=2)
    want = j_losses.total_loss_compact(
        *(jnp.asarray(a) for a in (logits, box_preds, labels, box_targets, state)),
        j_losses.LossConfig(pallas_focal=pallas_focal, pallas_interpret=True),
    )
    got = t_losses.total_loss_compact(
        *(torch.from_numpy(a) for a in (logits, box_preds, labels, box_targets, state))
    )
    for key in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL_SUMS)


def test_dense_total_loss_matches_jax():
    _, jnp, j_losses, _ = jax_modules()
    logits, labels, state, box_preds, box_targets = loss_inputs(*CASES["K 3"], seed=3)
    onehot = ((labels[..., None] == np.arange(3)) & (state == 1)[..., None]).astype(np.float32)
    config = dict(focal_alpha=0.5, focal_gamma=1.5, smooth_l1_beta=0.2, box_loss_weight=2.0)
    want = j_losses.total_loss(
        *(jnp.asarray(a) for a in (logits, box_preds, onehot, box_targets, state)),
        j_losses.LossConfig(**config),
    )
    got = t_losses.total_loss(
        *(torch.from_numpy(a) for a in (logits, box_preds, onehot, box_targets, state)),
        t_losses.LossConfig(**config),
    )
    for key in ("loss", "cls_loss", "box_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL_SUMS)


def test_softplus_is_logaddexp():
    """Equal to ``jax.nn.softplus`` across +-40; torch's own softplus
    returns x itself above 20."""
    jax, jnp, _, _ = jax_modules()
    x = np.linspace(-40, 40, 8001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = t_losses.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    above = torch.from_numpy(x[x > 20])
    assert torch.equal(torch.nn.functional.softplus(above), above)
    # The derivative at 0 is sigmoid(0); autograd of the formula written out
    # (max(x, 0) + log1p(exp(-|x|))) takes |x|' = 0 there and gives 1.
    zero = torch.zeros(3, requires_grad=True)
    t_losses.softplus(zero).sum().backward()
    assert float(jax.grad(jax.nn.softplus)(0.0)) == 0.5
    assert torch.equal(zero.grad, torch.full((3,), 0.5))


def test_empty_scene_box_loss_is_zero():
    logits, labels, state, box_preds, box_targets = loss_inputs(2, 300, 5, seed=4)
    state[:] = np.where(state == 1, 0, state)
    got = t_losses.total_loss_compact(
        *(torch.from_numpy(a) for a in (logits, box_preds, labels, box_targets, state))
    )
    assert float(got["box_loss"]) == 0.0
    assert np.isfinite(float(got["cls_loss"]))


@pytest.mark.parametrize(
    "bad",
    [
        lambda x, l, s: (x.to(torch.bfloat16), l, s),  # logits not f32
        lambda x, l, s: (x.transpose(1, 2).contiguous().transpose(1, 2), l, s),
        lambda x, l, s: (x[0], l, s),  # logits not (B, A, K)
        lambda x, l, s: (x, l.long(), s),  # labels not int32
        lambda x, l, s: (x, l, s[:, :-1]),  # state not (B, A)
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    logits, labels, state, *_ = loss_inputs(2, 64, 4, seed=5)
    with pytest.raises((TypeError, ValueError)):
        focal_cuda.focal_loss_per_image_sums(
            *bad(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(state))
        )


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_equal_plain_on_card(case):
    dev = _cuda_or_skip()
    logits, labels, state, *_ = loss_inputs(*CASES[case], seed=6)
    x, lab, st = (torch.from_numpy(a).to(dev) for a in (logits, labels, state))
    weights = torch.linspace(0.5, 2.0, x.shape[0], device=dev)
    xk = x.clone().requires_grad_()
    before = (focal_cuda.fwd_launches, focal_cuda.bwd_launches)
    got = focal_cuda.focal_loss_per_image_sums(xk, lab, st)
    again = focal_cuda.focal_loss_per_image_sums(x, lab, st)
    (got * weights).sum().backward()
    torch.cuda.synchronize()
    assert (focal_cuda.fwd_launches, focal_cuda.bwd_launches) == (before[0] + 2, before[1] + 1)
    assert torch.equal(got.detach(), again)  # the same bits every run
    want = focal_cuda.focal_sums_plain(x, lab, st)
    torch.testing.assert_close(got.detach(), want, rtol=RTOL_SUMS, atol=0)
    # Against f64 autograd: f32 autograd's own rounding is about GRAD_TOL.
    xp = x.double().requires_grad_()
    (focal_cuda.focal_sums_plain(xp, lab, st) * weights.double()).sum().backward()
    atol = GRAD_TOL * float(xp.grad.abs().max())
    torch.testing.assert_close(xk.grad.double(), xp.grad, rtol=0, atol=atol)
