"""The port's NMS suppression stage (``ops/cuda/nms.py``) against the JAX
package's Pallas kernel, run in interpret mode on the CPU.

Here the wrapper takes its plain version (the tensors lie on the CPU) and
counts that call; the keep masks and the whole batched pipeline are held
bit for bit on the cases of tests/unit/test_pallas_nms.py.  The tests
marked ``gpu`` hold the CUDA kernel against the plain version on a card
and skip without one.  JAX is imported inside the tests that compare with
it, so the ``gpu`` tests also run where only PyTorch is installed
(``python -m pytest -m gpu --noconftest tests/test_torch_nms.py``).
"""

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as t_nms
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import cases
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda

NEG_INF = t_nms._NEG_INF


def random_boxes_scores(batch, num, num_classes, seed=0, dup_frac=0.3):
    """Box/score fields with deliberate near-duplicates so real suppression
    chains form (the field of tests/unit/test_pallas_nms.py)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (batch, num, 2)).astype(np.float32)
    wh = rng.uniform(4, 120, (batch, num, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    ndup = int(num * dup_frac)
    if ndup:
        src = rng.integers(0, num, (batch, ndup))
        jitter = rng.normal(0, 3, (batch, ndup, 4)).astype(np.float32)
        for b in range(batch):
            boxes[b, :ndup] = boxes[b, src[b]] + jitter[b]
    scores = rng.uniform(0, 1, (batch, num, num_classes)).astype(np.float32)
    return boxes, scores


def quantised(scores):
    """Scores on a grid of 1/16: most candidates tie with others."""
    return (np.round(scores * 16.0) / 16.0).astype(np.float32)


def jax_modules():
    """(jax.numpy, the JAX package's ops.pallas.nms), imported on use."""
    jnp = pytest.importorskip("jax.numpy")
    from batchai_retinanet_horovod_coco_tpu.ops.pallas import nms as pallas_nms

    return jnp, pallas_nms


def candidates(batch, k, num_classes, seed, tied=False):
    """Sorted candidates from the port's (bit-equal) selection stage."""
    boxes, scores = random_boxes_scores(batch, k, num_classes, seed=seed)
    if tied:
        scores = quantised(scores)
    sel = t_nms.select_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, k
    )
    return tuple(t.contiguous() for t in sel)


def pallas_keep(cb, cs, ci, block_k=128):
    jnp, pallas_nms = jax_modules()
    keep = pallas_nms.nms_keep_mask(
        jnp.asarray(cb.numpy()), jnp.asarray(cs.numpy()), jnp.asarray(ci.numpy()),
        0.5, block_k=block_k, interpret=True,
    )
    return np.asarray(keep)


def as_torch(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def port_keep(cb, cs, ci):
    before = nms_cuda.plain_calls
    keep = nms_cuda.nms_keep_mask(cb, cs, ci, 0.5)
    assert nms_cuda.plain_calls == before + 1
    return keep.numpy()


@pytest.mark.parametrize(
    "batch,k,block_k,tied",
    [
        (1, 128, 128, False),  # single block
        (2, 384, 128, False),  # three blocks: cross-block suppression
        (1, 300, 128, False),  # K not a block multiple
        (2, 500, 256, True),   # partial second block, tied scores
    ],
)
def test_keep_mask_bit_identical_to_pallas(batch, k, block_k, tied):
    cb, cs, ci = candidates(batch, k, 5, seed=k, tied=tied)
    got = port_keep(cb, cs, ci)
    np.testing.assert_array_equal(got, pallas_keep(cb, cs, ci, block_k))
    assert got.any() and not got.all()


def test_cross_block_suppression_chain():
    """A kept box suppresses its copies one and two blocks later (across
    the kernel's 64-wide mask words and the Pallas kernel's 128-wide
    blocks), while a suppressed box suppresses nothing."""
    block = 128
    cb, cs, ci = as_torch(cases.suppression_chain(block))
    got = port_keep(cb, cs, ci)
    np.testing.assert_array_equal(got, pallas_keep(cb, cs, ci, block))
    keep = got[0]
    assert keep[0] and not keep[1]
    assert not keep[block + 1] and not keep[2 * block + 2] and not keep[2 * block + 5]


# Cases aimed at the kernel's blocked scan (64-candidate words), as
# builders of sorted (boxes, scores, class ids) on the CPU, with the kept
# count an image where it is known.
SCAN_CASES = {
    "one box repeated": (lambda: as_torch(cases.one_box_repeated(2, 1000)), 1),
    "disjoint boxes": (lambda: as_torch(cases.disjoint_boxes(2, 1000)), 1000),
    "K 65": (lambda: candidates(2, 65, 3, seed=65), None),
    "K 129": (lambda: candidates(2, 129, 3, seed=129), None),
    "cross-word chain": (lambda: as_torch(cases.suppression_chain()), None),
}


@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_cases_bit_identical_to_pallas(name):
    build, kept = SCAN_CASES[name]
    cb, cs, ci = build()
    got = port_keep(cb, cs, ci)
    np.testing.assert_array_equal(got, pallas_keep(cb, cs, ci))
    if kept is not None:
        assert (got.sum(-1) == kept).all()
    assert got.any() and (kept is not None or not got.all())


def test_same_class_masking():
    box = np.array([5.0, 5.0, 50.0, 50.0], np.float32)
    cb = torch.from_numpy(np.tile(box, (4, 1))[None].copy())
    cs = torch.tensor([[0.9, 0.8, 0.7, 0.6]], dtype=torch.float32)
    ci = torch.tensor([[0, 1, 0, 1]], dtype=torch.int32)
    got = port_keep(cb, cs, ci)
    np.testing.assert_array_equal(got, pallas_keep(cb, cs, ci))
    assert got.tolist() == [[True, True, False, False]]


def test_all_padding_and_padding_never_suppresses():
    k = 130
    boxes = np.zeros((2, k, 4), np.float32)
    scores = np.full((2, k), NEG_INF, np.float32)
    cls = np.full((2, k), -1, np.int32)
    boxes[1, 0] = [0.0, 0.0, 10.0, 10.0]  # image 0 is all padding
    scores[1, 0] = 0.9
    cls[1, 0] = 2
    cb, cs, ci = (torch.from_numpy(a) for a in (boxes, scores, cls))
    got = port_keep(cb, cs, ci)
    np.testing.assert_array_equal(got, pallas_keep(cb, cs, ci))
    assert not got[0].any()
    assert got[1, 0] and not got[1, 1:].any()


@pytest.mark.parametrize("pre_nms_size,tied", [(128, False), (1000, False), (500, True)])
def test_batched_multiclass_nms_bit_identical(pre_nms_size, tied):
    boxes, scores = random_boxes_scores(2, 800, 6, seed=3)
    if tied:
        scores = quantised(scores)
    jnp, pallas_nms = jax_modules()
    ref = pallas_nms.batched_multiclass_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), pre_nms_size=pre_nms_size,
        block_k=128, interpret=True,
    )
    before = nms_cuda.plain_calls
    got = nms_cuda.batched_multiclass_nms_cuda(
        torch.from_numpy(boxes), torch.from_numpy(scores), pre_nms_size=pre_nms_size
    )
    assert nms_cuda.plain_calls == before + 1
    for field in t_nms.Detections._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.valid.any()


@pytest.mark.parametrize(
    "bad",
    [
        lambda b, s, c: (b.double(), s, c),  # wrong dtype
        lambda b, s, c: (b, s, c.long()),
        lambda b, s, c: (b[:, :-1], s, c),  # wrong shape
        lambda b, s, c: (b.transpose(0, 1).contiguous().transpose(0, 1), s, c),
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    cb, cs, ci = candidates(2, 64, 3, seed=0)
    with pytest.raises((TypeError, ValueError)):
        nms_cuda.nms_keep_mask(*bad(cb, cs, ci))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


CARD_CASES = {
    "B 8 K 1000": lambda: candidates(8, 1000, 8, seed=0),
    "B 8 K 1000 tied": lambda: candidates(8, 1000, 8, seed=1, tied=True),
    "B 3 K 300": lambda: candidates(3, 300, 8, seed=2),
    "B 2 K 8192": lambda: candidates(2, 8192, 8, seed=3),
    **{name: build for name, (build, _) in SCAN_CASES.items()},
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_kernel_equals_plain_on_card(name):
    dev = _cuda_or_skip()
    cb, cs, ci = (t.to(dev) for t in CARD_CASES[name]())
    before = nms_cuda.kernel_launches
    got = nms_cuda.nms_keep_mask(cb, cs, ci, 0.5)
    torch.cuda.synchronize()
    assert nms_cuda.kernel_launches == before + 1
    want = nms_cuda.nms_keep_mask_plain(cb, cs, ci, 0.5)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_all_padding_on_card():
    dev = _cuda_or_skip()
    cb = torch.zeros((2, 200, 4), device=dev)
    cs = torch.full((2, 200), NEG_INF, device=dev)
    ci = torch.full((2, 200), -1, dtype=torch.int32, device=dev)
    got = nms_cuda.nms_keep_mask(cb, cs, ci, 0.5)
    assert not got.any().item()
