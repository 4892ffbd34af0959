"""The port's anchor matching (``ops/matching.py``, ``ops/cuda/matching.py``)
against the JAX package's, with its fused Pallas kernel in interpret mode.

On the CPU the wrapper ``assign_fused`` takes its plain version (counted).
Its five outputs must EQUAL the Pallas kernel's (both argmaxes keep the
first maximum), and its IoUs must equal IEEE f32 arithmetic (numpy) bit for
bit.  XLA on the CPU contracts the IoU's area products into fused
multiply-adds, so on arbitrary coordinates its union, and so its IoU, can
differ from the correctly rounded value by a few ulps and move a
force-matched anchor between near-tied ones.  The comparisons with JAX
therefore use anchors and gt boxes on a grid of 1/4 pixel, where every
product and sum before the divide is exact and the two sides must agree
bit for bit; the IEEE comparison uses the real anchors.
The batched targets must equal both JAX branches of
``anchor_targets_compact_batched`` (fused and vmapped) in states, matched
labels and force-match routing; box targets agree within 1e-5 abs (the
encode's divide and log may round an ulp apart).  Scenes hold ragged gt
counts with padded rows, an all-padding image, duplicated gts (IoU ties
and two gts forced onto one anchor) and tiny gts below the positive
threshold.  ``test_tile_culling_is_exact`` checks, on the real anchors,
the argument that lets the CUDA kernel skip the gts that miss a tile's or
a warp's bounding box.  Tests marked ``gpu`` hold the CUDA kernel against
the plain version on a card; JAX is imported inside the tests that compare
with it, so those run where only PyTorch is installed
(``python -m pytest -m gpu --noconftest tests/test_torch_matching.py``).
"""

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.ops.iou import pairwise_iou
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as t_matching
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.cases import CULLING_EDITS

HW = (96, 128)  # A = 2313: not a multiple of a 512 anchor tile


def scene(batch, num_gt, seed, empty=(), dup=(), tiny=(), hw=HW, grid=True,
          full=False, sizes=(4.0, 60.0), culling=(), tile=256):
    """Padded gts (boxes (B, G, 4) f32, labels (B, G) int32, mask (B, G)
    bool) with 1..G real rows an image (all G if ``full``); ``dup`` images
    repeat their first box (with other labels), ``tiny`` images get 2-4
    pixel boxes, ``grid`` rounds the coordinates to 1/4 pixel, and each
    edit named in ``culling`` (``CULLING_EDITS``) then reshapes the scene
    against the tiles of ``tile`` anchors (the kernel's on the card)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    boxes = np.zeros((batch, num_gt, 4), np.float32)
    labels = rng.integers(0, 5, (batch, num_gt)).astype(np.int32)
    mask = np.zeros((batch, num_gt), bool)
    for b in range(batch):
        n = 0 if b in empty else num_gt if full else int(rng.integers(1, num_gt + 1))
        size = (2.0, 4.0) if b in tiny else sizes
        xy = rng.uniform(0, [w - 8, h - 8], (n, 2))
        wh = rng.uniform(*size, (n, 2))
        boxes[b, :n, :2] = xy
        boxes[b, :n, 2:] = np.minimum(xy + wh, [w, h])
        if b in dup and n >= 3:
            boxes[b, 1] = boxes[b, 0]
            boxes[b, 2] = boxes[b, 0]
            labels[b, 1:3] = (labels[b, 0] + np.array([1, 2])) % 5
        mask[b, :n] = True
        # Padded rows hold junk boxes: the mask alone must drop them.
        boxes[b, n:] = rng.uniform(0, 50, (num_gt - n, 4))
    if grid:
        boxes = np.round(boxes * 4) / 4
    for kind in culling:
        CULLING_EDITS[kind](boxes, mask, rng, anchors_np(hw, grid), tile)
    return boxes, labels, mask


SCENES = {  # one (B, G), so that JAX compiles each function once
    "ragged": dict(batch=3, num_gt=6, seed=0),
    "all padding image": dict(batch=3, num_gt=6, seed=1, empty=(1,)),
    "duplicated gts": dict(batch=3, num_gt=6, seed=2, dup=(0, 1)),
    "tiny gts": dict(batch=3, num_gt=6, seed=3, tiny=(0, 1)),
}
CARD_SCENES = dict(SCENES, **{
    "G 1": dict(batch=2, num_gt=1, seed=4),
    # Aimed at the kernel's culling of gt rows per anchor tile:
    "real rows after padded ones": dict(batch=3, num_gt=6, seed=5, culling=("scatter",)),
    "gts that overlap no anchor": dict(batch=3, num_gt=8, seed=6, culling=("off anchors",)),
    "gt edges on tile box edges": dict(batch=3, num_gt=12, seed=7, culling=("tile edges",)),
    "G 1000 all real": dict(batch=2, num_gt=1000, seed=8, full=True),
    "only gt in the last tile": dict(batch=2, num_gt=6, seed=9, culling=("last tile",)),
})


def anchors_np(hw=HW, grid=True):
    anchors = np.array(t_anchors.anchors_for_image_shape(hw))
    return np.round(anchors * 4) / 4 if grid else anchors


def jax_modules():
    """(jax.numpy, the JAX package's ops.matching, its Pallas matching)."""
    jnp = pytest.importorskip("jax.numpy")
    from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
    from batchai_retinanet_horovod_coco_tpu.ops.pallas import matching as j_pallas

    return jnp, j_matching, j_pallas


def port_inputs(boxes, labels, mask, device="cpu"):
    return tuple(
        torch.from_numpy(x).to(device) for x in (anchors_np(), boxes, labels, mask)
    )


@pytest.mark.parametrize("name", sorted(SCENES))
def test_assign_fused_equals_pallas(name):
    jnp, _, j_pallas = jax_modules()
    boxes, labels, mask = scene(**SCENES[name])
    want = j_pallas.assign_fused(
        jnp.asarray(anchors_np()), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(mask), interpret=True, tile_a=512,
    )
    before = matching_cuda.plain_calls
    got = matching_cuda.assign_fused(*port_inputs(boxes, labels, mask))
    assert matching_cuda.plain_calls == before + 1
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32, torch.int32)
    for g, w, dtype in zip(got, want, dtypes):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(CARD_SCENES))
def test_assign_fused_is_ieee(name):
    """On the real anchors and unrounded boxes: the IoU reductions equal
    numpy's correctly rounded arithmetic, the argmaxes the first maximum."""
    boxes, labels, mask = scene(**CARD_SCENES[name], grid=False)
    anchors = anchors_np(grid=False)
    got = matching_cuda.assign_fused(
        *(torch.from_numpy(x) for x in (anchors, boxes, labels, mask))
    )
    iou = ieee_iou(anchors, boxes, mask)
    matched = iou.argmax(axis=2)
    np.testing.assert_array_equal(got[0].numpy(), np.take_along_axis(boxes, matched[..., None], 1))
    np.testing.assert_array_equal(got[1].numpy(), np.take_along_axis(labels, matched, 1))
    np.testing.assert_array_equal(got[2].numpy(), iou.max(axis=2))
    np.testing.assert_array_equal(got[3].numpy(), iou.max(axis=1))
    np.testing.assert_array_equal(got[4].numpy(), iou.argmax(axis=1))


def ieee_iou(anchors, boxes, mask):
    """(B, A, G) IoU in numpy f32, each operation correctly rounded, in the
    order of ``ops/iou.py``; masked gts give 0."""
    f32 = np.float32
    lt = np.maximum(anchors[None, :, None, :2], boxes[:, None, :, :2])
    rb = np.minimum(anchors[None, :, None, 2:], boxes[:, None, :, 2:])
    wh = np.maximum(rb - lt, f32(0))
    inter = wh[..., 0] * wh[..., 1]

    def area(b):
        return np.maximum(b[..., 2] - b[..., 0], f32(0)) * np.maximum(b[..., 3] - b[..., 1], f32(0))

    union = (area(anchors)[None, :, None] + area(boxes)[:, None, :]) - inter
    iou = np.where(union > 0, inter / np.maximum(union, f32(1e-12)), f32(0))
    return np.where(mask[:, None, :], iou, f32(0)).astype(f32)


TRAIN_HW = (800, 1344)  # the training bucket: A = 201 600, ragged at 1024 and 256
CHUNK = 32  # anchors a warp of the kernel culls together: aligned runs of 32


@pytest.mark.parametrize("tile", [1024, 256, CHUNK])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_culling_is_exact(seed, tile):
    """The matching kernel's culling on the real anchors: a gt that fails
    the strict overlap test with the bounding box of a tile (or of a chunk
    of 32 anchors) gets an IoU of exactly 0 from every anchor in it, and the
    kernel's walk (only the gts listed for the tile, only the pairs whose
    chunk box the gt overlaps, per anchor a strict > from (0, g 0), per gt
    only IoUs above 0 with (0, anchor 0) when there is none) gives the
    plain version's first argmax and all five of its outputs.  Gt edges lie
    on the boxes of tiles of ``tile`` anchors."""
    boxes, labels, mask = scene(
        1, 48, seed, hw=TRAIN_HW, grid=False, sizes=(8.0, 500.0), tile=tile,
        culling=("off anchors", "tile edges", "scatter"),
    )
    anchors, gt_boxes, gt_labels, gt_mask = (
        torch.from_numpy(x) for x in (anchors_np(TRAIN_HW, grid=False), boxes, labels, mask)
    )
    iou = pairwise_iou(anchors, gt_boxes)  # (1, A, G)
    anchor = torch.arange(anchors.shape[0])
    for size in {tile, CHUNK}:
        overlap = matching_cuda.tile_gt_lists(anchors, gt_boxes, torch.ones_like(gt_mask), size)
        culled = ~overlap[:, anchor // size]  # (1, A, G): the gt misses the anchor's tile box
        assert culled.any() and overlap.any()
        assert bool((iou[culled] == 0).all())

    walked = (
        matching_cuda.tile_gt_lists(anchors, gt_boxes, gt_mask, tile)[:, anchor // tile]
        & matching_cuda.tile_gt_lists(anchors, gt_boxes, gt_mask, CHUNK)[:, anchor // CHUNK]
    )
    walked_iou = torch.where(walked, iou, 0.0)
    best = walked_iou.amax(-1)  # from 0
    best_g = ((walked_iou == best[..., None]) & (best[..., None] > 0)).int().argmax(-1)
    col = torch.where(walked & (iou > 0), iou, 0.0)
    gt_best = col.amax(-2)
    gt_anchor = ((col == gt_best[:, None]) & (gt_best[:, None] > 0)).int().argmax(-2)
    assert bool((gt_mask & (gt_best == 0)).any())  # real gts that reach no anchor

    want = matching_cuda.assign_fused_plain(anchors, gt_boxes, gt_labels, gt_mask)
    first = torch.where(gt_mask[:, None], iou, 0.0).max(-1).indices
    assert torch.equal(best_g, first)
    assert torch.equal(torch.gather(gt_boxes, 1, best_g[..., None].expand(-1, -1, 4)), want[0])
    assert torch.equal(torch.gather(gt_labels, 1, best_g), want[1])
    assert torch.equal(best, want[2])
    assert torch.equal(gt_best, want[3])
    assert torch.equal(gt_anchor.int(), want[4])


def assert_targets_equal(got, want):
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))
    np.testing.assert_array_equal(got.matched_labels.numpy(), np.asarray(want.matched_labels))
    np.testing.assert_allclose(
        got.box_targets.numpy(), np.asarray(want.box_targets), rtol=0, atol=1e-5
    )


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_batched_targets_equal_both_jax_branches(name, fused):
    jnp, j_matching, _ = jax_modules()
    boxes, labels, mask = scene(**SCENES[name])
    config = j_matching.MatchingConfig(
        fused_pallas=fused, pallas_interpret=True, pallas_tile_a=512
    )
    want = j_matching.anchor_targets_compact_batched(
        jnp.asarray(anchors_np()), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(mask), config,
    )
    inputs = port_inputs(boxes, labels, mask)
    got = t_matching.anchor_targets_compact_batched(*inputs)
    assert got.box_targets.shape == (*mask.shape[:1], anchors_np().shape[0], 4)
    assert_targets_equal(got, want)
    # The kernel path's finish on the plain version's reductions.
    finished = t_matching.finish_fused(*inputs, matching_cuda.assign_fused_plain(*inputs))
    assert_targets_equal(finished, want)


def test_duplicate_force_targets_go_to_the_highest_gt():
    """Two identical tiny gts share their best anchor: JAX's scatter keeps
    the later gt there, while the per-anchor argmax elsewhere keeps the
    first.  (Padded to the scenes' (B, G), so JAX compiles nothing new.)"""
    boxes = np.zeros((3, 6, 4), np.float32)
    boxes[0, 0] = boxes[0, 1] = [40.0, 40.0, 43.0, 43.0]
    boxes[0, 2] = [80.0, 8.0, 120.0, 40.0]  # far from the tiny pair
    labels = np.zeros((3, 6), np.int32)
    labels[0, :3] = [1, 2, 3]
    mask = np.zeros((3, 6), bool)
    mask[0, :3] = True
    anchors, *gts = port_inputs(boxes, labels, mask)
    assigned = matching_cuda.assign_fused_plain(anchors, *gts)
    best = int(assigned[4][0, 0])
    assert best == int(assigned[4][0, 1])  # one anchor for both
    assert int(assigned[1][0, best]) == 1  # the plain argmax keeps gt 0
    for targets in (
        t_matching.anchor_targets_compact_batched(anchors, *gts),
        t_matching.finish_fused(anchors, *gts, assigned),
    ):
        assert int(targets.state[0, best]) == t_matching.POSITIVE
        assert int(targets.matched_labels[0, best]) == 2  # gt 1 wins the force
    jnp, j_matching, _ = jax_modules()
    for fused in (True, False):
        want = j_matching.anchor_targets_compact_batched(
            jnp.asarray(anchors_np()), jnp.asarray(boxes), jnp.asarray(labels),
            jnp.asarray(mask),
            j_matching.MatchingConfig(fused_pallas=fused, pallas_interpret=True),
        )
        assert int(np.asarray(want.matched_labels)[0, best]) == 2


def test_unbatched_assign_anchors_equals_jax():
    jnp, j_matching, _ = jax_modules()
    boxes, labels, mask = scene(**SCENES["duplicated gts"])
    want = j_matching.assign_anchors(
        jnp.asarray(anchors_np()), jnp.asarray(boxes[0]), jnp.asarray(mask[0])
    )
    got = t_matching.assign_anchors(
        torch.from_numpy(anchors_np()), torch.from_numpy(boxes[0]), torch.from_numpy(mask[0])
    )
    np.testing.assert_array_equal(got.matched_gt.numpy(), np.asarray(want.matched_gt))
    np.testing.assert_array_equal(got.state.numpy(), np.asarray(want.state))


def test_no_force_match():
    jnp, j_matching, _ = jax_modules()
    boxes, labels, mask = scene(**SCENES["tiny gts"])
    want = j_matching.anchor_targets_compact_batched(
        jnp.asarray(anchors_np()), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(mask), j_matching.MatchingConfig(force_match_best=False, fused_pallas=False),
    )
    got = t_matching.anchor_targets_compact_batched(
        *port_inputs(boxes, labels, mask), t_matching.MatchingConfig(force_match_best=False)
    )
    assert_targets_equal(got, want)


@pytest.mark.parametrize(
    "bad",
    [
        lambda a, b, l, m: (a, b, l.long(), m),  # labels not int32
        lambda a, b, l, m: (a, b, l, m.int()),  # mask not bool
        lambda a, b, l, m: (a.double(), b, l, m),  # anchors not f32
        lambda a, b, l, m: (a, b[:, :, :3], l, m),  # boxes not (B, G, 4)
        lambda a, b, l, m: (a, b.transpose(0, 1).contiguous().transpose(0, 1), l, m),
        lambda a, b, l, m: (a, b[:, :0], l[:, :0], m[:, :0]),  # G 0
    ],
)
def test_wrapper_rejects_bad_inputs(bad):
    boxes, labels, mask = scene(**SCENES["ragged"])
    with pytest.raises((TypeError, ValueError)):
        matching_cuda.assign_fused(*bad(*port_inputs(boxes, labels, mask)))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_SCENES))
def test_kernel_equals_plain_on_card(name):
    dev = _cuda_or_skip()
    inputs = port_inputs(*scene(**CARD_SCENES[name]), device=dev)
    before = matching_cuda.kernel_launches
    got = matching_cuda.assign_fused(*inputs)
    torch.cuda.synchronize()
    assert matching_cuda.kernel_launches == before + 1
    want = matching_cuda.assign_fused_plain(*inputs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    cpu = t_matching.anchor_targets_compact_batched(*(t.cpu() for t in inputs))
    card = t_matching.anchor_targets_compact_batched(*inputs)
    assert torch.equal(card.state.cpu(), cpu.state)
    assert torch.equal(card.matched_labels.cpu(), cpu.matched_labels)
    torch.testing.assert_close(card.box_targets.cpu(), cpu.box_targets, rtol=0, atol=1e-5)
