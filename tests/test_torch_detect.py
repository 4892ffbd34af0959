"""The whole serving slice — normalize → forward → sigmoid → decode → clip →
NMS — against the JAX package's ``evaluate.detect.make_detect_fn`` with the
Pallas suppression kernel in interpret mode.

Both sides hold the same weights (flax → port through ``models/convert.py``)
in f32 and see the same seeded uint8 images.  The classification head's
final kernel is scaled up so the scores spread out: with the untrained
prior every score sits near 0.01 and many tie, which would make an
end-to-end comparison a matter of tie-breaking rather than of the port.
``score_threshold`` 0.001 lets detections flow through NMS.

Tolerances and their reasons:

- part 1 (JAX forward outputs → the port's post-processing): the NMS stages
  are held bit for bit on JAX's own decoded boxes and scores; through the
  port's own sigmoid and decode, labels and validity are equal and scores
  and boxes agree to ``ULP_RTOL`` of their magnitude, because XLA's and
  PyTorch's CPU ``exp`` differ by up to one ulp;
- part 2 (forward): ``FWD_RTOL`` of the largest output, the order of the
  convolution sums (tests/test_torch_models.py);
- part 3 (end to end): the forward difference passes through sigmoid (slope
  at most 1/4) and decode into ``SCORE_ATOL`` and ``BOX_ATOL``.  The test
  first asserts that every score gap that decides which candidates reach
  NMS and in what order, and every same-class IoU's distance from the
  threshold, exceeds what those tolerances could move; then valid counts
  and labels must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.data.pipeline import normalize_images as j_normalize
from batchai_retinanet_horovod_coco_tpu.evaluate import detect as j_detect
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import anchors as j_anchors
from batchai_retinanet_horovod_coco_tpu.ops import boxes as j_boxes
from batchai_retinanet_horovod_coco_tpu.ops import iou as j_iou
from batchai_retinanet_horovod_coco_tpu.ops import nms as j_nms
from batchai_retinanet_horovod_coco_tpu.train import create_train_state
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as t_nms
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as t_nms_cuda

HW = (80, 112)  # C4 5 x 7, C5 3 x 4: a non-2x upsample and odd stride-2 inputs
SMALL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=2)
LOGIT_SCALE = 100.0
NMS = dict(score_threshold=0.001, iou_threshold=0.5, pre_nms_size=32, max_detections=32)
FWD_RTOL = 1e-4
ULP_RTOL = 1e-6
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4  # px, on a 112-px bucket


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX model, TrainState, port model on the CPU, images) with equal
    weights."""
    j_model = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**SMALL, dtype=jnp.float32))
    state = create_train_state(j_model, optax.sgd(0.1), (1, *HW, 3), jax.random.key(0))
    params = jax.device_get(state.params)
    logits = params["cls_head"]["logits"]
    logits["kernel"] = np.asarray(logits["kernel"]) * np.float32(LOGIT_SCALE)
    state = state.replace(params=params)
    t_model = t_retinanet.RetinaNet(t_retinanet.RetinaNetConfig(**SMALL, dtype=torch.float32))
    load_flax_variables(t_model, params).eval()
    images = np.random.default_rng(4).integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    return j_model, state, t_model, images


@pytest.fixture(scope="module")
def jax_run(slice_pair):
    """JAX's forward outputs, decoded boxes and scores, and Detections."""
    j_model, state, _, images = slice_pair
    outputs = jax.device_get(
        jax.jit(lambda p, x: j_model.apply({"params": p}, j_normalize(x)))(state.params, images)
    )
    anchors = jnp.asarray(j_anchors.anchors_for_image_shape(HW))
    scores = np.array(jax.nn.sigmoid(outputs["cls_logits"]))
    boxes = np.array(
        j_boxes.clip_boxes(j_boxes.decode_boxes(anchors[None], outputs["box_deltas"]), HW)
    )
    config = j_detect.DetectConfig(nms_impl="pallas", nms_interpret=True, nms_block_k=128, **NMS)
    det = jax.device_get(j_detect.make_detect_fn(j_model, HW, config)(state, images))
    return outputs, boxes, scores, det


def assert_detections_equal(got: t_nms.Detections, want) -> None:
    for field in t_nms.Detections._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


def test_nms_on_jax_stages_is_bit_identical(jax_run):
    """Part 1a: JAX's decoded boxes and scores through the port's NMS give
    JAX's Detections bit for bit, with suppression really happening."""
    _, boxes, scores, det = jax_run
    before = t_nms_cuda.plain_calls
    got = t_nms_cuda.batched_multiclass_nms_cuda(torch.from_numpy(boxes), torch.from_numpy(scores), **NMS)
    assert t_nms_cuda.plain_calls == before + 1
    assert_detections_equal(got, det)
    assert 0 < got.valid.sum() < 2 * NMS["pre_nms_size"]


def test_postprocess_on_jax_forward(jax_run):
    """Part 1b: JAX's forward outputs through the port's own sigmoid,
    decode, clip and NMS."""
    outputs, _, _, det = jax_run
    got = t_detect.postprocess(
        {k: torch.from_numpy(np.array(v)) for k, v in outputs.items()},
        t_detect.anchors_on(HW, t_detect.DetectConfig().anchor, torch.device("cpu")),
        HW,
        t_detect.DetectConfig(**NMS),
    )
    np.testing.assert_array_equal(got.valid.numpy(), det.valid)
    np.testing.assert_array_equal(got.labels.numpy(), det.labels)
    valid = det.valid
    np.testing.assert_allclose(got.scores.numpy()[valid], det.scores[valid], rtol=ULP_RTOL, atol=0)
    np.testing.assert_allclose(
        got.boxes.numpy(), det.boxes, rtol=0, atol=ULP_RTOL * np.abs(det.boxes).max()
    )


def test_forward_outputs_agree(slice_pair, jax_run):
    """Part 2: the port's forward on the same uint8 images."""
    _, _, t_model, images = slice_pair
    outputs = jax_run[0]
    with torch.no_grad():
        got = t_model(t_detect.pipeline_lib.normalize_images(torch.from_numpy(images)))
    for key in ("cls_logits", "box_deltas"):
        want = np.asarray(outputs[key])
        assert tuple(got[key].shape) == want.shape
        np.testing.assert_allclose(
            got[key].numpy(), want, rtol=0, atol=FWD_RTOL * np.abs(want).max()
        )


def decisions_are_robust(boxes: np.ndarray, scores: np.ndarray) -> None:
    """Assert that what decides the Detections cannot move within the
    part-3 tolerances: the score gaps around the anchor and pair top-k
    cuts and inside the sorted candidates, and each same-class IoU's
    distance from the threshold."""
    k = NMS["pre_nms_size"]
    for b in range(scores.shape[0]):
        best = -np.sort(-scores[b].max(axis=-1))[: k + 1]
        pairs = -np.sort(-scores[b].reshape(-1))[: k + 1]
        assert -np.diff(best).max() > 2 * SCORE_ATOL, "anchor top-k gap"
        assert -np.diff(pairs).max() > 2 * SCORE_ATOL, "candidate score gap"
    cand_boxes, _, class_idx = jax.device_get(
        jax.vmap(lambda bx, s: j_nms.select_candidates(bx, s, NMS["score_threshold"], k))(
            boxes, scores
        )
    )
    for cb, ci in zip(cand_boxes, class_idx):
        iou = np.asarray(j_iou.pairwise_iou(jnp.asarray(cb), jnp.asarray(cb)))
        same = (ci[:, None] == ci[None, :]) & ~np.eye(k, dtype=bool)
        side = np.minimum(cb[:, 2] - cb[:, 0], cb[:, 3] - cb[:, 1]).min()
        # A corner moved by BOX_ATOL changes an IoU by at most ~4 BOX_ATOL / side.
        assert np.abs(iou[same] - NMS["iou_threshold"]).min() > 8 * BOX_ATOL / side


def test_end_to_end_matches_jax(slice_pair, jax_run):
    """Part 3: uint8 images through the port's ``make_detect_fn`` on the CPU
    against JAX's ``make_detect_fn`` with the Pallas kernel."""
    _, _, t_model, images = slice_pair
    _, boxes, scores, det = jax_run
    decisions_are_robust(boxes, scores)
    detect = t_detect.make_detect_fn(t_model, HW, t_detect.DetectConfig(**NMS), device="cpu")
    got = detect(images)
    np.testing.assert_array_equal(got.valid.numpy().sum(1), det.valid.sum(1))
    np.testing.assert_array_equal(got.valid.numpy(), det.valid)
    np.testing.assert_array_equal(got.labels.numpy(), det.labels)
    np.testing.assert_allclose(
        got.scores.numpy()[det.valid], det.scores[det.valid], rtol=0, atol=SCORE_ATOL
    )
    np.testing.assert_allclose(got.boxes.numpy(), det.boxes, rtol=0, atol=BOX_ATOL)
    assert det.valid.sum() > 0

