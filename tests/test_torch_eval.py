"""The port's eval path against the JAX package's: the COCO mAP oracle
(``evaluate/coco_eval.py``), the VOC metric (``evaluate/voc_eval.py``),
the dataset reader (``data/coco.py``), ``pad_batch`` and the eval driver
(``evaluate/detect.py``: ``collect_detections``, ``run_coco_eval``).

The oracles are numpy on both sides and must agree number for number.  The
eval driver runs the small f32 model of tests/test_torch_detect.py (same
weights on both sides, the classification kernel scaled up so the scores
spread) over a seeded COCO-format validation set; JAX's driver runs
sequentially with its Pallas NMS kernel in interpret mode, as the JAX
package's tests run it.  Tolerances, from the forward's summation order
(tests/test_torch_detect.py): scores within ``SCORE_ATOL``; boxes within
``BOX_ULPS`` f32 ulps of the box's far edge (1.43 ulps measured: 1.09e-5
px on a box whose far edge is at 72 px, where an ulp is 7.6e-6 px);
metrics within ``METRIC_ATOL``.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from batchai_retinanet_horovod_coco_tpu.data import coco as j_coco
from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.evaluate import coco_eval as j_coco_eval
from batchai_retinanet_horovod_coco_tpu.evaluate import detect as j_detect
from batchai_retinanet_horovod_coco_tpu.evaluate import voc_eval as j_voc_eval
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu_torch.data import coco as t_coco
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import coco_eval as t_coco_eval
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import voc_eval as t_voc_eval
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_from_state_dict, load_flax_variables
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as t_nms_cuda

HW = (80, 112)
SMALL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=2)
LOGIT_SCALE = 100.0
NMS = dict(score_threshold=0.001, iou_threshold=0.5, pre_nms_size=32, max_detections=32)
SCORE_ATOL = 1e-6
BOX_ULPS = 4  # f32 ulps of the box's far edge, max(x + w, y + h)
METRIC_ATOL = 1e-6
CAT_IDS = (3, 7, 11)  # sparse COCO category ids


def random_annotations(seed: int, num_images: int = 8, max_dets: int = 150):
    """Seeded gt and detection dicts: three sparse categories, crowd
    regions, boxes in all three area ranges, more than 100 detections on
    most images, an image with no gt and one with no detection."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for img in range(1, num_images + 1):
        n_gt = 0 if img == 2 else int(rng.integers(1, 12))
        boxes = []
        for _ in range(n_gt):
            side = rng.choice([rng.uniform(8, 30), rng.uniform(35, 90), rng.uniform(100, 300)])
            w, h = side * rng.uniform(0.6, 1.4, 2)
            x, y = rng.uniform(0, 500, 2)
            crowd = int(rng.random() < 0.15)
            cat = int(rng.choice(CAT_IDS))
            gts.append({"id": len(gts) + 1, "image_id": img, "category_id": cat,
                        "bbox": [x, y, w, h], "area": float(w * h * rng.uniform(0.5, 1.0)),
                        "iscrowd": crowd})
            boxes.append((cat, [x, y, w, h]))
        n_dt = 0 if img == 3 else int(rng.integers(80, max_dets))
        for _ in range(n_dt):
            if boxes and rng.random() < 0.4:
                cat, (x, y, w, h) = boxes[int(rng.integers(len(boxes)))]
                j = rng.normal(0, 0.1, 4) * [w, h, w, h]
                bbox = [x + j[0], y + j[1], max(1.0, w + j[2]), max(1.0, h + j[3])]
            else:
                cat = int(rng.choice(CAT_IDS))
                bbox = [*rng.uniform(0, 500, 2), *rng.uniform(5, 200, 2)]
            dts.append({"image_id": img, "category_id": cat, "bbox": [float(v) for v in bbox],
                        "score": float(rng.uniform(0, 1))})
    return gts, dts, list(range(1, num_images + 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_eval_equals_jax(seed):
    gts, dts, img_ids = random_annotations(seed)
    want = j_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    got = t_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    assert got == want
    assert len(got) == 12 and 0 < got["AP"] < 1 and got["APsmall"] >= 0 and got["APlarge"] >= 0

    stream = t_coco_eval.StreamingCocoEval(gts, img_ids, cat_ids=list(CAT_IDS))
    for chunk in (img_ids[:3], img_ids[3:5], img_ids[5:]):
        stream.add([d for d in dts if d["image_id"] in chunk], chunk)
    assert stream.finish() == got


def test_gts_as_detections_give_ap_one():
    gts, _, img_ids = random_annotations(3)
    dts = [{"image_id": g["image_id"], "category_id": g["category_id"], "bbox": g["bbox"],
            "score": 1.0} for g in gts if not g["iscrowd"]]
    stats = t_coco_eval.evaluate_detections(gts, dts, img_ids=img_ids)
    assert stats["AP"] == stats["AP50"] == stats["AP75"] == 1.0
    assert stats["AR100"] == 1.0


@pytest.mark.parametrize("weighted", [False, True])
def test_voc_eval_equals_jax(weighted):
    gts, dts, _ = random_annotations(4)
    want = j_voc_eval.evaluate_detections_voc(gts, dts, weighted_average=weighted)
    got = t_voc_eval.evaluate_detections_voc(gts, dts, weighted_average=weighted)
    assert got == want and 0 < got["voc_mAP"] < 1


# ---------------------------------------------------------------------------
# The dataset, the batches and the eval driver
# ---------------------------------------------------------------------------


def interpolate_into_hw(image: np.ndarray) -> tuple[np.ndarray, float]:
    """``t_pipeline.resize_for_bucket(image, HW, *HW)`` with the bilinear
    resize done by ``F.interpolate``, so the set keeps the pixels it was
    built with.  The pipeline's own resize (``image_io.resize_bilinear``)
    differs from it by one level in a few samples; on this set that moves
    two detections of image 6 whose scores lie 4.5e-8 apart into the other
    order, while the frameworks' scores differ by up to 1.2e-7.  The eval
    driver, not the resize, is under test here; the resize is held against
    JAX in tests/test_torch_data.py."""
    h, w = image.shape[:2]
    scale = min(t_pipeline.resize_scale(h, w, HW[0], HW[1]), HW[0] / h, HW[1] / w)
    nh, nw = min(HW[0], int(round(h * scale))), min(HW[1], int(round(w * scale)))
    if (nh, nw) == (h, w):
        return image, scale
    x = torch.from_numpy(image).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=False)
    return np.ascontiguousarray(y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()), scale


@pytest.fixture(scope="module")
def val_set(tmp_path_factory):
    """A COCO-format validation set of 6 seeded uint8 images (one without
    any annotation, crowd boxes on some), its annotation file, and its eval
    batches at ``HW``: 4 rows a batch, the last one padded."""
    rng = np.random.default_rng(5)
    images, annotations, pixels = [], [], {}
    for img_id in range(1, 7):
        h, w = int(rng.integers(56, 81)), int(rng.integers(84, 113))
        images.append({"id": img_id, "file_name": f"{img_id}.jpg", "width": w, "height": h})
        pixels[img_id] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(0 if img_id == 4 else int(rng.integers(1, 5))):
            bw, bh = rng.uniform(8, w / 2), rng.uniform(8, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            annotations.append({"id": len(annotations) + 1, "image_id": img_id,
                                "category_id": int(rng.choice(CAT_IDS)), "bbox": [x, y, bw, bh],
                                "area": bw * bh, "iscrowd": int(rng.random() < 0.2)})
    path = tmp_path_factory.mktemp("coco") / "instances_val.json"
    path.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": c, "name": f"class{c}"} for c in CAT_IDS],
    }))
    dataset = t_coco.CocoDataset(str(path), keep_empty=True)
    examples = []
    for rec in dataset.records:
        image, scale = interpolate_into_hw(pixels[rec.image_id])
        examples.append((rec.image_id, (image, rec.boxes * scale, rec.labels, scale)))
    batches = []
    for i in range(0, len(examples), 4):
        chunk = examples[i:i + 4]
        batch = t_pipeline.assemble([e for _, e in chunk], [i for i, _ in chunk], HW, max_gt=8)
        batches.append(t_pipeline.pad_batch(batch, 4))
    return str(path), dataset, batches


def test_dataset_and_padding_equal_jax(val_set):
    path, dataset, batches = val_set
    want = j_coco.CocoDataset(path, keep_empty=True)
    assert dataset.label_to_cat_id == want.label_to_cat_id == dict(enumerate(CAT_IDS))
    assert len(dataset.records) == len(want.records) == 6
    for a, b in zip(dataset.records, want.records):
        for field in ("image_id", "file_name", "width", "height"):
            assert getattr(a, field) == getattr(b, field)
        for field in ("boxes", "labels", "areas", "crowd_boxes", "crowd_labels", "crowd_areas"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=field)
    assert dataset.image_path(dataset.records[0]) == want.image_path(want.records[0])
    assert t_detect.coco_gt_from_dataset(dataset) == j_detect.coco_gt_from_dataset(want)
    assert sum(len(r.crowd_boxes) for r in dataset.records) > 0
    short = batches[1]._replace(**{f: getattr(batches[1], f)[:2] for f in t_pipeline.Batch._fields})
    padded, want_padded = t_pipeline.pad_batch(short, 4), j_pipeline._pad_batch(short, 4)
    for field in t_pipeline.Batch._fields:
        x, y = getattr(padded, field), getattr(want_padded, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert padded.valid.tolist() == [True, True, False, False]


@pytest.fixture(scope="module")
def models():
    """The JAX model and state, and the port's model, with equal weights:
    the port's seeded ones, carried into flax trees by
    ``flax_from_state_dict`` (no flax init to compile)."""
    t_model = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(**SMALL, dtype=torch.float32),
                                          device="cpu", seed=0)
    params, stats = flax_from_state_dict(t_model.state_dict())
    params["cls_head"]["logits"]["kernel"] *= np.float32(LOGIT_SCALE)
    load_flax_variables(t_model, params)
    j_model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**SMALL, stem="conv", dtype=jax.numpy.float32)
    )
    state = j_state.TrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=params,
                               batch_stats=stats, opt_state=(), tx=optax.sgd(0.1))
    return j_model, state, t_model


@pytest.fixture(scope="module")
def jax_detect_fns():
    """JAX's detect functions, compiled once for the module's calls."""
    return {}


JAX_CONFIG = dict(nms_impl="pallas", nms_interpret=True, nms_block_k=128, **NMS)


def test_collect_detections_equal_jax(val_set, models, jax_detect_fns):
    path, dataset, batches = val_set
    j_model, state, t_model = models
    want = j_detect.collect_detections(
        state, j_model, j_coco.CocoDataset(path, keep_empty=True), batches,
        j_detect.DetectConfig(**JAX_CONFIG), pipelined=False, detect_fns=jax_detect_fns,
    )
    config = t_detect.DetectConfig(**NMS)
    before = t_nms_cuda.plain_calls
    sequential = t_detect.collect_detections(t_model, dataset, batches, config, "cpu", pipelined=False)
    pipelined = t_detect.collect_detections(t_model, dataset, batches, config, "cpu")
    assert t_nms_cuda.plain_calls == before + 2 * len(batches)
    assert pipelined == sequential  # identical values in identical order
    assert_same_detections(sequential, want)
    real_ids = {rec.image_id for rec in dataset.records}
    assert {d["image_id"] for d in sequential} <= real_ids  # padding rows add nothing
    # The same images unpadded give the same detections (a batch of another
    # size may sum its convolutions in another order: the tolerances hold).
    unpadded = [b._replace(**{f: getattr(b, f)[b.valid] for f in t_pipeline.Batch._fields}) for b in batches]
    assert_same_detections(t_detect.collect_detections(t_model, dataset, unpadded, config, "cpu"), sequential)


def assert_same_detections(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["image_id"] == w["image_id"] and g["category_id"] == w["category_id"]
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=SCORE_ATOL)
        x, y, bw, bh = w["bbox"]
        ulp = np.spacing(np.float32(max(x + bw, y + bh)))
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=BOX_ULPS * ulp)


def test_run_coco_eval_equals_jax(val_set, models, jax_detect_fns, tmp_path):
    """On ground truth made from some of the model's own detections (the
    random weights find nothing of the seeded boxes), so that the metrics
    are not all 0."""
    path, dataset, batches = val_set
    j_model, state, t_model = models
    config = t_detect.DetectConfig(**NMS)
    blob = json.loads(open(path).read())
    found = t_detect.collect_detections(t_model, dataset, batches, config, "cpu")
    rng = np.random.default_rng(6)
    blob["annotations"] = [
        {"id": i + 1, "image_id": d["image_id"], "category_id": d["category_id"],
         "bbox": [float(v) for v in np.asarray(d["bbox"]) * rng.uniform(0.9, 1.1, 4)],
         "area": float(d["bbox"][2] * d["bbox"][3]), "iscrowd": int(rng.random() < 0.1)}
        for i, d in enumerate(found[::3])
    ]
    path = tmp_path / "instances_found.json"
    path.write_text(json.dumps(blob))
    dataset = t_coco.CocoDataset(str(path), keep_empty=True)
    want = j_detect.run_coco_eval(
        state, j_model, j_coco.CocoDataset(str(path), keep_empty=True), batches,
        j_detect.DetectConfig(**JAX_CONFIG), voc_metrics=True, pipelined=False,
        detect_fns=jax_detect_fns,
    )
    got = t_detect.run_coco_eval(t_model, dataset, batches, config, "cpu", voc_metrics=True)
    sequential = t_detect.run_coco_eval(t_model, dataset, batches, config, "cpu", voc_metrics=True,
                                        pipelined=False)
    assert got == sequential
    assert set(got) == set(want) and 0 < got["AP50"]
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=METRIC_ATOL, err_msg=key)


def test_consumer_error_reaches_the_driver(val_set, models):
    _, dataset, batches = val_set
    t_model = models[2]

    def broken(results, done):
        raise KeyError("scoring failed")

    with pytest.raises(RuntimeError, match="eval consumer thread failed") as info:
        t_detect.collect_detections(t_model, dataset, batches, t_detect.DetectConfig(**NMS), "cpu",
                                    on_batch=broken)
    assert isinstance(info.value.__cause__, KeyError)
