"""The deployable server on the CPU: the port's export (``evaluate/export.py``),
its ``convert_model`` and ``DetectEngine.from_export``, against the live
engine and against the JAX package's export of the same checkpoint.

- **Round trip.** An exported program, loaded, equals the live engine on
  the same weights bit for bit (f32 and bf16, batch sizes 1 and 2): the
  live path runs the same ``DetectProgram``.
- **Against JAX.** One JAX ``CheckpointManager`` snapshot (``resnet_test``,
  the command line's full-width FPN and heads, f32, 64 x 64, the class
  logits scaled so that the scores spread out, as in
  ``test_torch_detect.py``) goes through the root ``convert_model.py`` and
  the JAX engine, and through the port's converter and engine.  Validity
  and labels are equal; scores and boxes agree within
  ``test_torch_detect.py``'s ``SCORE_ATOL`` and ``BOX_ATOL`` (the forward
  convolutions sum in another order).  The images are PNG and baseline
  JPEG files whose long side is the bucket's, so neither server resizes
  them: the two resizes differ by up to a grey level
  (``test_torch_serve.py::test_resize_matches_jax_pipeline``), which is
  not what this file holds.
- **The constant cache.** An export traced before any live call in the
  process leaves the live path real tensors.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import unittest.mock
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.serve import frontend as j_frontend
from batchai_retinanet_horovod_coco_tpu.serve.engine import DetectEngine as JaxEngine
from batchai_retinanet_horovod_coco_tpu.train import create_train_state as j_create_train_state
from batchai_retinanet_horovod_coco_tpu.utils import checkpoint as j_ckpt
from batchai_retinanet_horovod_coco_tpu_torch import convert_model as t_convert
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import export as t_export
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import (
    flax_from_state_dict,
    load_flax_variables,
)
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
    RetinaNet,
    RetinaNetConfig,
    build_retinanet,
)
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as t_nms
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as t_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve.batcher import assemble_requests
from batchai_retinanet_horovod_coco_tpu_torch.serve.common import ServeRequest
from batchai_retinanet_horovod_coco_tpu_torch.serve.engine import DetectEngine
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig
from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager
from test_torch_train import drop_tmp_path  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the root convert_model.py
import convert_model as j_convert  # noqa: E402

REPO_ROOT = Path(__file__).resolve().parents[1]
HW = (64, 64)
NUM_CLASSES = 3
LOGIT_SCALE = 100.0
# As in test_torch_detect.py (its part 3, end to end).
SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4  # px
# The converter's command line: resnet_test, full-width FPN and heads.
CONVERT = ["--num-classes", str(NUM_CLASSES), "--backbone", "resnet_test", "--f32",
           "--image-min-side", "64", "--image-max-side", "64", "--score-threshold", "0.001"]
SMALL_BF16 = dict(num_classes=NUM_CLASSES, backbone="resnet_test", fpn_channels=32,
                  head_width=32, head_depth=2, dtype=torch.bfloat16)
DCONFIG = t_detect.DetectConfig(score_threshold=0.001)
# (h, w, format) of the served files: the long side is the bucket's.
FILES = [(48, 64, "png"), (64, 40, "png"), (64, 64, "jpg"), (44, 64, "jpg")]


def cli_model() -> RetinaNet:
    """The converter's model (random weights; the snapshot sets them)."""
    return RetinaNet(RetinaNetConfig(num_classes=NUM_CLASSES, backbone="resnet_test",
                                     dtype=torch.float32))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX ``CheckpointManager`` snapshot of seeded weights with the
    class logits scaled up, and the port model holding the same weights."""
    root = tmp_path_factory.mktemp("snapshot")
    model = build_retinanet(RetinaNetConfig(num_classes=NUM_CLASSES, backbone="resnet_test",
                                            dtype=torch.float32), device="cpu", seed=3)
    with torch.no_grad():
        model.cls_head.logits.weight.mul_(LOGIT_SCALE)
    params, batch_stats = flax_from_state_dict(model.state_dict())
    j_model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(num_classes=NUM_CLASSES, backbone="resnet_test", dtype=jnp.float32))
    tx = optax.sgd(0.01)
    # The JAX state's structure without compiling its init.
    like = jax.eval_shape(lambda key: j_create_train_state(j_model, tx, (1, *HW, 3), key),
                          jax.random.key(0))
    state = like.replace(step=np.int32(7), params=params, batch_stats=batch_stats,
                         opt_state=tx.init(params))
    j_ckpt.CheckpointManager(str(root / "ckpt"), async_save=False).save(state, force=True)
    yield str(root / "ckpt"), model
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def exports(snapshot, tmp_path_factory):
    """The snapshot through JAX's root ``convert_model.py`` (batch 1) and
    through the port's (batches 1 and 2)."""
    ckpt, _ = snapshot
    root = tmp_path_factory.mktemp("exports")
    j_convert.main(["--snapshot-path", ckpt, "--output", str(root / "jax"), *CONVERT,
                    "--batch-size", "1", "--platform", "cpu"])
    t_convert.main(["--snapshot-path", ckpt, "--output", str(root / "port"), *CONVERT,
                    "--batch-sizes", "1,2", "--device", "cpu"])
    yield str(root / "jax"), str(root / "port")
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def port_engine(exports):
    return DetectEngine.from_export(exports[1], device="cpu")


@pytest.fixture(scope="module")
def bf16_export(tmp_path_factory):
    """A bf16 model exported through the Python API at batches 1 and 2,
    with the order of the files' writes."""
    root = tmp_path_factory.mktemp("bf16")
    model = build_retinanet(RetinaNetConfig(**SMALL_BF16), device="cpu", seed=4)
    writes = []

    def recorder(write):
        def record(path, *args, **kwargs):
            writes.append(os.path.basename(path))
            return write(path, *args, **kwargs)
        return record

    with unittest.mock.patch.object(t_export, "atomic_write_bytes", recorder(t_export.atomic_write_bytes)), \
            unittest.mock.patch.object(t_export, "atomic_write_text", recorder(t_export.atomic_write_text)):
        t_export.export_model(model, str(root / "exp"), (HW,), (1, 2), DCONFIG, device="cpu",
                              version="v-bf16")
    yield str(root / "exp"), model, writes
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def served_files(tmp_path_factory):
    """PNG and baseline JPEG files of seeded pixels (PIL writes them)."""
    root = tmp_path_factory.mktemp("files")
    rng = np.random.default_rng(11)
    for i, (h, w, fmt) in enumerate(FILES):
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(root / f"img_{i}.{fmt}", quality=90)
    return str(root)


def decoded(image_dir: str) -> list[np.ndarray]:
    """The files of ``image_dir`` in name order, decoded by the port's codec."""
    return [image_io.read_rgb(os.path.join(image_dir, name)) for name in sorted(os.listdir(image_dir))]


def padded(images: list[np.ndarray], batch: int) -> np.ndarray:
    """``images`` in one padded batch of ``batch`` rows, as the server's
    batcher assembles it."""
    reqs = []
    for image in images:
        req = ServeRequest(0, None, None)
        req.image = image
        reqs.append(req)
    return assemble_requests(reqs, HW, batch).images


def test_constant_cache_survives_an_export_before_any_live_call(tmp_path):
    """In a fresh process, trace a detect forward with ``torch.export``
    before any live call, then run the live program: its outputs are real
    tensors, equal to this process's.  (The cache of ``utils/device.py::
    constant`` once kept the fake tensors that tracing makes.)"""
    config = dict(num_classes=NUM_CLASSES, backbone="resnet_test", fpn_channels=16,
                  head_width=16, head_depth=1, dtype=torch.float32)
    code = f"""
import sys, numpy as np, torch
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import normalize_images
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import RetinaNetConfig, build_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops import boxes
model = build_retinanet(RetinaNetConfig(**{config!r}), device="cpu", seed=1)
anchors = detect.anchors_on({HW!r}, detect.DetectConfig().anchor, torch.device("cpu"))

class Forward(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.model = model
    def forward(self, images):
        out = self.model(normalize_images(images))
        return out["cls_logits"], boxes.decode_boxes(anchors[None], out["box_deltas"])

images = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, *{HW!r}, 3), dtype=np.uint8))
with torch.no_grad():
    torch.export.export(Forward().eval(), (images,))
det = detect.make_detect_fn(model, {HW!r}, detect.DetectConfig(score_threshold=0.001), "cpu")(images)
assert all(type(f) is torch.Tensor for f in det), [type(f) for f in det]
np.savez(sys.argv[1], *[f.numpy() for f in det])
"""
    out = tmp_path / "live.npz"
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = np.load(out)
    model = build_retinanet(RetinaNetConfig(**config), device="cpu", seed=1)
    images = np.random.default_rng(2).integers(0, 256, (1, *HW, 3), dtype=np.uint8)
    want = t_detect.make_detect_fn(model, HW, t_detect.DetectConfig(score_threshold=0.001),
                                   "cpu")(images)
    assert int(want.valid.sum()) > 0
    for i, field in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], field.numpy())


def test_nms_custom_op_passes_opcheck():
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 100, (2, 300, 2)).astype(np.float32)
    boxes = torch.from_numpy(
        np.concatenate([xy, xy + rng.uniform(4, 40, (2, 300, 2))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.uniform(0, 1, (2, 300, 3)).astype(np.float32))
    cb, cs, ci = (t.contiguous() for t in t_nms.select_candidates(boxes, scores, 0.05, 200))
    op = torch.ops.retinanet_torch.nms_keep_mask.default
    torch.library.opcheck(op, (cb, cs, ci, 0.5))
    np.testing.assert_array_equal(op(cb, cs, ci, 0.5), t_nms.greedy_keep(cb, cs, 0.5, ci))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_round_trip_equals_live_engine(dtype, request, served_files):
    """``from_export`` against ``from_state`` on the same weights: equal
    Detections bit for bit at batch sizes 1 and 2, through the NMS op."""
    if dtype == "f32":
        export_dir = request.getfixturevalue("exports")[1]
        loaded = request.getfixturevalue("port_engine")
        model = cli_model()
        saved = CheckpointManager(request.getfixturevalue("snapshot")[0]).restore_arrays()
        load_flax_variables(model, saved["params"], saved["batch_stats"])
        config = t_detect.DetectConfig(score_threshold=0.001)
        version = "port"  # the directory's basename: the converter sets none
    else:
        export_dir, model, _ = request.getfixturevalue("bf16_export")
        loaded = DetectEngine.from_export(export_dir, device="cpu")
        config, version = DCONFIG, "v-bf16"
    live = DetectEngine.from_state(model, (HW,), (1, 2), config, device="cpu",
                                   min_side=64, max_side=64)
    assert (loaded.source, loaded.version) == (export_dir, version)
    assert (live.source, live.version) == ("live", "live")
    assert loaded.buckets == (HW,) and loaded.batch_sizes(HW) == [1, 2]
    assert (loaded.min_side, loaded.max_side) == (64, 64)
    before = nms_cuda.plain_calls
    kept = 0
    images = decoded(served_files)
    # Batch 1, then batch 2 with two rows and with a padding row.
    batches = [padded(images[:1], 1), padded(images[1:2], 1), padded(images[2:4], 2),
               padded(images[:1], 2)]
    for batch in batches:
        got = loaded.fetch(loaded.dispatch(HW, batch))
        want = live.fetch(live.dispatch(HW, batch))
        for field in t_nms.Detections._fields:
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        kept += int(got.valid.sum())
    assert kept > 0
    # Each exported batch called the op's CPU kernel (the plain version).
    assert nms_cuda.plain_calls - before >= 2 * len(batches)


def test_unexported_shapes_and_foreign_exports_are_refused(exports, tmp_path):
    jax_dir, port_dir = exports
    loaded = t_export.LoadedDetector({}, torch.device("cpu"), {(1, 64, 64): lambda x: x,
                                                               (2, 64, 64): lambda x: x})
    assert loaded.buckets() == [(1, 64, 64), (2, 64, 64)]
    assert loaded(np.zeros((2, *HW, 3), np.uint8)).shape == (2, *HW, 3)
    with pytest.raises(ValueError, match="no exported program"):
        loaded(np.zeros((3, *HW, 3), np.uint8))
    with pytest.raises(ValueError, match="no exported program"):
        loaded(np.zeros((1, 64, 96, 3), np.uint8))
    with pytest.raises(ValueError, match="jax.export.stablehlo.v1"):
        t_export.load_model(jax_dir, device="cpu")
    with pytest.raises(ValueError, match="jax.export.stablehlo.v1"):
        DetectEngine.from_export(jax_dir, device="cpu")
    manifest = json.loads((Path(port_dir) / "manifest.json").read_text())
    (tmp_path / "manifest.json").write_text(json.dumps({**manifest, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported on cuda"):
        t_export.load_model(str(tmp_path), device="cpu")


def test_manifest_has_the_jax_keys_and_is_written_last(exports, bf16_export):
    jax_dir, port_dir = exports
    want = json.loads((Path(jax_dir) / "manifest.json").read_text())
    got = json.loads((Path(port_dir) / "manifest.json").read_text())
    assert set(got) == set(want) | {"device", "launch_shapes"}
    assert set(got["detect_config"]) == set(want["detect_config"])
    assert got["format"] == t_export.FORMAT and got["device"] == "cpu"
    assert got["detect_config"]["nms_impl"] == nms_cuda.OP_NAME
    assert got["detect_config"]["nms_block_k"] is None
    # The port's registry has no file for the CPU: the built-in defaults.
    assert got["schedule"] == {"device_kind": "cpu", "source": "defaults", "found": False}
    assert got["launch_shapes"] == {"nms": {"mask_lanes": 4, "scan_threads": 256}}
    for key in ("input", "output", "anchor_config", "image_min_side", "image_max_side"):
        assert got[key] == want[key], key
    for key in ("score_threshold", "iou_threshold", "pre_nms_size", "max_detections"):
        assert got["detect_config"][key] == want["detect_config"][key], key
    assert [(e["height"], e["width"], e["batch_size"]) for e in got["artifacts"]] == [
        (64, 64, 1), (64, 64, 2)]
    _, _, writes = bf16_export
    assert writes == ["detector_64x64_b1.pt2", "detector_64x64_b2.pt2", "manifest.json"]


def test_port_export_agrees_with_jax_export(exports, port_engine, served_files):
    jax_engine = JaxEngine.from_export(exports[0])
    kept = 0
    for image in decoded(served_files):
        batch = padded([image], 1)
        want = jax.device_get(jax_engine.fetch(jax_engine.dispatch(HW, batch)))
        got = port_engine.fetch(port_engine.dispatch(HW, batch))
        np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
        valid = got.valid
        np.testing.assert_allclose(got.scores[valid], np.asarray(want.scores)[valid], rtol=0,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(got.boxes, np.asarray(want.boxes), rtol=0, atol=BOX_ATOL)
        kept += int(valid.sum())
    assert kept > 0


def test_serve_cli_agrees_with_jax_serve_cli(exports, served_files, tmp_path):
    """Both ``serve --images`` command lines over the same files write JSONL
    whose records agree: the same files and categories, scores and boxes
    (original-image pixels; no resize, so the scale is 1) within the
    tolerances, a box's width and height within twice BOX_ATOL."""
    jax_dir, port_dir = exports
    previous = signal.getsignal(signal.SIGTERM)  # JAX's main installs its own
    try:
        j_frontend.main(["--export-dir", jax_dir, "--images", served_files, "--output",
                         str(tmp_path / "jax.jsonl"), "--serve-max-delay-ms", "1"])
    finally:
        signal.signal(signal.SIGTERM, previous)
    stats = t_frontend.main(["--export-dir", port_dir, "--images", served_files, "--output",
                             str(tmp_path / "port.jsonl"), "--device", "cpu",
                             "--serve-max-delay-ms", "1"])
    assert stats["completed"] == len(FILES) and stats["shed_total"] == 0
    assert signal.getsignal(signal.SIGTERM) == previous
    want = [json.loads(line) for line in (tmp_path / "jax.jsonl").read_text().splitlines()]
    got = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [r["file"] for r in got] == [r["file"] for r in want] == sorted(os.listdir(served_files))
    total = 0
    for a, b in zip(got, want):
        assert len(a["detections"]) == len(b["detections"]), a["file"]
        for da, db in zip(a["detections"], b["detections"]):
            assert set(da) == set(db) == {"category_id", "bbox", "score"}
            assert da["category_id"] == db["category_id"], a["file"]
            assert abs(da["score"] - db["score"]) <= SCORE_ATOL, a["file"]
            np.testing.assert_allclose(da["bbox"][:2], db["bbox"][:2], rtol=0, atol=BOX_ATOL)
            np.testing.assert_allclose(da["bbox"][2:], db["bbox"][2:], rtol=0, atol=2 * BOX_ATOL)
        total += len(a["detections"])
    assert total > 0


def test_server_runs_the_artifact_without_model_code_and_drains_on_sigterm(bf16_export):
    """``serve --http 0`` in a fresh process: it loads the export, answers
    a request equal to the live engine's, and on SIGTERM drains, prints
    its ``serve_stats`` line and exits 0, having imported no ``models``
    module (nor JAX)."""
    import urllib.request

    export_dir, model, _ = bf16_export
    code = (
        "import atexit, runpy, sys\n"
        "atexit.register(lambda: print('modules', sorted(m for m in sys.modules\n"
        "    if '.models' in m or m.split('.')[0] == 'jax'), flush=True))\n"
        "sys.argv = ['serve'] + sys.argv[1:]\n"
        "runpy.run_module('batchai_retinanet_horovod_coco_tpu_torch.serve', run_name='__main__')\n"
    )
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--export-dir", export_dir, "--http", "0", "--device", "cpu"],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                break
        assert lines and lines[-1].startswith("serving on "), "".join(lines) + proc.stderr.read()
        url = lines[-1].split()[2]
        image = np.random.default_rng(6).integers(0, 256, (48, 64, 3), dtype=np.uint8)
        request = urllib.request.Request(f"{url}/detect", data=image_io.encode_png(image),
                                         method="POST")
        with urllib.request.urlopen(request, timeout=120) as r:
            assert r.status == 200
            served = json.load(r)["detections"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    *_, stats_line, modules_line = out.strip().splitlines()
    assert json.loads(stats_line)["serve_stats"]["completed"] == 1
    assert modules_line == "modules []"
    live = DetectEngine.from_state(model, (HW,), (1, 2), DCONFIG, device="cpu",
                                   min_side=64, max_side=64)
    with t_frontend.DetectionServer(live) as server:
        assert served == json.loads(json.dumps(server.detect(image, timeout_s=120)))
    assert served


@pytest.mark.parametrize("flags", [
    ["--platform", "cpu"], ["--platforms=cpu,tpu"], ["--backbone", "vgg16"], ["--stem", "conv"],
], ids=["platform", "platforms", "backbone", "stem"])
def test_convert_refusals_name_the_roadmap(flags, tmp_path, served_files):
    """``--platform(s)`` are refused, naming ``ROADMAP.md``.  A backbone
    other than the ResNets and another stem, refused before, now convert: a
    VGG-16 snapshot of the port (full-width FPN and heads, f32) and the
    ``resnet_test`` snapshot under ``--stem conv`` export on the CPU, load
    through ``DetectEngine.from_export`` and answer as the live engine on
    the same weights, bit for bit."""
    if flags[0].startswith("--platform"):
        with pytest.raises(SystemExit, match="ROADMAP.md"):
            t_convert.main(["--snapshot-path", str(tmp_path), "--output", str(tmp_path / "out"),
                            "--num-classes", "3", "--device", "cpu", *flags])
        return
    backbone = flags[1] if flags[0] == "--backbone" else "resnet_test"
    model = build_retinanet(RetinaNetConfig(num_classes=NUM_CLASSES, backbone=backbone,
                                            dtype=torch.float32), device="cpu", seed=6)
    with torch.no_grad():
        model.cls_head.logits.weight.mul_(LOGIT_SCALE)
    state = create_train_state(model, OptimizerConfig(), device="cpu")
    manager = CheckpointManager(str(tmp_path / "ckpt"))
    assert manager.save(state)
    manager.close()
    convert_flags = [a for a in CONVERT if a not in ("--backbone", "resnet_test")]
    t_convert.main(["--snapshot-path", str(tmp_path / "ckpt"), "--output", str(tmp_path / "out"),
                    *convert_flags, "--backbone", backbone, *flags, "--batch-sizes", "1",
                    "--device", "cpu"])
    loaded = DetectEngine.from_export(str(tmp_path / "out"), device="cpu")
    live = DetectEngine.from_state(model, (HW,), (1,), t_detect.DetectConfig(score_threshold=0.001),
                                   device="cpu", min_side=64, max_side=64)
    batch = padded(decoded(served_files)[:1], 1)
    got = loaded.fetch(loaded.dispatch(HW, batch))
    want = live.fetch(live.dispatch(HW, batch))
    for field in t_nms.Detections._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert int(got.valid.sum()) > 0


def test_convert_defaults_and_card(tmp_path):
    """The root converter's flags and defaults, ``--platform(s)`` replaced
    by ``--device`` (default cuda: it raises without a card)."""
    want = {a.dest: a.default for a in j_convert.build_parser()._actions}
    got = {a.dest: a.default for a in t_convert.build_parser()._actions}
    assert set(got) == set(want) - {"platform", "platforms"} | {"device"}
    assert all(got[k] == want[k] for k in got if k != "device")
    assert got["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_convert.main(["--snapshot-path", str(tmp_path), "--output", str(tmp_path / "out"),
                            "--num-classes", "3"])
