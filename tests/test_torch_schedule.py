"""The port's schedule registry (``tune/schedule.py``) and its consumers.

The registry cases of the JAX package's ``tests/unit/test_tune.py`` that
apply to the port (every problem named, unknown ops and keys, the slug, the
deep merge, one ``schedule_fallback`` line per (device, reason), the cache
keyed by path, the environment override, provenance relative to the
checkout), the port's departures (its own format and directory, the torch
device as the device kind, the kernels' launch shapes as menus, no
``impl``, ``block_k`` or ``eval``), and its consumers: ``pre_nms_size`` and
the NMS launch shape in the detect path and the export manifest.  A lookup
for the CPU leaves CUDA uninitialised, in a process of its own.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import export as t_export
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as t_nms
from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

from test_torch_train import small_model

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def clean_registry(monkeypatch):
    """The lookup cache and the once-a-reason lines are process-global."""
    monkeypatch.delenv(schedule_lib.ENV_DIR, raising=False)
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()
    yield
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()


def doc(kind="cpu", **entries):
    return {"format": schedule_lib.FORMAT, "device_kind": kind, "entries": entries}


def fallback_lines(err: str) -> list[dict]:
    return [json.loads(line) for line in err.splitlines() if '"schedule_fallback"' in line]


def test_round_trip_and_deep_merge(tmp_path):
    path = schedule_lib.save_schedule(doc(nms={"pre_nms_size": 500}), str(tmp_path))
    assert path == str(tmp_path / "cpu.json")
    assert schedule_lib.load_schedule(path)["entries"] == {"nms": {"pre_nms_size": 500}}
    want = {**schedule_lib.DEFAULT_SCHEDULE,
            "nms": {**schedule_lib.DEFAULT_SCHEDULE["nms"], "pre_nms_size": 500}}
    assert schedule_lib.lookup("cpu", str(tmp_path)) == want
    # A file that names no knob keeps the defaults.
    schedule_lib.save_schedule(doc(nms={}), str(tmp_path))
    assert schedule_lib.lookup("cpu", str(tmp_path)) == schedule_lib.DEFAULT_SCHEDULE


def test_every_problem_is_named():
    bad = {"format": "retinanet.schedule.v1", "device_kind": "", "entries": {
        "matching": {"tile_a": 8192}, "focal": {"impl": "xla"},
        "nms": {"pre_nms_size": 9000, "block_k": 256, "impl": "xla"}}, "trials": {}}
    with pytest.raises(schedule_lib.ScheduleError) as info:
        schedule_lib.validate_schedule(bad)
    text = str(info.value)
    for needle in ("format: expected 'retinanet_torch.schedule.v1'", "device_kind",
                   "matching.tile_a: one of the kernel's menu [128, 256] required, got 8192",
                   "focal: unknown keys ['impl']", "nms: unknown keys ['block_k', 'impl']",
                   "bitsets are uint64", "never takes a plain version",
                   "nms.pre_nms_size: int in [1, 8192]", "trials: list"):
        assert needle in text, needle
    with pytest.raises(schedule_lib.ScheduleError, match="nms: object required"):
        schedule_lib.validate_schedule(doc(nms=500))
    with pytest.raises(schedule_lib.ScheduleError):
        schedule_lib.save_schedule(bad)


def test_device_kind_and_slug():
    assert schedule_lib.resolve_kind(torch.device("cpu")) == "cpu"
    assert schedule_lib.resolve_kind("cpu") == "cpu"
    assert schedule_lib.resolve_kind("NVIDIA H100 80GB HBM3") == "NVIDIA H100 80GB HBM3"
    assert schedule_lib.device_slug("NVIDIA H100 80GB HBM3") == "nvidia_h100_80gb_hbm3"
    assert schedule_lib.device_slug("!!") == "unknown"
    if not torch.cuda.is_initialized():
        assert schedule_lib.resolve_kind(None) == "unknown"


def test_missing_and_invalid_files_fall_back_with_one_line_each(tmp_path, capsys):
    for _ in range(3):
        assert schedule_lib.lookup("cpu", str(tmp_path))["nms"]["pre_nms_size"] == 1000
        schedule_lib._cache.clear()
    lines = fallback_lines(capsys.readouterr().err)
    assert [(x["device_kind"], x["reason"]) for x in lines] == [("cpu", "no_schedule_artifact")]
    (tmp_path / "cpu.json").write_text(json.dumps(doc(nms={"pre_nms_size": 0})))
    assert schedule_lib.lookup("cpu", str(tmp_path)) == schedule_lib.lookup("gone", str(tmp_path / "x"))
    lines = fallback_lines(capsys.readouterr().err)
    assert [x["reason"] for x in lines] == ["invalid_schedule_artifact", "no_schedule_artifact"]
    assert "nms.pre_nms_size" in lines[0]["detail"]
    (tmp_path / "cpu.json").write_text("{not json")
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()
    assert schedule_lib.lookup("cpu", str(tmp_path))["nms"]["pre_nms_size"] == 1000
    assert fallback_lines(capsys.readouterr().err)[0]["reason"] == "invalid_schedule_artifact"


def test_cache_is_keyed_by_path_and_the_environment_overrides(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    schedule_lib.save_schedule(doc(nms={"pre_nms_size": 11}), str(a))
    schedule_lib.save_schedule(doc(nms={"pre_nms_size": 22}), str(b))
    assert schedule_lib.lookup("cpu", str(a))["nms"]["pre_nms_size"] == 11
    assert schedule_lib.lookup("cpu", str(b))["nms"]["pre_nms_size"] == 22
    monkeypatch.setenv(schedule_lib.ENV_DIR, str(a))
    assert schedule_lib.schedule_dir() == str(a)
    assert schedule_lib.lookup("cpu")["nms"]["pre_nms_size"] == 11
    got = schedule_lib.lookup("cpu")
    got["nms"]["pre_nms_size"] = 0  # a caller's copy: the cache stays as it was
    assert schedule_lib.lookup("cpu")["nms"]["pre_nms_size"] == 11
    monkeypatch.delenv(schedule_lib.ENV_DIR)
    assert schedule_lib.schedule_dir().endswith(os.path.join("batchai_retinanet_horovod_coco_tpu_torch",
                                                             "tune", "schedules"))
    assert "artifacts" not in schedule_lib.schedule_dir()


def test_provenance(tmp_path):
    schedule_lib.save_schedule(doc(nms={"pre_nms_size": 64}), str(tmp_path))
    assert schedule_lib.provenance("cpu", str(tmp_path)) == {
        "device_kind": "cpu", "source": str(tmp_path / "cpu.json"), "found": True}
    assert schedule_lib.provenance("cpu", str(tmp_path / "none"))["source"] == "defaults"
    (tmp_path / "cpu.json").write_text("{}")
    assert schedule_lib.provenance("cpu", str(tmp_path))["found"] is False  # invalid is not found
    inside = REPO / "batchai_retinanet_horovod_coco_tpu_torch" / "tune" / "schedules"
    assert schedule_lib.provenance("cpu")["found"] is False  # no file is committed
    assert not inside.exists() or not any(inside.iterdir())


@pytest.mark.parametrize("op", ["focal", "eval", "serve", "matching"])
def test_jax_entries_without_a_reader_are_refused(op, tmp_path):
    """The JAX registry's entries with a reader in the port are accepted and
    resolve (focal and matching: the train step); eval (its reader, the
    benchmark harness's eval, is not ported) and serve (no entry point
    builds the engine from a live model) are refused with their reasons,
    so that a file cannot set a knob that nothing reads."""
    if op in ("eval", "serve"):
        why = {"eval": "not ported", "serve": "builds the serve engine from a live model"}[op]
        with pytest.raises(schedule_lib.ScheduleError,
                           match=f"unknown op keys \\['{op}'\\].*{why}"):
            schedule_lib.validate_schedule(doc(**{op: {}}))
        return
    entry = {"focal": {"fwd_tile_a": 1024, "bwd_tile_a": 128}, "matching": {"tile_a": 128}}[op]
    assert schedule_lib.validate_schedule(doc(**{op: {}}))
    schedule_lib.save_schedule(doc(**{op: entry}), str(tmp_path))
    assert schedule_lib.lookup("cpu", str(tmp_path))[op] == entry


def test_a_cpu_lookup_leaves_cuda_uninitialised(tmp_path):
    code = ("import torch\n"
            "from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule\n"
            "schedule.lookup(torch.device('cpu')); schedule.lookup('cpu'); schedule.provenance('cpu')\n"
            "schedule.lookup(None)\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, schedule_lib.ENV_DIR: str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    assert {x["device_kind"] for x in fallback_lines(out.stderr)} == {"cpu", "unknown"}


def test_detect_and_export_read_the_registry(tmp_path, monkeypatch):
    registry = tmp_path / "registry"
    monkeypatch.setenv(schedule_lib.ENV_DIR, str(registry))
    config = t_detect.DetectConfig(score_threshold=0.001, max_detections=20)
    assert t_detect.resolve_detect_config(config, "cpu").pre_nms_size == 1000
    schedule_lib.save_schedule(doc(nms={"pre_nms_size": 37, "mask_lanes": 8}), str(registry))
    resolved = t_detect.resolve_detect_config(config, "cpu")
    assert (resolved.pre_nms_size, resolved.nms_mask_lanes, resolved.nms_scan_threads) == (37, 8, 256)
    pinned = t_detect.DetectConfig(pre_nms_size=5, nms_mask_lanes=2, nms_scan_threads=512)
    assert t_detect.resolve_detect_config(pinned, "cpu") is pinned
    # postprocess, which every detect path goes through, hands the NMS the
    # registry's size where the config leaves it None, and a pinned one else.
    model = small_model()
    hw = (64, 64)
    anchors = t_detect.anchors_on(hw, config.anchor, torch.device("cpu"))
    with torch.no_grad():
        outputs = model(torch.zeros((1, *hw, 3)))
    handed = []

    def nms(*args, **kwargs):
        handed.append(kwargs["pre_nms_size"])
        return t_nms.batched_multiclass_nms(*args, **kwargs)

    for c in (config, pinned):
        t_detect.postprocess(outputs, anchors, hw, c, nms=nms)
    assert handed == [37, 5]
    manifest = json.loads(Path(t_export.export_model(
        model, str(tmp_path / "export"), (hw,), 1, config, "cpu")).read_text())
    assert manifest["detect_config"]["pre_nms_size"] == 37
    assert manifest["launch_shapes"] == {"nms": {"mask_lanes": 8, "scan_threads": 256}}
    assert manifest["schedule"] == {"device_kind": "cpu", "found": True,
                                    "source": str(registry / "cpu.json")}
