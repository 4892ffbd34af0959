"""The schedule search's command line (``python -m
batchai_retinanet_horovod_coco_tpu_torch.tune``) on the CPU.

A CPU run writes a file whose entries are the defaults (the other
candidates skipped: no kernel runs here) and that the CPU's lookups
resolve; ``--bench-out`` writes the record and ``--check`` holds a fresh
measurement to it within max(3%, the record's noise) on its best window,
passing a record of another device kind with a note; ``--check`` without
``--bench-out`` is an error; a dead card exits 75 with one JSON line;
``--from-report`` drives the search and names a ``batch`` it does not
search; ``--trace`` records the four spans; and the default device is the
card.
"""

import json

import pytest
import torch

from batchai_retinanet_horovod_coco_tpu_torch import losses as t_losses
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as t_matching
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step
from batchai_retinanet_horovod_coco_tpu_torch.tune import __main__ as t_tune_cli
from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib
from batchai_retinanet_horovod_coco_tpu_torch.tune import search as t_search

DEFAULTS = schedule_lib.DEFAULT_SCHEDULE


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    """The registry's cache and lines, and the trace, are process-global."""
    monkeypatch.delenv(schedule_lib.ENV_DIR, raising=False)
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()
    t_trace.reset()
    yield
    schedule_lib._cache.clear()
    schedule_lib._warned.clear()
    t_trace.reset()


def test_a_cpu_run_writes_the_defaults_and_the_cpu_resolves_them(tmp_path, monkeypatch, capsys):
    out = tmp_path / "registry"
    assert t_tune_cli.main(["--device", "cpu", "--smoke", "--out-root", str(out)]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["artifact"] == str(out / "cpu.json") and summary["device_kind"] == "cpu"
    doc = schedule_lib.load_schedule(summary["artifact"])
    assert doc["entries"] == {op: DEFAULTS[op] for op in ("nms", "focal", "matching")}
    ok = [t for t in doc["trials"] if t["status"] == "ok"]
    skipped = [t for t in doc["trials"] if t["status"] == "skipped"]
    assert [t["params"] for t in ok] == [DEFAULTS[op] for op in ("nms", "focal", "matching")]
    assert all(t["ms_per_call"] > 0 and len(t["window_ms"]) == 2 for t in ok)
    assert len(skipped) == 6 + 4 + 2 - 3 == summary["skipped"]
    assert all("no CUDA device" in t["error"] for t in skipped)
    assert schedule_lib.lookup("cpu", str(out)) == {**DEFAULTS, **doc["entries"]}
    # The consumers on the CPU resolve the file's entries, the same on every call.
    monkeypatch.setenv(schedule_lib.ENV_DIR, str(out))
    resolved = t_detect.resolve_detect_config(t_detect.DetectConfig(), "cpu")
    assert (resolved.pre_nms_size, resolved.nms_mask_lanes, resolved.nms_scan_threads) == (1000, 4, 256)
    assert t_detect.resolve_detect_config(t_detect.DetectConfig(), "cpu") == resolved
    loss, match = t_step.resolve_kernel_schedule(t_losses.LossConfig(), t_matching.MatchingConfig(),
                                                 "cpu")
    assert (loss.focal_fwd_tile_a, loss.focal_bwd_tile_a, match.tile_a) == (2048, 256, 256)
    assert schedule_lib.provenance("cpu")["found"] is True


def test_bench_out_writes_a_record_that_check_holds_the_cpu_to(tmp_path, capsys):
    record = tmp_path / "tunebench.json"
    assert t_tune_cli.main(["--device", "cpu", "--ops", "nms", "--hw", "64x64", "--batch", "1",
                            "--steps", "2", "--out-root", str(tmp_path), "--bench-out",
                            str(record)]) == 0
    rec = json.loads(record.read_text())
    assert rec["device_kind"] == "cpu" and rec["hw"] == [64, 64] and rec["batch"] == 1
    assert rec["winner"] == DEFAULTS["nms"] and rec["value"] > 0 and rec["metric"] == \
        "nms_keep_mask_ms_per_batch"
    capsys.readouterr()
    # A recorded value far above any fresh one passes; one far below regresses.
    record.write_text(json.dumps({**rec, "value": 1e9}))
    assert t_tune_cli.main(["--device", "cpu", "--check", "--bench-out", str(record),
                            "--steps", "2"]) == 0
    record.write_text(json.dumps({**rec, "value": 1e-9}))
    assert t_tune_cli.main(["--device", "cpu", "--check", "--bench-out", str(record),
                            "--steps", "2"]) == 1
    out = capsys.readouterr().out
    assert ": ok" in out and ": REGRESSION" in out


@pytest.mark.parametrize("windows,noise,verdict", [
    ([10.29, 12.0], 0.0, 0),  # best window under 10 * 1.03
    ([10.31, 10.4], 0.0, 1),  # above the 3% band
    ([10.31, 10.4], 5.0, 0),  # the record's own noise widens the band
    ([10.51, 10.6], 5.0, 1),
])
def test_check_holds_the_best_window_to_the_band(windows, noise, verdict, tmp_path, monkeypatch):
    def trial(op, params, build, steps, semantics="exact", **clock):
        assert op == "nms" and params == {"mask_lanes": 8, "scan_threads": 512, "pre_nms_size": 1000}
        assert clock == {"windows": t_search.host_windows}
        return t_search.Trial(op, params, sum(windows) / 2, windows, 1.0)

    monkeypatch.setattr(t_search, "run_trial", trial)
    monkeypatch.setattr(t_search, "_nms_builder", lambda batch, hw, device: None)
    record = tmp_path / "tunebench.json"
    record.write_text(json.dumps({"value": 10.0, "device_kind": "cpu", "noise_pct": noise,
                                  "hw": [64, 64], "batch": 1, "winner": {
                                      "mask_lanes": 8, "scan_threads": 512, "pre_nms_size": 1000}}))
    assert t_tune_cli.main(["--device", "cpu", "--check", "--bench-out", str(record)]) == verdict


def test_check_passes_a_record_of_another_device_kind(tmp_path, capsys):
    record = tmp_path / "tunebench.json"
    record.write_text(json.dumps({"value": 1e-9, "device_kind": "NVIDIA H100 80GB HBM3"}))
    assert t_tune_cli.main(["--device", "cpu", "--check", "--bench-out", str(record)]) == 0
    assert "not comparable" in capsys.readouterr().out


def test_check_needs_a_record_path(capsys):
    with pytest.raises(SystemExit) as info:
        t_tune_cli.main(["--device", "cpu", "--check"])
    assert info.value.code == 2
    assert "--check needs --bench-out" in capsys.readouterr().err


def test_a_dead_card_exits_75_with_one_line(tmp_path, monkeypatch, capsys):
    def dead(**kwargs):
        raise t_search.DeviceUnavailable("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(t_search, "run_search", dead)
    record = tmp_path / "tunebench.json"
    record.write_text(json.dumps({"value": 2.6}))
    assert t_tune_cli.main(["--device", "cpu", "--smoke", "--out-root", str(tmp_path),
                            "--bench-out", str(record)]) == 75
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["error"] == "device_unavailable" and line["exit_code"] == 75
    assert "illegal memory access" in line["last_error"]
    assert line["last_known_good"]["value"] == 2.6
    assert not (tmp_path / "cpu.json").exists()


def test_from_report_drives_the_search(tmp_path, capsys):
    report = tmp_path / "PERF_REPORT.json"
    report.write_text(json.dumps({"bottlenecks": [{"name": "device_step", "tune_ops": ["matching"]}]}))
    assert t_tune_cli.main(["--device", "cpu", "--from-report", str(report), "--smoke", "--steps",
                            "2", "--dry-run", "--out-root", str(tmp_path / "none")]) == 0
    out = capsys.readouterr().out
    assert f"# tune: --from-report {report} -> ops=matching\n" in out
    doc = json.loads(out[out.index("{"):])
    assert doc["entries"] == {"matching": DEFAULTS["matching"]}
    assert not (tmp_path / "none").exists()


@pytest.mark.parametrize("tune_ops,searched", [(["batch", "nms"], True), (["batch"], False)],
                         ids=["batch-and-nms", "batch-only"])
def test_from_report_names_batch_and_searches_no_batch_axis(tune_ops, searched, tmp_path, capsys):
    """A report's ``batch`` (the JAX package's serve batch-size axis) is
    named and not searched; a report naming nothing else is refused."""
    report = tmp_path / "PERF_REPORT.json"
    report.write_text(json.dumps({"bottlenecks": [{"name": "eval_pipeline", "tune_ops": tune_ops}]}))
    argv = ["--device", "cpu", "--from-report", str(report), "--smoke", "--steps", "2",
            "--dry-run", "--out-root", str(tmp_path / "none")]
    if not searched:
        with pytest.raises(SystemExit, match="names no op the port searches"):
            t_tune_cli.main(argv)
        return
    assert t_tune_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "-> ops=nms (batch named: the port searches no serve batch sizes)" in out
    doc = json.loads(out[out.index("{"):])
    assert set(doc["entries"]) == {"nms"}


def test_trace_records_the_tune_spans(tmp_path, capsys):
    obs = tmp_path / "obs"
    assert t_tune_cli.main(["--device", "cpu", "--ops", "matching", "--smoke", "--steps", "2",
                            "--out-root", str(tmp_path), "--trace", "--obs-dir", str(obs)]) == 0
    events = json.loads((obs / "tune_trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"tune_search", "tune_trial", "tune_compile", "tune_window"} <= names
    trials = [e for e in events if e["name"] == "tune_trial" and e.get("ph") in ("X", "B")]
    assert len(trials) == 1 and trials[0]["args"]["tile_a"] == DEFAULTS["matching"]["tile_a"]


def test_the_default_device_is_the_card(monkeypatch):
    """Without a card (as this process sees it), the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tune_cli.main(["--smoke"])
