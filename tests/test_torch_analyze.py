"""The perf doctor (``obs/analyze``) of the port against the JAX package's.

The port's analyzer is a copy of the JAX one's report format: on the same
artifacts (the JAX package's own golden fixture, and seeded synthetic
traces with their events, single-run and ``--fleet``) both give the same
report, bit for bit, except the peak row (the port's table holds NVIDIA
cards only) and ``flops_source`` (what the step FLOPs counted).  The train
command line writes ``PERF_REPORT.json`` at finalize with ``--obs-trace``;
the offline command line's report for that directory is byte-identical;
``--check`` needs a named baseline.  Tolerance: none (the reports are
compared as JSON).
"""

import copy
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.obs.analyze import report as j_analyze
from batchai_retinanet_horovod_coco_tpu.obs import telemetry as j_telemetry
from batchai_retinanet_horovod_coco_tpu.obs import trace as j_trace
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import normalize_images
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.obs import analyze as t_analyze
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as t_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import metric_records, split_runs
from batchai_retinanet_horovod_coco_tpu_torch.obs.analyze.__main__ import main as t_cli
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.train.loop import FLOPS_SOURCE, step_flops

REPO_ROOT = Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO_ROOT / "tests" / "fixtures" / "perf_doctor"
H100 = "NVIDIA H100 80GB HBM3"
# The keys of the ``mfu`` section that follow the peak row or the FLOP source.
PEAK_KEYS = ("peak_tflops", "peak_source", "mfu", "note")


@pytest.fixture(autouse=True)
def clean_obs():
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    yield
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    t_watchdog.stop()


def without_peak(report: dict) -> dict:
    out = copy.deepcopy(report)
    for key in (*PEAK_KEYS, "flops_source"):
        out["mfu"].pop(key, None)
    return out


def test_port_reproduces_the_jax_golden_report():
    """The JAX package's committed report of a CPU train-and-eval run."""
    golden = json.loads((GOLDEN_DIR / "PERF_REPORT.golden.json").read_text())
    assert t_analyze.analyze_dir(str(GOLDEN_DIR)) == golden


def test_peak_table_holds_the_cards():
    assert t_analyze.device_peak_tflops(H100) == (989.0, "spec")
    assert t_analyze.device_peak_tflops("NVIDIA H100 PCIe") == (756.0, "spec")
    assert t_analyze.device_peak_tflops("cpu") == (t_analyze.CPU_NOMINAL_PEAK_TFLOPS, "nominal-cpu")
    assert t_analyze.device_peak_tflops("TPU v5 lite") == (None, None)  # no TPU row
    assert j_analyze.device_peak_tflops("TPU v5 lite") == (197.0, "spec")


def synthetic_run(root: Path, seed: int, device_kind: str, fleet: bool, flops_source: str | None) -> Path:
    """A seeded obs dir: a train loop's spans (with compiles, evals and
    metric fetches), the eval and serve drivers' pairs, feed-queue and
    memory counters, run metadata, step FLOPs, SLO violations, numerics
    trips, stalls; its events JSONL; with ``fleet``, replicas' request
    spans, stage spans, fleet instants and a FLEET_METRICS.json."""
    rng = np.random.default_rng(seed)
    ev: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "p0:train (pid 1)"}},
        {"ph": "i", "name": "run_meta", "pid": 1, "tid": 1, "ts": 0,
         "args": {"device_kind": device_kind, "local_device_count": 1, "process_count": 1}},
    ]
    cost = {"target": "train_step", "bucket": "800x1344", "flops": float(rng.uniform(1e12, 2e13)),
            "batch": 16}
    if flops_source:
        cost["source"] = flops_source
    ev.append({"ph": "i", "name": "cost_analysis", "pid": 1, "tid": 1, "ts": 5, "args": cost})
    t = 10
    for step in range(int(rng.integers(20, 40))):
        for name, mean in (("data_wait", 3e3), ("compile_train_step", 2e5), ("step", 2e5),
                           ("metrics_fetch", 500), ("eval", 5e5)):
            if name == "compile_train_step" and step:
                continue
            if name in ("metrics_fetch", "eval") and step % int(rng.integers(3, 9)):
                continue
            dur = int(rng.exponential(mean)) + 1
            ev.append({"ph": "X", "name": name, "pid": 1, "tid": 1, "ts": t, "dur": dur})
            t += dur + int(rng.integers(0, 200))
        ev.append({"ph": "C", "name": "device-prefetch.qsize", "pid": 1, "tid": 2, "ts": t - 50,
                   "args": {"value": int(rng.integers(0, 3))}})
        ev.append({"ph": "C", "name": "dev0.bytes_in_use", "pid": 1, "tid": 1, "ts": t,
                   "args": {"value": 1e9 + step * float(rng.uniform(1e5, 1e6))}})
    for driver, pid in (("detect", 1), ("serve", 2)):
        s = int(rng.integers(0, t))
        for _ in range(int(rng.integers(3, 8))):
            for stage in ("dispatch", "fetch", "convert"):
                name = f"{driver}_{stage}" if driver == "serve" or stage != "convert" else "eval_convert"
                dur = int(rng.exponential(2e4)) + 1
                ev.append({"ph": "X", "name": name, "pid": pid, "tid": 3, "ts": s, "dur": dur})
                s += dur
    for i in range(int(rng.integers(1, 4))):
        ev.append({"ph": "i", "name": "slo_violation", "pid": 1, "tid": 1, "ts": t + i,
                   "args": {"rule": f"rule{i % 2}", "metric": "train_step_time_ms", "op": ">",
                            "threshold": 250.0, "value": 300.0 + i, "sustained_s": 30.0 + i}})
    ev.append({"ph": "i", "name": "stall", "pid": 1, "tid": 1, "ts": t, "args": {"component": "train-loop"}})
    if seed % 2:
        ev.append({"ph": "i", "name": "numerics_trip", "pid": 1, "tid": 1, "ts": t,
                   "args": {"metric": "loss", "step": 7, "value": float("nan")}})
    lines = [{"event": "run_header", "run_id": f"r{seed}", "device_kind": device_kind,
              "local_device_count": 1, "process_index": 0, "process_count": 1, "config_digest": "x"},
             {"event": "compile", "target": "train_step", "bucket": "800x1344", "build_s": 2.5}]
    for step in range(1, 6):
        lines.append({"step": step, "train/grad_norm": float(rng.uniform(1, 3))})
        lines.append({"event": "numerics", "step": step, "grad_norm": float(rng.uniform(1, 3)),
                      "update_ratio": float(rng.uniform(0, 1e-3)), "nonfinite_grads": 0.0})
    lines.append({"event": "slo_violation", "rule": "rule0", "metric": "train_step_time_ms",
                  "op": ">", "threshold": 250.0, "value": 320.0, "sustained_s": 31.0,
                  "description": "step time over 250 ms"})
    lines.append({"event": "watchdog_stall", "component": "train-loop"})
    if fleet:
        for r, pid in (("r0", 10), ("r1", 11), ("r2", 12)):
            ev.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": f"p1:{r} (pid {pid})"}})
            s = int(rng.integers(0, t))
            for k in range(int(rng.integers(4, 12))):
                dur = int(rng.exponential(3e4 * (1 + (r == "r2")))) + 1
                ev.append({"ph": "X", "name": "serve_request", "pid": pid, "tid": 1, "ts": s, "dur": dur,
                           "args": {"replica": r, "trace": f"t{int(rng.integers(0, 20))}"}})
                ev.append({"ph": "X", "name": "serve_preprocess", "pid": pid, "tid": 2, "ts": s,
                           "dur": dur // 3})
                s += dur + 10
        for name, rid in (("fleet_breaker_open", "r1"), ("fleet_replica_died", "r1"),
                          ("fleet_replica_respawned", "r1"), ("fleet_redispatch", "r0")):
            ev.append({"ph": "i", "name": name, "pid": 1, "tid": 9, "ts": int(rng.integers(0, t)),
                       "args": {"replica_id": rid, "reason": "probe", "trace": "t3"}})
        for decision in ("scale_up", "scale_up_capped", "scale_up_capped"):
            ev.append({"ph": "i", "name": "autoscale_decision", "pid": 1, "tid": 9,
                       "ts": int(rng.integers(0, t)), "args": {"decision": decision, "reason": "queue"}})
        metrics = {"replicas": {r: {"samples": [
            ["serve_requests_completed_total", {}, float(rng.integers(10, 100))],
            ["serve_shed_total", {}, float(rng.integers(0, 10))],
            ["serve_request_latency_ms", {"quantile": "0.99"}, float(rng.uniform(20, 90))],
        ]} for r in ("r0", "r1", "r2")}}
        (root / "FLEET_METRICS.json").write_text(json.dumps(metrics))
    (root / "trace.json").write_text(json.dumps({"traceEvents": ev, "otherData": {"merged_from": ["a", "b"]}}))
    (root / "metrics.jsonl").write_text("".join(json.dumps(r) + "\n" for r in lines))
    return root


@pytest.mark.parametrize("fleet", [False, True], ids=["single", "fleet"])
@pytest.mark.parametrize("device_kind", ["cpu", H100])
@pytest.mark.parametrize("seed", range(3))
def test_reports_equal_jax_on_a_synthetic_run(seed, device_kind, fleet, tmp_path):
    source = FLOPS_SOURCE if seed % 2 else None
    obs_dir = str(synthetic_run(tmp_path, seed, device_kind, fleet, source))
    analyze = "analyze_fleet_dir" if fleet else "analyze_dir"
    got = getattr(t_analyze, analyze)(obs_dir)
    want = getattr(j_analyze, analyze)(obs_dir)
    assert without_peak(got) == without_peak(want)
    assert t_analyze.validate_report(got) == [] and t_analyze.validate_report(want) == []
    assert got["mfu"]["flops_source"] == (source or "trace_cost_analysis") and want["mfu"]["flops_source"] == "trace_cost_analysis"
    if device_kind == "cpu":
        assert {k: got["mfu"].get(k) for k in PEAK_KEYS} == {k: want["mfu"].get(k) for k in PEAK_KEYS}
    else:
        assert want["mfu"]["peak_tflops"] is None and want["mfu"]["mfu"] is None
        assert got["mfu"]["peak_tflops"] == 989.0 and got["mfu"]["peak_source"] == "spec"
        assert got["mfu"]["mfu"] == round(got["mfu"]["achieved_tflops"] / 989.0, 6) > 0
    if fleet:
        assert set(got["fleet"]["replicas"]) == {"r0", "r1", "r2"}
        names = [b["name"] for b in got["bottlenecks"]]
        assert "fleet:unavailable_replica:r1" in names and "fleet:underprovisioned" in names
    # The CLI's file is the report as written, bit for bit.
    out = tmp_path / "cli.json"
    assert t_cli([obs_dir, "--out", str(out)] + (["--fleet"] if fleet else [])) == 0
    assert out.read_bytes() == Path(t_analyze.write_report(got, str(tmp_path / "direct.json"))).read_bytes()


def test_check_needs_a_named_baseline(tmp_path, capsys):
    obs_dir = str(synthetic_run(tmp_path, 0, "cpu", False, None))
    assert t_cli([obs_dir, "--check"]) == 2
    assert "no baseline" in capsys.readouterr().err
    baseline = t_analyze.write_report(t_analyze.analyze_dir(obs_dir), str(tmp_path / "baseline.json"))
    assert t_cli([obs_dir, "--out", str(tmp_path / "fresh.json"), "--check", baseline]) == 0
    assert "REGRESSION" not in capsys.readouterr().out


def test_auto_emit_never_raises(tmp_path, capsys):
    got = []

    class Sink:
        def event(self, kind, **fields):
            got.append((kind, fields))

    assert t_analyze.auto_emit(str(tmp_path / "missing"), sink=Sink()) is None
    assert got and got[0][0] == "perf_report_error"
    line = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert line["event"] == "perf_report_error"


def test_step_flops_count_forward_and_backward_on_meta_tensors():
    """The count on meta tensors is FlopCounterMode's over a real forward
    and backward of the model, about three times the forward's, and leaves
    the model's parameters, buffers and gradients as they were."""
    model = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(
        num_classes=3, backbone="resnet_test", fpn_channels=16, head_width=16, head_depth=1,
        dtype=torch.float32), device="cpu", seed=0)
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flops = step_flops(model, tuple(images.shape))
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(p.grad is None for p in model.parameters())
    from torch.utils.flop_counter import FlopCounterMode

    real, forward = FlopCounterMode(display=False), FlopCounterMode(display=False)
    with real:
        outputs = model(normalize_images(images))
        sum(v.float().sum() for v in outputs.values()).backward()
    with forward, torch.no_grad():
        model(normalize_images(images))
    assert flops == real.get_total_flops()
    assert 2.5 < flops / forward.get_total_flops() < 3.5


def test_train_cli_writes_the_report_the_offline_cli_repeats(tmp_path, monkeypatch, capsys):
    """A tiny traced CPU run: PERF_REPORT.json at finalize passes the
    schema, counts the step FLOPs with torch's counter, and the offline
    command line writes the same bytes; the JAX analyzer reads the port's
    artifacts to the same report but for the FLOP source."""
    monkeypatch.setattr(sys, "stdin", io.StringIO())
    obs_dir = tmp_path / "obs"
    argv = ["synthetic", "--device", "cpu", "--synthetic-root", str(tmp_path / "data"),
            "--synthetic-images", "8", "--synthetic-size", "64", "--image-min-side", "64",
            "--image-max-side", "64", "--backbone", "resnet_test", "--f32", "--batch-size", "2",
            "--workers", "2", "--steps", "3", "--log-every", "1"]
    t_train.main(argv + ["--snapshot-path", str(tmp_path / "ckpt"), "--obs-trace", "--obs-dir", str(obs_dir)])
    t_trace.reset()
    t_train.main(argv + ["--snapshot-path", str(tmp_path / "ckpt2"), "--log-dir", str(tmp_path / "logs")])
    # Counting the step's FLOPs changes no number of the run.
    traced, plain = ([r for r in metric_records(split_runs(str(d / "metrics.jsonl"))[-1]) if "train/loss" in r]
                     for d in (obs_dir, tmp_path / "logs"))
    keys = ("train/loss", "train/grad_norm", "train/param_norm")
    assert len(traced) == 3 and [[r[k] for k in keys] for r in traced] == [[r[k] for k in keys] for r in plain]
    inline = (obs_dir / "PERF_REPORT.json").read_bytes()
    report = json.loads(inline)
    assert t_analyze.validate_report(report) == []
    assert report["steps"]["count"] == 3 and report["steps"]["decomposition"]["compile"] == 0.0
    assert abs(sum(report["steps"]["decomposition"].values()) - 1.0) <= 0.02
    assert report["mfu"]["flops_source"] == FLOPS_SOURCE and report["mfu"]["flops_per_step"] > 0
    assert report["source"]["device_kind"] == "cpu"
    assert t_cli([str(obs_dir), "--out", str(tmp_path / "offline.json")]) == 0
    assert (tmp_path / "offline.json").read_bytes() == inline
    assert without_peak(j_analyze.analyze_dir(str(obs_dir))) == without_peak(report)
    assert "obs: perf report at" in capsys.readouterr().out
