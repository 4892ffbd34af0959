"""The port's obs layer (``obs/``, ``utils/locks.py`` and their wiring
through ``train`` and ``serve``) against the JAX package's.

- exposition: the same record calls into both telemetry registries give
  byte-equal Prometheus text (the families whose values are clocks — ages,
  uptimes — and the JAX-only families of the gradient-compression and
  replica planes, which the port does not have, left out by name);
- healthz: a stalled component gives both packages the same status code
  and payload keys;
- SLO: the same rule specs give equal ``SloRule``s, and a monitor fires
  once per sustained breach on both;
- names: every span, flow, event and series name the port's code emits is
  in the port's ``VOCABULARY``, and every entry there is emitted by the
  port and is the JAX package's (in its ``VOCABULARY``, with its kinds, or,
  for the names its registry does not list — spans, flows, collector
  families — emitted under the same name by its code);
- the command lines: ``train`` with ``--inject-nan-step --auto-resume
  --numerics`` excludes the same image ids as the JAX ``train.py``;
  ``train --obs-trace`` writes the merged trace and the event log;
  ``serve --http 0 --obs-port 0`` answers ``/metrics`` and ``/healthz``.
"""

import dataclasses
import json
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.obs import slo as j_slo
from batchai_retinanet_horovod_coco_tpu.obs import telemetry as j_telemetry
from batchai_retinanet_horovod_coco_tpu.obs import trace as j_trace
from batchai_retinanet_horovod_coco_tpu.obs import watchdog as j_watchdog
from batchai_retinanet_horovod_coco_tpu.obs.vocabulary import VOCABULARY as J_VOCABULARY
from batchai_retinanet_horovod_coco_tpu_torch.data import image_io
from batchai_retinanet_horovod_coco_tpu_torch.evaluate.export import export_model
from batchai_retinanet_horovod_coco_tpu_torch.obs import events as t_events
from batchai_retinanet_horovod_coco_tpu_torch.obs import slo as t_slo
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as t_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.obs.vocabulary import VOCABULARY as T_VOCABULARY
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.utils import locks as t_locks

from test_torch_train import drop_tmp_path, small_model  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = REPO_ROOT / "batchai_retinanet_horovod_coco_tpu_torch"
JAX_DIR = REPO_ROOT / "batchai_retinanet_horovod_coco_tpu"
sys.path.insert(0, str(REPO_ROOT))  # train.py
import train as j_train  # noqa: E402

# Families whose values are clocks (ages, uptimes): they differ between
# any two scrapes.
CLOCK_FAMILIES = {"process_uptime_seconds", "watchdog_beat_age_seconds",
                  "ckpt_last_success_age_s", "ckpt_age_over_interval"}
# The JAX registry's train handles for planes the port does not have yet
# (multi-GPU training, gradient compression: ROADMAP.md).
JAX_ONLY_FAMILIES = {"train_ef_residual", "train_ef_saturation",
                     "train_comm_compressed_bytes_total", "train_comm_ici_bytes_total",
                     "train_comm_dcn_bytes_total", "train_ef_residual_dcn"}


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test starts and ends with both packages' obs layers off."""
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    yield
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    for wd in (t_watchdog, j_watchdog):
        wd.stop()
        wd.default().sink = None


def family(line: str) -> str:
    if line.startswith("#"):
        return line.split()[2]
    name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
    return re.sub(r"_(count|sum)$", "", name)


def exposition(registry, drop: set[str]) -> str:
    lines = registry.prometheus_text().splitlines()
    return "\n".join(line for line in lines if family(line) not in drop) + "\n"


def record_all(telemetry) -> None:
    telemetry.enable()
    telemetry.record_train_window(step=10, images_per_s=72.46, step_time_ms=220.821,
                                  data_wait_ms=0.352)
    telemetry.record_compile("800x1344", 1.2345678)
    telemetry.record_numerics(grad_norm=3.5, update_ratio=1e-3, nonfinite=0.0, replica_agreement=0.97)
    telemetry.record_numerics(grad_norm=float("nan"), update_ratio=0.25, nonfinite=float("nan"))
    telemetry.record_nonfinite_trip("loss")
    telemetry.record_ckpt_save(3, 1.0123, 303886547)
    telemetry.record_ckpt_save(6, 1.25, 303886547)
    telemetry.record_ckpt_inflight(1)
    telemetry.record_serve_batch(0.75, 2, (1.5, 2.25, 0.1))
    telemetry.record_serve_batch(1.0, 0, ())


def fill(registry) -> None:
    """Counters, gauges (pushed and pulled), labels that need escaping,
    float formats, a histogram and a collector."""
    c = registry.counter("demo_requests_total", "requests by route")
    c.inc(route="/detect")
    c.inc(2.5, route='a"b\\c\nd')
    g = registry.gauge("demo_temperature", "a gauge")
    for v in (1e20, 0.1, 3.0, -2.5e-7):
        g.set(v)
    registry.gauge("demo_pulled", "pulled at scrape", fn=lambda: 1 / 3)
    h = registry.histogram("demo_latency_ms", "latency", window=32)
    for v in np.linspace(0.5, 99.5, 40):
        h.observe(float(v))
    registry.register_collector(lambda: iter([
        ("demo_collected", "gauge", "from a collector", {"queue": "bucket_800x1344"}, 7.0),
        ("demo_collected", "gauge", "from a collector", {"queue": "admission"}, 0.0),
    ]))


def test_exposition_is_byte_equal_to_jax():
    record_all(t_telemetry)
    record_all(j_telemetry)
    drop = CLOCK_FAMILIES | {"watchdog_components", "watchdog_stalled", "device_memory_bytes"}
    got = exposition(t_telemetry.default(), drop)
    want = exposition(j_telemetry.default(), drop | JAX_ONLY_FAMILIES)
    assert "train_step_time_ms 220.821" in got and "ckpt_staleness" in got
    assert got == want
    registries = []
    for telemetry in (t_telemetry, j_telemetry):
        registry = telemetry.Registry()
        fill(registry)
        registries.append(registry)
    assert registries[0].prometheus_text() == registries[1].prometheus_text()
    assert registries[0].snapshot() == registries[1].snapshot()
    text = registries[0].prometheus_text()
    assert t_telemetry.parse_exposition(text) == j_telemetry.parse_exposition(text)
    assert t_telemetry.parse_exposition_samples(text) == j_telemetry.parse_exposition_samples(text)


def test_records_are_one_bool_check_while_disabled():
    t_telemetry.record_train_window(step=1, images_per_s=1.0, step_time_ms=1.0, data_wait_ms=0.0)
    t_telemetry.record_serve_batch(1.0, 0, (1.0,))
    assert t_telemetry._train_gauges is None and t_telemetry._serve_metrics is None


@pytest.mark.parametrize("stalled", [False, True], ids=["ok", "stalled"])
def test_healthz_matches_jax(stalled):
    answers = []
    for watchdog, telemetry in ((t_watchdog, t_telemetry), (j_watchdog, j_telemetry)):
        wd = watchdog.Watchdog(stall_after=60.0)
        wd.register("beating")
        wd.register("stuck", stall_after=0.01 if stalled else 60.0)
        time.sleep(0.05)
        answers.append(telemetry.healthz(wd))
    (code, got), (want_code, want) = answers
    assert code == want_code == (503 if stalled else 200)
    assert set(got) == set(want)
    if stalled:
        assert got["component"] == want["component"] == "stuck"
        assert [set(s) for s in got["stalled"]] == [set(s) for s in want["stalled"]]
    assert set(got["components"]) == set(want["components"]) == {"beating", "stuck"}


SPECS = ["serve_request_latency_ms.p99>250@30", "train_step_time_ms>x1.5@60",
         "train_data_wait_fraction>=0.2", "fleet_availability<0.999@5", "serve_shed_total<=3"]


def test_slo_rules_match_jax():
    for spec in SPECS:
        assert dataclasses.asdict(t_slo.parse_rule(spec)) == dataclasses.asdict(j_slo.parse_rule(spec))
    for name, args in [("stall_rule", ()), ("p99_ceiling", (250.0,)), ("shed_rate", (5.0,)),
                       ("step_time_regression", ()), ("nonfinite_rule", ()),
                       ("ckpt_staleness_rule", ()), ("grad_norm_spike", ())]:
        got, want = getattr(t_slo, name)(*args), getattr(j_slo, name)(*args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    with pytest.raises(ValueError, match="bad SLO rule"):
        t_slo.parse_rule("p99 is high")


def test_slo_monitor_fires_once_a_breach_as_jax():
    fired = []
    for slo, telemetry in ((t_slo, t_telemetry), (j_slo, j_telemetry)):
        registry = telemetry.Registry()
        values = iter([1.0, 5.0, 5.0, 5.0, 1.0, 1.0, 5.0])
        registry.gauge("demo_value", fn=lambda: next(values))
        rule = slo.parse_rule("demo_value>2@1")
        monitor = slo.SloMonitor(registry, [dataclasses.replace(rule, clear_s=1.0)])
        fired.append([len(monitor.check_once(now=float(t))) for t in range(7)])
        assert registry.snapshot()[f'slo_violations_total{{rule="{rule.name}"}}'] == 1.0
    assert fired[0] == fired[1] == [0, 0, 1, 0, 0, 0, 0]


CALL = re.compile(
    r'\b(span|begin|instant|counter|gauge|histogram|event|emit_event|log_event|flow_step)'
    r'\(\s*"([^"]+)"', re.S)
COLLECTED = re.compile(r'yield\s*\(\s*"([^"]+)",\s*"(?:gauge|counter|summary)"', re.S)
KIND = {"span": "span", "begin": "span", "flow_step": "flow", "instant": "instant",
        "event": "event", "emit_event": "event", "log_event": "event"}


def emitted(root: Path) -> dict[str, set[str]]:
    names: dict[str, set[str]] = {}
    for path in root.rglob("*.py"):
        text = path.read_text()
        for fn, name in CALL.findall(text):
            names.setdefault(name, set()).add(KIND.get(fn, "series"))
        for name in COLLECTED.findall(text):
            names.setdefault(name, set()).add("series")
    return names


def test_emitted_names_are_the_vocabulary_and_jax_s():
    port = emitted(PORT_DIR)
    jax_names = emitted(JAX_DIR)
    jax_source = "\n".join(p.read_text() for p in [*JAX_DIR.rglob("*.py"), REPO_ROOT / "train.py"])
    assert set(port) == set(T_VOCABULARY)  # listed iff emitted
    for name, entry in T_VOCABULARY.items():
        assert all(c == "chip_smoke.py" or c.startswith("batchai_retinanet_horovod_coco_tpu_torch/")
                   for c in entry["consumers"]), name
        assert all((REPO_ROOT / c).exists() for c in entry["consumers"]), name
        if name in J_VOCABULARY:
            assert entry["kinds"] == J_VOCABULARY[name]["kinds"], name
        elif "span" in entry["kinds"] or "flow" in entry["kinds"]:
            assert name in jax_names and jax_names[name] & {"span", "flow"}, name
        else:
            assert f'"{name}"' in jax_source, name


def test_lock_order_file_is_the_port_s():
    path = t_locks.default_order_path()
    assert Path(path).resolve().parent == PORT_DIR.resolve()
    edges = json.loads(Path(path).read_text())["edges"]
    source = {p.relative_to(PORT_DIR).with_suffix("").as_posix().replace("/", "."): p.read_text()
              for p in PORT_DIR.rglob("*.py")}
    for edge in edges:
        for name in (edge["src"], edge["dst"]):
            # Each lock is made under its name in the module its name starts with.
            module = next(m for m in source if name.startswith(m + "."))
            assert f'make_lock("{name}")' in source[module], name


def test_trace_spans_export_and_merge(tmp_path):
    t_trace.configure(str(tmp_path), process_label="test")
    with t_trace.span("step", n=1):
        pass
    handle = t_trace.begin("serve_request", id=3)
    t_trace.end(handle)
    t_trace.instant("stall", component="x")
    t_trace.counter("serve.dispatch_qsize", 2)
    t_trace.export()
    merged = json.loads(Path(t_trace.merge_traces()).read_text())
    names = [e["name"] for e in merged["traceEvents"] if e["ph"] in ("X", "i", "C")]
    assert names == ["step", "serve_request", "stall", "serve.dispatch_qsize"]


def test_device_fields_never_initialise_the_card():
    assert t_events.device_memory_stats() == []
    assert t_events._device_header_fields() == {}
    assert not torch.cuda.is_initialized()


# ---- the command lines ----------------------------------------------------

TINY = ["--image-min-side", "64", "--image-max-side", "64", "--backbone", "resnet_test", "--f32",
        "--batch-size", "4", "--workers", "2"]


def synthetic(root: Path) -> list[str]:
    return ["synthetic", "--synthetic-root", str(root / "data"), "--synthetic-images", "8",
            "--synthetic-size", "64", *TINY, "--snapshot-path", str(root / "ckpt"),
            "--log-dir", str(root / "logs")]


def auto_resume_events(log_dir: Path) -> list[dict]:
    runs = t_events.split_runs(str(log_dir / "metrics.jsonl"))
    return [r for run in runs for r in run["records"] if r.get("event") == "auto_resume"]


def test_auto_resume_excludes_the_poison_batch_as_jax(tmp_path):
    """The port's CLI heals a NaN at batch 3; JAX's train.py trips on the
    same batch, and its own auto-resume plan, over its own dump, excludes
    the same image ids."""
    nan = ["--steps", "3", "--checkpoint-every", "1", "--log-every", "1", "--inject-nan-step", "3",
           "--warmup-steps", "0", "--numerics"]
    out = t_train.main(synthetic(tmp_path / "port") + nan + ["--device", "cpu", "--auto-resume"])
    assert out["final_step"] == 3.0
    (event,) = auto_resume_events(tmp_path / "port" / "logs")
    dump = json.loads((tmp_path / "port" / "logs" / "NUMERICS_DUMP.json").read_text())
    assert event["exclude_ids"] == sorted(dump["batch_image_ids"]) and len(event["exclude_ids"]) == 4
    assert dump["first_nonfinite"] == "['backbone']['stem_conv']['__call__'][0]"

    jax_argv = synthetic(tmp_path / "jax") + nan
    with pytest.raises(FloatingPointError) as info:
        j_train.main(jax_argv)
    plan = j_train._auto_resume_plan(j_train.parse_args(jax_argv + ["--auto-resume"]), 1, info.value)
    assert sorted(set(plan["exclude_ids"])) == event["exclude_ids"]
    assert plan["data_seed"] == event["data_seed"] and plan["restored_step"] == event["restored_step"]
    records = [r for run in t_events.split_runs(str(tmp_path / "port" / "logs" / "metrics.jsonl"))
               for r in t_events.metric_records(run)]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(r["train/nonfinite_grads"] == 0 for r in records)
    assert {"train/gnorm/backbone", "train/update_ratio"} <= set(records[-1])


def test_auto_resume_reads_only_the_dump_of_its_trip(tmp_path):
    """A dump left by another trip (an earlier run in the same directory,
    or a trip whose provenance pass failed) excludes nothing, with a
    warning; the dump the trip wrote gives its ids."""
    dump = {"step": 4, "tripped": {"metric": "loss", "value": float("nan")}, "batch_image_ids": [7, 3]}
    path = tmp_path / "NUMERICS_DUMP.json"
    path.write_text(json.dumps(dump))
    trip = t_loop.NonFiniteError("non-finite loss", 4, "loss", str(path))
    assert t_train._read_poison_ids(trip) == [7, 3]
    for stale in (t_loop.NonFiniteError("non-finite loss", 6, "loss", str(path)),
                  t_loop.NonFiniteError("non-finite loss", 4, "param_norm", str(path)),
                  t_loop.NonFiniteError("non-finite loss", 4, "loss", None)):
        with pytest.warns(UserWarning, match="excludes no images"):
            assert t_train._read_poison_ids(stale) == []


def test_train_obs_trace_writes_the_trace_and_the_event_log(tmp_path):
    obs_dir = tmp_path / "obs"
    flags = synthetic(tmp_path)[:-2]  # the obs dir is the log dir
    t_train.main(flags + ["--device", "cpu", "--steps", "2", "--checkpoint-every", "2",
                          "--eval-every", "2", "--log-every", "1", "--obs-trace", "--obs-dir", str(obs_dir),
                          "--slo-rule", "train_step_time_ms>1e9"])
    events = json.loads((obs_dir / "trace.json").read_text())["traceEvents"]
    spans = {e["name"] for e in events if e["ph"] == "X"}
    assert {"data_wait", "step", "metrics_fetch", "ckpt_snapshot", "ckpt_write", "final_eval",
            "pipe_decode_wait", "pipe_assemble", "device-prefetch", "detect_dispatch",
            "eval_convert"} <= spans
    (run,) = t_events.split_runs(str(obs_dir / "metrics.jsonl"))
    assert run["header"]["event"] == "run_header"
    assert [r["step"] for r in t_events.metric_records(run)][:2] == [1, 2]
    snapshot = t_telemetry.default().snapshot()
    assert snapshot["train_step"] == 2.0 and snapshot["ckpt_saves_total"] >= 1


def test_an_obs_port_that_cannot_bind_raises():
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        args = t_train.parse_args(["synthetic", "--obs-port", str(taken.getsockname()[1])])
        with pytest.raises(OSError):
            t_train._start_telemetry(args, None)


def test_serve_cli_answers_metrics_and_healthz(tmp_path):
    """``serve --http 0 --obs-port 0`` in a fresh process: both ports
    answer ``/metrics`` (the request counted) and ``/healthz`` (200), and
    SIGTERM still exits 0."""
    export_model(small_model(), str(tmp_path / "export"), ((64, 64),), 1, device="cpu",
                 image_min_side=64, image_max_side=64)
    proc = subprocess.Popen(
        [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve", "--export-dir",
         str(tmp_path / "export"), "--http", "0", "--obs-port", "0", "--device", "cpu"],
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        urls = {}
        for line in proc.stdout:
            for prefix in ("telemetry on ", "serving on "):
                if line.startswith(prefix):
                    urls[prefix] = line.split()[2]
            if len(urls) == 2:
                break
        assert len(urls) == 2, proc.stderr.read()
        image = np.random.default_rng(6).integers(0, 256, (48, 64, 3), dtype=np.uint8)
        post = urllib.request.Request(f"{urls['serving on ']}/detect", method="POST",
                                      data=image_io.encode_png(image))
        with urllib.request.urlopen(post, timeout=120) as r:
            assert r.status == 200
        for url in urls.values():
            with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
                assert r.status == 200 and json.load(r)["status"] == "ok"
            with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
                _, samples = t_telemetry.parse_exposition(r.read().decode())
            assert samples["serve_requests_completed_total"] == 1.0
            assert samples["serve_request_latency_ms_count"] == 1.0
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert json.loads(out.strip().splitlines()[-1])["serve_stats"]["completed"] == 1
