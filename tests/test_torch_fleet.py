"""The port's serve fleet (``serve/fleet.py``, ``serve/replica.py``,
``utils/backoff.py``, ``utils/arrivals.py``) against the JAX package's.

Everything runs on the routers' injectable clocks (``poll_once(now=...)``,
``canary_check_once(now=...)``), so nothing sleeps to make policy time
pass.  Every comparison is exact unless it says otherwise:

- ``BackoffPolicy.delays()`` and the arrival schedules are equal float for
  float;
- ``replica_weight`` is equal over a grid of load dicts;
- one script of health answers and request failures, played on each
  package's ``FleetRouter`` over stub replica handles that raise that
  package's errors, reaches the same breaker states, weights, re-dispatch
  choices, request outcomes, fleet counters and sink events (names and
  fields; the fleet latency quantiles, clocks, are left out);
- a slow stub canary (``StubDetectEngine(delay_s=...)`` behind a
  ``DetectionServer``) gets exactly one ``canary_rollback`` in both, and
  the fleet returns to its base weights;
- the fleet's HTTP frontend answers as the JAX one (status codes and JSON
  keys), the fleet command line parses as the JAX one plus ``--device``,
  and the fleet SLO rules are the JAX package's;
- the fleet command line over two of the port's ``--stub-engine`` serve
  processes: one SIGKILLed under load is re-dispatched with no failed
  request, its breaker opens, and the respawned replica is readmitted.
"""

import dataclasses
import inspect
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.obs import slo as j_slo
from batchai_retinanet_horovod_coco_tpu.obs import telemetry as j_telemetry
from batchai_retinanet_horovod_coco_tpu.obs import trace as j_trace
from batchai_retinanet_horovod_coco_tpu.obs import watchdog as j_watchdog
from batchai_retinanet_horovod_coco_tpu.serve import common as j_common
from batchai_retinanet_horovod_coco_tpu.serve import fleet as j_fleet
from batchai_retinanet_horovod_coco_tpu.serve import frontend as j_frontend
from batchai_retinanet_horovod_coco_tpu.serve import replica as j_replica
from batchai_retinanet_horovod_coco_tpu.serve import stub as j_stub
from batchai_retinanet_horovod_coco_tpu.utils import arrivals as j_arrivals
from batchai_retinanet_horovod_coco_tpu.utils import backoff as j_backoff
from batchai_retinanet_horovod_coco_tpu_torch.obs import slo as t_slo
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as t_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.serve import common as t_common
from batchai_retinanet_horovod_coco_tpu_torch.serve import fleet as t_fleet
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as t_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve import replica as t_replica
from batchai_retinanet_horovod_coco_tpu_torch.serve import stub as t_stub
from batchai_retinanet_horovod_coco_tpu_torch.utils import arrivals as t_arrivals
from batchai_retinanet_horovod_coco_tpu_torch.utils import backoff as t_backoff

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(name="jax", fleet=j_fleet, replica=j_replica, common=j_common,
                      backoff=j_backoff, stub=j_stub, frontend=j_frontend)
PORT = SimpleNamespace(name="torch", fleet=t_fleet, replica=t_replica, common=t_common,
                       backoff=t_backoff, stub=t_stub, frontend=t_frontend)


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


# ---- the pure schedules ----------------------------------------------------

POLICIES = {
    "geometric": dict(max_tries=8, base_s=0.5, multiplier=2.0, ceiling_s=10.0),
    "jitter": dict(max_tries=12, base_s=0.5, multiplier=2.0, ceiling_s=10.0, jitter=0.2, seed=7),
    "jitter crc seed": dict(max_tries=6, base_s=1.0, multiplier=2.0, ceiling_s=30.0, jitter=0.1,
                            seed=2_739_164_185),
    "flat": dict(max_tries=5, base_s=0.5, multiplier=1.0),
    "explicit schedule": dict(max_tries=6, schedule=(10.0, 30.0), jitter=0.25, seed=3),
    "long ceiling": dict(max_tries=1200, base_s=0.5, multiplier=2.0, ceiling_s=10.0, jitter=0.2,
                         seed=11),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_backoff_delays_equal_jax(name):
    """Exact: the same policy and seed give the same delays, float for
    float (the jitter is ``random.Random`` seeded as the JAX package
    seeds it)."""
    got = t_backoff.BackoffPolicy(**POLICIES[name])
    want = j_backoff.BackoffPolicy(**POLICIES[name])
    assert got.delays() == want.delays()
    sleeps: dict[str, list[float]] = {"t": [], "j": []}
    outcomes = iter(["down", "down", None])
    assert got.retry(lambda: next(outcomes), sleep=sleeps["t"].append)[0] == min(3, got.max_tries)
    outcomes = iter(["down", "down", None])
    assert want.retry(lambda: next(outcomes), sleep=sleeps["j"].append)[0] == min(3, want.max_tries)
    assert sleeps["t"] == sleeps["j"]
    env_t = t_backoff.BackoffPolicy.from_env_schedule(4, "10,30")
    env_j = j_backoff.BackoffPolicy.from_env_schedule(4, "10,30")
    assert dataclasses.asdict(env_t) == dataclasses.asdict(env_j)


SCHEDULES = [
    ("mixed_arrival_schedule", (200, 40.0), dict(seed=0)),
    ("mixed_arrival_schedule", (97, 12.5), dict(seed=5, phases=(1.0, 3.0))),
    ("diurnal_spike_schedule", (300, 20.0), dict(seed=1, period_s=10.0, amplitude=0.7)),
    ("multi_stream_schedule", (4, 25, 15.0), dict(seed=2)),
]


@pytest.mark.parametrize("fn,args,kwargs", SCHEDULES, ids=lambda v: str(v)[:40])
def test_arrival_schedules_equal_jax(fn, args, kwargs):
    """Exact: byte-identical schedules for the same seed."""
    got = getattr(t_arrivals, fn)(*args, **kwargs)
    want = getattr(j_arrivals, fn)(*args, **kwargs)
    assert json.dumps(got) == json.dumps(want)
    with pytest.raises(ValueError):
        t_arrivals.diurnal_spike_schedule(3, 1.0, amplitude=1.0)


def load_grid():
    """Load dicts over every field ``replica_weight`` reads, with edge
    values (missing fields, zero capacity, full queues, p99 against the
    reference on both sides)."""
    loads = [None, {}, {"accepting": False}, {"accepting": True}]
    for cap in (1, 4, 8, 128):
        for qsize in (0, 1, cap // 2, cap):
            for inflight in (0, 3, 2 * cap):
                for slots in (None, (0, 4), (3, 4), (4, 4), (9, 4), (2, 0)):
                    for p99 in (None, 0.0, 50.0, 100.0, 250.0):
                        load = {"accepting": True, "admission_capacity": cap,
                                "admission_qsize": qsize, "inflight": inflight, "p99_ms": p99}
                        if slots is not None:
                            load["free_slots"], load["slot_capacity"] = slots
                        loads.append(load)
    return loads


def test_replica_weight_equals_jax():
    """Exact over the grid, with and without a fleet reference p99."""
    for load in load_grid():
        for ref in (None, 0.0, 100.0, 180.0):
            assert t_fleet.replica_weight(load, ref) == j_fleet.replica_weight(load, ref), (load, ref)


@pytest.mark.parametrize("name,args", [
    ("fleet_availability_rule", ()), ("fleet_availability_rule", (0.5, "fleet_availability", 2.0)),
    ("fleet_occupancy_rule", ()), ("fleet_occupancy_rule", (0.9, "fleet_occupancy", 5.0)),
], ids=lambda v: str(v))
def test_fleet_slo_rules_equal_jax(name, args):
    """Exact: the fleet SLO rules are the JAX package's ``SloRule``s."""
    got, want = getattr(t_slo, name)(*args), getattr(j_slo, name)(*args)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---- the router on a script ------------------------------------------------

#: No-jitter breaker backoff: probe times are exact.
EXACT = dict(max_tries=1_000_000, base_s=1.0, multiplier=2.0, ceiling_s=8.0, jitter=0.0)


class ScriptedReplica:
    """A replica handle with scriptable health, load and request outcomes;
    failures raise the errors of the package ``pkg``."""

    def __init__(self, pkg, replica_id: str, capacity: int = 8, inflight: int = 0, qsize: int = 0,
                 p99_ms: float | None = 100.0, version: str = "v1"):
        self.pkg = pkg
        self.replica_id = replica_id
        self.version = version
        self.capacity, self.inflight, self.qsize, self.p99_ms = capacity, inflight, qsize, p99_ms
        self.accepting = True
        self.shed_total = 0
        self.healthy = True
        self.failure: str | None = None
        self.calls = 0
        self.drained = False

    def load(self) -> dict:
        return {"replica_id": self.replica_id, "version": self.version, "inflight": self.inflight,
                "admission_qsize": self.qsize, "admission_capacity": self.capacity,
                "p99_ms": self.p99_ms, "shed_total": self.shed_total, "accepting": self.accepting,
                "free_slots": 2, "slot_capacity": 4}

    def healthz(self):
        if not self.healthy:
            return 0, {"status": "unreachable"}
        return 200, {"status": "ok", "load": self.load()}

    def detect(self, payload, timeout_s=None, trace_id=None):
        self.calls += 1
        errors = {
            "dead": lambda: self.pkg.replica.ReplicaUnavailable(f"{self.replica_id} is dead"),
            "shed": lambda: self.pkg.common.RequestRejected("admission_queue_full"),
            "decode": lambda: self.pkg.common.RequestRejected("decode_error", "bad bytes"),
            "timeout": lambda: self.pkg.common.RequestTimeout("slow"),
        }
        if self.failure is not None:
            raise errors[self.failure]()
        return [{"category_id": 0, "bbox": [1.0, 2.0, 3.0, 4.0], "score": 0.5,
                 "served_by": self.replica_id}]

    def drain(self, timeout_s=5.0):
        self.drained = True
        self.accepting = False

    def close(self):
        self.accepting = False


class SinkSpy:
    def __init__(self):
        self.events: list[tuple[str, dict]] = []

    def event(self, kind: str, **fields):
        self.events.append((kind, fields))


#: Scripts of (op, *args): "health" rid ok, "fail" rid kind|None, "load"
#: rid field value, "poll" now, "detect" n, "status", "join" rid, "drain"
#: rid, "remove" rid, "close".
SCRIPTS = {
    "breaker open, half-open, readmit": [
        ("status",), ("health", "a", False), ("poll", 100.0), ("status",), ("poll", 100.5),
        ("poll", 101.0), ("status",), ("poll", 102.5), ("health", "a", True), ("poll", 103.1),
        ("status",), ("detect", 6), ("status",),
    ],
    "dead replica re-dispatched once": [
        ("fail", "b", "dead"), ("detect", 8), ("status",), ("poll", 50.0), ("poll", 51.0),
        ("fail", "b", None), ("poll", 51.5), ("status",), ("detect", 4),
    ],
    "every replica dead: the re-dispatch limit": [
        ("fail", "a", "dead"), ("fail", "b", "dead"), ("fail", "c", "dead"), ("detect", 3),
        ("status",),
    ],
    "consecutive sheds trip the breaker": [
        ("fail", "a", "shed"), ("fail", "b", "shed"), ("detect", 4), ("status",),
        ("fail", "b", None), ("detect", 4), ("status",),
    ],
    "decode errors and timeouts are outcomes": [
        ("fail", "a", "decode"), ("detect", 3), ("fail", "a", "timeout"), ("detect", 3),
        ("status",),
    ],
    "all breakers open sheds": [
        ("health", "a", False), ("health", "b", False), ("health", "c", False), ("poll", 10.0),
        ("detect", 2), ("status",),
    ],
    "loads steer the weights": [
        ("load", "a", "inflight", 6), ("load", "b", "qsize", 4), ("load", "c", "p99_ms", 300.0),
        ("poll", 1.0), ("status",), ("detect", 12), ("load", "a", "accepting", False),
        ("poll", 2.0), ("status",), ("detect", 6),
    ],
    "jittered probes": [
        ("jitter",), ("health", "b", False), ("poll", 0.0), ("status",), ("poll", 0.4),
        ("poll", 0.7), ("poll", 2.0), ("status",), ("poll", 4.0), ("poll", 9.0), ("status",),
    ],
    "membership: join, drain, remove": [
        ("join", "d"), ("status",), ("poll", 1.0), ("status",), ("drain", "a"), ("status",),
        ("detect", 6), ("remove", "a"), ("remove", "a"), ("status",), ("close",), ("detect", 1),
    ],
}


def play(pkg, script) -> dict:
    """Play ``script`` on ``pkg``'s router over three scripted replicas;
    returns what a client and an operator can observe."""
    replicas = {rid: ScriptedReplica(pkg, rid) for rid in ("a", "b", "c")}
    sink = SinkSpy()
    backoff = dict(EXACT)
    if script and script[0] == ("jitter",):
        backoff.update(jitter=0.2, ceiling_s=10.0, base_s=0.5)
        script = script[1:]
    config = pkg.fleet.FleetConfig(probe_backoff=pkg.backoff.BackoffPolicy(**backoff),
                                   poll_interval_s=0.05, seed=3)
    router = pkg.fleet.FleetRouter(list(replicas.values()), config, sink=sink, auto_poll=False)
    seen: list = []
    try:
        for op, *args in script:
            if op == "health":
                replicas[args[0]].healthy = args[1]
            elif op == "fail":
                replicas[args[0]].failure = args[1]
            elif op == "load":
                setattr(replicas[args[0]], args[1], args[2])
            elif op == "poll":
                router.poll_once(now=args[0])
            elif op == "detect":
                for _ in range(args[0]):
                    try:
                        seen.append(("ok", router.detect(b"payload")[0]["served_by"]))
                    except Exception as exc:  # the serve taxonomy, by name and reason
                        seen.append(("error", type(exc).__name__, getattr(exc, "reason", None)))
            elif op == "status":
                status = router.status()
                seen.append([(r["replica_id"], r["state"], r["weight"], r["is_canary"])
                             for r in status["replicas"]])
                seen.append({k: status[k] for k in ("accepting", "inflight", "redispatches",
                                                    "breaker_opens", "canary_rollbacks")})
            elif op == "join":
                replicas[args[0]] = ScriptedReplica(pkg, args[0])
                router.add_replica(replicas[args[0]])
            elif op == "drain":
                seen.append(router.begin_drain(args[0]))
            elif op == "remove":
                seen.append(router.remove_replica(args[0]))
            elif op == "close":
                router.close()
        stats = router.stats.snapshot()
        snap = router.telemetry.snapshot()
    finally:
        router.close()
    return {
        "seen": seen,
        "calls": {rid: r.calls for rid, r in replicas.items()},
        "events": [(kind, {k: v for k, v in fields.items() if k != "trace"})
                   for kind, fields in sink.events],
        "stats": {k: stats[k] for k in ("completed", "timeouts", "failed", "shed", "shed_total")},
        "telemetry": {k: v for k, v in snap.items()
                      if k.startswith("fleet_") and not k.startswith("fleet_request_latency_ms")},
    }


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_router_script_reaches_the_jax_states(name):
    """Exact: breaker states, weights (to the 6 decimals both round to),
    which replica served each request, each failure's error class and
    reason, the re-dispatch and breaker counters, the fleet series and the
    sink events equal the JAX router's on the same script."""
    got, want = play(PORT, SCRIPTS[name]), play(JAX, SCRIPTS[name])
    assert got == want
    assert want["seen"]


def canary_run(pkg, delay_s: float = 0.15) -> dict:
    """Two stub replicas and a stub canary slowed by ``delay_s`` a
    dispatch, each behind a ``DetectionServer``; each serves a few
    requests, then the gate is checked on the injectable clock."""
    def server(rid, version, delay):
        engine = pkg.stub.StubDetectEngine(batch_sizes=(1,), delay_s=delay, version=version)
        cfg = pkg.common.ServeConfig(max_delay_ms=1, preprocess_workers=1)
        return pkg.frontend.DetectionServer(engine, cfg, replica_id=rid)

    sink = SinkSpy()
    base = [pkg.replica.LocalReplica(server(f"base-{i}", "v1", 0.0)) for i in range(2)]
    canary = pkg.replica.LocalReplica(server("canary", "v2", delay_s))
    config = pkg.fleet.FleetConfig(canary_for_s=2.0, canary_p99_factor=1.5, canary_weight=0.25,
                                   probe_backoff=pkg.backoff.BackoffPolicy(**EXACT))
    router = pkg.fleet.FleetRouter(base, config, sink=sink, auto_poll=False)
    img = np.full((64, 64, 3), 40, np.uint8)
    out: dict = {}
    try:
        router.add_canary(canary)
        for rep in (*base, canary):
            for _ in range(4):
                assert rep.detect(img, timeout_s=30) == t_stub.EXPECTED_DETECTIONS
        router.poll_once(now=0.0)
        weights = {r["replica_id"]: r["weight"] for r in router.status()["replicas"]}
        out["canary_fraction"] = weights["canary"] > 0 and weights["canary"] < weights["base-0"]
        fired = [[v["rule"] for v in router.canary_check_once(now=t)] for t in (0.0, 1.0, 2.5)]
        for t in (3.0, 10.0):
            router.poll_once(now=t)
            fired.append([v["rule"] for v in router.canary_check_once(now=t)])
        out["fired"] = fired
        status = router.status()
        out["states"] = [(r["replica_id"], r["state"], r["weight"] > 0) for r in status["replicas"]]
        out["outcome"] = (status["canary_rollbacks"], status["canary_outcome"])
        out["events"] = [kind for kind, _ in sink.events]
        rollback = [fields for kind, fields in sink.events if kind == "canary_rollback"]
        out["rollback"] = [(f["replica_id"], f["version"], f["rule"], f["threshold"]) for f in rollback]
        out["shutting_down"] = type(pytest.raises(Exception, canary.detect, img).value).__name__
    finally:
        router.close(close_replicas=True)
    return out


def test_slow_stub_canary_rolls_back_once_as_jax():
    """One ``canary_rollback`` in both packages, at the same check, with
    the same rule; the canary drained, the base replicas keep their
    weight; nothing fires again while the breach lasts."""
    got, want = canary_run(PORT), canary_run(JAX)
    assert got == want
    assert want["fired"] == [[], [], ["canary-p99-regression"], [], []]
    assert want["outcome"] == (1, "rolled_back")
    assert want["events"].count("canary_rollback") == 1
    assert ("canary", "drained", False) in want["states"]


def test_http_replica_taxonomy_as_jax():
    """A refused connection is ``ReplicaUnavailable`` and a health code of
    0; a socket that accepts and never answers is a ``RequestTimeout``
    (a request outcome, never a breaker hit)."""
    import socket

    for pkg in (PORT, JAX):
        with socket.socket() as s:  # a port nobody listens on
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        rep = pkg.replica.HttpReplica(f"http://127.0.0.1:{port}", timeout_s=0.5)
        with pytest.raises(pkg.replica.ReplicaUnavailable):
            rep.detect(b"payload", timeout_s=0.5)
        code, payload = rep.healthz()
        assert code == 0 and payload["status"] == "unreachable"
        with socket.socket() as listener:
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            host, port = listener.getsockname()
            rep = pkg.replica.HttpReplica(f"http://{host}:{port}", timeout_s=0.3)
            with pytest.raises(pkg.common.RequestTimeout):
                rep.detect(b"payload", timeout_s=0.3)


def http_answers(pkg) -> dict:
    """Status codes and JSON keys of the fleet frontend over scripted
    replicas: a served request, a shed one, health with one replica open
    and with none, /fleet, /metrics' families and a 404."""
    replicas = [ScriptedReplica(pkg, rid) for rid in ("a", "b")]
    config = pkg.fleet.FleetConfig(probe_backoff=pkg.backoff.BackoffPolicy(**EXACT), seed=1)
    router = pkg.fleet.FleetRouter(replicas, config, auto_poll=False)
    httpd = pkg.fleet.serve_fleet_http(router, "127.0.0.1", 0)
    # watchdog: serve_forever returns at httpd.shutdown() in the finally below.
    threading.Thread(target=httpd.serve_forever, daemon=True, name="test-fleet-http").start()
    url = "http://%s:%d" % httpd.server_address[:2]

    def call(path, body=None, headers=None):
        req = urllib.request.Request(url + path, data=body, headers=headers or {},
                                     method="POST" if body is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code, raw, hdr = r.status, r.read(), r.headers
        except urllib.error.HTTPError as e:
            code, raw, hdr = e.code, e.read(), e.headers
        if hdr.get("Content-Type", "").startswith("application/json"):
            data = json.loads(raw)
            return code, sorted(data), data.get("reason"), hdr.get("X-Retinanet-Trace")
        families = {line.split()[2] for line in raw.decode().splitlines() if line.startswith("# TYPE")}
        return code, sorted(families)

    out = {}
    try:
        out["ok"] = call("/detect", b"img", {"X-Retinanet-Trace": "t-1"})
        for r in replicas:
            r.failure = "shed"
        out["shed"] = call("/detect", b"img", {"X-Retinanet-Trace": "t-2"})
        replicas[0].healthy = False
        router.poll_once(now=1.0)
        out["healthz one open"] = call("/healthz")
        out["fleet"] = call("/fleet")
        out["statusz"] = call("/statusz")
        out["metrics"] = call("/metrics")
        replicas[1].healthy = False
        router.poll_once(now=2.0)
        out["healthz none"] = call("/healthz")
        out["no replica"] = call("/detect", b"img", {"X-Retinanet-Trace": "t-3"})
        out["unknown stream"] = call("/stream/frame", b"img", {"X-Retinanet-Stream": "nope",
                                                                "X-Retinanet-Frame": "0",
                                                                "X-Retinanet-Trace": "t-4"})
        out["404"] = call("/nowhere")
    finally:
        httpd.shutdown()
        httpd.server_close()
        router.close()
    return out


def test_fleet_http_answers_as_jax():
    got, want = http_answers(PORT), http_answers(JAX)
    assert got == want
    assert want["ok"] == (200, ["detections", "trace_id"], None, "t-1")
    assert want["shed"] == (503, ["error", "reason", "trace_id"], "admission_queue_full", "t-2")
    assert want["healthz none"][0] == 503 and want["no replica"][2] == "no_replica_available"


def test_fleet_flags_are_the_jax_command_line_s():
    """Every flag and default of the JAX fleet command line, plus
    ``--device`` (default ``cuda``) and ``--replica-start-timeout-s``,
    whose default is the JAX spawn's fixed wait for /healthz."""
    want = {a.dest: a.default for a in j_fleet.build_parser()._actions}
    got = {a.dest: a.default for a in t_fleet.build_parser()._actions}
    assert set(got) == set(want) | {"device", "replica_start_timeout_s"}
    assert all(got[k] == want[k] for k in want)
    assert got["device"] == "cuda"
    jax_wait = inspect.signature(j_replica.spawn_http_replica).parameters["wait_policy"].default
    assert got["replica_start_timeout_s"] == jax_wait.max_tries * jax_wait.base_s == 60.0


def test_replica_start_timeout_bounds_every_spawn(tmp_path):
    """``--replica-start-timeout-s`` is the spawn's wait for /healthz: a
    stub replica, which imports torch before it listens, misses a wait of
    0.5 s and the fleet refuses to start, naming it; 0 is refused."""
    with pytest.raises(SystemExit, match="must be > 0"):
        t_fleet.main(["--http", "0", "--spawn", "1", "--stub-engine",
                      "--replica-start-timeout-s", "0"])
    proc = subprocess.run(
        [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve.fleet", "--http", "0",
         "--spawn", "1", "--stub-engine", "--replica-start-timeout-s", "0.5"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "spawned replica replica-0 never became healthy: healthz 0" in proc.stderr, proc.stderr[-2000:]


def test_fleet_cli_with_an_export_raises_without_a_card():
    """``--device cuda`` (the default) raises before any replica starts
    when the replicas would serve an export; nothing falls back to the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_fleet.main(["--http", "0", "--spawn", "1", "--export-dir", "nowhere"])
    with pytest.raises(SystemExit, match="--export-dir or --stub-engine"):
        t_fleet.main(["--http", "0", "--spawn", "1"])


# ---- the command line over subprocess stub replicas -----------------------

FLEET_CMD = [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve.fleet",
             "--http", "0", "--spawn", "2", "--stub-engine", "--stub-delay-ms", "20",
             "--obs-port", "0", "--slo-poll-s", "0.2", "--poll-interval", "0.2",
             "--respawn-delay-s", "0.2"]


def post(url: str, body: bytes) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def test_fleet_cli_redispatches_a_killed_stub_replica(tmp_path):
    """``python -m ...serve.fleet --spawn 2 --stub-engine``: a replica
    SIGKILLed under load loses no request (its in-flight and next requests
    are re-dispatched at most once), its breaker opens, the supervisor
    respawns it on its pinned port and the half-open probe readmits it;
    the fleet's /metrics counts one fleet-availability violation; SIGTERM
    stops the fleet and its replicas, exit 0."""
    image = (REPO_ROOT / "tests" / "fixtures" / "jpeg" / "coco_0.jpg").read_bytes()
    stderr = open(tmp_path / "fleet.err", "w+")
    proc = subprocess.Popen(FLEET_CMD, cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=stderr,
                            text=True)
    pids, ports, url, obs = {}, {}, None, None
    try:
        for line in proc.stdout:
            if line.startswith("{"):
                ev = json.loads(line)
                if ev["event"] == "fleet_replica_spawned":
                    pids[ev["replica_id"]] = ev["pid"]
                    ports[ev["replica_id"]] = ev["port"]
            elif line.startswith("fleet telemetry on"):
                obs = line.split()[3]
            elif line.startswith("fleet serving on"):
                url = line.split()[3]
                break
        assert url and obs and sorted(pids) == ["replica-0", "replica-1"], (pids, url)
        codes: list[int] = []
        lock = threading.Lock()

        def client(n):
            for _ in range(n):
                code, body = post(url + "/detect", image)
                with lock:
                    codes.append(code)

        load = [threading.Thread(target=client, args=(15,)) for _ in range(4)]
        for t in load:
            t.start()
        # Kill replica-0 while it holds a request, so the kill tests the
        # re-dispatch whatever share of the load the router gave it.
        deadline = time.time() + 20
        while json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{ports['replica-0']}/healthz", timeout=10).read())["load"]["inflight"] < 1:
            assert time.time() < deadline and any(t.is_alive() for t in load), "replica-0 held no request"
            time.sleep(0.01)
        os.kill(pids["replica-0"], signal.SIGKILL)
        for t in load:
            t.join(60)
        assert codes == [200] * 60
        deadline = time.time() + 40
        while time.time() < deadline:
            fleet = json.loads(urllib.request.urlopen(url + "/fleet", timeout=10).read())
            r0 = next(r for r in fleet["replicas"] if r["replica_id"] == "replica-0")
            if r0["state"] == "closed" and r0["weight"] > 0 and fleet["breaker_opens"] >= 1:
                break
            time.sleep(0.2)
        assert r0["state"] == "closed" and r0["weight"] > 0, fleet
        assert fleet["redispatches"] >= 1, fleet
        assert post(url + "/detect", image)[0] == 200
        metrics = urllib.request.urlopen(obs + "/metrics", timeout=10).read().decode()
        violations = [line for line in metrics.splitlines()
                      if line.startswith('slo_violations_total{rule="fleet-availability"}')]
        assert violations and float(violations[0].split()[-1]) == 1.0, violations
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    events = [json.loads(line) for line in out.splitlines() if line.startswith('{"event"')]
    respawned = [e for e in events if e["event"] == "fleet_replica_respawned"]
    assert [e["replica_id"] for e in respawned] == ["replica-0"]
    pids["respawned"] = respawned[0]["pid"]
    assert json.loads(out.strip().splitlines()[-1])["fleet_stats"]["failed"] == 0
    stderr.seek(0)
    router_events = [json.loads(line) for line in stderr if line.startswith('{"event"')]
    first_opens = [e for e in router_events if e["event"] == "fleet_breaker_open"
                   and e["replica_id"] == "replica-0" and e["reason"] != "half_open_probe_failed"]
    assert len(first_opens) == 1, router_events
    assert any(e["event"] == "fleet_breaker_close" for e in router_events)
    for pid in pids.values():  # every replica is gone
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
