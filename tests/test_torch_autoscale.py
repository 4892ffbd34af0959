"""The port's autoscaler (``serve/autoscale.py``), the respawn budget
(``serve/replica.py::RespawnBudget``) and the fleet command line's
``--autoscale`` against the JAX package's.

The control loop runs on its injectable clock (``check_once(now=...)``)
over routers polled on theirs, so nothing sleeps to make policy time
pass.  Every comparison is exact:

- ``AutoscalePolicy``: the same fields and defaults, the same bounds
  refused, the same policy file read and the same unknown key refused;
- the same policy and the same script of replica occupancy, p99, traffic,
  reaps, abandoned slots and refused launches give the same decision list
  (every field: decision, reason, delta, victims, the signals it acted
  on), the same sink events, fleet membership and autoscale series;
- ``LocalLauncher`` over stub servers drains a busy victim with no lost
  request, as in the JAX package;
- ``RespawnBudget`` reaches the same verdicts and respawn times on the
  same deaths;
- the fleet command line with ``--autoscale`` over the port's stub
  replicas goes 1 → 2 → 1 under a burst and idle time, with no failed
  request.
"""

import dataclasses
import json
import re
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

from batchai_retinanet_horovod_coco_tpu.obs import telemetry as j_telemetry
from batchai_retinanet_horovod_coco_tpu.obs import trace as j_trace
from batchai_retinanet_horovod_coco_tpu.obs import watchdog as j_watchdog
from batchai_retinanet_horovod_coco_tpu.serve import autoscale as j_autoscale
from batchai_retinanet_horovod_coco_tpu.serve import common as j_common
from batchai_retinanet_horovod_coco_tpu.serve import fleet as j_fleet
from batchai_retinanet_horovod_coco_tpu.serve import frontend as j_frontend
from batchai_retinanet_horovod_coco_tpu.serve import replica as j_replica
from batchai_retinanet_horovod_coco_tpu.serve import stub as j_stub
from batchai_retinanet_horovod_coco_tpu.utils import backoff as j_backoff
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog as t_watchdog
from batchai_retinanet_horovod_coco_tpu_torch.serve import autoscale as t_autoscale
from batchai_retinanet_horovod_coco_tpu_torch.serve import common as t_common
from batchai_retinanet_horovod_coco_tpu_torch.serve import fleet as t_fleet
from batchai_retinanet_horovod_coco_tpu_torch.serve import frontend as t_frontend
from batchai_retinanet_horovod_coco_tpu_torch.serve import replica as t_replica
from batchai_retinanet_horovod_coco_tpu_torch.serve import stub as t_stub
from batchai_retinanet_horovod_coco_tpu_torch.utils import backoff as t_backoff

REPO_ROOT = Path(__file__).resolve().parents[1]
JAX = SimpleNamespace(autoscale=j_autoscale, common=j_common, fleet=j_fleet,
                      frontend=j_frontend, replica=j_replica, stub=j_stub, backoff=j_backoff)
PORT = SimpleNamespace(autoscale=t_autoscale, common=t_common, fleet=t_fleet,
                       frontend=t_frontend, replica=t_replica, stub=t_stub, backoff=t_backoff)
EXACT = dict(max_tries=1_000_000, base_s=1.0, multiplier=2.0, ceiling_s=8.0, jitter=0.0)


def live_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(("serve", "fleet"))]


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test starts and ends with both packages' obs layers off, and
    leaves no serve or fleet thread behind."""
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    yield
    for mod in (t_trace, j_trace, t_telemetry, j_telemetry):
        mod.reset()
    for wd in (t_watchdog, j_watchdog):
        wd.stop()
        wd.default().sink = None
    deadline = time.time() + 10
    while live_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not live_threads()


# ---- the policy ------------------------------------------------------------


def test_policy_fields_and_file_are_the_jax_s(tmp_path):
    t_fields = [(f.name, f.default) for f in dataclasses.fields(t_autoscale.AutoscalePolicy)]
    j_fields = [(f.name, f.default) for f in dataclasses.fields(j_autoscale.AutoscalePolicy)]
    assert t_fields == j_fields
    doc = {"min_replicas": 0, "max_replicas": 5, "occupancy_low": 0.1, "occupancy_high": 0.6,
           "p99_slo_ms": 250.0, "for_s": 2.0, "interval_s": 0.5}
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(doc))
    assert (dataclasses.asdict(t_autoscale.AutoscalePolicy.from_file(str(path)))
            == dataclasses.asdict(j_autoscale.AutoscalePolicy.from_file(str(path))))
    path.write_text(json.dumps({**doc, "max_replica": 3}))
    for mod in (t_autoscale, j_autoscale):
        with pytest.raises(ValueError, match=r"unknown autoscale policy keys \['max_replica'\]"):
            mod.AutoscalePolicy.from_file(str(path))


@pytest.mark.parametrize("bad", [
    dict(min_replicas=-1), dict(min_replicas=3, max_replicas=2), dict(max_replicas=0),
    dict(occupancy_low=0.8, occupancy_high=0.5), dict(occupancy_high=1.5),
    dict(scale_up_step=0), dict(down_cooldown_s=-1.0),
], ids=lambda d: ",".join(d))
def test_policy_bounds_refused_as_jax(bad):
    messages = []
    for mod in (t_autoscale, j_autoscale):
        with pytest.raises(ValueError) as info:
            mod.AutoscalePolicy(**bad)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


# ---- the control loop on a script ------------------------------------------


class ScalableReplica:
    """A replica handle advertising the slot fields the occupancy
    aggregate reads, with scriptable occupancy and p99."""

    def __init__(self, replica_id: str, capacity: int = 8):
        self.replica_id = replica_id
        self.version = "v1"
        self.capacity = capacity
        self.p99_ms = 100.0
        self.inflight = 0
        self.accepting = True
        self.drained = False

    def load(self) -> dict:
        return {"replica_id": self.replica_id, "version": self.version,
                "inflight": self.inflight, "admission_qsize": 0,
                "admission_capacity": self.capacity, "slot_capacity": self.capacity,
                "free_slots": self.capacity - min(self.inflight, self.capacity),
                "p99_ms": self.p99_ms, "shed_total": 0, "accepting": self.accepting}

    def healthz(self):
        return 200, {"status": "ok", "load": self.load()}

    def detect(self, payload, timeout_s=None, trace_id=None):
        return [{"served_by": self.replica_id}]

    def drain(self, timeout_s=5.0):
        self.drained = True
        self.accepting = False

    def close(self):
        self.accepting = False


class ScriptedLauncher:
    """Launches ``ScalableReplica``s, owns what it launched or adopted,
    reaps what the script says is gone, reports abandoned slots, refuses
    a scripted number of launches."""

    def __init__(self):
        self.replicas: dict[str, ScalableReplica] = {}
        self.terminated: list[str] = []
        self.gone: set[str] = set()
        self.abandoned: list[str] = []
        self.refuse = 0
        self._owned: set[str] = set()
        self._seq = 0

    def launch(self):
        if self.refuse:
            self.refuse -= 1
            raise RuntimeError("spawn refused (scripted)")
        rid = f"scale-{self._seq}"
        self._seq += 1
        self.replicas[rid] = ScalableReplica(rid)
        self._owned.add(rid)
        return self.replicas[rid]

    def adopt(self, replica) -> None:
        self._owned.add(replica.replica_id)

    def owns(self, rid: str) -> bool:
        return rid in self._owned

    def terminate(self, rid: str) -> None:
        self.terminated.append(rid)

    def reap(self, rid: str) -> bool:
        if rid in self.gone:
            self._owned.discard(rid)
            return True
        return False

    def prune(self) -> list[str]:
        out, self.abandoned = self.abandoned, []
        return out


class SinkSpy:
    def __init__(self):
        self.events: list[tuple[str, dict]] = []

    def event(self, kind: str, **fields):
        self.events.append((kind, fields))


BAND = dict(min_replicas=1, max_replicas=3, occupancy_low=0.25, occupancy_high=0.75, for_s=5.0,
            up_cooldown_s=10.0, down_cooldown_s=10.0)

#: (policy, seed replicas, ticks); a tick is (now, {op: arg}) with ops
#: "occ" {rid: fraction}, "p99" {rid: ms}, "detect" n, "gone" [rids],
#: "abandon" [rids], "refuse" n, "tick" False (check without a poll).
SCENARIOS = {
    "sustained breach: one decision per cooldown window": (
        BAND, ["r0"],
        [(float(t), {"occ": {"*": 1.0}}) for t in range(0, 26)],
    ),
    "oscillation inside the band: nothing": (
        BAND, ["r0", "r1"],
        [(float(t), {"occ": {"*": 0.3 + 0.4 * (t % 2)}}) for t in range(0, 30)],
    ),
    "breach shorter than for_s: nothing": (
        BAND, ["r0"],
        [(float(t), {"occ": {"*": 1.0 if t % 6 < 4 else 0.5}}) for t in range(0, 24)],
    ),
    "p99 breach inside the band": (
        dict(BAND, p99_slo_ms=150.0), ["r0"],
        [(float(t), {"occ": {"*": 0.5}, "p99": {"*": 400.0}}) for t in range(0, 8)],
    ),
    "capped at max_replicas": (
        dict(BAND, max_replicas=2), ["r0", "r1"],
        [(float(t), {"occ": {"*": 1.0}}) for t in range(0, 18)],
    ),
    "scale down the lowest weight, drain, reap": (
        BAND, ["r0", "r1", "r2"],
        [(0.0, {"occ": {"r0": 0.125, "r1": 0.0, "r2": 0.0}})]
        + [(float(t), {"detect": 2}) for t in range(1, 7)]
        + [(7.0, {"gone": ["r1"]}), (8.0, {}), (20.0, {"detect": 1}), (21.0, {"gone": ["r2"]}),
           (22.0, {})],
    ),
    "scale to zero, then demand": (
        dict(min_replicas=0, max_replicas=2, for_s=2.0, up_cooldown_s=5.0, down_cooldown_s=5.0),
        ["r0"],
        [(0.0, {}), (1.0, {}), (2.0, {}), (3.0, {"gone": ["r0"]}), (3.5, {"detect": 1}),
         (4.0, {"tick": False}), (5.0, {}), (6.0, {"detect": 2})],
    ),
    "a trickle keeps the last replica": (
        dict(min_replicas=0, max_replicas=2, for_s=1.0, up_cooldown_s=1.0, down_cooldown_s=1.0),
        ["r0"],
        [(float(t), {"detect": 1}) for t in range(0, 8)],
    ),
    "abandoned slot under min: repaired at once": (
        dict(BAND, min_replicas=2), ["r0", "r1"],
        [(0.0, {"occ": {"*": 0.5}}), (1.0, {"abandon": ["r1"], "tick": False}), (2.0, {})],
    ),
    "refused launch is counted, not fatal": (
        dict(BAND, for_s=0.0, up_cooldown_s=0.0), ["r0"],
        [(0.0, {"occ": {"*": 1.0}, "refuse": 1}), (1.0, {"occ": {"*": 1.0}}),
         (2.0, {"occ": {"*": 0.5}})],
    ),
}


def play(pkg, policy: dict, seeds: list[str], ticks) -> dict:
    launcher = ScriptedLauncher()
    replicas = [ScalableReplica(rid) for rid in seeds]
    for r in replicas:
        launcher.replicas[r.replica_id] = r
        launcher.adopt(r)
    sink = SinkSpy()
    router = pkg.fleet.FleetRouter(
        replicas, pkg.fleet.FleetConfig(probe_backoff=pkg.backoff.BackoffPolicy(**EXACT),
                                        poll_interval_s=0.05, seed=2),
        sink=sink, auto_poll=False,
    )
    scaler = pkg.autoscale.Autoscaler(router, pkg.autoscale.AutoscalePolicy(**policy), launcher,
                                      sink=sink)
    trail: list = []
    try:
        for now, ops in ticks:
            for rid, frac in ops.get("occ", {}).items():
                for r in launcher.replicas.values():
                    if rid in ("*", r.replica_id):
                        r.inflight = round(frac * r.capacity)
            for rid, ms in ops.get("p99", {}).items():
                for r in launcher.replicas.values():
                    if rid in ("*", r.replica_id):
                        r.p99_ms = ms
            launcher.gone.update(ops.get("gone", ()))
            launcher.abandoned += ops.get("abandon", [])
            launcher.refuse += ops.get("refuse", 0)
            for _ in range(ops.get("detect", 0)):
                try:
                    trail.append(router.detect(b"payload")[0]["served_by"])
                except pkg.common.RequestRejected as exc:
                    trail.append(exc.reason)
            if ops.get("tick", True):
                router.poll_once(now=now)
            trail.append(scaler.check_once(now=now))
            trail.append(sorted((r["replica_id"], r["state"], r["weight"])
                                for r in router.status()["replicas"]))
        status = scaler.status()
        snap = router.federated_snapshot()
    finally:
        scaler.stop()
        router.close()
    return {
        "trail": trail,
        "decisions": scaler.decisions,
        "terminated": launcher.terminated,
        "events": sink.events,
        "status": {k: v for k, v in status.items() if k != "policy"},
        "series": {k: v for k, v in snap.items() if k.startswith(("fleet_scale", "fleet_replicas",
                                                                   "fleet_autoscale"))},
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_jax(name):
    got, want = play(PORT, *SCENARIOS[name]), play(JAX, *SCENARIOS[name])
    assert got == want
    decided = [d["decision"] for d in want["decisions"]]
    expect = {
        "sustained breach: one decision per cooldown window": ["scale_up", "scale_up",
                                                                "scale_up_capped"],
        "oscillation inside the band: nothing": [],
        "breach shorter than for_s: nothing": [],
        "p99 breach inside the band": ["scale_up"],
        "capped at max_replicas": ["scale_up_capped", "scale_up_capped"],
        "scale down the lowest weight, drain, reap": ["scale_down", "scale_down"],
        "scale to zero, then demand": ["scale_down", "scale_up"],
        "a trickle keeps the last replica": [],
        "abandoned slot under min: repaired at once": ["scale_up"],
        "refused launch is counted, not fatal": ["scale_up", "scale_up"],
    }[name]
    assert decided == expect


def test_local_launcher_drains_a_busy_victim_as_jax():
    """In-process stub servers: the busy replica is the victim (lowest
    weight), its in-flight requests all complete, new traffic lands on the
    survivor, and the victim is reaped and removed."""
    def run(pkg):
        def server(rid, delay):
            return pkg.frontend.DetectionServer(
                pkg.stub.StubDetectEngine(video=True, delay_s=delay),
                pkg.common.ServeConfig(max_delay_ms=5, preprocess_workers=1), replica_id=rid)

        replicas = [pkg.replica.LocalReplica(server(f"r{k}", 0.15)) for k in range(2)]
        router = pkg.fleet.FleetRouter(
            replicas, pkg.fleet.FleetConfig(probe_backoff=pkg.backoff.BackoffPolicy(**EXACT)),
            auto_poll=False)
        launcher = pkg.autoscale.LocalLauncher(
            lambda rid: pkg.replica.LocalReplica(server(rid, 0.0)))
        for r in replicas:
            launcher.adopt(r)
        scaler = pkg.autoscale.Autoscaler(router, pkg.autoscale.AutoscalePolicy(
            min_replicas=1, max_replicas=2, occupancy_low=0.6, occupancy_high=0.9, for_s=0.0,
            up_cooldown_s=0.0, down_cooldown_s=0.0), launcher)
        img = np.full((64, 64, 3), 7, np.uint8)
        results, errors = [], []

        def call():
            try:
                results.append(replicas[0].detect(img, timeout_s=30))
            except Exception as exc:  # any drop fails the test
                errors.append(exc)

        threads = [threading.Thread(target=call, daemon=True) for _ in range(4)]
        out = {}
        try:
            for t in threads:
                t.start()
            fired = []
            for _ in range(200):
                router.poll_once(now=0.0)
                if any(r["load"].get("inflight") for r in router.status()["replicas"]):
                    fired = scaler.check_once(now=0.0)
                    break
                time.sleep(0.005)
            out["fired"] = [(d["decision"], d["victims"]) for d in fired]
            out["served"] = sum(bool(router.detect(img, timeout_s=30)) for _ in range(3))
            for t in threads:
                t.join(30)
            scaler.check_once(now=1.0)
            out["left"] = [r["replica_id"] for r in router.status()["replicas"]]
            out["results"] = len(results), len(errors)
        finally:
            scaler.stop()
            router.close(close_replicas=True)
        return out

    got, want = run(PORT), run(JAX)
    assert got == want
    assert want == {"fired": [("scale_down", ["r0"])], "served": 3, "left": ["r1"],
                    "results": (4, 0)}


def test_respawn_budget_as_jax():
    """The same deaths and alive notes give the same verdicts, respawn
    times and exhaustion (a per-slot jittered policy, as the fleet
    command line builds it)."""
    script = [("death", 0.0), ("ready", 0.5), ("ready", 3.0), ("death", 3.0), ("alive", 10.0),
              ("death", 11.0), ("death", 12.0), ("ready", 40.0), ("death", 41.0),
              ("alive", 200.0), ("death", 300.0), ("death", 301.0)]

    def run(pkg):
        budget = pkg.replica.RespawnBudget(pkg.backoff.BackoffPolicy(
            max_tries=3, base_s=1.0, multiplier=2.0, ceiling_s=30.0, jitter=0.1,
            seed=12345), reset_after_s=60.0)
        out = []
        for op, now in script:
            if op == "death":
                out.append(("death", budget.note_death(now), budget.next_respawn_t))
            elif op == "alive":
                budget.note_alive(now)
            else:
                out.append(("ready", budget.ready(now)))
            out.append((budget.deaths, budget.exhausted))
        return out

    got, want = run(PORT), run(JAX)
    assert got == want
    assert (4, True) in want


# ---- the fleet command line ------------------------------------------------


def post(url: str, body: bytes) -> int:
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                    timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_fleet_cli_autoscales_stub_replicas_up_and_down(tmp_path):
    """``--autoscale --min-replicas 1 --max-replicas 2`` over stub replicas
    slowed to 50 ms a batch: a burst of 8 clients scales up to 2 replicas,
    idle time drains back to 1, no request fails, and SIGTERM stops the
    fleet and every replica."""
    cmd = [sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.serve.fleet",
           "--http", "0", "--spawn", "1", "--stub-engine", "--stub-delay-ms", "50",
           "--poll-interval", "0.2", "--autoscale", "--min-replicas", "1",
           "--max-replicas", "2", "--autoscale-for-s", "0.4", "--autoscale-up-cooldown-s", "1",
           "--autoscale-down-cooldown-s", "1", "--autoscale-interval-s", "0.2"]
    image = (REPO_ROOT / "tests" / "fixtures" / "jpeg" / "coco_0.jpg").read_bytes()
    stderr = open(tmp_path / "fleet.err", "w+")
    proc = subprocess.Popen(cmd, cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=stderr, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("fleet serving on"):
                url = line.split()[3]
                break
        assert url
        codes, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                codes.append(post(url + "/detect", image))

        clients = [threading.Thread(target=client) for _ in range(8)]
        for t in clients:
            t.start()

        def fleet_size() -> int:
            fleet = json.loads(urllib.request.urlopen(url + "/fleet", timeout=10).read())
            return sum(r["state"] == "closed" and r["weight"] > 0 for r in fleet["replicas"])

        deadline = time.time() + 60
        while fleet_size() < 2 and time.time() < deadline:
            time.sleep(0.2)
        grew = fleet_size()
        stop.set()
        for t in clients:
            t.join(60)
        deadline = time.time() + 60
        while len(json.loads(urllib.request.urlopen(url + "/fleet", timeout=10).read())
                  ["replicas"]) > 1 and time.time() < deadline:
            time.sleep(0.2)
        left = json.loads(urllib.request.urlopen(url + "/fleet", timeout=10).read())["replicas"]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert grew == 2 and len(left) == 1, (grew, left)
    assert codes and set(codes) == {200}
    assert proc.returncode == 0
    stderr.seek(0)
    decisions = [json.loads(line) for line in stderr if line.startswith('{"event": "autoscale_decision"')]
    # A breach that outlasts the scale-up at max_replicas is a capped
    # decision, which changes nothing.
    assert [d["decision"] for d in decisions if d["decision"] != "scale_up_capped"] == [
        "scale_up", "scale_down"], decisions
    assert re.search(r'"fleet_stats": \{"completed": \d+, "timeouts": 0, "failed": 0', out)
