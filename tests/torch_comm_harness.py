"""Shared by the gradient-communication tests (tests/test_torch_comm_*.py):
the worlds of ranks (``tests/torch_comm_worker.py``), each a child process
in a session of its own, meeting through a file store under the test's
directory and sharing one deadline, past which all are killed and reaped
with their output tails in the failure; and the JAX package's mesh steps
of the same flavors over host devices, on the same weights.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.comm import CommConfig as JCommConfig
from batchai_retinanet_horovod_coco_tpu.comm import init_comm_state as j_init_comm_state
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu.parallel import init_sharded_opt_state, make_mesh
from batchai_retinanet_horovod_coco_tpu.parallel import mesh as j_mesh
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_comm_worker.py")
STEP_ARRAYS = ("images", "gt_boxes", "gt_labels", "gt_mask")


def world_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                        "MASTER_PORT", "RETINANET_COMM_SLICES")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "1"
    return env


def start(cmd: list[str], log: Path) -> subprocess.Popen:
    with open(log, "wb") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=world_env(),
                                cwd=REPO, start_new_session=True)


def tails(logs: list[Path]) -> str:
    return "\n".join(f"--- {log.name} ---\n{log.read_text(errors='replace')[-2500:]}" for log in logs)


def wait_all(procs: list[subprocess.Popen], logs: list[Path], deadline: float) -> None:
    """Wait for every process against one deadline; past it, kill and reap
    them all and fail with their output tails.  A non-zero exit fails too."""
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in procs:
            p.wait()
        raise AssertionError("world timed out; " + tails(logs)) from None
    assert all(p.returncode == 0 for p in procs), (
        f"exit codes {[p.returncode for p in procs]}; " + tails(logs))


class World:
    """A world of ``size`` ranks running ``cases`` under ``job_dir``."""

    def __init__(self, job_dir: Path, cases: list[dict], size: int, deadline_s: float):
        job_dir.mkdir(parents=True, exist_ok=True)
        self.dir, self.size = job_dir, size
        job = job_dir / "job.json"
        job.write_text(json.dumps({"cases": cases}))
        self.logs = [job_dir / f"rank{r}.log" for r in range(size)]
        self.deadline = time.monotonic() + deadline_s
        self.procs = [start([sys.executable, str(WORKER), str(job), str(r), str(size),
                             str(job_dir / "store")], log) for r, log in enumerate(self.logs)]

    def wait(self) -> None:
        wait_all(self.procs, self.logs, self.deadline)

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        for p in self.procs:
            p.wait()

    def json(self, name: str) -> list[dict]:
        return [json.loads((self.dir / f"{name}-{r}.json").read_text()) for r in range(self.size)]

    def npz(self, name: str) -> list[dict]:
        return [dict(np.load(self.dir / f"{name}-{r}.npz")) for r in range(self.size)]


def jax_state(initial, opt: dict, mesh, comm: JCommConfig | None = None, zero: bool = False):
    """The JAX train state of ``initial`` (flax params, batch_stats) for the
    mesh step's flavor, placed as the step returns it."""
    cfg = j_optim.OptimizerConfig(**opt)
    tx, _ = j_optim.make_optimizer(cfg, shard_clip_axis=j_mesh.DATA_AXIS if zero else None)
    repl = j_mesh.replicated_sharding(mesh)
    params = jax.device_put(jax.tree.map(jnp.asarray, initial[0]), repl)
    opt_state = (init_sharded_opt_state(tx, params, mesh) if zero
                 else jax.device_put(tx.init(params), repl))
    comm_state = ()
    if comm is not None and comm.needs_state:
        shard = NamedSharding(mesh, P(j_mesh.DATA_AXIS))
        comm_state = {k: jax.device_put(jnp.asarray(v), shard)
                      for k, v in j_init_comm_state(initial[0], comm, mesh.size, zero=zero).items()}
    return j_state.TrainState(
        step=jax.device_put(jnp.zeros((), jnp.int32), repl), params=params,
        batch_stats=jax.device_put(jax.tree.map(jnp.asarray, initial[1]), repl),
        opt_state=opt_state, tx=tx, comm_state=comm_state,
    )


def jax_mesh_steps(golden: dict, norm: str, initial, opt: dict, batch, steps: int, n: int,
                   comm: JCommConfig | None = None, zero: bool = False):
    """``steps`` steps of the JAX mesh step's flavor over ``n`` host devices
    (the plain references of the Pallas kernels); returns (history, final
    state, on the devices)."""
    config = j_retinanet.RetinaNetConfig(**golden, norm_kind=norm, stem="conv", dtype=jnp.float32)
    model = j_retinanet.build_retinanet(config)
    mesh = make_mesh(n)
    step = j_step.make_train_step(
        model, (batch.images.shape[1], batch.images.shape[2]), golden["num_classes"], mesh=mesh,
        loss_config=j_losses.LossConfig(pallas_focal=False),
        matching_config=j_matching.MatchingConfig(fused_pallas=False), donate_state=False,
        shard_weight_update=zero, comm=comm,
    )
    state = jax_state(initial, opt, mesh, comm, zero)
    arrays = jax.device_put({k: getattr(batch, k) for k in STEP_ARRAYS}, j_mesh.batch_sharding(mesh))
    history = []
    for _ in range(steps):
        state, metrics = step(state, arrays)
        history.append({k: float(v) for k, v in jax.device_get(metrics).items()})
    return history, state
