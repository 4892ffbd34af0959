"""The port's data-parallel training (``launch/``, ``parallel/``, the world
paths of ``train/step.py``, ``train/loop.py``, ``utils/checkpoint.py``,
``evaluate/detect.py`` and the command line) against the JAX package's
``shard_map`` + ``pmean`` step, on the CPU.

Every world is two ranks over gloo, each a child process
(``tests/torch_dp_worker.py`` or the command line's own launcher): this
process never joins a group.  Ranks meet through a file store under
``tmp_path``, share one deadline, and are killed and reaped when it passes,
with their output tails in the failure.  The JAX side is the mesh step over
2 of the 8 host devices that ``tests/conftest.py`` forces, from the same
weights (``models/convert.py``) and the same global batch of 4; the
tolerances are ``tests/test_torch_train.py``'s (losses and norms within
rel 1e-4, each tensor within 3e-2 of how far the steps moved it).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu import losses as j_losses
from batchai_retinanet_horovod_coco_tpu.data import pipeline as j_pipeline
from batchai_retinanet_horovod_coco_tpu.obs.numerics import NumericsConfig as JNumericsConfig
from batchai_retinanet_horovod_coco_tpu.ops import matching as j_matching
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.parallel import make_mesh
from batchai_retinanet_horovod_coco_tpu.parallel import mesh as j_mesh
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu.utils import checkpoint as j_ckpt
from batchai_retinanet_horovod_coco_tpu_torch import launch
from batchai_retinanet_horovod_coco_tpu_torch.data import CocoDataset, make_synthetic_coco
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import variables_from_flax
from batchai_retinanet_horovod_coco_tpu_torch.obs import events as t_events
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as t_trace
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh
from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as t_train
from batchai_retinanet_horovod_coco_tpu_torch.train import loop as t_loop
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_train import (  # noqa: F401
    GOLDEN,
    GOLDEN_OPT,
    HW,
    RTOL,
    drop_tmp_path,
    flax_variables,
    golden_batch,
    one_torch_thread,
)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_dp_worker.py")
WORLD = 2
DEADLINE_S = 150
STEPS = 3
# Each tensor within this share of how far the steps moved it, plus 1e-6 of
# its norm: tests/test_torch_train.py's rule, which its docstring explains.
MOVED_RTOL = 3e-2
METRICS = ("loss", "cls_loss", "box_loss", "grad_norm", "param_norm")
STEP_ARRAYS = ("images", "gt_boxes", "gt_labels", "gt_mask")


def world_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"
    return env


def start(cmd: list[str], log: Path) -> subprocess.Popen:
    """A process in a session of its own (its own children die with it),
    its output into ``log``."""
    with open(log, "wb") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=world_env(),
                                cwd=REPO, start_new_session=True)


def wait_all(procs: list[subprocess.Popen], logs: list[Path], deadline: float) -> None:
    """Wait for every process against ONE deadline; past it, kill and reap
    them all and fail with each one's output tail.  A non-zero exit fails
    with the tails too."""
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


def tails(logs: list[Path]) -> str:
    return "\n".join(f"--- {log.name} ---\n{log.read_text(errors='replace')[-2500:]}" for log in logs)


def start_world(job_dir: Path, cases: list[dict]) -> tuple[list[subprocess.Popen], list[Path]]:
    job = job_dir / "job.json"
    job.write_text(json.dumps({"cases": cases}))
    logs = [job_dir / f"rank{r}.log" for r in range(WORLD)]
    procs = [start([sys.executable, str(WORKER), str(job), str(r), str(WORLD), str(job_dir / "store")],
                   log) for r, log in enumerate(logs)]
    return procs, logs


def seeded_model(norm: str) -> torch.nn.Module:
    return t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm, dtype=torch.float32), device="cpu",
        seed=42,
    )


def padded_batch():
    """The golden batch with rank 1's two images made padding: the pad
    pixel, no gt, so that rank has no positive anchor."""
    batch = golden_batch()
    images = batch.images.copy()
    images[2:] = np.round(t_pipeline.IMAGENET_MEAN * 255).astype(np.uint8)
    mask = batch.gt_mask.copy()
    mask[2:] = False
    return batch._replace(images=images, gt_mask=mask)


CASES = {"gn": ("gn", golden_batch), "bn": ("bn", golden_batch), "pad": ("gn", padded_batch)}


def run_jax_mesh(norm: str, batches: list, steps: int) -> list:
    """The JAX mesh step over 2 host devices, numerics on
    (``replica_agreement``), through the plain references of the Pallas
    kernels (held against the port in its single-step tests): ``steps``
    steps of each global batch from the seeded weights, one compile for
    all.  Returns ``(initial, history, (params, batch_stats))`` a batch, as
    ``test_torch_train.run_jax``."""
    config = j_retinanet.RetinaNetConfig(**GOLDEN, norm_kind=norm, stem="conv", dtype=jnp.float32)
    model = j_retinanet.build_retinanet(config)
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**GOLDEN_OPT))
    mesh_ = make_mesh(WORLD)
    step = j_step.make_train_step(
        model, HW, 3, mesh=mesh_, loss_config=j_losses.LossConfig(pallas_focal=False),
        matching_config=j_matching.MatchingConfig(fused_pallas=False), donate_state=False,
        numerics=JNumericsConfig(enabled=True),
    )
    initial = flax_variables(seeded_model(norm))
    params = jax.tree.map(jnp.asarray, initial[0])
    # Placed as the step returns it, so the second step reuses the compile.
    state0 = jax.device_put(j_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, initial[1]), opt_state=tx.init(params), tx=tx,
    ), j_mesh.replicated_sharding(mesh_))
    out = []
    for batch in batches:
        arrays = jax.device_put({k: getattr(batch, k) for k in STEP_ARRAYS},
                                j_mesh.batch_sharding(mesh_))
        state, history = state0, []
        for _ in range(steps):
            state, metrics = step(state, arrays)
            history.append({k: float(v) for k, v in jax.device_get(metrics).items()})
        out.append((initial, history, jax.device_get((state.params, state.batch_stats))))
    return out


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory):
    """One world of 2 runs every step case, and the world-of-1 checkpoint
    resumed in the world, while this process computes the JAX mesh steps
    and the port's one-process runs; yields both sides' results."""
    root = tmp_path_factory.mktemp("dp_world")
    cases = []
    for name, (norm, make) in CASES.items():
        batch = make()
        np.savez(root / f"{name}-batch.npz",
                 **{k: getattr(batch, k) for k in STEP_ARRAYS})
        torch.save(seeded_model(norm).state_dict(), root / f"{name}-weights.pt")
        cases.append(dict(kind="train", name=name, model=dict(GOLDEN, norm_kind=norm), hw=HW,
                          opt=GOLDEN_OPT, weights=str(root / f"{name}-weights.pt"),
                          batch=str(root / f"{name}-batch.npz"), steps=STEPS, save_after=2))
    # A checkpoint of one process, restored and saved again in the world.
    model = seeded_model("bn")
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    t_step.make_train_step(model, HW, 3, device="cpu")(
        state, t_loop.device_batch(golden_batch(), torch.device("cpu")))
    single = t_ckpt.CheckpointManager(str(root / "ckpt"), metadata={"shard_count": 1})
    single.save(state)
    single.close()
    torch.save(seeded_model("bn").state_dict(), root / "ckpt-weights.pt")
    cases.append(dict(kind="checkpoint", name="ckpt", model=dict(GOLDEN, norm_kind="bn"), hw=HW,
                      opt=GOLDEN_OPT, weights=str(root / "ckpt-weights.pt"), dir=str(root / "ckpt"),
                      batch=str(root / "bn-batch.npz")))
    cases.append(dict(kind="nan", name="nan", model=dict(GOLDEN, norm_kind="gn"), hw=HW,
                      opt=GOLDEN_OPT, weights=str(root / "gn-weights.pt"), dir=str(root / "nan-ckpt"),
                      dump_dir=str(root / "nan-dump"), batch=str(root / "gn-batch.npz")))
    procs, logs = start_world(root, cases)
    deadline = time.monotonic() + DEADLINE_S
    try:
        gn, pad = run_jax_mesh("gn", [golden_batch(), padded_batch()], 2)
        jax_side = {"gn": gn, "pad": pad, "bn": run_jax_mesh("bn", [golden_batch()], 2)[0]}
    finally:
        wait_all(procs, logs, deadline)
    ranks = {name: [json.loads((root / f"{name}-{r}.json").read_text()) for r in range(WORLD)]
             for name in [*CASES, "ckpt", "nan"]}
    states = {name: torch.load(root / f"{name}-state-0.pt") for name in CASES}
    yield SimpleNamespace(root=root, jax=jax_side, ranks=ranks, states=states)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(CASES), ids=sorted(CASES))
def test_dp_step_matches_jax_mesh_step(dp_world, name):
    """Two steps of a world of 2 against the JAX mesh step: the metrics
    (``num_pos`` summed over the ranks), ``replica_agreement`` and every
    parameter and BatchNorm statistic (averaged over the ranks, so the bn
    case's second step starts from the averaged statistics).  ``pad``: rank
    1 holds only padding images, so no positive anchor, and still trains."""
    initial, want, final = dp_world.jax[name]
    got = dp_world.ranks[name][0]["history"]
    for g, w in zip(got[:2], want):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        assert g["num_pos"] == w["num_pos"]
        np.testing.assert_allclose(g["replica_agreement"], w["replica_agreement"], rtol=RTOL)
    assert dp_world.ranks[name][1]["history"] == got  # every rank reads the world's metrics
    if name == "pad":
        assert got[0]["replica_agreement"] < 1.0
    start, end = variables_from_flax(*initial), variables_from_flax(*final)
    ours = dp_world.states[name]
    assert set(end) == set(ours)
    for key, want_v in end.items():
        err = torch.linalg.vector_norm(ours[key] - want_v)
        moved = torch.linalg.vector_norm(want_v - start[key])
        assert err <= MOVED_RTOL * moved + 1e-6 * torch.linalg.vector_norm(want_v), key
    if name == "bn":
        assert any(".running_var" in k for k in end)


def test_world_equals_one_process_and_ranks_stay_identical(dp_world):
    """The port alone: three steps of the world of 2 equal three steps of
    one process on the global batch (GroupNorm; the parameters after two
    within ``MOVED_RTOL`` of how far they moved: the batch's split moves
    the ill-conditioned backbone updates of this tiny model by up to ~1e-3
    of their size, as f32 rounding does), and both ranks' parameters are
    bit-identical after them."""
    model = seeded_model("gn")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    step = t_step.make_train_step(model, HW, 3, device="cpu")
    arrays = t_loop.device_batch(golden_batch(), torch.device("cpu"))
    history = []
    for i in range(STEPS):
        history.append({k: float(v) for k, v in step(state, arrays).items()})
        if i == 1:  # the world saved its state after two steps
            for key, want_v in model.state_dict().items():
                err = torch.linalg.vector_norm(dp_world.states["gn"][key] - want_v)
                moved = torch.linalg.vector_norm(want_v - start[key])
                assert err <= MOVED_RTOL * moved + 1e-6 * torch.linalg.vector_norm(want_v), key
    ranks = dp_world.ranks["gn"]
    for g, w in zip(ranks[0]["history"], history):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        assert g["num_pos"] == w["num_pos"]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert ranks[0]["step"] == ranks[1]["step"] == STEPS
    for name in CASES:
        assert len({r["digest"] for r in dp_world.ranks[name]}) == 1, name


def test_checkpoint_moves_between_world_sizes(dp_world):
    """A world of 2 restores the step one process saved, on every rank,
    and its rank 0 alone writes the next; that checkpoint restores in one
    process and in the JAX package."""
    ranks = dp_world.ranks["ckpt"]
    assert [r["restored"] for r in ranks] == [1, 1]
    assert [r["step"] for r in ranks] == [2, 2]
    assert ranks[0]["digest"] == ranks[1]["digest"]
    directory = str(dp_world.root / "ckpt")
    assert [s for s, _ in t_ckpt.scan_checkpoints(directory)] == [1, 2]
    assert not [n for n in os.listdir(directory) if n.startswith(".tmp")]
    assert t_ckpt.read_manifest(directory)["metadata"]["shard_count"] == WORLD
    model = seeded_model("bn")
    state = t_state.create_train_state(model, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    t_ckpt.CheckpointManager(directory).restore(state)
    assert state.step == 2
    saved = j_ckpt.CheckpointManager(directory).restore_arrays()
    assert int(saved["step"]) == 2
    ours = t_ckpt.CheckpointManager(directory).restore_arrays()
    assert jax.tree.all(jax.tree.map(np.array_equal, saved["params"], ours["params"]))
    assert jax.tree.all(jax.tree.map(np.array_equal, saved["batch_stats"], ours["batch_stats"]))


def test_nan_on_one_rank_stops_every_rank_at_one_step(dp_world):
    """A NaN image on rank 1 alone: the world's loss is NaN on both ranks, so
    both stop at step 2; rank 0 writes the one NUMERICS_DUMP.json, naming
    the global batch's 4 image ids, which every rank's ``--auto-resume``
    would exclude, restoring the same step (1) on every rank."""
    trips = [r["trip"] for r in dp_world.ranks["nan"]]
    assert trips[0] == trips[1]
    trip = trips[0]
    assert (trip["step"], trip["metric"], trip["restore"]) == (2, "loss", 1)
    assert trip["exclude"] == [200, 201, 202, 203]
    assert trip["dump"] == str(dp_world.root / "nan-dump" / "NUMERICS_DUMP.json")
    assert os.listdir(dp_world.root / "nan-dump") == ["NUMERICS_DUMP.json"]
    assert [s for s, _ in t_ckpt.scan_checkpoints(str(dp_world.root / "nan-ckpt"))] == [1]


def records(shapes: list[tuple[int, int]]):
    return SimpleNamespace(records=[SimpleNamespace(image_id=1000 + i, height=h, width=w)
                                    for i, (h, w) in enumerate(shapes)])


@pytest.mark.parametrize("shards", [2, 3])
def test_shard_batch_plans_equal_jax(shards):
    """Each shard's batch plans (buckets, record indices, image ids) equal
    the JAX pipeline's, with exclusions, for two epochs, training and eval."""
    rng = np.random.default_rng(shards)
    dataset = records([(int(h), int(w)) for h, w in rng.integers(200, 900, (29, 2))])
    common = dict(batch_size=2, min_side=256, max_side=512, seed=3, exclude_ids=(1004, 1011),
                  buckets=((256, 512), (512, 256), (384, 384)))
    for index in range(shards):
        for train in (True, False):
            for epoch in (0, 1):
                got = list(t_pipeline.batch_plans(dataset, t_pipeline.PipelineConfig(
                    shard_index=index, shard_count=shards, **common), train, epoch))
                want = list(j_pipeline.batch_plans(dataset, j_pipeline.PipelineConfig(
                    shard_index=index, shard_count=shards, **common), train, epoch))
                assert got == want and got, (index, train, epoch)
    every = [i for index in range(shards) for i in t_pipeline.epoch_indices(
        dataset, t_pipeline.PipelineConfig(shard_index=index, shard_count=shards, **common), True, 0)]
    assert sorted(every) == sorted(set(range(29)) - {4, 11})


def test_sharded_eval_equals_one_process(tmp_path):
    """A world of 2 detects its halves of the val set, gathers them and
    scores: the merged detections and the 12 stats equal one process's.
    The image ids lie above 2**32 (the gather sends them as two halves)."""
    ann = make_synthetic_coco(str(tmp_path), num_images=6, num_classes=3, image_size=(64, 64),
                              seed=7, split="val")
    blob = json.loads(Path(ann).read_text())
    big = {im["id"]: im["id"] + 2**32 + 5 for im in blob["images"]}
    for item in blob["images"]:
        item["id"] = big[item["id"]]
    for item in blob["annotations"]:
        item["image_id"] = big[item["image_id"]]
    Path(ann).write_text(json.dumps(blob))
    model = seeded_model("gn")
    torch.save(model.state_dict(), tmp_path / "weights.pt")
    case = dict(kind="eval", name="eval", model=dict(GOLDEN, norm_kind="gn"), hw=HW,
                weights=str(tmp_path / "weights.pt"), annotations=ann,
                images=str(tmp_path / "val"), score_threshold=0.005)
    procs, logs = start_world(tmp_path, [case])
    deadline = time.monotonic() + DEADLINE_S
    dataset = CocoDataset(ann, str(tmp_path / "val"), keep_empty=True)
    config = t_pipeline.PipelineConfig(batch_size=1, shuffle=False, hflip_prob=0.0, buckets=(HW,),
                                       min_side=HW[0], max_side=HW[1], max_gt=8, num_workers=1)
    detect_config = t_detect.DetectConfig(score_threshold=0.005)
    batches = t_pipeline.build_pipeline(dataset, config, train=False)
    try:
        want = t_detect.collect_detections(model.eval(), dataset, batches, detect_config, "cpu")
    finally:
        batches.close()
    batches = t_pipeline.build_pipeline(dataset, config, train=False)
    try:
        want_stats = t_detect.run_coco_eval(model, dataset, batches, detect_config, "cpu")
    finally:
        batches.close()
    wait_all(procs, logs, deadline)
    ranks = [json.loads((tmp_path / f"eval-{r}.json").read_text()) for r in range(WORLD)]
    assert want and all(0 < r["local"] < len(want) for r in ranks)
    assert sum(r["local"] for r in ranks) == len(want)

    def key(d):
        return (d["image_id"], d["category_id"], d["score"], *d["bbox"])

    for r in ranks:
        assert sorted(map(key, r["merged"])) == sorted(map(key, want))
        assert r["stats"] == want_stats
    assert min(d["image_id"] for d in want) > 2**32


def cli_flags(root: Path) -> list[str]:
    return ["synthetic", "--device", "cpu", "--synthetic-root", str(root / "data"),
            "--synthetic-images", "8", "--synthetic-size", "64", "--image-min-side", "64",
            "--image-max-side", "64", "--backbone", "resnet_test", "--f32", "--batch-size", "4",
            "--workers", "2", "--snapshot-path", str(root / "ckpt"), "--log-dir", str(root / "logs"),
            "--warmup-steps", "0"]


def test_cli_world_of_two_checkpoints_once_and_resumes_alone(tmp_path):
    """``train synthetic --device cpu --num-devices 2``: exits 0; rank 0
    alone logs and writes the one checkpoint, whose manifest records the
    world; one process resumes it, and the JAX package restores it."""
    log = tmp_path / "cli.log"
    proc = start([sys.executable, "-m", "batchai_retinanet_horovod_coco_tpu_torch.train",
                  *cli_flags(tmp_path), "--num-devices", "2", "--steps", "2",
                  "--checkpoint-every", "2"], log)
    wait_all([proc], [log], time.monotonic() + DEADLINE_S)
    directory = str(tmp_path / "ckpt")
    assert [s for s, _ in t_ckpt.scan_checkpoints(directory)] == [2]
    assert not [n for n in os.listdir(directory) if n.startswith(".tmp")]
    assert t_ckpt.read_manifest(directory)["metadata"]["shard_count"] == 2
    lines = [json.loads(line) for line in log.read_text().splitlines() if line.startswith('{"step"')]
    assert [line["step"] for line in lines] == [2]  # rank 0 alone logs
    headers = [r for r in map(json.loads, (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines())
               if r.get("event") == "run_header"]
    assert [(h["process_index"], h["process_count"]) for h in headers] == [(0, 2)]
    saved = j_ckpt.CheckpointManager(directory).restore_arrays()
    assert int(saved["step"]) == 2
    out = t_train.main(cli_flags(tmp_path) + ["--steps", "3", "--checkpoint-every", "3"])
    assert out["final_step"] == 3.0
    assert t_ckpt.read_manifest(directory)["metadata"]["shard_count"] == 1


@pytest.mark.parametrize("flags,want", [
    (["--num-devices", "8"], dict(joins=False)),
    (["--distributed-auto"], dict(joins=True, auto=True)),
    (["--coordinator-address", "h:1", "--num-processes", "4", "--process-id", "3"],
     dict(joins=True, coordinator_address="h:1", num_processes=4, process_id=3,
          init_method="tcp://h:1")),
    (["--preset", "pod"], dict(joins=True, auto=True)),
], ids=["num-devices", "auto", "explicit", "pod"])
def test_launch_flags_map_to_the_config(flags, want):
    """The launch flags and presets → ``DistributedConfig``, without a run."""
    args = t_train.parse_args(["synthetic", "--device", "cpu", *flags])
    config = t_train.distributed_config(args)
    assert {k: getattr(config, k) for k in want} == want
    assert config.device == "cpu" and config.backend_name() == "gloo"


def test_torchrun_environment_maps_to_the_world(monkeypatch):
    env = {"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2",
           "MASTER_PORT": "29500"}
    config = launch.DistributedConfig(auto=True).resolved(env)
    assert (config.process_id, config.num_processes, config.local_rank) == (5, 8, 1)
    assert config.init_method == "env://" and config.backend_name() == "nccl"
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        launch.DistributedConfig(auto=True).resolved({k: v for k, v in env.items() if k != "MASTER_PORT"})
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert launch.DistributedConfig(auto=True).resolved().process_id == 5
    explicit = launch.DistributedConfig(coordinator_address="file:///x/store", num_processes=2,
                                        process_id=1).resolved()
    assert (explicit.local_rank, explicit.init_method) == (1, "file:///x/store")
    with pytest.raises(ValueError, match="process id 2 is not in a world of 2"):
        launch.DistributedConfig(coordinator_address="h:1", num_processes=2, process_id=2).resolved()
    with pytest.raises(SystemExit, match="together"):
        t_train.distributed_config(t_train.parse_args(["synthetic", "--process-id", "0"]))
    assert launch.initialize_distributed(launch.DistributedConfig()) is None
    assert launch.shard_info(None) == (0, 1)


def test_rank_labels_the_trace_and_the_run_header(tmp_path, monkeypatch):
    """The run header carries the process's index and count; only process 0
    writes the event log; the trace names the rank."""
    monkeypatch.setenv(t_trace.OBS_PINDEX_ENV, "0")  # restored after the test
    for index in (1, 0):
        sink = t_events.EventSink(str(tmp_path / f"logs{index}"), stdout=False,
                                  process_index=index, process_count=2)
        sink.log(1, {"loss": 1.0})
        sink.close()
    assert not (tmp_path / "logs1" / "metrics.jsonl").exists()
    header = json.loads((tmp_path / "logs0" / "metrics.jsonl").read_text().splitlines()[0])
    assert (header["event"], header["process_index"], header["process_count"]) == ("run_header", 0, 2)
    t_trace.set_process_index(3)
    try:
        t_trace.configure(str(tmp_path / "obs"), process_label="train", export_env=False)
        meta = {e["name"]: e["args"] for e in t_trace.snapshot_events() if e["ph"] == "M"}
        assert meta["process_name"]["name"].startswith("p3:train")
        assert meta["process_labels"] == {"labels": "process_index=3"}
    finally:
        t_trace.reset()


def test_what_is_not_there_raises(tmp_path, monkeypatch):
    """Cards that are not there, a batch the ranks cannot split and a
    backend this build lacks each raise, naming the cause; nothing falls
    back to the CPU or to one process."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="asks for 2 CUDA card"):
            t_train.main(["synthetic", "--num-devices", "2", "--synthetic-root", str(tmp_path)])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.initialize_distributed(launch.DistributedConfig(
                coordinator_address="h:1", num_processes=2, process_id=0))
    with pytest.raises(ValueError, match="--batch-size 4 is not divisible by the data world's 3"):
        t_train.main(["synthetic", "--device", "cpu", "--num-devices", "3", "--batch-size", "4",
                      "--synthetic-root", str(tmp_path)])
    monkeypatch.setattr(torch.distributed, "is_gloo_available", lambda: False)
    with pytest.raises(RuntimeError, match="the gloo backend of torch.distributed is not available"):
        launch.initialize_distributed(launch.DistributedConfig(
            coordinator_address=f"file://{tmp_path}/store", num_processes=1, process_id=0,
            device="cpu"))
    assert not torch.distributed.is_initialized()
    assert mesh.local_batch_size(16, 8) == 2
