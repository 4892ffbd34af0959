"""One rank of a world of the port on the CPU (gloo), for the
gradient-communication tests (tests/test_torch_comm_*.py):

    python tests/torch_comm_worker.py <job.json> <rank> <world size> <store file>

The job lists the cases to run, in order; each writes its results next to
the job, per rank.  Imports torch and the port only.
"""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from torch_dp_worker import build_model, digest  # noqa: E402

from batchai_retinanet_horovod_coco_tpu_torch.comm import compress  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.launch import (  # noqa: E402
    DistributedConfig,
    initialize_distributed,
    shutdown_distributed,
)
from batchai_retinanet_horovod_coco_tpu_torch.obs.numerics import NumericsConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.parallel.quantize import (  # noqa: E402
    quantized_pmean,
)
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.state import (  # noqa: E402
    create_train_state,
    snapshot,
)
from batchai_retinanet_horovod_coco_tpu_torch.train.step import make_train_step  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

STEP_ARRAYS = ("images", "gt_boxes", "gt_labels", "gt_mask")


def topology_of(case: dict, world):
    slices = case.get("slices")
    return None if slices is None else mesh.CommTopology(slices, world.size // slices)


def position(world, topology) -> int:
    return world.rank if topology is None else topology.position(world.rank)


def reduce_case(case: dict, world, out: Path) -> None:
    """``reduce_tree`` (flat or hierarchical) or ``zero_gather_updates`` on
    the inputs of mesh position ``d`` (each leaf's row ``d``), ``steps``
    times from the given residuals; writes the reduced tree, this rank's new
    residuals and the saturated count."""
    data = np.load(case["inputs"])
    cfg = CommConfig(**case["comm"])
    topology = topology_of(case, world)
    pos = position(world, topology)
    axis = mesh.DataAxis(world)
    n = world.size
    res = {k: torch.from_numpy(data[f"res/{k}"]).reshape(n, -1)[pos].clone() for k in case["res"]}
    results = {}
    if case["kind"] == "zero":
        updates = {p: torch.from_numpy(data[f"u/{p}"][pos]) for p in case["paths"]}
        params = {p: torch.from_numpy(data[f"p/{p}"]) for p in case["paths"]}
        plan = compress.plan_buckets(params, cfg)
        new, res, sat = compress.zero_gather_updates(updates, params, res, plan, cfg, axis)
    else:
        tree = {p: torch.from_numpy(data[f"x/{p}"][pos]) for p in case["paths"]}
        hierarchy = None
        if topology is not None:
            hierarchy = compress.Hierarchy(topology, *mesh.hop_axes(world, topology))
        plan = compress.plan_buckets(tree, cfg, topology)
        for _ in range(case.get("steps", 1)):
            new, res, sat = compress.reduce_tree(tree, res, plan, cfg, axis, hierarchy)
    results.update({f"out/{p}": v.numpy() for p, v in new.items()})
    results.update({f"res/{k}": v.numpy() for k, v in res.items()})
    results["sat"] = sat.numpy()
    np.savez(out / f"{case['name']}-{world.rank}.npz", **results)


def pmean_case(case: dict, world, out: Path) -> None:
    """The deprecated ``quantized_pmean`` on the inputs of this rank (its
    row of each leaf); writes the reduced tree."""
    data = np.load(case["inputs"])
    tree = {p: torch.from_numpy(data[f"x/{p}"][world.rank]) for p in case["paths"]}
    reduced = quantized_pmean(tree, mesh.DataAxis(world))
    np.savez(out / f"{case['name']}-{world.rank}.npz",
             **{f"out/{p}": v.numpy() for p, v in reduced.items()})


def telescope_case(case: dict, world, out: Path) -> None:
    """EF telescoping over ``steps`` random gradients: the applied
    (dequantized) means summed, the exact means summed, and the final
    residual gathered in position order."""
    cfg = CommConfig(**case["comm"])
    axis = mesh.DataAxis(world)
    rng = np.random.default_rng(case["seed"] + world.rank)
    shapes = {"['heads']['w']": (3000,), "['backbone']['k']": (40, 130)}
    zeros = {p: np.zeros(s, np.float32) for p, s in shapes.items()}
    plan = compress.plan_buckets(zeros, cfg)
    full = compress.init_comm_state(zeros, cfg, world.size)
    sharding = mesh_sharding(world)
    res = {k: sharding.local(torch.from_numpy(v)).clone() for k, v in full.items()}
    applied = {p: torch.zeros(s, dtype=torch.float64) for p, s in shapes.items()}
    exact = {p: torch.zeros(s, dtype=torch.float64) for p, s in shapes.items()}
    for _ in range(case["steps"]):
        grads = {p: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                     * rng.choice([1e-3, 1.0, 30.0]))
                 for p, s in shapes.items()}
        out_tree, res, _ = compress.reduce_tree(grads, res, plan, cfg, axis)
        for p in shapes:
            applied[p] += out_tree[p].double()
            exact[p] += axis.pmean(grads[p]).double()
    gathered = {k: sharding.gather(v).numpy() for k, v in res.items()}
    np.savez(out / f"{case['name']}-{world.rank}.npz",
             **{f"applied/{p}": v.numpy() for p, v in applied.items()},
             **{f"exact/{p}": v.numpy() for p, v in exact.items()},
             **{f"res/{k}": v for k, v in gathered.items()})


def mesh_sharding(world, topology=None):
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.zero import Sharding

    return Sharding.of(world, topology)


def constant_case(case: dict, world, out: Path) -> None:
    """A constant gradient on the exact float grid: 0.5 everywhere, 127 at
    the head of each block, on every rank; two reduces."""
    cfg = CommConfig(compress="int8")
    v = np.full((8192,), 0.5, np.float32)
    v[:: cfg.block] = 127.0
    tree = {"['w']": torch.from_numpy(v)}
    plan = compress.plan_buckets(tree, cfg)
    sharding = mesh_sharding(world)
    res = {k: sharding.local(torch.from_numpy(a)).clone()
           for k, a in compress.init_comm_state(tree, cfg, world.size).items()}
    axis = mesh.DataAxis(world)
    out1, res, _ = compress.reduce_tree(tree, res, plan, cfg, axis)
    out2, res, _ = compress.reduce_tree(tree, res, plan, cfg, axis)
    np.savez(out / f"{case['name']}-{world.rank}.npz", v=v, out1=out1["['w']"].numpy(),
             out2=out2["['w']"].numpy(), res=np.concatenate([r.numpy() for r in res.values()]))


def local_rows(arrays: dict, world, pos: int) -> dict[str, torch.Tensor]:
    n = arrays["images"].shape[0] // world.size
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k][pos * n:(pos + 1) * n]))
            for k in STEP_ARRAYS}


def make_state(case: dict, world, topology):
    model = build_model(case)
    comm = CommConfig(**case["comm"]) if case.get("comm") else None
    zero = bool(case.get("zero"))
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu", world=world,
                               comm=comm, shard_weight_update=zero, topology=topology)
    step = make_train_step(model, tuple(case["hw"]), case["model"]["num_classes"], device="cpu",
                           numerics=NumericsConfig(enabled=True), world=world, comm=comm,
                           shard_weight_update=zero, topology=topology)
    hier = topology if (comm is not None and not zero and comm.hierarchical_with(topology)) else None
    return model, state, step, position(world, hier)


def train_case(case: dict, world, out: Path) -> None:
    """``steps`` steps of a comm flavor; the metrics, the digest, the final
    parameters (rank 0) and this rank's residuals; with ``save``, a
    checkpoint of the last step."""
    topology = topology_of(case, world)
    model, state, step, pos = make_state(case, world, topology)
    batch = local_rows(dict(np.load(case["batch"])), world, pos)
    history = []
    for _ in range(case["steps"]):
        history.append({k: float(v) for k, v in step(state, batch).items()})
    if world.rank == 0:
        torch.save(model.state_dict(), out / f"{case['name']}-state.pt")
    if case.get("save"):
        manager = CheckpointManager(case["save"], world=world)
        manager.save(state, force=True)
        manager.close()
    torch.save({k: v.clone() for k, v in state.comm_state.items()},
               out / f"{case['name']}-comm-{world.rank}.pt")
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(
        {"history": history, "digest": digest(model), "step": state.step, "position": pos}))


def restore_case(case: dict, world, out: Path) -> None:
    """Restore ``dir`` into a fresh state of this world's layout; write the
    restored leaves (gathered: rank 0's file), the ``ef_reset`` lines the
    restore printed, and take one step."""
    topology = topology_of(case, world)
    model, state, step, pos = make_state(case, world, topology)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        CheckpointManager(case["dir"], world=world).restore(state)
    resets = [json.loads(line) for line in err.getvalue().splitlines() if '"ef_reset"' in line]
    leaves = snapshot(state, writer=world.is_main)
    if world.is_main:
        np.savez(out / f"{case['name']}-leaves.npz", **dict(leaves))
    restored = state.step
    metrics = step(state, local_rows(dict(np.load(case["batch"])), world, pos))
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(
        {"restored": restored, "loss": float(metrics["loss"]), "digest": digest(model),
         "comm_keys": sorted(state.comm_state), "resets": resets}))


def nan_case(case: dict, world, out: Path) -> None:
    """Three loop steps of the int8 flavor; rank 1's second batch holds a
    NaN pixel.  Records the trip each rank raises."""
    from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch
    from batchai_retinanet_horovod_coco_tpu_torch.train.loop import (
        LoopConfig,
        NonFiniteError,
        run_training,
    )

    comm = CommConfig(**case["comm"])
    model = build_model(case)
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu", world=world,
                               comm=comm, shard_weight_update=bool(case.get("zero")))
    arrays = dict(np.load(case["batch"]))
    n = arrays["images"].shape[0] // world.size
    rows = slice(world.rank * n, (world.rank + 1) * n)
    batches = []
    for i in range(3):
        images = arrays["images"][rows]
        if i == 1 and world.rank == 1:
            images = images.astype(np.float32)
            images[0, 0, 0, 0] = np.nan
        batches.append(Batch(images=images, gt_boxes=arrays["gt_boxes"][rows],
                             gt_labels=arrays["gt_labels"][rows], gt_mask=arrays["gt_mask"][rows],
                             image_ids=np.arange(4, dtype=np.int64)[rows] + 100 * (i + 1),
                             scales=np.ones(n, np.float32), valid=np.ones(n, bool)))
    config = LoopConfig(total_steps=3, log_every=1, device_prefetch=0, comm=comm,
                        shard_weight_update=bool(case.get("zero")))
    try:
        run_training(state, iter(batches), case["model"]["num_classes"], config,
                     log=lambda step, scalars: None, world=world)
        trip = None
    except NonFiniteError as exc:
        trip = {"step": exc.step, "metric": exc.metric}
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps({"trip": trip}))


def refuse_case(case: dict, world, out: Path) -> None:
    """A comm step given a state built with other flags (an int8 state to
    the ZeRO+int8 step, a plain state to the int8 step): each refusal's
    message, or None where the step took the state."""
    model = build_model(case)
    comm = CommConfig(**case["comm"])
    messages = []
    for (state_comm, state_zero), (step_comm, step_zero) in (((comm, False), (comm, True)),
                                                             ((None, False), (comm, False))):
        state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu",
                                   world=world, comm=state_comm, shard_weight_update=state_zero)
        step = make_train_step(model, tuple(case["hw"]), case["model"]["num_classes"],
                               device="cpu", world=world, comm=step_comm,
                               shard_weight_update=step_zero)
        try:
            step(state, {})  # refused before the batch is read
            messages.append(None)
        except ValueError as exc:
            messages.append(str(exc))
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps({"messages": messages}))


CASES = {"reduce": reduce_case, "zero": reduce_case, "pmean": pmean_case,
         "telescope": telescope_case,
         "constant": constant_case, "train": train_case, "restore": restore_case,
         "nan": nan_case, "refuse": refuse_case}


def main() -> None:
    job_path, rank, size, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    # One thread, as the test process: a conv's last bits depend on it.
    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    out = Path(job_path).parent
    world = initialize_distributed(DistributedConfig(
        coordinator_address=f"file://{store}", num_processes=size, process_id=rank, device="cpu",
        timeout_s=120,
    ))
    try:
        for case in job["cases"]:
            CASES[case["kind"]](case, world, out)
    finally:
        shutdown_distributed(world)


if __name__ == "__main__":
    main()
