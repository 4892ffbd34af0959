"""One rank of a data-parallel world of the port on the CPU (gloo), for
tests/test_torch_data_parallel.py:

    python tests/torch_dp_worker.py <job.json> <rank> <world size> <store file>

The job names the train-step cases, the sharded eval and the checkpoint
round trip to run; each writes its results next to the job, per rank.
Imports torch and the port only, so a rank starts in about two seconds.
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from batchai_retinanet_horovod_coco_tpu_torch.data import CocoDataset  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (  # noqa: E402
    PipelineConfig,
    build_pipeline,
)
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.launch import (  # noqa: E402
    DistributedConfig,
    initialize_distributed,
    shutdown_distributed,
)
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.obs.numerics import NumericsConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.step import make_train_step  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402

STEP_ARRAYS = ("images", "gt_boxes", "gt_labels", "gt_mask")


def build_model(spec: dict) -> torch.nn.Module:
    config = retinanet.RetinaNetConfig(**spec["model"], dtype=torch.float32)
    model = retinanet.RetinaNet(config)
    model.load_state_dict(torch.load(spec["weights"]))
    return model


def digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for name, value in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(value.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def local_rows(arrays: dict, world) -> dict[str, torch.Tensor]:
    """This rank's contiguous share of the global batch, as the JAX mesh
    step shards it over the ``data`` axis."""
    n = arrays["images"].shape[0] // world.size
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k][world.rank * n:(world.rank + 1) * n]))
            for k in STEP_ARRAYS}


def train_case(case: dict, world, out: Path) -> None:
    model = build_model(case)
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu")
    step = make_train_step(model, tuple(case["hw"]), case["model"]["num_classes"], device="cpu",
                           numerics=NumericsConfig(enabled=True), world=world)
    batch = local_rows(dict(np.load(case["batch"])), world)
    history, saved = [], {}
    for i in range(case["steps"]):
        history.append({k: float(v) for k, v in step(state, batch).items()})
        if i + 1 == case["save_after"]:
            saved = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(saved, out / f"{case['name']}-state-{world.rank}.pt")
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(
        {"history": history, "digest": digest(model), "step": state.step}))


def checkpoint_case(case: dict, world, out: Path) -> None:
    """Restore the world-of-1 checkpoint under ``dir``, take a step, save."""
    model = build_model(case)
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu")
    manager = CheckpointManager(case["dir"], metadata={"shard_count": world.size}, world=world)
    restored = manager.latest_step()
    manager.restore(state)
    step = make_train_step(model, tuple(case["hw"]), case["model"]["num_classes"], device="cpu",
                           world=world)
    step(state, local_rows(dict(np.load(case["batch"])), world))
    manager.save(state, force=True)
    manager.close()  # every rank returns once rank 0's write has landed
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(
        {"restored": restored, "step": state.step, "digest": digest(model)}))


def nan_case(case: dict, world, out: Path) -> None:
    """Three steps of ``train/loop.py`` with a checkpoint a step; rank 1's
    second batch holds a NaN pixel.  Records the trip each rank raises, the
    image ids the command line's ``--auto-resume`` would exclude on it, and
    the step it would restore."""
    from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import Batch
    from batchai_retinanet_horovod_coco_tpu_torch.train.__main__ import _read_poison_ids
    from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import latest_step
    from batchai_retinanet_horovod_coco_tpu_torch.train.loop import LoopConfig, NonFiniteError, run_training

    model = build_model(case)
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu")
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
    config = LoopConfig(total_steps=3, log_every=1, checkpoint_every=1, checkpoint_dir=case["dir"],
                        device_prefetch=0, numerics_dump_dir=case["dump_dir"])
    try:
        run_training(state, iter(batches), 3, config, log=lambda step, scalars: None, world=world)
        trip = None
    except NonFiniteError as exc:
        trip = {"step": exc.step, "metric": exc.metric, "dump": exc.dump_path,
                "exclude": _read_poison_ids(exc),
                "restore": latest_step(case["dir"], world)}
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps({"trip": trip}))


def eval_case(case: dict, world, out: Path) -> None:
    model = build_model(case).eval()
    dataset = CocoDataset(case["annotations"], case["images"], keep_empty=True)
    config = PipelineConfig(batch_size=1, shuffle=False, hflip_prob=0.0, buckets=(tuple(case["hw"]),),
                            min_side=case["hw"][0], max_side=case["hw"][1], max_gt=8, num_workers=1,
                            shard_index=world.rank, shard_count=world.size)
    detect_config = detect.DetectConfig(score_threshold=case["score_threshold"])
    batches = build_pipeline(dataset, config, train=False)
    try:
        mine = detect.collect_detections(model, dataset, batches, detect_config, "cpu")
    finally:
        batches.close()
    merged = detect.allgather_process_detections(mine, world)
    batches = build_pipeline(dataset, config, train=False)
    try:
        stats = detect.run_coco_eval(model, dataset, batches, detect_config, "cpu", world=world)
    finally:
        batches.close()
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(
        {"local": len(mine), "merged": merged, "stats": stats}))


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
            {"train": train_case, "checkpoint": checkpoint_case, "eval": eval_case,
             "nan": nan_case}[case["kind"]](
                case, world, out)
    finally:
        shutdown_distributed(world)


if __name__ == "__main__":
    main()
