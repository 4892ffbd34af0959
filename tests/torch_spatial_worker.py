"""One rank of a spatially partitioned world of the port on the CPU (gloo),
for tests/test_torch_spatial.py and tests/test_torch_spatial_train.py:

    python tests/torch_spatial_worker.py <job.json> <rank> <world size> <store file>

The job lists cases, each run on a (world // space) x space grid:

- ``ops``: one module of the model family (:data:`OPS`) on this rank's
  rows of its data index's images, and the backward of a seeded cotangent;
  writes the output rows, the input rows' gradient and the parameters'
  gradients;
- ``detect``: ``make_detect_fn_spatial`` on the job's images, with the
  job's model and with seeded models of the other families; writes the
  detections;
- ``train``: one ``make_train_step_spatial`` step on this data index's
  share of the batch; writes the metrics, the parameters after it and
  the targets of the rank's anchors.

Imports torch and the port only, so a rank starts in about two seconds.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.launch import (  # noqa: E402
    DistributedConfig,
    initialize_distributed,
    shutdown_distributed,
)
from batchai_retinanet_horovod_coco_tpu_torch.models import fpn, resnet, retinanet  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import focal as focal_cuda  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import matching as matching_cuda  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh, spatial  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig  # noqa: E402
from batchai_retinanet_horovod_coco_tpu_torch.ops.matching import (  # noqa: E402
    anchor_targets_compact_spatial,
)
from batchai_retinanet_horovod_coco_tpu_torch.train.step import (  # noqa: E402
    make_train_step_spatial,
    spatial_anchors,
)

F32 = torch.float32
SYM = resnet.symmetric


def _conv(*args, **kwargs):
    return lambda: resnet.Conv2d(*args, dtype=F32, **kwargs)


def _fn(f):
    """A parameterless op as a module."""
    class Op(torch.nn.Module):
        def forward(self, *args):
            return f(*args)
    return Op


#: Every conv and pool geometry of the model family, and the norms: name ->
#: module factory.  Inputs have 4 channels.
OPS = {
    "conv7x7s2-symmetric": lambda: resnet.Conv2d(4, 4, 7, 2, SYM(7), False, F32),
    "conv3x3s1-same": _conv(4, 4, 3, 1, "same", True),
    "conv3x3s2-same": _conv(4, 4, 3, 2, "same", True),
    "conv3x3s1-symmetric": _conv(4, 4, 3, 1, SYM(3), False),
    "conv3x3s2-symmetric": _conv(4, 4, 3, 2, SYM(3), False),
    "conv1x1s1": _conv(4, 4, 1, 1, SYM(1), False),
    "conv1x1s2": _conv(4, 4, 1, 2, SYM(1), False),
    "depthwise3x3s2-same": _conv(4, 4, 3, 2, "same", False, groups=4),
    "maxpool2x2-valid": _fn(lambda x: resnet.max_pool(x, 2, 2)),
    "avgpool2x2-valid": _fn(lambda x: resnet.avg_pool(x, 2, 2)),
    "maxpool3x3s2-same": _fn(lambda x: resnet.max_pool(x, 3, 2, "same")),
    "stempool-max": _fn(lambda x: resnet.stem_pool(x, "max")),
    "stempool-avg": _fn(lambda x: resnet.stem_pool(x, "avg")),
    "groupnorm": lambda: resnet.GroupNorm(4, F32, num_groups=2),
    "batchnorm": lambda: resnet.BatchNorm(4, F32).train(),
    # The FPN's top-down resize to a map of h rows (its input has ceil(h / 2)).
    "upsample": None,
}


def build_op(name: str, seed: int) -> torch.nn.Module:
    """The op, its parameters drawn from ``seed``."""
    if name == "upsample":
        return _fn(lambda x, ref: fpn.upsample_like(x, ref))()
    module = OPS[name]()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5 + (1.0 if p.dim() == 1 else 0.0))
    return module


def build_model(spec: dict) -> torch.nn.Module:
    model = retinanet.RetinaNet(retinanet.RetinaNetConfig(**spec["model"], dtype=F32))
    model.load_state_dict(torch.load(spec["weights"]))
    return model


def ops_case(case: dict, world, out: Path) -> None:
    axis = mesh.space_axis(world, case["space"])
    arrays = np.load(case["inputs"])
    results = {}
    for name in case["ops"]:
        for h in case["heights"]:
            x = torch.from_numpy(arrays[f"{name}-{h}-x"])
            n = x.shape[0] // axis.data_size
            x = x[axis.data_index * n:(axis.data_index + 1) * n]
            r0, r1 = spatial.rows_of(x.shape[2], axis.size, axis.index)
            x = x[:, :, r0:r1].clone().requires_grad_(True)
            op = build_op(name, case["seed"])
            with spatial.sharded(axis):
                if name == "upsample":
                    o0, o1 = spatial.rows_of(h, axis.size, axis.index)
                    y = op(x, x.new_zeros((n, x.shape[1], o1 - o0, 2 * x.shape[3])))
                else:
                    y = op(x)
            cot = torch.from_numpy(arrays[f"{name}-{h}-cot"])[axis.data_index * n:(axis.data_index + 1) * n]
            o0, o1 = spatial.rows_of(cot.shape[2], axis.size, axis.index)
            (y * cot[:, :, o0:o1]).sum().backward()
            key = f"{name}-{h}"
            results[f"{key}-y"] = y.detach().numpy()
            results[f"{key}-gx"] = x.grad.numpy()
            for pname, p in op.named_parameters():
                results[f"{key}-g-{pname}"] = p.grad.numpy()
            for bname, b in op.named_buffers():
                results[f"{key}-b-{bname}"] = b.numpy()
    np.savez(out / f"{case['name']}-{world.rank}.npz", **results)


def detect_case(case: dict, world, out: Path) -> None:
    model = build_model(case)
    images = np.load(case["images"])
    config = detect.DetectConfig(**case["detect"])
    results = {}
    nms_cuda.reset_counts()
    for space in case["spaces"]:
        for hw in case["hws"]:
            fn = detect.make_detect_fn_spatial(model, tuple(hw), config, world, space)
            det = fn(images[f"{hw[0]}x{hw[1]}"])
            for field in det._fields:
                results[f"{space}-{hw[0]}x{hw[1]}-{field}"] = getattr(det, field).numpy()
    results["nms_plain_calls"] = np.asarray(nms_cuda.plain_calls)
    for backbone in case.get("families", ()):
        family = retinanet.build_retinanet(retinanet.RetinaNetConfig(
            **dict(case["model"], backbone=backbone), dtype=F32), device="cpu", seed=1)
        hw = tuple(case["family_hw"])
        det = detect.make_detect_fn_spatial(family, hw, config, world, case["family_space"])(
            images[f"{hw[0]}x{hw[1]}"])
        for field in det._fields:
            results[f"{backbone}-{field}"] = getattr(det, field).numpy()
    np.savez(out / f"{case['name']}-{world.rank}.npz", **results)


def train_case(case: dict, world, out: Path) -> None:
    model = build_model(case)
    state = create_train_state(model, OptimizerConfig(**case["opt"]), device="cpu", world=world,
                               spatial_shards=case["space"])
    step = make_train_step_spatial(model, tuple(case["hw"]), case["model"]["num_classes"], world,
                                   case["space"])
    axis = mesh.space_axis(world, case["space"])
    arrays = dict(np.load(case["batch"]))
    n = arrays["images"].shape[0] // axis.data_size
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[axis.data_index * n:(axis.data_index + 1) * n]))
             for k, v in arrays.items()}
    matching_cuda.reset_counts()
    focal_cuda.reset_counts()
    metrics = {k: float(v) for k, v in step(state, batch).items()}
    metrics["matching_plain_calls"] = matching_cuda.plain_calls
    metrics["focal_plain_calls"] = focal_cuda.plain_calls
    # The targets of this rank's anchors, by global anchor index.
    anchors, index = spatial_anchors(tuple(case["hw"]), AnchorConfig(), axis, torch.device("cpu"))
    targets = anchor_targets_compact_spatial(anchors, index, batch["gt_boxes"], batch["gt_labels"],
                                             batch["gt_mask"], axis)
    np.savez(out / f"{case['name']}-targets-{world.rank}.npz", index=index.numpy(),
             **{k: getattr(targets, k).numpy() for k in targets._fields})
    torch.save(model.state_dict(), out / f"{case['name']}-state-{world.rank}.pt")
    (out / f"{case['name']}-{world.rank}.json").write_text(json.dumps(metrics))


def main() -> None:
    job_path, rank, size, store = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    job = json.loads(Path(job_path).read_text())
    out = Path(job_path).parent
    world = initialize_distributed(DistributedConfig(
        coordinator_address=f"file://{store}", num_processes=size, process_id=rank, device="cpu",
        timeout_s=120,
    ))
    try:
        for case in job["cases"]:
            {"ops": ops_case, "detect": detect_case, "train": train_case}[case["kind"]](
                case, world, out)
    finally:
        shutdown_distributed(world)


if __name__ == "__main__":
    main()
