"""The port's spatially partitioned train step (``train/step.py::
make_train_step_spatial``) on the CPU: one step of a (1 data x 2 space)
world and of a (2 x 2) world (``tests/torch_spatial_worker.py``, gloo
child processes under one deadline), on the same batch and weights as

- the JAX package's single-device ``make_train_step(mesh=None)``: ``loss``
  and ``grad_norm`` within rtol 3e-5, every parameter within atol 3e-5
  (rtol 1e-5), the bounds of ``tests/distributed/test_spatial_train.py``.
  The JAX *spatial* step is not the reference: inside its ``allow_*``
  overrides it computes other gradients, the port's step does not;
- the port's own one-process step, within rtol 2e-6 (``loss``,
  ``grad_norm``) and atol 2e-6 (parameters): the same math, summed in
  another order.

The batch pins the global force-match: a gt whose best anchor lies on the
other rank, and a gt whose two best anchors tie across the shard boundary
(the lower global index, rank 0's, must win).  The factory's refusals are
checked against the JAX package's own envelope functions and messages,
without a world.
"""

import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.parallel.mesh import make_mesh_2d
from batchai_retinanet_horovod_coco_tpu.train import optim as j_optim
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu.train import step as j_step
from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as t_pipeline
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.ops import matching as t_matching
from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state
from batchai_retinanet_horovod_coco_tpu_torch.train import step as t_step
from test_torch_train import GOLDEN_OPT, drop_tmp_path, flax_variables, one_torch_thread  # noqa: F401
from torch_comm_harness import start, wait_all

WORKER = "tests/torch_spatial_worker.py"
DEADLINE_S = 120
HW = (128, 64)
MODEL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=1)
GRIDS = ((1, 2), (2, 2))  # (data, space)
# gt 0 of image 0 is centred on the boundary row 64 between the two ranks:
# the 32 x 32 anchors centred at y 60 (rank 0) and y 68 (rank 1) overlap it
# equally (IoU 0.39, below both thresholds), so only the force-match makes
# one of them positive.  Image 1's gt lies in rank 1's rows.
TIE_GT = [26.0, 54.0, 46.0, 74.0]
FAR_GT = [10.0, 92.0, 40.0, 118.0]


def spatial_batch():
    rng = np.random.default_rng(11)
    examples = []
    for i in range(4):
        boxes = {0: [TIE_GT], 1: [FAR_GT], 2: [[4.0, 6.0, 30.0, 40.0], [30.0, 70.0, 60.0, 125.0]],
                 3: []}[i]
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        image = rng.integers(0, 256, (*HW, 3), dtype=np.uint8)
        examples.append((image, boxes, np.arange(len(boxes), dtype=np.int32) % 3, 1.0))
    return t_pipeline.assemble(examples, list(range(4)), HW, max_gt=3)


def seeded_model() -> torch.nn.Module:
    return t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**MODEL, dtype=torch.float32), device="cpu", seed=9)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worlds' results, the port's one-process step and the JAX
    single-device step on the same batch."""
    root = tmp_path_factory.mktemp("spatial-train")
    batch = spatial_batch()
    arrays = {k: getattr(batch, k) for k in ("images", "gt_boxes", "gt_labels", "gt_mask")}
    np.savez(root / "batch.npz", **arrays)
    model = seeded_model()
    torch.save(model.state_dict(), root / "weights.pt")
    worlds = []
    for data, space in GRIDS:
        job_dir = root / f"{data}x{space}"
        job_dir.mkdir()
        case = {"kind": "train", "name": "train", "model": MODEL, "weights": str(root / "weights.pt"),
                "batch": str(root / "batch.npz"), "hw": list(HW), "space": space,
                "opt": GOLDEN_OPT}
        (job_dir / "job.json").write_text(json.dumps({"cases": [case]}))
        size = data * space
        logs = [job_dir / f"rank{r}.log" for r in range(size)]
        procs = [start(["python", WORKER, str(job_dir / "job.json"), str(r), str(size),
                        str(job_dir / "store")], log) for r, log in enumerate(logs)]
        worlds.append((job_dir, size, procs, logs))
    deadline = time.monotonic() + DEADLINE_S
    # Meanwhile: the port's one-process step and the JAX step.
    one = seeded_model()
    state = t_state.create_train_state(one, t_optim.OptimizerConfig(**GOLDEN_OPT), device="cpu")
    step = t_step.make_train_step(one, HW, 3, device="cpu")
    one_metrics = {k: float(v) for k, v in step(state, {k: torch.from_numpy(v) for k, v in
                                                        arrays.items()}).items()}
    one_targets = t_matching.anchor_targets_compact(
        torch.from_numpy(np.array(t_anchors.anchors_for_image_shape(HW))),
        *(torch.from_numpy(arrays[k]) for k in ("gt_boxes", "gt_labels", "gt_mask")))
    j_model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**MODEL, stem="conv", dtype=jnp.float32))
    tx, _ = j_optim.make_optimizer(j_optim.OptimizerConfig(**GOLDEN_OPT))
    params, stats = (jax.tree.map(jnp.asarray, t) for t in flax_variables(model))
    j_state0 = j_state.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params), tx=tx)
    j_new, j_metrics = j_step.make_train_step(j_model, HW, 3, mesh=None, donate_state=False)(
        j_state0, {k: jnp.asarray(v) for k, v in arrays.items()})
    got = {}
    for (data, space), (job_dir, size, procs, logs) in zip(GRIDS, worlds):
        wait_all(procs, logs, deadline)
        got[(data, space)] = {
            "metrics": [json.loads((job_dir / f"train-{r}.json").read_text()) for r in range(size)],
            "states": [torch.load(job_dir / f"train-state-{r}.pt") for r in range(size)],
            "targets": [dict(np.load(job_dir / f"train-targets-{r}.npz")) for r in range(size)],
        }
    return {
        "got": got, "one": (one_metrics, one.state_dict(), one_targets),
        "jax": ({k: float(v) for k, v in jax.device_get(j_metrics).items()},
                jax.device_get(j_new.params)),
    }


def flat_params(state_dict: dict) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in state_dict.items() if not k.endswith(("running_mean",
                                                                          "running_var"))}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_spatial_step_matches_jax_single_device(runs, grid):
    """Every rank's metrics and parameters against the JAX single-device
    step: loss and grad_norm rtol 3e-5, parameters atol 3e-5."""
    want_metrics, want_params = runs["jax"]
    got = runs["got"][grid]
    seeded = seeded_model()
    want = {name: np.asarray(value) for name, value in zip(
        [n for n, _ in seeded.named_parameters()], _jax_leaves_in_port_order(seeded, want_params))}
    for metrics, state in zip(got["metrics"], got["states"]):
        for k in ("loss", "grad_norm", "cls_loss", "box_loss"):
            np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=3e-5, err_msg=k)
        assert metrics["num_pos"] == want_metrics["num_pos"]
        params = flat_params(state)
        for name, value in want.items():
            np.testing.assert_allclose(params[name], value, rtol=1e-5, atol=3e-5, err_msg=name)


def _jax_leaves_in_port_order(model: torch.nn.Module, params) -> list[np.ndarray]:
    """The JAX params, each in the port's layout, in the port's order."""
    out = []
    for name, p in model.named_parameters():
        *scope, leaf = name.split(".")
        node = params
        for key in scope:
            node = node[key]
        if leaf == "weight" and p.dim() == 4:
            out.append(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        else:
            out.append(np.asarray(node[{"weight": "scale"}.get(leaf, leaf)]))
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_spatial_step_matches_the_port_one_process_step(runs, grid):
    """The same math as the port's one-process step, summed in another
    order: loss and grad_norm within rtol 2e-6, parameters atol 2e-6; every
    rank holds the same parameters after the step; the matching and the
    focal kernels' wrappers ran once a rank (their plain versions here)."""
    one_metrics, one_state, _ = runs["one"]
    got = runs["got"][grid]
    first = flat_params(got["states"][0])
    for metrics, state in zip(got["metrics"], got["states"]):
        for k in ("loss", "grad_norm", "cls_loss", "box_loss", "param_norm"):
            np.testing.assert_allclose(metrics[k], one_metrics[k], rtol=2e-6, err_msg=k)
        assert metrics["num_pos"] == one_metrics["num_pos"]
        assert metrics["matching_plain_calls"] == 1 and metrics["focal_plain_calls"] == 1
        params = flat_params(state)
        for name, value in flat_params(one_state).items():
            np.testing.assert_allclose(params[name], value, rtol=0, atol=2e-6, err_msg=name)
            np.testing.assert_array_equal(params[name], first[name], err_msg=name)


def test_force_match_is_global_over_the_space_group(runs):
    """The ranks' targets joined by global anchor index equal the
    one-process targets exactly; the boundary tie went to rank 0's anchor
    (the lower global index) and the far gt's forced anchor is rank 1's."""
    _, _, one = runs["one"]
    for grid in GRIDS:
        data, space = grid
        ranks = runs["got"][grid]["targets"]
        for d in range(data):
            n = 4 // data
            group = ranks[d * space:(d + 1) * space]
            index = np.concatenate([r["index"] for r in group])
            for field in ("state", "matched_labels", "box_targets"):
                got = np.concatenate([r[field] for r in group], axis=1)
                want = getattr(one, field).numpy()[d * n:(d + 1) * n][:, index]
                np.testing.assert_array_equal(got, want, err_msg=f"{grid} {field}")
    group = runs["got"][(1, 2)]["targets"]
    positives = [r["index"][r["state"][0] == t_matching.POSITIVE] for r in group]
    assert len(positives[0]) == 1 and len(positives[1]) == 0  # the tie: rank 0's
    far = [r["index"][r["state"][1] == t_matching.POSITIVE] for r in group]
    assert len(far[0]) == 0 and len(far[1]) >= 1


def _port_refusal(model_config, hw, data, space, **allow) -> str | None:
    model = types.SimpleNamespace(config=model_config)
    try:
        t_step.check_spatial_config(model, hw, data, space, **allow)
    except ValueError as e:
        return str(e)
    return None


def _jax_refusal(model_config, hw, data, space, **allow) -> str | None:
    try:
        j_step.make_train_step_spatial(j_retinanet.build_retinanet(model_config), hw, 3,
                                       make_mesh_2d(data, space), **allow)
    except ValueError as e:
        return str(e)
    return None


def test_envelopes_equal_jax_on_a_grid():
    """The port's copies of the JAX envelope functions give the JAX
    package's answers on a grid of heights and shard counts."""
    for h in range(8, 1400, 8):
        for space in (1, 2, 3, 4, 8, 16, 32):
            assert (t_step._degenerate_strided_conv_heights(h, space)
                    == j_step._degenerate_strided_conv_heights(h, space)), (h, space)
            assert (t_step._data_axis_risky_stage_heights(h, space)
                    == j_step._data_axis_risky_stage_heights(h, space)), (h, space)
    assert t_step._SPATIAL_GRAD_VALIDATED_BACKBONES == j_step._SPATIAL_GRAD_VALIDATED_BACKBONES


@pytest.mark.parametrize("case,refused", [
    (dict(backbone="resnet_test", dtype="bf16", hw=(64, 64), grid=(1, 2)), True),
    (dict(backbone="resnet_test", dtype="bf16", hw=(64, 64), grid=(1, 2),
          allow={"allow_unvalidated_bf16": True}), False),
    (dict(backbone="resnet_test", dtype="f32", hw=(64, 64), grid=(1, 8)), True),
    (dict(backbone="resnet_test", dtype="f32", hw=(64, 64), grid=(1, 8),
          allow={"allow_degenerate_spatial_sharding": True}), False),
    (dict(backbone="resnet_test", dtype="f32", hw=(1024, 64), grid=(1, 8)), False),
    (dict(backbone="resnet50", dtype="f32", hw=(64, 64), grid=(2, 2)), True),
    (dict(backbone="resnet50", dtype="f32", hw=(64, 64), grid=(2, 2),
          allow={"allow_data_axis_divergence": True}), False),
    (dict(backbone="resnet50", dtype="f32", hw=(256, 64), grid=(2, 2)), False),
    (dict(backbone="resnet_test", dtype="f32", hw=(64, 64), grid=(2, 2)), False),
], ids=["bf16", "bf16-allowed", "degenerate", "degenerate-allowed", "outside-envelope",
        "data-axis", "data-axis-allowed", "data-axis-tall", "data-axis-validated"])
def test_factory_refusals_carry_the_jax_messages(case, refused):
    """The factory refuses (or accepts) what the JAX factory refuses (or
    accepts), with its message."""
    allow = case.get("allow", {})
    t_config = t_retinanet.RetinaNetConfig(
        **dict(MODEL, backbone=case["backbone"]),
        dtype=torch.bfloat16 if case["dtype"] == "bf16" else torch.float32)
    j_config = j_retinanet.RetinaNetConfig(
        **dict(MODEL, backbone=case["backbone"]),
        dtype=jnp.bfloat16 if case["dtype"] == "bf16" else jnp.float32)
    want = _jax_refusal(j_config, case["hw"], *case["grid"], **allow)
    assert (want is not None) == refused
    assert _port_refusal(t_config, case["hw"], *case["grid"], **allow) == want
