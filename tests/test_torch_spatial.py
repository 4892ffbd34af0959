"""Spatial partitioning in the port (``parallel/spatial.py``): each image's
H axis over the ranks of a space group, on the CPU.

One world of 4 gloo ranks (``tests/torch_spatial_worker.py``, child
processes meeting through a file store under the test's directory, one
deadline) runs, as a (1 x 4) and a (2 x 2) grid:

- every conv and pool geometry of the model family and both norms on row
  shards, forward and backward, against the same module on the whole map
  in this process: outputs and input gradients within rtol 1e-5 / atol
  1e-6 (a conv on a window of rows may sum in another order than on the
  whole map), the parameters' gradients summed over the ranks within rtol
  1e-5 and an atol of 2e-6 of the largest gradient entry (a weight
  gradient sums hundreds of products, its small entries cancel), and the
  max pools' outputs exactly (their gradients reach the same elements, an
  element under two windows across a boundary summing them in another
  order); heights where trailing ranks own no rows (3 over 4 ranks);
- ``make_detect_fn_spatial`` at S 2 and 4, at (128, 64) and (96, 64)
  (where P7 has one row, so ranks own none of it), against the port's
  ``make_detect_fn`` and the JAX ``make_detect_fn`` on the same weights,
  within the JAX tolerances of ``tests/distributed/test_spatial.py``; and
  for MobileNet, VGG-16 and DenseNet-121 against the port's one process.

In this process: ``stem_pool="avg"`` against the JAX model with the flax
tree copied in, and the JAX guards' messages.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.evaluate import detect as j_detect
from batchai_retinanet_horovod_coco_tpu.models import retinanet as j_retinanet
from batchai_retinanet_horovod_coco_tpu.ops import anchors as j_anchors
from batchai_retinanet_horovod_coco_tpu.train import state as j_state
from batchai_retinanet_horovod_coco_tpu_torch.evaluate import detect as t_detect
from batchai_retinanet_horovod_coco_tpu_torch.models import retinanet as t_retinanet
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as t_anchors
from batchai_retinanet_horovod_coco_tpu_torch.parallel import spatial
from test_torch_train import drop_tmp_path, flax_variables, one_torch_thread  # noqa: F401
from torch_comm_harness import start, wait_all
from torch_spatial_worker import OPS, build_op

WORKER = "tests/torch_spatial_worker.py"
WORLD = 4
DEADLINE_S = 120
SEED = 3
# (space size, heights): 13 and 9 rows leave the last rank short, 3 rows
# over 4 ranks leave it none.
OP_GRIDS = ((4, (13, 9, 3)), (2, (13, 3)))
WIDTH = 10
MODEL = dict(num_classes=3, backbone="resnet_test", fpn_channels=32, head_width=32, head_depth=1)
LOGIT_SCALE = 100.0
NMS = dict(score_threshold=0.001, iou_threshold=0.5, pre_nms_size=32, max_detections=32)
HWS = ((128, 64), (96, 64))
SPACES = (2, 4)
# The other families the JAX step accepts: depthwise SAME convs, VALID max
# pools, DenseNet's SAME stem pool and VALID average pools.
FAMILIES = ("mobilenet", "vgg16", "densenet121")
FAMILY_HW = (96, 64)


def op_input(name: str, h: int, rng) -> np.ndarray:
    rows = -(-h // 2) if name == "upsample" else h
    return rng.normal(0.0, 1.0, (2, 4, rows, WIDTH // 2 if name == "upsample" else WIDTH)
                      ).astype(np.float32)


def unsharded(name: str, x: np.ndarray, h: int):
    """The op on the whole map: (module, input, output)."""
    op = build_op(name, SEED)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = op(xt, torch.zeros((2, 4, h, WIDTH))) if name == "upsample" else op(xt)
    return op, xt, y


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results, and what this process computed."""
    root = tmp_path_factory.mktemp("spatial")
    rng = np.random.default_rng(0)
    inputs, want = {}, {}
    for name in OPS:
        for h in sorted({h for _, hs in OP_GRIDS for h in hs}):
            x = op_input(name, h, rng)
            op, xt, y = unsharded(name, x, h)
            cot = rng.normal(0.0, 1.0, tuple(y.shape)).astype(np.float32)
            (y * torch.from_numpy(cot)).sum().backward()
            inputs[f"{name}-{h}-x"], inputs[f"{name}-{h}-cot"] = x, cot
            want[(name, h)] = {"y": y.detach().numpy(), "gx": xt.grad.numpy(),
                               **{f"g-{n}": p.grad.numpy() for n, p in op.named_parameters()},
                               **{f"b-{n}": b.numpy() for n, b in op.named_buffers()}}
    np.savez(root / "inputs.npz", **inputs)
    model = t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**MODEL, dtype=torch.float32), device="cpu", seed=7)
    with torch.no_grad():
        model.cls_head.logits.weight.mul_(LOGIT_SCALE)
    torch.save(model.state_dict(), root / "weights.pt")
    images = {f"{h}x{w}": np.random.default_rng(h).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
              for h, w in HWS}
    np.savez(root / "images.npz", **images)
    cases = [{"kind": "ops", "name": f"ops-s{space}", "space": space, "heights": list(hs),
              "ops": list(OPS), "inputs": str(root / "inputs.npz"), "seed": SEED}
             for space, hs in OP_GRIDS]
    cases.append({"kind": "detect", "name": "detect", "model": MODEL,
                  "weights": str(root / "weights.pt"), "images": str(root / "images.npz"),
                  "detect": NMS, "spaces": list(SPACES), "hws": [list(hw) for hw in HWS],
                  "families": list(FAMILIES), "family_hw": list(FAMILY_HW), "family_space": 4})
    job = root / "job.json"
    job.write_text(__import__("json").dumps({"cases": cases}))
    logs = [root / f"rank{r}.log" for r in range(WORLD)]
    procs = [start(["python", WORKER, str(job), str(r), str(WORLD), str(root / "store")], log)
             for r, log in enumerate(logs)]
    wait_all(procs, logs, time.monotonic() + DEADLINE_S)
    got = {case["name"]: [dict(np.load(root / f"{case['name']}-{r}.npz")) for r in range(WORLD)]
           for case in cases}
    return {"got": got, "want": want, "model": model, "images": images}


def joined(ranks: list[dict], key: str, space: int, axis: int) -> np.ndarray:
    """The data groups' row shards joined in rank order (rows), then the
    groups in data order (images)."""
    groups = [np.concatenate([ranks[d * space + s][key] for s in range(space)], axis=axis)
              for d in range(WORLD // space)]
    return np.concatenate(groups, axis=0)


@pytest.mark.parametrize("name", list(OPS))
def test_row_exchange_matches_the_whole_map(world, name):
    """The op on row shards (through the exchange and its backward, or the
    norms' group sums) equals the op on the whole map, forward and
    backward, on every grid and height; a max pool's output bit for bit."""
    exact = name.startswith(("maxpool", "stempool-max"))
    for space, heights in OP_GRIDS:
        ranks = world["got"][f"ops-s{space}"]
        for h in heights:
            key, want = f"{name}-{h}", world["want"][(name, h)]
            for part in ("y", "gx"):
                got = joined(ranks, f"{key}-{part}", space, 2)
                if exact and part == "y":
                    np.testing.assert_array_equal(got, want[part], err_msg=f"{key} s{space} {part}")
                else:
                    np.testing.assert_allclose(got, want[part], rtol=1e-5, atol=1e-6,
                                               err_msg=f"{key} s{space} {part}")
            for part in [k for k in want if k.startswith("g-")]:
                got = sum(r[f"{key}-{part}"] for r in ranks)
                atol = 2e-6 * float(np.abs(want[part]).max())
                np.testing.assert_allclose(got, want[part], rtol=1e-5, atol=atol,
                                           err_msg=f"{key} s{space} {part}")
            for part in [k for k in want if k.startswith("b-")]:
                for r in ranks:  # every rank the same running statistics
                    np.testing.assert_allclose(r[f"{key}-{part}"], want[part], rtol=1e-5,
                                               atol=1e-6, err_msg=f"{key} s{space} {part}")


def test_ranks_that_own_no_rows_take_part(world):
    """At 3 rows over 4 ranks the last rank owns no input rows and, after
    a stride-2 op, ranks 2 and 3 no output rows: their shards are empty,
    and the whole still matches (the collectives ran on every rank)."""
    ranks = world["got"]["ops-s4"]
    assert ranks[3]["conv3x3s1-same-3-gx"].shape[2] == 0
    assert [r["conv3x3s2-same-3-y"].shape[2] for r in ranks] == [1, 1, 0, 0]
    assert [r["groupnorm-3-y"].shape[2] for r in ranks] == [1, 1, 1, 0]


def test_rows_of_is_the_gspmd_split():
    """Rank s owns [s*c, min((s+1)*c, h)) with c = ceil(h/S); a rank's
    anchors are the global anchors of its rows, level by level, and the
    ranks' anchors together are every anchor once."""
    for h in range(0, 40):
        for size in (1, 2, 3, 4, 8):
            spans = [spatial.rows_of(h, size, s) for s in range(size)]
            assert spans[0][0] == 0 and spans[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all(stop - start in (0, -(-h // size)) or stop == h for start, stop in spans)
    config = t_anchors.AnchorConfig()
    for hw in HWS:
        full = j_anchors.anchors_for_image_shape(hw)
        for size in SPACES:
            parts = [t_anchors.anchors_for_rows(hw, config, size, s) for s in range(size)]
            index = np.concatenate([p[1] for p in parts])
            np.testing.assert_array_equal(np.sort(index), np.arange(len(full)))
            for anchors, idx in parts:
                assert np.all(np.diff(idx) > 0)
                np.testing.assert_array_equal(anchors, full[idx])


_JAX_DETECTIONS: dict = {}


def jax_detections(model: torch.nn.Module, hw, images: np.ndarray):
    """The JAX ``make_detect_fn``'s detections, once a bucket."""
    if hw not in _JAX_DETECTIONS:
        _JAX_DETECTIONS[hw] = _jax_detections(model, hw, images)
    return _JAX_DETECTIONS[hw]


def _jax_detections(model: torch.nn.Module, hw, images: np.ndarray):
    j_model = j_retinanet.build_retinanet(
        j_retinanet.RetinaNetConfig(**MODEL, stem="conv", dtype=jnp.float32))
    params, stats = (jax.tree.map(jnp.asarray, t) for t in flax_variables(model))
    state = j_state.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               opt_state=(), tx=optax.sgd(0.1))
    config = j_detect.DetectConfig(**NMS)
    return jax.device_get(j_detect.make_detect_fn(j_model, hw, config)(state, images))


@pytest.mark.parametrize("space", SPACES)
@pytest.mark.parametrize("hw", HWS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_spatial_detection_matches_one_process_and_jax(world, space, hw):
    """Every rank's detections equal the port's one-process
    ``make_detect_fn`` and the JAX ``make_detect_fn`` on the same weights:
    ``valid`` and ``labels`` exactly, scores within rtol 1e-5 / atol 1e-6
    and boxes within rtol 1e-4 / atol 1e-3 (the JAX spatial test's
    bounds); NMS ran on every rank (replicated)."""
    key = f"{hw[0]}x{hw[1]}"
    images = world["images"][key]
    one = t_detect.make_detect_fn(world["model"], hw, t_detect.DetectConfig(**NMS), device="cpu")(
        images)
    want_jax = jax_detections(world["model"], hw, images)
    assert one.valid.numpy().sum() > 0
    for rank in world["got"]["detect"]:
        got = {f: rank[f"{space}-{key}-{f}"] for f in ("boxes", "scores", "labels", "valid")}
        for want in ({f: getattr(one, f).numpy() for f in got},
                     {f: np.asarray(getattr(want_jax, f)) for f in got}):
            np.testing.assert_array_equal(got["valid"], want["valid"])
            np.testing.assert_array_equal(got["labels"], want["labels"])
            np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4, atol=1e-3)
        assert int(rank["nms_plain_calls"]) == len(SPACES) * len(HWS)


@pytest.mark.parametrize("backbone", FAMILIES)
def test_spatial_detection_of_every_family(world, backbone):
    """MobileNet, VGG-16 and DenseNet-121 (seeded, GroupNorm where they
    have norms) over 4 ranks at (96, 64), where P7's one row leaves three
    ranks none: every rank's detections equal the one-process
    ``make_detect_fn``'s within the bounds above."""
    model = t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(
        **dict(MODEL, backbone=backbone), dtype=torch.float32), device="cpu", seed=1)
    images = world["images"][f"{FAMILY_HW[0]}x{FAMILY_HW[1]}"]
    want = t_detect.make_detect_fn(model, FAMILY_HW, t_detect.DetectConfig(**NMS),
                                   device="cpu")(images)
    assert want.valid.numpy().sum() > 0
    for rank in world["got"]["detect"]:
        np.testing.assert_array_equal(rank[f"{backbone}-valid"], want.valid.numpy())
        np.testing.assert_array_equal(rank[f"{backbone}-labels"], want.labels.numpy())
        np.testing.assert_allclose(rank[f"{backbone}-scores"], want.scores.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(rank[f"{backbone}-boxes"], want.boxes.numpy(), rtol=1e-4,
                                   atol=1e-3)


def test_stem_pool_avg_matches_jax():
    """``stem_pool="avg"`` (flax's ``avg_pool``, pads in the divisor)
    against the JAX model with the port's weights copied in."""
    config = dict(MODEL, stem="conv", stem_pool="avg")
    model = t_retinanet.build_retinanet(
        t_retinanet.RetinaNetConfig(**config, dtype=torch.float32), device="cpu", seed=5)
    x = np.random.default_rng(1).normal(0.0, 1.0, (1, 64, 48, 3)).astype(np.float32)
    j_model = j_retinanet.build_retinanet(j_retinanet.RetinaNetConfig(**config, dtype=jnp.float32))
    params = jax.tree.map(jnp.asarray, flax_variables(model)[0])
    want = jax.device_get(jax.jit(lambda p, x: j_model.apply({"params": p}, x))(params, x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ("cls_logits", "box_deltas"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        assert not torch.equal(t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(
            **MODEL, stem="conv", dtype=torch.float32), device="cpu", seed=5)(
                torch.from_numpy(x))["box_deltas"], got["box_deltas"])


@pytest.mark.parametrize("config", [
    dict(stem="conv", stem_pool="median"),
    dict(stem="space_to_depth", stem_pool="avg"),
    dict(backbone="vgg16", stem_pool="avg"),
], ids=["unknown", "packed-stem", "not-resnet"])
def test_stem_pool_guards_carry_the_jax_messages(config):
    model_config = dict(MODEL, **config)
    with pytest.raises(ValueError) as want:
        j_model = j_retinanet.build_retinanet(
            j_retinanet.RetinaNetConfig(**model_config, dtype=jnp.float32))
        jax.eval_shape(j_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    with pytest.raises(ValueError) as got:
        t_retinanet.build_retinanet(t_retinanet.RetinaNetConfig(**model_config), device="cpu")
    assert str(got.value) == str(want.value)
