"""Checkpoints of the port's gradient-communication flavors, on the CPU:
the ZeRO optimizer layout and the EF residuals (``comm_state``) saved by a
world of 2 restore in worlds of 1 and 4 and in the JAX package, and a JAX
ZeRO+int8 checkpoint restores in the port; residuals that are missing, or
whose buckets changed, reset with one ``ef_reset`` line.

Worlds are child processes (``tests/torch_comm_worker.py``) over gloo,
meeting through a file store, under one deadline each.  Every restored
optimizer slot and residual equals the saved one re-laid into the new
world's layout (``parallel/zero.py::reshard_flat_leaf``), exactly.
"""

import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.comm import CommConfig as JCommConfig
from batchai_retinanet_horovod_coco_tpu.parallel import make_mesh
from batchai_retinanet_horovod_coco_tpu.parallel.zero import reshard_flat_leaf as j_reshard
from batchai_retinanet_horovod_coco_tpu.utils import checkpoint as j_ckpt
from batchai_retinanet_horovod_coco_tpu_torch.utils import checkpoint as t_ckpt
from test_torch_data_parallel import STEP_ARRAYS, seeded_model
from test_torch_train import GOLDEN, GOLDEN_OPT, HW, flax_variables, golden_batch
from torch_comm_harness import World, jax_mesh_steps, jax_state

DEADLINE_S = 300  # one deadline a world; generous under the tier's six workers
SMALL = dict(bucket_mb=0.02, min_bucket_bytes=1024)
INT8 = dict(compress="int8", **SMALL)


def manifest_layout(directory: str) -> tuple:
    manifest = t_ckpt.read_manifest(directory)
    return manifest["zero_world_size"], [(e["path"], e["shape"], e["dtype"])
                                         for e in manifest["leaves"]]


def saved_leaves(directory: str) -> dict:
    _, path, manifest = t_ckpt.CheckpointManager(directory)._target(None)
    return t_ckpt._load_leaves(path, manifest)


@pytest.fixture(scope="module")
def ckpt_worlds(tmp_path_factory):
    """A world of 2 saves ZeRO+int8, int8 and plain checkpoints and
    restores the int8 one under another bucket size and the plain one under
    int8; the JAX package saves ZeRO+int8 from its mesh step over 2
    devices; then a world of 1 restores the port's ZeRO+int8 checkpoint and
    a world of 4 restores it and the JAX one."""
    root = tmp_path_factory.mktemp("comm_ckpt")
    batch = golden_batch()
    np.savez(root / "batch.npz", **{k: getattr(batch, k) for k in STEP_ARRAYS})
    model = seeded_model("gn")
    torch.save(model.state_dict(), root / "weights.pt")
    base = dict(model=dict(GOLDEN, norm_kind="gn"), hw=HW, opt=GOLDEN_OPT,
                weights=str(root / "weights.pt"), batch=str(root / "batch.npz"))
    dirs = {name: str(root / name) for name in ("zero-int8", "int8", "plain", "jax")}
    first = World(root / "world2", [
        dict(base, kind="train", name="zero-int8", comm=INT8, zero=True, steps=2,
             save=dirs["zero-int8"]),
        dict(base, kind="train", name="int8", comm=INT8, steps=2, save=dirs["int8"]),
        dict(base, kind="train", name="plain", steps=2, save=dirs["plain"]),
        dict(base, kind="restore", name="rebucketed", comm=dict(INT8, bucket_mb=0.05),
             dir=dirs["int8"]),
        dict(base, kind="restore", name="missing", comm=INT8, dir=dirs["plain"]),
    ], 2, DEADLINE_S)
    try:
        _, jax_final = jax_mesh_steps(GOLDEN, "gn", flax_variables(model), GOLDEN_OPT, batch, 2, 2,
                                      comm=JCommConfig(**INT8), zero=True)
        manager = j_ckpt.CheckpointManager(dirs["jax"], async_save=False)
        manager.save(jax_final, step=2)
        manager.close()
    except BaseException:
        first.kill()
        raise
    first.wait()
    restore = dict(base, kind="restore", comm=INT8, zero=True)
    worlds = {4: World(root / "world4", [dict(restore, name="zero-int8", dir=dirs["zero-int8"]),
                                         dict(restore, name="jax", dir=dirs["jax"])], 4, DEADLINE_S)}
    try:
        # The JAX package restores the port's checkpoint into a world-4 template.
        template = jax_state(flax_variables(model), GOLDEN_OPT, make_mesh(4), JCommConfig(**INT8),
                             zero=True)
        jax_restored = j_ckpt.CheckpointManager(dirs["zero-int8"]).restore(template)
    except BaseException:
        worlds[4].kill()
        raise
    worlds[4].wait()
    # After the world of 4: at most four ranks beside the tier's workers.
    worlds[1] = World(root / "world1", [dict(restore, name="zero-int8", dir=dirs["zero-int8"])],
                      1, DEADLINE_S)
    worlds[1].wait()
    yield dict(root=root, dirs=dirs, first=first, worlds=worlds, jax_restored=jax_restored)


def assert_relaid(restored: dict, saved: dict) -> None:
    """Every leaf of ``restored`` is ``saved``'s, re-laid into its shape."""
    assert set(restored) == set(saved)
    for path, arr in restored.items():
        np.testing.assert_array_equal(arr, j_reshard(saved[path], arr.shape, arr.dtype, path),
                                      err_msg=path)


def test_port_manifest_is_the_jax_package_s(ckpt_worlds):
    """The same leaves, shapes and dtypes, in the same order, and
    ``zero_world_size`` 2, as the JAX package's ZeRO+int8 checkpoint."""
    dirs = ckpt_worlds["dirs"]
    port, jax_side = manifest_layout(dirs["zero-int8"]), manifest_layout(dirs["jax"])
    assert port == jax_side and port[0] == 2
    assert any(p.startswith("['comm_state']") for p, _, _ in port[1])
    assert manifest_layout(dirs["int8"])[0] is None  # DP: the optimizer stays replicated


@pytest.mark.parametrize("size,source", [(1, "zero-int8"), (4, "zero-int8"), (4, "jax")])
def test_zero_int8_restores_at_another_world_size(ckpt_worlds, size, source):
    """Every rank restores step 2 with the optimizer slots and residuals
    re-laid for its world, the ranks' parameters equal, and takes a step."""
    world = ckpt_worlds["worlds"][size]
    name = "jax" if source == "jax" else "zero-int8"
    ranks = world.json(name)
    assert [r["restored"] for r in ranks] == [2] * size
    assert len({r["digest"] for r in ranks}) == 1 and np.isfinite(ranks[0]["loss"])
    assert all(r["resets"] == [] for r in ranks)
    restored = dict(np.load(world.dir / f"{name}-leaves.npz"))
    assert_relaid(restored, saved_leaves(ckpt_worlds["dirs"][source]))
    assert any(k.startswith("['comm_state']") and v.any() for k, v in restored.items())


def test_the_jax_package_restores_the_port_s(ckpt_worlds):
    """The JAX package's restore of the port's world-2 checkpoint into a
    world-4 template keeps every residual and optimizer slot."""
    import jax

    restored = ckpt_worlds["jax_restored"]
    saved = saved_leaves(ckpt_worlds["dirs"]["zero-int8"])
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"comm_state": restored.comm_state, "opt_state": restored.opt_state})
    checked = 0
    for path, arr in flat:
        key = jax.tree_util.keystr(path)
        arr = np.asarray(arr)
        np.testing.assert_array_equal(arr, j_reshard(saved[key], arr.shape, arr.dtype, key))
        checked += key.startswith("['comm_state']")
    assert checked == len([k for k in saved if k.startswith("['comm_state']")]) > 0


def test_missing_or_rebucketed_residuals_reset_with_one_line(ckpt_worlds):
    """A plain checkpoint restored under int8: every residual zeroed.  An
    int8 checkpoint restored under another bucket size: the residuals the
    new plan lacks dropped, the ones it adds or resizes zeroed.  One
    ``ef_reset`` line each, from rank 0."""
    first = ckpt_worlds["first"]
    missing = first.json("missing")
    assert [len(r["resets"]) for r in missing] == [1, 0]
    line = missing[0]["resets"][0]
    assert (line["zeroed"], line["dropped"]) == (len(missing[0]["comm_keys"]), 0)
    rebucketed = first.json("rebucketed")
    assert [len(r["resets"]) for r in rebucketed] == [1, 0]
    saved = {k for k in saved_leaves(ckpt_worlds["dirs"]["int8"]) if k.startswith("['comm_state']")}
    now = {f"['comm_state'][{k!r}]" for k in rebucketed[0]["comm_keys"]}
    line = rebucketed[0]["resets"][0]
    assert line["dropped"] == len(saved - now) > 0
    assert line["zeroed"] >= len(now - saved)
    assert all(np.isfinite(r["loss"]) for r in missing + rebucketed)


def test_residual_free_restore_of_a_world_checkpoint(ckpt_worlds, tmp_path, capfd):
    """One process without compression restores the ZeRO+int8 checkpoint:
    the momentum re-laid into the parameters' shapes, the residuals dropped
    with one ``ef_reset`` line."""
    from batchai_retinanet_horovod_coco_tpu_torch.train import optim as t_optim
    from batchai_retinanet_horovod_coco_tpu_torch.train import state as t_state

    state = t_state.create_train_state(seeded_model("gn"), t_optim.OptimizerConfig(**GOLDEN_OPT),
                                       device="cpu")
    t_ckpt.CheckpointManager(ckpt_worlds["dirs"]["zero-int8"]).restore(state)
    assert state.step == 2
    saved = saved_leaves(ckpt_worlds["dirs"]["zero-int8"])
    got = dict(t_state.snapshot(state))
    assert_relaid({k: v for k, v in got.items() if k.startswith("['opt_state']")},
                  {k: v for k, v in saved.items() if k.startswith("['opt_state']")})
    err = capfd.readouterr().err
    assert err.count('"event": "ef_reset"') == 1
