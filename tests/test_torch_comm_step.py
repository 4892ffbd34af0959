"""The port's gradient-communication flavors of the world step against the
JAX mesh step's, on the CPU: a world of 2 over gloo (child processes,
``tests/torch_comm_worker.py``) takes 3 steps of each flavor from the same
weights and global batch as the JAX ``make_train_step`` over 2 host
devices (``tests/torch_comm_harness.py``):

- int8 with error feedback against the JAX step with ``comm``;
- the same with ``overlap``, bit for bit the fused int8 run;
- ZeRO with int8 against the JAX step with ``shard_weight_update`` and
  ``comm``;
- ZeRO alone against the port's plain data-parallel world (the DDP step,
  itself held against the JAX mesh step in
  tests/test_torch_data_parallel.py).

Tolerances are ``tests/test_torch_data_parallel.py``'s: losses and norms
within rel 1e-4, each tensor within 3e-2 of how far the steps moved it;
the EF residual norm within rel 1e-3 (its bucket blocks see the gradients'
f32 rounding), the wire bytes equal.  A NaN image on one rank stops every
rank at the same step, and a comm step refuses a state built with other
flags.
"""


import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.comm import CommConfig as JCommConfig
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import variables_from_flax
from test_torch_data_parallel import METRICS, MOVED_RTOL, STEP_ARRAYS, seeded_model
from test_torch_train import GOLDEN, GOLDEN_OPT, HW, RTOL, flax_variables, golden_batch
from torch_comm_harness import World, jax_mesh_steps

DEADLINE_S = 300  # one deadline a world; generous under the tier's six workers
STEPS = 3
SMALL = dict(bucket_mb=0.02, min_bucket_bytes=1024)
INT8 = dict(compress="int8", **SMALL)
FLAVORS = {
    "int8": dict(comm=INT8),
    "overlap": dict(comm=dict(INT8, overlap=True)),
    "zero-int8": dict(comm=INT8, zero=True),
    "zero": dict(zero=True),
    "plain": {},
}


@pytest.fixture(scope="module")
def comm_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("comm_step")
    batch = golden_batch()
    np.savez(root / "batch.npz", **{k: getattr(batch, k) for k in STEP_ARRAYS})
    model = seeded_model("gn")
    torch.save(model.state_dict(), root / "weights.pt")
    base = dict(kind="train", model=dict(GOLDEN, norm_kind="gn"), hw=HW, opt=GOLDEN_OPT,
                weights=str(root / "weights.pt"), batch=str(root / "batch.npz"), steps=STEPS)
    cases = [dict(base, name=name, **flavor) for name, flavor in FLAVORS.items()]
    cases.append(dict(base, kind="nan", name="nan", comm=INT8))
    cases.append(dict(base, kind="refuse", name="refuse", comm=INT8))
    world = World(root / "world", cases, 2, DEADLINE_S)
    try:
        initial = flax_variables(model)
        jax_side = {
            "int8": jax_mesh_steps(GOLDEN, "gn", initial, GOLDEN_OPT, batch, STEPS, 2,
                                   comm=JCommConfig(**INT8)),
            "zero-int8": jax_mesh_steps(GOLDEN, "gn", initial, GOLDEN_OPT, batch, STEPS, 2,
                                        comm=JCommConfig(**INT8), zero=True),
        }
    except BaseException:
        world.kill()
        raise
    world.wait()
    yield world, initial, jax_side


def state_of(world, name: str) -> dict:
    return torch.load(world.dir / f"{name}-state.pt")


def assert_moved_within(got: dict, want: dict, start: dict) -> None:
    assert set(got) == set(want)
    for key, want_v in want.items():
        err = torch.linalg.vector_norm(got[key] - want_v)
        moved = torch.linalg.vector_norm(want_v - start[key])
        assert err <= MOVED_RTOL * moved + 1e-6 * torch.linalg.vector_norm(want_v), key


@pytest.mark.parametrize("name", ["int8", "zero-int8"])
def test_compressed_step_matches_jax_mesh_step(comm_world, name):
    """Three steps: every metric, the wire bytes, the EF residual norm and
    each parameter after the steps, against the JAX mesh step."""
    world, initial, jax_side = comm_world
    want, final = jax_side[name]
    ranks = world.json(name)
    got = ranks[0]["history"]
    for g, w in zip(got, want, strict=True):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        assert g["num_pos"] == w["num_pos"]
        assert g["comm_compressed_bytes"] == w["comm_compressed_bytes"]
        np.testing.assert_allclose(g["ef_residual_norm"], w["ef_residual_norm"], rtol=1e-3)
        assert 0 < g["ef_saturation"] < 0.01 and 0 < w["ef_saturation"] < 0.01
    assert ranks[1]["history"] == got
    start = variables_from_flax(*initial)
    assert_moved_within(state_of(world, name), variables_from_flax(final.params, final.batch_stats),
                        start)


def test_overlap_equals_fused_bit_for_bit(comm_world):
    """Each stage's reduce inside the backward: the same parameters, metrics
    and residuals as the fused reduce after it."""
    world, _, _ = comm_world
    fused, overlap = world.json("int8"), world.json("overlap")
    assert [r["digest"] for r in overlap] == [r["digest"] for r in fused]
    for f, o in zip(fused[0]["history"], overlap[0]["history"]):
        assert {k: v for k, v in o.items() if k != "replica_agreement"} == {
            k: v for k, v in f.items() if k != "replica_agreement"}
    for rank in range(2):
        a = torch.load(world.dir / f"int8-comm-{rank}.pt")
        b = torch.load(world.dir / f"overlap-comm-{rank}.pt")
        assert set(a) == set(b) and a
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_zero_without_compression_equals_exact_dp(comm_world):
    """ZeRO's exact reduce-scatter, sharded update and gather against the
    plain data-parallel world: metrics within rel 1e-4, parameters within
    3e-2 of their move."""
    world, initial, _ = comm_world
    zero, plain = world.json("zero")[0]["history"], world.json("plain")[0]["history"]
    for g, w in zip(zero, plain, strict=True):
        for key in METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=key)
        assert "ef_residual_norm" not in g
    assert_moved_within(state_of(world, "zero"), state_of(world, "plain"),
                        variables_from_flax(*initial))


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_ranks_stay_bit_identical(comm_world, name):
    """After three steps every rank holds the same parameters and has read
    the same metrics."""
    world, _, _ = comm_world
    ranks = world.json(name)
    assert len({r["digest"] for r in ranks}) == 1
    assert [r["step"] for r in ranks] == [STEPS, STEPS]
    assert ranks[0]["history"] == ranks[1]["history"]


def test_nan_on_one_rank_stops_every_rank_at_one_step(comm_world):
    """A NaN pixel on rank 1's second batch: its gradients poison their
    blocks' scales, and both ranks stop at step 2 on the loss."""
    world, _, _ = comm_world
    trips = [r["trip"] for r in world.json("nan")]
    assert trips == [{"step": 2, "metric": "loss"}] * 2


def test_a_state_built_with_other_flags_is_refused(comm_world):
    """The comm step takes only a state that ``create_train_state`` built
    with its own flags (which also gave every rank rank 0's weights)."""
    world, _, _ = comm_world
    for got in world.json("refuse"):
        assert len(got["messages"]) == 2
        assert all(m is not None and "not built for this step's communication" in m
                   for m in got["messages"])
