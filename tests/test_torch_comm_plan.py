"""The port's gradient-communication subsystem without a world, against the
JAX package: the policy (``comm/config.py``), the plan and its bytes on the
wire, the EF state's layout, the quantizer, the topology, the stage
grouping of the overlap, and the telemetry and SLO rule of the EF health.

The plan is built over the ResNet test model's leaves (the port's, under
their flax paths, ``models/convert.py::flax_params``) and over the flax
tree of the same weights; the quantizer runs on seeded inputs with an
outlier block, an all-zero block and blocks holding an Inf and a NaN.  All
comparisons are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batchai_retinanet_horovod_coco_tpu.comm import compress as j_compress
from batchai_retinanet_horovod_coco_tpu.comm import config as j_config
from batchai_retinanet_horovod_coco_tpu.comm import overlap as j_overlap
from batchai_retinanet_horovod_coco_tpu.obs import slo as j_slo
from batchai_retinanet_horovod_coco_tpu.parallel import mesh as j_mesh
from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as t_compress
from batchai_retinanet_horovod_coco_tpu_torch.comm import config as t_config
from batchai_retinanet_horovod_coco_tpu_torch.comm import overlap as t_overlap
from batchai_retinanet_horovod_coco_tpu_torch.models.convert import flax_params, to_flax
from batchai_retinanet_horovod_coco_tpu_torch.obs import slo as t_slo
from batchai_retinanet_horovod_coco_tpu_torch.obs import telemetry as t_telemetry
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh as t_mesh
from test_torch_train import flax_variables, small_model

# Policies over the test model: small buckets so that every stage has
# several, exact ones below min_bucket_bytes among them.
POLICIES = {
    "int8": dict(compress="int8", bucket_mb=0.01, min_bucket_bytes=1024),
    "bf16": dict(compress="bf16", bucket_mb=0.05),
    "stage-modes": dict(compress="int8", stage_modes=(("heads", "bf16"), ("fpn", "none")),
                        bucket_mb=0.02, min_bucket_bytes=0),
    "no-ef": dict(compress="int8", error_feedback=False, bucket_mb=0.03),
    "default": dict(compress="int8"),
    "overlap-only": dict(overlap=True),
    "hop": dict(compress="int8", dcn_bucket_mb=0.02, min_bucket_bytes=1024),
    "dcn-bf16": dict(compress="int8", dcn_mode="bf16", bucket_mb=0.01),
}
TOPOLOGIES = [None, (1, 4), (2, 2), (2, 4), (4, 2)]


@pytest.fixture(scope="module")
def trees():
    """(the port's {path: flax-layout tensor}, the flax params tree) of one
    set of weights."""
    model = small_model("gn", seed=0)
    params, _ = flax_variables(model)
    return {path: to_flax(p.detach()) for _, path, p in flax_params(model)}, params


def topology(pair, package):
    if pair is None:
        return None
    cls = t_mesh.CommTopology if package == "port" else j_mesh.CommTopology
    return cls(*pair)


def test_leaves_follow_the_flax_flatten_order(trees):
    port, params = trees
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    assert list(port) == [jax.tree_util.keystr(p) for p, _ in flat]
    assert all(tuple(t.shape) == np.shape(leaf) for t, (_, leaf) in zip(port.values(), flat))


@pytest.mark.parametrize("pair", TOPOLOGIES, ids=str)
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_plan_and_bytes_equal_jax(trees, name, pair):
    """The buckets (stage, index, mode, leaf paths, offsets, shapes), and
    every byte count at n in {1, 2, 4, 8}, per hop where a topology is
    given."""
    port, params = trees
    t_cfg, j_cfg = t_config.CommConfig(**POLICIES[name]), j_config.CommConfig(**POLICIES[name])
    t_topo, j_topo = topology(pair, "port"), topology(pair, "jax")
    got = t_compress.plan_buckets(port, t_cfg, t_topo)
    want = j_compress.plan_buckets(params, j_cfg, j_topo)
    assert [dataclasses.asdict(b) for b in got.buckets] == [dataclasses.asdict(b) for b in want.buckets]
    assert got.stages == want.stages and len(got.buckets) > 1
    for n in (1, 2, 4, 8):
        assert got.exact_bytes(n) == want.exact_bytes(n)
        assert got.compressed_bytes(n) == want.compressed_bytes(n)
        for zero in (False, True):
            assert got.quant_elems(n, zero=zero) == want.quant_elems(n, zero=zero)
    if t_topo is not None:
        assert got.quant_elems(t_topo.num_devices, topology=t_topo) == want.quant_elems(
            j_topo.num_devices, topology=j_topo)
        assert got.hop_bytes(t_topo) == want.hop_bytes(j_topo)
        assert got.hop_bytes_exact(t_topo) == want.hop_bytes_exact(j_topo)
        assert got.hop_quant_bytes(t_topo) == want.hop_quant_bytes(j_topo)


@pytest.mark.parametrize("pair", [None, (2, 2), (2, 4)], ids=str)
@pytest.mark.parametrize("name", sorted(POLICIES))
def test_init_comm_state_equals_jax(trees, name, pair):
    """The EF state's keys and shapes: per bucket (DP), per leaf (ZeRO),
    per cross-slice bucket (hierarchical), at each world size."""
    port, params = trees
    t_cfg, j_cfg = t_config.CommConfig(**POLICIES[name]), j_config.CommConfig(**POLICIES[name])
    for n in ([1, 2, 4, 8] if pair is None else [pair[0] * pair[1]]):
        for zero in (False, True):
            got = t_compress.init_comm_state(port, t_cfg, n, zero=zero,
                                             topology=topology(pair, "port"))
            want = j_compress.init_comm_state(params, j_cfg, n, zero=zero,
                                              topology=topology(pair, "jax"))
            assert list(got) == list(want)
            assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
                k: (v.shape, v.dtype) for k, v in want.items()}


def quantizer_inputs(seed: int, block: int) -> np.ndarray:
    """Eight blocks and a ragged tail: random, an outlier, all zero, an
    Inf, a NaN, a -Inf, tiny values, values on the rounding midpoints."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(8 * block + block // 3).astype(np.float32)
    x[block + 7] = 3e4  # an outlier block
    x[2 * block:3 * block] = 0.0
    x[3 * block + 5] = np.inf
    x[4 * block + 9] = np.nan
    x[5 * block + 1] = -np.inf
    x[6 * block:7 * block] *= 1e-30
    x[7 * block:8 * block] = (np.arange(block) - block // 2 + 0.5).astype(np.float32)
    return x


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantizer_equals_jax_bit_for_bit(mode, seed):
    """Payload, scales, dequantized values and saturated count, bit for
    bit against the compiled JAX quantizer: the non-finite blocks get a NaN
    scale and their int8 payload is 0 (XLA's conversion of a NaN; the port
    converts it explicitly)."""
    block = 512
    x = quantizer_inputs(seed, block)
    got, got_deq, got_sat = t_compress._quantize_shard(torch.from_numpy(x), mode, block)
    # Jitted, as the JAX step runs it: XLA turns the scale's division by
    # 127 into a multiply by the f32 reciprocal.
    want, want_deq, want_sat = jax.jit(lambda a: j_compress._quantize_shard(a, mode, block))(
        jnp.asarray(x))
    np.testing.assert_array_equal(got_deq.numpy(), np.asarray(want_deq))
    assert float(got_sat) == float(want_sat)
    if mode == "bf16":
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        return
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.isnan(got[1].numpy()[[3, 4, 5]]).all() and np.isfinite(got[1].numpy()[[0, 1, 2, 6, 7]]).all()
    # The gathered payload of two ranks → the full flat, as the JAX package's.
    q2, s2 = torch.stack([got[0], got[0]]), torch.stack([got[1], got[1]])
    np.testing.assert_array_equal(
        t_compress._dequantize_gathered((q2, s2), mode, x.size, 2).numpy(),
        np.asarray(j_compress._dequantize_gathered(
            (jnp.asarray(q2.numpy()), jnp.asarray(s2.numpy())), mode, x.size, 2)))


BAD_CONFIGS = [
    dict(compress="int4"),
    dict(stage_modes=(("neck", "int8"),)),
    dict(stage_modes=(("heads", "fp8"),)),
    dict(bucket_mb=0),
    dict(block=0),
    dict(ici_mode="int4"),
    dict(dcn_bucket_mb=-1.0),
    dict(compress="int8", ici_mode="bf16"),
    dict(ici_mode="int8", dcn_mode="bf16"),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS, ids=lambda k: ",".join(k))
def test_config_refusals_are_jax_s(kwargs):
    with pytest.raises(ValueError) as want:
        j_config.CommConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        t_config.CommConfig(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pair", TOPOLOGIES, ids=str)
def test_config_resolution_equals_jax(pair):
    """``enabled``, ``needs_state``, the hop modes, whether the hierarchy
    engages and the flat equivalent it degenerates to."""
    for kwargs in [*POLICIES.values(), dict(dcn_mode="int8"), dict(compress="bf16", ici_mode="bf16")]:
        t_cfg, j_cfg = t_config.CommConfig(**kwargs), j_config.CommConfig(**kwargs)
        for attr in ("enabled", "needs_state", "effective_ici_mode", "effective_dcn_mode",
                     "bucket_elems", "dcn_bucket_elems"):
            assert getattr(t_cfg, attr) == getattr(j_cfg, attr), (kwargs, attr)
        t_topo, j_topo = topology(pair, "port"), topology(pair, "jax")
        assert t_cfg.hierarchical_with(t_topo) == j_cfg.hierarchical_with(j_topo)
        assert dataclasses.asdict(t_cfg.flat_equivalent(t_topo)) == dataclasses.asdict(
            j_cfg.flat_equivalent(j_topo))
    assert t_config.STAGES == j_config.STAGES and t_config.COMPRESS_MODES == j_config.COMPRESS_MODES


@pytest.mark.parametrize("pair", [(1, 4), (2, 2), (2, 4), (4, 2), (3, 1)], ids=str)
def test_topology_groups_and_positions(pair):
    """The groups of mesh positions are the JAX package's, and the
    position of the rank ``node * L + local`` is ``local * S + node``: each
    of its two groups, listed in the torch group's (ascending rank) order,
    gives the positions in the JAX group's order."""
    got, want = t_mesh.CommTopology(*pair), j_mesh.CommTopology(*pair)
    assert got.ici_groups() == want.ici_groups() and got.dcn_groups() == want.dcn_groups()
    S, L = pair
    for rank in range(S * L):
        node, local = divmod(rank, L)
        assert got.position(rank) == local * S + node
        assert got.rank_at(got.position(rank)) == rank
    for s, group in enumerate(got.ici_groups()):
        assert [got.position(s * L + r) for r in range(L)] == group
    for r, group in enumerate(got.dcn_groups()):
        assert [got.position(s * L + r) for s in range(S)] == group


def test_derive_topology():
    """``--comm-slices`` first, then ``RETINANET_COMM_SLICES``, then the
    hosts of a torchrun world (``LOCAL_WORLD_SIZE``); one host is flat."""
    derive = t_mesh.derive_topology
    assert derive(4, 2, environ={}) == t_mesh.CommTopology(2, 2)
    assert derive(4, None, environ={t_mesh.COMM_SLICES_ENV: "4"}) == t_mesh.CommTopology(4, 1)
    assert derive(8, None, environ={"LOCAL_WORLD_SIZE": "4"}) == t_mesh.CommTopology(2, 4)
    assert derive(8, 4, environ={"LOCAL_WORLD_SIZE": "4"}) == t_mesh.CommTopology(4, 2)
    assert derive(4, None, environ={"LOCAL_WORLD_SIZE": "4"}) is None
    assert derive(4, None, environ={}) is None
    assert dataclasses.asdict(derive(4, 1, environ={})) == dataclasses.asdict(j_mesh.derive_topology(4, 1))
    with pytest.raises(ValueError, match="do not divide into 3 equal slices"):
        derive(4, 3, environ={})
    with pytest.raises(ValueError, match="must be an integer slice count"):
        derive(4, None, environ={t_mesh.COMM_SLICES_ENV: "two"})
    with pytest.raises(ValueError, match="comm slices must be >= 1"):
        derive(4, 0, environ={})


def test_group_tree_splits_by_stage_and_merges_back(trees):
    """Each stage holds the leaves of the JAX grouping's top-level keys."""
    port, params = trees
    groups = t_overlap.group_tree(port)
    want = j_overlap.group_tree(params, None)  # the JAX grouping ignores its plan
    assert set(groups) == set(want) == {"backbone", "fpn", "heads"}
    for stage, sub in groups.items():
        assert {t_compress._top_key(path) for path in sub} == set(want[stage])
    merged = t_overlap.merge_groups(port, groups)
    assert list(merged) == list(port) and all(merged[k] is port[k] for k in port)


def test_record_comm_feeds_gauges_and_counters():
    t_telemetry.reset()
    t_telemetry.enable()
    try:
        t_telemetry.record_comm(ef_residual=0.25, ef_saturation=0.01, compressed_bytes=1000.0,
                                ici_bytes=300.0, dcn_bytes=700.0, ef_residual_dcn=0.5, steps=20)
        snap = t_telemetry.default().snapshot()
        assert snap["train_ef_residual"] == 0.25
        assert snap["train_ef_saturation"] == 0.01
        assert snap["train_comm_compressed_bytes_total"] == 20000.0
        assert snap["train_comm_ici_bytes_total"] == 6000.0
        assert snap["train_comm_dcn_bytes_total"] == 14000.0
        assert snap["train_ef_residual_dcn"] == 0.5
        t_telemetry.record_comm(ef_residual=float("nan"), compressed_bytes=float("inf"))
        assert t_telemetry.default().snapshot()["train_ef_residual"] == 0.25
        t_telemetry.reset()  # disabled: one bool check, nothing recorded
        t_telemetry.record_comm(ef_residual=9.9, compressed_bytes=1.0)
        assert "train_ef_residual" not in t_telemetry.default().snapshot()
    finally:
        t_telemetry.reset()


@pytest.mark.parametrize("hop", [None, "dcn"])
def test_ef_residual_spike_fires_once_and_is_jax_s(hop):
    assert dataclasses.asdict(t_slo.ef_residual_spike(hop=hop)) == dataclasses.asdict(
        j_slo.ef_residual_spike(hop=hop))
    t_telemetry.enable()
    try:
        registry = t_telemetry.Registry()
        gauge = registry.gauge("train_ef_residual" + (f"_{hop}" if hop else ""), "test")
        monitor = t_slo.SloMonitor(registry, [t_slo.ef_residual_spike(factor=10.0, hop=hop)],
                                   poll_interval=999)
        for i in range(6):
            gauge.set(1.0 + 0.01 * i)
            assert monitor.check_once(now=float(i)) == []
        gauge.set(100.0)
        fired = monitor.check_once(now=10.0)
        assert [v["rule"] for v in fired] == ["ef_residual_spike" + (f"_{hop}" if hop else "")]
        assert monitor.check_once(now=11.0) == [] and monitor.check_once(now=12.0) == []
        silent = t_slo.SloMonitor(t_telemetry.Registry(), [t_slo.ef_residual_spike(hop=hop)],
                                  poll_interval=999)
        assert all(silent.check_once(now=float(i)) == [] for i in range(10))
    finally:
        t_telemetry.reset()

