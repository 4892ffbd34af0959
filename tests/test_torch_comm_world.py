"""The port's compressed collectives in gloo worlds on the CPU against the
JAX package's under ``shard_map``: ``reduce_tree`` (flat and hierarchical),
``zero_gather_updates`` and the deprecated ``quantized_pmean`` in a world
of 2 and a world of 4 (2 slices x 2), and the error-feedback properties in
the port alone.

Each world is one set of child processes (``tests/torch_comm_worker.py``)
running every case of that world size, while this process computes the
JAX side over 2 and 4 of the 8 host devices ``tests/conftest.py`` forces.
Mesh position ``d`` reads row ``d`` of each input; on the hierarchical tree
the rank ``node * L + local`` sits at position ``local * S + node``.

Tolerances: in a world of 2 every output, residual and saturated count
equals the JAX package's bit for bit (two f32 addends sum exactly in either
order, and the division by 2 is exact).  In a world of 4 the
reduce-scatter adds four ranks' values: gloo's order may differ from
XLA's, an element's f32 mean can then differ in its last bit and, at a
rounding boundary, quantize to the next level, so an output may differ by
at most one quantization step of its block (``amax / 127``, which for a
bf16 bucket is more than one bf16 step of any value in the block: a mean
that cancels to a tiny value differs by its addends' rounding, which is
many of its own bf16 steps), and the residual likewise.  The ZeRO update
gather adds nothing across ranks, so it is bit for bit at 4.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from batchai_retinanet_horovod_coco_tpu.comm import CommConfig as JCommConfig
from batchai_retinanet_horovod_coco_tpu.comm import compress as j_compress
from batchai_retinanet_horovod_coco_tpu.parallel import make_mesh
from batchai_retinanet_horovod_coco_tpu.parallel import mesh as j_mesh
from batchai_retinanet_horovod_coco_tpu.parallel import quantize as j_quantize
from batchai_retinanet_horovod_coco_tpu.parallel.shmap import shard_map
from batchai_retinanet_horovod_coco_tpu_torch.parallel import mesh as t_mesh
from torch_comm_harness import World

DEADLINE_S = 300  # one deadline a world; generous under the tier's six workers
DATA = j_mesh.DATA_AXIS
SHAPES = {
    ("backbone", "conv", "kernel"): (3, 3, 8, 40),
    ("backbone", "norm", "bias"): (40,),
    ("backbone", "norm", "scale"): (40,),
    ("backbone", "proj", "kernel"): (1, 1, 40, 33),
    ("box_head", "out", "bias"): (36,),
    ("box_head", "out", "kernel"): (3, 3, 16, 36),
    ("cls_head", "out", "bias"): (27,),
    ("fpn", "p3", "bias"): (16,),
    ("fpn", "p3", "kernel"): (1, 1, 40, 16),
}
# quantized_pmean's default policy (4 MB buckets, 32 KB the least that
# quantizes): the backbone and heads buckets go int8, the fpn one stays exact.
PMEAN_SHAPES = {
    ("backbone", "conv", "kernel"): (3, 3, 32, 64),
    ("cls_head", "out", "bias"): (90,),
    ("cls_head", "out", "kernel"): (3, 3, 64, 90),
    ("fpn", "p3", "bias"): (64,),
}
SMALL = dict(bucket_mb=0.01, min_bucket_bytes=1024)
POLICIES = {
    "int8": (dict(compress="int8", **SMALL), 2),
    "mixed": (dict(compress="int8", stage_modes=(("heads", "bf16"),), **SMALL), 2),
    "no-ef": (dict(compress="int8", error_feedback=False, **SMALL), 1),
}


def path_of(keys) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def nest(leaves: dict) -> dict:
    tree: dict = {}
    for keys, value in leaves.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def rows(n: int, seed: int) -> dict:
    """Each leaf's (n, *shape) rows: a scale a leaf and position, an
    outlier, an all-zero leaf."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (keys, shape) in enumerate(SHAPES.items()):
        scale = 10.0 ** rng.uniform(-3, 1, (n,) + (1,) * len(shape))
        out[keys] = (rng.standard_normal((n, *shape)) * scale).astype(np.float32)
    out[("fpn", "p3", "bias")][:] = 0.0
    out[("backbone", "conv", "kernel")][1, 0, 0, 0, 3] = 250.0
    return out


def pmean_rows(n: int, seed: int) -> dict:
    """Each leaf of PMEAN_SHAPES as (n, *shape) rows, a scale a leaf and
    position, and an outlier."""
    rng = np.random.default_rng(seed)
    out = {}
    for keys, shape in PMEAN_SHAPES.items():
        scale = 10.0 ** rng.uniform(-3, 1, (n,) + (1,) * len(shape))
        out[keys] = (rng.standard_normal((n, *shape)) * scale).astype(np.float32)
    out[("cls_head", "out", "kernel")][n - 1, 1, 2, 3, 4] = -300.0
    return out


def jax_pmean(x: dict, n: int):
    """The JAX package's ``quantized_pmean`` under ``shard_map``: the
    reduced tree."""

    @jax.jit
    def run(xs):
        def body(xs):
            return j_quantize.quantized_pmean(jax.tree.map(lambda a: a[0], xs), DATA, n)

        return shard_map(body, mesh=make_mesh(n), in_specs=(P(DATA),), out_specs=P(),
                         check_vma=False)(xs)

    return jax.device_get(run(nest({k: jnp.asarray(v) for k, v in x.items()})))


def jax_reduce(x: dict, cfg: JCommConfig, n: int, steps: int, topology=None):
    tree0 = nest({k: v[0] for k, v in x.items()})
    plan = j_compress.plan_buckets(tree0, cfg, topology)
    res = {k: jnp.asarray(v) for k, v in
           j_compress.init_comm_state(tree0, cfg, n, topology=topology).items()}
    res_spec = j_compress.state_partition_specs(res)

    @jax.jit
    def run(xs, r):
        def body(xs, r):
            per_dev = jax.tree.map(lambda a: a[0], xs)
            sat = None
            for _ in range(steps):
                out, r, sat = j_compress.reduce_tree(per_dev, r, plan, cfg, DATA, n, topology)
            return out, r, sat[None]

        return shard_map(body, mesh=make_mesh(n), in_specs=(P(DATA), res_spec),
                         out_specs=(P(), res_spec, P(DATA)), check_vma=False)(xs, r)

    out, res_out, sat = jax.device_get(run(nest({k: jnp.asarray(v) for k, v in x.items()}), res))
    return plan, res, out, res_out, sat


def jax_zero(u: dict, p: dict, res: dict, cfg: JCommConfig, n: int):
    plan = j_compress.plan_buckets(nest(p), cfg)
    res_spec = j_compress.state_partition_specs(res)

    @jax.jit
    def run(us, ps, r):
        def body(us, ps, r):
            upd = jax.tree.map(lambda a: a[0], us)
            new_p, new_r, sat = j_compress.zero_gather_updates(upd, ps, r, plan, cfg, DATA, n)
            return new_p, new_r, sat[None]

        return shard_map(body, mesh=make_mesh(n), in_specs=(P(DATA), P(), res_spec),
                         out_specs=(P(), res_spec, P(DATA)), check_vma=False)(us, ps, r)

    return jax.device_get(run(nest({k: jnp.asarray(v) for k, v in u.items()}),
                              nest({k: jnp.asarray(v) for k, v in p.items()}),
                              {k: jnp.asarray(v) for k, v in res.items()}))


def flat_out(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(v) for path, v in flat}


def write_inputs(path, x=None, res=None, u=None, p=None) -> list[str]:
    arrays = {}
    for prefix, tree in (("x", x), ("u", u), ("p", p)):
        for keys, v in (tree or {}).items():
            arrays[f"{prefix}/{path_of(keys)}"] = v
    for k, v in (res or {}).items():
        arrays[f"res/{k}"] = np.asarray(v)
    np.savez(path, **arrays)
    return [path_of(k) for k in (x or u)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """This process computes the JAX side, then each world runs every case
    of its size; yields ``{size: (world, {case: jax results})}``."""
    root = tmp_path_factory.mktemp("comm_world")
    plans, cases, want = {}, {2: [], 4: []}, {2: {}, 4: {}}
    for n in (2, 4):
        x = rows(n, seed=n)
        for name, (kwargs, steps) in POLICIES.items():
            cfg = JCommConfig(**kwargs)
            plan, res0, *_ = want[n].setdefault(name, jax_reduce(x, cfg, n, steps))
            paths = write_inputs(root / f"{name}-{n}.npz", x=x, res=res0)
            cases[n].append(dict(kind="reduce", name=name, comm=kwargs, steps=steps, paths=paths,
                                 res=sorted(res0), inputs=str(root / f"{name}-{n}.npz")))
            plans[(n, name)] = plan
        # The hierarchical tree: 2 slices of n / 2.
        topo = j_mesh.CommTopology(2, n // 2)
        kwargs = dict(compress="int8", **SMALL)
        plan, res0, *_ = want[n].setdefault("hier", jax_reduce(x, JCommConfig(**kwargs), n, 2, topo))
        paths = write_inputs(root / f"hier-{n}.npz", x=x, res=res0)
        cases[n].append(dict(kind="reduce", name="hier", comm=kwargs, steps=2, paths=paths,
                             slices=2, res=sorted(res0), inputs=str(root / f"hier-{n}.npz")))
        plans[(n, "hier")] = plan
        # The ZeRO update gather: update shards, full parameters, residuals.
        for name, kwargs in (("zero-int8", dict(compress="int8", **SMALL)),
                             ("zero-bf16", dict(compress="bf16", **SMALL))):
            rng = np.random.default_rng(7 + n)
            p = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
            u = {k: (rng.standard_normal((n, -(-int(np.prod(s)) // n)))
                     * 1e-3).astype(np.float32) for k, s in SHAPES.items()}
            cfg = JCommConfig(**kwargs)
            res = {path_of(k): v for k, v in
                   j_compress.init_comm_state(nest(p), cfg, n, zero=True).items()}
            res = {k: (rng.standard_normal(v.shape) * 1e-5).astype(np.float32)
                   for k, v in res.items()}
            want[n][name] = jax_zero(u, p, res, cfg, n)
            paths = write_inputs(root / f"{name}-{n}.npz", u=u, p=p, res=res)
            cases[n].append(dict(kind="zero", name=name, comm=kwargs, paths=paths,
                                 res=sorted(res), inputs=str(root / f"{name}-{n}.npz")))
        # The deprecated stateless alias at its default policy.
        x = pmean_rows(n, seed=11 + n)
        plan = j_compress.plan_buckets(nest({k: v[0] for k, v in x.items()}),
                                       JCommConfig(compress="int8", error_feedback=False))
        want[n]["pmean"] = (plan, jax_pmean(x, n))
        paths = write_inputs(root / f"pmean-{n}.npz", x=x)
        cases[n].append(dict(kind="pmean", name="pmean", paths=paths,
                             inputs=str(root / f"pmean-{n}.npz")))
    cases[2] += [dict(kind="telescope", name="telescope", comm=dict(compress="int8", **SMALL),
                      seed=3, steps=6),
                 dict(kind="constant", name="constant")]
    # One world at a time: at most four ranks beside the tier's workers.
    started = {}
    for n in (4, 2):
        started[n] = World(root / f"world{n}", cases[n], n, DEADLINE_S)
        started[n].wait()
    yield {n: (started[n], want[n], plans) for n in (2, 4)}


def positions(n: int, case: str) -> list[int]:
    """The mesh position of each rank."""
    if case != "hier":
        return list(range(n))
    topo = t_mesh.CommTopology(2, n // 2)
    return [topo.position(r) for r in range(n)]


def chunks(size: int, n: int, hier: bool) -> list[np.ndarray]:
    """The bucket-flat indices of each mesh position's chunk (``size`` or
    more: padding).  Flat: ``n`` chunks of the padded flat.  Hierarchical
    (2 slices of n / 2): tile ``r`` of the flat padded to n / 2 tiles, then
    chunk ``s`` of that tile padded to 2 chunks."""
    if not hier:
        c = -(-size // n)
        return [np.arange(d * c, (d + 1) * c) for d in range(n)]
    L = n // 2
    tile = -(-size // L)
    c = -(-tile // 2)
    out = [None] * n
    for r in range(L):
        for s in range(2):
            local = s * c + np.arange(c)
            out[r * 2 + s] = np.where(local < tile, r * tile + local, size)
    return out


def bounds(plan, out: dict, n: int, hier: bool):
    """One quantization step for each output element and each residual
    element: the block's largest dequantized magnitude / 127 (an int8
    block's scale); exact buckets, 1e-6 of the bucket's largest value.
    Returns ({path: bound}, {bucket key: (n, chunk) bound})."""
    out_bound, res_bound = {}, {}
    for bucket in plan.buckets:
        flat = np.concatenate([out[leaf.path].reshape(-1) for leaf in bucket.leaves])
        size = flat.size
        b = np.full(size, 1e-6 * max(np.abs(flat).max(), 1e-30))
        per_chunk = []
        if bucket.mode != "exact":
            for ids in chunks(size, n, hier):
                rb = np.zeros(ids.size)
                for start in range(0, ids.size, 512):
                    block = ids[start:start + 512]
                    valid = block[block < size]
                    step = np.abs(flat[valid]).max() / 127.0 if valid.size else 0.0
                    b[valid] = step
                    rb[start:start + 512] = step
                per_chunk.append(rb)
            res_bound[bucket.key + ("@dcn" if hier else "")] = np.stack(per_chunk)
        for leaf in bucket.leaves:
            out_bound[leaf.path] = b[leaf.offset:leaf.offset + leaf.size].reshape(leaf.shape)
    return out_bound, res_bound


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", [*POLICIES, "hier"])
def test_reduce_tree_equals_jax(worlds, n, name):
    """The reduced tree (the same on every rank), each rank's new residuals
    at its mesh position and its saturated count: bit for bit at 2, within
    one quantization step at 4 (module docstring)."""
    world, want, plans = worlds[n]
    plan, _, out, res_out, sat = want[name]
    out = flat_out(out)
    ranks = world.npz(name)
    pos = positions(n, name)
    bound, res_bound = bounds(plan, out, n, name == "hier")
    for r, got in enumerate(ranks):
        for path, v in out.items():
            if n == 2:
                np.testing.assert_array_equal(got[f"out/{path}"], v, err_msg=path)
            else:
                assert (np.abs(got[f"out/{path}"] - v) <= bound[path]).all(), path
        for key, v in res_out.items():
            mine = np.asarray(v).reshape(n, -1)[pos[r]]
            if n == 2:
                np.testing.assert_array_equal(got[f"res/{key}"], mine, err_msg=key)
            else:
                assert (np.abs(got[f"res/{key}"] - mine) <= res_bound[key][pos[r]]).all(), key
        if n == 2:
            assert float(got["sat"]) == float(sat[pos[r]])
        np.testing.assert_array_equal(got[f"out/{next(iter(out))}"],
                                      ranks[0][f"out/{next(iter(out))}"])
    assert set(res_out) == {k.removeprefix("res/") for k in ranks[0] if k.startswith("res/")}
    if name == "hier":
        assert all(k.endswith("@dcn") for k in res_out)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["zero-int8", "zero-bf16"])
def test_zero_gather_updates_equals_jax(worlds, n, name):
    """The new parameters and each rank's per-leaf residuals, bit for bit
    at both world sizes (the update gather adds nothing across ranks)."""
    world, want, _ = worlds[n]
    new_p, res_out, sat = want[name]
    new_p = flat_out(new_p)
    for r, got in enumerate(world.npz(name)):
        for path, v in new_p.items():
            np.testing.assert_array_equal(got[f"out/{path}"], v, err_msg=path)
        for key, v in res_out.items():
            np.testing.assert_array_equal(got[f"res/{key}"], np.asarray(v).reshape(n, -1)[r])
        assert float(got["sat"]) == float(sat[r])


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_pmean_equals_jax(worlds, n):
    """The deprecated alias (``bucketed_pmean`` at the default int8 policy,
    no error feedback): the reduced tree, the same on every rank, bit for
    bit at 2 and within one quantization step at 4 (module docstring)."""
    world, want, _ = worlds[n]
    plan, out = want["pmean"]
    assert sorted(b.mode for b in plan.buckets) == ["exact", "int8", "int8"]
    out = flat_out(out)
    bound, _ = bounds(plan, out, n, False)
    ranks = world.npz("pmean")
    for got in ranks:
        for path, v in out.items():
            if n == 2:
                np.testing.assert_array_equal(got[f"out/{path}"], v, err_msg=path)
            else:
                assert (np.abs(got[f"out/{path}"] - v) <= bound[path]).all(), path
            np.testing.assert_array_equal(got[f"out/{path}"], ranks[0][f"out/{path}"])


def test_error_feedback_telescopes(worlds):
    """Six steps of random gradients at three magnitudes: the applied means
    summed plus the final residual equal the exact means summed, within f32
    rounding of the sums (1e-6 of the largest), on both ranks."""
    world, _, _ = worlds[2]
    ranks = world.npz("telescope")
    got = ranks[0]
    for key in [k for k in got if k.startswith("applied/")]:
        path = key.removeprefix("applied/")
        applied, exact = got[key], got[f"exact/{path}"]
        np.testing.assert_array_equal(applied, ranks[1][key])
        assert np.abs(applied - exact).max() > 0  # the residual is real
    # The residual is in the buckets' layout: rebuild each bucket's flat.
    from batchai_retinanet_horovod_coco_tpu_torch.comm import compress as t_compress
    from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig

    shapes = {"['heads']['w']": (3000,), "['backbone']['k']": (40, 130)}
    plan = t_compress.plan_buckets({p: np.zeros(s, np.float32) for p, s in shapes.items()},
                                   CommConfig(compress="int8", **SMALL))
    for bucket in plan.buckets:
        applied = np.concatenate([got[f"applied/{leaf.path}"].reshape(-1) for leaf in bucket.leaves])
        exact = np.concatenate([got[f"exact/{leaf.path}"].reshape(-1) for leaf in bucket.leaves])
        if bucket.mode == "exact":
            np.testing.assert_array_equal(applied, exact)
            continue
        res = got[f"res/{bucket.key}"][: bucket.size]
        np.testing.assert_allclose(applied + res, exact, rtol=0,
                                   atol=1e-6 * np.abs(exact).max())


def test_constant_gradient_is_bit_exact_on_step_2(worlds):
    """0.5 everywhere and 127 at each block's head (scale exactly 1): step 1
    rounds 0.5 to 0 (half to even) and keeps 0.5; step 2 quantizes 1.0
    exactly, so the two applied gradients sum to 2v bit for bit and the
    residual returns to 0."""
    world, _, _ = worlds[2]
    for got in world.npz("constant"):
        v = got["v"]
        assert not np.array_equal(got["out1"], v)
        np.testing.assert_array_equal(got["out1"] + got["out2"], 2.0 * v)
        np.testing.assert_array_equal(got["res"], np.zeros_like(got["res"]))


def test_worlds_met_their_deadline(worlds):
    """Both worlds ran every case; no rank outlived them."""
    for n, (world, _, _) in worlds.items():
        assert all(p.returncode == 0 for p in world.procs), n
    assert time.monotonic() < max(w.deadline for w, _, _ in worlds.values())
