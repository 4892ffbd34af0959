"""Bucketed, error-feedback gradient compression: the JAX package's
``comm/compress.py`` over a world's process group.

Per bucket, the wire scheme reduces in exact f32 and compresses only the
phase that can take it:

1. **Bucketing**: leaves pack per schedule stage into flat buckets of
   ``CommConfig.bucket_mb``, so many small leaves share one collective and
   one scale vector; only a bucket whose whole payload is under
   ``min_bucket_bytes`` stays exact.  The plan is built over the flax key
   paths of the leaves, in the flax flatten order, and each leaf's flat is
   its flax layout (``models/convert.py::to_flax``): bucket membership
   decides the int8 blocks and their scales, so it must be the JAX plan's.
2. **Error feedback**: rank ``i`` owns the reduced shard it quantizes, and
   so the rounding it introduced: ``residual = shard - dequant(quant(
   shard))`` is kept in ``TrainState.comm_state`` (this rank's ``(chunk,)``
   slice of a flat ``(n * chunk,)`` array a bucket, the ZeRO layout) and
   added back before the next quantize, so that ``sum(applied) +
   residual_T == sum(exact)``.
3. **Health**: each reduce returns the new residuals and the count of
   saturated elements (``|q| == 127``), which :func:`comm_metrics` turns
   into ``ef_residual_norm``, ``ef_saturation`` and
   ``comm_compressed_bytes``.

Two layouts share the quantizer.  :func:`reduce_tree`, the data-parallel
path: per bucket an exact f32 reduce-scatter (``DataAxis.psum_scatter``),
the EF add-back, the per-block quantize of the reduced shard, and the
compressed all-gather; every rank dequantizes the same gathered bytes, so
the parameters stay bit-identical across ranks.  Handed a topology's axes
(:class:`Hierarchy`) the tree is hierarchical: exact within each slice,
quantized only across slices (:func:`reduce_bucket_hierarchical`).
:func:`zero_gather_updates`, the ZeRO path: the gradient reduce-scatter
stays exact, and compression moves to the gather of the optimizer's update
shards, with per-leaf residuals in the ZeRO flat layout.

Non-finite gradients surface: a block holding an Inf or a NaN gets a NaN
scale, so its dequantized values are NaN and the loop's finite-check stops
every rank at the same step.

Trees are ``{flax key path: tensor}`` mappings in flatten order.  The
collectives are unconditional: every rank calls them in the same order.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping
from typing import Any, NamedTuple

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.comm.config import CommConfig, stage_of
from batchai_retinanet_horovod_coco_tpu_torch.parallel.zero import _pad_flat

_INV_127 = float(np.float32(1.0) / np.float32(127.0))
_TOP_KEY = re.compile(r"\[(?:'([^']*)'|\"([^\"]*)\")\]")


# ---------------------------------------------------------------------------
# The plan: a deterministic, n-independent bucketing of a gradient tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketLeaf:
    path: str  # the flax key path of the leaf in the full tree
    offset: int  # element offset within the bucket's logical flat
    size: int
    shape: tuple
    dtype: str


@dataclasses.dataclass(frozen=True)
class Bucket:
    stage: str
    index: int
    mode: str  # "exact" | "int8" | "bf16"
    leaves: tuple  # of BucketLeaf
    size: int  # total logical elements

    @property
    def key(self) -> str:
        return f"{self.stage}.{self.index}"


@dataclasses.dataclass(frozen=True)
class CommPlan:
    buckets: tuple  # of Bucket, stage-major in backward-completion order
    config: CommConfig

    def stage_buckets(self, stage: str) -> tuple:
        return tuple(b for b in self.buckets if b.stage == stage)

    @property
    def stages(self) -> tuple:
        seen = []
        for b in self.buckets:
            if b.stage not in seen:
                seen.append(b.stage)
        return tuple(seen)

    # ---- static wire accounting (per-rank bytes sent, ring model) ----

    def _chunk(self, size: int, n: int) -> int:
        return -(-size // n)

    def _blocks(self, size: int, n: int) -> int:
        return -(-self._chunk(size, n) // self.config.block)

    def exact_bytes(self, n: int) -> int:
        """Per-rank ring bytes of the uncompressed schedule: one f32
        all-reduce (reduce-scatter + all-gather) per bucket."""
        f = (n - 1) / max(n, 1)
        return int(sum(2 * f * 4 * b.size for b in self.buckets))

    def compressed_bytes(self, n: int) -> int:
        """Per-rank ring bytes under this plan: exact f32 reduce-scatter +
        compressed gather (int8 payload + one f32 scale per block; bf16
        payload; exact buckets unchanged)."""
        f = (n - 1) / max(n, 1)
        total = 0.0
        for b in self.buckets:
            rs = f * 4 * b.size
            if b.mode == "int8":
                gather = f * (b.size + 4 * n * self._blocks(b.size, n))
            elif b.mode == "bf16":
                gather = f * 2 * b.size
            else:
                gather = f * 4 * b.size
            total += rs + gather
        return int(total)

    def quant_elems(self, n: int, zero: bool = False, topology=None) -> int:
        """Per-rank int8-quantized elements (the saturation denominator;
        bf16 buckets cannot saturate and are left out).  DP layout: one
        padded chunk a bucket; ZeRO (``zero``): the per-leaf padded chunks;
        hierarchical (``topology``): the cross-slice hop's chunk."""
        total = 0
        for b in self.buckets:
            if b.mode != "int8":
                continue
            if zero:
                total += sum(self._chunk(leaf.size, n) for leaf in b.leaves)
            elif topology is not None:
                total += self._hier_chunk(b.size, topology)
            else:
                total += self._chunk(b.size, n)
        return total

    # ---- per-hop accounting (the hierarchical tree) ----

    def _hier_chunk(self, size: int, topology) -> int:
        """Final per-rank chunk of the hierarchical tree: the bucket pads
        to the slice size first (the intra-slice tile), then that tile pads
        across slices."""
        return self._chunk(self._chunk(size, topology.slice_size), topology.num_slices)

    def _hop_bucket_bytes(self, mode: str, size: int, topology) -> dict:
        """Per-rank ring bytes of one bucket through the hierarchical tree,
        by hop: intra-slice reduce-scatter (f32), cross-slice reduce-scatter
        (f32) + gather (``mode``), intra-slice all-gather (f32)."""
        S, L = topology.num_slices, topology.slice_size
        fi = (L - 1) / max(L, 1)
        fd = (S - 1) / max(S, 1)
        tile = size / max(L, 1)
        ici = fi * 4 * size * 2
        dcn_rs = fd * 4 * tile
        if mode == "int8":
            chunk = self._hier_chunk(size, topology)
            blocks = -(-chunk // self.config.block)
            dcn_gather = fd * (tile + 4 * S * blocks)
        elif mode == "bf16":
            dcn_gather = fd * 2 * tile
        else:
            dcn_gather = fd * 4 * tile
        return {"ici": ici, "dcn": dcn_rs + dcn_gather}

    def hop_bytes(self, topology) -> dict:
        """Per-rank ring bytes under this plan's modes, by hop:
        ``{"ici": ..., "dcn": ...}``."""
        out = {"ici": 0.0, "dcn": 0.0}
        for b in self.buckets:
            bb = self._hop_bucket_bytes(b.mode, b.size, topology)
            out["ici"] += bb["ici"]
            out["dcn"] += bb["dcn"]
        return {k: int(v) for k, v in out.items()}

    def hop_bytes_exact(self, topology) -> dict:
        """Per-rank ring bytes of the all-exact hierarchical tree."""
        out = {"ici": 0.0, "dcn": 0.0}
        for b in self.buckets:
            bb = self._hop_bucket_bytes("exact", b.size, topology)
            out["ici"] += bb["ici"]
            out["dcn"] += bb["dcn"]
        return {k: int(v) for k, v in out.items()}

    def hop_quant_bytes(self, topology) -> dict:
        """Per-rank quantized payload bytes by hop; the intra-slice hops
        are exact f32, so ``"ici"`` is 0."""
        S = topology.num_slices
        fd = (S - 1) / max(S, 1)
        dcn = 0.0
        for b in self.buckets:
            chunk = self._hier_chunk(b.size, topology)
            if b.mode == "int8":
                blocks = -(-chunk // self.config.block)
                dcn += fd * S * (chunk + 4 * blocks)
            elif b.mode == "bf16":
                dcn += fd * S * 2 * chunk
        return {"ici": 0, "dcn": int(dcn)}


def _dtype_name(leaf: Any) -> str:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _is_float(leaf: Any) -> bool:
    dtype = leaf.dtype
    if isinstance(dtype, torch.dtype):
        return dtype.is_floating_point
    return bool(np.issubdtype(np.dtype(dtype), np.floating))


def _top_key(path: str) -> str:
    match = _TOP_KEY.match(path)
    return "" if match is None else (match.group(1) if match.group(1) is not None else match.group(2))


def plan_buckets(leaves: Mapping[str, Any], config: CommConfig, topology=None) -> CommPlan:
    """Deterministic bucketing of ``leaves`` (``{flax key path: array or
    tensor}`` in flatten order), as the JAX package's ``plan_buckets``.

    Leaves group by schedule stage (``stage_of`` the top-level key), keep
    their order within a stage, and pack greedily into buckets of at most
    ``bucket_mb``.  The plan depends on the tree and the config only, not
    on the world size, so EF state saved at one world size reshards to
    another.  Non-float leaves are left out.  With an engaged hierarchical
    ``topology`` the capacity is ``dcn_bucket_mb`` and a bucket's mode the
    stage's cross-slice mode.
    """
    hier = config.hierarchical_with(topology)
    by_stage: dict[str, list] = {}
    for path, leaf in leaves.items():
        if _is_float(leaf):
            by_stage.setdefault(stage_of(_top_key(path)), []).append((path, leaf))
    buckets: list[Bucket] = []
    # Backward-completion order: heads first, backbone last.
    stage_order = [s for s in ("heads", "fpn", "backbone") if s in by_stage]
    cap = config.dcn_bucket_elems if hier else config.bucket_elems
    for stage in stage_order:
        pending: list[BucketLeaf] = []
        total = 0
        index = 0

        def flush():
            nonlocal pending, total, index
            if not pending:
                return
            mode = config.mode_for_stage(stage, config.effective_dcn_mode if hier else None)
            if mode == "none":
                mode = "exact"  # never through the quantizer
            if total * 4 < config.min_bucket_bytes:
                mode = "exact"  # the wire saving is noise below this
            buckets.append(Bucket(stage=stage, index=index, mode=mode,
                                  leaves=tuple(pending), size=total))
            pending, total = [], 0
            index += 1

        for path, leaf in by_stage[stage]:
            shape = tuple(int(d) for d in leaf.shape)
            size = int(np.prod(shape)) if shape else 1
            if total and total + size > cap:
                flush()
            pending.append(BucketLeaf(path=path, offset=total, size=size, shape=shape,
                                      dtype=_dtype_name(leaf)))
            total += size
        flush()
    return CommPlan(buckets=tuple(buckets), config=config)


# ---------------------------------------------------------------------------
# EF state
# ---------------------------------------------------------------------------


def _padded_total(size: int, n: int) -> int:
    return n * (-(-size // n))


def bucket_state_key(bucket: Bucket, topology=None) -> str:
    """EF-state key of a bucket: ``"<stage>.<index>"`` on the flat tree,
    ``"<stage>.<index>@dcn"`` on the hierarchical tree (the residual lives
    on the hop that quantizes, so a flat <-> hierarchical switch is a
    layout change at restore, never a misread)."""
    return bucket.key if topology is None else f"{bucket.key}@dcn"


def init_comm_state(leaves: Mapping[str, Any], config: CommConfig, n: int,
                    zero: bool = False, topology=None) -> dict[str, np.ndarray]:
    """Zero EF state for ``leaves`` under ``config`` at world ``n``, as host
    arrays in the global layout the JAX package keeps (this rank holds its
    slice; ``parallel/zero.py::Sharding``).  DP: one ``(n * chunk,)``
    residual a compressed bucket, keyed ``"<stage>.<index>"``; ZeRO
    (``zero``): one ``(n * ceil(size / n),)`` residual a leaf, keyed by its
    path; hierarchical (an engaged ``topology``): one ``(n *
    hier_chunk,)`` residual a compressed bucket, keyed
    ``"<stage>.<index>@dcn"``.  Empty when the policy keeps no state."""
    if zero:
        topology = None  # the ZeRO update gather stays flat
    if not config.hierarchical_with(topology):
        config = config.flat_equivalent(topology)
        topology = None
    if not config.needs_state:
        return {}
    plan = plan_buckets(leaves, config, topology)
    out: dict[str, np.ndarray] = {}
    for bucket in plan.buckets:
        if bucket.mode == "exact":
            continue
        if zero:
            for leaf in bucket.leaves:
                out[leaf.path] = np.zeros((_padded_total(leaf.size, n),), np.float32)
        elif topology is not None:
            chunk = plan._hier_chunk(bucket.size, topology)
            out[bucket_state_key(bucket, topology)] = np.zeros((n * chunk,), np.float32)
        else:
            out[bucket.key] = np.zeros((_padded_total(bucket.size, n),), np.float32)
    return out


# ---------------------------------------------------------------------------
# The per-bucket quantizer (shared by both layouts)
# ---------------------------------------------------------------------------


def _quantize_shard(shard: torch.Tensor, mode: str, block: int):
    """Quantize one reduced local shard; returns (payload, dequantized
    local shard, saturated-element count).  ``payload`` is what crosses
    the wire: (int8 blocks, f32 scales), or a bf16 array."""
    m = shard.shape[0]
    if mode == "bf16":
        q = shard.to(torch.bfloat16)
        return q, q.float(), torch.zeros((), dtype=torch.float32, device=shard.device)
    blocks = -(-m // block)
    sb = torch.nn.functional.pad(shard, (0, blocks * block - m)).view(blocks, block)
    amax = sb.abs().amax(dim=1)
    # A non-finite block poisons its scale: its values dequantize to NaN and
    # the loop's finite-check stops the run (never launder an Inf into
    # finite int8).
    # XLA compiles the JAX package's ``/ 127.0`` into a multiply by the f32
    # reciprocal; so does the port, for the same scales bit for bit.
    scale = torch.where(torch.isfinite(amax), torch.clamp_min(amax, 1e-30) * _INV_127,
                        torch.full_like(amax, float("nan")))
    r = torch.clamp(torch.round(sb / scale[:, None]), -127.0, 127.0)
    # XLA converts a NaN to the integer 0; torch leaves it undefined.
    q = torch.nan_to_num(r, nan=0.0).to(torch.int8)
    deq = (q.float() * scale[:, None]).reshape(-1)[:m]
    sat = (q.abs() >= 127).float().sum()
    return (q, scale), deq, sat


def _residual(shard: torch.Tensor, payload, mode: str) -> torch.Tensor:
    """``shard - dequant(payload)`` rounded once, as XLA computes the JAX
    package's residual: it contracts the multiply and the subtract into a
    fused multiply-add.  The int8 product is exact in f64, so the f64
    difference rounded to f32 is the fused result."""
    if mode == "bf16":
        return shard - payload.float()
    q, scale = payload
    deq = (q.double() * scale.double()[:, None]).reshape(-1)[: shard.shape[0]]
    return (shard.double() - deq).float()


def _dequantize_gathered(payload_all, mode: str, m: int, n: int) -> torch.Tensor:
    """The all-gathered payload → the full ``(n * m,)`` f32 flat."""
    if mode == "bf16":
        return payload_all.float().reshape(-1)
    q_all, s_all = payload_all
    blocks_block = q_all.shape[1] * q_all.shape[2]
    return (q_all.float() * s_all[..., None]).reshape(n, blocks_block)[:, :m].reshape(-1)


def _gather_payload(payload, mode: str, axis):
    if mode == "bf16":
        return axis.all_gather(payload)
    return axis.all_gather(payload[0]), axis.all_gather(payload[1])


def _reduce_bucket_flat(flat: torch.Tensor, res: torch.Tensor | None, bucket: Bucket,
                        config: CommConfig, axis):
    """One bucket's compressed pmean over ``axis``.  ``flat`` is the local
    logical concat of the bucket's leaves, ``res`` this rank's residual or
    None.  Returns (reduced full flat ``(size,)``, new residual or None,
    saturated count)."""
    size = bucket.size
    zero = torch.zeros((), dtype=torch.float32, device=flat.device)
    if bucket.mode == "exact":
        return axis.pmean(flat), res, zero
    n = axis.size
    padded = _pad_flat(flat, n)
    # Phase 1: exact f32 reduction; each rank owns 1/n of the sum.
    shard = axis.psum_scatter(padded) / n
    if res is not None:
        shard = shard + res  # EF add-back: last step's dropped rounding
    payload, _, sat = _quantize_shard(shard, bucket.mode, config.block)
    new_res = _residual(shard, payload, bucket.mode) if res is not None else None
    # Phase 2: compressed gather; every rank dequantizes the same bytes.
    gathered = _gather_payload(payload, bucket.mode, axis)
    out = _dequantize_gathered(gathered, bucket.mode, shard.shape[0], n)
    return out[:size], new_res, sat


class Hierarchy(NamedTuple):
    """The two-level tree of a world: its topology and this rank's two
    axes (``parallel/mesh.py::hop_axes``)."""

    topology: Any
    ici: Any
    dcn: Any


def reduce_bucket_hierarchical(flat: torch.Tensor, res: torch.Tensor | None, bucket: Bucket,
                               config: CommConfig, axis, hierarchy: Hierarchy):
    """One bucket's pmean through the two-level tree, compressed only on
    the slow hop:

    1. reduce-scatter within the slice (exact f32): intra-slice rank ``r``
       owns tile ``r`` of the slice's sum;
    2. reduce-scatter across slices (exact f32): slice ``s`` owns chunk
       ``s`` of that tile of the global sum;
    3. EF add-back and quantize of the owned chunk (``bucket.mode``);
    4. all-gather of the payload across slices: every rank of the group
       dequantizes the same bytes;
    5. all-gather within the slice (exact f32) back to the whole bucket.

    ``axis`` is the world's (the exact buckets' pmean).  Returns (reduced
    full flat ``(size,)``, new residual or None, saturated count)."""
    size = bucket.size
    if bucket.mode == "exact":
        return axis.pmean(flat), res, torch.zeros((), dtype=torch.float32, device=flat.device)
    S, L = hierarchy.topology.num_slices, hierarchy.topology.slice_size
    n = hierarchy.topology.num_devices
    tile = hierarchy.ici.psum_scatter(_pad_flat(flat, L))
    shard = hierarchy.dcn.psum_scatter(_pad_flat(tile, S)) / n
    if res is not None:
        shard = shard + res
    payload, _, sat = _quantize_shard(shard, bucket.mode, config.block)
    new_res = _residual(shard, payload, bucket.mode) if res is not None else None
    gathered = _gather_payload(payload, bucket.mode, hierarchy.dcn)
    tile_out = _dequantize_gathered(gathered, bucket.mode, shard.shape[0], S)[: tile.shape[0]]
    full = hierarchy.ici.all_gather(tile_out).reshape(-1)
    return full[:size], new_res, sat


# ---------------------------------------------------------------------------
# DP path: reduce_tree
# ---------------------------------------------------------------------------


def reduce_leaves(leaf_map: Mapping[str, torch.Tensor], res_map: Mapping[str, torch.Tensor],
                  buckets, config: CommConfig, axis, hierarchy: Hierarchy | None = None):
    """Reduce the leaves of ``buckets`` (``{path: local gradient}``, flax
    layout): the engine under :func:`reduce_tree` and the overlap's stage
    triggers.  ``hierarchy`` selects the two-level tree (only where it
    engages: the flat fallback is the flat code path).  Returns (reduced
    leaf map, new residual map, saturated count)."""
    out: dict[str, torch.Tensor] = {}
    new_res: dict[str, torch.Tensor] = {}
    sat_total = None
    topology = None if hierarchy is None else hierarchy.topology
    for bucket in buckets:
        parts = [leaf_map[leaf.path].float().reshape(-1) for leaf in bucket.leaves]
        flat = parts[0] if len(parts) == 1 else torch.cat(parts)
        key = bucket_state_key(bucket, topology)
        res = res_map.get(key) if bucket.mode != "exact" else None
        if hierarchy is not None:
            reduced, res_out, sat = reduce_bucket_hierarchical(flat, res, bucket, config, axis,
                                                               hierarchy)
        else:
            reduced, res_out, sat = _reduce_bucket_flat(flat, res, bucket, config, axis)
        sat_total = sat if sat_total is None else sat_total + sat
        if res_out is not None:
            new_res[key] = res_out
        for leaf in bucket.leaves:
            piece = reduced[leaf.offset:leaf.offset + leaf.size]
            out[leaf.path] = piece.reshape(leaf.shape).to(leaf_map[leaf.path].dtype)
    if sat_total is None:
        sat_total = torch.zeros((), dtype=torch.float32)
    return out, new_res, sat_total


def reduce_tree(grads: Mapping[str, torch.Tensor], comm_state: Mapping[str, torch.Tensor],
                plan: CommPlan, config: CommConfig, axis, hierarchy: Hierarchy | None = None):
    """Bucketed compressed pmean of a whole gradient tree (the fused path,
    after the backward).  Leaves outside the plan (non-float) take the exact
    pmean.  Returns (reduced tree, new comm state, local saturated count);
    the comm state keeps its keys (a key no bucket updated passes through)."""
    planned = {leaf.path for b in plan.buckets for leaf in b.leaves}
    out_map, new_res, sat = reduce_leaves(grads, comm_state, plan.buckets, config, axis,
                                          hierarchy)
    for path, leaf in grads.items():
        if path not in planned:
            out_map[path] = axis.pmean(leaf)
    new_res = {k: new_res.get(k, v) for k, v in comm_state.items()}
    return {path: out_map[path] for path in grads}, new_res, sat


def bucketed_pmean(grads: Mapping[str, torch.Tensor], axis, config: CommConfig | None = None):
    """Stateless (no EF) bucketed compressed pmean; the plan is built from
    the tree itself."""
    config = config or CommConfig(compress="int8", error_feedback=False)
    plan = plan_buckets(grads, config)
    reduced, _, _ = reduce_tree(grads, {}, plan, config, axis)
    return reduced


# ---------------------------------------------------------------------------
# ZeRO path: the compressed update gather
# ---------------------------------------------------------------------------


def zero_gather_updates(updates: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
                        comm_state: Mapping[str, torch.Tensor], plan: CommPlan,
                        config: CommConfig, axis):
    """The compressed gather of the ZeRO update shards in place of the f32
    parameter all-gather.

    ``updates`` holds this rank's ``(chunk_leaf,)`` shard of each leaf's
    optimizer update (the ``parallel/zero.py`` layout); ``params`` the full
    replicated parameters (flax layout).  Per bucket: concat the member
    shards, add back their residuals, quantize, all-gather, and add the
    same dequantized full update to every rank's parameters.  Exact buckets
    gather in f32.  Returns (new parameters map, new comm state, saturated
    count)."""
    new_params: dict[str, torch.Tensor] = {}
    new_res: dict[str, torch.Tensor] = {}
    sat_total = None
    n = axis.size
    planned = {leaf.path for b in plan.buckets for leaf in b.leaves}
    for bucket in plan.buckets:
        shards = [updates[leaf.path].float().reshape(-1) for leaf in bucket.leaves]
        chunks = [s.shape[0] for s in shards]
        flat = shards[0] if len(shards) == 1 else torch.cat(shards)
        # EF engages iff the state holds every member leaf's residual; a
        # stateless caller quantizes without EF.
        use_ef = (bucket.mode != "exact" and config.needs_state
                  and all(leaf.path in comm_state for leaf in bucket.leaves))
        res = None
        if use_ef:
            parts = [comm_state[leaf.path] for leaf in bucket.leaves]
            res = parts[0] if len(parts) == 1 else torch.cat(parts)
        if bucket.mode == "exact":
            gathered = axis.all_gather(flat)  # (n, L) f32
            sat = torch.zeros((), dtype=torch.float32, device=flat.device)
        else:
            if res is not None:
                flat = flat + res
            payload, _, sat = _quantize_shard(flat, bucket.mode, config.block)
            if res is not None:
                res_out = _residual(flat, payload, bucket.mode)
                off = 0
                for leaf, c in zip(bucket.leaves, chunks):
                    new_res[leaf.path] = res_out[off:off + c]
                    off += c
            if bucket.mode == "bf16":
                gathered = axis.all_gather(payload).float()
            else:
                q_all, s_all = _gather_payload(payload, bucket.mode, axis)
                # Exact in f64; added to the parameters with one rounding,
                # as XLA's fused multiply-add.
                gathered = (q_all.double() * s_all.double()[..., None]).reshape(n, -1)[
                    :, : flat.shape[0]]
        sat_total = sat if sat_total is None else sat_total + sat
        # Each leaf's full update: its column range of the gathered (n, L)
        # matrix, rank-major (the ZeRO flat layout).
        off = 0
        for leaf, c in zip(bucket.leaves, chunks):
            cols = gathered[:, off:off + c].reshape(n * c)[: leaf.size]
            p = params[leaf.path]
            if cols.dtype == torch.float64:
                new_params[leaf.path] = (p.double() + cols.reshape(leaf.shape)).to(p.dtype)
            else:
                new_params[leaf.path] = p + cols.reshape(leaf.shape).to(p.dtype)
            off += c
    for path, p in params.items():
        if path not in planned:
            full = axis.all_gather(updates[path]).reshape(-1)
            new_params[path] = p + full[: p.numel()].reshape(p.shape).to(p.dtype)
    new_res = {k: new_res.get(k, v) for k, v in comm_state.items()}
    if sat_total is None:
        sat_total = torch.zeros((), dtype=torch.float32)
    return {path: new_params[path] for path in params}, new_res, sat_total


# ---------------------------------------------------------------------------
# In-step health metrics
# ---------------------------------------------------------------------------


def comm_metrics(plan: CommPlan, new_comm_state: Mapping[str, torch.Tensor],
                 sat_local: torch.Tensor, axis, zero: bool = False,
                 topology=None) -> dict[str, torch.Tensor]:
    """The step's EF health metrics, after the reduce: the global residual
    norm, the global saturated fraction and the plan's static bytes on the
    wire; per hop (``comm_ici_bytes``, ``comm_dcn_bytes``,
    ``ef_residual_norm_dcn``) on the hierarchical tree.  ``zero`` selects
    the ZeRO layout's saturation denominator.  One all-reduce."""
    n = axis.size
    device = sat_local.device
    if topology is not None:
        hop = plan.hop_bytes(topology)
        out = {
            "comm_compressed_bytes": torch.tensor(float(hop["ici"] + hop["dcn"]), device=device),
            "comm_ici_bytes": torch.tensor(float(hop["ici"]), device=device),
            "comm_dcn_bytes": torch.tensor(float(hop["dcn"]), device=device),
        }
    else:
        out = {"comm_compressed_bytes": torch.tensor(float(plan.compressed_bytes(n)),
                                                     device=device)}
    denom = float(max(1, n * plan.quant_elems(n, zero=zero, topology=topology)))
    sq = torch.zeros((), dtype=torch.float32, device=device)
    for r in new_comm_state.values():
        sq = sq + r.float().square().sum()
    summed = axis.psum(torch.stack([sat_local.float().reshape(()).to(device), sq]))
    out["ef_saturation"] = summed[0] / denom
    if new_comm_state:
        out["ef_residual_norm"] = summed[1].sqrt()
        if topology is not None:
            out["ef_residual_norm_dcn"] = out["ef_residual_norm"]
    return out
