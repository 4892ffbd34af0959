"""CommConfig: the policy for how gradients cross the interconnect, as the
JAX package's ``comm/config.py`` (a copy: the port imports nothing of that
package).

- ``compress`` selects the wire format of the compressible phase:
  ``"none"`` (exact f32), ``"int8"`` (symmetric per-block int8, about 5/8
  of the exact bytes on the wire) or ``"bf16"`` (round-to-nearest bf16,
  about 3/4);
- ``error_feedback`` carries the residual each step's quantization dropped
  in ``TrainState.comm_state`` and adds it back before the next quantize,
  so that the applied updates telescope: applied_1..T + residual_T ==
  exact_1..T;
- ``overlap`` issues each schedule stage's compressed collective from
  inside the backward (``comm/overlap.py``) instead of one fused pass after
  it: the same values, an earlier wire;
- ``bucket_mb`` packs the leaves of a stage into flat buckets that share
  one collective and one scale vector; a bucket whose payload is under
  ``min_bucket_bytes`` stays exact;
- ``stage_modes`` overrides the mode of a stage, e.g.
  ``(("heads", "bf16"),)``;
- ``ici_mode``, ``dcn_mode`` and ``dcn_bucket_mb`` are the per-hop policy
  of the two-level tree (``parallel/mesh.py::CommTopology``): fast links
  within a slice (the cards of one host), slow links across slices (the
  hosts).  They are dormant until a step is handed a topology; then
  ``dcn_mode`` (default: ``compress``) is the wire format of the
  cross-slice hop and ``ici_mode`` (default ``"none"``) that of the
  intra-slice hops.

The config is a frozen dataclass, so a world's ranks rebuild it from the
same flags and get the same plan.
"""

from __future__ import annotations

import dataclasses

#: Comm schedule stages, in backward-completion order: the heads' grads
#: exist first, the backbone's last — overlap issues each stage's
#: collective as soon as its cotangents exist.  Top-level param keys map
#: onto stages via ``stage_of``; anything that is not backbone/fpn
#: (cls_head, box_head, test models' ad-hoc keys) is "heads".
STAGES = ("backbone", "fpn", "heads")

COMPRESS_MODES = ("none", "int8", "bf16")


def stage_of(top_key: str) -> str:
    """Schedule stage of a top-level parameter key."""
    key = str(top_key)
    if key in ("backbone", "fpn"):
        return key
    return "heads"


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Policy for the gradient collectives (see module docstring)."""

    compress: str = "none"  # "none" | "int8" | "bf16"
    error_feedback: bool = True
    overlap: bool = False
    bucket_mb: float = 4.0
    # Buckets with payload below this stay exact.
    min_bucket_bytes: int = 32768
    block: int = 512  # elements per int8 scale (EQuARX-style blocks)
    # Per-role overrides: ((stage, mode), ...) — mode for unlisted
    # stages is ``compress`` (the DCN baseline when hierarchical).
    stage_modes: tuple = ()
    # Per-hop policy, dormant until a CommTopology is supplied.  None
    # means "unset": ici defaults to "none" (the fast wire stays exact),
    # dcn inherits ``compress``, dcn_bucket_mb inherits ``bucket_mb``.
    ici_mode: str | None = None
    dcn_mode: str | None = None
    dcn_bucket_mb: float | None = None

    def __post_init__(self):
        if self.compress not in COMPRESS_MODES:
            raise ValueError(
                f"CommConfig.compress must be one of {COMPRESS_MODES}, "
                f"got {self.compress!r}"
            )
        for stage, mode in self.stage_modes:
            if stage not in STAGES:
                raise ValueError(
                    f"CommConfig.stage_modes names unknown stage "
                    f"{stage!r}; valid stages are {STAGES}"
                )
            if mode not in COMPRESS_MODES:
                raise ValueError(
                    f"CommConfig.stage_modes[{stage!r}] must be one of "
                    f"{COMPRESS_MODES}, got {mode!r}"
                )
        if self.bucket_mb <= 0:
            raise ValueError(
                f"CommConfig.bucket_mb must be positive, "
                f"got {self.bucket_mb!r}"
            )
        if self.block <= 0:
            raise ValueError(
                f"CommConfig.block must be positive, got {self.block!r}"
            )
        for field in ("ici_mode", "dcn_mode"):
            value = getattr(self, field)
            if value is not None and value not in COMPRESS_MODES:
                raise ValueError(
                    f"CommConfig.{field} must be one of {COMPRESS_MODES} "
                    f"(or None to inherit), got {value!r}"
                )
        if self.dcn_bucket_mb is not None and self.dcn_bucket_mb <= 0:
            raise ValueError(
                f"CommConfig.dcn_bucket_mb must be positive (or None to "
                f"inherit bucket_mb), got {self.dcn_bucket_mb!r}"
            )
        ici, dcn = self.effective_ici_mode, self.effective_dcn_mode
        if ici != "none" and ici != dcn:
            raise ValueError(
                f"CommConfig.ici_mode: compressing the fast (ICI) hop "
                f"({ici!r}) while the DCN hop runs {dcn!r} is "
                "unsupported — the hierarchical tree compresses only "
                "the slow wire; set ici_mode='none' (exact) or give "
                "both hops one mode (which is the flat tree)"
            )

    @property
    def enabled(self) -> bool:
        """Any compression at all (overlap without compression still
        routes through the comm reduce, so it counts).  A hop-only
        policy (``compress='none'`` but ``dcn_mode`` set) counts too:
        it compresses the moment a multi-slice topology appears."""
        return (
            self.compress != "none"
            or self.overlap
            or self.effective_dcn_mode != "none"
        )

    @property
    def needs_state(self) -> bool:
        """Does this policy carry cross-step comm state (EF residuals)?"""
        return self.error_feedback and (
            self.compress != "none" or self.effective_dcn_mode != "none"
        )

    def mode_for_stage(self, stage: str, default: str | None = None) -> str:
        """Wire mode for a schedule stage.  ``default`` overrides the
        baseline (the hierarchical planner passes the hop's mode)."""
        baseline = self.compress if default is None else default
        return dict(self.stage_modes).get(stage, baseline)

    @property
    def effective_ici_mode(self) -> str:
        """Intra-slice wire mode once a topology engages ("none" unless
        explicitly set — the fast wire stays exact)."""
        return "none" if self.ici_mode is None else self.ici_mode

    @property
    def effective_dcn_mode(self) -> str:
        """Cross-slice wire mode once a topology engages (inherits
        ``compress`` unless explicitly set)."""
        return self.compress if self.dcn_mode is None else self.dcn_mode

    def hierarchical_with(self, topology) -> bool:
        """Does the hierarchical tree engage at ``topology``?  Requires
        a real multi-slice topology AND per-hop modes that differ —
        when both hops share one mode the hierarchy degenerates to the
        flat tree (and the step compiles the flat tree, byte-identical:
        the pinned contract)."""
        if topology is None or getattr(topology, "num_slices", 1) <= 1:
            return False
        return self.effective_ici_mode != self.effective_dcn_mode

    def flat_equivalent(self, topology) -> "CommConfig":
        """The flat-tree config this policy degenerates to when the
        hierarchical tree does NOT engage at ``topology``:

        - no topology → this config unchanged;
        - single-slice topology → the whole world is the fast wire, so
          the flat tree runs at ``ici_mode`` (stage_modes are DCN-side
          overrides and a single slice has no DCN hop, so they drop);
        - multi-slice with ``ici_mode == dcn_mode`` → the flat tree at
          that shared mode (stage_modes keep their meaning).  Both hop
          fields are pinned to the shared mode — NOT cleared — so the
          result is a fixed point: re-resolving it against any topology
          never re-engages the hierarchy (``ici_mode=None`` would read
          back as "none" and differ from a non-"none" ``compress``).
        """
        if topology is None:
            return self
        if getattr(topology, "num_slices", 1) <= 1:
            return dataclasses.replace(
                self, compress=self.effective_ici_mode,
                ici_mode=None, dcn_mode=None, dcn_bucket_mb=None,
                stage_modes=(),
            )
        mode = self.effective_dcn_mode
        return dataclasses.replace(
            self, compress=mode, ici_mode=mode, dcn_mode=mode,
            dcn_bucket_mb=None,
        )

    @property
    def bucket_elems(self) -> int:
        """Bucket capacity in f32 elements."""
        return max(1, int(self.bucket_mb * (1 << 20) / 4))

    @property
    def dcn_bucket_elems(self) -> int:
        """Bucket capacity (f32 elements) for the hierarchical plan —
        sized for the hop that actually hurts (the DCN exchange);
        inherits ``bucket_mb`` unless ``dcn_bucket_mb`` is set."""
        mb = self.bucket_mb if self.dcn_bucket_mb is None else self.dcn_bucket_mb
        return max(1, int(mb * (1 << 20) / 4))
