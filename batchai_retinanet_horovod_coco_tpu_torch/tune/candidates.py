"""Candidates of the schedule search (``tune/search.py``), the JAX package's
``tune/candidates.py`` for the port.

Each op yields a small explicit list of candidate dicts: the menus are a
handful of launch shapes each, so the search measures every one.  Every
candidate is a valid registry entry (``tune/schedule.py``), so the winner
IS the file's entry.

- The launch shapes are the kernels' menus (``ops/cuda/shapes.py``): NMS
  lanes a mask row x scan threads,
  focal forward tile x backward tile, matching tile.  Every shape gives the
  same detections and targets, and the same focal gradient; the focal
  forward's sums move in their last bits with its tile.  There is no
  ``impl`` axis: the port never takes a plain version on a card.
- ``pre_nms_size`` CHANGES DETECTION SEMANTICS (fewer candidates reach the
  suppression, so mAP can move).  Its other values are candidates only
  when the caller opts in (``include_semantic=True``), and the search
  records them as ``semantics: "approx"`` trials that never win.
- There is no batch axis: the JAX package's picks serve batch sizes, which
  the port's registry refuses (``tune/schedule.py``).
"""

from __future__ import annotations

from typing import Any, Iterable

from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda.shapes import MENUS
from batchai_retinanet_horovod_coco_tpu_torch.tune.schedule import DEFAULT_SCHEDULE

NMS_MASK_LANES = MENUS[("nms", "mask_lanes")]
NMS_SCAN_THREADS = MENUS[("nms", "scan_threads")]
FOCAL_FWD_TILES = MENUS[("focal", "fwd_tile_a")]
FOCAL_BWD_TILES = MENUS[("focal", "bwd_tile_a")]
MATCHING_TILES = MENUS[("matching", "tile_a")]
PRE_NMS_SIZES = (512, 1000, 2048)
DEFAULT_PRE_NMS_SIZE = DEFAULT_SCHEDULE["nms"]["pre_nms_size"]


def nms_candidates(
    include_semantic: bool = False,
    mask_lanes: Iterable[int] = NMS_MASK_LANES,
    scan_threads: Iterable[int] = NMS_SCAN_THREADS,
    pre_nms_sizes: Iterable[int] = PRE_NMS_SIZES,
) -> list[dict[str, Any]]:
    """Every (lanes, scan threads) shape, at ``pre_nms_size`` 1000 (and at
    the other sizes when the caller opts into that axis)."""
    pres = tuple(pre_nms_sizes) if include_semantic else (DEFAULT_PRE_NMS_SIZE,)
    return [{"mask_lanes": lanes, "scan_threads": threads, "pre_nms_size": pre}
            for pre in pres for lanes in mask_lanes for threads in scan_threads]


def focal_candidates(
    fwd_tiles: Iterable[int] = FOCAL_FWD_TILES,
    bwd_tiles: Iterable[int] = FOCAL_BWD_TILES,
) -> list[dict[str, Any]]:
    return [{"fwd_tile_a": fwd, "bwd_tile_a": bwd} for fwd in fwd_tiles for bwd in bwd_tiles]


def matching_candidates(tiles: Iterable[int] = MATCHING_TILES) -> list[dict[str, Any]]:
    return [{"tile_a": tile} for tile in tiles]


def candidates_for(op: str, **kwargs: Any) -> list[dict[str, Any]]:
    try:
        fn = {
            "nms": nms_candidates,
            "focal": focal_candidates,
            "matching": matching_candidates,
        }[op]
    except KeyError:
        raise ValueError(
            f"unknown op {op!r}; known: focal, matching, nms"
        ) from None
    return fn(**kwargs)


def is_default(op: str, params: dict[str, Any]) -> bool:
    """Whether ``params`` is ``op``'s built-in default entry: the one
    candidate a run without a card measures (through the plain version)."""
    return all(params.get(k) == v for k, v in DEFAULT_SCHEDULE[op].items())
