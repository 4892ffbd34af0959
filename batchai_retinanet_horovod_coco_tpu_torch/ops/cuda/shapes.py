"""The launch shapes of the CUDA kernel libraries: each kernel's menu and
its default, the one list on the Python side (each launcher's ``switch``
in its ``.cu`` source is the list on the C side, and returns
``cudaErrorInvalidValue`` for a shape off it).

Torch-free, so that the schedule registry (``tune/schedule.py``) can name
the menus without loading a library.  The defaults are the kernels' launch
shapes before the menus existed, so a device with no schedule file
launches exactly those.  Units, by ``(op, key)`` as the registry names
them:

- ``("matching", "tile_a")``: anchors a block of the matching kernel (one
  anchor a thread);
- ``("focal", "fwd_tile_a")``: groups a forward block sums (256 threads x
  groups a thread; a group is the 4 logits of one 16-byte load, or 1 where
  K is no multiple of 4); each tile sums in its own order, so two tiles'
  sums may differ in their last bits;
- ``("focal", "bwd_tile_a")``: threads, hence groups, a backward block;
- ``("nms", "mask_lanes")``: threads sharing one row of the NMS mask pass's
  64 x 64 block (the pass runs 64 x lanes threads a block);
- ``("nms", "scan_threads")``: threads of the NMS scan's one block an image.

Every shape but the focal forward's gives the same result bit for bit.
"""

from __future__ import annotations

#: (op, key) -> the shapes the kernel library instantiates.
MENUS: dict[tuple[str, str], tuple[int, ...]] = {
    ("matching", "tile_a"): (128, 256),
    ("focal", "fwd_tile_a"): (1024, 2048),
    ("focal", "bwd_tile_a"): (128, 256),
    ("nms", "mask_lanes"): (2, 4, 8),
    ("nms", "scan_threads"): (256, 512),
}

#: (op, key) -> the shape a caller naming none launches.
DEFAULTS: dict[tuple[str, str], int] = {
    ("matching", "tile_a"): 256,
    ("focal", "fwd_tile_a"): 2048,
    ("focal", "bwd_tile_a"): 256,
    ("nms", "mask_lanes"): 4,
    ("nms", "scan_threads"): 256,
}


def resolve(op: str, key: str, value: int | None) -> int:
    """``value`` checked against the menu of ``(op, key)``; None is the
    default.  Raises ValueError off the menu."""
    if value is None:
        return DEFAULTS[(op, key)]
    menu = MENUS[(op, key)]
    if isinstance(value, bool) or value not in menu:
        raise ValueError(f"{op} {key} {value!r} is not on the kernel's menu {list(menu)}")
    return int(value)
