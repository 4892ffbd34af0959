"""Inputs aimed at the designs of the NMS and matching kernels, in numpy.

``chip_smoke.py`` and the tests build their cases with these, so that the
card and the CPU hold the kernels to the same inputs.

NMS (sorted candidates: boxes (B, K, 4) f32, scores (B, K) f32, class ids
(B, K) int32), aimed at the blocked scan's 64-candidate words:
:func:`one_box_repeated`, :func:`disjoint_boxes`, :func:`suppression_chain`.

Matching: the edits of ``CULLING_EDITS`` reshape padded gts (boxes
(B, G, 4) f32 and mask (B, G) bool, in place) against the tiles of a given
number of anchors, aimed at the kernel's culling of gt rows per tile.
"""

from __future__ import annotations

import numpy as np


def one_box_repeated(batch: int, k: int):
    """One class, one box K times, scores descending: one kept an image."""
    boxes = np.tile(np.array([5.0, 5.0, 50.0, 50.0], np.float32), (batch, k, 1))
    scores = np.tile(np.linspace(1.0, 0.1, k, dtype=np.float32), (batch, 1))
    return boxes, scores, np.zeros((batch, k), np.int32)


def disjoint_boxes(batch: int, k: int):
    """K pairwise-disjoint boxes of one class on a grid: all kept."""
    i = np.arange(k, dtype=np.float32)
    x, y = (i % 40) * 10, (i // 40) * 10
    boxes = np.tile(np.stack([x, y, x + 8, y + 8], -1), (batch, 1, 1))
    scores = np.tile(np.linspace(1.0, 0.1, k, dtype=np.float32), (batch, 1))
    return boxes, scores, np.zeros((batch, k), np.int32)


def suppression_chain(block: int = 128):
    """One image of 3 * ``block`` candidates in score order, one class: a
    kept box (0) with copies one and two blocks later (block + 1,
    2 block + 2), and a box it suppresses (1) whose own copy (2 block + 5)
    it suppresses too; big random boxes elsewhere."""
    k = 3 * block
    rng = np.random.default_rng(7)
    xy = rng.uniform(0, 1000, (k, 2)).astype(np.float32)
    wh = rng.uniform(500, 600, (k, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    base = np.array([10.0, 10.0, 100.0, 100.0], np.float32)
    shifted = base + np.array([20.0, 0.0, 20.0, 0.0], np.float32)  # IoU ≈ 0.64
    boxes[0] = base
    boxes[1] = shifted
    boxes[block + 1] = base
    boxes[2 * block + 2] = base
    boxes[2 * block + 5] = shifted
    scores = np.linspace(1.0, 0.5, k).astype(np.float32)
    return boxes[None].copy(), scores[None].copy(), np.zeros((1, k), np.int32)


def tile_boxes(anchors: np.ndarray, tile: int) -> np.ndarray:
    """(T, 4): the bounding box of each tile of ``tile`` anchors."""
    tiles = [anchors[i:i + tile] for i in range(0, len(anchors), tile)]
    return np.stack([np.concatenate([t[:, :2].min(0), t[:, 2:].max(0)]) for t in tiles])


def scatter_rows(boxes, mask, rng, anchors, tile) -> None:
    """Real rows after padded ones: each image's rows in a random order."""
    for b in range(len(mask)):
        perm = rng.permutation(mask.shape[1])
        boxes[b], mask[b] = boxes[b, perm], mask[b, perm]


def off_anchor_rows(boxes, mask, rng, anchors, tile) -> None:
    """Every other real gt becomes one that overlaps no anchor (zero width,
    zero height, beyond every anchor) or lies outside the image."""
    far = anchors[:, 2:].max(0) + 50
    edge = anchors[:, 2:].max(0) - 40  # right of and below the image, within anchors
    for b in range(len(mask)):
        for i, g in enumerate(np.flatnonzero(mask[b])[::2]):
            x1, y1, x2, y2 = boxes[b, g]
            boxes[b, g] = [
                [x1, y1, x1, y2],
                [x1, y1, x2, y1],
                [far[0], far[1], far[0] + 30, far[1] + 20],
                [edge[0], edge[1], edge[0] + 30, edge[1] + 20],
            ][i % 4]


def tile_edge_rows(boxes, mask, rng, anchors, tile) -> None:
    """Every other real gt gets an edge exactly on an edge of a tile's box:
    touching it from outside (off that tile's list) or lying inside it
    along its edge (on the list)."""
    tb = tile_boxes(anchors, tile)
    for b in range(len(mask)):
        for i, g in enumerate(np.flatnonzero(mask[b])[1::2]):
            x1, y1, x2, y2 = tb[rng.integers(len(tb))]
            u, v = x1 + (x2 - x1) * rng.uniform(), y1 + (y2 - y1) * rng.uniform()
            w, h = np.round(rng.uniform(2, 60, 2) * 4) / 4
            boxes[b, g] = [
                [x2, v, x2 + w, v + h],  # left edge on the right edge
                [x1 - w, v, x1, v + h],  # right edge on the left edge
                [u, y2, u + w, y2 + h],  # top edge on the bottom edge
                [u, y1 - h, u + w, y1],  # bottom edge on the top edge
                [x1, y1, x1 + w, y1 + h],  # inside, corner on corner
                [x2 - w, y2 - h, x2, y2],
            ][i % 6]


def last_tile_row(boxes, mask, rng, anchors, tile) -> None:
    """Image 0 keeps one real gt, at a random row, overlapping the box of
    the last (ragged) tile and no other tile's: beyond the other tiles'
    far edge on an axis where the last tile reaches further."""
    tb = tile_boxes(anchors, tile)
    far = tb[:-1, 2:].max(0)  # the other tiles' largest x2, y2
    axis = 0 if far[0] < tb[-1, 2] else 1
    if not (far[axis] < tb[-1, 2 + axis] and len(anchors) % tile):
        raise ValueError(f"no ragged last tile of {tile} anchors reaches past the others")
    lo, hi = far[axis], min(far[axis] + 40, tb[-1, 2 + axis])
    o1 = tb[-1, 1 - axis] + 8
    o2 = min(o1 + 40, tb[-1, 3 - axis])
    g = rng.integers(mask.shape[1])
    mask[0] = False
    mask[0, g] = True
    boxes[0, g] = [lo, o1, hi, o2] if axis == 0 else [o1, lo, o2, hi]


CULLING_EDITS = {
    "scatter": scatter_rows,
    "off anchors": off_anchor_rows,
    "tile edges": tile_edge_rows,
    "last tile": last_tile_row,
}
