"""Anchor generation for FPN levels P3..P7.

Capability parity with keras-retinanet's anchor machinery (SURVEY.md M5:
``utils/anchors.py`` — sizes 32..512, strides 8..128, 3 ratios x 3 scales = 9
anchors per location), re-designed for TPU/XLA:

- Anchors are a *static* function of the (bucketed) padded image shape, so we
  compute them once per shape bucket in numpy on host and close over them as
  compile-time constants of the jit'd train/eval step.  XLA constant-folds
  them into the program; nothing is recomputed per step (unlike the reference,
  which regenerates anchors per image inside the data-loader hot loop,
  SURVEY.md call stack 3.3).
- All shapes are fixed: for a given image bucket the anchor count A is a
  Python int, which keeps every downstream op (IoU, matching, NMS) statically
  shaped for the MXU.

Boxes are ``(x1, y1, x2, y2)`` in image pixels throughout the codebase.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor pyramid hyperparameters (RetinaNet defaults, Lin et al. 2017)."""

    # One entry per pyramid level P3..P7.
    levels: tuple[int, ...] = (3, 4, 5, 6, 7)
    strides: tuple[int, ...] = (8, 16, 32, 64, 128)
    sizes: tuple[int, ...] = (32, 64, 128, 256, 512)
    ratios: tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: tuple[float, ...] = (2 ** 0.0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0))

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.ratios) * len(self.scales)

    def feature_shape(self, image_hw: tuple[int, int], level: int) -> tuple[int, int]:
        """Feature-map shape at ``level`` for a padded image of ``image_hw``.

        Matches the backbones' conv stride arithmetic — symmetric k//2
        padding (torch geometry, models/resnet.py) — which, like SAME,
        yields ceil(dim / stride) for every input parity.
        """
        stride = self.strides[self.levels.index(level)]
        return (
            int(math.ceil(image_hw[0] / stride)),
            int(math.ceil(image_hw[1] / stride)),
        )

    def num_anchors(self, image_hw: tuple[int, int]) -> int:
        total = 0
        for level in self.levels:
            fh, fw = self.feature_shape(image_hw, level)
            total += fh * fw * self.num_anchors_per_location
        return total


def generate_base_anchors(
    size: float,
    ratios: tuple[float, ...],
    scales: tuple[float, ...],
) -> np.ndarray:
    """(len(ratios)*len(scales), 4) anchors centered at the origin.

    For each (ratio, scale): area = (size*scale)^2, h/w = ratio.  Ordering is
    ratio-major to keep a deterministic layout: index = r * len(scales) + s.
    """
    anchors = []
    for ratio in ratios:
        for scale in scales:
            area = (size * scale) ** 2
            w = math.sqrt(area / ratio)
            h = w * ratio
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, dtype=np.float32)


def _anchors_for_level(
    feat_hw: tuple[int, int],
    stride: int,
    base_anchors: np.ndarray,
) -> np.ndarray:
    """Shift base anchors over every feature-map location → (H*W*K, 4)."""
    fh, fw = feat_hw
    shift_x = (np.arange(fw, dtype=np.float32) + 0.5) * stride
    shift_y = (np.arange(fh, dtype=np.float32) + 0.5) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)  # (fh, fw)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)  # (H*W,1,4)
    out = shifts + base_anchors[None, :, :]  # (H*W, K, 4)
    return out.reshape(-1, 4).astype(np.float32)


@lru_cache(maxsize=64)
def _anchors_cached(image_hw: tuple[int, int], config: AnchorConfig) -> np.ndarray:
    per_level = []
    for i, level in enumerate(config.levels):
        base = generate_base_anchors(config.sizes[i], config.ratios, config.scales)
        feat_hw = config.feature_shape(image_hw, level)
        per_level.append(_anchors_for_level(feat_hw, config.strides[i], base))
    out = np.concatenate(per_level, axis=0)
    out.setflags(write=False)  # shared cached array: in-place edits would
    return out  # silently corrupt every later caller


def anchors_for_image_shape(
    image_hw: tuple[int, int],
    config: AnchorConfig | None = None,
) -> np.ndarray:
    """All anchors for a padded image shape, concatenated P3→P7: (A, 4).

    Host-side numpy; cached per shape bucket.  The result is closed over by the
    jit'd step as a constant (see ``train/step.py``), making anchor generation
    free at runtime.
    """
    config = config or AnchorConfig()
    return _anchors_cached((int(image_hw[0]), int(image_hw[1])), config)


def anchors_for_rows(
    image_hw: tuple[int, int],
    config: AnchorConfig,
    num_space: int,
    index: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The anchors of space rank ``index`` of ``num_space`` under spatial
    partitioning: ``(anchors (A_local, 4), global_index (A_local,) int64)``.

    Level by level, the rank owns the rows of each feature map that the
    row split gives it (``parallel/spatial.py::rows_of``), and its anchors
    are the global anchors of those rows (:func:`anchors_for_image_shape`),
    in the order the heads flatten a shard: level, then local (y, x), then
    anchor.  Trap: they are never regenerated from the shard's own shape,
    whose anchor centres would start again at row 0.  ``global_index``
    is each one's index in the global anchors, increasing."""
    from batchai_retinanet_horovod_coco_tpu_torch.parallel.spatial import rows_of

    full = anchors_for_image_shape(image_hw, config)
    per_location = config.num_anchors_per_location
    parts, offset = [], 0
    for level in config.levels:
        fh, fw = config.feature_shape(image_hw, level)
        r0, r1 = rows_of(fh, num_space, index)
        per_row = fw * per_location
        parts.append(np.arange(offset + r0 * per_row, offset + r1 * per_row, dtype=np.int64))
        offset += fh * per_row
    global_index = np.concatenate(parts)
    return full[global_index], global_index
