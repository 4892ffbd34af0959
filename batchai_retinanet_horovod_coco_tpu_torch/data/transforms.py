"""Random geometric and photometric augmentation on the host, as the JAX
package's ``data/transforms.py`` (the reference's ``--random-transform``).

A homogeneous 3x3 affine of rotation, translation, shear, scaling and axis
flips about the image centre, with the translation a fraction of the image
size, then brightness, contrast and saturation jitter.  Boxes map through
the affine by their four corners, take the axis-aligned box, are clipped to
the image, and drop when under 1 pixel on a side.

The random draws are the JAX package's, from the same
``numpy.random.Generator`` in the same order, so a seed gives the same
matrix, boxes and jitter.  The pixel operations run in torch on the host
and follow the JAX package's cv2 path, its oracle:
- :func:`warp_image` is ``cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT
  0)``: the inverse map and the bilinear weights in f32, 0 outside the
  image;
- :func:`apply_visual_effects` is ``cv2.mean`` and ``cv2.transform`` with
  the mixing matrix in cv2's 10-bit fixed point.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Ranges for the random affine and the photometric jitter: rotation
    and shear in radians, translation as a fraction of the image size,
    scaling as factors (the reference's defaults)."""

    rotation: tuple[float, float] = (-0.1, 0.1)
    translation: tuple[float, float] = (-0.1, 0.1)
    shear: tuple[float, float] = (-0.1, 0.1)
    scaling: tuple[float, float] = (0.9, 1.1)
    flip_x_prob: float = 0.5
    flip_y_prob: float = 0.0
    # Photometric jitter; identity ranges disable a term.
    brightness: tuple[float, float] = (-0.1, 0.1)  # additive, fraction of 255
    contrast: tuple[float, float] = (0.9, 1.1)
    saturation: tuple[float, float] = (0.95, 1.05)


def _rotation(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _translation(tx: float, ty: float) -> np.ndarray:
    return np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]])


def _shear(angle: float) -> np.ndarray:
    return np.array([[1.0, -np.sin(angle), 0.0], [0.0, np.cos(angle), 0.0], [0.0, 0.0, 1.0]])


def _scaling(sx: float, sy: float) -> np.ndarray:
    return np.diag([sx, sy, 1.0])


def random_transform_matrix(
    config: TransformConfig, rng: np.random.Generator, height: int, width: int
) -> np.ndarray:
    """One 3x3 affine in pixel coordinates about the image centre: rotation
    @ translation @ shear @ scaling @ flip, translation scaled by (width,
    height)."""
    u = lambda lo_hi: float(rng.uniform(*lo_hi))  # noqa: E731
    m = _rotation(u(config.rotation))
    m = m @ _translation(u(config.translation) * width, u(config.translation) * height)
    m = m @ _shear(u(config.shear))
    m = m @ _scaling(u(config.scaling), u(config.scaling))
    flip_x = rng.random() < config.flip_x_prob
    flip_y = rng.random() < config.flip_y_prob
    m = m @ _scaling(-1.0 if flip_x else 1.0, -1.0 if flip_y else 1.0)
    center = _translation(width / 2.0, height / 2.0)
    return center @ m @ np.linalg.inv(center)


def _invert_affine(m: np.ndarray) -> list[float]:
    """``cv2.invertAffineTransform`` of the top two rows, in its order of
    operations (its translation uses the already inverted 2x2)."""
    m = [float(v) for v in m[:2].reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_image(image: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 3x3 affine to a uint8 HWC image, same output size, bilinear,
    0 outside the source: ``cv2.warpAffine`` in torch on the host.

    As cv2 (version 5) computes it: each output pixel's source position
    from the inverted matrix in f32, its floor and fraction, the four taps
    (0 where outside the image) weighted in f32, and the sum rounded half
    to even."""
    h, w = image.shape[:2]
    m = torch.tensor(_invert_affine(matrix), dtype=torch.float64).to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32)[None, :]
    ys = torch.arange(h, dtype=torch.float32)[:, None]
    sx = m[0] * xs + (m[1] * ys + m[2])
    sy = m[3] * xs + (m[4] * ys + m[5])
    x0, y0 = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    src = torch.from_numpy(np.ascontiguousarray(image)).reshape(h * w, -1).to(torch.float32)
    src = torch.cat([src, torch.zeros((1, src.shape[1]))])  # row h*w: the border value 0

    def tap(dy: int, dx: int) -> torch.Tensor:
        ty, tx = y0 + dy, x0 + dx
        inside = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
        index = torch.where(inside, ty * w + tx, h * w)
        return src.index_select(0, index.reshape(-1)).reshape(h, w, -1)

    out = (
        tap(0, 0) * ((1 - ax) * (1 - ay))
        + tap(0, 1) * (ax * (1 - ay))
        + tap(1, 0) * ((1 - ax) * ay)
        + tap(1, 1) * (ax * ay)
    )
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def transform_boxes(
    boxes: np.ndarray, matrix: np.ndarray, height: int, width: int
) -> tuple[np.ndarray, np.ndarray]:
    """Map corner boxes through an affine: the box of the four mapped
    corners, clipped to the image.  Returns ``(boxes, keep)``, ``keep``
    marking boxes still at least 1 pixel on both sides."""
    if len(boxes) == 0:
        return boxes, np.zeros((0,), dtype=bool)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    corners = np.stack(
        [
            np.stack([x1, y1], axis=1),
            np.stack([x2, y1], axis=1),
            np.stack([x1, y2], axis=1),
            np.stack([x2, y2], axis=1),
        ],
        axis=1,
    )  # (N, 4, 2)
    ones = np.ones((*corners.shape[:2], 1))
    mapped = np.concatenate([corners, ones], axis=2) @ matrix.T  # (N, 4, 3)
    xs, ys = mapped[..., 0], mapped[..., 1]
    out = np.stack(
        [xs.min(axis=1), ys.min(axis=1), xs.max(axis=1), ys.max(axis=1)], axis=1
    ).astype(np.float32)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, width)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, height)
    keep = ((out[:, 2] - out[:, 0]) >= 1.0) & ((out[:, 3] - out[:, 1]) >= 1.0)
    return out, keep


_MIX_BITS = 10  # cv2.transform's fixed point for uint8 3x3(+1) matrices


def apply_visual_effects(
    image: np.ndarray, config: TransformConfig, rng: np.random.Generator
) -> np.ndarray:
    """Brightness, contrast and saturation jitter of a uint8 HWC image, as
    one linear pass ``s·c·x + (1−s)·c·gray(x) + k`` (gray = the mean of the
    three channels, contrast about the image's mean after brightness)."""
    b = float(rng.uniform(*config.brightness)) * 255.0
    c = float(rng.uniform(*config.contrast))
    s = float(rng.uniform(*config.saturation))
    a1 = s * c
    a2 = (1.0 - s) * c / 3.0
    pixels = image.reshape(-1, 3)
    channel_means = pixels.sum(axis=0, dtype=np.int64) / pixels.shape[0]  # cv2.mean
    mean = float(sum(channel_means.tolist()) / 3.0) + b
    k = c * b + mean * (1.0 - c)
    # The matrix in f32, then in cv2's fixed point: weights and offset
    # times 1 << 10, rounded half to even.
    diag = np.float32(a1 + a2)
    off = np.float32(a2)
    one = float(1 << _MIX_BITS)
    w_diag = int(np.round(np.float32(diag * np.float32(one))))
    w_off = int(np.round(np.float32(off * np.float32(one))))
    w_k = int(np.round(np.float32(np.float32(k) * np.float32(one))))
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.int32)
    total = x.sum(dim=2, keepdim=True)
    out = x * (w_diag - w_off) + total * w_off + w_k + (1 << (_MIX_BITS - 1))
    return (out >> _MIX_BITS).clamp(0, 255).to(torch.uint8).numpy()


def apply_random_transform(
    image: np.ndarray,
    boxes: np.ndarray,
    labels: np.ndarray,
    config: TransformConfig,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One full augmentation draw: affine warp, box remap, photometric."""
    h, w = image.shape[:2]
    matrix = random_transform_matrix(config, rng, h, w)
    image = warp_image(image, matrix)
    boxes, keep = transform_boxes(boxes, matrix, h, w)
    image = apply_visual_effects(image, config, rng)
    return image, boxes[keep], labels[keep]
