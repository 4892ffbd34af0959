"""Writes the JPEG fixtures of this folder and ``digests.json``, with PIL,
from seeded arrays:

    python tests/fixtures/jpeg/make_fixtures.py

Four 640x480 images (quality 92, 4:2:0: COCO's typical size and
sampling), 4:4:4 and 4:2:2 files, a grey file, one with a restart interval,
a 33x47 file, and a progressive one (which the port's decoder refuses).
The JSON holds each file's shape and the sha256 of its pixels as PIL
decodes them (``np.asarray(Image.open(f).convert("RGB"))``), for machines
without PIL.
"""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def scene(seed: int, h: int, w: int) -> np.ndarray:
    """A smooth two-tone gradient, a few flat rectangles and ellipses, and
    light noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    c0, c1 = rng.uniform(40, 210, 3), rng.uniform(40, 210, 3)
    t = (0.6 * xx + 0.4 * yy)[..., None]
    img = c0 * (1 - t) + c1 * t
    for _ in range(int(rng.integers(3, 7))):
        color = rng.uniform(0, 255, 3)
        x0, y0 = rng.uniform(0, 0.8, 2)
        bw, bh = rng.uniform(0.08, 0.3, 2)
        if rng.random() < 0.5:
            inside = (xx >= x0) & (xx < x0 + bw) & (yy >= y0) & (yy < y0 + bh)
        else:
            inside = ((xx - x0 - bw / 2) / (bw / 2)) ** 2 + ((yy - y0 - bh / 2) / (bh / 2)) ** 2 < 1
        img[inside] = color
    img += rng.normal(0, 2.0, img.shape)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


FIXTURES = {
    # name: (seed, (h, w), PIL save options, grey)
    "coco_0.jpg": (0, (480, 640), dict(quality=92, subsampling=2), False),
    "coco_1.jpg": (1, (480, 640), dict(quality=92, subsampling=2), False),
    "coco_2.jpg": (2, (480, 640), dict(quality=92, subsampling=2), False),
    "coco_3.jpg": (3, (480, 640), dict(quality=92, subsampling=2), False),
    "sampling_444.jpg": (4, (120, 160), dict(quality=92, subsampling=0), False),
    "sampling_422.jpg": (5, (120, 160), dict(quality=92, subsampling=1), False),
    "grey.jpg": (6, (120, 160), dict(quality=92), True),
    "restart.jpg": (7, (120, 160), dict(quality=92, subsampling=2, restart_marker_blocks=5), False),
    "odd_33x47.jpg": (8, (33, 47), dict(quality=92, subsampling=2), False),
    "progressive.jpg": (9, (48, 64), dict(quality=92, progressive=True), False),
}


def main() -> None:
    digests = {}
    for name, (seed, (h, w), options, grey) in FIXTURES.items():
        img = scene(seed, h, w)
        pil = Image.fromarray(img).convert("L") if grey else Image.fromarray(img)
        pil.save(HERE / name, "JPEG", **options)
        with Image.open(HERE / name) as im:
            pixels = np.asarray(im.convert("RGB"))
        digests[name] = {
            "shape": list(pixels.shape),
            "sha256": hashlib.sha256(pixels.tobytes()).hexdigest(),
            "progressive": bool(options.get("progressive", False)),
        }
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()
