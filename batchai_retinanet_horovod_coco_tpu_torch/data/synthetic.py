"""Synthetic COCO-format datasets for tests, overfit runs and the
convergence gate, as the JAX package's ``data/synthetic.py``.

Colored axis-aligned rectangles on noise backgrounds, the class encoded in
the rectangle's color, written as image files and an ``instances_<split>
.json``, so the whole file path (decode, resize, bucketing, the eval JSON)
runs end to end.  The random draws, annotations and pixels are the JAX
package's for the same arguments; the files differ: the port has no JPEG
encoder, so it writes **PNG** (``data/image_io.py::encode_png``, filter 0
and zlib), named ``<id>.png``, which decode to exactly the drawn pixels,
where the JAX package writes JPEG at quality 92.
"""

from __future__ import annotations

import json
import os

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data.image_io import encode_png
from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_write_bytes, atomic_write_text

# A fixed palette: class k gets a distinct hue so the task is learnable.
_PALETTE = [
    (220, 40, 40),
    (40, 220, 40),
    (40, 40, 220),
    (220, 220, 40),
    (220, 40, 220),
    (40, 220, 220),
    (240, 140, 20),
    (140, 20, 240),
]


def make_synthetic_coco(
    root: str,
    num_images: int = 64,
    num_classes: int = 3,
    image_size: tuple[int, int] = (256, 256),
    max_objects: int = 4,
    seed: int = 0,
    split: str = "train",
) -> str:
    """Write a synthetic COCO dataset under ``root``; returns the path of
    its annotation file."""
    if num_classes > len(_PALETTE):
        raise ValueError(f"at most {len(_PALETTE)} classes, got {num_classes}")
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    h, w = image_size
    for image_id in range(1, num_images + 1):
        canvas = rng.integers(90, 120, size=(h, w, 3), dtype=np.uint8)
        n_obj = int(rng.integers(1, max_objects + 1))
        for _ in range(n_obj):
            bw = int(rng.integers(max(8, w // 8), w // 2))
            bh = int(rng.integers(max(8, h // 8), h // 2))
            x1 = int(rng.integers(0, w - bw))
            y1 = int(rng.integers(0, h - bh))
            label = int(rng.integers(0, num_classes))
            canvas[y1 : y1 + bh, x1 : x1 + bw] = _PALETTE[label]
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": image_id,
                    "category_id": label + 1,
                    "bbox": [float(x1), float(y1), float(bw), float(bh)],
                    "area": float(bw * bh),
                    "iscrowd": 0,
                }
            )
            ann_id += 1
        file_name = f"{image_id:06d}.png"
        atomic_write_bytes(os.path.join(img_dir, file_name), encode_png(canvas), fsync=False)
        images.append({"id": image_id, "file_name": file_name, "width": w, "height": h})

    blob = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": k + 1, "name": f"class{k}"} for k in range(num_classes)],
    }
    ann_path = os.path.join(root, f"instances_{split}.json")
    # Atomic: a reader never sees a half-written annotation file.
    atomic_write_text(ann_path, json.dumps(blob))
    return ann_path
