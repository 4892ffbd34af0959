"""COCO instances-JSON parsing without pycocotools, as the JAX package's
``data/coco.py``.

The sparse COCO category ids map onto contiguous labels 0..K-1, sorted by
category id (the pycocotools convention), and boxes convert from COCO
``[x, y, w, h]`` to corners ``[x1, y1, x2, y2]`` once, at load time.  Crowd
annotations (``iscrowd=1``) are kept apart from the training boxes, so
that evaluation can mark them ignore as COCOeval does, and each
annotation's ``area`` is kept for COCOeval's area ranges.  Pure json and
numpy: no image is decoded here.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    image_id: int
    file_name: str
    width: int
    height: int
    boxes: np.ndarray  # (N, 4) float32 corner boxes (non-crowd)
    labels: np.ndarray  # (N,) int32 contiguous labels
    areas: np.ndarray  # (N,) float32 annotation areas (COCOeval ranges)
    crowd_boxes: np.ndarray  # (C, 4) float32 corner boxes (iscrowd=1)
    crowd_labels: np.ndarray  # (C,) int32
    crowd_areas: np.ndarray  # (C,) float32


class CocoDataset:
    """In-memory index of a COCO-format detection dataset; images without
    a non-crowd annotation are left out unless ``keep_empty``."""

    def __init__(self, annotation_file: str, image_dir: str | None = None, keep_empty: bool = False):
        with open(annotation_file) as f:
            blob = json.load(f)

        self.image_dir = image_dir or os.path.dirname(annotation_file)
        categories = sorted(blob.get("categories", []), key=lambda c: c["id"])
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(categories)}
        self.label_to_cat_id = {i: c["id"] for i, c in enumerate(categories)}
        self.class_names = [c["name"] for c in categories]

        per_image: dict[int, list[dict]] = {}
        for ann in blob.get("annotations", []):
            per_image.setdefault(ann["image_id"], []).append(ann)

        self.records: list[ImageRecord] = []
        for img in blob.get("images", []):
            anns = per_image.get(img["id"], [])
            normal = [a for a in anns if not a.get("iscrowd", 0)]
            crowd = [a for a in anns if a.get("iscrowd", 0)]
            if not normal and not keep_empty:
                continue
            self.records.append(
                ImageRecord(
                    image_id=img["id"],
                    file_name=img["file_name"],
                    width=img["width"],
                    height=img["height"],
                    **self._pack(normal, prefix=""),
                    **self._pack(crowd, prefix="crowd_"),
                )
            )

    def _pack(self, anns: list[dict], prefix: str) -> dict[str, np.ndarray]:
        boxes = np.zeros((len(anns), 4), dtype=np.float32)
        labels = np.zeros((len(anns),), dtype=np.int32)
        areas = np.zeros((len(anns),), dtype=np.float32)
        for i, ann in enumerate(anns):
            x, y, w, h = ann["bbox"]
            boxes[i] = [x, y, x + w, y + h]
            labels[i] = self.cat_id_to_label[ann["category_id"]]
            areas[i] = ann.get("area", w * h)
        return {f"{prefix}boxes": boxes, f"{prefix}labels": labels, f"{prefix}areas": areas}

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.records)

    def image_path(self, record: ImageRecord) -> str:
        return os.path.join(self.image_dir, record.file_name)
