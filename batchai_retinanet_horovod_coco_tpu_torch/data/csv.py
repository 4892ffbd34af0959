"""CSV-format detection dataset, as the JAX package's ``data/csv.py``
(keras-retinanet's ``CSVGenerator`` format):

  annotations.csv   one row per annotation:  path,x1,y1,x2,y2,class_name
                    an image with no annotations is listed as:  path,,,,,
  classes.csv       one row per class:       class_name,id   (ids 0..K-1)

parsed into the ``ImageRecord`` stream that the COCO dataset gives.
Malformed rows, non-numeric or inverted coordinates, and unknown or
duplicate classes raise ``ValueError`` with the line number.  Image sizes
come from the file headers at index time (``data/image_io.py::read_size``,
no pixel decode), since the pipeline picks each image's bucket up front.
"""

from __future__ import annotations

import csv as _csv
import math
import os

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data.coco import ImageRecord
from batchai_retinanet_horovod_coco_tpu_torch.data.image_io import read_size

_EMPTY4 = np.zeros((0, 4), dtype=np.float32)
_EMPTY1 = np.zeros((0,), dtype=np.int32)
_EMPTY1F = np.zeros((0,), dtype=np.float32)


def _parse_num(value: str, what: str, line: int) -> float:
    # Python numeric literals allow digit-group underscores ('1_0' == 10);
    # a CSV containing one is a typo, not a number — reject it.
    if "_" in value:
        raise ValueError(f"line {line}: malformed {what}: {value!r}")
    try:
        parsed = float(value)
    except ValueError:
        raise ValueError(f"line {line}: malformed {what}: {value!r}") from None
    if not math.isfinite(parsed):
        raise ValueError(f"line {line}: malformed {what}: {value!r}")
    return parsed


def _parse_int(value: str, what: str, line: int) -> int:
    # isdecimal, not isdigit: digit-but-not-decimal characters ('²') pass
    # isdigit but are rejected by int().
    if not value.strip().isdecimal():
        raise ValueError(f"line {line}: malformed {what}: {value!r}")
    return int(value)


def read_classes(path: str) -> dict[str, int]:
    """Parse classes.csv → {name: id}; ids must be exactly 0..K-1."""
    mapping: dict[str, int] = {}
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        for row in reader:
            # reader.line_num is the physical file line, correct even when a
            # quoted field spans multiple lines (record index would drift).
            line = reader.line_num
            if not row:
                continue
            if len(row) != 2:
                raise ValueError(
                    f"line {line}: expected 'class_name,id', got {row!r}"
                )
            name, raw_id = row
            if name in mapping:
                raise ValueError(f"line {line}: duplicate class name {name!r}")
            class_id = _parse_int(raw_id, "class id", line)
            if class_id in mapping.values():
                raise ValueError(f"line {line}: duplicate class id {class_id}")
            mapping[name] = class_id
    ids = sorted(mapping.values())
    if ids != list(range(len(ids))):
        raise ValueError(
            f"class ids must be contiguous 0..{len(ids) - 1}, got {ids}"
        )
    return mapping


class CsvDataset:
    """CSV-format dataset exposing the ``CocoDataset`` interface.

    Duck-type contract used downstream (data/pipeline.py, evaluate/detect.py):
    ``records`` (list of ImageRecord), ``num_classes``, ``class_names``,
    ``label_to_cat_id``/``cat_id_to_label`` (identity here — CSV class ids ARE
    the contiguous labels), and ``image_path``.
    """

    def __init__(
        self,
        annotation_file: str,
        classes_file: str,
        image_dir: str | None = None,
        keep_empty: bool = False,
    ):
        self.image_dir = image_dir or os.path.dirname(annotation_file)
        name_to_id = read_classes(classes_file)
        self.class_names = [
            name for name, _ in sorted(name_to_id.items(), key=lambda kv: kv[1])
        ]
        self.cat_id_to_label = {i: i for i in range(len(self.class_names))}
        self.label_to_cat_id = dict(self.cat_id_to_label)

        per_image: dict[str, list[tuple[np.ndarray, int]]] = {}
        order: list[str] = []
        with open(annotation_file, newline="") as f:
            reader = _csv.reader(f)
            for row in reader:
                line = reader.line_num  # physical line, not record index
                if not row:
                    continue
                if len(row) != 6:
                    raise ValueError(
                        f"line {line}: expected "
                        f"'path,x1,y1,x2,y2,class_name', got {row!r}"
                    )
                path, x1, y1, x2, y2, cls = row
                if path not in per_image:
                    per_image[path] = []
                    order.append(path)
                if (x1, y1, x2, y2, cls) == ("", "", "", "", ""):
                    continue  # explicit empty-image row
                box = np.array(
                    [
                        _parse_num(x1, "x1", line),
                        _parse_num(y1, "y1", line),
                        _parse_num(x2, "x2", line),
                        _parse_num(y2, "y2", line),
                    ],
                    dtype=np.float32,
                )
                if box[2] <= box[0]:
                    raise ValueError(
                        f"line {line}: x2 ({x2}) must be > x1 ({x1})"
                    )
                if box[3] <= box[1]:
                    raise ValueError(
                        f"line {line}: y2 ({y2}) must be > y1 ({y1})"
                    )
                if cls not in name_to_id:
                    raise ValueError(f"line {line}: unknown class {cls!r}")
                per_image[path].append((box, name_to_id[cls]))

        self.records: list[ImageRecord] = []
        for image_id, path in enumerate(order):
            anns = per_image[path]
            if not anns and not keep_empty:
                continue
            width, height = self._image_size(os.path.join(self.image_dir, path))
            if anns:
                boxes = np.stack([b for b, _ in anns]).astype(np.float32)
                labels = np.array([l for _, l in anns], dtype=np.int32)
                areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
                areas = areas.astype(np.float32)
            else:
                boxes, labels, areas = _EMPTY4, _EMPTY1, _EMPTY1F
            self.records.append(
                ImageRecord(
                    image_id=image_id,
                    file_name=path,
                    width=width,
                    height=height,
                    boxes=boxes,
                    labels=labels,
                    areas=areas,
                    crowd_boxes=_EMPTY4,
                    crowd_labels=_EMPTY1,
                    crowd_areas=_EMPTY1F,
                )
            )

    @staticmethod
    def _image_size(path: str) -> tuple[int, int]:
        return read_size(path)  # (width, height), from the header only

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.records)

    def image_path(self, record: ImageRecord) -> str:
        return os.path.join(self.image_dir, record.file_name)
