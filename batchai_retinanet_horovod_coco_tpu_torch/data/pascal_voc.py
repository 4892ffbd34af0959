"""Pascal VOC detection dataset, as the JAX package's
``data/pascal_voc.py`` (keras-retinanet's ``PascalVocGenerator``), over the
VOCdevkit layout:

    <root>/ImageSets/Main/<split>.txt    image ids, one per line
    <root>/Annotations/<id>.xml          objects: name + bndbox (1-based)
    <root>/JPEGImages/<id>.jpg

- the 20 VOC classes map to labels 0..19 in their canonical order;
- ``bndbox`` coordinates are 1-based, and the reference subtracts 1 from
  all four, as this parser does;
- ``difficult`` objects go to the record's ignore set (``crowd_*``, which
  the COCO oracle treats as ignore regions), or are dropped with
  ``skip_difficult=True``;
- image sizes come from the XML ``<size>`` block when present, else from
  the image header (``data/image_io.py::read_size``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from batchai_retinanet_horovod_coco_tpu_torch.data.coco import ImageRecord
from batchai_retinanet_horovod_coco_tpu_torch.data.image_io import read_size

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _parse_box(obj: ET.Element, image_id: str) -> tuple[np.ndarray, str, bool]:
    name_el = obj.find("name")
    box_el = obj.find("bndbox")
    if name_el is None or box_el is None:
        raise ValueError(f"{image_id}: malformed <object> (missing name/bndbox)")

    def coord(tag: str) -> float:
        el = box_el.find(tag)
        if el is None or el.text is None:
            raise ValueError(f"{image_id}: missing <{tag}>")
        return float(el.text)

    # VOC coords are 1-based; the reference generator subtracts 1 from ALL
    # FOUR coordinates (keras-retinanet __parse_annotation), so parity keeps
    # that convention (boxes are 1px narrower than the strict
    # inclusive→exclusive conversion would give; matching the reference
    # outweighs the devkit pedantry).
    box = np.array(
        [
            coord("xmin") - 1,
            coord("ymin") - 1,
            coord("xmax") - 1,
            coord("ymax") - 1,
        ],
        dtype=np.float32,
    )
    difficult_el = obj.find("difficult")
    difficult = bool(int(difficult_el.text)) if (
        difficult_el is not None and difficult_el.text
    ) else False
    return box, (name_el.text or "").strip(), difficult


class PascalVocDataset:
    """VOCdevkit dataset exposing the ``CocoDataset`` duck-type interface."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        classes: tuple[str, ...] = VOC_CLASSES,
        skip_difficult: bool = False,
        keep_empty: bool = False,
    ):
        self.root = root
        self.image_dir = os.path.join(root, "JPEGImages")
        self.class_names = list(classes)
        name_to_label = {n: i for i, n in enumerate(self.class_names)}
        self.cat_id_to_label = {i: i for i in range(len(self.class_names))}
        self.label_to_cat_id = dict(self.cat_id_to_label)

        split_file = os.path.join(root, "ImageSets", "Main", f"{split}.txt")
        with open(split_file) as f:
            ids = [line.split(None, 1)[0] for line in f if line.strip()]

        self.records: list[ImageRecord] = []
        for image_id, vid in enumerate(ids):
            xml_path = os.path.join(root, "Annotations", f"{vid}.xml")
            tree = ET.parse(xml_path)
            troot = tree.getroot()

            fname_el = troot.find("filename")
            file_name = (
                fname_el.text.strip()
                if fname_el is not None and fname_el.text
                else f"{vid}.jpg"
            )
            size = troot.find("size")
            w_el = size.find("width") if size is not None else None
            h_el = size.find("height") if size is not None else None
            if (
                w_el is not None and w_el.text
                and h_el is not None and h_el.text
            ):
                width = int(float(w_el.text))
                height = int(float(h_el.text))
            else:
                width, height = read_size(os.path.join(self.image_dir, file_name))

            boxes, labels, ign_boxes, ign_labels = [], [], [], []
            for obj in troot.iter("object"):
                box, name, difficult = _parse_box(obj, vid)
                if name not in name_to_label:
                    raise ValueError(f"{vid}: unknown class {name!r}")
                if difficult:
                    if not skip_difficult:
                        ign_boxes.append(box)
                        ign_labels.append(name_to_label[name])
                    continue
                boxes.append(box)
                labels.append(name_to_label[name])

            if not boxes and not keep_empty:
                continue

            def pack(bs, ls):
                b = (
                    np.stack(bs).astype(np.float32)
                    if bs
                    else np.zeros((0, 4), np.float32)
                )
                l = np.asarray(ls, np.int32)
                areas = (
                    (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
                ).astype(np.float32)
                return b, l, areas

            b, l, a = pack(boxes, labels)
            ib, il, ia = pack(ign_boxes, ign_labels)
            self.records.append(
                ImageRecord(
                    image_id=image_id,
                    file_name=file_name,
                    width=width,
                    height=height,
                    boxes=b,
                    labels=l,
                    areas=a,
                    # Difficult objects ride the ignore channel: the COCO
                    # oracle marks crowd matches neither TP nor FP, VOC
                    # eval's difficult treatment.
                    crowd_boxes=ib,
                    crowd_labels=il,
                    crowd_areas=ia,
                )
            )

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def __len__(self) -> int:
        return len(self.records)

    def image_path(self, record: ImageRecord) -> str:
        return os.path.join(self.image_dir, record.file_name)
