"""Data layer, as the JAX package's ``data/``: COCO, CSV and Pascal VOC
annotation readers, synthetic datasets, the image decoder
(``image_io.py``), augmentation (``transforms.py``) and the bucketed input
pipeline (``pipeline.py``), with device prefetch (``prefetch.py``)."""

from batchai_retinanet_horovod_coco_tpu_torch.data.coco import CocoDataset, ImageRecord
from batchai_retinanet_horovod_coco_tpu_torch.data.csv import CsvDataset
from batchai_retinanet_horovod_coco_tpu_torch.data.pascal_voc import VOC_CLASSES, PascalVocDataset
from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import (
    Batch,
    PipelineConfig,
    PipelineStats,
    build_pipeline,
    resolve_max_gt,
)
from batchai_retinanet_horovod_coco_tpu_torch.data.synthetic import make_synthetic_coco
from batchai_retinanet_horovod_coco_tpu_torch.data.transforms import TransformConfig

__all__ = [
    "Batch",
    "CocoDataset",
    "CsvDataset",
    "ImageRecord",
    "PascalVocDataset",
    "PipelineConfig",
    "PipelineStats",
    "VOC_CLASSES",
    "TransformConfig",
    "build_pipeline",
    "resolve_max_gt",
    "make_synthetic_coco",
]
