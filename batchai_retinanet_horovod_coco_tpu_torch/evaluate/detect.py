"""Detection: normalize → forward → sigmoid → decode → clip → batched NMS.

The JAX package's ``evaluate/detect.py::_detect_body`` and
``detections_to_coco``.  The NMS suppression stage is
``ops.cuda.nms.batched_multiclass_nms_cuda``: the hand-written CUDA kernel
on a card, the plain ``greedy_keep`` on the CPU — decided by the device the
tensors are on, never by a fallback.  The schedule registry of the JAX
package (``tune/``) is not ported: the knobs are the fixed defaults below.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data import pipeline as pipeline_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import anchors as anchors_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import boxes as boxes_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops import nms as nms_lib
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    """FilterDetections-equivalent knobs (the reference's defaults)."""

    score_threshold: float = 0.05
    iou_threshold: float = 0.5
    pre_nms_size: int = 1000
    max_detections: int = 300
    codec: boxes_lib.BoxCodecConfig = boxes_lib.BoxCodecConfig()
    anchor: anchors_lib.AnchorConfig = anchors_lib.AnchorConfig()


def postprocess(
    outputs: dict[str, torch.Tensor],
    anchors: torch.Tensor,
    image_hw: tuple[int, int],
    config: DetectConfig,
    nms: Callable[..., nms_lib.Detections] = nms_cuda.batched_multiclass_nms_cuda,
) -> nms_lib.Detections:
    """Forward outputs → Detections: sigmoid in f32 → decode against
    ``anchors`` (A, 4) → clip to the bucket extent (not the image: the
    conversion re-clamps to the true image) → ``nms``."""
    scores = torch.sigmoid(outputs["cls_logits"])  # (B, A, K)
    boxes = boxes_lib.decode_boxes(anchors[None], outputs["box_deltas"], config.codec)
    boxes = boxes_lib.clip_boxes(boxes, image_hw)
    return nms(
        boxes,
        scores,
        score_threshold=config.score_threshold,
        iou_threshold=config.iou_threshold,
        pre_nms_size=config.pre_nms_size,
        max_detections=config.max_detections,
    )


def anchors_on(
    image_hw: tuple[int, int], config: anchors_lib.AnchorConfig, device: torch.device
) -> torch.Tensor:
    """The (A, 4) f32 anchors of a padded image shape, on ``device``."""
    return torch.from_numpy(
        np.array(anchors_lib.anchors_for_image_shape(image_hw, config))
    ).to(device)


def to_device_images(images, device: torch.device) -> torch.Tensor:
    """A (B, H, W, 3) batch (numpy or torch) on ``device``; host memory is
    pinned so the copy to a card does not block the host."""
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(np.ascontiguousarray(images))
    if images.device == device:
        return images
    if device.type == "cuda":
        return images.pin_memory().to(device, non_blocking=True)
    return images.to(device)


def make_detect_fn(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    config: DetectConfig = DetectConfig(),
    device: str | torch.device = "cuda",
) -> Callable[[object], nms_lib.Detections]:
    """``detect(images (B, H, W, 3) uint8) → Detections`` for one bucket,
    on ``device`` (``cuda`` unless the caller asks for the CPU; without a
    card it raises).  ``model`` is moved to ``device`` and put in eval
    mode.  On a card the call returns without synchronising: read the
    result with ``.cpu()``."""
    device = resolve_device(device)
    model = model.to(device).eval()
    anchors = anchors_on(image_hw, config.anchor, device)

    def detect(images) -> nms_lib.Detections:
        x = to_device_images(images, device)
        if tuple(x.shape[1:3]) != tuple(image_hw):
            raise ValueError(f"batch of {tuple(x.shape)} for bucket {image_hw}")
        with torch.inference_mode():
            outputs = model(pipeline_lib.normalize_images(x))
            return postprocess(outputs, anchors, image_hw, config)

    return detect


def detections_to_coco(
    det: nms_lib.Detections,
    image_ids: np.ndarray,
    scales: np.ndarray,
    valid_rows: np.ndarray,
    label_to_cat_id: dict[int, int],
    image_sizes: dict[int, tuple[int, int]] | None = None,
) -> list[dict]:
    """Detections (one batch, numpy) → COCO result dicts in ORIGINAL coords.

    Boxes come back in resized-image coordinates; dividing by the per-image
    scale restores original coordinates.  The device-side clip is to the
    static bucket extent (which includes padding), so with ``image_sizes``
    ({image_id: (width, height)}) boxes are re-clamped to the true image
    bounds here; degenerate (zero-area) boxes — e.g. spurious hits entirely
    inside the padding — are dropped.
    """
    boxes = np.asarray(det.boxes, dtype=np.float64)
    scores = np.asarray(det.scores, dtype=np.float64)
    labels = np.asarray(det.labels)
    valid = np.asarray(det.valid)

    results: list[dict] = []
    for i in range(boxes.shape[0]):
        if not valid_rows[i]:
            continue  # eval padding row
        inv = 1.0 / float(scales[i])
        img_id = int(image_ids[i])
        wh = image_sizes.get(img_id) if image_sizes else None
        for j in np.flatnonzero(valid[i]):
            x1, y1, x2, y2 = boxes[i, j] * inv
            if wh is not None:
                x1, x2 = np.clip([x1, x2], 0.0, wh[0])
                y1, y2 = np.clip([y1, y2], 0.0, wh[1])
                if x2 <= x1 or y2 <= y1:
                    continue
            results.append(
                {
                    "image_id": img_id,
                    "category_id": int(label_to_cat_id[int(labels[i, j])]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(scores[i, j]),
                }
            )
    return results
