"""Exported inference artifacts: what ``convert_model`` writes and the
server loads, as the JAX package's ``evaluate/export.py``.

A trained model becomes a directory of self-contained detection programs
(forward → decode → clip → NMS, the weights inside) that run without the
model code.  Each program is ``evaluate/detect.py::DetectProgram`` for one
(shape bucket, batch size), exported with ``torch.export`` on the device it
will serve on and saved with ``torch.export.save``.  Its NMS suppression
is a call of the custom op ``retinanet_torch::nms_keep_mask``, so the
loaded program runs the hand-written CUDA kernel on a card (the plain
version on the CPU).  Loading needs torch and the op's registration
module (``ops/cuda/nms.py``), never ``models/``.

Layout of an export directory::

    manifest.json                 shapes, detect config, class names, device
    detector_<H>x<W>_b<B>.pt2     one exported program per (bucket, batch)

The manifest has the JAX manifest's keys plus ``device`` (where the
programs were traced; they load only there).  It is written last,
atomically, after every artifact it names.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from collections.abc import Callable

import torch

# Imported for its side effect too: it registers the custom op that the
# exported programs call, which torch.export.load needs.
from batchai_retinanet_horovod_coco_tpu_torch.ops.cuda import nms as nms_cuda
from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import (
    atomic_write_bytes,
    atomic_write_text,
)
from batchai_retinanet_horovod_coco_tpu_torch.utils.device import (
    resolve_device,
    to_device_images,
)

FORMAT = "torch.export.pt2.v1"
JAX_FORMAT = "jax.export.stablehlo.v1"
MANIFEST = "manifest.json"


def artifact_name(hw: tuple[int, int], batch_size: int) -> str:
    return f"detector_{hw[0]}x{hw[1]}_b{batch_size}.pt2"


def export_detector(
    model: torch.nn.Module,
    image_hw: tuple[int, int],
    batch_size: int,
    config=None,
    device: str | torch.device = "cuda",
) -> bytes:
    """One detection program for one bucket and batch size, serialized:
    ``images (B, H, W, 3) uint8`` (raw pixels; normalization inside) →
    ``(boxes, scores, labels, valid)``.  ``model`` is moved to ``device``
    (``cuda`` unless the caller asks for the CPU) and put in eval mode."""
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import (
        DetectConfig,
        DetectProgram,
    )

    device = resolve_device(device)
    program = DetectProgram(model, image_hw, config or DetectConfig()).to(device).eval()
    example = torch.zeros((batch_size, *image_hw, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    exported.example_inputs = None  # zeros of the input's shape: not worth keeping
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def export_model(
    model: torch.nn.Module,
    output_dir: str,
    buckets: tuple[tuple[int, int], ...],
    batch_size: int | tuple[int, ...] = 1,
    config=None,
    device: str | torch.device = "cuda",
    class_names: list[str] | None = None,
    label_to_cat_id: dict[int, int] | None = None,
    image_min_side: int | None = None,
    image_max_side: int | None = None,
    version: str | None = None,
) -> str:
    """Export one program per (shape bucket, batch size) and the manifest;
    returns the manifest's path.

    Several batch sizes (e.g. ``(1, 8)``) let the server's batcher pad a
    partial batch to the smallest exported size that fits it.
    ``image_min_side`` / ``image_max_side`` record the resize rule the
    model was evaluated under, which the server routes raw images by."""
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import (
        DetectConfig,
        resolve_detect_config,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

    device = resolve_device(device)
    # Resolved once, so that the manifest records the knobs the programs use.
    config = resolve_detect_config(config or DetectConfig(), device)
    os.makedirs(output_dir, exist_ok=True)
    batch_sizes = (batch_size,) if isinstance(batch_size, int) else tuple(batch_size)
    entries = []
    for hw in buckets:
        for b in batch_sizes:
            name = artifact_name(hw, b)
            data = export_detector(model, hw, b, config, device)
            # Atomic: a torn artifact must never load under the name that
            # the manifest publishes.
            atomic_write_bytes(os.path.join(output_dir, name), data)
            entries.append({"file": name, "height": hw[0], "width": hw[1], "batch_size": b})
    manifest = {
        "format": FORMAT,
        "input": "uint8 RGB (B, H, W, 3), raw pixels (normalization inside)",
        "output": ["boxes", "scores", "labels", "valid"],
        "artifacts": entries,
        "detect_config": {
            "score_threshold": config.score_threshold,
            "iou_threshold": config.iou_threshold,
            "pre_nms_size": config.pre_nms_size,
            "max_detections": config.max_detections,
            # The suppression stage inside every program.
            "nms_impl": nms_cuda.OP_NAME,
            "nms_block_k": None,
        },
        # Where the device's schedule came from (tune/schedule.py), and the
        # NMS kernel's launch shape baked into every program.
        "schedule": schedule_lib.provenance(device),
        "launch_shapes": {"nms": {"mask_lanes": config.nms_mask_lanes,
                                  "scan_threads": config.nms_scan_threads}},
        # Anchors parameterize the box decoding inside the programs.
        "anchor_config": dataclasses.asdict(config.anchor),
        "image_min_side": image_min_side,
        "image_max_side": image_max_side,
        # Rollout identity; loaders fall back to the directory's basename.
        "version": version,
        "class_names": class_names,
        "label_to_cat_id": (
            {str(k): v for k, v in label_to_cat_id.items()} if label_to_cat_id else None
        ),
        "device": device.type,
    }
    path = os.path.join(output_dir, MANIFEST)
    # The manifest is the export's commit record: written last, atomically.
    atomic_write_text(path, json.dumps(manifest, indent=2))
    return path


@dataclasses.dataclass
class LoadedDetector:
    """A loaded export directory: shape-routed detection callables, each
    ``images (B, H, W, 3) uint8`` (numpy or torch) → the output tuple on
    the detector's device, without synchronising."""

    manifest: dict
    device: torch.device
    _fns: dict[tuple[int, int, int], Callable]

    def buckets(self) -> list[tuple[int, int, int]]:
        return sorted(self._fns)

    def fn(self, batch_size: int, hw: tuple[int, int]) -> Callable:
        """The callable of one exact (batch, H, W) program."""
        return self._fns[(batch_size, *hw)]

    def __call__(self, images):
        """Run the program whose shape is exactly ``images.shape``."""
        b, h, w = images.shape[:3]
        fn = self._fns.get((b, h, w))
        if fn is None:
            raise ValueError(
                f"no exported program for input shape {(b, h, w)}; available: {self.buckets()}"
            )
        return fn(images)


def _program_fn(module: torch.nn.Module, device: torch.device) -> Callable:
    def call(images):
        with torch.inference_mode():
            return tuple(module(to_device_images(images, device)))

    return call


def load_model(output_dir: str, device: str | torch.device = "cuda") -> LoadedDetector:
    """Load an export directory written by :func:`export_model` onto
    ``device`` (``cuda`` unless the caller asks for the CPU), which must
    be the device it was exported on.  Needs torch and the NMS op's
    registration module, never the model code or the checkpoint."""
    device = resolve_device(device)
    with open(os.path.join(output_dir, MANIFEST)) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{output_dir} holds a JAX export ({JAX_FORMAT}, StableHLO); the JAX package "
            f"serves it. This package loads {FORMAT}: convert the checkpoint with "
            "python -m batchai_retinanet_horovod_coco_tpu_torch.convert_model"
        )
    if fmt != FORMAT:
        raise ValueError(f"{output_dir}: unknown export format {fmt!r} (expected {FORMAT})")
    if manifest["device"] != device.type:
        raise ValueError(
            f"{output_dir} was exported on {manifest['device']}; its programs load only "
            f"there, not on {device.type} (export again with --device {device.type})"
        )
    fns: dict[tuple[int, int, int], Callable] = {}
    for entry in manifest["artifacts"]:
        exported = torch.export.load(os.path.join(output_dir, entry["file"]))
        key = (entry["batch_size"], entry["height"], entry["width"])
        fns[key] = _program_fn(exported.module(), device)
    return LoadedDetector(manifest=manifest, device=device, _fns=fns)
