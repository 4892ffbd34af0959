"""Convert a training snapshot into exported inference programs: the JAX
package's root ``convert_model.py`` for the port.

    python -m batchai_retinanet_horovod_coco_tpu_torch.convert_model \\
        --snapshot-path ckpts --output exported --num-classes 80

The snapshot is read through ``utils/checkpoint.py``, whose format is the
JAX package's, so a JAX ``train.py`` snapshot converts too.  The detection
program (forward → decode → clip → NMS on the card, ``evaluate/detect.py``)
is exported with ``torch.export`` for each shape bucket and batch size,
weights inside, and runs without the model code (``evaluate/export.py``).

The flags are the root file's, with their names and defaults, except that
``--platform`` / ``--platforms`` become ``--device {cuda,cpu}`` (default
``cuda``, which raises without a card): the programs are traced on the
device they will serve on.  Every backbone of the JAX package converts,
with every ``--stem`` (the same parameters and math).
"""

from __future__ import annotations

import argparse
import os
import sys

from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import STEMS
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import BACKBONES, DEFAULT_STEM
from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import add_anchor_flags

# The JAX command line's flags that this one replaces with --device.
REFUSED_FLAGS = ("--platform", "--platforms")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--snapshot-path", required=True,
                   help="checkpoint directory (train --snapshot-path, or the JAX "
                        "package's train.py --snapshot-path)")
    p.add_argument("--output", required=True, help="export directory")
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--backbone", default="resnet50", choices=BACKBONES)
    p.add_argument("--norm", default="gn", choices=["gn", "bn", "frozen_bn"])
    p.add_argument("--stem", default=DEFAULT_STEM, choices=STEMS,
                   help="stem formulation (param layout is identical; "
                        "either loads any snapshot)")
    p.add_argument("--f32", action="store_true",
                   help="compute in float32 (default bfloat16)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="single exported batch size (shorthand for "
                        "--batch-sizes N; default 1)")
    p.add_argument("--batch-sizes", default=None, metavar="B1,B2",
                   help="comma-separated batch sizes: one program per "
                        "(bucket, batch); the serve batcher pads a partial "
                        "batch to the smallest exported size that fits it")
    p.add_argument("--buckets", default=None, metavar="HxW,HxW",
                   help="explicit (H, W) shape buckets (e.g. 800x1344,1344x800); "
                        "default: the pipeline's default_buckets for the image "
                        "sides, i.e. the shapes an eval run emits")
    p.add_argument("--image-min-side", type=int, default=800)
    p.add_argument("--image-max-side", type=int, default=1333)
    p.add_argument("--score-threshold", type=float, default=0.05)
    p.add_argument("--nms-threshold", type=float, default=0.5)
    p.add_argument("--max-detections", type=int, default=300)
    add_anchor_flags(p)
    p.add_argument("--export-version", default=None, metavar="VERSION",
                   help="rollout identity recorded in the manifest (default: "
                        "the export directory's basename at load time)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the programs are traced and will serve; cuda "
                        "raises without a card")
    return p


def refuse_unported(argv: list[str]) -> None:
    """Raise ``SystemExit`` naming every flag of the JAX command line that
    this one replaces.  ``argv`` is scanned before parsing, so a refused
    flag is named even where the parser would stop at another error."""
    refused = [a.split("=", 1)[0] for a in argv if a.split("=", 1)[0] in REFUSED_FLAGS]
    if refused:
        raise SystemExit(
            f"{', '.join(refused)}: not ported to the PyTorch package (it exports "
            "for the device it runs on: pass --device cuda or --device cpu); see ROADMAP.md"
        )


def parse_buckets(text: str) -> tuple[tuple[int, int], ...]:
    """'800x1344,1344x800' → ((800, 1344), (1344, 800))."""
    buckets = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            h, w = part.lower().split("x")
            buckets.append((int(h), int(w)))
        except ValueError:
            raise SystemExit(f"--buckets: not an HxW shape: {part!r}")
    if not buckets:
        raise SystemExit("--buckets: empty bucket list")
    return tuple(buckets)


def parse_batch_sizes(args) -> tuple[int, ...]:
    if args.batch_sizes is not None and args.batch_size is not None:
        raise SystemExit("pass --batch-size OR --batch-sizes, not both")
    if args.batch_sizes is not None:
        try:
            sizes = tuple(int(v) for v in args.batch_sizes.split(",") if v.strip())
        except ValueError:
            raise SystemExit(f"--batch-sizes: not an int list: {args.batch_sizes!r}")
        if not sizes or any(b < 1 for b in sizes):
            raise SystemExit(f"--batch-sizes: bad sizes {args.batch_sizes!r}")
        return tuple(sorted(set(sizes)))
    return (args.batch_size if args.batch_size is not None else 1,)


def main(argv: list[str] | None = None) -> str:
    """Run the command line ``argv``; returns the manifest's path."""
    argv = list(sys.argv[1:] if argv is None else argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)

    import torch

    from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import default_buckets
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import DetectConfig
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate.export import export_model
    from batchai_retinanet_horovod_coco_tpu_torch.models.convert import load_flax_variables
    from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
        RetinaNet,
        RetinaNetConfig,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        latest_step,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import resolve_anchor_config
    from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if latest_step(args.snapshot_path) is None:
        raise SystemExit(f"no checkpoint found under {args.snapshot_path}")
    # Flags + the anchor config persisted beside the checkpoint
    # (conflicting flags abort; no flags = the saved config).
    anchor_config = resolve_anchor_config(args, args.snapshot_path)
    model = RetinaNet(RetinaNetConfig(
        num_classes=args.num_classes,
        backbone=args.backbone,
        norm_kind=args.norm,
        stem=args.stem,
        anchor=anchor_config,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
    ))
    # Only the parameters and statistics are needed: the snapshot's
    # optimizer never has to be rebuilt here.
    restored = CheckpointManager(args.snapshot_path).restore_arrays()
    load_flax_variables(model, restored["params"], restored["batch_stats"])
    print(f"restored step {int(restored['step'])} from {args.snapshot_path}")

    buckets = (
        parse_buckets(args.buckets)
        if args.buckets
        else default_buckets(args.image_min_side, args.image_max_side)
    )
    manifest = export_model(
        model,
        args.output,
        buckets,
        parse_batch_sizes(args),
        DetectConfig(
            score_threshold=args.score_threshold,
            iou_threshold=args.nms_threshold,
            max_detections=args.max_detections,
            anchor=anchor_config,
        ),
        device=device,
        image_min_side=args.image_min_side,
        image_max_side=args.image_max_side,
        version=args.export_version,
    )
    for name in sorted(os.listdir(args.output)):
        print(f"  {name}: {os.path.getsize(os.path.join(args.output, name)) / 1e6:.1f} MB")
    print(f"wrote {manifest}")
    return manifest


if __name__ == "__main__":
    main()
