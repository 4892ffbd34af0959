"""COCO mAP evaluation of a snapshot from the command line, as the JAX
package's ``evaluate.py``:

    python -m batchai_retinanet_horovod_coco_tpu_torch.evaluate coco <root> --snapshot-path <dir>

The training command line with ``--eval-only`` (``train/__main__.py``), so
the two cannot drift: it restores the latest checkpoint under
``--snapshot-path`` and prints the COCO stats, then the VOC ones (csv and
pascal datasets).  With the launch flags (``--num-devices N`` and the
rest) the eval is sharded over a data-parallel world: each rank detects
its slice of the val set, and the detections are gathered before scoring.
"""

from __future__ import annotations

import sys

from batchai_retinanet_horovod_coco_tpu_torch.train import __main__ as train_cli


def main(argv: list[str] | None = None) -> dict[str, float]:
    argv = list(sys.argv[1:] if argv is None else argv)
    metrics = train_cli.main(argv + ["--eval-only"])
    for k in ("AP", "AP50", "AP75", "APsmall", "APmedium", "APlarge"):
        if k in metrics:
            print(f"{k}: {metrics[k]:.4f}")

    # voc_mAP first, then the per-class APs in class-id order.
    def voc_order(k: str):
        tail = k.rsplit("_", 1)[-1]
        return (k != "voc_mAP", int(tail) if tail.isdigit() else 0, k)

    for k in sorted((k for k in metrics if k.startswith("voc_")), key=voc_order):
        print(f"{k}: {metrics[k]:.4f}")
    return metrics


if __name__ == "__main__":
    main()
