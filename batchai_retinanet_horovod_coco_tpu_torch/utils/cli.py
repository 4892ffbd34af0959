"""Command-line glue shared by the port's tools, as the JAX package's
``utils/cli.py``: the anchor, data-pipeline, durability and serve flag
surfaces, and the anchor configuration persisted beside a checkpoint.

The anchor file keeps the JAX package's name and format
(``anchor_config.json``, ``dataclasses.asdict`` of the config), so a
snapshot directory moves between the two packages: an eval, resume or
export never regenerates default anchors for a model trained with custom
ones (anchors parameterize the box decoding, so a mismatch would decode
garbage with no error anywhere).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from batchai_retinanet_horovod_coco_tpu_torch.ops.anchors import AnchorConfig
from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_write_text

_ANCHOR_FILE = "anchor_config.json"
_FLAG_FIELDS = ("sizes", "strides", "ratios", "scales")


def float_list(text: str) -> tuple[float, ...]:
    """argparse type for comma-separated floats ('32,64' → (32.0, 64.0))."""
    try:
        values = tuple(float(v) for v in text.split(",") if v.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a float list: {text!r}")
    if not values:
        raise argparse.ArgumentTypeError("empty list")
    return values


def add_anchor_flags(parser) -> None:
    """The anchor flag surface, identical on every tool that builds anchors."""
    parser.add_argument("--anchor-sizes", type=float_list, default=None,
                        metavar="S3,S4,S5,S6,S7",
                        help="anchor base size per pyramid level "
                             "(default 32,64,128,256,512)")
    parser.add_argument("--anchor-strides", type=float_list, default=None,
                        metavar="T3,T4,T5,T6,T7",
                        help="anchor stride per pyramid level "
                             "(default 8,16,32,64,128)")
    parser.add_argument("--anchor-ratios", type=float_list, default=None,
                        help="aspect ratios (default 0.5,1,2)")
    parser.add_argument("--anchor-scales", type=float_list, default=None,
                        help="octave scales (default 1,2^(1/3),2^(2/3))")


def add_data_pipeline_flags(parser) -> None:
    """The host input-pipeline flag surface.  ``--data-worker-procs`` and
    ``--data-worker-timeout`` belong to the multiprocess producer, which is
    not ported: the train command refuses values other than their
    defaults."""
    parser.add_argument("--workers", "--data-workers", dest="workers",
                        type=int, default=16,
                        help="decode THREADS of the in-process pool (the "
                             "codec and the resize release the interpreter "
                             "lock)")
    parser.add_argument("--data-worker-procs", type=int, default=0,
                        help="decode worker PROCESSES (the JAX package's "
                             "data/shm_pipeline.py); not ported: only 0")
    parser.add_argument("--data-worker-timeout", type=float, default=120.0,
                        help="stall bound of the multiprocess producer; "
                             "not ported: only the default")
    parser.add_argument("--device-prefetch", type=int, default=2,
                        help="batches copied host->device ahead of the "
                             "step by a background thread; 0 = in line")


def add_durability_flags(parser) -> None:
    """The preemption and recovery flag surface."""
    parser.add_argument("--resume-elastic", action="store_true",
                        help="on resume, re-derive the input stream's "
                             "position from the checkpoint manifest "
                             "(consumed batches = restored step), so no "
                             "batch is replayed or skipped; needs the "
                             "--batch-size and --seed of the checkpoint")
    parser.add_argument("--auto-resume", action="store_true",
                        help="on a non-finite abort, restore the last "
                             "checkpoint (the loop saves only finite "
                             "states), reseed the data order, and continue "
                             "to --steps")
    parser.add_argument("--max-auto-resumes", type=int, default=3,
                        help="give up (re-raise the abort) after this "
                             "many auto-resumes in one invocation")
    parser.add_argument("--inject-nan-step", type=int, default=None,
                        metavar="N",
                        help="FAULT INJECTION: poison the N-th training "
                             "batch with NaN, once per process; exercises "
                             "the abort and --auto-resume")


def add_serve_flags(parser) -> None:
    """The inference server's flag surface (``serve/frontend.py``), with
    the JAX package's names and defaults; its ``--replica-id`` belongs to
    the fleet, which is not ported (the serve command refuses it)."""
    parser.add_argument("--serve-max-delay-ms", type=float, default=10.0,
                        help="dynamic-batching deadline: a partial batch "
                             "fires at most this long after its first "
                             "request reaches the batcher (in continuous "
                             "mode the dispatch gate usually seals first)")
    parser.add_argument("--serve-batching", default="continuous",
                        choices=["continuous", "deadline"],
                        help="continuous (default): batch N+1 assembles "
                             "while N runs and seals the instant the device "
                             "is ready; deadline: deadline-only coalescing")
    parser.add_argument("--serve-admission-queue", type=int, default=128,
                        help="bounded front-door queue; a full queue sheds "
                             "(503) instead of growing")
    parser.add_argument("--serve-bucket-queue", type=int, default=64,
                        help="bounded per-bucket coalescing queue (full = "
                             "shed with reason bucket_queue_full)")
    parser.add_argument("--serve-workers", type=int, default=2,
                        help="host decode/resize worker threads (the serve "
                             "router)")
    parser.add_argument("--serve-timeout-s", type=float, default=None,
                        help="default per-request deadline (expired requests "
                             "are rejected, never occupy a batch row); unset "
                             "= no deadline")
    parser.add_argument("--serve-drain-timeout-s", type=float, default=30.0,
                        help="graceful close waits this long for in-flight "
                             "requests before rejecting the remainder")


def make_serve_config(args):
    """``ServeConfig`` from the serve flags."""
    from batchai_retinanet_horovod_coco_tpu_torch.serve.common import ServeConfig

    return ServeConfig(
        max_delay_ms=args.serve_max_delay_ms,
        continuous=args.serve_batching == "continuous",
        admission_queue=args.serve_admission_queue,
        bucket_queue=args.serve_bucket_queue,
        preprocess_workers=args.serve_workers,
        default_timeout_s=args.serve_timeout_s,
        drain_timeout_s=args.serve_drain_timeout_s,
    )


def make_anchor_config(args) -> AnchorConfig:
    """AnchorConfig from the flags (defaults where a flag is unset)."""
    default = AnchorConfig()
    kw = {}
    if args.anchor_sizes is not None:
        kw["sizes"] = args.anchor_sizes
    if args.anchor_strides is not None:
        for s in args.anchor_strides:
            if not float(s).is_integer():
                raise SystemExit(f"--anchor-strides must be whole numbers, got {s}")
        kw["strides"] = tuple(int(s) for s in args.anchor_strides)
    if args.anchor_ratios is not None:
        kw["ratios"] = args.anchor_ratios
    if args.anchor_scales is not None:
        kw["scales"] = args.anchor_scales
    for key in ("sizes", "strides"):
        if key in kw and len(kw[key]) != len(default.levels):
            raise SystemExit(
                f"--anchor-{key} needs {len(default.levels)} entries "
                f"(one per pyramid level {default.levels}), got {len(kw[key])}"
            )
    return dataclasses.replace(default, **kw) if kw else default


def save_anchor_config(snapshot_dir: str, config: AnchorConfig) -> None:
    """Persist the anchor config next to the checkpoints, atomically, and
    only when it changed."""
    os.makedirs(snapshot_dir, exist_ok=True)
    if load_anchor_config(snapshot_dir) == config:
        return
    atomic_write_text(
        os.path.join(snapshot_dir, _ANCHOR_FILE), json.dumps(dataclasses.asdict(config), indent=1)
    )


def load_anchor_config(snapshot_dir: str | None) -> AnchorConfig | None:
    if not snapshot_dir:
        return None
    path = os.path.join(snapshot_dir, _ANCHOR_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    return AnchorConfig(**{k: tuple(v) for k, v in raw.items()})


def resolve_anchor_config(args, snapshot_dir: str | None, fresh: bool = False) -> AnchorConfig:
    """The flags combined with the config persisted beside the checkpoint:
    the flags when nothing is saved (or they match it); the saved config
    when no flag is given; an abort when both are given and differ.
    ``fresh`` (--no-resume) ignores the saved config."""
    from_flags = make_anchor_config(args)
    if fresh:
        return from_flags
    flags_given = any(getattr(args, f"anchor_{k}") is not None for k in _FLAG_FIELDS)
    saved = load_anchor_config(snapshot_dir)
    if saved is None:
        return from_flags
    if not flags_given:
        if saved != AnchorConfig():
            print(f"using anchor config persisted in {snapshot_dir}")
        return saved
    if from_flags != saved:
        raise SystemExit(
            f"anchor flags conflict with the config persisted in "
            f"{snapshot_dir} (trained with {saved}); drop the flags to use "
            "the saved config, or point --snapshot-path elsewhere"
        )
    return from_flags
