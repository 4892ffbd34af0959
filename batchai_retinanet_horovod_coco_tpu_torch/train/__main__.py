"""RetinaNet training from the command line, on one card or data-parallel
over several, one process a card: the JAX package's ``train.py`` for the
port.

    python -m batchai_retinanet_horovod_coco_tpu_torch.train coco <root> [flags]
    python -m batchai_retinanet_horovod_coco_tpu_torch.train synthetic --device cpu ...

A dataset subcommand (``coco``, ``csv``, ``pascal``, ``synthetic``) and
the flags of ``train.py``, each with its name and default, so a JAX
command line carries over unchanged; ``--device {cuda,cpu}`` (default
``cuda``, which raises without a card) is the port's own.  The
run: datasets → bucketed pipelines of decoded image files
(``data/pipeline.py``; with ``--data-worker-procs N`` decoded by N worker
processes over shared memory, ``data/shm_pipeline.py``) → the model, the optimizer (sgd's LR is ``--lr`` ×
global batch / 256) and the train state → ``train/loop.py::run_training``
with checkpoints in the JAX package's format under ``--snapshot-path``, and
a COCO eval (``evaluate/detect.py::run_coco_eval``, plus VOC AP for csv
and pascal) → the final step and the last eval's stats.  ``--eval-only``
restores the snapshot and evaluates it (``evaluate/__main__.py``).

Data-parallel training (``launch/pod.py``, ``parallel/mesh.py``): one
process a card, a ``torch.distributed`` group (NCCL on cards, gloo with
``--device cpu``).  ``--num-devices N`` (0 = every card) starts N processes
of this command line on this host and waits for them; ``--distributed-auto``
joins the world that ``torchrun`` started this process in, and
``--coordinator-address``, ``--num-processes`` and ``--process-id`` join
one explicitly (in a joined world ``--num-devices`` is 0 or its size).
``--batch-size`` is the global batch: each rank reads its shard of the
data (``records[rank::size]``), the step averages the gradients, and rank
0 alone logs and writes checkpoints (``shard_count`` in the manifest); the
eval is sharded the same way and its detections gathered.  Adam's LR
scales with the ranks (the reference's ``hvd.size()``).  The ``dp8`` and
``pod`` presets are the JAX package's.

The obs flags are the JAX command line's (``utils/cli.py::add_obs_flags``):
``--obs-trace``/``--obs-dir`` trace the run into the obs directory
(``trace.json``, watchdog stack dumps; ``--log-dir`` defaults to it),
``--obs-port`` serves the live telemetry (``/metrics``, ``/healthz``,
``/statusz``; rank r of a world serves on port + r), ``--slo-rule`` adds
SLO rules to the built-in ones, and
``--numerics`` puts the numerics summary into each step.  A non-finite
loss writes ``NUMERICS_DUMP.json`` into the obs directory or ``--log-dir``
before the run raises, and ``--auto-resume`` excludes its batch's image ids
from the reseeded stream.  ``--log-dir``'s ``metrics.jsonl`` is the
``obs/events.py::EventSink`` stream (a run header, ``train/<metric>`` and
``eval/<metric>`` records, events).

Every backbone of the JAX package is built (``--backbone``: the ResNets,
``mobilenet``, ``mobilenet050``, ``vgg16``, ``vgg19``, ``densenet121``,
``densenet169``, ``densenet201``), every ``--stem`` and ``--pack-width``
(the same math as the plain stem and stage 2, with the JAX model's shape
checks), and ``--pretrained-backbone`` imports a torchvision ResNet-50
state dict into the backbone (``models/import_weights.py``; the
reference's recipe adds ``--norm frozen_bn``).

Refused with a message naming ``ROADMAP.md``, since what they need is not
ported: spatial sharding, the sharded weight update and the quantized
allreduce, TensorBoard and ``--debug-nans``.  The gradient-communication
flags and ``--platform`` are left out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import warnings

import numpy as np
import torch

from batchai_retinanet_horovod_coco_tpu_torch.data.pipeline import default_buckets
from batchai_retinanet_horovod_coco_tpu_torch.launch import (
    DistributedConfig,
    initialize_distributed,
    run_local_world,
    shard_info,
    shutdown_distributed,
)
from batchai_retinanet_horovod_coco_tpu_torch.models.resnet import STEMS
from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import BACKBONES, DEFAULT_STEM
from batchai_retinanet_horovod_coco_tpu_torch.obs import trace
from batchai_retinanet_horovod_coco_tpu_torch.obs.events import EventSink, emit_event
from batchai_retinanet_horovod_coco_tpu_torch.parallel.mesh import local_batch_size, world_devices
from batchai_retinanet_horovod_coco_tpu_torch.utils.cli import (
    add_anchor_flags,
    add_data_pipeline_flags,
    add_durability_flags,
    add_obs_flags,
    configure_obs,
    make_pipeline_worker_kwargs,
    resolve_anchor_config,
    save_anchor_config,
)

PRESETS: dict[str, dict] = {
    # single-image inference
    "cpu-inference": {"eval_only": True, "batch_size": 1, "num_devices": 1},
    # focal + smooth-L1 training on COCO-mini, single device
    "coco-mini": {
        "batch_size": 2,
        "steps": 500,
        "num_devices": 1,
        "eval_every": 0,
        "schedule": "constant",
    },
    # single-host 8-card data-parallel training
    "dp8": {"batch_size": 16, "num_devices": 8},
    # multi-host, full COCO2017 at 1333x800
    "pod": {
        "batch_size": 256,
        "num_devices": 0,  # 0 = every card of the world
        "distributed_auto": True,
        "steps": 90000 // 16,  # ~12 epochs at global batch 256
    },
    # COCO eval
    "eval": {"eval_only": True},
}



def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: the preset resolution compares raw argv flag
    # names with dest names, which needs unabbreviated flags.
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        allow_abbrev=False,
    )
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named configuration; explicit flags override")

    sub = p.add_subparsers(dest="dataset_type", required=True)
    coco = sub.add_parser("coco", help="train on a COCO-format dataset", allow_abbrev=False)
    coco.add_argument("coco_path", help="dataset root")
    coco.add_argument("--train-annotations", default="annotations/instances_train2017.json")
    coco.add_argument("--train-images", default="train2017")
    coco.add_argument("--val-annotations", default="annotations/instances_val2017.json")
    coco.add_argument("--val-images", default="val2017")
    csvp = sub.add_parser(
        "csv", help="train on a CSV-format dataset (keras-retinanet "
        "annotations.csv/classes.csv)", allow_abbrev=False,
    )
    csvp.add_argument("csv_annotations", help="annotations CSV (path,x1,y1,x2,y2,class_name)")
    csvp.add_argument("csv_classes", help="classes CSV (class_name,id)")
    csvp.add_argument("--val-csv-annotations", default=None,
                      help="validation annotations CSV (default: none)")
    csvp.add_argument("--image-dir", default=None,
                      help="base dir for image paths (default: the annotations file's directory)")
    pascal = sub.add_parser("pascal", help="train on a Pascal VOC dataset (VOCdevkit layout)",
                            allow_abbrev=False)
    pascal.add_argument("pascal_path",
                        help="VOCdevkit year root (contains Annotations/, JPEGImages/, ImageSets/)")
    pascal.add_argument("--train-split", default="trainval")
    pascal.add_argument("--val-split", default="test")
    pascal.add_argument("--skip-difficult", action="store_true",
                        help="drop difficult objects entirely (default: keep as ignore regions)")
    synth = sub.add_parser("synthetic", help="generated dataset (PNG files)", allow_abbrev=False)
    synth.add_argument("--synthetic-root", default=os.path.join(tempfile.gettempdir(), "synthetic_coco"))
    synth.add_argument("--synthetic-images", type=int, default=64)
    synth.add_argument("--synthetic-classes", type=int, default=3)
    synth.add_argument("--synthetic-size", default="256",
                       help="source image size: N (square) or HxW")

    for sp in (coco, csvp, pascal, synth):
        # Also accepted after the subcommand; SUPPRESS so the subparser
        # does not clobber a top-level --preset with its default.
        sp.add_argument("--preset", choices=sorted(PRESETS), default=argparse.SUPPRESS,
                        help=argparse.SUPPRESS)
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the model runs; cuda raises without a card")
        g = sp.add_argument_group("model")
        g.add_argument("--backbone", default="resnet50", choices=BACKBONES)
        g.add_argument("--norm", default="gn", choices=["gn", "bn", "frozen_bn"])
        g.add_argument("--stem", default=DEFAULT_STEM, choices=STEMS,
                       help="the JAX package's stem formulation (ResNet); each is "
                            "the plain stem's math, which the port computes")
        g.add_argument("--pack-width", action="store_true",
                       help="the JAX package's width-packed stage 2 (ResNet only; "
                            "W divisible by 8); the plain stage's math here")
        g.add_argument("--f32", action="store_true", help="compute in float32 (default bfloat16)")
        add_anchor_flags(g)
        g.add_argument("--freeze-backbone", action="store_true")
        g.add_argument("--pretrained-backbone", default=None,
                       help="torch resnet50 state dict (.pth/.npz) to import; "
                            "use with --norm frozen_bn (the reference recipe)")

        g = sp.add_argument_group("data")
        g.add_argument("--batch-size", type=int, default=16, help="GLOBAL batch size")
        g.add_argument("--image-min-side", type=int, default=800)
        g.add_argument("--image-max-side", type=int, default=1333)
        g.add_argument("--max-gt", type=int, default=None,
                       help="gt boxes padded per image; default: the dataset's "
                            "largest count, so no box is dropped")
        add_data_pipeline_flags(g)
        g.add_argument("--random-transform", action="store_true",
                       help="full random affine + photometric augmentation "
                            "(default: horizontal flips only)")

        g = sp.add_argument_group("optimization")
        g.add_argument("--steps", type=int, default=90000)
        g.add_argument("--lr", type=float, default=0.01)
        g.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
        g.add_argument("--schedule", default="multistep",
                       choices=["multistep", "cosine", "constant", "plateau"])
        g.add_argument("--plateau-factor", type=float, default=0.1)
        g.add_argument("--plateau-patience", type=int, default=2)
        g.add_argument("--plateau-window", type=int, default=1000)
        g.add_argument("--plateau-min-delta", type=float, default=1e-4)
        g.add_argument("--warmup-steps", type=int, default=500)
        g.add_argument("--weight-decay", type=float, default=1e-4)
        g.add_argument("--seed", type=int, default=0)

        g = sp.add_argument_group("loop / io")
        g.add_argument("--snapshot-path", default=None,
                       help="checkpoint directory (enables checkpointing)")
        g.add_argument("--checkpoint-every", type=int, default=1000)
        g.add_argument("--no-resume", action="store_true")
        add_durability_flags(g)
        g.add_argument("--eval-every", type=int, default=0)
        g.add_argument("--async-eval", action="store_true",
                       help="run the mid-training evals in a background "
                            "thread on a snapshot of the weights")
        g.add_argument("--log-every", type=int, default=20)
        g.add_argument("--log-dir", default=None, help="metrics.jsonl goes here")
        g.add_argument("--tensorboard", action="store_true", help="not ported")
        g.add_argument("--profile-dir", default=None,
                       help="write a torch.profiler trace of a few steps here")
        add_obs_flags(g)
        g.add_argument("--debug-nans", action="store_true", help="not ported")
        g.add_argument("--eval-only", action="store_true")
        g.add_argument("--score-threshold", type=float, default=0.05)
        g.add_argument("--nms-threshold", type=float, default=0.5)
        g.add_argument("--max-detections", type=int, default=300)
        g.add_argument("--weighted-average", action="store_true",
                       help="weight the VOC mAP by per-class annotation counts (csv/pascal)")

        g = sp.add_argument_group("distributed (one process a card)")
        g.add_argument("--num-devices", type=int, default=1,
                       help="cards in the data world, one process each; 0 = all")
        g.add_argument("--shard-weight-update", action="store_true", help="not ported")
        g.add_argument("--quantized-allreduce", action="store_true", help="not ported")
        g.add_argument("--spatial-shards", type=int, default=1, help="not ported: only 1")
        g.add_argument("--distributed-auto", action="store_true",
                       help="join the world torchrun started (RANK, WORLD_SIZE, LOCAL_RANK, "
                            "MASTER_ADDR, MASTER_PORT)")
        g.add_argument("--coordinator-address", default=None,
                       help="host:port of rank 0's store (or a tcp:// or file:// URL)")
        g.add_argument("--num-processes", type=int, default=None)
        g.add_argument("--process-id", type=int, default=None)
        # Where a rank started by --num-devices writes its result (JSON).
        g.add_argument("--world-result", default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.preset:
        explicit = {
            a[2:].replace("-", "_").split("=")[0]
            for a in (argv if argv is not None else sys.argv[1:])
            if a.startswith("--")
        }
        for k, v in PRESETS[args.preset].items():
            if k not in explicit and hasattr(args, k):
                setattr(args, k, v)
    return args


def refuse_unported(args) -> None:
    """Raise ``SystemExit`` naming every flag whose setting needs what the
    port does not have yet."""
    unported = {
        f"--spatial-shards {args.spatial_shards}": args.spatial_shards != 1,
        "--quantized-allreduce": args.quantized_allreduce,
        "--shard-weight-update": args.shard_weight_update,
        "--tensorboard": args.tensorboard,
        "--debug-nans": args.debug_nans,
    }
    refused = [flag for flag, hit in unported.items() if hit]
    if refused:
        raise SystemExit(
            f"{', '.join(refused)}: not ported to the PyTorch package yet (it trains "
            "data-parallel, one process a card); see ROADMAP.md"
        )


def distributed_config(args) -> DistributedConfig:
    """The world the flags join (``launch/pod.py``): torchrun's with
    ``--distributed-auto``, an explicit one with ``--coordinator-address``,
    ``--num-processes`` and ``--process-id``, else none (one process, or
    the ranks that ``--num-devices`` starts)."""
    explicit = (args.coordinator_address, args.num_processes, args.process_id)
    if args.distributed_auto and any(v is not None for v in explicit):
        raise SystemExit("--distributed-auto joins torchrun's world: drop --coordinator-address, "
                         "--num-processes and --process-id")
    if not args.distributed_auto and any(v is not None for v in explicit) \
            and any(v is None for v in explicit):
        raise SystemExit("--coordinator-address, --num-processes and --process-id join a world "
                         "together: pass all three")
    return DistributedConfig(
        auto=args.distributed_auto,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes,
        process_id=args.process_id,
        device=args.device,
    )


def make_datasets(args):
    from batchai_retinanet_horovod_coco_tpu_torch.data import (
        CocoDataset,
        CsvDataset,
        PascalVocDataset,
        make_synthetic_coco,
    )

    if args.dataset_type == "csv":
        # keep_empty: explicit 'path,,,,,' rows are background-only images
        # the reference trains on.
        train = CsvDataset(args.csv_annotations, args.csv_classes, image_dir=args.image_dir,
                           keep_empty=True)
        val = None
        if args.val_csv_annotations:
            val = CsvDataset(args.val_csv_annotations, args.csv_classes,
                             image_dir=args.image_dir, keep_empty=True)
        return train, val

    if args.dataset_type == "pascal":
        # keep_empty: the reference keeps every id of the split file.
        train = PascalVocDataset(args.pascal_path, split=args.train_split,
                                 skip_difficult=args.skip_difficult, keep_empty=True)
        val = PascalVocDataset(args.pascal_path, split=args.val_split,
                               skip_difficult=args.skip_difficult, keep_empty=True)
        return train, val

    if args.dataset_type == "synthetic":
        raw = str(args.synthetic_size)
        if "x" in raw:
            h, w = raw.split("x", 1)
            size = (int(h), int(w))
        else:
            size = (int(raw), int(raw))
        train_ann = make_synthetic_coco(
            args.synthetic_root, num_images=args.synthetic_images,
            num_classes=args.synthetic_classes, image_size=size, seed=args.seed, split="train",
        )
        val_ann = make_synthetic_coco(
            args.synthetic_root, num_images=max(8, args.synthetic_images // 4),
            num_classes=args.synthetic_classes, image_size=size, seed=args.seed + 1, split="val",
        )
        train = CocoDataset(train_ann, os.path.join(args.synthetic_root, "train"))
        val = CocoDataset(val_ann, os.path.join(args.synthetic_root, "val"), keep_empty=True)
        return train, val

    root = args.coco_path
    train = CocoDataset(os.path.join(root, args.train_annotations),
                        os.path.join(root, args.train_images))
    val = CocoDataset(os.path.join(root, args.val_annotations),
                      os.path.join(root, args.val_images), keep_empty=True)
    return train, val


class RunLog:
    """The loop's ``log(step, scalars)`` over an ``EventSink``: one JSON
    line a record on stdout, and in ``--log-dir``'s ``metrics.jsonl`` the
    sink's records (``train/<k>``, and ``eval/<k>`` for the eval's stats);
    ``event`` is the sink's.  Keeps the last eval's stats.  In a world the
    loop calls it on rank 0 only."""

    def __init__(self, sink: EventSink):
        self.sink = sink
        self.last_eval: dict[str, float] = {}

    def __call__(self, step: int, scalars: dict[str, float]) -> None:
        print(json.dumps({"step": int(step), **scalars}), flush=True)
        evals = {k.removeprefix("eval/"): v for k, v in scalars.items() if k.startswith("eval/")}
        rest = {k: v for k, v in scalars.items() if not k.startswith("eval/")}
        if rest:
            self.sink.log(int(step), rest, prefix="train")
        if evals:
            self.sink.log(int(step), evals, prefix="eval")
            self.last_eval = {f"eval/{k}": v for k, v in evals.items()}

    def event(self, kind: str, **fields) -> None:
        self.sink.event(kind, **fields)

    def close(self) -> None:
        self.sink.close()


def _start_telemetry(args, sink: EventSink, rank: int = 0):
    """The ``--obs-port`` status server over the process registry the loop
    feeds (rank r of a world on ``--obs-port`` + r; 0 stays any free
    port), and the SLO monitor (the built-in rules, then ``--slo-rule``'s),
    its violations into the run's ``metrics.jsonl``.  Returns ``(server,
    monitor)``, each None when neither flag is given; the caller closes
    both.  A port that cannot bind raises."""
    rule_specs = args.slo_rule or []
    if args.obs_port is None and not rule_specs:
        return None, None
    from batchai_retinanet_horovod_coco_tpu_torch.obs import slo, telemetry

    telemetry.enable()  # arm the loop's push record sites
    server = None
    if args.obs_port is not None:
        port = args.obs_port + rank if args.obs_port else args.obs_port
        server = telemetry.start_http_server(telemetry.default(), port=port)
        print(f"obs: telemetry on http://{server.host}:{server.port} "
              "(/metrics /healthz /statusz)", flush=True)
    try:
        # Built-ins first: the watchdog stall, any non-finite value (the
        # loop's trips and the numerics summary feed it), a grad-norm
        # spike and checkpoint staleness (each silent until its series
        # exists).
        monitor = slo.SloMonitor(
            telemetry.default(),
            [slo.stall_rule(), slo.nonfinite_rule(), slo.grad_norm_spike(),
             slo.ckpt_staleness_rule()]
            + [slo.parse_rule(spec) for spec in rule_specs],
            sink=sink,
            poll_interval=args.slo_poll_s,
        ).start()
    except BaseException:
        if server is not None:
            server.close()
        raise
    return server, monitor


def _read_poison_ids(exc: FloatingPointError) -> list[int]:
    """The tripped batch's image ids from the ``NUMERICS_DUMP.json`` that
    the trip ``exc`` wrote (the loop's abort, just before raising); [] and
    a warning when it wrote none or the file holds another trip's dump."""
    from batchai_retinanet_horovod_coco_tpu_torch.obs.numerics import load_dump

    step, metric = getattr(exc, "step", None), getattr(exc, "metric", None)
    path = getattr(exc, "dump_path", None)
    try:
        dump = load_dump(path) if path else {}
    except (OSError, ValueError):
        dump = {}
    if dump.get("step") != step or (dump.get("tripped") or {}).get("metric") != metric:
        warnings.warn(f"no numerics dump of the trip at step {step} ({path}): the resumed run "
                      "excludes no images")
        return []
    return [int(i) for i in dump.get("batch_image_ids") or []]


def _elastic_plan(args, is_main: bool = True) -> dict:
    """--resume-elastic: where the checkpointed run's stream stopped,
    ``{"skip", "data_seed", "exclude_ids", "stream_base_step"}``: one batch
    a step, so the position is ``step - stream_base_step``.  The batch size
    (and, for a stream never reseeded, the seed) must equal the
    manifest's."""
    from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import read_manifest

    plan = {"skip": 0, "data_seed": int(args.seed), "exclude_ids": (), "stream_base_step": 0}
    manifest = read_manifest(args.snapshot_path)
    if manifest is None:
        return plan
    meta = manifest.get("metadata") or {}
    base = int(meta.get("stream_base_step") or 0)
    saved_gb = meta.get("global_batch_size")
    if saved_gb is not None and int(saved_gb) != int(args.batch_size):
        raise SystemExit(
            f"--resume-elastic: global_batch_size changed since the checkpoint was written "
            f"({saved_gb} -> {args.batch_size}); re-run with the original value, or drop "
            "--resume-elastic to resume with a restarted stream."
        )
    saved_seed = meta.get("data_seed")
    if base == 0 and saved_seed is not None and int(saved_seed) != int(args.seed):
        raise SystemExit(
            f"--resume-elastic: data_seed changed since the checkpoint was written "
            f"({saved_seed} -> {args.seed}); re-run with the original value, or drop "
            "--resume-elastic to resume with a restarted stream."
        )
    if saved_seed is not None:
        plan["data_seed"] = int(saved_seed)  # a reseeded stream: the manifest wins
    plan["exclude_ids"] = tuple(int(i) for i in (meta.get("exclude_ids") or []))
    plan["stream_base_step"] = base
    plan["skip"] = max(0, int(manifest.get("step") or 0) - base)
    if (plan["skip"] or base) and is_main:
        print(json.dumps({
            "event": "elastic_resume",
            "restored_step": int(manifest.get("step") or 0),
            "skip_batches": plan["skip"],
            "stream_base_step": base,
            "data_seed": plan["data_seed"],
            "excluded": len(plan["exclude_ids"]),
            "saved_world": meta.get("shard_count"),
        }), flush=True)
    return plan


class _NanInjector:
    """--inject-nan-step: the N-th batch's images as f32 with one NaN
    (uint8 cannot hold one; the step's normalization passes floats
    through), once a process: ``latch`` is shared across auto-resumes."""

    def __init__(self, inner, at_batch: int, latch: dict, sink: EventSink | None = None):
        self._inner = inner
        self._at = int(at_batch)
        self._latch = latch
        self._sink = sink
        self._count = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._inner)
        self._count += 1
        if not self._latch["done"] and self._count == self._at:
            self._latch["done"] = True
            images = batch.images.astype(np.float32, copy=True)
            images[0, 0, 0, 0] = np.nan
            batch = batch._replace(images=images)
            emit_event("chaos_nan_injected", sink=self._sink, batch=self._count,
                       image_ids=[int(i) for i in batch.image_ids])
        return batch


def main(argv=None) -> dict[str, float]:
    """Run the command line ``argv``; returns the metrics: the eval's stats
    for ``--eval-only``, else ``final_step`` and the last eval's stats
    under ``eval/`` names (rank 0's, for a world this call started)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    refuse_unported(args)
    config = distributed_config(args)
    if not config.joins:
        ranks = 1 if args.num_devices == 1 else world_devices(args.num_devices, args.device)
        local_batch_size(args.batch_size, ranks)
        if ranks > 1:
            # One process a card: this command line again as each rank.
            return run_local_world("batchai_retinanet_horovod_coco_tpu_torch.train", argv, ranks)[0]
    world = initialize_distributed(config)
    try:
        if world is not None and args.num_devices not in (0, world.size):
            raise SystemExit(f"--num-devices {args.num_devices} in a world of {world.size} "
                             f"processes (one a card): pass {world.size} or 0")
        if world is not None:
            trace.set_process_index(world.rank)
        out = _observed(args, world)
    finally:
        shutdown_distributed(world)
    result_path = getattr(args, "world_result", None)
    if result_path:
        with open(result_path, "w") as f:
            json.dump(out, f)
    return out


def _observed(args, world) -> dict[str, float]:
    # The obs layer comes up before any thread starts; its finalize runs
    # even when the run dies (the partial trace is the post-mortem).
    obs_dir = configure_obs(args, process_label="train")
    if obs_dir is None:
        return _run(args, world)
    if not args.log_dir:
        args.log_dir = obs_dir  # the events land beside the trace
    try:
        return _run(args, world)
    finally:
        from batchai_retinanet_horovod_coco_tpu_torch import obs

        merged = obs.finalize()
        if merged:
            # The JAX CLI then writes PERF_REPORT.json (obs/analyze),
            # which waits for the tooling item of ROADMAP.md queue 1.
            print(f"obs: merged Chrome trace at {merged} (load in Perfetto / "
                  "chrome://tracing)", flush=True)


def _run(args, world) -> dict[str, float]:

    from batchai_retinanet_horovod_coco_tpu_torch.data import (
        PipelineConfig,
        TransformConfig,
        build_pipeline,
        resolve_max_gt,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.evaluate.detect import DetectConfig, run_coco_eval
    from batchai_retinanet_horovod_coco_tpu_torch.models.retinanet import (
        RetinaNetConfig,
        build_retinanet,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.train.loop import LoopConfig, run_training
    from batchai_retinanet_horovod_coco_tpu_torch.train.optim import OptimizerConfig
    from batchai_retinanet_horovod_coco_tpu_torch.train.state import create_train_state
    from batchai_retinanet_horovod_coco_tpu_torch.utils.checkpoint import (
        CheckpointManager,
        latest_step,
    )
    from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device) if world is None else world.device
    shard_index, shard_count = shard_info(world)
    is_main = shard_index == 0
    local_batch = local_batch_size(args.batch_size, shard_count)
    train_ds, val_ds = make_datasets(args)
    num_classes = train_ds.num_classes
    # Gt padding sized to the data (silent truncation poisons targets); an
    # explicit --max-gt is honoured and the pipeline counts what it drops.
    args.max_gt = resolve_max_gt(args.max_gt, *(ds for ds in (train_ds, val_ds) if ds is not None))
    if val_ds is None and (args.eval_only or args.eval_every):
        raise SystemExit("no validation set: pass --val-csv-annotations to evaluate")

    # Persisted on fresh training, so eval and resume never need the flags.
    anchor_config = resolve_anchor_config(args, args.snapshot_path, fresh=args.no_resume)
    if args.snapshot_path and not args.eval_only and is_main:
        save_anchor_config(args.snapshot_path, anchor_config)
    model_config = RetinaNetConfig(
        num_classes=num_classes,
        backbone=args.backbone,
        norm_kind=args.norm,
        stem=args.stem,
        pack_width=args.pack_width,
        anchor=anchor_config,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
    )
    opt_config = OptimizerConfig(
        optimizer=args.optimizer,
        base_lr=args.lr,
        global_batch_size=args.batch_size,
        world_size=shard_count,
        warmup_steps=args.warmup_steps,
        total_steps=args.steps,
        schedule=args.schedule,
        plateau_factor=args.plateau_factor,
        plateau_patience=args.plateau_patience,
        plateau_window=args.plateau_window,
        plateau_min_delta=args.plateau_min_delta,
        weight_decay=args.weight_decay,
        freeze_backbone=args.freeze_backbone,
    )

    def build_state():
        """A fresh train state from the flags: at start and for each
        --auto-resume, whose resume then restores the last checkpoint."""
        model = build_retinanet(model_config, device=device, seed=args.seed)
        if args.pretrained_backbone:
            from batchai_retinanet_horovod_coco_tpu_torch.models.import_weights import (
                import_pretrained_backbone,
            )

            import_pretrained_backbone(model, args.pretrained_backbone)
            print(f"imported backbone weights from {args.pretrained_backbone}")
        return create_train_state(model, opt_config, device)

    state = build_state()
    pipe_common = dict(
        buckets=default_buckets(args.image_min_side, args.image_max_side),
        min_side=args.image_min_side,
        max_side=args.image_max_side,
        max_gt=args.max_gt,
        # --workers, --data-worker-procs, --data-worker-timeout: the
        # shared-memory worker processes when procs > 0, else the threads.
        **make_pipeline_worker_kwargs(args),
    )
    detect_config = DetectConfig(
        score_threshold=args.score_threshold,
        iou_threshold=args.nms_threshold,
        max_detections=args.max_detections,
        anchor=anchor_config,
    )

    def eval_fn(model: torch.nn.Module) -> dict[str, float]:
        val_batches = build_pipeline(
            val_ds,
            PipelineConfig(batch_size=local_batch, shuffle=False, hflip_prob=0.0,
                           seed=args.seed, shard_index=shard_index, shard_count=shard_count,
                           **pipe_common),
            train=False,
        )
        try:
            # csv and pascal also report the reference's VOC AP@0.5.
            return run_coco_eval(
                model, val_ds, val_batches, detect_config, device,
                voc_metrics=args.dataset_type in ("csv", "pascal"),
                voc_weighted_average=args.weighted_average,
                world=world,
            )
        finally:
            val_batches.close()

    log = RunLog(EventSink(args.log_dir, stdout=False, run_config=vars(args),
                           process_index=shard_index, process_count=shard_count))
    if args.obs_trace or args.obs_dir:
        # Stall diagnoses land in metrics.jsonl beside the metrics they
        # interrupt.
        from batchai_retinanet_horovod_coco_tpu_torch.obs import watchdog

        watchdog.default().sink = log.sink
    telem_server, slo_monitor = _start_telemetry(args, log.sink, shard_index)
    try:
        if args.eval_only:
            if args.snapshot_path:
                CheckpointManager(args.snapshot_path, world=world).restore(state)
            metrics = eval_fn(state.model)
            if is_main:
                log(state.step, {f"eval/{k}": float(v) for k, v in metrics.items()})
            return metrics

        # The manifest records the stream's facts, so --resume-elastic can
        # re-derive its position; updated in place on an --auto-resume.
        ckpt_metadata = {
            "global_batch_size": args.batch_size,
            "data_seed": args.seed,
            "shard_count": shard_count,
            "stream_base_step": 0,
            "exclude_ids": [],
        }
        skip_batches, data_seed, exclude_ids = 0, args.seed, ()
        if args.resume_elastic and args.snapshot_path and not args.no_resume:
            plan = _elastic_plan(args, is_main)
            skip_batches, data_seed, exclude_ids = plan["skip"], plan["data_seed"], plan["exclude_ids"]
            ckpt_metadata.update(data_seed=data_seed, exclude_ids=list(exclude_ids),
                                 stream_base_step=plan["stream_base_step"])
        loop_config = LoopConfig(
            total_steps=args.steps,
            log_every=args.log_every,
            checkpoint_every=args.checkpoint_every if args.snapshot_path else 0,
            eval_every=args.eval_every,
            checkpoint_dir=args.snapshot_path,
            resume=not args.no_resume,
            profile_dir=args.profile_dir,
            device_prefetch=args.device_prefetch,
            async_eval=args.async_eval,
            ckpt_metadata=ckpt_metadata,
            numerics=args.numerics,
            numerics_dump_dir=args.obs_dir or args.log_dir,
            rng_seed=args.seed,
        )
        run_eval = args.eval_every or args.dataset_type in ("coco", "pascal") or (
            args.dataset_type == "csv" and val_ds is not None
        )
        transform = TransformConfig() if args.random_transform else None
        attempt = 0
        latch = {"done": False}  # one NaN injection a process
        while True:
            train_batches = build_pipeline(
                train_ds,
                PipelineConfig(batch_size=local_batch, shuffle=True, transform=transform,
                               seed=data_seed, skip_batches=skip_batches, exclude_ids=exclude_ids,
                               shard_index=shard_index, shard_count=shard_count, **pipe_common),
                train=True,
            )
            batches = train_batches
            if args.inject_nan_step:
                batches = _NanInjector(train_batches, args.inject_nan_step, latch, log.sink)
            try:
                state = run_training(
                    state, batches, num_classes, loop_config, anchor_config=anchor_config,
                    log=log, eval_fn=eval_fn if run_eval else None, world=world,
                )
                break
            except FloatingPointError as exc:
                attempt += 1
                restored = latest_step(args.snapshot_path, world) if args.snapshot_path else None
                if (not args.auto_resume or attempt > args.max_auto_resumes or args.no_resume
                        or restored is None):
                    raise
                # A new deterministic order from the restored step, without
                # the tripped batch's images: its seed, exclusions and base
                # go into every later manifest.
                data_seed, skip_batches = int(args.seed) + 7919 * attempt, 0
                poison = _read_poison_ids(exc)
                exclude_ids = tuple(sorted(set(exclude_ids) | set(poison)))
                ckpt_metadata.update(data_seed=data_seed, exclude_ids=list(exclude_ids),
                                     stream_base_step=int(restored))
                emit_event("auto_resume", sink=log.sink, attempt=attempt,
                           restored_step=int(restored), data_seed=data_seed,
                           exclude_ids=list(exclude_ids), error=str(exc)[:300])
                state = build_state()
            finally:
                train_batches.close()
        return {"final_step": float(state.step), **log.last_eval}
    finally:
        if slo_monitor is not None:
            slo_monitor.stop()
        if telem_server is not None:
            telem_server.close()
        log.close()


if __name__ == "__main__":
    main()
