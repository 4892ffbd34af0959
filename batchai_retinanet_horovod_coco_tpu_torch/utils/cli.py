"""Command-line glue shared by the port's tools, as the JAX package's
``utils/cli.py``: the anchor, data-pipeline, durability, serve, obs and
gradient-communication flag surfaces, the obs bring-up, the
communication policy the flags make, and the anchor configuration
persisted beside a checkpoint.

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
import sys

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
    """The host input-pipeline flag surface: decode threads, or decode
    worker processes over shared memory (``data/shm_pipeline.py``)."""
    parser.add_argument("--workers", "--data-workers", dest="workers",
                        type=int, default=16,
                        help="decode THREADS of the in-process pool (the "
                             "codec and the resize release the interpreter "
                             "lock); ignored when --data-worker-procs > 0")
    parser.add_argument("--data-worker-procs", type=int, default=0,
                        help="decode worker PROCESSES writing into shared "
                             "memory (data/shm_pipeline.py); 0 = threads")
    parser.add_argument("--data-worker-timeout", type=float, default=120.0,
                        help="seconds a head-of-line batch may wait on the "
                             "worker processes before the run raises")
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
    the JAX package's names and defaults."""
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
    parser.add_argument("--replica-id", default=None,
                        help="stable identity carried in /healthz load "
                             "fields (fleet routing and canary attribution); "
                             "default host-pid.  The fleet command line pins "
                             "it across respawns so a breaker-open replica "
                             "is readmitted as itself")


def add_comm_flags(parser) -> None:
    """The gradient-communication flag surface, the JAX package's
    (``comm/``).  ``--quantized-allreduce`` stays a deprecated alias of
    ``--comm-compress int8`` (:func:`make_comm_config`)."""
    parser.add_argument("--comm-compress", default="none",
                        choices=["none", "int8", "bf16"],
                        help="gradient-compression wire format "
                             "(comm/compress.py): int8 = bucketed "
                             "per-block symmetric int8 with error "
                             "feedback (~5/8 the exact bytes-on-wire), "
                             "bf16 = round-to-nearest bf16 (~3/4); the "
                             "reduce phase stays exact f32 either way.  "
                             "Composes with --shard-weight-update (the "
                             "compression moves to the ZeRO update "
                             "gather).  none = the plain all-reduce")
    parser.add_argument("--comm-overlap", action="store_true",
                        help="issue each schedule stage's (backbone/fpn/"
                             "heads) compressed collective from INSIDE "
                             "the backward pass (comm/overlap.py) "
                             "instead of one fused pass after it; "
                             "identical values, earlier wire time.  DP "
                             "path only: with --shard-weight-update the "
                             "compression is the post-update gather and "
                             "this flag is ignored with a structured "
                             "warning")
    parser.add_argument("--comm-bucket-mb", type=float, default=4.0,
                        help="bucket capacity in MB: leaves pack per "
                             "stage into flat buckets of this size so "
                             "small leaves share one quantized "
                             "collective; a bucket under "
                             "min_bucket_bytes stays exact")
    parser.add_argument("--comm-no-error-feedback", action="store_true",
                        help="disable the error-feedback residual "
                             "(comm state): quantization error is then "
                             "dropped each step instead of carried — "
                             "debugging/ablation only")
    parser.add_argument("--comm-slices", type=int, default=None,
                        metavar="N",
                        help="slice count of the two-level grouping "
                             "(parallel/mesh.py CommTopology): with N > 1 "
                             "and distinct per-hop modes the gradient "
                             "collective becomes hierarchical — exact "
                             "f32 within each slice, compressed exchange "
                             "only across slices.  Default: the hosts of "
                             "a torchrun world (LOCAL_WORLD_SIZE ranks a "
                             "host) or the RETINANET_COMM_SLICES env; on "
                             "one host pass e.g. 2 to emulate 2 slices")
    parser.add_argument("--comm-ici-mode", default=None,
                        choices=["none", "int8", "bf16"],
                        help="wire format of the intra-slice hops once a "
                             "topology engages; default none = the fast "
                             "wire stays exact f32.  A compressed ici "
                             "mode must equal the dcn mode (which is just "
                             "the flat tree)")
    parser.add_argument("--comm-dcn-mode", default=None,
                        choices=["none", "int8", "bf16"],
                        help="wire format of the cross-slice hop once a "
                             "topology engages; default: inherit "
                             "--comm-compress — so '--comm-compress int8 "
                             "--comm-slices 2' alone gives exact within "
                             "a slice, int8 across slices")
    parser.add_argument("--comm-dcn-bucket-mb", type=float, default=None,
                        metavar="MB",
                        help="bucket capacity for the hierarchical plan, "
                             "sized for the cross-slice hop (the wire "
                             "that actually hurts); default: inherit "
                             "--comm-bucket-mb")


def make_comm_config(args, announce: bool = True):
    """The ``comm/config.py::CommConfig`` of the flags above (None when
    they ask for no compression), as the JAX package's.  The deprecated
    ``--quantized-allreduce`` maps onto ``--comm-compress int8`` with one
    structured ``deprecated_flag`` line on stderr (``announce``: a world's
    rank 0 alone prints it)."""
    from batchai_retinanet_horovod_coco_tpu_torch.comm import CommConfig

    compress = getattr(args, "comm_compress", "none") or "none"
    if getattr(args, "quantized_allreduce", False):
        if compress == "none":
            compress = "int8"
    if getattr(args, "quantized_allreduce", False) and announce:
        print(
            json.dumps({
                "event": "deprecated_flag",
                "flag": "--quantized-allreduce",
                "mapped_to": f"--comm-compress {compress}",
                "note": (
                    "the per-leaf quantized allreduce was subsumed by "
                    "the comm/ subsystem (bucketed, error-feedback) — "
                    "switch to --comm-compress"
                ),
            }),
            file=sys.stderr, flush=True,
        )
    overlap = bool(getattr(args, "comm_overlap", False))
    ici_mode = getattr(args, "comm_ici_mode", None)
    dcn_mode = getattr(args, "comm_dcn_mode", None)
    dcn_bucket_mb = getattr(args, "comm_dcn_bucket_mb", None)
    if (compress == "none" and not overlap and (dcn_mode or "none") == "none"
            and (ici_mode or "none") == "none"):
        return None
    return CommConfig(
        compress=compress,
        overlap=overlap,
        bucket_mb=float(getattr(args, "comm_bucket_mb", 4.0)),
        error_feedback=not getattr(args, "comm_no_error_feedback", False),
        ici_mode=ici_mode,
        dcn_mode=dcn_mode,
        dcn_bucket_mb=None if dcn_bucket_mb is None else float(dcn_bucket_mb),
    )


def add_obs_flags(parser) -> None:
    """The observability flag surface of ``train`` and ``serve``: the JAX
    package's flags, names, defaults and meanings.  With them off the obs
    layer costs nothing: spans check one module-level bool and heartbeats
    are attribute stores."""
    parser.add_argument("--obs-trace", action="store_true",
                        help="record trace spans (step loop, data pipeline, "
                             "prefetch, eval, checkpoints, serve threads) and "
                             "export a Perfetto-loadable Chrome trace JSON "
                             "(trace.json) into --obs-dir at exit "
                             "(obs/trace.py)")
    parser.add_argument("--obs-dir", default=None,
                        help="observability artifact directory (trace JSON, "
                             "watchdog stack dumps, NUMERICS_DUMP.json); "
                             "default artifacts/obs when --obs-trace is set")
    parser.add_argument("--obs-stall-timeout", type=float, default=120.0,
                        help="seconds a registered component may go without "
                             "a heartbeat before the watchdog dumps a stall "
                             "diagnosis (JSON + all-thread stacks; it never "
                             "kills the run — obs/watchdog.py).  Takes effect "
                             "with --obs-trace/--obs-dir")
    parser.add_argument("--obs-port", type=int, default=None, metavar="PORT",
                        help="start a stdlib HTTP status server on this port "
                             "(0 = ephemeral, printed at startup): GET "
                             "/metrics (Prometheus text), /healthz "
                             "(watchdog-backed liveness — 503 names the "
                             "stalled component), /statusz (JSON snapshot); "
                             "a port that cannot bind raises")
    parser.add_argument("--slo-rule", action="append", default=None,
                        metavar="METRIC{>,<}THR[@FOR_S]",
                        help="declarative SLO over a telemetry snapshot "
                             "metric, evaluated by a monitor thread; a "
                             "sustained breach emits ONE slo_violation event. "
                             "THR 'x1.5' means regression vs a rolling-median "
                             "baseline, e.g. 'serve_request_latency_ms.p99>250@30', "
                             "'train_step_time_ms>x1.5@60'.  Repeatable; a "
                             "watchdog-stall rule is always included")
    parser.add_argument("--slo-poll-s", type=float, default=5.0,
                        help="SLO monitor poll interval (seconds)")
    parser.add_argument("--numerics", action="store_true",
                        help="the in-step numerics summary in the train step: "
                             "per-layer-group gradient norms, the update/param "
                             "ratio and the non-finite gradient count, on the "
                             "device, read at the log cadence (metrics.jsonl "
                             "'numerics' records and the telemetry gauges the "
                             "built-in nonfinite/grad-norm-spike SLO rules "
                             "watch).  The NUMERICS_DUMP.json of a tripped "
                             "finite-check is written with or without it")


def configure_obs(args, process_label: str = "main") -> str | None:
    """Bring up the obs layer from the flags above; returns the obs dir
    (None = disabled).  Call before building pipelines and threads."""
    if not (getattr(args, "obs_trace", False) or getattr(args, "obs_dir", None)):
        return None
    from batchai_retinanet_horovod_coco_tpu_torch import obs

    return obs.enable(
        args.obs_dir or "artifacts/obs",
        process_label=process_label,
        stall_after=getattr(args, "obs_stall_timeout", 120.0),
    )


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


def make_pipeline_worker_kwargs(args) -> dict:
    """``PipelineConfig`` kwargs for the decode-worker flags above."""
    return dict(
        num_workers=args.workers,
        num_worker_procs=args.data_worker_procs,
        worker_timeout=args.data_worker_timeout,
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
