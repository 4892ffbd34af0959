"""The schedule search's command line:
``python -m batchai_retinanet_horovod_coco_tpu_torch.tune``.

Three jobs, one command (the JAX package's ``tune/__main__.py`` for the
port):

- **search** (the default): measure the requested ops' candidates on
  ``--device`` (``cuda`` unless the caller asks for the CPU; without a card
  it raises), compose the winners and every trial into a registry file,
  and save it under ``--out-root`` (default ``tune/schedules/`` in this
  package), where the consumers read it at their next start.
  ``--dry-run`` prints it instead;
- **--bench-out PATH**: also write a regression record there (the NMS
  winner's keep-mask ms a batch, device time on a card);
- **--check --bench-out PATH**: measure that record's winner again and hold
  it to the record: its best window within max(3%, the record's own
  window-to-window noise) above the recorded ms; exit 1 with
  ``REGRESSION`` above it.  A record taken on another device kind passes
  with a note: latencies of two cards do not compare.

``--from-report`` takes the ops a perf-doctor report names; a report's
``batch`` (the JAX package's serve batch-size axis) is named and not
searched: the port's registry refuses ``serve`` (``tune/schedule.py``).

A sticky CUDA error mid-search (``search.DeviceUnavailable``) prints ONE
structured JSON line and exits 75 (EX_TEMPFAIL), never a traceback.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# ms a batch is lower-better, so the band is a ceiling: recorded x 1.03.
NOISE_BAND_PCT = 3.0
METRIC = "nms_keep_mask_ms_per_batch"
EXIT_DEVICE_UNAVAILABLE = 75


def _checkout() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _last_known_good(path: str | None) -> dict | None:
    try:
        with open(path) as f:
            data = json.load(f)
        return {
            "value": float(data["value"]),
            "source": os.path.basename(path),
            "note": "recorded last-known-good, NOT a fresh measurement",
        }
    except (OSError, KeyError, ValueError, TypeError):
        return None


def _emit_unavailable(phase: str, error: str, bench_out: str | None) -> int:
    """The one structured line of a dead card (mode "tune")."""
    print(
        json.dumps(
            {
                "error": "device_unavailable",
                "mode": "tune",
                "phase": phase,
                "metric": METRIC,
                "attempts": 1,
                "last_error": str(error)[-2000:],
                "last_known_good": _last_known_good(bench_out),
                "exit_code": EXIT_DEVICE_UNAVAILABLE,
            }
        ),
        flush=True,
    )
    return EXIT_DEVICE_UNAVAILABLE


def _ops_from_report(path: str) -> tuple[list[str], bool]:
    """PERF_REPORT.json (``obs/analyze``) -> (ops to search, whether it
    names ``batch``): the JAX package's reader, line for line.

    The perf doctor names, for each of its top-3 bottlenecks, the ``tune``
    problems that attack it (``tune_ops``: nms, focal, matching, batch);
    ``--from-report`` turns a run's own attribution into the next search.
    Ops come back deduplicated in rank order; ``batch`` (the JAX package's
    batch axis) comes back as a flag, which the port only names.  Raises
    SystemExit on an unreadable report or one that names nothing tunable.
    """
    ops: list[str] = []
    names: list[str] = []
    batch_axis = False
    try:
        with open(path) as f:
            report = json.load(f)
        # TypeError/AttributeError: structurally wrong JSON (a top-level
        # array, string entries) gets the same message as a missing key.
        for b in report["bottlenecks"]:
            names.append(str(b.get("name")))
            for op in b.get("tune_ops") or []:
                if op == "batch":
                    batch_axis = True
                elif op not in ops:
                    ops.append(op)
    except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
        raise SystemExit(f"--from-report: cannot read {path!r}: {e}")
    if not ops and not batch_axis:
        raise SystemExit(
            f"--from-report: {path!r} names no tunable ops in its top-3 "
            f"verdict ({names}) — nothing for the tuner to attack; run "
            "the search explicitly with --ops"
        )
    return ops, batch_axis


def _parse_hw(text: str) -> tuple[int, int]:
    try:
        h, w = text.lower().split("x")
        return int(h), int(w)
    except ValueError:
        raise SystemExit(f"--hw: not an HxW shape: {text!r}") from None


def _check(args, search_lib, device) -> int:
    """Measure the record's NMS winner again and hold it to the band."""
    from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib

    try:
        with open(args.bench_out) as f:
            recorded = json.load(f)
        recorded_ms = float(recorded["value"])
    except (OSError, KeyError, ValueError, TypeError) as e:
        print(f"# tune --check: cannot read the record: {e}")
        return 1
    device_kind = schedule_lib.resolve_kind(device)
    recorded_device = recorded.get("device_kind")
    if recorded_device != device_kind:
        print(
            f"# tune --check: the record was taken on "
            f"{recorded_device or 'an unrecorded device'!r} but this run is on "
            f"{device_kind!r}; latencies are not comparable across device kinds: "
            "take the record again with --bench-out"
        )
        return 0
    hw = tuple(recorded.get("hw", list(search_lib.DEFAULT_HW)))
    batch = int(recorded.get("batch", search_lib.DEFAULT_BATCH))
    winner = dict(recorded.get("winner") or schedule_lib.DEFAULT_SCHEDULE["nms"])
    search_lib.build_libraries(("nms",), device)
    trial = search_lib.run_trial("nms", winner, search_lib._nms_builder(batch, hw, device),
                                 args.steps, windows=search_lib.windows_for(device))
    if trial.status != "ok":
        print(f"# tune --check: the measurement failed: {trial.error}")
        return 1
    # The record's own window-to-window spread is its noise floor, so the
    # band is max(3%, that spread); the fresh side compares its BEST window:
    # a real regression slows every window, a descheduled one does not.
    band_pct = max(NOISE_BAND_PCT, float(recorded.get("noise_pct") or 0.0))
    fresh = min(trial.window_ms)
    ceiling = recorded_ms * (1 + band_pct / 100)
    verdict = "ok" if fresh <= ceiling else "REGRESSION"
    print(
        f"# tune --check: {fresh:.4f} ms/batch (best window of {trial.window_ms}) vs "
        f"recorded {recorded_ms:.4f} (ceiling {ceiling:.4f} = +{band_pct:.2f}%): {verdict}"
    )
    return 0 if verdict == "ok" else 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m batchai_retinanet_horovod_coco_tpu_torch.tune",
        description="measured schedule search -> per-device registry file",
    )
    ap.add_argument("--ops", default=None,
                    help="comma list of ops to search (default nms,focal,matching, or the "
                         "--from-report verdict)")
    ap.add_argument("--from-report", default=None, metavar="PERF_REPORT.json",
                    help="derive the search from a perf-doctor report's top-3 bottlenecks "
                         "(obs/analyze): their tune_ops in rank order ('batch' is named and not "
                         "searched).  An explicit --ops overrides")
    ap.add_argument("--hw", default=None, metavar="HxW",
                    help="bucket to measure at (default 800x1344)")
    ap.add_argument("--batch", type=int, default=None,
                    help="batch size of the op trials (default 8)")
    ap.add_argument("--steps", type=int, default=None,
                    help="timed calls a trial, split into two windows (default 30)")
    ap.add_argument("--include-semantic", action="store_true",
                    help="also measure other pre_nms_size values (recorded as "
                         "semantics-approx trials, never the winner)")
    ap.add_argument("--smoke", action="store_true",
                    help="a small run: bucket 256x256, batch 2, 4 steps")
    ap.add_argument("--device", default="cuda",
                    help="where to search: cuda (the default; raises without a card) or cpu, "
                         "where only each op's default is measured")
    ap.add_argument("--device-kind", default=None,
                    help="override the file's device_kind")
    ap.add_argument("--out-root", default=None,
                    help="registry directory (default tune/schedules/ in this package, or "
                         "RETINANET_TORCH_SCHEDULE_DIR)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the file instead of writing it")
    ap.add_argument("--bench-out", default=None, metavar="PATH",
                    help="also write the regression record here; with --check, the record "
                         "to hold the card to")
    ap.add_argument("--check", action="store_true",
                    help="measure the --bench-out record's winner again and enforce the band")
    ap.add_argument("--trace", "--obs-trace", action="store_true", dest="trace",
                    help="record the tune_* spans to a Perfetto-loadable trace in --obs-dir")
    ap.add_argument("--obs-dir", default="artifacts/obs",
                    help="where --trace writes its files")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.check and args.bench_out is None:
        ap.error("--check needs --bench-out PATH: the record to hold the card to")

    if args.from_report is not None and args.ops is None:
        report_ops, report_batch = _ops_from_report(args.from_report)
        print(f"# tune: --from-report {args.from_report} -> ops={','.join(report_ops) or '(none)'}"
              + (" (batch named: the port searches no serve batch sizes)" if report_batch else ""),
              flush=True)
        if not report_ops:
            raise SystemExit(f"--from-report: {args.from_report!r} names no op the port searches")
        args.ops = ",".join(report_ops)
    if args.ops is None:
        args.ops = "nms,focal,matching"

    hw = _parse_hw(args.hw) if args.hw else ((256, 256) if args.smoke else None)
    batch = args.batch if args.batch is not None else (2 if args.smoke else None)
    steps = args.steps if args.steps is not None else (4 if args.smoke else None)
    args.steps = steps if steps is not None else 30

    from batchai_retinanet_horovod_coco_tpu_torch.obs import trace as obs_trace
    from batchai_retinanet_horovod_coco_tpu_torch.tune import schedule as schedule_lib
    from batchai_retinanet_horovod_coco_tpu_torch.tune import search as search_lib
    from batchai_retinanet_horovod_coco_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.trace:
        obs_trace.configure(args.obs_dir, process_label="tune")
    try:
        if args.check:
            return _check(args, search_lib, device)
        kwargs = {}
        if hw is not None:
            kwargs["hw"] = hw
        if batch is not None:
            kwargs["batch"] = batch
        doc = search_lib.run_search(
            ops=tuple(p for p in args.ops.split(",") if p),
            steps=args.steps,
            include_semantic=args.include_semantic,
            device_kind=args.device_kind,
            device=device,
            **kwargs,
        )
        summary = {
            "device_kind": doc["device_kind"],
            "entries": doc["entries"],
            "trials": len(doc["trials"]),
            "failed": sum(1 for t in doc["trials"] if t["status"] == "failed"),
            "skipped": sum(1 for t in doc["trials"] if t["status"] == "skipped"),
        }
        if args.dry_run:
            print(json.dumps(doc, indent=2, sort_keys=True))
            return 0
        path = schedule_lib.save_schedule(doc, args.out_root)
        summary["artifact"] = path
        print(json.dumps(summary, sort_keys=True), flush=True)

        if args.bench_out is not None:
            win = [t for t in doc["trials"] if t["op"] == "nms" and t["status"] == "ok"
                   and t["params"] == doc["entries"].get("nms")]
            if not win:
                print("# tune: no NMS winner trial to record")
                return 1
            checkout = _checkout()
            record = {
                "metric": METRIC,
                "mode": "tune",
                "value": win[0]["ms_per_call"],
                "unit": "ms/batch of the NMS keep mask (lower is better)",
                "device_kind": doc["device_kind"],
                "hw": list(hw or search_lib.DEFAULT_HW),
                "batch": batch or search_lib.DEFAULT_BATCH,
                "steps": args.steps,
                "noise_pct": win[0]["noise_pct"],
                "winner": doc["entries"]["nms"],
                "schedule_artifact": (os.path.relpath(path, checkout)
                                      if os.path.abspath(path).startswith(checkout + os.sep)
                                      else path),
            }
            from batchai_retinanet_horovod_coco_tpu_torch.utils.atomicio import atomic_write_text

            atomic_write_text(args.bench_out, json.dumps(record, indent=2, sort_keys=True) + "\n")
            print(f"# tune: record written to {args.bench_out}")
        return 0
    except search_lib.DeviceUnavailable as e:
        return _emit_unavailable("check" if args.check else "search", str(e), args.bench_out)
    finally:
        if args.trace:
            obs_trace.export()
            merged = obs_trace.merge_traces(out_name="tune_trace.json")
            print(f"# trace written to {merged}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
