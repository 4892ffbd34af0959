"""Perf-doctor CLI: ``python -m batchai_retinanet_horovod_coco_tpu_torch.obs.analyze``.

Analysis of any obs dir after the run (the offline twin of the report the
train command line writes at finalize: byte-identical for the same
artifacts), ``--fleet`` for a fleet run's directory, and ``--check
BASELINE``: schema-validate the fresh report and hold its step-time
attribution fractions within an absolute band of BASELINE's, with the
device-class guard (reports from different device kinds are not
comparable: a mismatch passes with a re-capture note, never a false
REGRESSION).  BASELINE must be named: the repository-root
``PERF_REPORT.json`` is the JAX package's report from a TPU, no baseline
for a card.

Exit codes: 0 ok, 1 schema problem or regression, 2 usage (missing
artifacts, a ``--check`` without a baseline).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from batchai_retinanet_horovod_coco_tpu_torch.obs.analyze.report import (
    AnalyzeError,
    analyze_dir,
    analyze_fleet_dir,
    validate_report,
    write_report,
)

# Absolute per-fraction band for --check: attribution fractions move with
# host load far more than throughput does (a descheduled CPU smoke can
# shift data_wait by whole points), so the default band is generous; a
# real inversion — data_wait% doubling, step% collapsing — still trips it.
DEFAULT_BAND_ABS = 0.20


def _summary_line(report: dict, path: str | None) -> str:
    steps = report.get("steps") or {}
    mfu = report.get("mfu") or {}
    top = [b["name"] for b in report.get("bottlenecks", [])]
    return json.dumps(
        {
            "perf_report": path,
            "device_kind": (report.get("source") or {}).get("device_kind"),
            "steps": steps.get("count"),
            "decomposition": steps.get("decomposition"),
            "mfu": mfu.get("mfu"),
            "top_bottlenecks": top,
        },
        sort_keys=True,
    )


def _check(fresh: dict, baseline_path: str, band: float) -> int:
    problems = validate_report(fresh)
    if problems:
        print(f"# perf-report-check: fresh report invalid: {problems}")
        return 1
    try:
        with open(baseline_path) as f:
            committed = json.load(f)
    except (OSError, ValueError) as e:
        print(
            f"# perf-report-check: cannot read baseline "
            f"{baseline_path!r}: {e}"
        )
        return 1
    problems = validate_report(committed)
    if problems:
        print(
            f"# perf-report-check: baseline invalid: {problems}"
        )
        return 1
    fresh_dev = (fresh.get("source") or {}).get("device_kind")
    committed_dev = (committed.get("source") or {}).get("device_kind")
    if committed_dev != fresh_dev:
        # bench-check's device-class guard: fractions shift with the
        # host/device balance, so cross-class comparison is meaningless.
        print(
            f"# perf-report-check: baseline was captured on "
            f"{committed_dev!r} but this run is on {fresh_dev!r}; "
            "attribution fractions are not comparable across device "
            "classes — re-capture the baseline on this device"
        )
        return 0
    fresh_d = (fresh.get("steps") or {}).get("decomposition")
    committed_d = (committed.get("steps") or {}).get("decomposition")
    if not fresh_d or not committed_d:
        print(
            "# perf-report-check: a report has no step decomposition "
            "(no train loop in the trace?) — nothing to band-check"
        )
        return 1
    rc = 0
    for key in sorted(committed_d):
        got = float(fresh_d.get(key, 0.0))
        want = float(committed_d[key])
        delta = got - want
        verdict = "ok" if abs(delta) <= band else "REGRESSION"
        print(
            f"# perf-report-check: {key}: {got:.3f} vs baseline "
            f"{want:.3f} (band ±{band:.2f}): {verdict}"
        )
        if verdict != "ok":
            rc = 1
    return rc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m batchai_retinanet_horovod_coco_tpu_torch.obs.analyze",
        description="obs artifacts -> PERF_REPORT.json (the perf doctor)",
    )
    ap.add_argument("obs_dir", help="observability artifact directory "
                                    "(as left by an --obs-trace run)")
    ap.add_argument("--trace", default="trace.json",
                    help="trace file name inside obs_dir (bench runs "
                         "write bench_<mode>_trace.json)")
    ap.add_argument("--events", default="metrics.jsonl",
                    help="events JSONL name inside obs_dir (enrichment; "
                         "analysis proceeds without it)")
    ap.add_argument("--fleet", action="store_true",
                    help="fleet mode: the obs dir is a fleet "
                         "CLI run's — add the per-replica decomposition, "
                         "time-weighted routing share, breaker/canary/"
                         "re-dispatch timeline (from the merged trace) "
                         "and the FLEET_METRICS.json cross-reference, "
                         "with fleet verdicts (unavailable / most-shed / "
                         "slowest replica) ranked into the bottlenecks")
    ap.add_argument("--fleet-metrics", default="FLEET_METRICS.json",
                    help="federated metrics dump name inside obs_dir "
                         "(--fleet mode; analysis proceeds without it)")
    ap.add_argument("--out", default=None,
                    help="report path (default <obs_dir>/PERF_REPORT.json)")
    ap.add_argument("--print", action="store_true", dest="print_report",
                    help="print the full report to stdout as well")
    ap.add_argument("--check", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="check mode: schema-validate and enforce the "
                         "attribution-fraction band against BASELINE, a "
                         "report of this package on this device kind (no "
                         "default: the repository-root PERF_REPORT.json is "
                         "the JAX package's TPU report)")
    ap.add_argument("--band", type=float,
                    default=float(
                        os.environ.get("PERF_BAND_ABS", str(DEFAULT_BAND_ABS))
                    ),
                    help="absolute per-fraction band for --check "
                         "(env PERF_BAND_ABS)")
    args = ap.parse_args(argv)
    if args.check == "":
        print("# obs.analyze: --check needs a BASELINE report path: the "
              "repository-root PERF_REPORT.json is the JAX package's report "
              "from a TPU, no baseline for this package's runs on a card",
              file=sys.stderr)
        return 2

    try:
        if args.fleet:
            report = analyze_fleet_dir(
                args.obs_dir, trace_name=args.trace,
                events_name=args.events,
                metrics_name=args.fleet_metrics,
            )
        else:
            report = analyze_dir(
                args.obs_dir, trace_name=args.trace,
                events_name=args.events,
            )
    except AnalyzeError as e:
        print(f"# obs.analyze: {e}", file=sys.stderr)
        print(
            "# obs.analyze: run a traced workload first, e.g. `python -m "
            "batchai_retinanet_horovod_coco_tpu_torch.train ... --obs-trace "
            "--obs-dir <dir>`",
            file=sys.stderr,
        )
        return 2

    out = args.out or os.path.join(args.obs_dir, "PERF_REPORT.json")
    write_report(report, out)
    if args.print_report:
        print(json.dumps(report, indent=2, sort_keys=True))
    print(_summary_line(report, out))

    if args.check is not None:
        return _check(report, args.check, args.band)
    problems = validate_report(report)
    if problems:
        print(f"# obs.analyze: report failed schema validation: {problems}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
