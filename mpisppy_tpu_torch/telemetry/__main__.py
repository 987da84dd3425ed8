###############################################################################
# `python -m mpisppy_tpu_torch.telemetry <analyze|compare|gate>` — the trace
# toolbox CLI (port of mpisppy_tpu/telemetry/__main__.py: the same
# subcommands, arguments and exit codes).  Pure host-side stdlib: runs
# on any machine holding a trace, with no card and no JAX.
#
#   analyze [--trace-jsonl T] [--profile-dir D] [--run ID] [--json]
#       per-phase wall-time breakdown, bound progress + stalls,
#       per-spoke bound attribution, dispatch audit, crash forensics —
#       T may be a --trace-jsonl stream OR a flight-<runid>.jsonl dump.
#       --profile-dir joins the DEVICE section (trace-derived roofline:
#       measured_stream_gbps, achieved HBM GB/s, MFU, DMA/compute
#       overlap_frac, busy share) from a torch.profiler capture (the
#       run's --profile-dir, telemetry/profiler.py); with --trace-jsonl
#       alone, a capture advertised by the run's `profile` events is
#       auto-discovered.  --profile-dir alone renders the device-only
#       report.
#   watch --trace-jsonl T [--metrics-snapshot M] [--interval S] [--once]
#       live-tail a RUNNING wheel: bound/gap, sec/iter, dispatch
#       occupancy, quarantine counts; --once prints one snapshot.
#   watch --trace-dir D [--interval S] [--once]
#       live-tail a DIRECTORY of per-session traces (the serve layer
#       writes one per session) as a per-tenant session table.
#   trace [ID] (--trace-dir D | --trace-jsonl T) [--json]
#       assemble one causal span tree per trace id across per-session /
#       per-replica / fleet JSONL segments: span hierarchy,
#       migration/reshard spans, critical-path latency buckets; exit 2
#       on orphan spans (a dropped propagation hop).
#   slo (--trace-dir D | --trace-jsonl T | --bench B) [--json]
#       evaluate the declarative SLOs (slo.DEFAULT_SLOS) into error
#       budgets + burn rates from slo-observation rows or a committed
#       BENCH artifact; exit 2 on a violated budget.
#   compare OLD NEW [--json]
#       diff the perf metrics of two artifacts (analyzer --json
#       reports, device roofline reports, BENCH_DETAIL.json, or
#       BENCH_r0N.json wrappers).
#   gate OLD NEW [--threshold KEY=FRAC ...] [--milestones] [--json]
#       compare + direction-aware thresholds + absolute milestone
#       floors (ratchet by default, strict with --milestones); exit 2
#       on a regression.
###############################################################################
from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpisppy_tpu_torch.telemetry",
        description="wheel trace analyzer / perf-regression gate")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("analyze", help="analyze a JSONL wheel trace "
                                        "and/or a device capture")
    pa.add_argument("--trace-jsonl", default=None,
                    help="trace file (--trace-jsonl output or a "
                         "flight-<runid>.jsonl black box)")
    pa.add_argument("--profile-dir", default=None,
                    help="torch.profiler capture dir (--profile-dir of "
                         "the run, a capture dir or a .pt.trace.json[.gz] "
                         "file): adds the trace-derived device section")
    pa.add_argument("--run", default=None,
                    help="run id to analyze (default: last in stream)")
    pa.add_argument("--json", action="store_true",
                    help="machine report instead of the human rendering")

    pw = sub.add_parser("watch", help="live-tail a running wheel's "
                                      "trace + metrics snapshot, or a "
                                      "serve trace directory")
    pw.add_argument("--trace-jsonl", default=None,
                    help="the running wheel's --trace-jsonl path")
    pw.add_argument("--trace-dir", default=None,
                    help="a directory of per-session JSONL traces "
                         "(the serve layer writes one per session; "
                         "docs/serving.md) — renders the per-tenant "
                         "session table instead of the single-run "
                         "status block")
    pw.add_argument("--metrics-snapshot", default=None,
                    help="the wheel's --metrics-snapshot file "
                         "(Prometheus text) to fold into the display")
    pw.add_argument("--interval", type=float, default=2.0,
                    help="refresh period, seconds (default 2)")
    pw.add_argument("--once", action="store_true",
                    help="print one status snapshot and exit")

    pt = sub.add_parser("trace", help="assemble one causal span tree "
                                      "from per-session/fleet JSONL "
                                      "segments")
    pt.add_argument("trace_id", nargs="?", default=None,
                    help="full trace id, a unique prefix, or 'last' "
                         "(default: the only trace present)")
    pt.add_argument("--trace-dir", default=None,
                    help="directory of JSONL segments (per-session, "
                         "per-replica subdirs, router stream) to join")
    pt.add_argument("--trace-jsonl", default=None,
                    help="a single JSONL trace file")
    pt.add_argument("--json", action="store_true",
                    help="machine report (schema mpisppy-tpu-trace/1)")

    ps = sub.add_parser("slo", help="evaluate SLO error budgets / "
                                    "burn rates from traces or a "
                                    "committed bench artifact")
    ps.add_argument("--trace-dir", default=None,
                    help="trace dir: fold its slo-observation rows")
    ps.add_argument("--trace-jsonl", default=None,
                    help="a single JSONL trace file")
    ps.add_argument("--bench", default=None,
                    help="a BENCH_r*.json artifact: evaluate its "
                         "serve/fleet/MPC sections")
    ps.add_argument("--json", action="store_true")

    for name, hlp in (("compare", "diff two perf artifacts"),
                      ("gate", "compare + thresholds; exit 2 on "
                               "regression")):
        pc = sub.add_parser(name, help=hlp)
        pc.add_argument("old")
        pc.add_argument("new")
        pc.add_argument("--json", action="store_true")
        if name == "gate":
            pc.add_argument("--threshold", action="append", default=[],
                            metavar="KEY=FRAC",
                            help="override: metric-key substring = "
                                 "relative threshold (repeatable)")
            pc.add_argument("--milestones", action="store_true",
                            help="make the absolute MILESTONE bounds "
                                 "(S=10k sec_per_iter <= 0.045, S=100k "
                                 "iters/s >= 2) bind even when the old "
                                 "artifact predates the win; default "
                                 "is ratchet semantics (bind once "
                                 "landed)")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "analyze":
        from mpisppy_tpu_torch.telemetry import analyze as an
        if not args.trace_jsonl and not args.profile_dir:
            print("analyze: need --trace-jsonl and/or --profile-dir",
                  file=sys.stderr)
            return 1
        try:
            if args.trace_jsonl:
                rep = an.analyze_path(args.trace_jsonl, run=args.run,
                                      profile_dir=args.profile_dir)
                text = an.render_report(rep)
            else:
                # device-only: the roofline report straight from the
                # capture
                from mpisppy_tpu_torch.telemetry import roofline
                rep = roofline.roofline_path(args.profile_dir)
                text = roofline.render_device(rep)
        except (OSError, ValueError) as e:
            print(f"analyze: {e}", file=sys.stderr)
            return 1
        print(json.dumps(rep) if args.json else text)
        return 0

    if args.cmd == "watch":
        from mpisppy_tpu_torch.telemetry import watch as w
        if bool(args.trace_jsonl) == bool(args.trace_dir):
            print("watch: need exactly one of --trace-jsonl / "
                  "--trace-dir", file=sys.stderr)
            return 1
        if args.trace_dir:
            return w.watch_dir(args.trace_dir, interval=args.interval,
                               once=args.once)
        return w.watch(args.trace_jsonl,
                       metrics_path=args.metrics_snapshot,
                       interval=args.interval, once=args.once)

    if args.cmd == "trace":
        from mpisppy_tpu_torch.telemetry import spans
        path = args.trace_dir or args.trace_jsonl
        if not path:
            print("trace: need --trace-dir or --trace-jsonl",
                  file=sys.stderr)
            return 1
        try:
            rep = spans.assemble_path(path, trace=args.trace_id)
        except (OSError, ValueError) as e:
            print(f"trace: {e}", file=sys.stderr)
            return 1
        print(json.dumps(rep) if args.json
              else spans.render_trace(rep))
        return 0 if not rep["orphans"] else 2

    if args.cmd == "slo":
        from mpisppy_tpu_torch.telemetry import regress, slo
        path = args.trace_dir or args.trace_jsonl
        if bool(path) == bool(args.bench):
            print("slo: need exactly one of --trace-dir/--trace-jsonl "
                  "or --bench", file=sys.stderr)
            return 1
        try:
            if args.bench:
                rep = slo.evaluate_bench(
                    regress.load_artifact(args.bench))
            else:
                rep = slo.evaluate_path(path)
        except (OSError, ValueError) as e:
            print(f"slo: {e}", file=sys.stderr)
            return 1
        slo.export_metrics(rep)
        print(json.dumps(rep) if args.json else slo.render_slo(rep))
        return 0 if all(r["ok"] for r in rep["slo"].values()) else 2

    from mpisppy_tpu_torch.telemetry import regress
    overrides = {}
    for spec in getattr(args, "threshold", []):
        try:
            key, frac = spec.split("=", 1)
            overrides[key] = float(frac)
        except ValueError:
            print(f"bad --threshold {spec!r} (want KEY=FRAC)",
                  file=sys.stderr)
            return 1
    try:
        if args.cmd == "gate":
            rep = regress.gate_paths(
                args.old, args.new, overrides,
                milestones=getattr(args, "milestones", False))
        else:
            rep = regress.compare_paths(args.old, args.new)
    except (OSError, ValueError) as e:
        print(f"{args.cmd}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(rep) if args.json
          else regress.render_compare(rep, only_gated=False))
    if args.cmd == "gate" and not rep["ok"]:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
