###############################################################################
# `python -m mpisppy_tpu_torch.serve` — run the multi-tenant wheel server
# (port of mpisppy_tpu/serve/__main__.py; docs/serving.md).
#
#   python -m mpisppy_tpu_torch.serve --unix /tmp/wheel.sock \
#       --max-running 2 --tenant-quota 2 --trace-dir ./serve-traces \
#       --spool-dir ./serve-spool
#
# The process serves until SIGINT/SIGTERM; clients speak the JSON-lines
# protocol (serve/protocol.py).  Sessions run on the CUDA device; without
# one the server exits 1 with a message unless --device cpu asks for the
# CPU, so no session ever runs on the CPU unasked.  Watch it live with
#   python -m mpisppy_tpu_torch.telemetry watch --trace-dir ./serve-traces
###############################################################################
from __future__ import annotations

import argparse
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpisppy_tpu_torch.serve",
        description="multi-tenant stochastic-program wheel server")
    p.add_argument("--unix", default=None,
                   help="unix socket path to listen on (preferred)")
    p.add_argument("--host", default="127.0.0.1",
                   help="TCP bind host (used when --unix is not set)")
    p.add_argument("--port", type=int, default=7453,
                   help="TCP bind port")
    p.add_argument("--max-running", type=int, default=2,
                   help="concurrent session workers")
    p.add_argument("--max-queued", type=int, default=64,
                   help="global admission queue cap (backpressure)")
    p.add_argument("--tenant-quota", type=int, default=2,
                   help="per-tenant in-flight session cap")
    p.add_argument("--tenant-weight", action="append", default=[],
                   metavar="TENANT=W",
                   help="WFQ weight override (repeatable)")
    p.add_argument("--latency-burst", type=int, default=4,
                   help="consecutive latency-class admissions before "
                        "one throughput session is forced through")
    p.add_argument("--trace-dir", default=None,
                   help="write one JSONL trace per session here "
                        "(telemetry watch --trace-dir tails it)")
    p.add_argument("--spool-dir", default=None,
                   help="session checkpoint spool (preemption-safe "
                        "resume)")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-session deadline (typed failure "
                        "on expiry; sessions may override)")
    p.add_argument("--step-miss-budget", type=int, default=3,
                   help="consecutive per-step deadline misses before "
                        "a RUNNING MPC stream is reaped (streams set "
                        "step_deadline_s per session)")
    p.add_argument("--no-multiplex", action="store_true",
                   help="run sessions on the synchronous hub without "
                        "the exchange interleave ring")
    p.add_argument("--device", default="cuda",
                   help="where every session's wheel runs (default "
                        "cuda; 'cpu' serves on the CPU); clients cannot "
                        "override it")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    weights = {}
    for spec in args.tenant_weight:
        try:
            name, w = spec.split("=", 1)
            weights[name] = float(w)
        except ValueError:
            print(f"bad --tenant-weight {spec!r} (want TENANT=W)",
                  file=sys.stderr)
            return 1
    if args.device != "cpu":
        import torch
        if not torch.cuda.is_available():
            print(f"serve: --device {args.device} needs a CUDA device and "
                  "torch.cuda.is_available() is false; pass --device cpu "
                  "to serve on the CPU", file=sys.stderr)
            return 1
    from mpisppy_tpu_torch.serve.server import ServeOptions, WheelServer
    opts = ServeOptions(
        unix_path=args.unix, host=args.host,
        port=args.port if not args.unix else 0,
        max_running=args.max_running, max_queued=args.max_queued,
        tenant_quota=args.tenant_quota,
        tenant_weights=weights or None,
        latency_burst=args.latency_burst,
        trace_dir=args.trace_dir, spool_dir=args.spool_dir,
        default_deadline_s=args.deadline_s,
        step_miss_budget=args.step_miss_budget,
        multiplex=not args.no_multiplex, device=args.device)
    server = WheelServer(opts).start()
    print(f"serving on {server.address}")  # telemetry: allow-print
    try:
        server.serve_forever()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
