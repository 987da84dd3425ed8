###############################################################################
# `telemetry watch` — live wheel monitoring (port of
# mpisppy_tpu/telemetry/watch.py).
#
# Tails a RUNNING wheel's --trace-jsonl stream (and, optionally, its
# --metrics-snapshot Prometheus file) and renders a refreshing status
# block: bound/gap, steady-state sec/iter, dispatch occupancy and
# queue pressure, quarantine/strike counts, checkpoint age.  Built for
# the long S=100k runs where the console scrolls too fast to read and
# the analyzer only answers post-mortem.
#
# Pure stdlib, incremental: the file is read FROM THE LAST OFFSET each
# tick (a 10-hour trace is parsed once, not per refresh), torn final
# lines are retried next tick, and a log-rotated/truncated file is
# detected by shrinkage and re-read from the top.  `--once` renders a
# single snapshot and exits — the mode CI smoke-tests.
###############################################################################
from __future__ import annotations

import json
import os
import sys
import time

from mpisppy_tpu_torch.telemetry import slo as _slo
from mpisppy_tpu_torch.telemetry.metrics import Histogram


class WatchState:
    """Rolling view over one run's event stream (newest run wins —
    a restarted wheel appending to the same path takes over the
    display, matching the analyzer's default run selection)."""

    def __init__(self):
        self.run = None
        self.hub_class = None
        self.tenant = None          # serve layer: session-state rows
        self.sla = None
        self.session = None
        self.session_state = None
        self.replica = None         # fleet: replica this trace segment
                                    # rode on (session-state payloads)
        self.migrations = 0         # fleet: session-migrated events
                                    # seen in THIS segment
        self.events = 0
        self.last_iter = None
        self.outer = self.inner = self.rel_gap = None
        self.iter_monos: list = []      # (iter, t_mono) tail
        self.megabatch_lanes = 0
        self.megabatch_padded = 0
        self.megabatches = 0
        self.dispatch_last: dict = {}
        self.quarantine_resets = 0
        self.strikes = 0
        self.disables = 0
        self.faults = 0
        self.dispatch_retries = 0
        self.dispatch_quarantined = 0
        self.watchdog_trips = 0
        self.mesh_epoch = 0         # elastic mesh
        self.mesh_hosts_lost = 0
        self.mesh_reshards = 0
        self.mesh_devices = None    # old->new of the latest reshard
        self.mesh_stragglers = 0
        self.mpc_steps = 0          # MPC streams: mpc-step
        self.mpc_last_step = None   # events on the session trace
        self.mpc_warm = 0
        self.mpc_degraded = 0
        self.mpc_latencies: list = []   # recent step latency_s tail
                                        # (display only; capped)
        # ALL step latencies fold into a histogram so the p50 covers
        # the stream's whole life in O(1) memory — the old tail-only
        # median silently forgot everything before the last 64 windows
        self.mpc_hist = Histogram()
        self.trace_id = None        # causal trace id — the
                                    # migrated-segment join key
        self.slo_obs: list = []     # slo-observation payloads
        self.ckpt_writes = 0
        self.last_ckpt_wall = None
        self.last_event_wall = None
        self.end: dict | None = None
        self.profile_dir = None

    def feed(self, row: dict) -> None:
        kind = row.get("kind")
        run = row.get("run")
        if run and run != self.run:
            if kind == "run-start" or self.run is None:
                # new segment: reset to follow the newest run
                self.__init__()
                self.run = run
            else:
                return                 # stale cross-run stragglers
        self.events += 1
        self.last_event_wall = row.get("t_wall", self.last_event_wall)
        if row.get("trace_id") and self.trace_id is None:
            self.trace_id = row["trace_id"]
        data = row.get("data", {})
        it = row.get("iter")
        if kind == "run-start":
            self.hub_class = data.get("hub_class")
        elif kind == "hub-iteration":
            self.last_iter = data.get("iter", it)
            self.outer = data.get("outer", self.outer)
            self.inner = data.get("inner", self.inner)
            self.rel_gap = data.get("rel_gap", self.rel_gap)
            if row.get("t_mono") is not None:
                self.iter_monos.append((self.last_iter, row["t_mono"]))
                del self.iter_monos[:-32]
        elif kind == "dispatch":
            if row.get("cyl") == "dispatch":
                self.megabatches += 1
                self.megabatch_lanes += data.get("lanes", 0)
                self.megabatch_padded += data.get("padded_to", 0)
            else:
                self.dispatch_last = data
        elif kind == "lane-quarantine":
            self.quarantine_resets += data.get("resets", 0)
        elif kind == "dispatch-retry":
            self.dispatch_retries += 1
        elif kind == "dispatch-quarantine":
            self.dispatch_quarantined += data.get("lanes", 0)
        elif kind == "watchdog":
            # count hub-watchdog TRIPS only, mirroring the analyzer's
            # resilience summary — a dispatcher fail-fast event shares
            # the kind but is not a progress-watchdog trip
            if data.get("action") in ("abort", "degrade"):
                self.watchdog_trips += 1
        elif kind == "spoke-strike":
            self.strikes += 1
        elif kind == "spoke-disable":
            self.disables += 1
        elif kind == "fault-injected":
            self.faults += 1
        elif kind == "mpc-step":
            # rolling-horizon stream (docs/mpc.md): one row per solved
            # window; degraded windows carry degraded=True here too, so
            # the paired mpc-degraded event needs no extra counting
            self.mpc_steps += 1
            self.mpc_last_step = data.get("step", self.mpc_last_step)
            self.mpc_warm += 1 if data.get("warm") else 0
            self.mpc_degraded += 1 if data.get("degraded") else 0
            if data.get("latency_s") is not None:
                self.mpc_hist.observe(data["latency_s"])
                self.mpc_latencies.append(data["latency_s"])
                del self.mpc_latencies[:-64]
        elif kind == "checkpoint-write":
            self.ckpt_writes += 1
            self.last_ckpt_wall = row.get("t_wall")
        elif kind == "run-end":
            self.end = data
        elif kind == "session-state":
            # serve layer (docs/serving.md): the per-session lifecycle
            # rides the same trace; the newest state wins the display
            self.tenant = data.get("tenant", self.tenant)
            self.sla = data.get("sla", self.sla)
            self.session = data.get("session", self.session)
            self.session_state = data.get("state", self.session_state)
            self.replica = data.get("replica", self.replica)
        elif kind == "session-migrated":
            # fleet: this segment ends here; the destination replica's
            # segment continues the same (run, session)
            self.session = data.get("session", self.session)
            self.tenant = data.get("tenant", self.tenant)
            self.migrations = max(self.migrations,
                                  data.get("migrations", 0) or 0)
        elif kind == "mesh-state":
            self.mesh_epoch = max(self.mesh_epoch,
                                  data.get("epoch", 0) or 0)
        elif kind == "mesh-host-lost":
            self.mesh_hosts_lost += 1
        elif kind == "mesh-reshard":
            self.mesh_reshards += 1
            self.mesh_devices = (f"{data.get('old_devices')}->"
                                 f"{data.get('new_devices')}")
        elif kind == "mesh-straggler":
            self.mesh_stragglers += 1
        elif kind == "slo-observation":
            # one terminal SLO sample per session: folded
            # into the live burn-rate rows below the session table
            if "outcome" in data:
                self.slo_obs.append(data)
                del self.slo_obs[:-256]
        elif kind == "profile":
            self.profile_dir = data.get("profile_dir", self.profile_dir)

    @property
    def sec_per_iter(self) -> float | None:
        ms = [m for _, m in self.iter_monos]
        deltas = sorted(b - a for a, b in zip(ms, ms[1:]) if b > a)
        return deltas[len(deltas) // 2] if deltas else None

    @property
    def mpc_step_latency_p50(self) -> float | None:
        """p50 over EVERY retained window (the histogram), not just
        the recent display tail."""
        if not self.mpc_hist.count:
            return None
        return self.mpc_hist.quantile(0.5)


def _follow(path: str, state: WatchState, pos: int) -> int:
    """Feed appended complete lines; returns the new offset."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return pos
    if size < pos:      # truncated/rotated: start over
        state.__init__()
        pos = 0
    if size == pos:
        return pos
    with open(path, "rb") as f:
        f.seek(pos)
        chunk = f.read()
    # keep a torn final line for the next tick
    last_nl = chunk.rfind(b"\n")
    if last_nl < 0:
        return pos
    for line in chunk[:last_nl].split(b"\n"):
        line = line.strip()
        if not line:
            continue
        try:
            state.feed(json.loads(line))
        except ValueError:
            continue
    return pos + last_nl + 1


def read_metrics_snapshot(path: str) -> dict[str, float]:
    """Prometheus text exposition -> {metric_name: value} (labels are
    folded into the name verbatim; last sample wins)."""
    out: dict[str, float] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.rsplit(" ", 1)
                if len(parts) != 2:
                    continue
                try:
                    out[parts[0]] = float(parts[1])
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def _fmt(v, spec=".6g"):
    return "-" if v is None else format(v, spec)


def render_status(state: WatchState,
                  metrics: dict[str, float] | None = None) -> str:
    L: list[str] = []
    age = (time.time() - state.last_event_wall
           if state.last_event_wall else None)
    L.append(f"run {state.run or '?'}  hub={state.hub_class or '?'}  "
             f"events {state.events}"
             + (f"  last event {age:.1f}s ago" if age is not None
                else ""))
    gap = state.rel_gap
    L.append(f"iter {_fmt(state.last_iter)}  outer {_fmt(state.outer)}  "
             f"inner {_fmt(state.inner)}  rel_gap {_fmt(gap, '.3e')}"
             f"  sec/iter {_fmt(state.sec_per_iter, '.4g')}")
    occ = (state.megabatch_lanes / state.megabatch_padded
           if state.megabatch_padded else None)
    d = state.dispatch_last
    L.append(f"dispatch: megabatches {state.megabatches}"
             f"  occupancy {_fmt(occ, '.3f')}"
             f"  inflight_max {_fmt(d.get('inflight_max'))}"
             f"  compiles {_fmt(d.get('backend_compiles'))}"
             f"  unexpected {_fmt(d.get('unexpected_recompiles'))}")
    ck_age = (time.time() - state.last_ckpt_wall
              if state.last_ckpt_wall else None)
    L.append(f"resilience: quarantine resets {state.quarantine_resets}"
             f"  strikes {state.strikes}  disabled {state.disables}"
             f"  faults {state.faults}"
             f"  retries {state.dispatch_retries}"
             f"  quarantined lanes {state.dispatch_quarantined}"
             f"  watchdog {state.watchdog_trips}"
             f"  ckpt writes {state.ckpt_writes}"
             + (f" (last {ck_age:.0f}s ago)" if ck_age is not None
                else ""))
    if (state.mesh_epoch or state.mesh_hosts_lost
            or state.mesh_reshards or state.mesh_stragglers):
        L.append(f"mesh: epoch {state.mesh_epoch}"
                 f"  hosts lost {state.mesh_hosts_lost}"
                 f"  reshards {state.mesh_reshards}"
                 + (f" ({state.mesh_devices} devices)"
                    if state.mesh_devices else "")
                 + (f"  stragglers/tears {state.mesh_stragglers}"
                    if state.mesh_stragglers else ""))
    if state.mpc_steps:
        L.append(f"mpc: steps {state.mpc_steps}"
                 f" (last {_fmt(state.mpc_last_step, 'd')})"
                 f"  warm {state.mpc_warm}"
                 f"  degraded {state.mpc_degraded}"
                 f"  step p50 "
                 f"{_fmt(state.mpc_step_latency_p50, '.3g')}s")
    if metrics:
        keys = sorted(k for k in metrics
                      if k.startswith(("dispatch_", "wheel_", "pdhg_")))
        if keys:
            L.append("metrics: " + "  ".join(
                f"{k}={metrics[k]:g}" for k in keys[:6]))
    if state.end is not None:
        L.append(f"RUN ENDED: {state.end.get('reason')}  rel_gap "
                 f"{_fmt(state.end.get('rel_gap'), '.3e')}")
    if state.profile_dir:
        L.append(f"profiler captures under {state.profile_dir} "
                 f"(analyze --profile-dir to inspect)")
    return "\n".join(L)


# ---------------------------------------------------------------------------
# directory mode (`telemetry watch --trace-dir`)
# ---------------------------------------------------------------------------
def _fmt_cell(v, spec=".3g", width=0):
    s = "-" if v is None else format(v, spec)
    return s.rjust(width) if width else s


def merge_session_rows(states: dict[str, "WatchState"]) -> list[dict]:
    """Fold per-FILE states into per-SESSION rows.  A fleet-migrated
    session leaves one trace segment per replica it ran on (the same
    sid file name under each replica's subdirectory); the segments
    join on the CAUSAL TRACE ID so the session counts ONCE,
    with the newest segment supplying its current state and the
    replica chain recording the journey; the (run id, session id)
    heuristic remains only as the fallback for pre-trace segments."""
    groups: dict = {}
    for name in sorted(states):
        st = states[name]
        if st.trace_id:
            key = st.trace_id
        elif st.run and st.session:
            key = (st.run, st.session)
        else:
            key = name
        groups.setdefault(key, []).append((name, st))
    rows: list[dict] = []
    for key in groups:
        segs = groups[key]
        # segment order = event recency (the destination segment is
        # the live one; ties keep listing order)
        segs = sorted(segs, key=lambda p: p[1].last_event_wall or 0.0)
        chain = []
        for name, s in segs:
            rep = s.replica or os.path.dirname(name) or None
            if rep and rep not in chain:
                chain.append(rep)
        name, prim = segs[-1]
        iters = [s.last_iter for _, s in segs
                 if isinstance(s.last_iter, int)]
        rows.append({
            "session": prim.session or os.path.basename(name)
            .replace("session-", "").replace(".jsonl", ""),
            "tenant": next((s.tenant for _, s in reversed(segs)
                            if s.tenant), "?"),
            "sla": next((s.sla for _, s in reversed(segs) if s.sla),
                        None),
            "state": prim.session_state,
            "iter": max(iters) if iters else None,
            "rel_gap": prim.rel_gap,
            "sec_per_iter": prim.sec_per_iter,
            "events": sum(s.events for _, s in segs),
            "chain": chain,
            "replica": chain[-1] if chain else None,
            "migrations": max((s.migrations for _, s in segs),
                              default=0),
            "mpc_steps": sum(s.mpc_steps for _, s in segs),
            "step_p50": prim.mpc_step_latency_p50,
        })
    return rows


def render_tenant_table(states: dict[str, "WatchState"]) -> str:
    """Per-session table over a directory of per-session traces (the
    serve layer writes one per session; docs/serving.md), grouped by
    tenant with a per-tenant rollup line.  Fleet layouts (per-replica
    subdirectories) get a replica column — `r0>r1` marks a migrated
    session — and a per-replica summary block."""
    L: list[str] = []
    rows = merge_session_rows(states)
    fleet = any(r["replica"] for r in rows)
    mpc = any(r["mpc_steps"] for r in rows)
    rep_w = 9 if fleet else 0
    head = (f"{'session':<10} {'tenant':<10} {'sla':<10} {'state':<9} "
            f"{'iter':>5} {'rel_gap':>9} {'s/iter':>8} {'events':>7}")
    if mpc:
        # MPC streams (docs/mpc.md): windows solved + step-latency p50
        head += f" {'steps':>6} {'step p50':>9}"
    if fleet:
        head += f" {'replica':<9}"
    L.append(head)
    by_tenant: dict[str, list] = {}
    for r in rows:
        by_tenant.setdefault(r["tenant"], []).append(r)
    for tenant in sorted(by_tenant):
        rows_t = by_tenant[tenant]
        done = sum(1 for r in rows_t
                   if r["state"] in ("DONE", "FAILED", "REJECTED"))
        gaps = [r["rel_gap"] for r in rows_t
                if r["rel_gap"] is not None]
        L.append(f"tenant {tenant}: {len(rows_t)} session(s), "
                 f"{done} terminal"
                 + (f", best rel_gap {min(gaps):.3e}" if gaps else ""))
        for r in sorted(rows_t, key=lambda r: r["session"]):
            line = (
                f"  {r['session']:<8} {tenant:<10} "
                f"{r['sla'] or '-':<10} {r['state'] or '-':<9} "
                f"{_fmt_cell(r['iter'], 'd'):>5} "
                f"{_fmt_cell(r['rel_gap'], '.3e'):>9} "
                f"{_fmt_cell(r['sec_per_iter'], '.3g'):>8} "
                f"{r['events']:>7}")
            if mpc:
                line += (f" {_fmt_cell(r['mpc_steps'], 'd'):>6} "
                         f"{_fmt_cell(r['step_p50'], '.3g'):>9}")
            if fleet:
                line += f" {'>'.join(r['chain']) or '-':<{rep_w}}"
            L.append(line)
    if fleet:
        reps = sorted({rep for r in rows for rep in r["chain"]})
        for rid in reps:
            here = [r for r in rows if r["replica"] == rid]
            touched = [r for r in rows if rid in r["chain"]]
            done = sum(1 for r in here
                       if r["state"] in ("DONE", "FAILED", "REJECTED"))
            moved = sum(1 for r in touched if len(r["chain"]) > 1)
            L.append(f"replica {rid}: {len(here)} session(s) "
                     f"resident, {done} terminal, {moved} migrated")
    # live SLO burn rates: fold every settled session's
    # slo-observation sample into the per-class error budgets
    obs = [{"kind": "slo-observation", "data": d}
           for st in states.values() for d in st.slo_obs]
    if obs:
        rep = _slo.evaluate_observations(obs)
        for name, row in rep["slo"].items():
            if not row["samples"]:
                continue
            verdict = "ok" if row["ok"] else "BUDGET EXHAUSTED"
            L.append(f"slo {name}: burn {row['burn_rate']:.2f}  "
                     f"budget left {row['budget_remaining']:.2f}  "
                     f"({row['bad']}/{row['samples']} bad)  {verdict}")
    if not by_tenant:
        L.append("(no session traces yet)")
    return "\n".join(L)


def watch_dir(trace_dir: str, interval: float = 2.0,
              once: bool = False, out=None) -> int:
    """Tail a DIRECTORY of per-session JSONL traces (the serve layer
    writes one per session) and render the per-tenant table.  New
    files are picked up between ticks; each file keeps its own
    incremental offset.  A fleet layout — per-replica SUBDIRECTORIES
    each holding that replica's session traces — is walked one level
    deep; aggregate streams (fleet.jsonl) are skipped, and a migrated
    session's segments merge on (run, sid) so it never double-counts."""
    out = out or sys.stdout
    if not os.path.isdir(trace_dir):
        print(f"watch: no trace directory at {trace_dir!r}",
              file=sys.stderr)
        return 1
    states: dict[str, WatchState] = {}
    offsets: dict[str, int] = {}

    def _scan() -> list[str]:
        try:
            entries = sorted(os.listdir(trace_dir))
        except OSError:
            return []
        found: list[str] = []
        for e in entries:
            p = os.path.join(trace_dir, e)
            if e.endswith(".jsonl") and os.path.isfile(p):
                found.append(e)
            elif os.path.isdir(p):
                try:
                    subs = sorted(os.listdir(p))
                except OSError:
                    continue
                found.extend(os.path.join(e, s) for s in subs
                             if s.endswith(".jsonl"))
        session_only = [n for n in found
                        if os.path.basename(n).startswith("session-")]
        return session_only or found

    try:
        while True:
            names = _scan()
            for n in names:
                st = states.setdefault(n, WatchState())
                offsets[n] = _follow(os.path.join(trace_dir, n), st,
                                     offsets.get(n, 0))
            block = render_tenant_table(states)
            if once:
                print(block, file=out, flush=True)
                return 0
            print("\x1b[2J\x1b[H" + block, file=out, flush=True)
            time.sleep(max(0.2, interval))
    except KeyboardInterrupt:
        return 0


def watch(trace_path: str, metrics_path: str | None = None,
          interval: float = 2.0, once: bool = False,
          out=None) -> int:
    """The `telemetry watch` loop.  Returns the process exit code."""
    out = out or sys.stdout
    if not os.path.exists(trace_path):
        print(f"watch: no trace at {trace_path!r}", file=sys.stderr)
        return 1
    state = WatchState()
    pos = 0
    try:
        while True:
            pos = _follow(trace_path, state, pos)
            metrics = (read_metrics_snapshot(metrics_path)
                       if metrics_path else None)
            block = render_status(state, metrics)
            if once:
                print(block, file=out, flush=True)
                return 0
            # clear + repaint (plain ANSI home; scrollback stays sane
            # on dumb terminals because the block is short)
            print("\x1b[2J\x1b[H" + block, file=out, flush=True)
            if state.end is not None:
                return 0
            time.sleep(max(0.2, interval))
    except KeyboardInterrupt:
        return 0
