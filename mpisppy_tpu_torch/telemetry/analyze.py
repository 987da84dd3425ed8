###############################################################################
# Trace analyzer (port of mpisppy_tpu/telemetry/analyze.py; the report
# keys, the schema and the text are the JAX package's).
#
# Consumes the JSONL event stream the wheel emits (--trace-jsonl, or a
# flight-recorder dump) and answers the first questions of every run of
# a hub-and-spoke wheel (Knueven et al., MPC 2023): where did the wall
# time go, which spoke produced the binding bounds, is the gap moving
# or stalled, and is the dispatch tunnel healthy?
#
#   rows  = load_trace("trace.jsonl")
#   model = build_run_model(rows)           # typed run -> iters -> events
#   rep   = analyze(model)                  # the machine report (JSON)
#   text  = render_report(rep)              # the human report
#
# Pure stdlib on purpose: a host without a card or JAX (a laptop holding
# a trace copied off a GPU host) can run `python -m mpisppy_tpu_torch.telemetry
# analyze` on any trace or black box.  Joins are exact: events carry
# run ids, hub_iter stamps, and the
# per-bus seq total order; no seq-window heuristics.
###############################################################################
from __future__ import annotations

import dataclasses
import json
import math

from mpisppy_tpu_torch.telemetry import events as ev
from mpisppy_tpu_torch.telemetry import flightrec

ANALYZE_SCHEMA = "mpisppy-tpu-analyze/1"

#: rel-gap thresholds the time-to-gap table reports (the 1% target is
#: the BENCH_METHODOLOGY headline)
GAP_TARGETS = (0.05, 0.02, 0.01)


def load_trace(path: str) -> list[dict]:
    """Parse a JSONL trace (or flight dump) into row dicts.  A torn
    final line — the signature of a crashed writer — is skipped, not
    fatal: a crash trace must stay analyzable by construction."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows


def join_segments(rows: list[dict],
                  run: str | None = None) -> tuple[list, list]:
    """Join a trace DIRECTORY's rows into ONE session's stream.  A
    fleet-migrated session leaves one segment file per replica it ran
    on (same sid under each replica's subdir) — the segments join on
    the CAUSAL TRACE ID every row carries, with the (run, session)
    heuristic only as the fallback for pre-trace rows.
    Returns (rows of the chosen session sorted by wall clock, the
    segment files they came from); `run` selects a session, default is
    the newest."""
    groups: dict = {}
    order: list = []
    for r in rows:
        key = r.get("trace_id")
        if not key:
            sid = (r.get("data") or {}).get("session")
            key = (r.get("run"), sid) if sid else r.get("_file")
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(r)
    if not groups:
        raise ValueError("no rows in the trace directory")
    if run:
        target = next((k for k in order
                       if any(g.get("run") == run for g in groups[k])),
                      None)
        if target is None:
            raise ValueError(f"run {run!r} not in the trace directory")
    else:
        target = max(order, key=lambda k: max(
            (g.get("t_wall") or 0.0) for g in groups[k]))
    segs = sorted(groups[target],
                  key=lambda r: (r.get("t_wall") or 0.0,
                                 r.get("seq") or 0))
    files: list = []
    for r in segs:
        f = r.get("_file")
        if f and f not in files:
            files.append(f)
    return segs, files


def runs_in(rows: list[dict]) -> list[str]:
    """Distinct run ids in stream order (a restarted run appends a new
    segment to the same file; ids delimit the segments)."""
    seen: list[str] = []
    for r in rows:
        run = r.get("run")
        if run and run not in seen:
            seen.append(run)
    return seen


@dataclasses.dataclass
class HubIter:
    """One hub iteration joined from its events."""

    it: int
    t_wall: float | None = None
    t_mono: float | None = None
    data: dict = dataclasses.field(default_factory=dict)
    harvests: list = dataclasses.field(default_factory=list)
    accepts: list = dataclasses.field(default_factory=list)
    rejects: list = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunModel:
    """Typed model of one run: run -> hub iterations -> joined events,
    plus the cross-iteration streams (dispatch, faults, checkpoints)."""

    run: str
    rows: list = dataclasses.field(default_factory=list)
    header: dict | None = None        # flight-recorder dump header
    start: dict | None = None         # run-start row
    end: dict | None = None           # run-end row
    iters: dict = dataclasses.field(default_factory=dict)  # it -> HubIter
    spans: list = dataclasses.field(default_factory=list)
    strikes: list = dataclasses.field(default_factory=list)
    disables: list = dataclasses.field(default_factory=list)
    evicts: list = dataclasses.field(default_factory=list)
    quarantines: list = dataclasses.field(default_factory=list)
    faults: list = dataclasses.field(default_factory=list)
    ckpt_writes: list = dataclasses.field(default_factory=list)
    ckpt_restores: list = dataclasses.field(default_factory=list)
    megabatches: list = dataclasses.field(default_factory=list)
    dispatch_stats: list = dataclasses.field(default_factory=list)
    dispatch_retries: list = dataclasses.field(default_factory=list)
    dispatch_quarantines: list = dataclasses.field(default_factory=list)
    watchdogs: list = dataclasses.field(default_factory=list)
    kernel: dict = dataclasses.field(default_factory=dict)  # cyl -> last
    spoke_classes: dict = dataclasses.field(default_factory=dict)
    profiles: list = dataclasses.field(default_factory=list)  # profile evs
    plane_writes: list = dataclasses.field(default_factory=list)
    overlaps: list = dataclasses.field(default_factory=list)  # async rows
    placements: list = dataclasses.field(default_factory=list)  # fleet
    migrations: list = dataclasses.field(default_factory=list)  # fleet
    mesh_states: list = dataclasses.field(default_factory=list)  # elastic
    mesh_losses: list = dataclasses.field(default_factory=list)  # elastic
    mesh_reshards: list = dataclasses.field(default_factory=list)
    mesh_stragglers: list = dataclasses.field(default_factory=list)
    mpc_steps: list = dataclasses.field(default_factory=list)  # stream
    mpc_degrades: list = dataclasses.field(default_factory=list)

    def iter_of(self, it: int) -> HubIter:
        if it not in self.iters:
            self.iters[it] = HubIter(it)
        return self.iters[it]

    @property
    def t0_mono(self) -> float | None:
        monos = [r["t_mono"] for r in self.rows if "t_mono" in r]
        return min(monos) if monos else None

    @property
    def t1_mono(self) -> float | None:
        monos = [r["t_mono"] for r in self.rows if "t_mono" in r]
        return max(monos) if monos else None


def build_run_model(rows: list[dict], run: str | None = None) -> RunModel:
    """Join one run's events into a RunModel.  `run=None` picks the
    LAST run id in the stream — with segment-appending traces (a
    preempted run restarted onto the same --trace-jsonl path) the
    newest segment is the one being diagnosed."""
    runs = runs_in(rows)
    if run is None:
        if not runs:
            raise ValueError("no run ids in the trace "
                             "(empty or console-only stream)")
        run = runs[-1]
    elif run not in runs:
        raise ValueError(f"run {run!r} not in trace (have: {runs})")
    m = RunModel(run=run)
    for r in rows:
        if r.get("kind") == flightrec.HEADER_KIND:
            if r.get("run") in (run, "unknown"):
                m.header = r
            continue
        if r.get("run") != run:
            # a scheduler configured before the hub minted its run id
            # emits dispatch rows with run="" — keep them (single-wheel
            # processes; the hub adopts the scheduler afterwards).  A
            # MIXED cross-session megabatch (serve layer) carries the
            # scheduler's run with a per-session breakdown: keep the
            # row when this run rode in it, joined by its own token —
            # no seq heuristics
            if r.get("kind") != ev.DISPATCH:
                continue
            sessions = (r.get("data") or {}).get("sessions") or []
            mine = [s for s in sessions if s.get("run") == run]
            if r.get("run") and not mine:
                continue
            if mine:
                # join at THIS session's iteration (its own token),
                # not the foreign top-level stamp
                r = dict(r)
                r["iter"] = mine[0].get("iter", r.get("iter"))
        m.rows.append(r)
        kind, data, it = r.get("kind"), r.get("data", {}), r.get("iter")
        if kind == ev.RUN_START:
            m.start = r
        elif kind == ev.RUN_END:
            m.end = r
        elif kind == ev.HUB_ITERATION:
            hi = m.iter_of(data.get("iter", it))
            hi.t_wall, hi.t_mono = r.get("t_wall"), r.get("t_mono")
            hi.data = data
        elif kind == ev.SPOKE_HARVEST:
            m.iter_of(it).harvests.append(data)
            if "spoke" in data and "spoke_class" in data:
                m.spoke_classes[data["spoke"]] = data["spoke_class"]
        elif kind == ev.BOUND_ACCEPT:
            m.iter_of(it).accepts.append(data)
        elif kind == ev.BOUND_REJECT:
            m.iter_of(it).rejects.append(data)
        elif kind == ev.SPAN:
            m.spans.append({"iter": it, **data})
            if it is not None:
                spans = m.iter_of(it).spans
                name = data.get("name", "?")
                spans[name] = spans.get(name, 0.0) + data.get("dur_s", 0.0)
        elif kind == ev.SPOKE_STRIKE:
            m.strikes.append({"iter": it, **data})
        elif kind == ev.SPOKE_DISABLE:
            m.disables.append({"iter": it, **data})
        elif kind == ev.BOUND_EVICT:
            m.evicts.append({"iter": it, **data})
        elif kind == ev.LANE_QUARANTINE:
            m.quarantines.append({"iter": it, **data})
        elif kind == ev.FAULT_INJECTED:
            m.faults.append({"iter": it, **data})
        elif kind == ev.CHECKPOINT_WRITE:
            m.ckpt_writes.append({"iter": it, **data})
        elif kind == ev.CHECKPOINT_RESTORE:
            m.ckpt_restores.append({"iter": it, **data})
        elif kind == ev.DISPATCH:
            # two producers share the kind (docs/telemetry.md): the
            # scheduler's per-megabatch row (cyl "dispatch") and the
            # hub's cumulative per-sync stats row (cyl "hub")
            if r.get("cyl") == "dispatch":
                m.megabatches.append({"iter": it, **data})
            else:
                m.dispatch_stats.append({"iter": it, **data})
        elif kind == ev.DISPATCH_RETRY:
            m.dispatch_retries.append({"iter": it, **data})
        elif kind == ev.DISPATCH_QUARANTINE:
            m.dispatch_quarantines.append({"iter": it, **data})
        elif kind == ev.WATCHDOG:
            m.watchdogs.append({"iter": it, **data})
        elif kind == ev.KERNEL_COUNTERS:
            m.kernel["hub" if r.get("cyl") in (None, "", "hub")
                     else r["cyl"]] = data
        elif kind == ev.PLANE_WRITE:
            m.plane_writes.append({"iter": it, **data})
        elif kind == ev.EXCHANGE_OVERLAP:
            m.overlaps.append({"iter": it, **data})
        elif kind == ev.PROFILE:
            m.profiles.append({"iter": it, **data})
        elif kind == ev.FLEET_PLACEMENT:
            m.placements.append({"iter": it, **data})
        elif kind == ev.SESSION_MIGRATED:
            m.migrations.append({"iter": it, **data})
        elif kind == ev.MESH_STATE:
            m.mesh_states.append({"iter": it, **data})
        elif kind == ev.MESH_HOST_LOST:
            m.mesh_losses.append({"iter": it, **data})
        elif kind == ev.MESH_RESHARD:
            m.mesh_reshards.append({"iter": it, **data})
        elif kind == ev.MESH_STRAGGLER:
            m.mesh_stragglers.append({"iter": it, **data})
        elif kind == ev.MPC_STEP:
            m.mpc_steps.append({"iter": it, **data})
        elif kind == ev.MPC_DEGRADED:
            m.mpc_degrades.append({"iter": it, **data})
    return m


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------
def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def _phase_breakdown(model: RunModel) -> dict:
    agg: dict[str, dict] = {}
    for s in model.spans:
        a = agg.setdefault(s.get("name", "?"),
                           {"calls": 0, "total_s": 0.0, "max_s": 0.0})
        d = float(s.get("dur_s") or 0.0)
        a["calls"] += 1
        a["total_s"] += d
        a["max_s"] = max(a["max_s"], d)
    grand = sum(a["total_s"] for a in agg.values()) or 1.0
    for a in agg.values():
        a["mean_s"] = a["total_s"] / max(1, a["calls"])
        a["share"] = a["total_s"] / grand
        for k in ("total_s", "mean_s", "max_s", "share"):
            a[k] = round(a[k], 6)
    return dict(sorted(agg.items(), key=lambda kv: -kv[1]["total_s"]))


def _iteration_stats(model: RunModel) -> dict:
    hs = sorted((h for h in model.iters.values() if h.t_mono is not None),
                key=lambda h: h.it)
    deltas = [b.t_mono - a.t_mono for a, b in zip(hs, hs[1:])
              if b.it == a.it + 1]
    steady = deltas[2:] if len(deltas) > 4 else deltas
    out = {"count": len(hs),
           "wall_s": (round(hs[-1].t_mono - hs[0].t_mono, 6)
                      if len(hs) > 1 else 0.0),
           "sec_per_iter_median": None, "sec_per_iter_p90": None}
    if steady:
        out["sec_per_iter_median"] = round(_median(steady), 6)
        out["sec_per_iter_p90"] = round(
            sorted(steady)[min(len(steady) - 1,
                               int(0.9 * len(steady)))], 6)
    return out


def _bound_progress(model: RunModel) -> dict:
    hs = sorted(model.iters.values(), key=lambda h: h.it)
    traj = [(h.it, _finite(h.data.get("outer")),
             _finite(h.data.get("inner")), _finite(h.data.get("rel_gap")))
            for h in hs if h.data]
    last_move = {"outer": None, "inner": None}
    prev = {"outer": None, "inner": None}
    for it, ob, ib, _ in traj:
        for side, v in (("outer", ob), ("inner", ib)):
            if v is not None and v != prev[side]:
                last_move[side] = it
                prev[side] = v
    last_iter = traj[-1][0] if traj else 0
    gaps = [(it, g) for it, _, _, g in traj if g is not None]
    t0 = model.t0_mono
    time_to_gap = {}
    for target in GAP_TARGETS:
        hit = next((h for h in hs
                    if _finite(h.data.get("rel_gap")) is not None
                    and h.data["rel_gap"] <= target), None)
        time_to_gap[f"{target:g}"] = None if hit is None else {
            "iter": hit.it,
            "seconds": (round(hit.t_mono - t0, 6)
                        if hit.t_mono is not None and t0 is not None
                        else None)}
    return {
        "final_outer": prev["outer"],
        "final_inner": prev["inner"],
        "final_rel_gap": gaps[-1][1] if gaps else None,
        "min_rel_gap": min((g for _, g in gaps), default=None),
        "first_rel_gap": gaps[0][1] if gaps else None,
        "iters_since_outer_moved": (None if last_move["outer"] is None
                                    else last_iter - last_move["outer"]),
        "iters_since_inner_moved": (None if last_move["inner"] is None
                                    else last_iter - last_move["inner"]),
        "time_to_gap": time_to_gap,
        "gap_trajectory_tail": [[it, g] for it, g in gaps[-8:]],
    }


def _spoke_attribution(model: RunModel) -> dict:
    spokes: dict = {}

    def rec(j):
        return spokes.setdefault(j, {
            "class": model.spoke_classes.get(j),
            "harvests": 0, "accepts": 0, "binding_accepts": 0,
            "rejects": 0, "strikes": 0, "disabled": False,
            "senses": [], "last_bound": None})

    for hi in model.iters.values():
        for h in hi.harvests:
            r = rec(h.get("spoke"))
            r["harvests"] += 1
            if h.get("sense") not in r["senses"]:
                r["senses"].append(h.get("sense"))
        for a in hi.accepts:
            r = rec(a.get("spoke"))
            r["accepts"] += 1
            r["last_bound"] = a.get("bound")
            if a.get("improved"):
                r["binding_accepts"] += 1
        for x in hi.rejects:
            rec(x.get("spoke"))["rejects"] += 1
    for s in model.strikes:
        rec(s.get("spoke"))["strikes"] = max(
            rec(s.get("spoke"))["strikes"], s.get("strikes", 0))
    for d in model.disables:
        rec(d.get("spoke"))["disabled"] = True
    # who holds the final incumbent of each side: the LAST improving
    # accept per sense in the stream
    binding = {}
    for hi in sorted(model.iters.values(), key=lambda h: h.it):
        for a in hi.accepts:
            if a.get("improved"):
                binding[a.get("sense")] = {
                    "spoke": a.get("spoke"),
                    "class": model.spoke_classes.get(a.get("spoke")),
                    "bound": a.get("bound"), "iter": hi.it}
    return {"spokes": {str(k): v for k, v in sorted(spokes.items())},
            "final_bound_producer": binding}


def _dispatch_audit(model: RunModel) -> dict | None:
    if not model.megabatches and not model.dispatch_stats:
        return None
    out: dict = {}
    mbs = model.megabatches
    if mbs:
        lanes = sum(b.get("lanes", 0) for b in mbs)
        padded = sum(b.get("padded_to", 0) for b in mbs)
        out.update({
            "megabatches": len(mbs),
            "lanes": lanes,
            "occupancy_mean": round(lanes / padded, 4) if padded else None,
            "wait_ms_med": round(_median(
                [b.get("wait_ms", 0.0) for b in mbs]), 3),
            "wait_ms_max": round(max(b.get("wait_ms", 0.0)
                                     for b in mbs), 3),
            "queue_depth_max": max(b.get("queue_depth", 0) for b in mbs),
            "coalesced": sum(1 for b in mbs if b.get("requests", 1) > 1),
            "pre_wheel": sum(1 for b in mbs if (b.get("iter") or 0) < 0),
        })
        # occupancy attribution by dispatch cause:
        # a timer-heavy mix means windows expire before filling — the
        # occupancy loss is admission-deadline driven, not size driven
        by_cause: dict[str, dict] = {}
        for b in mbs:
            c = b.get("cause")
            if c is None:
                continue
            a = by_cause.setdefault(c, {"batches": 0, "lanes": 0,
                                        "padded": 0})
            a["batches"] += 1
            a["lanes"] += b.get("lanes", 0)
            a["padded"] += b.get("padded_to", 0)
        for a in by_cause.values():
            a["occupancy"] = (round(a["lanes"] / a["padded"], 4)
                              if a["padded"] else None)
        if by_cause:
            out["by_cause"] = by_cause
    if model.dispatch_stats:
        last = model.dispatch_stats[-1]
        out.update({
            "batches_total": last.get("batches"),
            "buckets": last.get("buckets"),
            "backend_compiles": last.get("backend_compiles"),
            "unexpected_recompiles": last.get("unexpected_recompiles"),
            "inflight_max": last.get("inflight_max"),
            "retries_total": last.get("retries_total"),
            "quarantined_lanes": last.get("quarantined_lanes"),
            "degraded": last.get("degraded"),
        })
        # compile-cache discipline: in steady state each shape bucket
        # compiles once; more compiles than buckets means the ladder is
        # leaking (docs/dispatch.md)
        b, c = last.get("buckets"), last.get("backend_compiles")
        if b and c is not None:
            out["compiles_per_bucket"] = round(c / b, 3)
        # per-coalesce-key occupancy: which
        # mergeable identities shared megabatches, across how many
        # sessions — megabatch sharing across tenants made attributable
        if last.get("by_key"):
            out["by_key"] = last["by_key"]
    return out


def _resilience_summary(model: RunModel) -> dict:
    by_seam: dict[str, int] = {}
    for f in model.faults:
        by_seam[f.get("seam", "?")] = by_seam.get(f.get("seam", "?"), 0) + 1
    return {
        "faults_injected": by_seam,
        "spoke_strikes": len(model.strikes),
        "spokes_disabled": len({d.get("spoke") for d in model.disables}),
        "bound_evictions": len(model.evicts),
        "lane_quarantine_resets": sum(q.get("resets", 0)
                                      for q in model.quarantines),
        "checkpoint_writes": len(model.ckpt_writes),
        "checkpoint_restores": len(model.ckpt_restores),
        "restore_fallbacks": sum(1 for c in model.ckpt_restores
                                 if c.get("fallback")),
        # dispatch fault domain (docs/dispatch.md)
        "dispatch_retries": len(model.dispatch_retries),
        "dispatch_quarantined_lanes": sum(
            q.get("lanes", 0) for q in model.dispatch_quarantines),
        "dispatch_quarantined_requests": len(model.dispatch_quarantines),
        "watchdog_trips": sum(1 for w in model.watchdogs
                              if w.get("action") in ("abort", "degrade")),
        "dispatcher_deaths": sum(1 for w in model.watchdogs
                                 if w.get("component") == "dispatcher"),
    }


def _fleet_summary(model: RunModel) -> dict | None:
    """Fleet rows for a session's run: where it was placed,
    how it moved.  None for non-fleet runs (no fleet events rode the
    trace)."""
    if not model.placements and not model.migrations:
        return None
    chain: list = []
    for p in model.placements:
        rep = p.get("replica")
        if rep and (not chain or chain[-1] != rep):
            chain.append(rep)
    policies: dict[str, int] = {}
    for p in model.placements:
        pol = p.get("policy", "?")
        policies[pol] = policies.get(pol, 0) + 1
    return {
        "placements": len(model.placements),
        "policies": policies,
        "replica_chain": chain,
        "migrations": len(model.migrations),
        "migrated_at_iters": [mg.get("iter") for mg in model.migrations
                              if mg.get("iter") is not None],
    }


def _mesh_summary(model: RunModel) -> dict | None:
    """Elastic-mesh rows: membership churn, host losses,
    reshards, and harvest degradations.  None when no mesh fault-domain
    events rode the trace (every pre-elastic run)."""
    if not (model.mesh_states or model.mesh_losses
            or model.mesh_reshards or model.mesh_stragglers):
        return None
    return {
        "transitions": len(model.mesh_states),
        "final_epoch": max(
            [int(s.get("epoch", 0)) for s in model.mesh_states],
            default=0),
        "hosts_lost": sorted({loss.get("host")
                              for loss in model.mesh_losses
                              if loss.get("host") is not None}),
        "reshards": [{"hub_iter": rs.get("hub_iter"),
                      "old_devices": rs.get("old_devices"),
                      "new_devices": rs.get("new_devices")}
                     for rs in model.mesh_reshards],
        "stragglers": sum(1 for s in model.mesh_stragglers
                          if s.get("mode") == "deadline"),
        "torn_harvests": sum(1 for s in model.mesh_stragglers
                             if s.get("mode") == "torn"),
    }


def _mpc_summary(model: RunModel) -> dict | None:
    """Rolling-horizon stream rows: one mpc-step event per
    solved window (docs/mpc.md), plus mpc-degraded for windows that
    missed the gap target warm AND cold.  None when the run is not an
    MPC stream."""
    if not model.mpc_steps and not model.mpc_degrades:
        return None
    lat = [s.get("latency_s") for s in model.mpc_steps
           if isinstance(s.get("latency_s"), (int, float))]
    gaps = [s.get("rel_gap") for s in model.mpc_steps
            if isinstance(s.get("rel_gap"), (int, float))]
    return {
        "steps": len(model.mpc_steps),
        "last_step": max([s.get("step") for s in model.mpc_steps
                          if s.get("step") is not None], default=None),
        "warm": sum(1 for s in model.mpc_steps if s.get("warm")),
        "cold_fallbacks": sum(1 for s in model.mpc_steps
                              if s.get("cold_fallback")),
        "degraded": sum(1 for s in model.mpc_steps if s.get("degraded")),
        "step_latency_p50_s": (round(_median(lat), 6) if lat else None),
        "step_latency_max_s": (round(max(lat), 6) if lat else None),
        "last_rel_gap": gaps[-1] if gaps else None,
        "degraded_at_steps": [d.get("step") for d in model.mpc_degrades
                              if d.get("step") is not None],
    }


def _async_wheel(model: RunModel) -> dict | None:
    """Plane-staleness + host/device overlap attribution for an async
    wheel run: how stale the exchange plane actually ran,
    how the per-sync host wall split between the issue and complete
    halves, and what fraction of the host exchange was absorbed on the
    stale side of the pipeline."""
    if not model.plane_writes and not model.overlaps:
        return None
    out: dict = {"plane_writes": len(model.plane_writes)}
    stal = [w.get("staleness") for w in model.plane_writes
            if isinstance(w.get("staleness"), (int, float))]
    if stal:
        out["staleness_mean"] = round(sum(stal) / len(stal), 3)
        out["staleness_max"] = max(stal)
    if model.overlaps:
        issue = [o.get("issue_s", 0.0) or 0.0 for o in model.overlaps]
        comp = [o.get("complete_s", 0.0) or 0.0 for o in model.overlaps]
        thetas = [o.get("theta") for o in model.overlaps
                  if isinstance(o.get("theta"), (int, float))]
        total = sum(issue) + sum(comp)
        out.update({
            "syncs": len(model.overlaps),
            "issue_s_total": round(sum(issue), 6),
            "complete_s_total": round(sum(comp), 6),
            "complete_s_med": round(_median(comp), 6),
            # share of the host exchange running on the stale side —
            # host work overlapping the in-flight device step
            "overlapped_host_frac": (round(sum(comp) / total, 4)
                                     if total > 0 else None),
        })
        if thetas:
            out["theta_last"] = thetas[-1]
            out["theta_min"] = min(thetas)
    return out


def _exit_info(model: RunModel) -> dict:
    if model.end is not None:
        d = dict(model.end.get("data", {}))
        d.setdefault("reason", "unknown")
        return d
    if model.header is not None:
        return {"reason": "truncated",
                "flight_reason": model.header.get("reason")}
    return {"reason": "truncated"}


def analyze(model: RunModel) -> dict:
    """The machine report: one JSON-able dict per run."""
    it_stats = _iteration_stats(model)
    bounds = _bound_progress(model)
    exit_info = _exit_info(model)
    # run-end carries the truly-final bounds (finalize's last harvest
    # can improve on the last hub-iteration row); prefer them
    for k in ("outer", "inner", "rel_gap"):
        v = _finite(exit_info.get(k))
        if v is not None:
            bounds[f"final_{k}"] = v
    rep = {
        "schema": ANALYZE_SCHEMA,
        "run": {
            "id": model.run,
            "hub_class": (model.start or {}).get("data", {})
            .get("hub_class"),
            "num_spokes": (model.start or {}).get("data", {})
            .get("num_spokes"),
            "events": len(model.rows),
            "exit": exit_info,
        },
        "iteration": it_stats,
        "phases": _phase_breakdown(model),
        "bounds": bounds,
        "attribution": _spoke_attribution(model),
        "dispatch": _dispatch_audit(model),
        "resilience": _resilience_summary(model),
        "kernel": model.kernel,
        "async_wheel": _async_wheel(model),
        "fleet": _fleet_summary(model),
        "mesh": _mesh_summary(model),
        "mpc": _mpc_summary(model),
    }
    flags = []
    stall = bounds.get("iters_since_outer_moved")
    n = max(1, it_stats["count"])
    if stall is not None and stall >= max(5, n // 2):
        flags.append(f"outer bound stalled for {stall} iterations")
    stall_i = bounds.get("iters_since_inner_moved")
    if stall_i is not None and stall_i >= max(5, n // 2):
        flags.append(f"inner bound stalled for {stall_i} iterations")
    if exit_info.get("reason") == "truncated":
        flags.append("stream truncated: no run-end event "
                     "(crash, kill, or tracing stopped mid-run)")
    disp = rep["dispatch"]
    if disp and (disp.get("unexpected_recompiles") or 0) > 0:
        flags.append(f"{disp['unexpected_recompiles']} unexpected "
                     "warm-bucket recompile(s)")
    if rep["resilience"]["spokes_disabled"]:
        flags.append(f"{rep['resilience']['spokes_disabled']} spoke(s) "
                     "auto-disabled")
    if rep["resilience"]["bound_evictions"]:
        flags.append(f"{rep['resilience']['bound_evictions']} incumbent "
                     "bound eviction(s)")
    if rep["resilience"]["dispatch_quarantined_lanes"]:
        flags.append(
            f"{rep['resilience']['dispatch_quarantined_lanes']} dispatch "
            f"lane(s) quarantined "
            f"({rep['resilience']['dispatch_quarantined_requests']} "
            "request(s) resolved SolveFailed)")
    if rep["resilience"]["watchdog_trips"]:
        flags.append(f"watchdog tripped "
                     f"{rep['resilience']['watchdog_trips']} time(s)")
    if rep["resilience"]["dispatcher_deaths"]:
        flags.append(f"{rep['resilience']['dispatcher_deaths']} "
                     "dispatcher-thread death(s) (tickets failed fast)")
    rep["flags"] = flags
    return rep


def profiled_window(model: RunModel) -> dict | None:
    """The hub-iteration window a ProfilerSession captured, from its
    profile events (start / stop-with-capture), plus the profile dir —
    the join between the host-span timeline and the device trace."""
    if not model.profiles:
        return None
    out: dict = {"profile_dir": None, "start_iter": None,
                 "stop_iter": None, "captured": False}
    for p in model.profiles:
        if p.get("profile_dir"):
            out["profile_dir"] = p["profile_dir"]
        if p.get("action") == "start":
            out["start_iter"] = p.get("iter")
        elif p.get("action") in ("stop", "captured"):
            # a close()-time capture (wheel finalized early) carries
            # iter=None — keep the last known boundary instead
            if p.get("iter") is not None:
                out["stop_iter"] = p["iter"]
        if p.get("action") == "captured" or p.get("trace_dir"):
            out["captured"] = True
            out["capture_dir"] = p.get("trace_dir")
    return out


def attach_device(rep: dict, profile_dir: str) -> dict:
    """Join a device-trace roofline report (telemetry/roofline.py) onto
    an analyzer report under rep['device'].  Parse problems become a
    flag, not a crash — a host report must survive a torn capture."""
    from mpisppy_tpu_torch.telemetry import roofline
    try:
        dev = roofline.roofline_path(profile_dir)
    except (OSError, ValueError) as e:
        rep.setdefault("flags", []).append(
            f"device trace unreadable under {profile_dir!r}: {e}")
        return rep
    rep["device"] = dev
    host_spi = (rep.get("iteration") or {}).get("sec_per_iter_median")
    dev_spi = dev.get("device_sec_per_iter")
    if host_spi and dev_spi:
        # host sec/iter covers dispatch + python; the gap to device
        # time is the wheel's host-side overhead during the profiled
        # window
        rep["device"]["host_device_ratio"] = round(host_spi / dev_spi, 3)
    return rep


def analyze_path(path: str, run: str | None = None,
                 profile_dir: str | None = None) -> dict:
    """Analyze a JSONL trace; `profile_dir` (or a profile event in the
    trace pointing at a directory that exists here) joins the device
    section on.  `path` may be a trace DIRECTORY (the serve layer's
    per-session / per-replica layout): the newest session's segments
    are joined across files on their trace id, so a migrated session
    analyzes as ONE run instead of losing its pre-migration segment."""
    import os
    seg_files: list = []
    if os.path.isdir(path):
        from mpisppy_tpu_torch.telemetry import spans as _spans
        rows, seg_files = join_segments(_spans.load_rows(path), run=run)
    else:
        rows = load_trace(path)
    model = build_run_model(rows, run=run)
    rep = analyze(model)
    if seg_files:
        rep["run"]["segment_files"] = seg_files
        rep["run"]["migrated_segments"] = max(0, len(seg_files) - 1)
    window = profiled_window(model)
    if window:
        rep["profiled_window"] = window
    if profile_dir is None and window and window.get("captured"):
        # auto-discovery trusts only a VERIFIED capture advertisement
        # (action "captured"): a bare profile_dir may hold a STALE
        # capture from an earlier run whose device numbers would be
        # silently joined to this one.  Prefer the exact capture dir
        # the event recorded over "newest under the root".
        import os
        for cand in (window.get("capture_dir"),
                     window.get("profile_dir")):
            if cand and os.path.isdir(cand):
                profile_dir = cand
                break
    if profile_dir:
        attach_device(rep, profile_dir)
    return rep


# ---------------------------------------------------------------------------
# the human rendering
# ---------------------------------------------------------------------------
def _fmt(v, spec=".6g"):
    return "-" if v is None else format(v, spec)


def render_report(rep: dict) -> str:
    L: list[str] = []
    r, ex = rep["run"], rep["run"]["exit"]
    L.append(f"run {r['id']}  hub={r.get('hub_class') or '?'}  "
             f"spokes={r.get('num_spokes', '?')}  events={r['events']}"
             + (f"  migrated segments {r['migrated_segments']} "
                f"({' + '.join(r.get('segment_files') or [])})"
                if r.get("migrated_segments") else ""))
    L.append(f"exit: {ex.get('reason')}"
             + (f"  rel_gap={_fmt(ex.get('rel_gap'), '.3e')}"
                if ex.get("rel_gap") is not None else "")
             + (f"  ({ex.get('flight_reason')})"
                if ex.get("flight_reason") else ""))
    it = rep["iteration"]
    L.append(f"iterations: {it['count']}  wall {_fmt(it['wall_s'], '.3f')}s"
             f"  sec/iter median {_fmt(it['sec_per_iter_median'], '.4g')}"
             f"  p90 {_fmt(it['sec_per_iter_p90'], '.4g')}")
    if rep["phases"]:
        L.append("phases (host wall):")
        for name, a in rep["phases"].items():
            L.append(f"  {name:<18} {a['total_s']:9.3f}s"
                     f"  {100 * a['share']:5.1f}%"
                     f"  x{a['calls']}  mean {a['mean_s']:.4g}s")
    b = rep["bounds"]
    L.append(f"bounds: outer {_fmt(b['final_outer'])}  "
             f"inner {_fmt(b['final_inner'])}  "
             f"rel_gap {_fmt(b['final_rel_gap'], '.3e')} "
             f"(min {_fmt(b['min_rel_gap'], '.3e')})")
    L.append(f"  stall: outer moved {_fmt(b['iters_since_outer_moved'])} "
             f"iters ago, inner {_fmt(b['iters_since_inner_moved'])}")
    for tgt, hit in b["time_to_gap"].items():
        if hit is not None:
            L.append(f"  gap<={tgt}: iter {hit['iter']}"
                     f" @ {_fmt(hit['seconds'], '.3f')}s")
    at = rep["attribution"]
    for sense, w in at["final_bound_producer"].items():
        L.append(f"  binding {sense}: spoke {w['spoke']}"
                 f" ({w.get('class') or '?'}) = {_fmt(w['bound'])}"
                 f" at iter {w['iter']}")
    if at["spokes"]:
        L.append("spokes:")
        for j, s in at["spokes"].items():
            L.append(f"  [{j}] {s.get('class') or '?':<28}"
                     f" harvests {s['harvests']:4d}  accepts"
                     f" {s['accepts']:4d} ({s['binding_accepts']} binding)"
                     f"  rejects {s['rejects']}  strikes {s['strikes']}"
                     + ("  DISABLED" if s["disabled"] else ""))
    d = rep["dispatch"]
    if d:
        L.append("dispatch:"
                 + (f" megabatches {d.get('megabatches')}"
                    f"  lanes {d.get('lanes')}"
                    f"  occupancy {_fmt(d.get('occupancy_mean'))}"
                    f"  wait_ms med {_fmt(d.get('wait_ms_med'))}"
                    f"/max {_fmt(d.get('wait_ms_max'))}"
                    if d.get("megabatches") else "")
                 + (f"  buckets {d.get('buckets')}"
                    f"  compiles {d.get('backend_compiles')}"
                    f" ({_fmt(d.get('compiles_per_bucket'))}/bucket)"
                    f"  unexpected {d.get('unexpected_recompiles')}"
                    if d.get("buckets") is not None else ""))
    aw = rep.get("async_wheel")
    if aw:
        L.append(f"async wheel: plane writes {aw.get('plane_writes')}"
                 f"  staleness mean {_fmt(aw.get('staleness_mean'))}"
                 f"/max {_fmt(aw.get('staleness_max'))}"
                 + (f"  host-complete {_fmt(aw.get('complete_s_total'), '.3f')}s"
                    f" ({_fmt(aw.get('overlapped_host_frac'))}"
                    f" of exchange wall on the stale side)"
                    if aw.get("syncs") else "")
                 + (f"  theta last {_fmt(aw.get('theta_last'), '.3g')}"
                    f"/min {_fmt(aw.get('theta_min'), '.3g')}"
                    if aw.get("theta_last") is not None else ""))
    fl = rep.get("fleet")
    if fl:
        L.append(f"fleet: placements {fl['placements']} "
                 f"{fl['policies']}  migrations {fl['migrations']}"
                 + (f"  path {'>'.join(fl['replica_chain'])}"
                    if fl["replica_chain"] else "")
                 + (f"  at iters {fl['migrated_at_iters']}"
                    if fl["migrated_at_iters"] else ""))
    msh = rep.get("mesh")
    if msh:
        L.append(f"mesh: epoch {msh['final_epoch']}  "
                 f"hosts lost {msh['hosts_lost'] or '[]'}  "
                 f"reshards {len(msh['reshards'])}"
                 + ("".join(f"  [{r['old_devices']}->"
                            f"{r['new_devices']}dev@iter"
                            f"{r['hub_iter']}]"
                            for r in msh["reshards"]))
                 + (f"  stragglers {msh['stragglers']}"
                    if msh["stragglers"] else "")
                 + (f"  torn harvests {msh['torn_harvests']}"
                    if msh["torn_harvests"] else ""))
    mpc = rep.get("mpc")
    if mpc:
        L.append(f"mpc stream: steps {mpc['steps']}"
                 f" (last {_fmt(mpc['last_step'], 'd')})"
                 f"  warm {mpc['warm']}"
                 f"  cold fallbacks {mpc['cold_fallbacks']}"
                 f"  degraded {mpc['degraded']}"
                 f"  step p50 {_fmt(mpc['step_latency_p50_s'], '.3g')}s"
                 f"/max {_fmt(mpc['step_latency_max_s'], '.3g')}s"
                 + (f"  last rel_gap {_fmt(mpc['last_rel_gap'], '.3e')}"
                    if mpc["last_rel_gap"] is not None else "")
                 + (f"  degraded at {mpc['degraded_at_steps']}"
                    if mpc["degraded_at_steps"] else ""))
    res = rep["resilience"]
    if any(v for v in res.values()):
        L.append(f"resilience: faults {res['faults_injected'] or '{}'}  "
                 f"strikes {res['spoke_strikes']}  "
                 f"disabled {res['spokes_disabled']}  "
                 f"evictions {res['bound_evictions']}  "
                 f"quarantine resets {res['lane_quarantine_resets']}  "
                 f"ckpt writes/restores {res['checkpoint_writes']}"
                 f"/{res['checkpoint_restores']}")
        if res.get("dispatch_retries") or res.get(
                "dispatch_quarantined_lanes") or res.get(
                "watchdog_trips") or res.get("dispatcher_deaths"):
            L.append(f"  dispatch fault domain: retries "
                     f"{res['dispatch_retries']}  quarantined lanes "
                     f"{res['dispatch_quarantined_lanes']} "
                     f"({res['dispatch_quarantined_requests']} requests)"
                     f"  watchdog trips {res['watchdog_trips']}"
                     f"  dispatcher deaths {res['dispatcher_deaths']}")
    for cyl, k in rep["kernel"].items():
        tot = k.get("pdhg_iterations_total")
        if tot is not None:
            L.append(f"kernel[{cyl}]: pdhg iters {tot}  restarts "
                     f"{k.get('pdhg_restarts_total')}  guard resets "
                     f"{k.get('pdhg_guard_resets_total')}")
    if rep.get("device"):
        from mpisppy_tpu_torch.telemetry import roofline
        L.append("device (trace-derived; docs/telemetry.md):")
        w = rep.get("profiled_window") or {}
        if w.get("start_iter") is not None:
            L.append(f"  profiled hub iters [{w.get('start_iter')}, "
                     f"{w.get('stop_iter')})")
        L.extend("  " + ln
                 for ln in roofline.render_device(rep["device"])
                 .splitlines())
        ratio = rep["device"].get("host_device_ratio")
        if ratio is not None:
            L.append(f"  host/device sec-per-iter ratio {ratio}")
    if rep["flags"]:
        L.append("flags:")
        L.extend(f"  ! {f}" for f in rep["flags"])
    return "\n".join(L)
