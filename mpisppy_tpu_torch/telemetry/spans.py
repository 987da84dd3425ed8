###############################################################################
# Causal span assembly (port of mpisppy_tpu/telemetry/spans.py).
#
# `telemetry trace <trace_id>` turns the per-replica / per-session /
# fleet JSONL segments back into ONE causal tree per trace.  The model
# is deliberately record-free: a span is the set of rows carrying its
# span_id, its extent the [min, max] wall clock of those rows, its name
# and attributes the `span-start` row that opened it.  No close record
# exists, so a torn tail (a replica killed mid-write) shortens a span's
# extent but can never corrupt the tree — and every row self-describes
# its span's parent (the bus stamps trace_id/span_id/parent_span_id
# together), so parentage survives files being read in any order.
#
# Zero-orphan is the structural invariant the chaos tests pin: on a
# clean run — including a live migration and a mesh reshard — every
# parent_span_id referenced by any span resolves to a span that has
# rows of its own.  An orphan means a propagation hop dropped the
# context (the bug class this plane exists to catch).
#
# CRITICAL PATH: client-observed latency is attributed by partitioning
# the [first-row, last-row] wall timeline at every event and charging
# each inter-event gap to the bucket of the event that CLOSES it
# (queue-wait / admission / iter0 / hub-sync / exchange-overlap /
# dispatch-queue / solve / migration-gap / step-shift).  Because the
# buckets partition the timeline, they sum to the client-observed
# latency by construction (the acceptance criterion's 5% headroom
# covers only wall-vs-monotonic clock skew).
#
# Pure stdlib on purpose: this module is imported by regress.py, which
# tools (graftlint, CI gates) load standalone by path on machines
# without a card.
###############################################################################
from __future__ import annotations

import json
import os

#: the machine-report schema tag (graftlint schema-drift pins the key
#: set below against docs/telemetry.md)
TRACE_SCHEMA = "mpisppy-tpu-trace/1"

#: the critical-path buckets, in render order (docs/telemetry.md)
BUCKETS = ("queue-wait", "admission", "iter0", "hub-sync",
           "exchange-overlap", "dispatch-queue", "solve",
           "migration-gap", "step-shift")


# -- row loading (torn-tail safe) -------------------------------------------
def iter_rows(path: str):
    """Yield parsed JSONL rows; a torn/garbage line (the killed-replica
    tail) is skipped, never raised."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict):
                yield row


def load_rows(path: str) -> list[dict]:
    """All rows from a JSONL file, or from every *.jsonl under a
    directory tree (a fleet trace dir holds one subdir per replica plus
    the router stream) — each row annotated with its source file."""
    files: list[str] = []
    if os.path.isdir(path):
        for dirpath, _dirs, names in os.walk(path):
            for name in sorted(names):
                if name.endswith(".jsonl"):
                    files.append(os.path.join(dirpath, name))
    else:
        files.append(path)
    rows: list[dict] = []
    for fp in sorted(files):
        rel = os.path.relpath(fp, path) if os.path.isdir(path) else fp
        for row in iter_rows(fp):
            row["_file"] = rel
            rows.append(row)
    return rows


def trace_ids(rows: list[dict]) -> list[str]:
    """Distinct trace ids in first-appearance order."""
    seen: dict[str, None] = {}
    for r in rows:
        tid = r.get("trace_id")
        if tid and tid not in seen:
            seen[tid] = None
    return list(seen)


def resolve_trace_id(rows: list[dict], prefix: str | None) -> str:
    """Match a full id or unique prefix; None/'' picks the only trace
    present (or raises listing the candidates)."""
    ids = trace_ids(rows)
    if not ids:
        raise ValueError("no trace-stamped rows found")
    if not prefix or prefix == "last":
        if prefix != "last" and len(ids) > 1:
            raise ValueError(
                "multiple traces present; pass one of: "
                + ", ".join(i[:12] for i in ids))
        return ids[-1] if prefix == "last" else ids[0]
    hits = [i for i in ids if i.startswith(prefix)]
    if len(hits) != 1:
        raise ValueError(
            f"trace id {prefix!r} matches {len(hits)} of: "
            + ", ".join(i[:12] for i in ids))
    return hits[0]


# -- span-tree assembly ------------------------------------------------------
def assemble(rows: list[dict], trace_id: str) -> dict:
    """One causal span tree for `trace_id` (the machine report,
    schema TRACE_SCHEMA).  Spans carry extent, row/kind accounting,
    the files their rows landed in, and the span-start attributes;
    `orphans` lists spans whose parent has no rows of its own."""
    mine = [r for r in rows if r.get("trace_id") == trace_id]
    if not mine:
        raise ValueError(f"no rows for trace {trace_id!r}")
    mine.sort(key=lambda r: (r.get("t_wall") or 0.0, r.get("seq") or 0))
    spans: dict[str, dict] = {}
    for r in mine:
        sid = r.get("span_id") or ""
        if not sid:
            continue
        sp = spans.get(sid)
        if sp is None:
            sp = spans[sid] = {
                "span_id": sid, "parent_span_id": "", "name": "",
                "t_start": r["t_wall"], "t_end": r["t_wall"],
                "events": 0, "kinds": {}, "files": [], "attrs": {},
            }
        sp["t_start"] = min(sp["t_start"], r["t_wall"])
        sp["t_end"] = max(sp["t_end"], r["t_wall"])
        sp["events"] += 1
        kind = r.get("kind", "?")
        sp["kinds"][kind] = sp["kinds"].get(kind, 0) + 1
        f = r.get("_file")
        if f and f not in sp["files"]:
            sp["files"].append(f)
        parent = r.get("parent_span_id") or ""
        if parent and not sp["parent_span_id"]:
            sp["parent_span_id"] = parent
        if kind == "span-start" and not sp["name"]:
            data = r.get("data") or {}
            sp["name"] = str(data.get("name") or "")
            sp["attrs"] = {k: v for k, v in data.items()
                           if k != "name" and v is not None}
    # rows stamped with a span we never saw a span-start for still name
    # it by its dominant kind — e.g. the request root is named by its
    # own span-start, but a bare hub trace roots at an anonymous span
    for sp in spans.values():
        if not sp["name"]:
            top = max(sp["kinds"].items(), key=lambda kv: kv[1])[0]
            sp["name"] = f"({top})"
    orphans = sorted(
        sp["span_id"] for sp in spans.values()
        if sp["parent_span_id"] and sp["parent_span_id"] not in spans)
    roots = sorted(
        (sp for sp in spans.values()
         if not sp["parent_span_id"]
         or sp["parent_span_id"] not in spans),
        key=lambda sp: sp["t_start"])
    children: dict[str, list] = {}
    for sp in spans.values():
        if sp["parent_span_id"] in spans:
            children.setdefault(sp["parent_span_id"], []).append(sp)
    for kids in children.values():
        kids.sort(key=lambda sp: sp["t_start"])
    # a request that never moved has ONE segment span; every extra
    # segment is a resume after a preemption/migration hand-off
    n_segments = sum(1 for sp in spans.values()
                     if sp["name"] in ("segment", "mesh-segment"))
    migrated = n_segments - 1
    cp = critical_path(mine)
    span_rows = []

    def _emit(sp, depth):
        span_rows.append(dict(sp, depth=depth,
                              duration_s=round(
                                  sp["t_end"] - sp["t_start"], 6)))
        for kid in children.get(sp["span_id"], []):
            _emit(kid, depth + 1)

    for root in roots:
        _emit(root, 0)
    return {
        "schema": TRACE_SCHEMA,
        "trace_id": trace_id,
        "spans": span_rows,
        "orphans": orphans,
        "critical_path": cp,
        "migrated_segments": max(0, migrated),
        "files": sorted({f for sp in spans.values()
                         for f in sp["files"]}),
        "events": len(mine),
    }


# -- critical path -----------------------------------------------------------
def _bucket_of(row: dict, st: dict) -> str:
    """The bucket charged for the gap THIS row closes.  `st` is the
    walker's state (admitted / segment-open / first-sync-seen /
    draining), mutated here as the row is consumed."""
    kind = row.get("kind")
    data = row.get("data") or {}
    if kind == "session-state":
        state = data.get("state")
        if state == "ADMITTED":
            st["admitted"] = True
            return "queue-wait"
        if state == "RUNNING":
            st["admitted"] = True
            return ("migration-gap" if data.get("prev") == "DEGRADED"
                    else "admission")
        if state == "DEGRADED":
            st["draining"] = True
            return "solve" if st.get("in_seg") else "migration-gap"
        return "solve" if st.get("in_seg") else "admission"
    if kind == "span-start":
        name = data.get("name")
        if name in ("segment", "mesh-segment"):
            b = ("migration-gap" if st.get("draining")
                 else "admission" if st.get("admitted")
                 else "queue-wait")
            st.update(in_seg=True, seg_synced=False, draining=False)
            return b
        if name in ("migration", "reshard"):
            st.update(in_seg=False, draining=True)
            return "migration-gap"
        if name == "mpc-step":
            # the shift/checkpoint wall between window k's last event
            # and window k+1's open
            return "step-shift" if st.get("seg_synced") else "iter0"
        if name in ("request", "mesh-run"):
            return "queue-wait"
        return "solve" if st.get("in_seg") else "admission"
    if kind == "hub-iteration":
        if not st.get("seg_synced"):
            st["seg_synced"] = True
            return "iter0"
        return "hub-sync"
    if kind == "exchange-overlap":
        return "exchange-overlap"
    if kind in ("dispatch", "dispatch-retry"):
        return "dispatch-queue"
    if kind in ("session-migrated", "mesh-reshard", "mesh-host-lost",
                "checkpoint-restore"):
        st.update(in_seg=False, draining=True)
        return "migration-gap"
    if kind == "mpc-step":
        st["seg_synced"] = True
        return "solve"
    if kind == "run-start":
        return "iter0"
    # anything else: compute time inside a segment, queue time before
    # admission, drain time while migrating
    if st.get("in_seg"):
        return "solve"
    if st.get("draining"):
        return "migration-gap"
    return "solve" if st.get("admitted") else "queue-wait"


def critical_path(rows: list[dict]) -> dict:
    """Partition the trace's wall timeline into the BUCKETS; the sums
    equal last-row minus first-row wall clock exactly.  When the trace
    carries an slo-observation row, its client-observed total_s is
    reported alongside with the coverage ratio (the 5% acceptance
    line)."""
    rows = sorted(rows,
                  key=lambda r: (r.get("t_wall") or 0.0,
                                 r.get("seq") or 0))
    buckets = {b: 0.0 for b in BUCKETS}
    st: dict = {}
    prev_t = rows[0]["t_wall"] if rows else 0.0
    client_total = None
    for row in rows:
        t = row.get("t_wall")
        if t is None:
            continue
        dt = max(0.0, t - prev_t)
        buckets[_bucket_of(row, st)] += dt
        prev_t = t
        if row.get("kind") == "slo-observation":
            tot = (row.get("data") or {}).get("total_s")
            if tot is not None:
                client_total = float(tot)
    total = sum(buckets.values())
    out = {
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "total_s": round(total, 6),
        "client_total_s": client_total,
    }
    if client_total:
        out["coverage"] = round(total / client_total, 4)
    return out


# -- entry points ------------------------------------------------------------
def assemble_path(path: str, trace: str | None = None) -> dict:
    """Load a JSONL file or trace directory and assemble one trace
    (`trace` is a full id, unique prefix, 'last', or None when only
    one trace is present)."""
    rows = load_rows(path)
    return assemble(rows, resolve_trace_id(rows, trace))


def render_trace(rep: dict) -> str:
    """The human rendering of an assemble() report."""
    lines = [f"trace {rep['trace_id']}  "
             f"({rep['events']} events, "
             f"{len(rep['files'])} file(s), "
             f"{rep['migrated_segments']} migrated segment(s))"]
    t0 = min((sp["t_start"] for sp in rep["spans"]), default=0.0)
    for sp in rep["spans"]:
        pad = "  " * sp["depth"]
        attrs = ""
        keep = {k: v for k, v in sp["attrs"].items()
                if k in ("session", "tenant", "sla", "replica", "step",
                         "epoch", "devices", "from_replica",
                         "resume_iter", "restore")}
        if keep:
            attrs = "  " + " ".join(f"{k}={v}"
                                    for k, v in sorted(keep.items()))
        lines.append(
            f"{pad}{sp['name']:<14s} "
            f"+{sp['t_start'] - t0:8.3f}s "
            f"{sp['duration_s']:8.3f}s "
            f"{sp['events']:4d} ev{attrs}")
    if rep["orphans"]:
        lines.append(f"ORPHAN SPANS: {len(rep['orphans'])} "
                     f"({', '.join(o[:8] for o in rep['orphans'])})")
    cp = rep["critical_path"]
    lines.append("critical path:")
    total = cp["total_s"] or 1.0
    for b in BUCKETS:
        v = cp["buckets"].get(b, 0.0)
        if v <= 0.0:
            continue
        lines.append(f"  {b:<18s} {v:8.3f}s  {100.0 * v / total:5.1f}%")
    tail = f"  {'total':<18s} {cp['total_s']:8.3f}s"
    if cp.get("client_total_s") is not None:
        tail += (f"  (client observed {cp['client_total_s']:.3f}s, "
                 f"coverage {cp.get('coverage', 0.0):.2%})")
    lines.append(tail)
    return "\n".join(lines)
