###############################################################################
# Perf-regression compare/gate (port of mpisppy_tpu/telemetry/regress.py;
# the gates, milestones and report schema are the JAX package's, and
# _device_metrics reads the port's device report keys).
#
# `compare` diffs the perf metrics of two artifacts; `gate` applies
# direction-aware thresholds and fails (exit 2 from the CLI) on a
# regression — the mechanical guard the ROADMAP north star needs so
# sec/iter, backend-compile, and time-to-certified-gap regressions are
# caught by CI instead of by eyeballing BENCH_*.json diffs.
#
# Accepted artifact forms (auto-detected per file):
#   * an analyzer report (telemetry/analyze.py --json output;
#     schema mpisppy-tpu-analyze/1), including its `device` section;
#   * a device roofline report (telemetry/roofline.py; schema
#     mpisppy-tpu-deviceprof/1) — stream/achieved GB/s, overlap_frac,
#     MFU and device_sec_per_iter gate direction-aware;
#   * a BENCH_DETAIL.json-style dict (bench.py output: *_to_1pct_gap
#     sections, wheel_overhead, measured_mfu, sweep_iters_per_sec,
#     embedded metrics_snapshot / dispatch stats);
#   * a BENCH_r0N.json run wrapper whose `tail` holds the (possibly
#     front-TRUNCATED) bench stdout: named sections are salvaged by
#     balanced-brace extraction, so the committed r04/r05 fixtures gate
#     on their recoverable overlap instead of failing to parse.
#
# Metrics are flattened to dotted keys; GATES maps key patterns to
# (direction, relative threshold).  Only keys present in BOTH artifacts
# are gated — a metric that disappeared is reported, not failed (bench
# sections legitimately come and go across rounds).
###############################################################################
from __future__ import annotations

import json
import re

ANALYZE_SCHEMA_PREFIX = "mpisppy-tpu-analyze/"
DEVPROF_SCHEMA_PREFIX = "mpisppy-tpu-deviceprof/"

#: (key regex, direction, relative threshold).  direction "up" = larger
#: is worse, "down" = smaller is worse.  First match wins; keys that
#: match nothing are compared but never gated.
GATES: tuple[tuple[str, str, float], ...] = (
    (r"(^|\.)sec_per_iter", "up", 0.10),
    (r"(^|\.)seconds_to_gap$", "up", 0.15),
    (r"(^|\.)time_to_gap\.", "up", 0.15),
    (r"(^|\.)iters_per_sec$", "down", 0.10),
    (r"(^|\.)overhead_factor$", "up", 0.15),
    (r"backend_compiles", "up", 0.10),
    (r"unexpected_recompiles", "up", 0.0),
    (r"guard_resets", "up", 0.0),
    (r"(^|\.)final_rel_gap$", "up", 0.25),
    # dispatch fault domain: on the committed bench fixtures
    # any retry growth or quarantined lane is a regression — the bench
    # workloads are fault-free by construction, so these counters only
    # move when the dispatch layer itself started failing
    (r"(retries_total|dispatch_retries)$", "up", 0.0),
    (r"quarantined_lanes", "up", 0.0),
    (r"quarantined_requests", "up", 0.0),
    (r"(watchdog_trips|dispatcher_deaths)", "up", 0.0),
    # device-trace roofline metrics (telemetry/roofline.py):
    # bandwidth, DMA/compute overlap and MFU falling is a regression;
    # device time per iteration rising is one.  Together with the
    # MILESTONES below these guard the JAX package's wins (bf16x3
    # iteration precision, Pallas double-buffer).
    (r"measured_stream_gbps", "down", 0.10),
    (r"achieved_hbm_gbps", "down", 0.10),
    (r"hbm_roofline_frac", "down", 0.10),
    (r"overlap_frac", "down", 0.10),
    (r"(^|\.)mfu$", "down", 0.10),
    (r"device_sec_per_iter", "up", 0.10),
    (r"dma\.exposed_s$", "up", 0.25),
    # multi-tenant serve layer (BENCH serve_load phase):
    # client-observed latency under load and the tenant-isolation
    # ratio regressing is a serving regression (docs/serving.md)
    (r"serve_load\..*time_to_gap_p(50|99)_s$", "up", 0.25),
    (r"(^|\.)isolation_ratio$", "up", 0.25),
    # IR-level kernel facts (KERNEL_IR.json, docs/
    # static_analysis.md "IR layer"): bytes of concrete array
    # constants baked into a kernel's jaxpr may NEVER grow (any growth
    # is a new baked value — the per-value recompile-leak class), and
    # the compiled temp-byte high-water per kernel ratchets at +10%
    # (a materialized S-major temporary in a VirtualBatch-fed kernel
    # multiplies it)
    (r"kernels\..*\.const_bytes$", "up", 0.0),
    (r"kernels\..*\.temp_bytes$", "up", 0.10),
    # replicated serve fleet (BENCH fleet_serve_load phase):
    # a migration that loses its session is ALWAYS a regression — the
    # counter must stay 0 (any increase fails).  Latency/isolation on
    # the fleet phase ride the serve_load\..* and isolation_ratio
    # patterns above unchanged (the phase is named fleet_serve_load,
    # and the gates' searches are unanchored).
    (r"migrations_lost", "up", 0.0),
    # elastic mesh (BENCH mesh_chaos phase): a re-shard that
    # loses its run is ALWAYS a regression — the counter stays 0.
    # watchdog_trips rides the any-increase gate above unchanged.
    (r"mesh_reshards_lost", "up", 0.0),
    # rolling-horizon MPC streams (BENCH mpc_stream phase):
    # client-observed per-step latency on the committed uc / ccopf
    # horizons regressing past 25% is a serving regression — the warm
    # path's whole point is the per-window latency class (docs/mpc.md)
    (r"mpc_stream\..*step_latency_p(50|99)_s$", "up", 0.25),
    # SLO plane (telemetry/slo.py): committed artifacts carry
    # per-class `slo` sections (burn_rate = violating fraction over the
    # error budget).  Budget consumption growing past 25% relative is a
    # serving regression even while still inside the budget; the
    # absolute <= 1.0 ceiling lives in MILESTONES below.
    (r"slo\..*\.burn_rate$", "up", 0.25),
    (r"slo\..*\.budget_remaining$", "down", 0.25),
)

#: absolute slack added on top of the relative threshold, so integer
#: counters (compiles, guard resets) tolerate tiny absolute wiggle
ABS_SLACK = {"backend_compiles": 2.0, "guard_resets": 2.0,
             "unexpected_recompiles": 0.0}

#: Absolute MILESTONE bounds:
#: (key regex, direction, bound).  direction "up": the value must stay
#: <= bound; "down": >= bound.  Unlike the relative GATES these are
#: floors/ceilings on the NEW artifact, with RATCHET semantics: a
#: milestone only BINDS once the old artifact already meets it (the
#: win has landed on hardware) — before that it is reported "pending",
#: so pre-win fixture pairs keep gating green while a landed win can
#: never silently regress past its acceptance line.  `gate(...,
#: milestones=True)` / CLI --milestones forces every milestone to bind
#: regardless (the strict mode CI runs on post-win artifacts).
MILESTONES: tuple[tuple[str, str, float], ...] = (
    # bf16x3 on the S=10k PH iteration: 0.0601 s/iter measured at full
    # precision (BENCH_r05 / BENCH_DETAIL measured_mfu.S10000)
    (r"measured_mfu\.S10000\.sec_per_iter$", "up", 0.045),
    # double-buffered Pallas window at S=100k: 1.46 iters/s measured
    # with the single-buffer kernel (sweep entries key by scenario
    # count — extract_metrics rewrites list indices to S<count>)
    (r"sweep_iters_per_sec\.S100000\.iters_per_sec$", "down", 2.0),
    # async wheel (ROADMAP item 4): wheel overhead over bare
    # PH at staleness 1 must reach <= 1.3x (2.41x measured synchronous,
    # BENCH_DETAIL wheel_overhead).  Ratchet: pending until witnessed
    # on hardware, binding forever after.
    (r"wheel_overhead_async\.overhead_factor$", "up", 1.3),
    # multi-tenant serve: healthy-tenant p99
    # time-to-gap under one adversarial tenant within 25% of the
    # no-adversary baseline — the tenant-isolation line the serve_load
    # bench phase measures (docs/serving.md)
    (r"serve_load\.isolation\.isolation_ratio$", "up", 1.25),
    # seeded scenario synthesis (docs/scengen.md):
    # recompute-instead-of-store must cost <= 10% PH throughput at the
    # max common scale both paths hold resident...
    (r"wheel_scengen\.synth_vs_materialized_ratio$", "down", 0.9),
    # ...and the S=1M synthesized sweep entry must EXIST (bound 0 is a
    # presence ratchet: any measured throughput meets it, but dropping
    # the S=1M phase — the "as many scenarios as you can imagine"
    # witness — fails as MISSING once an artifact has carried it)
    (r"wheel_scengen\.sweep\.S1000000\.iters_per_sec$", "down", 0.0),
    # wheel fleet: every session a replica death forced to migrate must
    # still certify to the SAME gap target as the fault-free run —
    # the migrated-reached-gap fraction is 1.0 or the live-migration
    # story is fiction
    (r"fleet_serve_load\.migration\.migrated_reached_gap_frac$",
     "down", 1.0),
    # elastic mesh (docs/resilience.md): a run
    # that survives a mid-wheel host loss must re-shard across the
    # survivors and STILL certify the same gap target as the
    # fault-free baseline — anything under 1.0 means a reshard lost
    # certified progress
    (r"mesh_chaos\..*reshard_reached_gap_frac$", "down", 1.0),
    # rolling-horizon MPC (docs/mpc.md): mean
    # warm step latency pooled over the committed uc + ccopf --soc
    # horizons must stay <= 0.6x the matching cold re-solves — below
    # that the receding-horizon product is just repeated cold solves
    # (the phase's per-model detail records each horizon's own ratio)
    (r"mpc_stream\.warm_over_cold_ratio$", "up", 0.6),
    # ...and a stream preempted mid-flight must resume and reproduce
    # the fault-free stream's per-step bounds exactly (bit-identical
    # window data + the checkpointed shifted plane): the matched
    # fraction is 1.0 or the resume story is fiction
    (r"mpc_stream\..*resumed_matched_frac$", "down", 1.0),
    # SLO plane: a
    # committed artifact's per-class burn rate must never exceed 1.0 —
    # an exhausted error budget IS the violated SLO, regardless of how
    # gently it got there (the relative gate above catches the drift)
    (r"slo\..*\.burn_rate$", "up", 1.0),
)


# ---------------------------------------------------------------------------
# artifact loading + metric extraction
# ---------------------------------------------------------------------------
def _salvage_tail(tail: str) -> dict:
    """Recover named JSON sections from a (front-truncated) bench
    stdout tail: for every `"name": {` seen, try a balanced-brace parse;
    also pick up top-level scalars like `"bench_total_sec": 1012.3`.
    Sections cut off by the truncation simply don't parse and are
    skipped — salvage is best-effort by design."""
    out: dict = {}
    spans: list[tuple[int, int]] = []  # captured section extents
    for mt in re.finditer(r'"(\w+)":\s*(\{|\[)', tail):
        if any(a <= mt.start() < b for a, b in spans):
            continue  # nested inside an already-salvaged section
        name = mt.group(1)
        depth, i = 0, mt.end(2) - 1
        in_str = esc = False
        for i in range(mt.end(2) - 1, len(tail)):
            ch = tail[i]
            if in_str:
                if esc:
                    esc = False
                elif ch == "\\":
                    esc = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
            elif ch in "{[":
                depth += 1
            elif ch in "}]":
                depth -= 1
                if depth == 0:
                    break
        if depth != 0:
            continue
        try:
            val = json.loads(tail[mt.end(2) - 1:i + 1])
        except ValueError:
            continue
        if name not in out:
            out[name] = val
            spans.append((mt.start(), i + 1))
    # top-level scalars: whitelist only — a bare regex would hoist
    # NESTED scalars ("seconds_to_gap": ... inside whichever section
    # survived the truncation) to top level and diff unrelated sections
    # against each other
    for key in ("bench_total_sec",):
        ms = re.search(rf'"{key}":\s*(-?\d+(?:\.\d+)?)', tail)
        if ms and key not in out:
            out[key] = float(ms.group(1))
    return out


def load_artifact(path: str) -> dict:
    """Load + normalize one artifact file into a bench-style dict (or
    an analyzer report, passed through).  Run wrappers carry the
    bench stdout in `tail` (salvaged); assembled wrappers (e.g. the
    committed BENCH_r06.json, built from prior on-TPU captures in a
    round whose container had no chip) carry the sections directly in
    `parsed`."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, dict) and isinstance(obj.get("parsed"), dict):
        return obj["parsed"]
    if isinstance(obj, dict) and isinstance(obj.get("tail"), str) \
            and "cmd" in obj:
        return _salvage_tail(obj["tail"])
    return obj


def _flatten(prefix: str, obj, out: dict) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(obj, list):
        # bench lists key by scenario count when the entries carry one
        # (the sweep) — "sweep_iters_per_sec.S100000.iters_per_sec"
        # stays comparable across rounds even when the sweep grid
        # changes, and is what MILESTONES anchors on; other lists keep
        # stable positional keys
        for i, v in enumerate(obj):
            key = i
            if isinstance(v, dict) \
                    and isinstance(v.get("scenarios"), (int, float)) \
                    and not isinstance(v.get("scenarios"), bool):
                key = f"S{int(v['scenarios'])}"
            _flatten(f"{prefix}.{key}", v, out)
    elif isinstance(obj, bool):
        pass
    elif isinstance(obj, (int, float)):
        out[prefix] = float(obj)


def _device_metrics(dev: dict, out: dict, prefix: str = "device"):
    """Gate-relevant keys of a roofline report (telemetry/roofline.py),
    shared by standalone device reports and analyzer rep['device']."""
    for k in ("device_sec_per_iter", "measured_stream_gbps",
              "achieved_hbm_gbps", "hbm_roofline_frac", "mfu",
              "overlap_frac", "opaque_frac", "busy_share"):
        if isinstance(dev.get(k), (int, float)) \
                and not isinstance(dev.get(k), bool):
            out[f"{prefix}.{k}"] = float(dev[k])
    dma = dev.get("dma") or {}
    for k in ("exposed_s", "inflight_s"):
        if isinstance(dma.get(k), (int, float)):
            out[f"{prefix}.dma.{k}"] = float(dma[k])
    med = (dev.get("steps") or {}).get("sec_per_iter_median")
    if isinstance(med, (int, float)):
        out[f"{prefix}.steps.sec_per_iter_median"] = float(med)


def extract_metrics(obj: dict) -> dict[str, float]:
    """Flatten an artifact into {dotted_key: number}.  Analyzer reports
    keep only the gate-relevant sections (timings, bounds, dispatch,
    guard totals) so two reports of different runs stay comparable."""
    out: dict[str, float] = {}
    schema = obj.get("schema", "") if isinstance(obj, dict) else ""
    if isinstance(schema, str) and schema.startswith(
            DEVPROF_SCHEMA_PREFIX):
        _device_metrics(obj, out, prefix="device")
        return out
    if isinstance(schema, str) and schema.startswith(
            ANALYZE_SCHEMA_PREFIX):
        _flatten("iteration", obj.get("iteration") or {}, out)
        b = obj.get("bounds") or {}
        for k in ("final_rel_gap", "min_rel_gap"):
            if isinstance(b.get(k), (int, float)):
                out[f"bounds.{k}"] = float(b[k])
        for tgt, hit in (b.get("time_to_gap") or {}).items():
            if isinstance(hit, dict) and hit.get("seconds") is not None:
                out[f"time_to_gap.{tgt}"] = float(hit["seconds"])
        disp = dict(obj.get("dispatch") or {})
        # per-coalesce-key rows are labeled with a per-process digest
        # (dispatch/scheduler._key_label) — never comparable across
        # runs, so they inform the audit but not the gate
        disp.pop("by_key", None)
        _flatten("dispatch", disp, out)
        res = obj.get("resilience") or {}
        for k in ("dispatch_retries", "dispatch_quarantined_lanes",
                  "dispatch_quarantined_requests", "watchdog_trips",
                  "dispatcher_deaths", "lane_quarantine_resets"):
            if isinstance(res.get(k), (int, float)) \
                    and not isinstance(res.get(k), bool):
                out[f"resilience.{k}"] = float(res[k])
        for cyl, k in (obj.get("kernel") or {}).items():
            if isinstance(k, dict) \
                    and k.get("pdhg_guard_resets_total") is not None:
                out[f"kernel.{cyl}.guard_resets"] = float(
                    k["pdhg_guard_resets_total"])
        if isinstance(obj.get("device"), dict):
            _device_metrics(obj["device"], out, prefix="device")
        out.pop("iteration.count", None)
        return out
    _flatten("", obj, out)
    # noise keys that vary run to run without meaning anything (by_key
    # rows carry a per-process coalesce-key digest in their name)
    drop = re.compile(r"(t_wall|timestamp|seed|\.n$|\.rc$|\.by_key\.)")
    return {k: v for k, v in out.items() if not drop.search(k)}


# ---------------------------------------------------------------------------
# compare + gate
# ---------------------------------------------------------------------------
def _gate_for(key: str):
    for pat, direction, thr in GATES:
        if re.search(pat, key):
            return direction, thr
    return None, None


def compare(old: dict, new: dict,
            _metrics: tuple[dict, dict] | None = None) -> dict:
    """Diff two artifacts.  Returns rows for common keys plus the
    appeared/disappeared key lists.  `_metrics` lets gate() pass
    already-extracted metric maps so each artifact is flattened once
    per invocation."""
    mo, mn = _metrics or (extract_metrics(old), extract_metrics(new))
    rows = []
    for k in sorted(set(mo) & set(mn)):
        a, b = mo[k], mn[k]
        delta = b - a
        rel = delta / abs(a) if a else (0.0 if not delta else float("inf"))
        direction, thr = _gate_for(k)
        regressed = False
        if direction is not None:
            slack = next((s for pat, s in ABS_SLACK.items()
                          if pat in k), 0.0)
            worse = delta if direction == "up" else -delta
            regressed = worse > thr * abs(a) + slack
        rows.append({"metric": k, "old": a, "new": b,
                     "delta": delta, "rel": rel,
                     "gated": direction is not None,
                     "direction": direction, "threshold": thr,
                     "regressed": regressed})
    return {
        "schema": "mpisppy-tpu-regress/1",
        "rows": rows,
        "common": len(rows),
        "appeared": sorted(set(mn) - set(mo)),
        "disappeared": sorted(set(mo) - set(mn)),
        "regressions": [r for r in rows if r["regressed"]],
        "ok": not any(r["regressed"] for r in rows),
    }


def _meets(value: float, direction: str, bound: float) -> bool:
    return value <= bound if direction == "up" else value >= bound


def _milestone_rows(mo: dict, mn: dict, strict: bool) -> list[dict]:
    """Evaluate MILESTONES over the new artifact's metrics (ratchet
    semantics — see the table's comment).

    A milestone key ABSENT from the new artifact is itself a failure
    whenever the bound would have bound: dropping the phase from the
    bench (or renaming the key) must not become a silent regression
    path.  Ratchet mode fails a landed key that disappeared; strict
    mode additionally fails a pattern with no match anywhere (strict
    is the post-win bench CI mode — an artifact without the milestone
    phases has no business passing it)."""
    rows = []
    for pat, direction, bound in MILESTONES:
        matched_new = False
        for k in sorted(mn):
            if not re.search(pat, k):
                continue
            matched_new = True
            new, old = mn[k], mo.get(k)
            landed = old is not None and _meets(old, direction, bound)
            binding = strict or landed
            met = _meets(new, direction, bound)
            rows.append({
                "metric": k, "milestone": bound,
                "direction": direction, "old": old, "new": new,
                "binding": binding,
                "regressed": binding and not met,
                "status": ("met" if met
                           else ("REGRESSED" if binding else "pending")),
            })
        if matched_new:
            continue
        old_hits = [k for k in sorted(mo) if re.search(pat, k)]
        landed_old = [k for k in old_hits
                      if _meets(mo[k], direction, bound)]
        if strict or landed_old:
            # readable stand-in when neither artifact carries the key
            # (a raw regex is not a metric name)
            fallback = pat.replace("\\.", ".").rstrip("$")
            for k in (landed_old or old_hits or [fallback]):
                rows.append({
                    "metric": k, "milestone": bound,
                    "direction": direction,
                    "old": mo.get(k), "new": None,
                    "binding": True, "regressed": True,
                    "status": "MISSING"})
    return rows


def gate(old: dict, new: dict,
         overrides: dict[str, float] | None = None,
         milestones: bool = False) -> dict:
    """compare() with per-call threshold overrides ({key substring:
    relative threshold}) plus the MILESTONE floors/ceilings.  `ok` is
    the pass/fail verdict; the CLI maps it to the exit code.
    `milestones=True` makes every milestone bind even when the old
    artifact predates the win (strict mode)."""
    mo, mn = extract_metrics(old), extract_metrics(new)
    rep = compare(old, new, _metrics=(mo, mn))
    if overrides:
        for r in rep["rows"]:
            for sub, thr in overrides.items():
                if sub in r["metric"]:
                    direction = r["direction"] or "up"
                    a, delta = r["old"], r["delta"]
                    worse = delta if direction == "up" else -delta
                    r["gated"] = True
                    r["direction"] = direction
                    r["threshold"] = thr
                    r["regressed"] = worse > thr * abs(a)
        rep["regressions"] = [r for r in rep["rows"] if r["regressed"]]
        rep["ok"] = not rep["regressions"]
    ms = _milestone_rows(mo, mn, milestones)
    rep["milestones"] = ms
    failed_ms = [r for r in ms if r["regressed"]]
    if failed_ms:
        # fold milestone failures into `regressions` in the compare-row
        # schema (consumers iterate one list), deduped against metrics
        # the relative gates already failed
        already = {r["metric"] for r in rep["regressions"]}
        for r in failed_ms:
            if r["metric"] in already:
                continue
            delta = (None if r["old"] is None or r["new"] is None
                     else r["new"] - r["old"])
            rel = (delta / abs(r["old"])
                   if delta is not None and r["old"] else None)
            rep["regressions"].append({
                "metric": r["metric"], "old": r["old"], "new": r["new"],
                "delta": delta, "rel": rel, "gated": True,
                "direction": r["direction"],
                "threshold": r["milestone"], "regressed": True,
                "milestone": r["milestone"], "status": r["status"]})
        rep["ok"] = False
    if not rep["rows"]:
        # two artifacts with NO overlapping metrics cannot certify
        # anything — fail loudly rather than green-light a vacuous diff
        rep["ok"] = False
        rep["error"] = "no common metrics between the two artifacts"
    return rep


def compare_paths(old_path: str, new_path: str) -> dict:
    return compare(load_artifact(old_path), load_artifact(new_path))


def gate_paths(old_path: str, new_path: str,
               overrides: dict[str, float] | None = None,
               milestones: bool = False) -> dict:
    return gate(load_artifact(old_path), load_artifact(new_path),
                overrides, milestones=milestones)


def render_compare(rep: dict, only_gated: bool = False) -> str:
    L = []
    for r in rep["rows"]:
        if only_gated and not r["gated"]:
            continue
        mark = "REGRESSED" if r["regressed"] else (
            "gated" if r["gated"] else "")
        L.append(f"{r['metric']:<52} {r['old']:>12.6g} -> "
                 f"{r['new']:>12.6g}  ({r['rel']:+7.2%})  {mark}".rstrip())
    for r in rep.get("milestones") or []:
        cmp_c = "<=" if r["direction"] == "up" else ">="
        shown = "absent" if r["new"] is None else format(r["new"], ".6g")
        L.append(f"milestone {r['metric']:<42} {shown:>12} "
                 f"{cmp_c} {r['milestone']:g}  [{r['status']}]")
    if rep["disappeared"]:
        L.append(f"disappeared: {', '.join(rep['disappeared'][:8])}"
                 + (" ..." if len(rep["disappeared"]) > 8 else ""))
    if rep["appeared"]:
        L.append(f"appeared: {', '.join(rep['appeared'][:8])}"
                 + (" ..." if len(rep["appeared"]) > 8 else ""))
    if rep.get("error"):
        L.append(f"ERROR: {rep['error']}")
    verdict = "PASS" if rep["ok"] else \
        f"FAIL ({len(rep['regressions'])} regression(s))"
    L.append(f"{rep['common']} common metrics; gate: {verdict}")
    return "\n".join(L)
