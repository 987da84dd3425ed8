###############################################################################
# Declarative SLOs + error budgets (port of mpisppy_tpu/telemetry/slo.py).
#
# One SLOSpec per serve class and per MPC stream product:
#
#   latency     time-to-1%-gap p99 within target_s, and at most
#               `budget` of sessions missing their per-session target;
#   throughput  certified-within-deadline rate >= 1 - budget;
#   mpc         per-step deadline miss (degraded-window) rate <= budget.
#
# Evaluation folds either `slo-observation` rows (the terminal sample
# Session.settle stamps on every request's root span) or a committed
# BENCH artifact's parsed sections into the same row shape:
#
#   bad_frac          the violating fraction of samples
#   burn_rate         bad_frac / budget   (1.0 = the budget is exactly
#                     spent; > 1.0 = the SLO is violated)
#   budget_remaining  max(0, 1 - burn_rate)
#
# burn_rate is THE scalar the machinery binds on: `telemetry slo`
# renders it, watch shows it live, metrics.py exports it as the
# slo_burn_rate gauge, and regress.py gates any committed
# `*.slo.*.burn_rate` key (relative growth AND the absolute <= 1.0
# milestone), so a burn-rate regression on a committed serve/fleet/MPC
# artifact exits 2.
#
# Pure stdlib: regress-adjacent tooling loads these modules on machines
# without a card.
###############################################################################
from __future__ import annotations

import dataclasses

SLO_SCHEMA = "mpisppy-tpu-slo/1"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One service-level objective."""

    name: str        # row key ("latency", "throughput", "mpc")
    sla: str         # the SLA class / product the spec applies to
    objective: str   # the human sentence
    target_s: float  # per-sample latency target (p99 line)
    budget: float    # allowed violating fraction (error budget)


#: the shipped objectives (docs/telemetry.md SLO table)
DEFAULT_SLOS: tuple[SLOSpec, ...] = (
    SLOSpec("latency", "latency",
            "time-to-1%-gap p99 <= 15s; <= 5% of latency-class "
            "sessions miss gap or deadline",
            target_s=15.0, budget=0.05),
    SLOSpec("throughput", "throughput",
            "<= 5% of throughput-class sessions fail to certify "
            "within their deadline",
            target_s=60.0, budget=0.05),
    SLOSpec("mpc", "mpc",
            "step-deadline miss (degraded-window) rate <= 10% per "
            "stream; step p99 <= 5s",
            target_s=5.0, budget=0.10),
)


def _row(spec: SLOSpec, samples: int, bad: int,
         detail: dict | None = None) -> dict:
    """One evaluated SLO row.  With zero samples the row reports
    burn 0 and samples 0 — absence of traffic is not a violation."""
    bad_frac = (bad / samples) if samples else 0.0
    burn = bad_frac / spec.budget if spec.budget else 0.0
    out = {
        "sla": spec.sla,
        "objective": spec.objective,
        "target_s": spec.target_s,
        "budget": spec.budget,
        "samples": samples,
        "bad": bad,
        "bad_frac": round(bad_frac, 6),
        "burn_rate": round(burn, 4),
        "budget_remaining": round(max(0.0, 1.0 - burn), 4),
        "ok": burn <= 1.0,
    }
    if detail:
        out.update(detail)
    return out


# -- evaluation from slo-observation rows ------------------------------------
def observations(rows: list[dict]) -> list[dict]:
    """The slo-observation payloads in a row stream (trace files, an
    assembled trace, or a raw JSONL list)."""
    out = []
    for r in rows:
        if r.get("kind") == "slo-observation":
            d = r.get("data") or {}
            if "outcome" in d:
                out.append(d)
    return out


def _p99(xs: list[float]) -> float | None:
    """Nearest-rank p99 (stdlib; no numpy on the tooling path)."""
    if not xs:
        return None
    xs = sorted(xs)
    i = min(len(xs) - 1, max(0, int(0.99 * len(xs) + 0.5) - 1))
    return xs[i]


def evaluate_observations(rows: list[dict],
                          specs=DEFAULT_SLOS) -> dict:
    """Fold slo-observation rows (one per settled session) into the
    per-SLO burn-rate report."""
    obs = observations(rows)
    slos: dict = {}
    for spec in specs:
        if spec.name == "mpc":
            mine = [o for o in obs
                    if (o.get("steps_expected") or 0) > 0]
            # a stream's violating unit is the WINDOW: count expected
            # windows as samples, missed windows (a stream that died
            # at step k misses the rest) as bad
            samples = sum(int(o.get("steps_expected") or 0)
                          for o in mine)
            bad = sum(max(0, int(o.get("steps_expected") or 0)
                          - int(o.get("steps") or 0))
                      for o in mine)
            bad += sum(1 for o in mine if o.get("outcome") != "done"
                       and int(o.get("steps") or 0)
                       >= int(o.get("steps_expected") or 0))
            lat = [o["total_s"] for o in mine
                   if o.get("total_s") is not None]
            slos[spec.name] = _row(
                spec, samples, bad,
                {"streams": len(mine), "p99_s": _p99(lat)})
            continue
        mine = [o for o in obs
                if o.get("sla") == spec.sla
                and not (o.get("steps_expected") or 0)]
        lat = [o["total_s"] for o in mine
               if o.get("total_s") is not None]
        bad = 0
        for o in mine:
            failed = o.get("outcome") != "done"
            over = (o.get("total_s") is not None
                    and o["total_s"] > spec.target_s)
            if failed or over:
                bad += 1
        slos[spec.name] = _row(spec, len(mine), bad,
                               {"p99_s": _p99(lat)})
    return {"schema": SLO_SCHEMA, "source": "observations",
            "slo": slos}


def evaluate_path(path: str, specs=DEFAULT_SLOS) -> dict:
    """Evaluate a trace file or directory (spans.load_rows)."""
    from mpisppy_tpu_torch.telemetry import spans
    return evaluate_observations(spans.load_rows(path), specs)


# -- evaluation from a committed BENCH artifact ------------------------------
def _frac_bad(section: dict, reached_key: str = "reached_gap") -> float:
    """1 - reached/sessions from a loadgen summary section."""
    n = section.get("sessions") or 0
    if not n:
        return 0.0
    return max(0.0, 1.0 - (section.get(reached_key) or 0) / n)


def evaluate_bench(parsed: dict, specs=DEFAULT_SLOS) -> dict:
    """The same burn-rate rows from a BENCH artifact's parsed sections
    (serve_load / fleet_serve_load / mpc_stream).  Aggregates stand in
    for per-session samples: a p99 over target charges at least the
    1% the percentile proves; the reached-gap shortfall charges the
    rest."""
    by_name = {s.name: s for s in specs}
    slos: dict = {}
    serve = parsed.get("serve_load") or {}
    fleet = parsed.get("fleet_serve_load") or {}
    mpc = parsed.get("mpc_stream") or {}
    if serve or fleet:
        spec = by_name["latency"]
        n = int((serve.get("sessions") or 0)
                + (fleet.get("sessions") or 0))
        bad_frac = 0.0
        p99s = []
        for sec in (serve, fleet):
            if not sec:
                continue
            w = (sec.get("sessions") or 0) / max(1, n)
            bad = _frac_bad(sec)
            p99 = sec.get("time_to_gap_p99_s")
            if p99 is not None:
                p99s.append(p99)
                if p99 > spec.target_s:
                    bad = max(bad, 0.01)
            bad_frac += w * bad
        slos["latency"] = _row(
            spec, n, round(bad_frac * n),
            {"p99_s": max(p99s) if p99s else None})
        spec = by_name["throughput"]
        done = sum((sec.get("outcomes") or {}).get("done", 0)
                   for sec in (serve, fleet) if sec)
        slos["throughput"] = _row(spec, n, max(0, n - done))
    if mpc:
        spec = by_name["mpc"]
        steps = bad = 0
        p99s = []
        for key, sec in mpc.items():
            if not isinstance(sec, dict) or "degraded_steps" not in sec:
                continue
            steps += int(sec.get("steps") or 0)
            bad += int(sec.get("degraded_steps") or 0)
            p99 = sec.get("step_latency_p99_s")
            if p99 is not None:
                p99s.append(p99)
                if p99 > spec.target_s:
                    bad = max(bad, 1)
        slos["mpc"] = _row(spec, steps, bad,
                           {"p99_s": max(p99s) if p99s else None})
    return {"schema": SLO_SCHEMA, "source": "bench", "slo": slos}


def bench_slo_section(parsed: dict, specs=DEFAULT_SLOS) -> dict:
    """The `slo` section a BENCH artifact commits: just the rows (the
    schema/source envelope stays on the CLI report)."""
    return evaluate_bench(parsed, specs)["slo"]


# -- metrics export ----------------------------------------------------------
def export_metrics(report: dict) -> None:
    """Publish the evaluated burn rates as slo_* gauges (labels key the
    SLO name).  Import is local so the module stays loadable standalone
    on tooling machines."""
    try:
        from mpisppy_tpu_torch.telemetry import metrics as _metrics
    except ImportError:
        return
    for name, row in (report.get("slo") or {}).items():
        _metrics.REGISTRY.set_gauge("slo_burn_rate",
                                    row["burn_rate"], slo=name)
        _metrics.REGISTRY.set_gauge("slo_error_budget_remaining",
                                    row["budget_remaining"], slo=name)


# -- rendering ---------------------------------------------------------------
def render_slo(report: dict) -> str:
    lines = [f"SLO report ({report.get('source', '?')})"]
    lines.append(f"{'slo':<12} {'samples':>7} {'bad':>5} "
                 f"{'burn':>7} {'budget left':>11}  verdict")
    for name, row in (report.get("slo") or {}).items():
        verdict = "ok" if row["ok"] else "VIOLATED"
        lines.append(
            f"{name:<12} {row['samples']:>7} {row['bad']:>5} "
            f"{row['burn_rate']:>7.2f} "
            f"{row['budget_remaining']:>11.2f}  {verdict}")
        lines.append(f"    {row['objective']}")
    if not report.get("slo"):
        lines.append("  (no samples)")
    return "\n".join(lines)
