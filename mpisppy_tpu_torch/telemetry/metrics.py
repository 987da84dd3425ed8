###############################################################################
# Metrics registry + the shared snapshot schema (port of
# mpisppy_tpu/telemetry/metrics.py; the metric names are the JAX
# package's).
#
# A MetricsRegistry is a flat map of named counters (monotone within a
# run) and gauges (point-in-time values), with optional Prometheus-style
# labels.  Two render paths share ONE schema:
#
#   * render_prom()  — Prometheus text exposition, written atomically to
#     the --metrics-snapshot file so a node-exporter-style scraper (or a
#     human with `cat`) can watch a long-running wheel;
#   * to_snapshot()  — the JSON snapshot dict (the JAX package's
#     bench.py embeds the same object in its BENCH_*.json entries).
#
# There is a process-global default registry (REGISTRY) in the style of
# prometheus_client: deep library code (the dispatch scheduler, the
# async hub, the watchdog) records into it without threading a handle
# through every call, and sinks snapshot it.  Values mirrored from on-device cumulative
# counters are SET (absolute), not inc'd — the device is the source of
# truth and re-folding would double count.
###############################################################################
from __future__ import annotations

import threading
import time

SNAPSHOT_SCHEMA = "mpisppy-tpu-metrics/1"

#: The declared metric vocabulary (schema-drift pass): every
#: literal metric name recorded anywhere in the library must appear
#: here, so a typo'd or ad-hoc name is a lint failure instead of a
#: silently forked time series (`python -m tools.graftlint`).  Names
#: are grouped by producer; labels (cyl=, kind=) are orthogonal to the
#: base name and not part of the schema.
ALL_METRICS = frozenset({
    # telemetry spine (sinks.py, hub checkpoint path)
    "events_total",
    "checkpoint_writes_total",
    # on-device PDHG kernel counters (counters.py harvest)
    "pdhg_iterations_total",
    "pdhg_restarts_total",
    "pdhg_omega_adaptations_total",
    "pdhg_guard_resets_total",
    "pdhg_windows_total",
    "pdhg_last_score_median",
    # host-driven B&B (ops/bnb.py)
    "bnb_nodes_solved_total",
    "bnb_lanes_closed_total",
    # dispatch scheduler (dispatch/scheduler.py; docs/dispatch.md)
    "dispatch_batches_total",
    "dispatch_lanes_total",
    "dispatch_pad_lanes_total",
    "dispatch_batch_occupancy",
    "dispatch_queue_depth",
    "dispatch_buckets_active",
    "dispatch_inflight",
    "dispatch_backend_compiles_total",
    "dispatch_unexpected_recompiles_total",
    "dispatch_retries_total",
    "dispatch_quarantined_lanes_total",
    "dispatch_quarantined_requests_total",
    "dispatch_dispatcher_deaths_total",
    "dispatch_plane_tickets_total",
    "dispatch_plane_deadline_misses_total",
    # async wheel exchange plane (cylinders/hub.AsyncPHHub)
    "async_plane_writes_total",
    "async_plane_staleness",
    # seeded scenario synthesis (mpisppy_tpu/scengen; docs/scengen.md)
    "scengen_virtual_batches_total",
    "scengen_scenarios",
    "scengen_data_bytes_saved",
    # supervisors (resilience/watchdog.py)
    "watchdog_trips_total",
    # multi-tenant wheel server (mpisppy_tpu/serve)
    "serve_sessions_total",
    "serve_sessions_active",
    "serve_queue_depth",
    "serve_admission_rejects_total",
    "serve_preemptions_total",
    "serve_disconnects_total",
    "serve_failures_total",
    # replicated serve fleet (mpisppy_tpu/fleet)
    "fleet_replicas_up",
    "fleet_replica_deaths_total",
    "fleet_sessions_migrated_total",
    "fleet_migrations_lost_total",
    "fleet_placement_affinity_total",
    "fleet_placement_spill_total",
    # rolling-horizon MPC streams (mpisppy_tpu/mpc)
    "mpc_streams_total",
    "mpc_steps_total",
    "mpc_warm_steps_total",
    "mpc_cold_fallbacks_total",
    "mpc_degraded_steps_total",
    "mpc_stream_resumes_total",
    "mpc_step_latency_s",
    # elastic mesh fault domain (parallel/elastic.py)
    "mesh_hosts_up",
    "mesh_epoch",
    "mesh_hosts_lost_total",
    "mesh_reshards_total",
    "mesh_reshards_lost_total",
    "mesh_stragglers_total",
    "mesh_torn_harvests_total",
    # SLO plane (telemetry/slo.py, serve/session.py) —
    # *_latency_* names are HISTOGRAMS (observe()), the rest gauges
    "slo_session_latency_s",
    "slo_burn_rate",
    "slo_error_budget_remaining",
    "mpc_step_latency_hist_s",
})

#: default histogram bucket upper bounds (seconds — the latency scale
#: every slo_*/mpc latency histogram shares); +Inf is implicit
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class Histogram:
    """One bucketed distribution: cumulative-style bucket counts plus
    sum/count, the Prometheus histogram data model.  Standalone (no
    registry required) so stream-following consumers — `telemetry
    watch`'s per-stream MPC step latencies — can
    fold unbounded row streams into O(buckets) state instead of
    retaining every raw row."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=None):
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float | None:
        """Bucket-resolution quantile estimate (linear interpolation
        inside the landing bucket; the +Inf tail reports its lower
        bound).  None while empty."""
        if self.count == 0:
            return None
        target = max(0.0, min(1.0, float(q))) * self.count
        cum = 0
        lo = 0.0
        for j, b in enumerate(self.buckets):
            nxt = cum + self.counts[j]
            if nxt >= target and self.counts[j] > 0:
                frac = (target - cum) / self.counts[j]
                return lo + frac * (b - lo)
            cum = nxt
            lo = b
        return lo

    def to_dict(self) -> dict:
        return {"buckets": list(self.buckets),
                "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


def _key(name: str, labels: dict | None) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe counter/gauge map (checkpoint writes record from a
    daemon thread)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}      # guarded-by: _lock
        self._gauges: dict[str, float] = {}        # guarded-by: _lock
        self._histograms: dict[str, Histogram] = {}  # guarded-by: _lock

    # -- recording --------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, **labels):
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def set_counter(self, name: str, value: float, **labels):
        """Mirror an absolute cumulative value (e.g. an on-device
        counter total) into the registry."""
        with self._lock:
            self._counters[_key(name, labels)] = float(value)

    def set_gauge(self, name: str, value: float, **labels):
        with self._lock:
            self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, buckets=None, **labels):
        """Record one sample into a histogram series (first-class
        histogram type, — p50/p99 stop being recomputed from
        retained raw rows)."""
        k = _key(name, labels)
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                h = self._histograms[k] = Histogram(buckets)
            h.observe(value)

    def get(self, name: str, default: float = 0.0, **labels) -> float:
        k = _key(name, labels)
        with self._lock:
            if k in self._counters:
                return self._counters[k]
            return self._gauges.get(k, default)

    def get_histogram(self, name: str, **labels) -> Histogram | None:
        with self._lock:
            return self._histograms.get(_key(name, labels))

    def quantile(self, name: str, q: float, **labels) -> float | None:
        h = self.get_histogram(name, **labels)
        return None if h is None else h.quantile(q)

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    # -- rendering (the one shared schema) --------------------------------
    def to_snapshot(self) -> dict:
        """JSON snapshot — the schema bench.py embeds in BENCH_*.json.
        `histograms` is additive (snapshots without histograms parse
        identically)."""
        with self._lock:
            snap = {
                "schema": SNAPSHOT_SCHEMA,
                "t_wall": time.time(),
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
            }
            if self._histograms:
                snap["histograms"] = {
                    k: self._histograms[k].to_dict()
                    for k in sorted(self._histograms)}
            return snap

    def render_prom(self) -> str:
        """Prometheus text exposition (one sample per line)."""
        snap = self.to_snapshot()
        lines = [f"# mpisppy-tpu metrics snapshot "
                 f"(schema {SNAPSHOT_SCHEMA})"]
        for kind, samples in (("counter", snap["counters"]),
                              ("gauge", snap["gauges"])):
            seen_names = set()
            for k, v in samples.items():
                base = k.split("{", 1)[0]
                if base not in seen_names:
                    seen_names.add(base)
                    lines.append(f"# TYPE {base} {kind}")
                lines.append(f"{k} {v!r}")
        seen_names = set()
        for k, h in snap.get("histograms", {}).items():
            base, _, labels = k.partition("{")
            labels = labels[:-1] if labels else ""
            if base not in seen_names:
                seen_names.add(base)
                lines.append(f"# TYPE {base} histogram")

            def series(suffix, extra=""):
                inner = ",".join(x for x in (labels, extra) if x)
                return f"{base}{suffix}" + (f"{{{inner}}}" if inner
                                            else "")
            cum = 0
            for b, c in zip(h["buckets"], h["counts"]):
                cum += c
                le = 'le="%s"' % b
                lines.append(series("_bucket", le) + f" {cum}")
            cum += h["counts"][-1]
            lines.append(series("_bucket", 'le="+Inf"') + f" {cum}")
            lines.append(series("_sum") + " " + repr(h["sum"]))
            lines.append(series("_count") + " %d" % h["count"])
        return "\n".join(lines) + "\n"


#: process-global default registry (prometheus_client convention)
REGISTRY = MetricsRegistry()
