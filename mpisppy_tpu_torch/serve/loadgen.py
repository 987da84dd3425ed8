###############################################################################
# Load generator + client library (port of mpisppy_tpu/serve/loadgen.py;
# docs/serving.md).
#
# ServeClient is the minimal protocol client (connect / submit /
# stream-until-terminal); run_load drives N synthetic clients with a
# mixed farmer/sslp/uc workload against a running server and measures
# what the acceptance criteria name:
#
#   * per-session TIME-TO-TARGET-GAP: the wall clock from submit to the
#     first streamed progress line whose rel_gap <= the session's gap
#     target (falling back to the terminal line for sessions whose
#     engine reports only the final gap);
#   * p50/p99 across the HEALTHY tenants' sessions — the serve_load
#     bench phase's headline numbers;
#   * TENANT ISOLATION: run_load runs once clean and once with an
#     adversarial tenant (flood via the ServeFault seam + hang/
#     disconnect behaviors); healthy-tenant p99 in the adversarial run
#     within 25% of the clean baseline is the isolation line.
#
# Every record carries the terminal outcome kind, so the no-hang
# contract is asserted mechanically: a session with no terminal
# outcome is a harness failure, not a statistic.
###############################################################################
from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np

from mpisppy_tpu_torch.serve.protocol import SubmitRequest, TERMINAL_EVENTS
from mpisppy_tpu_torch.telemetry.tracecontext import TraceContext


class ServeClient:
    """Blocking JSON-lines client for one connection."""

    def __init__(self, address, timeout: float = 300.0):
        if isinstance(address, str):
            self.sock = socket.socket(socket.AF_UNIX,
                                      socket.SOCK_STREAM)
            self.sock.connect(address)
        else:
            self.sock = socket.create_connection(tuple(address))
        self.sock.settimeout(timeout)
        self._rfile = self.sock.makefile("rb")
        self._stashed: list = []   # events read while waiting for acks

    def send(self, obj: dict) -> None:
        self.sock.sendall((json.dumps(obj) + "\n").encode())

    def recv(self) -> dict:
        line = self._rfile.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    def submit(self, spec: SubmitRequest) -> dict:
        """Submit and read lines until THIS submit's ack arrives
        (streamed events for earlier sessions may interleave — they are
        returned to the caller via collect())."""
        self.send(spec.to_dict())
        while True:
            msg = self.recv()
            if "ok" in msg and msg.get("event") is None:
                return msg
            self._stashed.append(msg)

    def stream(self):
        """Yield stashed + live messages."""
        while self._stashed:
            yield self._stashed.pop(0)
        while True:
            yield self.recv()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def run_session(client: ServeClient, spec: SubmitRequest,
                wait_terminal: bool = True) -> dict:
    """Submit one session and stream it to its terminal outcome.
    Returns the record the load summary consumes."""
    # causal trace context: the CLIENT mints the root trace
    # at submit — the server adopts it, so the record's trace_id joins
    # the client-observed latency to the server-side span tree
    if getattr(spec, "traceparent", None) is None:
        import dataclasses as _dc
        spec = _dc.replace(
            spec, traceparent=TraceContext.mint().to_traceparent())
    ctx = TraceContext.from_traceparent(spec.traceparent)
    t0 = time.perf_counter()
    ack = client.submit(spec)
    rec = {"tenant": spec.tenant, "sla": spec.sla, "model": spec.model,
           "submit_t": t0, "session": ack.get("session"),
           "trace_id": ctx.trace_id if ctx else None,
           "outcome": None, "time_to_gap_s": None, "total_s": None,
           "preempted": 0}
    if not ack.get("ok"):
        rec["outcome"] = "rejected"
        rec["reason"] = ack.get("reason")
        rec["total_s"] = time.perf_counter() - t0
        return rec
    if not wait_terminal:
        return rec
    sid = ack["session"]
    for msg in client.stream():
        if msg.get("session") not in (None, sid):
            continue
        ev = msg.get("event")
        if ev == "progress" and rec["time_to_gap_s"] is None:
            g = msg.get("rel_gap")
            if g is not None and g <= spec.gap_target:
                rec["time_to_gap_s"] = time.perf_counter() - t0
        elif ev == "preempted":
            rec["preempted"] += 1
        elif ev in TERMINAL_EVENTS:
            rec["outcome"] = ev
            rec["reason"] = msg.get("reason")
            rec["total_s"] = time.perf_counter() - t0
            if rec["time_to_gap_s"] is None and ev == "done" \
                    and msg.get("rel_gap") is not None \
                    and msg["rel_gap"] <= spec.gap_target:
                rec["time_to_gap_s"] = rec["total_s"]
            return rec
    rec["outcome"] = "disconnected"
    rec["total_s"] = time.perf_counter() - t0
    return rec


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def summarize(records: list[dict],
              healthy_tenants=None) -> dict:
    """p50/p99 time-to-gap + outcome accounting over (optionally a
    tenant subset of) the records."""
    rel = [r for r in records
           if healthy_tenants is None or r["tenant"] in healthy_tenants]
    hits = [r["time_to_gap_s"] for r in rel
            if r["time_to_gap_s"] is not None]
    outcomes: dict = {}
    for r in rel:
        outcomes[r["outcome"] or "none"] = \
            outcomes.get(r["outcome"] or "none", 0) + 1
    return {
        "sessions": len(rel),
        "reached_gap": len(hits),
        "time_to_gap_p50_s": (round(_pct(hits, 50), 4)
                              if hits else None),
        "time_to_gap_p99_s": (round(_pct(hits, 99), 4)
                              if hits else None),
        "total_p50_s": round(_pct(
            [r["total_s"] for r in rel if r["total_s"] is not None],
            50) or 0.0, 4),
        "outcomes": outcomes,
        "preemptions": sum(r.get("preempted", 0) for r in rel),
    }


#: the default mixed workload (model, num_scens, sla) — cycled per
#: client so every tenant touches every model class
DEFAULT_MIX = (
    ("farmer", 3, "latency"),
    ("sslp", 4, "throughput"),
    ("farmer", 4, "throughput"),
    ("uc", 3, "throughput"),
)


def run_load(address, n_clients: int = 8, sessions_each: int = 2,
             tenants=("acme", "zeta"), mix=DEFAULT_MIX,
             gap_target: float = 0.01, max_iterations: int = 200,
             deadline_s: float | None = 120.0,
             adversary: str | None = None,
             adversary_sessions: int = 8,
             fault_plan=None, seed: int = 0) -> list[dict]:
    """N concurrent clients round-robined over `tenants`, each running
    `sessions_each` sessions drawn from `mix` sequentially.  With
    `adversary` set, one extra client floods that tenant (submit
    count scaled by the fault plan's flood factor when armed, never
    reading backpressure as failure) while hanging/disconnect seams
    ride the server's own FaultPlan."""
    records: list[dict] = []
    rec_lock = threading.Lock()

    def client_body(ci: int):
        tenant = tenants[ci % len(tenants)]
        cl = ServeClient(address)
        try:
            for k in range(sessions_each):
                model, scens, sla = mix[(ci + k) % len(mix)]
                spec = SubmitRequest(
                    tenant=tenant, sla=sla, model=model,
                    num_scens=scens, gap_target=gap_target,
                    max_iterations=max_iterations,
                    deadline_s=deadline_s)
                rec = run_session(cl, spec)
                with rec_lock:
                    records.append(rec)
        finally:
            cl.close()

    def adversary_body():
        n = adversary_sessions
        if fault_plan is not None:
            n *= fault_plan.serve_flood_factor(adversary)
        cl = ServeClient(address)
        acks = []
        try:
            # flood: fire-and-forget submits — backpressure answers
            # with typed rejects, which the harness records as such
            for k in range(n):
                model, scens, _ = mix[k % len(mix)]
                spec = SubmitRequest(
                    tenant=adversary, sla="latency", model=model,
                    num_scens=scens, gap_target=gap_target,
                    max_iterations=max_iterations,
                    deadline_s=deadline_s)
                acks.append(run_session(cl, spec,
                                        wait_terminal=False))
                time.sleep(0.002)
            # then stop reading entirely (a hanging consumer) and
            # finally drop the connection mid-stream
            time.sleep(0.2)
        finally:
            cl.close()
        with rec_lock:
            for a in acks:
                if not a.get("outcome"):
                    # submitted then never streamed: the flood client
                    # walked away — the SERVER still settles these
                    # (drain rejects or detached completion)
                    a["outcome"] = "abandoned"
                records.append(a)

    threads = [threading.Thread(target=client_body, args=(i,),
                                daemon=True, name=f"loadgen-{i}")
               for i in range(n_clients)]
    if adversary is not None:
        threads.append(threading.Thread(target=adversary_body,
                                        daemon=True,
                                        name="loadgen-adversary"))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return records
