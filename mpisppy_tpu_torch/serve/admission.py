###############################################################################
# Admission control (port of mpisppy_tpu/serve/admission.py;
# docs/serving.md).
#
# Weighted fair queueing across tenants with SLA priority classes and
# typed backpressure — the dispatch layer's "a caller observes a result or a typed
# failure, never a hang" semantics extended one layer up:
#
#   * BACKPRESSURE — submit() never blocks.  A full global queue, a
#     full per-tenant queue, or a draining server raises a typed
#     AdmissionRejected (reason queue-full / tenant-queue-full /
#     draining) that the server answers as the client's terminal
#     `rejected` line.  Load converts to a bounded queue and typed
#     refusals, exactly like the dispatch layer converts storms to
#     batch occupancy.
#   * WEIGHTED FAIRNESS — pop() runs virtual-time WFQ (stride
#     scheduling): each tenant accumulates virtual service 1/weight
#     per admitted session, and the eligible tenant with the least
#     virtual finish time goes next.  A tenant flooding its queue
#     advances its own virtual clock and cannot starve the others —
#     the mechanism behind the tenant-isolation acceptance line.
#   * SLA CLASSES — `latency` sessions pop before `throughput` ones
#     (they also jump their own tenant's queue), bounded by a
#     starvation guard: after `latency_burst` consecutive latency
#     pops with throughput work waiting, one throughput session is
#     scheduled regardless.
#   * QUOTAS — a tenant with `quota` sessions already in flight is
#     ineligible until one finishes; quota never rejects (queued work
#     waits), only the queue caps do.
###############################################################################
from __future__ import annotations

import threading


class AdmissionRejected(RuntimeError):
    """Typed admission refusal (docs/serving.md failure semantics):
    reason 'queue-full' | 'tenant-queue-full' | 'draining'."""

    def __init__(self, reason: str, tenant: str = "", detail: str = ""):
        self.reason = reason
        self.tenant = tenant
        self.detail = detail
        super().__init__(
            f"admission rejected ({reason})"
            + (f" for tenant {tenant!r}" if tenant else "")
            + (f": {detail}" if detail else ""))


class _Tenant:
    __slots__ = ("name", "weight", "quota", "vfinish", "queue",
                 "inflight", "admitted", "rejected", "ordinals",
                 "steps_charged")

    def __init__(self, name: str, weight: float, quota: int):
        self.name = name
        self.weight = max(1e-6, float(weight))
        self.quota = int(quota)
        self.vfinish = 0.0     # virtual finish time (WFQ clock)
        self.queue: list = []  # FIFO of queued sessions (latency first)
        self.inflight = 0
        self.admitted = 0
        self.rejected = 0
        self.ordinals = 0      # per-tenant admission ordinal counter
        self.steps_charged = 0  # MPC stream windows billed


class FairQueue:
    """The admission policy: bounded tenant queues + WFQ pop.

    Thread-safety: submit() rides client reader threads, pop() the
    scheduler loop, release() the session workers."""

    def __init__(self, max_queued: int = 64,
                 max_queued_per_tenant: int = 32,
                 default_quota: int = 2,
                 default_weight: float = 1.0,
                 latency_burst: int = 4,
                 weights: dict | None = None,
                 quotas: dict | None = None):
        self.max_queued = int(max_queued)
        self.max_queued_per_tenant = int(max_queued_per_tenant)
        self.default_quota = int(default_quota)
        self.default_weight = float(default_weight)
        self.latency_burst = int(latency_burst)
        self._weights = dict(weights or {})
        self._quotas = dict(quotas or {})
        self._lock = threading.Lock()
        self._tenants: dict = {}          # guarded-by: _lock
        self._queued = 0                  # guarded-by: _lock
        self._vtime = 0.0                 # guarded-by: _lock
        self._draining = False            # guarded-by: _lock
        self._latency_run = 0             # guarded-by: _lock
        self._rejects = 0                 # guarded-by: _lock

    def _tenant(self, name: str) -> _Tenant:   # holds-lock: _lock
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name, self._weights.get(name,
                                                self.default_weight),
                        self._quotas.get(name, self.default_quota))
            self._tenants[name] = t
        return t

    # -- submit (client reader threads) -----------------------------------
    def submit(self, session) -> None:
        """Enqueue or raise a typed AdmissionRejected — never blocks."""
        with self._lock:
            t = self._tenant(session.tenant)
            if self._draining:
                t.rejected += 1
                self._rejects += 1
                raise AdmissionRejected("draining", session.tenant)
            if self._queued >= self.max_queued:
                t.rejected += 1
                self._rejects += 1
                raise AdmissionRejected(
                    "queue-full", session.tenant,
                    f"{self._queued} sessions queued (cap "
                    f"{self.max_queued})")
            if len(t.queue) >= self.max_queued_per_tenant:
                t.rejected += 1
                self._rejects += 1
                raise AdmissionRejected(
                    "tenant-queue-full", session.tenant,
                    f"{len(t.queue)} queued (cap "
                    f"{self.max_queued_per_tenant})")
            session.ordinal = t.ordinals
            t.ordinals += 1
            if session.sla == "latency":
                # jump the tenant's own throughput backlog, FIFO among
                # latency peers
                idx = sum(1 for s in t.queue if s.sla == "latency")
                t.queue.insert(idx, session)
            else:
                t.queue.append(session)
            self._queued += 1

    def requeue_front(self, session) -> None:
        """Put a preempted/degraded session back at the FRONT of its
        tenant queue (it already paid its virtual service; restoring it
        first minimizes client-visible disruption)."""
        with self._lock:
            t = self._tenant(session.tenant)
            t.queue.insert(0, session)
            self._queued += 1

    # -- pop (scheduler loop) ---------------------------------------------
    def _eligible(self):               # holds-lock: _lock
        return [t for t in self._tenants.values()
                if t.queue and t.inflight < t.quota]

    def _select(self):                 # holds-lock: _lock
        """The WFQ winner tenant (SLA-class priority + starvation
        guard + least virtual finish), or None when nothing is
        eligible."""
        elig = self._eligible()
        if not elig:
            return None
        lat = [t for t in elig if t.queue[0].sla == "latency"]
        thr = [t for t in elig if t.queue[0].sla != "latency"]
        pool = lat or thr
        if lat and thr and self._latency_run >= self.latency_burst:
            pool = thr                 # starvation guard: one through
        return min(pool, key=lambda x: (x.vfinish, x.name))

    def _charge(self, t, session) -> None:   # holds-lock: _lock
        """Commit an admission: quota slot, WFQ virtual clock, SLA
        burst counter."""
        t.inflight += 1
        t.admitted += 1
        # WFQ virtual clock: service cost 1 scaled by weight
        self._vtime = max(self._vtime, t.vfinish)
        t.vfinish = self._vtime + 1.0 / t.weight
        if session.sla == "latency":
            self._latency_run += 1
        else:
            self._latency_run = 0

    def pop(self):
        """The next session to admit, or None when nothing is eligible
        (empty queues or every queued tenant at quota).  SLA-class
        priority first (with the starvation guard), then least virtual
        finish time among eligible tenants.  Sessions that reached a
        terminal state while queued (deadline-reaped, rejected on
        drain) are dropped here without charging the tenant's virtual
        clock or quota — a dead session must not burn a worker slot
        or skew fairness."""
        with self._lock:
            while True:
                t = self._select()
                if t is None:
                    return None
                session = t.queue.pop(0)
                self._queued -= 1
                if session.is_terminal():
                    continue           # reaped while queued: discard
                self._charge(t, session)
                return session

    def release(self, session) -> None:
        """A session left the running set (terminal or preempted) —
        frees its tenant's quota slot."""
        with self._lock:
            t = self._tenant(session.tenant)
            t.inflight = max(0, t.inflight - 1)

    def charge_step(self, session) -> None:
        """Bill one completed MPC stream window against the tenant's
        WFQ clock: each step advances vfinish exactly like a
        fresh admission, so a long-lived stream keeps paying virtual
        service per window and can never starve throughput tenants off
        a single admission-time charge.  Quota and the SLA burst
        counter are NOT touched — the stream still holds its one
        admission slot."""
        with self._lock:
            t = self._tenant(session.tenant)
            self._vtime = max(self._vtime, t.vfinish)
            t.vfinish = self._vtime + 1.0 / t.weight
            t.steps_charged += 1

    # -- lifecycle / stats ------------------------------------------------
    def drain(self) -> list:
        """Stop admitting: every queued session is returned for typed
        rejection, later submits raise AdmissionRejected('draining')."""
        with self._lock:
            self._draining = True
            out = []
            for t in self._tenants.values():
                out.extend(t.queue)
                t.queue = []
            self._queued = 0
            return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "queued": self._queued,
                "rejected": self._rejects,
                "draining": self._draining,
                "tenants": {
                    t.name: {
                        "queued": len(t.queue),
                        "inflight": t.inflight,
                        "admitted": t.admitted,
                        "rejected": t.rejected,
                        "steps_charged": t.steps_charged,
                        "weight": t.weight,
                        "quota": t.quota,
                        "vfinish": round(t.vfinish, 4),
                    } for t in self._tenants.values()},
            }


class FleetAdmission(FairQueue):
    """Placement-aware WFQ for the fleet router.

    The exact FairQueue policy — WFQ weights, quotas, SLA classes,
    bounded queues with typed rejection — hoisted ABOVE the replicas
    (global admission state lives here, each replica's local queue is
    just a hand-off buffer), plus a placement step fused into pop:
    the WFQ winner is only charged (quota + virtual clock) once a
    replica actually accepted it, so a fleet momentarily out of free
    slots leaves fairness untouched."""

    def pop_placed(self, place_fn):
        """Pop the WFQ-next session and place it.

        place_fn(session) -> replica-or-None runs OUTSIDE the queue
        lock (it reads replica load and affinity state).  Returns
        (session, replica), or (None, None) when nothing is eligible,
        placement declined (no live replica with a free slot — the
        session stays at the front of its queue, uncharged), or a
        concurrent drain raced the candidate away."""
        with self._lock:
            while True:
                t = self._select()
                if t is None:
                    return None, None
                session = t.queue[0]
                if session.is_terminal():
                    t.queue.pop(0)     # reaped while queued: discard
                    self._queued -= 1
                    continue
                break
        replica = place_fn(session)
        if replica is None:
            return None, None
        with self._lock:
            t2 = self._tenants.get(session.tenant)
            # commit only if the candidate is still at its queue front
            # (a drain may have emptied the queue while we placed)
            if t2 is None or not t2.queue or t2.queue[0] is not session:
                return None, None
            t2.queue.pop(0)
            self._queued -= 1
            self._charge(t2, session)
        return session, replica
