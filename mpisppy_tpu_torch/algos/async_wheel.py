###############################################################################
# Asynchronous wheel driver (port of mpisppy_tpu/algos/async_wheel.py).
#
# The synchronous fused wheel serializes harvest -> validate ->
# plane-write -> device step every sync: the device idles while the host
# completes the exchange and vice versa.  APH (Eckstein et al.,
# transcribed in algos/aph.py) names the cure — run projections and
# bounds without a barrier against a stale-but-bounded plane.
#
# Mechanics (staleness s >= 1):
#
#   * a DOUBLE-BUFFERED exchange plane (two ExchangePlane slots of tensor
#     references): the device step of iteration k reads slot k mod 2, the
#     host writes slot (k+1) mod 2 with generation k+1-s (a delay line of
#     references — a plane write is a reference swap, never a copy; no
#     step writes a plane's tensors in place, see fused_wheel.py);
#   * the hub PH step proxes around the PLANE x̄ with the multiplier
#     update theta-damped by the APH projective step length
#     (fused_wheel.ph_stale_step) so stale updates stay convergent;
#   * the spoke planes (Lagrangian / x̂ / slam / shuffle) evaluate AT the
#     plane — L(W) is a certified outer bound at ANY W, and every
#     candidate evaluation keeps its feasibility + comp-tightness gates,
#     so staleness can delay bounds but never invalidate them;
#   * plane launches ride fire-and-forget PlaneTickets through the
#     dispatch scheduler (a wedged exchange becomes a typed SolveFailed
#     or a watchdog trip, never a hang).  The port's submit_plane runs
#     the plane at submit, so a ticket's deadline measures the host's
#     launch time, not the device's;
#   * the host reads results pipelined (the depth-2 scalar cache plus a
#     one-slot theta pipeline, both non-blocking copies into pinned
#     memory with an event), so it never waits for the step in flight —
#     except where a plane reads a device value on the host itself (the
#     x̂ plane's straggler tail, fused_wheel._tail_rescue).
#
# staleness = 0 degrades to the synchronous FusedPH path untouched, so
# trajectories equal the sync wheel's (tested).
###############################################################################
from __future__ import annotations

import dataclasses

from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core.batch import require_unsharded
from mpisppy_tpu_torch.utils.host_copy import HostCopy


@dataclasses.dataclass(frozen=True)
class AsyncWheelOptions:
    """Host-side async-wheel knobs (CLI: --async-staleness).

    staleness: bound on how many iterations the exchange plane may lag
    the device step (0 = synchronous; fault injection may exceed it
    deliberately — validity never depends on it).  nu/gamma feed the APH
    theta formula; theta_floor keeps the damped multiplier update
    flowing near convergence.  exchange_deadline_s bounds how long the
    exchange may block on any plane ticket before a typed SolveFailed
    surfaces."""

    staleness: int = 1
    nu: float = 1.0
    gamma: float = 1.0
    theta_floor: float = 0.05
    exchange_deadline_s: float | None = None


class AsyncFusedPH(fw.FusedPH):
    """FusedPH whose iteration runs against the double-buffered stale
    exchange plane.  Pair with cylinders.hub.AsyncPHHub (which emits the
    plane-write/overlap telemetry and runs the host-complete half of the
    exchange on the stale side of the pipeline)."""

    def __init__(self, options, batch, wheel_options=None,
                 async_options: AsyncWheelOptions | None = None, **kw):
        # the stale-plane damping (aph.projective_theta) reduces over
        # scenarios without the mesh
        require_unsharded(batch, "AsyncFusedPH")
        super().__init__(options, batch, wheel_options, **kw)
        self.async_options = async_options or AsyncWheelOptions()
        # double buffer of ExchangePlane slots; a "write" is a host-side
        # reference swap, routed through the fault plan's torn/dropped
        # write seams.  Touched only on the hub driver thread.
        self._plane_slots: list = [None, None]
        self._plane_slot_gen: list = [0, 0]  # generation each slot holds
        self._plane_delay: list = []   # generation delay line, len <= s
        self._theta_inflight = None    # a HostCopy, a 1-deep pipeline
        self.last_theta: float | None = None
        self.plane_events: list[dict] = []   # drained by AsyncPHHub
        self._exchange_tickets: list = []    # THIS iteration's tickets
        self._tickets_due: list = []         # previous iteration's

    # -- plane bookkeeping ------------------------------------------------
    def take_plane_events(self) -> list[dict]:
        out, self.plane_events = self.plane_events, []
        return out

    def _write_plane(self, phst: ph_mod.PHState):
        """Append generation self._iter to the delay line and write the
        due generation into slot (iter+1) mod 2 — the slot the NEXT
        iteration's step reads.  The fault plan's async-exchange seams
        (drop / torn swap) intercept here; the recorded event carries
        the generation the slot ACTUALLY holds afterwards, so a dropped
        or torn write shows its observed staleness exceeding the bound."""
        s = max(1, int(self.async_options.staleness))
        self._plane_delay.append((self._iter, fw.plane_of(phst)))
        while len(self._plane_delay) > s:
            self._plane_delay.pop(0)
        gen, plane = self._plane_delay[0]
        slot = (self._iter + 1) % 2
        plan = self.options_fault_plan()
        old = self._plane_slots[slot]
        if plan is not None and old is not None:
            filtered = plan.filter_plane_write(self._iter, plane, old)
            if filtered is old:
                # dropped write: the slot keeps its previous generation
                gen = self._plane_slot_gen[slot]
            elif filtered is not plane:
                # torn swap: the stalest mixed-in component governs what
                # the device actually reads
                gen = min(self._plane_slot_gen[slot], gen)
            plane = filtered
        self._plane_slots[slot] = plane
        self._plane_slot_gen[slot] = gen
        self.plane_events.append({
            "slot": slot, "generation": gen,
            "staleness": self._iter + 1 - gen})

    def options_fault_plan(self):
        """The run's FaultPlan, if the hub armed one."""
        spcomm = getattr(self, "spcomm", None)
        if spcomm is None:
            return None
        return spcomm.options.get("fault_plan")

    # -- iteration --------------------------------------------------------
    def _iter0_impl(self):
        phst, tb, cert = super()._iter0_impl()
        if int(self.async_options.staleness) > 0:
            # seed both slots with the iter0 generation so the first
            # iterk reads a valid plane (staleness 1 at iteration 1)
            plane = fw.plane_of(self.wstate.ph)
            self._plane_slots = [plane, plane]
            self._plane_slot_gen = [0, 0]
            self._plane_delay = [(0, plane)]
        return phst, tb, cert

    def _iterk_impl(self):
        if int(self.async_options.staleness) <= 0:
            # synchronous degrade: the untouched FusedPH path
            return super()._iterk_impl()
        return self._iterk_async()

    def _plane_dispatch(self, label, fn, *args):
        """One fire-and-forget plane launch: through the scheduler's
        PlaneTicket when one is configured, else a direct call."""
        from mpisppy_tpu_torch import dispatch as _dispatch
        sched = _dispatch.get_scheduler(create=False)
        if sched is None:
            return fn(*args)
        ticket = sched.submit_plane(
            fn, *args, label=label,
            deadline_s=self.async_options.exchange_deadline_s)
        self._exchange_tickets.append(ticket)
        return ticket.value

    def result_exchange(self):
        """Bounded settle of the PREVIOUS iteration's plane tickets — the
        host-complete half's 'observe a result or a typed SolveFailed'
        point.  The current iteration's tickets stay in flight; they
        rotate into the due list at the next iterk."""
        tickets, self._tickets_due = self._tickets_due, []
        self._settle(tickets)

    def _settle(self, tickets):
        """Settle EVERY ticket (one wedged launch must not leave its
        siblings unsettled); the first failure re-raises after the
        sweep."""
        deadline = self.async_options.exchange_deadline_s
        first_exc = None
        for t in tickets:
            try:
                t.result(timeout=deadline)
            except Exception as e:
                if first_exc is None:
                    first_exc = e
        if first_exc is not None:
            raise first_exc

    def _iterk_async(self):
        aopts = self.async_options
        # rotate: LAST iteration's tickets become settleable at this
        # sync's host-complete half (result_exchange)
        self._tickets_due.extend(self._exchange_tickets)
        self._exchange_tickets = []
        # a mispaired hub (a plain PHHub never drains tickets or plane
        # events): settle/trim here rather than keep every ticket's
        # tensors alive for the whole run
        if len(self._tickets_due) > 32:
            due, self._tickets_due = self._tickets_due, []
            self._settle(due)
        if len(self.plane_events) > 32:
            del self.plane_events[:-8]
        sid, spoke_iter = self._draw_spoke_cycle()
        plane = self._plane_slots[self._iter % 2]
        if plane is not None \
                and plane.W.shape[0] != self.wstate.ph.W.shape[0]:
            # a re-partitioned state (an elastic reshard, once multi-GPU
            # lands) no longer matches the seeded slots: drop both and
            # re-seed below
            plane = None
            self._plane_slots = [None, None]
        if plane is None:
            # a state restored without _iter0_impl: re-seed both slots
            # (and the delay line's generation stamp) from it, so the
            # first write reports staleness 1, like iteration 1
            plane = fw.plane_of(self.wstate.ph)
            self._plane_slots = [plane, plane]
            self._plane_slot_gen = [self._iter - 1, self._iter - 1]
            self._plane_delay = [(self._iter - 1, plane)]
        # device-issue half: the theta-damped hub step against the stale
        # plane, then every enabled spoke plane AT the plane — none of
        # their inputs depend on this step's output
        phst, theta = fw.ph_stale_step(
            self.batch, self.state, plane, self.options,
            aopts.nu, aopts.gamma, aopts.theta_floor)
        out = dataclasses.replace(self.wstate, ph=phst)
        if spoke_iter:
            out = self._dispatch_spoke_planes(
                out, plane.W, plane.xbar_nodes, plane.x, sid,
                dispatch=self._plane_dispatch)
        self.wstate = dataclasses.replace(out,
                                          scalars=fw._pack_scalars(out))
        self._write_plane(phst)
        # pipelined host reads: the PREVIOUS iteration's packed scalars
        # and theta — the host never waits for the step in flight
        prev_theta, self._theta_inflight = self._theta_inflight, \
            HostCopy([theta])
        if prev_theta is not None:
            self.last_theta = float(prev_theta.values()[0])
        self._cache_scalars(pipelined=True)
        if spoke_iter:
            self._observe_progress()
        return self.wstate.ph

    def flush_scalars(self):
        super().flush_scalars()
        # finalize path: settle every outstanding plane ticket so the
        # last iteration's launches keep the typed-failure contract
        due, self._tickets_due = self._tickets_due, []
        cur, self._exchange_tickets = self._exchange_tickets, []
        self._settle(due + cur)
        if self._theta_inflight is not None:
            self.last_theta = float(self._theta_inflight.values()[0])
