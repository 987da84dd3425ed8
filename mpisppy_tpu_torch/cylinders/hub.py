###############################################################################
# Hub: runs the hub algorithm (PH, APH or L-shaped), feeds spokes, tracks
# bounds, decides termination (port of the core of
# mpisppy_tpu/cylinders/hub.py; ref:mpisppy/cylinders/hub.py:28-724).
#
# Termination semantics match ref:mpisppy/cylinders/hub.py:82-166:
#   * rel_gap  <= options['rel_gap']   (gap = (inner-outer)/|inner|;
#     when |inner| ~ 0 the denominator widens to max(|inner|,|outer|))
#   * abs_gap  <= options['abs_gap']
#   * inner bounds stalled for 'max_stalled_iters' hub iterations
#
# Telemetry spine: every hub observation — iterations, harvests, bound
# decisions, spans, plane writes — is EMITTED through an event bus
# (telemetry/); `trace` and each spoke's `(iter, bound)` trace are
# subscriber views (telemetry/views.py), a row's `t` its event's
# perf_counter stamp.  A bus arrives via options['telemetry_bus'] (the
# CLI's --trace-jsonl / --metrics-snapshot / flight-recorder wiring);
# otherwise the hub gets a private bus whose only subscriber is the view.
#
# Each sync is split as the JAX hub's: a prologue (dispatch stamps, the
# migration drain, the fault plan's preemption and lane seams), the host
# exchange (harvest -> validate -> publish -> checkpoint), and an
# epilogue (the pipelined kernel-counter harvest, dispatch stats, the
# watchdog beat, the iteration event).  options['fault_plan'] arms
# resilience.FaultPlan's harvest, lane, preemption, checkpoint and
# dispatch seams; options['watchdog_budget_s'] starts the progress
# watchdog (resilience/watchdog.py).  AsyncPHHub runs the exchange
# against the async wheel's stale plane (algos/async_wheel.py).
#
# Checkpoints (options['checkpoint_path']): rotated npz snapshots of the
# whole wheel state, CRC-checked, in the JAX package's format (its keys,
# leaf order, dtypes and CRC; utils/wxbarutils.py walks the states), so
# each package restores the other's.  The port's snapshots add, as the
# format's `extra_` arrays (which the JAX package ignores), the host state
# of the driver, the spokes and the hub (their checkpoint_extras), so a
# fused wheel preempted at a sync resumes on its uninterrupted trace
# rows; a JAX snapshot resumes as the JAX package does.  A background save
# starts the device-to-host copies of the state and of the extras'
# tensors on the hub thread (pinned buffers, non-blocking, one event)
# and a daemon thread waits on that event and on the fused wheel's
# scalar copy in flight, then checksums, writes and rotates: the hub
# never waits on the card for a background save.  That is safe because
# no step writes a solver, PH or wheel state tensor in place (every step
# and seam builds new tensors; the lane fault seam clones), so a copy
# queued at iteration k reads the state of iteration k however far the
# hub has run on.
#
# The --profile-dir session (options['profile_dir'],
# options['profile_iters']): a telemetry.profiler.ProfilerSession that
# each sync advances before its wheel_sync range opens and finalize
# closes, so its torch.profiler window holds whole hub iterations.
#
# A rolling-horizon window (mpc/driver.py) passes the previous window's
# shifted W/x̄ plane as options['warm_plane']; the PH hub seeds it into
# the state at its first sync (_apply_warm_plane).
###############################################################################
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
import time
import zlib

import numpy as np
import torch

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.cylinders.spcommunicator import SPCommunicator
from mpisppy_tpu_torch.cylinders.spoke import ConvergerSpokeType
from mpisppy_tpu_torch.telemetry import counters as kcounters
from mpisppy_tpu_torch.telemetry import metrics as metrics_mod
from mpisppy_tpu_torch.telemetry import profiler as _prof
from mpisppy_tpu_torch.utils import atomic_io
from mpisppy_tpu_torch.utils import wxbarutils
from mpisppy_tpu_torch.utils.host_copy import HostCopy


def _checkpoint_crc(data: dict) -> np.ndarray:
    """CRC32 over every array in key order: the checkpoint integrity
    stamp, the JAX package's.  Keys sorted, raw bytes read in place (no
    copy of the snapshot in the emergency-save path)."""
    crc = 0
    for k in sorted(data):
        crc = zlib.crc32(k.encode(), crc)
        arr = np.ascontiguousarray(data[k])
        crc = zlib.crc32(memoryview(arr).cast("B"), crc)
    return np.asarray(crc, np.uint32)


def _unread(v):
    """A snapshot value as save_checkpoint takes it: a device tensor or a
    host copy in flight as it is, anything else as a numpy array."""
    if isinstance(v, (torch.Tensor, HostCopy)):
        return v
    return np.asarray(v)


class Hub(SPCommunicator):
    """Bound bookkeeping + termination (ref:cylinders/hub.py:28-243)."""

    def __init__(self, opt, options: dict | None = None, spokes=None):
        super().__init__(opt, options)
        self.spokes = spokes or []
        self.BestOuterBound = -math.inf  # min problems: lower bound
        self.BestInnerBound = math.inf
        self.latest_ib_char = ""
        self.latest_ob_char = ""
        self._inner_bound_update_iter = 0
        self._iter = 0
        # the perf_counter origin of the trace rows' `t`
        self._t0 = time.perf_counter()
        # one row per hub iteration (iter, conv, bounds, gaps, chars, t),
        # kept by the WheelTraceView subscriber
        self.trace: list[dict] = []
        self.telemetry = self.options.get("telemetry_bus") \
            or tel.EventBus()
        # a session passes its own id; a standalone wheel mints one
        self.run_id = self.options.get("run_id") or tel.new_run_id()
        if self.telemetry.trace is None:
            self.telemetry.set_trace(tel.TraceContext.mint())
        self._trace_view = tel.WheelTraceView(self)
        self.telemetry.subscribe(self._trace_view)
        plan = self.options.get("fault_plan")
        if plan is not None:
            # fault injections report through the same spine
            plan.telemetry = self.telemetry
            plan.telemetry_run = self.run_id
        # adopt the process-default dispatch scheduler into this run
        # (its megabatch events then carry this run's id) and arm the
        # run's fault plan on its dispatch seams; a session hub
        # (options["run_id"]) stamps its driver thread, pre-wheel work
        # included, with its own token
        sched = _dispatch.get_scheduler(create=False)
        if sched is not None and not sched.run:
            sched.run = self.run_id
        if sched is not None and plan is not None \
                and sched.fault_plan is None:
            sched.fault_plan = plan
        if self.options.get("run_id"):
            _dispatch.set_session_context(self.run_id, -1,
                                          **self._trace_token())
        self._last_dispatch_batches = 0
        self._last_guard_total = 0
        # progress watchdog: no hub iteration or bound movement for
        # watchdog_budget_s wall seconds -> flight-recorder dump + the
        # configured action (exit 75, or degrade the dispatch scheduler)
        self._watchdog = None
        budget = self.options.get("watchdog_budget_s")
        if budget:
            from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog
            self._watchdog = HubWatchdog(
                self, float(budget),
                action=self.options.get("watchdog_action", "abort"),
                interval_s=self.options.get("watchdog_interval_s"),
            ).start()
        self._profiler = None
        if self.options.get("profile_dir"):
            batch = getattr(opt, "batch", None)
            self._profiler = _prof.ProfilerSession(
                self.options["profile_dir"],
                num_iters=int(self.options.get("profile_iters", 5)),
                bus=self.telemetry, run=self.run_id,
                cuda=None if batch is None
                else batch.device.type == "cuda")
        self._emit(tel.RUN_START, hub_class=type(self).__name__,
                   num_spokes=len(self.spokes))
        # sense-contradiction bookkeeping: the DISTINCT spokes whose
        # bounds contradicted the CURRENT incumbent of each side
        self._contra: dict[str, list] = {"outer": [], "inner": []}

    # -- the telemetry spine ----------------------------------------------
    def _emit(self, kind: str, **data):
        """Publish one event for this hub's run."""
        self.telemetry.emit(kind, run=self.run_id, cyl="hub",
                            hub_iter=self._iter, **data)

    def _trace_token(self) -> dict:
        """The bus's trace/span ids as set_session_context kwargs."""
        ctx = self.telemetry.trace
        return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}

    def emit_span(self, name: str, dur_s: float):
        """One timed wheel phase (host wall seconds) onto the stream,
        the analyzer's per-phase input.  A span covers launches plus any
        blocking read inside it, so the device wait lands in whichever
        span first reads a result."""
        self._emit(tel.SPAN, name=name, dur_s=dur_s)

    @contextlib.contextmanager
    def _span(self, name: str):
        """Profiler range + SPAN event for one wheel phase."""
        with _prof.annotate(f"wheel/{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.emit_span(name, time.perf_counter() - t0)

    def emit_run_end(self, reason: str, **extra):
        """The run-end record (exit reason + final gap), exactly once:
        finalize() on the normal path, WheelSpinner.spin's unwind for a
        dying wheel ("exception")."""
        if getattr(self, "_run_ended", False):
            return
        self._run_ended = True
        abs_gap, rel_gap = self.compute_gaps()
        self._emit(tel.RUN_END, reason=reason,
                   outer=self.BestOuterBound, inner=self.BestInnerBound,
                   abs_gap=abs_gap, rel_gap=rel_gap,
                   iterations=self._iter, **extra)

    # -- bound bookkeeping (ref:hub.py:207-243) ---------------------------
    # Non-finite values never enter: a NaN outer bound would poison every
    # later max() silently, and a +inf outer would fire gap termination.
    def OuterBoundUpdate(self, new_bound: float, char: str = "*"):
        if math.isfinite(new_bound) and new_bound > self.BestOuterBound:
            self.BestOuterBound = new_bound
            self.latest_ob_char = char
        return self.BestOuterBound

    def InnerBoundUpdate(self, new_bound: float, char: str = "*"):
        if math.isfinite(new_bound) and new_bound < self.BestInnerBound:
            self.BestInnerBound = new_bound
            self.latest_ib_char = char
            self._inner_bound_update_iter = self._iter
        return self.BestInnerBound

    def _validate_bound(self, sense: str, b: float) -> str | None:
        """None when `b` is acceptable, else a rejection reason: non-
        finite, or SENSE-VIOLATING (an outer bound above the incumbent or
        an inner bound below the outer bound) by more than `bound_slack`
        relative (default 5e-3)."""
        if not math.isfinite(b):
            return f"non-finite {sense} bound {b!r}"
        slack = float(self.options.get("bound_slack", 5e-3))
        if sense == "outer" and math.isfinite(self.BestInnerBound):
            lim = self.BestInnerBound \
                + slack * max(1.0, abs(self.BestInnerBound))
            if b > lim:
                return (f"sense-violating outer bound {b:.6g} > "
                        f"inner {self.BestInnerBound:.6g} + slack")
        if sense == "inner" and math.isfinite(self.BestOuterBound):
            lim = self.BestOuterBound \
                - slack * max(1.0, abs(self.BestOuterBound))
            if b < lim:
                return (f"sense-violating inner bound {b:.6g} < "
                        f"outer {self.BestOuterBound:.6g} - slack")
        return None

    # -- gaps + termination (ref:hub.py:82-166) ---------------------------
    def _harvest_dispatch_stats(self):
        """One DISPATCH event of the scheduler's stats, only when MIP
        solves were dispatched since the last one."""
        stats = _dispatch.scheduler_stats()
        if not stats or stats["batches"] == self._last_dispatch_batches:
            return
        self._last_dispatch_batches = stats["batches"]
        self._emit(tel.DISPATCH, **stats)

    def compute_gaps(self) -> tuple[float, float]:
        abs_gap = self.BestInnerBound - self.BestOuterBound
        nano = 1e-10
        if self.BestInnerBound in (math.inf, -math.inf):
            rel_gap = math.inf
        else:
            # reference semantics: divide by |inner|; only when the
            # optimum is near zero fall back to the larger magnitude
            denom = abs(self.BestInnerBound)
            ob = abs(self.BestOuterBound)
            near_zero = denom < 1e-6 * max(1.0, ob if math.isfinite(ob)
                                           else 0.0)
            if near_zero and math.isfinite(ob):
                denom = max(denom, ob)
            rel_gap = abs_gap / max(nano, denom)
        return abs_gap, rel_gap

    def determine_termination(self) -> bool:
        abs_gap, rel_gap = self.compute_gaps()
        opt = self.options
        if "rel_gap" in opt and rel_gap <= opt["rel_gap"]:
            global_toc(f"Terminating: rel_gap {rel_gap:.4e} <= "
                       f"{opt['rel_gap']}", True)
            self._term_reason = "converged"
            return True
        if "abs_gap" in opt and abs_gap <= opt["abs_gap"]:
            global_toc(f"Terminating: abs_gap {abs_gap:.4e} <= "
                       f"{opt['abs_gap']}", True)
            self._term_reason = "converged"
            return True
        if "max_stalled_iters" in opt:
            # the stall budget counts in EXCHANGE rounds
            period = max(1, int(opt.get("spoke_sync_period", 1)))
            if (self._iter - self._inner_bound_update_iter
                    >= opt["max_stalled_iters"] * period
                    and self.BestInnerBound < math.inf):
                global_toc("Terminating: inner bound stalled", True)
                self._term_reason = "stalled"
                return True
        return False

    def is_converged(self) -> bool:
        return self.determine_termination()


class PHHub(Hub):
    """PH as the hub algorithm (ref:cylinders/hub.py:462-573).  `opt` is
    an algos.ph.PH driver; the hub installs itself as `opt.spcomm` so the
    PH loop calls sync()/is_converged() each iteration."""

    def setup_hub(self):
        self.opt.spcomm = self
        for sp in self.spokes:
            sp.make_windows()
        ext = getattr(self.opt, "extobject", None)
        if ext is not None:
            if hasattr(ext, "setup_hub"):
                ext.setup_hub()
            if hasattr(ext, "initialize_spoke_indices"):
                ext.initialize_spoke_indices()

    def _snapshot(self) -> dict:
        """Tensor snapshot for classic spokes (ref:hub.py:517-532)."""
        st = self.opt.state
        batch = self.opt.batch
        return {
            "W": st.W,
            "nonants": batch.nonants(st.solver.x),
            "xbar_scen": st.xbar,
            "xbar_nodes": st.xbar_nodes,
            "iter": self._iter,
            "bounds": (self.BestOuterBound, self.BestInnerBound),
        }

    def _harvest_all(self, only=None):
        """Fold every spoke's latest result into the bound bookkeeping.
        Non-finite bounds count a strike against the producing spoke
        (disabled after `spoke_max_strikes`); sense-violating ones are
        rejected without blame and recorded as contradictions against the
        standing opposite incumbent.  The fault plan's harvest seam
        poisons bounds HERE, between the spoke and the validation."""
        plan = self.options.get("fault_plan")
        max_strikes = int(self.options.get("spoke_max_strikes", 3))
        for j, sp in enumerate(self.spokes):
            if only is not None and sp not in only:
                continue
            if getattr(sp, "disabled", False):
                continue
            b = sp.harvest()
            if b is None:
                continue
            types = sp.converger_spoke_types
            if ConvergerSpokeType.OUTER_BOUND in types:
                sense = "outer"
            elif ConvergerSpokeType.INNER_BOUND in types:
                sense = "inner"
            else:
                continue  # cut/rc providers publish no bound
            self._emit(tel.SPOKE_HARVEST, spoke=j,
                       spoke_class=type(sp).__name__, sense=sense,
                       bound=float(b))
            if plan is not None:
                b = plan.filter_bound(j, sense, float(b), self._iter)
            reason = self._validate_bound(sense, b)
            if reason is not None:
                self._emit(tel.BOUND_REJECT, spoke=j, sense=sense,
                           bound=float(b), reason=reason)
                # scrub the offending value from the spoke's monotone
                # cache, or it would re-offer itself every sync
                if getattr(sp, "bound", None) is not None:
                    sp.bound = None
                if reason.startswith("sense-violating"):
                    self._note_contradiction(sense, sp, reason)
                else:
                    self._strike(j, sp, reason, max_strikes)
                continue
            ch = getattr(sp, "converger_spoke_char",
                         type(sp).__name__[0])
            if sense == "outer":
                before = self.BestOuterBound
                self.OuterBoundUpdate(b, ch)
                improved = self.BestOuterBound > before
            else:
                before = self.BestInnerBound
                self.InnerBoundUpdate(b, ch)
                improved = self.BestInnerBound < before
                # hub-side incumbent cache: BestInnerBound always has a
                # backing solution, even if the spoke is later scrubbed
                if (self.BestInnerBound < before
                        and getattr(sp, "best_xhat", None) is not None):
                    self._best_inner_xhat = sp.best_xhat
            # an accepted bound is consistent with the opposite incumbent
            other = "inner" if sense == "outer" else "outer"
            self._contra[other] = []
            # the view appends (iter, bound) to sp.trace
            self._emit(tel.BOUND_ACCEPT, spoke=j, sense=sense,
                       bound=float(b), char=ch, improved=bool(improved))

    def _strike(self, j: int, sp, reason: str, max_strikes: int):
        """One unambiguously-garbage (non-finite) bound = one strike; K
        strikes disable the spoke."""
        sp.strikes = getattr(sp, "strikes", 0) + 1
        self._emit(tel.SPOKE_STRIKE, spoke=j,
                   spoke_class=type(sp).__name__, reason=reason,
                   strikes=sp.strikes, max_strikes=max_strikes)
        global_toc(f"hub: rejected bound from spoke {j} "
                   f"({type(sp).__name__}): {reason} "
                   f"[strike {sp.strikes}/{max_strikes}]",
                   self.options.get("display_progress", False))
        if sp.strikes >= max_strikes and not getattr(sp, "disabled",
                                                     False):
            sp.disabled = True
            self._emit(tel.SPOKE_DISABLE, spoke=j,
                       spoke_class=type(sp).__name__, strikes=sp.strikes)
            global_toc(f"hub: DISABLED spoke {j} ({type(sp).__name__}) "
                       f"after {sp.strikes} strikes; continuing with "
                       f"the remaining spokes", True)

    def _note_contradiction(self, sense: str, sp, reason: str):
        """A finite sense-violating bound is ambiguous: EITHER it or the
        standing opposite incumbent is garbage.  Contradictions from
        enough DISTINCT spokes (bound_evict_contras, default 3) evict the
        incumbent; one rogue spoke can only log its dissent."""
        global_toc(f"hub: rejected {reason}",
                   self.options.get("display_progress", False))
        other = "outer" if sense == "inner" else "inner"
        rec = self._contra[other]
        if sp not in rec:
            rec.append(sp)
        if len(rec) >= int(self.options.get("bound_evict_contras", 3)):
            self._evict_incumbent(other, rec)

    def _evict_incumbent(self, side: str, contradictors: list):
        """Reset a contradicted incumbent (no strikes, no blame); the
        surviving producers re-establish the bound next exchange."""
        val = self.BestOuterBound if side == "outer" \
            else self.BestInnerBound
        self._emit(tel.BOUND_EVICT, side=side, value=float(val),
                   contradictors=len(contradictors))
        global_toc(f"hub: EVICTING the {side} incumbent ({val:.6g}) — "
                   f"contradicted by {len(contradictors)} distinct "
                   f"spokes", True)
        if side == "outer":
            self.BestOuterBound = -math.inf
            self.latest_ob_char = ""
            # re-fold the hub's own certified trivial bound
            if (getattr(self, "_trivial_bound_folded", False)
                    and getattr(self.opt, "trivial_bound_certified",
                                False)
                    and self.opt.trivial_bound is not None):
                self.OuterBoundUpdate(self.opt.trivial_bound, "T")
        else:
            self.BestInnerBound = math.inf
            self.latest_ib_char = ""
            self._best_inner_xhat = None
            self._inner_bound_update_iter = self._iter
        self._contra[side] = []

    def _fold_own_bounds(self):
        """Fold bounds the hub algorithm itself produces (PH: none — the
        trivial bound enters via is_converged)."""

    def _trace_extra(self) -> dict:
        return {"conv": self.opt._read_conv()}

    def _apply_warm_plane(self, plane: dict):
        """Seed a rolling-horizon window's shifted W/x̄ plane (host numpy
        arrays, mpc/shift.py) into the PH state at the FIRST sync: the
        WXBarReader.post_iter0 timing (iter0 has run, so the seeded duals
        price iteration 1 onward) without the file round-trip;
        mpc/driver.py passes the plane as options['warm_plane'].  A fused
        wheel's wstate gets the same state, as a checkpoint restore keeps
        the two consistent."""
        opt = self.opt
        st = getattr(opt, "state", None)
        if st is None:
            return
        batch = opt.batch

        def t(v):
            return torch.as_tensor(np.asarray(v), dtype=st.W.dtype,
                                   device=st.W.device)
        kw = {}
        if plane.get("W") is not None:
            kw["W"] = t(plane["W"])
        if plane.get("xbar_nodes") is not None:
            xbj = t(plane["xbar_nodes"])
            kw["xbar_nodes"] = xbj
            kw["xbar"] = (
                torch.gather(xbj, 0, batch.node_of_slot)
                if batch.tree.num_nodes > 1
                else xbj[0].expand(st.xbar.shape).clone())
        if not kw:
            return
        new = dataclasses.replace(st, **kw)
        wstate = getattr(opt, "wstate", None)
        if wstate is not None:
            opt.wstate = dataclasses.replace(wstate, ph=new)
        opt.state = new

    def sync(self):
        """One hub<->spoke exchange (fused spokes every iteration,
        classic ones every spoke_sync_period): prologue, exchange,
        epilogue, as one profiler step; the --profile-dir session
        advances first, so a window opens before a step range.  The
        first sync seeds options['warm_plane'] when one is given."""
        self._iter += 1
        if self._iter == 1 and self.options.get("warm_plane") is not None:
            self._apply_warm_plane(self.options["warm_plane"])
        if self._profiler is not None:
            self._profiler.on_sync(self._iter)
        with _prof.step("wheel_sync", self._iter):
            self._sync_body()

    def _sync_body(self):
        self._exchange_pending = True
        self._sync_prologue()
        self._sync_exchange()
        self._exchange_pending = False
        self._sync_epilogue()

    def _sync_prologue(self):
        """Stamp the hub iteration onto the out-of-band emitters (the
        dispatch scheduler, the fault plan); a set options['preempt_event']
        (a migration drain) raises PreemptionError here, at a consistent
        sync boundary; then the fault plan's preemption seam and its lane
        seam (which corrupts the solver state so the PDHG lane guard has
        something real to catch)."""
        if self.options.get("run_id"):
            _dispatch.set_session_context(self.run_id, self._iter,
                                          **self._trace_token())
        _dispatch.set_hub_iter(self._iter)
        drain = self.options.get("preempt_event")
        if drain is not None and drain.is_set():
            from mpisppy_tpu_torch.resilience.faults import PreemptionError
            raise PreemptionError(
                f"migration drain requested at iter {self._iter}")
        plan = self.options.get("fault_plan")
        if plan is not None:
            plan.telemetry_iter = self._iter
            plan.maybe_preempt(self._iter)
            plan.corrupt_lanes(self._iter, self.opt)

    def _sync_exchange(self):
        """The host exchange: harvest -> validate -> publish ->
        checkpoint.  The async hub runs it as its host-complete half
        while the next device step is already queued."""
        period = max(1, int(self.options.get("spoke_sync_period", 1)))
        do_spokes = (self._iter <= 2) or (self._iter % period == 0)
        fused = [sp for sp in self.spokes if getattr(sp, "fused", False)]
        classic = [sp for sp in self.spokes
                   if not getattr(sp, "fused", False)]
        with self._span("harvest"):
            self._harvest_all(only=fused)
            if do_spokes:
                self._harvest_all(only=classic)
        if do_spokes:
            ext = getattr(self.opt, "extobject", None)
            if ext is not None and hasattr(ext, "sync_with_spokes"):
                ext.sync_with_spokes()
        self._fold_own_bounds()
        if (do_spokes and classic) or self.options.get("publish_snapshots"):
            with self._span("hub_sync"):
                payload = self._snapshot()
                self.from_hub.put(payload)
            if do_spokes:
                with self._span("spoke_update"):
                    for sp in classic:
                        if not getattr(sp, "disabled", False):
                            sp.update(payload)
        with self._span("checkpoint"):
            self._maybe_checkpoint()

    def _sync_epilogue(self):
        """Off the critical path: the pipelined kernel-counter harvest,
        dispatch stats, the watchdog beat and the iteration event (the
        trace row)."""
        self._harvest_kernel_counters()
        self._harvest_dispatch_stats()
        abs_gap, rel_gap = self.compute_gaps()
        if self._watchdog is not None:
            self._watchdog.beat(self._iter, self.BestOuterBound,
                                self.BestInnerBound)
        extra = self._trace_extra()
        self._emit(tel.HUB_ITERATION, **{
            "iter": self._iter, **extra,
            "outer": self.BestOuterBound, "inner": self.BestInnerBound,
            "abs_gap": abs_gap, "rel_gap": rel_gap,
            "ob_char": self.latest_ob_char, "ib_char": self.latest_ib_char,
        })
        if self.options.get("display_progress"):
            conv_str = (f" conv {extra['conv']:9.3e}"
                        if "conv" in extra else "")
            global_toc(
                f"iter {self._iter:4d}{conv_str}"
                f" outer {self.BestOuterBound:12.5g}"
                f" inner {self.BestInnerBound:12.5g} rel_gap {rel_gap:8.3e}"
                f" ({self.latest_ob_char}/{self.latest_ib_char})", True)

    # -- kernel counter harvest ------------------------------------------
    def _counter_solvers(self):
        """(label, PDHGState) pairs carrying kernel counters: the hub's
        subproblem solver plus the fused bound planes' warm solvers, each
        plane gated on ITS options' telemetry flag (a plane warm-starts
        from the hub's iter0 solver and may carry counters its own solve
        never updates)."""
        out = []
        st = getattr(self.opt, "state", None)
        solver = getattr(st, "solver", None) if st is not None else None
        if solver is not None:
            out.append(("hub", solver))
        wstate = getattr(self.opt, "wstate", None)
        wopts = getattr(self.opt, "wheel_options", None)
        if wstate is not None and wopts is not None:
            plane_on = {
                "lag": wopts.lag_pdhg.telemetry and wopts.lag_windows,
                "xhat": wopts.xhat_pdhg.telemetry and wopts.xhat_windows,
                "slam": wopts.xhat_pdhg.telemetry and wopts.slam_windows,
                "shuf": wopts.xhat_pdhg.telemetry
                and wopts.shuffle_windows,
            }
            for name, on in plane_on.items():
                s = getattr(wstate, f"{name}_solver", None)
                if on and s is not None:
                    out.append((name, s))
        return [(cyl, s) for cyl, s in out
                if getattr(s, "counters", None) is not None]

    def _harvest_kernel_counters(self, flush: bool = False):
        """Mirror the cumulative per-lane counters into the metrics
        registry and the event stream: one small copy per solver per
        sync (the ring stays on the card), a no-op with telemetry off.
        Pipelined off the critical path: each sync COMPLETES the harvest
        begun the previous sync (its copies have landed) and BEGINS one
        on the current state.  finalize (flush=True) discards the
        pending one-sync-stale harvest and takes one synchronous harvest
        of the final state instead, so the exported totals never
        undercount the run."""
        pending = getattr(self, "_counters_pending", None)
        if pending and not flush:
            for cyl, handle in pending:
                self._fold_counter_harvest(
                    cyl, kcounters.complete_harvest(handle))
        self._counters_pending = [
            (cyl, kcounters.begin_harvest(s, include_ring=False))
            for cyl, s in self._counter_solvers()]
        if flush:
            for cyl, handle in self._counters_pending:
                self._fold_counter_harvest(
                    cyl, kcounters.complete_harvest(handle))
            self._counters_pending = []

    def _fold_counter_harvest(self, cyl: str, h: dict | None):
        if h is None:
            return
        kcounters.fold_into_registry(metrics_mod.REGISTRY, h, cyl=cyl)
        if cyl != "hub":
            return
        guard_total = h["pdhg_guard_resets_total"]
        if guard_total > self._last_guard_total:
            self._emit(tel.LANE_QUARANTINE,
                       resets=guard_total - self._last_guard_total,
                       total=guard_total)
        self._last_guard_total = guard_total
        self._emit(tel.KERNEL_COUNTERS, **h)

    # -- crash-resilient checkpoints --------------------------------------
    def _maybe_checkpoint(self):
        """The checkpoint cadence: every checkpoint_every_iters hub
        iterations (a synchronous save), else every checkpoint_every_s
        wall seconds (default 60) in the background; the first sync only
        starts the clock.  A background save skipped because the
        previous write is still running does not consume its slot."""
        path = self.options.get("checkpoint_path")
        if not path:
            return
        every_it = self.options.get("checkpoint_every_iters")
        if every_it:
            if self._iter > 0 and self._iter % int(every_it) == 0 \
                    and self._iter != getattr(self, "_last_ckpt_iter", -1):
                if self.save_checkpoint(path):
                    self._last_ckpt_iter = self._iter
            return
        every = float(self.options.get("checkpoint_every_s", 60.0))
        now = time.perf_counter()
        last = getattr(self, "_last_ckpt_t", None)
        if last is None:
            self._last_ckpt_t = now
            return
        if now - last < every:
            return
        if self.save_checkpoint(path, background=True):
            self._last_ckpt_t = now

    def save_checkpoint(self, path: str, background: bool = False,
                        tmp_tag: str = ".tmp"):
        """Atomic npz snapshot of the whole wheel: the solver state
        (wstate for FusedPH, else the driver's state), the hub's bound
        bookkeeping, the spokes' bests and the host extras of the
        driver, the spokes and the hub (their checkpoint_extras).

        background=True starts the device-to-host copies of the leaves
        and of the extras' tensors here and leaves every wait (on those
        copies and on the fused wheel's scalar copy in flight), the
        checksum, the write and the rotation to a daemon thread, so the
        hub does not drain the step pipeline; at most one background
        save is in flight (a later request is skipped, not queued).
        Returns True when a write launched (or, synchronous, completed),
        False when skipped — _maybe_checkpoint's cadence depends on it."""
        st = getattr(self.opt, "wstate", None)
        which = "wstate" if st is not None else "state"
        if st is None:
            st = self.opt.state
        if st is None:
            return False  # preempted before Iter0: nothing to persist
        # created here (on the hub thread) so the two possible writers,
        # the background daemon and a later emergency save, share one
        # lock without a creation race
        if not hasattr(self, "_ckpt_lock"):
            self._ckpt_lock = threading.Lock()
        if background:
            prev = getattr(self, "_ckpt_thread", None)
            if prev is not None and prev.is_alive():
                return False
        meta = self._checkpoint_meta(which)
        # tensors start their copies now; copies already in flight (a
        # HostCopy) are read by the writer
        late = {k: meta.pop(k) for k in list(meta)
                if isinstance(meta[k], (torch.Tensor, HostCopy))}
        tensors = {f"leaf{i}": wxbarutils.leaf_tensor(x)
                   for i, x in enumerate(wxbarutils.state_leaves(st))}
        tensors.update((k, v) for k, v in late.items()
                       if isinstance(v, torch.Tensor))
        pending = (list(tensors), HostCopy(list(tensors.values())),
                   {k: v for k, v in late.items()
                    if isinstance(v, HostCopy)})
        if background:
            t = threading.Thread(target=self._write_checkpoint,
                                 args=(path, pending, meta, tmp_tag),
                                 daemon=True)
            self._ckpt_thread = t
            t.start()
            return True
        self._write_checkpoint(path, pending, meta, tmp_tag)
        return True

    def emergency_checkpoint(self, path: str) -> bool:
        """Synchronous last-gasp save for SIGTERM/SIGINT/preemption or a
        watchdog abort.  It does not wait for an in-flight background
        write (that could outlast the eviction grace window); its own
        tmp name keeps the two writers off each other's staging file,
        and if the older background snapshot lands after it, ours
        rotates to path.1 and load_checkpoint still picks the newest by
        hub_iter.  Best effort: a failure is logged and reported False.
        Returns True when a snapshot landed."""
        try:
            return self.save_checkpoint(path, background=False,
                                        tmp_tag=".emergency.tmp")
        except Exception as e:  # noqa: BLE001 — last-gasp, logged
            global_toc(f"emergency checkpoint failed ({e}); "
                       "falling back to last rotated snapshot", True)
            return False

    def _checkpoint_meta(self, which: str) -> dict:
        """Host-side bookkeeping, captured synchronously (the mutable
        bits) in the JAX package's keys and dtypes.  Device tensors and
        host copies in flight are left as they are, for save_checkpoint
        to read without waiting on the card here."""
        data = {}
        data["which"] = np.frombuffer(which.encode(), np.uint8)
        data["hub_iter"] = np.asarray(self._iter)
        data["opt_iter"] = np.asarray(self.opt._iter)
        data["bounds"] = np.asarray([self.BestOuterBound,
                                     self.BestInnerBound])
        data["ib_update_iter"] = np.asarray(self._inner_bound_update_iter)
        tb = self.opt.trivial_bound
        data["trivial"] = np.asarray([
            np.nan if tb is None else tb,
            1.0 if self.opt.trivial_bound_certified else 0.0,
            1.0 if getattr(self, "_trivial_bound_folded", False) else 0.0])
        for j, sp in enumerate(self.spokes):
            if sp.bound is not None:
                data[f"spoke{j}_bound"] = np.asarray(sp.bound)
                bx = getattr(sp, "best_xhat", None)
                if bx is not None:
                    data[f"spoke{j}_xhat"] = _unread(bx)
        bx = getattr(self, "_best_inner_xhat", None)
        if bx is not None:
            data["hub_best_xhat"] = _unread(bx)
        # the driver's and the spokes' host state (FusedPH's step cycle),
        # as extras of the same format; the JAX package returns them to
        # its caller and ignores them
        for prefix, owner in self._extra_owners():
            fn = getattr(owner, "checkpoint_extras", None)
            if fn is not None:
                for k, v in fn().items():
                    data[f"extra_{prefix}{k}"] = _unread(v)
        return data

    def _extra_owners(self):
        """(key prefix, object) of every owner of checkpoint extras, in
        restore order: the driver and the spokes before the hub, whose
        restore may harvest them."""
        return [("", self.opt)] + [
            (f"spoke{j}_", sp) for j, sp in enumerate(self.spokes)] + [
            ("hub_", self)]

    def checkpoint_extras(self) -> dict:
        """The chars of the latest bound updates (trace rows carry them)
        and whether the current sync's exchange is still to run (a
        preemption in the prologue), so the restore can run its fused
        harvest."""
        return {"chars": np.frombuffer(
                    f"{self.latest_ob_char}|{self.latest_ib_char}".encode(),
                    np.uint8),
                "exchange_pending": np.asarray(
                    int(getattr(self, "_exchange_pending", False)),
                    np.int64)}

    def restore_extras(self, extras: dict) -> None:
        """A snapshot taken before its sync's exchange: fold the fused
        spokes' pending results now (the driver restored the scalar cache
        that exchange would have read), stamped with that sync's
        iteration — the uninterrupted wheel's bookkeeping."""
        if "chars" in extras:
            self.latest_ob_char, self.latest_ib_char = \
                bytes(extras["chars"]).decode().split("|")
        if int(extras.get("exchange_pending", 0)) \
                and getattr(self.opt, "scalar_cache", None) is not None:
            self._harvest_all(only=[sp for sp in self.spokes
                                    if getattr(sp, "fused", False)])

    def _write_checkpoint(self, path: str, pending: tuple, data: dict,
                          tmp_tag: str = ".tmp"):
        """Atomic rotated write: the leaves and a CRC32 over every array
        into path+tmp_tag, then, under the shared writer lock, rotate
        path -> path.1 -> ... (checkpoint_keep slots, at least 2) and
        rename the tmp file to path, then fsync the directory.
        `pending` is save_checkpoint's (keys, HostCopy of their tensors,
        {key: HostCopy in flight}); its waits happen here."""
        keys, copy, inflight = pending
        data.update(zip(keys, copy.values()))
        for k, hc in inflight.items():
            data[k] = hc.values()[0]
        data["crc"] = _checkpoint_crc(data)
        tmp = path + tmp_tag
        with open(tmp, "wb") as f:
            np.savez(f, **data)
        # without the lock the background daemon could rename its OLDER
        # tmp over a just-landed emergency snapshot without rotating it
        lock = getattr(self, "_ckpt_lock", None) or threading.Lock()
        with lock:
            # a floor of 2 slots: with one, a slow background write
            # finishing after an emergency save would clobber it
            keep = max(2, int(self.options.get("checkpoint_keep", 2)))
            for i in range(keep - 1, 0, -1):
                src = path if i == 1 else f"{path}.{i - 1}"
                try:
                    if os.path.exists(src):
                        os.replace(src, f"{path}.{i}")
                except OSError:
                    # a stolen rotation slot is harmless: every complete
                    # snapshot validates itself
                    pass
            os.replace(tmp, path)
            atomic_io.fsync_dir(path)
        # may run on the daemon: the bus is thread-safe, and the
        # snapshot's own hub_iter stamps the event
        self.telemetry.emit(
            tel.CHECKPOINT_WRITE, run=self.run_id, cyl="hub",
            hub_iter=int(data["hub_iter"]), path=path,
            bytes=os.path.getsize(path))
        metrics_mod.REGISTRY.inc("checkpoint_writes_total")
        plan = self.options.get("fault_plan")
        if plan is not None:
            plan.on_checkpoint_written(path)

    def _checkpoint_candidates(self, path: str) -> list[str]:
        """Existing snapshots, newest name first: path, path.1, ..."""
        out = [path] if os.path.exists(path) else []
        i = 1
        while os.path.exists(f"{path}.{i}"):
            out.append(f"{path}.{i}")
            i += 1
        return out

    def load_checkpoint(self, path: str) -> dict:
        """Restore a snapshot (this package's or the JAX package's) into
        the built, unspun wheel; ph_main then skips Iter0 and resumes the
        loop.  Returns the extras dict.  The newest VALID snapshot wins:
        candidates are ordered by the hub_iter stored in each (an
        emergency save racing a slow background write can leave the
        older snapshot at `path`), and a torn, corrupt or incompatible
        one falls back to the next."""
        order = []
        for i, cand in enumerate(self._checkpoint_candidates(path)):
            try:  # cheap lazy read of one meta scalar, no validation
                with np.load(cand) as d:
                    it = int(d["hub_iter"])
            except Exception:
                it = -1  # unreadable here: full validation gets it last
            order.append((it, -i, cand))
        order.sort(reverse=True)
        errors = []
        for _, _, cand in order:
            try:
                arrays = self._read_checkpoint_arrays(cand)
            except Exception as e:  # torn zip, bad crc, IO error, ...
                errors.append(f"{cand}: {type(e).__name__}: {e}")
                continue
            try:
                extras = self._restore_from_arrays(arrays)
            except ValueError as e:  # wrong shapes/dtypes/leaf count
                errors.append(f"{cand}: {e}")
                continue
            if cand != path:
                global_toc(f"checkpoint: {path} invalid, restored the "
                           f"older rotated snapshot {cand}", True)
            self._emit(tel.CHECKPOINT_RESTORE, path=cand,
                       fallback=cand != path)
            return extras
        detail = "; ".join(errors) if errors else "no snapshot files"
        raise FileNotFoundError(
            f"no valid checkpoint under {path!r}: {detail}")

    def _read_checkpoint_arrays(self, path: str) -> dict:
        """Load and integrity-check one snapshot file (no state
        change)."""
        with np.load(path) as data:
            arrays = {k: np.asarray(data[k]) for k in data.files}
        if "crc" in arrays:
            stored = int(arrays.pop("crc"))
            actual = int(_checkpoint_crc(arrays))
            if actual != stored:
                raise ValueError(
                    f"checksum mismatch (stored {stored:#x}, "
                    f"recomputed {actual:#x})")
        if "which" not in arrays:
            raise ValueError("not a wheel checkpoint (missing 'which')")
        return arrays

    def _restore_from_arrays(self, data: dict) -> dict:
        which = bytes(data["which"]).decode()
        template = self.opt.state_template()
        wxbarutils.validate_state_leaves(
            data, wxbarutils.leaf_specs(template))
        n = len(wxbarutils.state_leaves(template))
        st = wxbarutils.state_from_leaves(
            template, [data[f"leaf{i}"] for i in range(n)],
            self.opt.batch.device)
        if which == "wstate":
            self.opt.wstate = st
            self.opt.state = st.ph
        else:
            self.opt.state = st
        self._iter = int(data["hub_iter"])
        self.opt._iter = int(data["opt_iter"])
        ob, ib = [float(v) for v in data["bounds"]]
        self.BestOuterBound, self.BestInnerBound = ob, ib
        self._inner_bound_update_iter = int(data["ib_update_iter"])
        tb, cert, folded = [float(v) for v in data["trivial"]]
        self.opt.trivial_bound = None if math.isnan(tb) else tb
        self.opt.trivial_bound_certified = bool(cert)
        self._trivial_bound_folded = bool(folded)
        if "hub_best_xhat" in data:
            self._best_inner_xhat = np.asarray(data["hub_best_xhat"])
        # re-baseline the quarantine delta: the restored solver carries
        # its cumulative guard_resets, which must not re-report as fresh
        solver = getattr(self.opt.state, "solver", None)
        if solver is not None:
            self._last_guard_total = int(solver.guard_resets.sum())
        for j, sp in enumerate(self.spokes):
            key = f"spoke{j}_bound"
            if key in data:
                sp.bound = float(data[key])
                if f"spoke{j}_xhat" in data:
                    sp.best_xhat = np.asarray(data[f"spoke{j}_xhat"])
        extras = {k[len("extra_"):]: data[k] for k in data
                  if k.startswith("extra_")}
        for prefix, owner in self._extra_owners():
            fn = getattr(owner, "restore_extras", None)
            if fn is not None:
                fn({k[len(prefix):]: v for k, v in extras.items()
                    if k.startswith(prefix)})
        return extras

    def is_converged(self) -> bool:
        # the PH trivial bound is the initial outer bound (ref:hub.py:544)
        # — only when its dual-residual certificate held
        if (self.opt.trivial_bound is not None
                and not getattr(self, "_trivial_bound_folded", False)
                and getattr(self.opt, "trivial_bound_certified", False)):
            self._trivial_bound_folded = True
            self.OuterBoundUpdate(self.opt.trivial_bound, "T")
        return self.determine_termination()

    def main(self):
        """ref:cylinders/hub.py:571-573."""
        return self.opt.ph_main()

    def finalize(self):
        # the run is terminating on purpose: the watchdog must not trip
        # on the finalization work
        if self._watchdog is not None:
            self._watchdog.stop()
        # one last harvest so late results count; fused drivers first
        # sync their pipelined scalar cache to the final iterate
        if hasattr(self.opt, "flush_scalars"):
            self.opt.flush_scalars()
        self._harvest_all()
        # settle an in-flight background checkpoint write, so the file
        # on disk is complete before the caller reads or deletes it
        t = getattr(self, "_ckpt_thread", None)
        if t is not None and t.is_alive():
            t.join()
        if self._profiler is not None:
            self._profiler.close()
        # final totals after the last iterk: the exported totals equal
        # the device state's exactly
        self._harvest_kernel_counters(flush=True)
        self.emit_run_end(getattr(self, "_term_reason", None)
                          or "max-iter")
        return self.BestInnerBound

    def hub_finalize(self):
        abs_gap, rel_gap = self.compute_gaps()
        global_toc(f"Final bounds: outer {self.BestOuterBound:.6g} "
                   f"inner {self.BestInnerBound:.6g} rel_gap {rel_gap:.3e}",
                   self.options.get("display_progress", False))

    # -- solution access --------------------------------------------------
    def best_nonants(self):
        """(num_nodes, N) numpy nonants of the solution that achieved
        BestInnerBound (ref:spin_the_wheel.py:171-195); falls back to the
        final xbar when no incumbent exists."""
        winner, best = None, math.inf
        for sp in self.spokes:
            if (ConvergerSpokeType.INNER_BOUND in sp.converger_spoke_types
                    and not getattr(sp, "disabled", False)
                    and sp.bound is not None and math.isfinite(sp.bound)
                    and sp.bound < best
                    and self._validate_bound("inner", sp.bound) is None
                    and getattr(sp, "best_xhat", None) is not None):
                winner, best = sp, sp.bound
        xhat = None
        if winner is not None:
            xhat = np.asarray(winner.best_xhat)
        elif getattr(self, "_best_inner_xhat", None) is not None:
            xhat = np.asarray(self._best_inner_xhat)
        if xhat is not None:
            if xhat.ndim == 1:
                num_nodes = self.opt.batch.tree.num_nodes
                return np.broadcast_to(xhat, (num_nodes, xhat.shape[0]))
            return xhat
        return self._fallback_nonants()

    def _fallback_nonants(self) -> np.ndarray:
        return self.opt.state.xbar_nodes.cpu().numpy()


class AsyncPHHub(PHHub):
    """Asynchronous exchange hub (port of the JAX package's AsyncPHHub).
    Pair with algos.async_wheel.AsyncFusedPH.

    At staleness s >= 1 every sync splits into a device-issue half
    (iteration stamps, fault seams, the driver's plane-write events —
    while the just-launched step runs) and a host-complete half
    (settle the previous iteration's plane tickets, harvest -> validate
    -> publish, against scalars the depth-2 pipeline already landed),
    and emits one exchange-overlap event per sync.  s = 0 routes every
    sync through PHHub's body: trajectories and trace events equal a
    plain PHHub wheel's."""

    def _async_staleness(self) -> int:
        """The driver's AsyncWheelOptions are the one source of truth
        (the driver owns the delay line); options['async_staleness'] is
        only the CLI's mirror, and a contradictory mirror raises."""
        aopts = getattr(self.opt, "async_options", None)
        drv = None if aopts is None else int(aopts.staleness)
        mirror = self.options.get("async_staleness")
        if drv is not None and mirror is not None and int(mirror) != drv:
            raise ValueError(
                f"async_staleness mismatch: hub options carry "
                f"{int(mirror)} but the driver's AsyncWheelOptions "
                f"carry {drv} — set one (the driver's is "
                f"authoritative)")
        if drv is not None:
            return drv
        return int(mirror or 0)

    def _sync_body(self):
        staleness = self._async_staleness()
        if staleness <= 0:
            return super()._sync_body()
        t0 = time.perf_counter()
        self._exchange_pending = True
        with self._span("exchange_issue"):
            self._sync_prologue()
            plan = self.options.get("fault_plan")
            # the driver recorded its plane writes while launching this
            # iteration; stamp them onto the stream here (it has no bus)
            for evd in getattr(self.opt, "take_plane_events",
                               lambda: [])():
                self._emit(tel.PLANE_WRITE, **evd)
                metrics_mod.REGISTRY.inc("async_plane_writes_total")
                metrics_mod.REGISTRY.set_gauge(
                    "async_plane_staleness",
                    float(evd.get("staleness", 0)))
        t1 = time.perf_counter()
        with self._span("exchange_complete"):
            if plan is not None:
                # a slow host harvest (AsyncExchangeFault) — the wedged
                # exchange the watchdog must still catch
                plan.before_harvest(self._iter)
            # settle the PREVIOUS iteration's plane tickets (a late one
            # raises SolveFailed('deadline'), never a silent hang)
            if hasattr(self.opt, "result_exchange"):
                self.opt.result_exchange()
            self._sync_exchange()
        self._exchange_pending = False
        t2 = time.perf_counter()
        self._sync_epilogue()
        theta = getattr(self.opt, "last_theta", None)
        self._emit(tel.EXCHANGE_OVERLAP,
                   staleness=staleness,
                   issue_s=round(t1 - t0, 6),
                   complete_s=round(t2 - t1, 6),
                   **({} if theta is None else {"theta": float(theta)}))


class APHHub(PHHub):
    """APH as the hub algorithm (ref:mpisppy/cylinders/hub.py:712-724):
    PHHub's exchange surface (W and nonants out, bounds in) with APH's
    conv and theta in the trace rows."""

    def _trace_extra(self) -> dict:
        return {"conv": float(self.opt.state.conv),
                "theta": float(self.opt.state.theta)}

    def main(self):
        """ref:cylinders/hub.py:722-724."""
        return self.opt.APH_main()


class LShapedHub(PHHub):
    """L-shaped (Benders) as the hub algorithm
    (ref:mpisppy/cylinders/hub.py:618-710): it sends only NONANTS (the
    master's current candidate) to spokes — no W exists — and folds the
    Benders lb/ub into the bound bookkeeping."""

    def setup_hub(self):
        self.opt.spcomm = self
        for sp in self.spokes:
            if ConvergerSpokeType.W_GETTER in sp.converger_spoke_types:
                raise RuntimeError(
                    "LShapedHub cannot feed W-getter spokes "
                    "(ref:hub.py:618-710 sends nonants only)")
            sp.make_windows()

    def _snapshot(self) -> dict:
        ls = self.opt  # an algos.lshaped.LShapedMethod
        batch = ls.batch
        xhat = torch.as_tensor(ls.xhat, dtype=batch.qp.c.dtype,
                               device=batch.device)
        S = batch.num_scenarios
        return {
            "nonants": torch.broadcast_to(xhat, (S, xhat.shape[0])),
            "xbar_scen": torch.broadcast_to(xhat, (S, xhat.shape[0])),
            "xbar_nodes": xhat[None, :],
            "iter": self._iter,
            "bounds": (self.BestOuterBound, self.BestInnerBound),
        }

    def _fold_own_bounds(self):
        # the hub algorithm itself produces both bounds
        self.OuterBoundUpdate(self.opt.lb, "B")
        if np.isfinite(self.opt.ub):
            self.InnerBoundUpdate(self.opt.ub, "B")

    def _trace_extra(self) -> dict:
        return {}

    def _counter_solvers(self):
        """The latest subproblem solve's counters (--kernel-counters arms
        sub_pdhg): each Benders iteration's solve starts them at zero,
        so a lane's count is its iterations in that solve.  The JAX
        package's L-shaped hub arms and harvests none."""
        st = self.opt.sub_state
        if st is None or st.counters is None:
            return []
        return [("hub", st)]

    def is_converged(self) -> bool:
        return self.determine_termination()

    def main(self):
        return self.opt.lshaped_algorithm()

    def _fallback_nonants(self) -> np.ndarray:
        return np.asarray(self.opt.xhat)[None, :]
