###############################################################################
# SolveScheduler: coalescing queue + bounded in-flight dispatch (port of
# mpisppy_tpu/dispatch/scheduler.py).
#
# Every host-driven MIP solve (algos/mip.py oracle loops, decomposition-
# B&B node solves) routes through one of these instead of calling
# ops.bnb.solve_mip directly:
#
#   * ADMISSION (coalescing windows).  Requests are keyed by their
#     mergeable identity — (n, m), dtype, A storage/identity, integer
#     signature, BnBOptions — and same-key requests land in one open
#     WINDOW.  A window dispatches when it reaches max_batch lanes, when
#     max_wait_ms passes, or the moment a caller blocks on one of its
#     tickets.  Dispatch concatenates the window's requests along the
#     batch axis into one MEGABATCH solve and splits the result back.
#   * BACKPRESSURE.  A semaphore of max_inflight outstanding dispatches
#     gates every window; windows keep accumulating requests while their
#     dispatching thread waits on it.
#   * SHAPE DISCIPLINE.  Megabatches pad up the geometric ladder
#     (buckets.py); each padded shape signature is registered, and a
#     CompileWatch (compilewatch.py: kernel-library builds and first-seen
#     signatures) attributes compiles — one against an already-warm
#     signature counts as unexpected (and raises under compile_guard).
#   * FAULT DOMAIN.  Tickets may carry a deadline and result() takes a
#     timeout: a caller never blocks past the earlier of the two (expiry
#     raises SolveFailed('deadline')).  A dispatch may carry a timeout
#     (dispatch_timeout_s); a hung or raising dispatch is retried with
#     exponential backoff up to retry_max, then BISECTED by lanes until
#     the poison request is isolated and QUARANTINED (its ticket raises
#     SolveFailed, the others proceed).  A dead dispatcher daemon fails
#     every queued ticket fast (SolveFailed('dispatcher-died')), and the
#     next submit restarts it.  The compile guard's AssertionError is
#     never retried.
#
# Threads and CUDA: the dispatcher daemon (and a dispatch-timeout worker)
# launches work on tensors made on the caller's thread; every thread
# uses the device's default stream, as torch does unless told otherwise,
# so the launches stay ordered.  A hung CUDA call cannot be cancelled: a
# dispatch timeout abandons its worker thread, as in the reference.
#
# Observability and chaos: every counter is also mirrored into the
# process metrics REGISTRY (telemetry/metrics.py, the JAX package's
# dispatch_* names), and with a bus each megabatch lands as a DISPATCH
# event (retries, quarantines, dispatcher deaths and plane-ticket misses
# as their own kinds).  `fault_plan` (resilience.FaultPlan, armed by
# tests and by the hub when its options carry one) fires the
# before_dispatch / drop_ticket / maybe_kill_dispatcher seams on the
# host dispatch path.
###############################################################################
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from mpisppy_tpu_torch.dispatch import buckets as _buckets
from mpisppy_tpu_torch.dispatch import compilewatch as _cw
from mpisppy_tpu_torch.telemetry import metrics as _metrics

# -- hub-iteration stamp and the per-session context token ------------------
# The hub calls set_hub_iter at every sync; a session's hub installs a
# thread-local DispatchContext (run id + hub iter) on its driver thread,
# and submit() captures the submitting thread's token per request, so a
# megabatch can be attributed to the sessions that rode it.
_hub_iter = -1
_ctx_local = threading.local()


@dataclasses.dataclass(frozen=True)
class DispatchContext:
    """One session's dispatch stamp: its run id, its current hub
    iteration (-1 pre-wheel) and its trace/span ids."""

    run: str = ""
    hub_iter: int = -1
    trace_id: str = ""
    span_id: str = ""


def set_session_context(run: str, hub_iter: int = -1,
                        trace_id: str = "", span_id: str = "") -> None:
    """Install the calling thread's session token."""
    _ctx_local.ctx = DispatchContext(run=str(run), hub_iter=int(hub_iter),
                                     trace_id=str(trace_id or ""),
                                     span_id=str(span_id or ""))


def clear_session_context() -> None:
    _ctx_local.ctx = None


def current_context() -> DispatchContext:
    """The submitting thread's token; falls back to the process-global
    hub-iteration stamp."""
    ctx = getattr(_ctx_local, "ctx", None)
    return ctx if ctx is not None else DispatchContext(hub_iter=_hub_iter)


def set_hub_iter(it: int) -> None:
    global _hub_iter
    _hub_iter = int(it)
    # a thread that carries a session token advances it in lockstep
    ctx = getattr(_ctx_local, "ctx", None)
    if ctx is not None:
        _ctx_local.ctx = dataclasses.replace(ctx, hub_iter=int(it))


def current_hub_iter() -> int:
    return _hub_iter


@dataclasses.dataclass(frozen=True)
class DispatchOptions:
    """Scheduler knobs (CLI: the --dispatch-* group, utils/config.py)."""

    coalesce: bool = True        # merge same-key requests into megabatches
    max_batch: int = 4096        # lane cap per megabatch dispatch
    max_wait_ms: float = 2.0     # admission window for async submits
    max_inflight: int = 2        # outstanding dispatches (double buffer)
    pad_batch: bool = True       # pad megabatches up the bucket ladder
    bucket_growth: float = 2.0   # geometric ladder growth factor
    compile_guard: bool = False  # raise on a warm-signature recompile
    dispatch_timeout_s: float | None = None  # per-attempt solve timeout
    retry_max: int = 2           # retries per request set before bisecting
    retry_backoff_s: float = 0.05  # base backoff, doubled per retry
    deadline_s: float | None = None  # default per-ticket deadline


class SolveFailed(RuntimeError):
    """Typed terminal outcome of a failed solve request.

    reason: 'deadline'         ticket deadline / result(timeout) expired
            'timeout'          every attempt hit dispatch_timeout_s
            'exception'        every attempt raised (`detail` holds the
                               last error)
            'dispatcher-died'  the dispatcher daemon died with this
                               request queued
    attempts counts the solve attempts the request rode in; lanes is its
    batch size (the quarantine accounting unit)."""

    def __init__(self, reason: str, detail: str = "", attempts: int = 0,
                 lanes: int = 0):
        self.reason = reason
        self.detail = detail
        self.attempts = attempts
        self.lanes = lanes
        super().__init__(
            f"solve failed ({reason}"
            + (f" after {attempts} attempt(s)" if attempts else "")
            + (f"): {detail}" if detail else ")"))


class _DispatchTimeout(RuntimeError):
    """Internal: one dispatch attempt exceeded dispatch_timeout_s."""


class SolveTicket:
    """Future for one submitted solve; result() blocks (and, when the
    owning window is still open, dispatches it — inline on the caller's
    thread for unbounded waits, through the dispatcher daemon when a
    deadline/timeout bounds the wait)."""

    def __init__(self, scheduler, window, lanes: int = 0,
                 deadline: float | None = None, sid: int = -1):
        self._scheduler = scheduler
        self._window = window
        self._event = threading.Event()
        self._result = None
        self._exc = None
        self._lanes = lanes
        self._deadline = deadline     # absolute perf_counter stamp
        self.sid = sid                # scheduler-assigned submit id

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """Block for the result.  A live ticket deadline and `timeout`
        (seconds) each bound the wait — past the earlier one this raises
        SolveFailed('deadline').  After the deadline has expired, a bare
        result() keeps raising, but an explicit timeout grants a fresh
        recovery wait and a call after the solve lands returns it.  A
        quarantined/failed request raises its SolveFailed."""
        if not self._event.is_set():
            now = time.perf_counter()
            expired = self._deadline is not None \
                and self._deadline <= now
            if expired and timeout is None:
                raise SolveFailed(
                    "deadline", lanes=self._lanes,
                    detail="ticket deadline expired with the solve "
                           "still outstanding")
            bound = None if timeout is None else now + timeout
            if self._deadline is not None and not expired:
                bound = self._deadline if bound is None \
                    else min(bound, self._deadline)
            if bound is None:
                self._scheduler._drive(self._window, cause="inline")
                self._event.wait()
            else:
                self._scheduler._expedite(self._window)
                if not self._event.wait(
                        max(0.0, bound - time.perf_counter())):
                    raise SolveFailed(
                        "deadline", lanes=self._lanes,
                        detail="ticket deadline/timeout expired with "
                               "the solve still outstanding")
        if self._exc is not None:
            raise self._exc
        return self._result


def _tensors(value):
    """The tensors in a value (a tensor, a dataclass of tensors, or a
    list/tuple/dict of those)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        value = [getattr(value, f.name) for f in dataclasses.fields(value)]
    elif isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


class PlaneTicket:
    """Fire-and-forget future over one asynchronous plane dispatch (the
    async wheel's exchange programs).  `fn` already ran at submit_plane:
    its CUDA work is queued on the stream and `value` holds its tensors;
    a CUDA event recorded after it marks readiness.  result(timeout=) is
    a bounded readiness wait: past the earlier of the ticket deadline
    and the explicit timeout it raises SolveFailed('deadline')."""

    def __init__(self, scheduler, value, label: str = "plane",
                 deadline: float | None = None):
        self._scheduler = scheduler
        self.value = value
        self.label = label
        self._deadline = deadline     # absolute perf_counter stamp
        self._ready = None
        if any(t.is_cuda for t in _tensors(value)):
            self._ready = torch.cuda.Event()
            self._ready.record()

    def done(self) -> bool:
        """Readiness probe (no blocking)."""
        return self._ready is None or self._ready.query()

    def _landed(self):
        try:
            if self._ready is not None:
                self._ready.synchronize()
        except Exception as e:
            raise SolveFailed(
                "exception",
                detail=f"plane ticket {self.label!r} dispatch "
                       f"failed: {e!r}") from e
        return self.value

    def result(self, timeout: float | None = None):
        """Block until the dispatched tensors are ready, bounded by the
        earlier of the live ticket deadline and `timeout` (SolveTicket's
        expired-deadline semantics)."""
        now = time.perf_counter()
        expired = self._deadline is not None and self._deadline <= now
        bound = None if timeout is None else now + float(timeout)
        if self._deadline is not None and not expired:
            bound = self._deadline if bound is None \
                else min(bound, self._deadline)
        if (bound is None and not expired) or self.done():
            return self._landed()
        if bound is None:
            self._scheduler._note_plane_miss(self.label)
            raise SolveFailed(
                "deadline",
                detail=f"plane ticket {self.label!r} deadline expired "
                       f"with the dispatch still outstanding")
        done = threading.Event()
        err: list = []

        def waiter():
            try:
                self._landed()
            except Exception as e:   # typed below, on the caller thread
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=waiter, daemon=True,
                         name="mpisppy-torch-plane-wait").start()
        if not done.wait(max(0.0, bound - time.perf_counter())):
            if not self.done():
                self._scheduler._note_plane_miss(self.label)
                raise SolveFailed(
                    "deadline",
                    detail=f"plane ticket {self.label!r} still not "
                           f"ready at its deadline")
            return self._landed()
        if err:
            raise err[0]
        return self.value


class _Window:
    """One open coalescing window for a key: requests accumulate until
    the window is claimed by a dispatching thread and frozen."""

    __slots__ = ("key", "reqs", "tickets", "t0", "claimed", "frozen",
                 "due", "cause")

    def __init__(self, key):
        self.key = key
        # (qp, d_col, int_cols, opts, kwargs, sid, ctx) per request
        self.reqs: list = []
        self.tickets: list = []
        self.t0 = time.perf_counter()
        self.claimed = False
        self.frozen = False
        self.due = False          # a bounded result() wait expedites
        self.cause = "timer"      # why the window dispatched (stats)


def _lanes(req) -> int:
    return int(req[0].c.shape[0])


def _host_ints(int_cols) -> np.ndarray:
    if isinstance(int_cols, torch.Tensor):
        return int_cols.detach().cpu().numpy()
    return np.asarray(int_cols)


class SolveScheduler:
    """See the module header.  `solve_fn` is injectable (tests drive
    the queue with fake solves); the default is ops.bnb.solve_mip."""

    def __init__(self, options: DispatchOptions = DispatchOptions(),
                 solve_fn=None, bus=None, run: str = "",
                 fault_plan=None):
        if solve_fn is None:
            from mpisppy_tpu_torch.ops import bnb as _bnb
            solve_fn = _bnb.solve_mip
        self.options = options
        self.solve_fn = solve_fn
        self.bus = bus
        self.run = run
        self.fault_plan = fault_plan
        self.ladder = _buckets.BucketLadder(options.bucket_growth)
        # every field marked `guarded-by: _lock` is touched only under
        # the lock (or _wake, a Condition over it)
        self._lock = threading.Lock()
        self._sem = threading.Semaphore(max(1, options.max_inflight))
        self._pending: dict = {}          # guarded-by: _lock
        self._watch = _cw.CompileWatch()
        self._dispatcher = None           # guarded-by: _lock
        self._wake = threading.Condition(self._lock)
        self._closed = False              # guarded-by: _lock
        self._degraded = False            # guarded-by: _lock
        self._next_sid = 0                # guarded-by: _lock
        self._attempts = 0                # guarded-by: _lock
        self._buckets: dict = {}          # guarded-by: _lock
        self._inflight = 0                # guarded-by: _lock
        self._inflight_max = 0            # guarded-by: _lock
        self._batches = 0                 # guarded-by: _lock
        self._lanes = 0                   # guarded-by: _lock
        self._pad_lanes = 0               # guarded-by: _lock
        self._coalesced_lanes = 0         # guarded-by: _lock
        self._unexpected_recompiles = 0   # guarded-by: _lock
        self._dispatch_compiles = 0       # guarded-by: _lock
        self._retries = 0                 # guarded-by: _lock
        self._quarantined_lanes = 0       # guarded-by: _lock
        self._quarantined_requests = 0    # guarded-by: _lock
        self._dispatcher_deaths = 0       # guarded-by: _lock
        self._plane_tickets = 0           # guarded-by: _lock
        self._plane_deadline_misses = 0   # guarded-by: _lock
        # why windows dispatched: timer, size, inline, expedite,
        # overflow, close
        self._by_cause: dict = {}         # guarded-by: _lock
        # per-coalesce-key occupancy and the sessions that shared it
        self._by_key: dict = {}           # guarded-by: _lock

    # -- public API -------------------------------------------------------
    def solve_mip(self, qp, d_col, int_cols, opts=None, **kwargs):
        """Synchronous solve through the scheduler: bucket-padded and
        coalesced with whatever compatible requests are already queued
        (a lone caller dispatches immediately)."""
        return self.submit(qp, d_col, int_cols, opts, **kwargs).result()

    def submit(self, qp, d_col, int_cols, opts=None,
               deadline_s: float | None = None, **kwargs) -> SolveTicket:
        """Enqueue one solve; returns a ticket.  Same-key submits
        coalesce into one megabatch dispatch; the first result() call
        drives it.  `deadline_s` (default: options.deadline_s) bounds
        how long result() may ever block on this ticket."""
        if opts is None:
            from mpisppy_tpu_torch.ops.bnb import BnBOptions
            opts = BnBOptions()
        S = int(qp.c.shape[0])
        key = self._request_key(qp, d_col, int_cols, opts, kwargs)
        if deadline_s is None:
            deadline_s = self.options.deadline_s
        deadline = None if deadline_s is None \
            else time.perf_counter() + float(deadline_s)
        overflow = None
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            win = self._pending.get(key)
            lanes = sum(_lanes(r) for r in win.reqs) if win else 0
            if (win is None or win.frozen
                    or not self.options.coalesce
                    or lanes + S > self.options.max_batch):
                # an OPEN window displaced by the lane cap would be
                # orphaned: this thread dispatches it below
                if win is not None and not win.frozen \
                        and not win.claimed:
                    overflow = win
                win = _Window(key)
                self._pending[key] = win
            sid = self._next_sid
            self._next_sid += 1
            ticket = SolveTicket(self, win, lanes=S, deadline=deadline,
                                 sid=sid)
            win.reqs.append((qp, d_col, int_cols, opts, kwargs, sid,
                             current_context()))
            win.tickets.append(ticket)
            full = sum(_lanes(r) for r in win.reqs) >= self.options.max_batch
            if not full:
                self._ensure_dispatcher()
            self._wake.notify_all()
        # full/overflow windows dispatch on THIS thread, unless a
        # deadline with no dispatch timeout would pin it inside an
        # unbounded solve: then the dispatcher takes them
        inline_ok = deadline is None \
            or self.options.dispatch_timeout_s is not None
        if overflow is not None:
            if inline_ok:
                self._drive(overflow, cause="overflow")
            else:
                self._expedite(overflow)
        if full:
            if inline_ok:
                self._drive(win, cause="size")
            else:
                self._expedite(win)
        return ticket

    def submit_plane(self, fn, *args, label: str = "plane",
                     deadline_s: float | None = None,
                     **kwargs) -> PlaneTicket:
        """Fire-and-forget ticket over one asynchronous plane dispatch:
        `fn` runs INLINE (its CUDA work is queued, not awaited);
        `deadline_s` bounds any later result() wait."""
        value = fn(*args, **kwargs)
        deadline = None if deadline_s is None \
            else time.perf_counter() + float(deadline_s)
        with self._lock:
            self._plane_tickets += 1
        _metrics.REGISTRY.inc("dispatch_plane_tickets_total")
        return PlaneTicket(self, value, label=label, deadline=deadline)

    def _note_plane_miss(self, label: str) -> None:
        """A plane ticket's bounded wait expired (from whichever thread
        timed it out)."""
        with self._lock:
            self._plane_deadline_misses += 1
        _metrics.REGISTRY.inc("dispatch_plane_deadline_misses_total")
        self._emit_event("watchdog", component="exchange",
                         action="deadline", label=label)

    def stats(self) -> dict:
        """Point-in-time snapshot of the scheduler's counters."""
        with self._lock:
            lanes = max(1, self._lanes + self._pad_lanes)
            return {
                "batches": self._batches,
                "lanes": self._lanes,
                "pad_lanes": self._pad_lanes,
                "coalesced_lanes": self._coalesced_lanes,
                "occupancy": self._lanes / lanes,
                "buckets": len(self._buckets),
                # compile events observed while a dispatch executed
                # (CompileWatch.total() is the process total)
                "backend_compiles": self._dispatch_compiles,
                "unexpected_recompiles": self._unexpected_recompiles,
                "inflight_max": self._inflight_max,
                "queue_depth": sum(len(w.reqs)
                                   for w in self._pending.values()),
                "retries_total": self._retries,
                "quarantined_lanes": self._quarantined_lanes,
                "quarantined_requests": self._quarantined_requests,
                "dispatcher_deaths": self._dispatcher_deaths,
                "plane_tickets": self._plane_tickets,
                "plane_deadline_misses": self._plane_deadline_misses,
                "degraded": self._degraded,
                "by_cause": dict(self._by_cause),
                "by_key": {
                    label: {
                        "batches": a["batches"],
                        "lanes": a["lanes"],
                        "pad_lanes": a["pad_lanes"],
                        "coalesced_lanes": a["coalesced_lanes"],
                        "occupancy": round(
                            a["lanes"] / max(1, a["lanes"]
                                             + a["pad_lanes"]), 4),
                        "sessions": len(a["runs"]),
                    } for label, a in self._by_key.items()},
            }

    def degrade(self) -> None:
        """Drop to direct, un-coalesced dispatch (every later submit
        dispatches solo); shape padding stays on."""
        with self._lock:
            self.options = dataclasses.replace(self.options,
                                               coalesce=False)
            self._degraded = True

    def close(self):
        """Flush every open window and stop the dispatcher thread."""
        with self._lock:
            self._closed = True
            wins = [w for w in self._pending.values() if not w.claimed]
            self._wake.notify_all()
        for w in wins:
            self._drive(w, cause="close")
        with self._lock:
            t = self._dispatcher
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    # -- request identity -------------------------------------------------
    def _request_key(self, qp, d_col, int_cols, opts, kwargs) -> tuple:
        """Mergeable identity.  Batched per-lane fields concatenate
        freely; SHARED structure (a broadcast A, the ELL column index
        tensor, a ConeSpec) must be the same object across a window (a
        miss only costs coalescence, never correctness).  Requests with
        kwargs never coalesce (a warm start is per-request state)."""
        A = qp.A
        if hasattr(A, "vals"):
            a_id = ("ell", id(A.cols),
                    None if A.vals.ndim == 3 else id(A.vals))
        else:
            a_id = ("dense", None if A.ndim == 3 else id(A))
        cones = getattr(qp, "cones", None)
        shared = tuple(
            None if getattr(f, "ndim", 0) == nd else id(f)
            for f, nd in ((qp.c, 2), (qp.q, 2), (qp.bl, 2), (qp.bu, 2),
                          (qp.l, 2), (qp.u, 2), (d_col, 2)))
        ints = _host_ints(int_cols)
        return (qp.n, qp.m, str(qp.c.dtype), str(qp.c.device), a_id,
                shared, None if cones is None else id(cones),
                ints.shape, hash(ints.tobytes()), opts,
                ("solo", id(kwargs)) if kwargs else ())

    # -- dispatch machinery -----------------------------------------------
    def _ensure_dispatcher(self):        # holds-lock: _lock
        """Lazy daemon that fires windows whose admission timer lapsed
        (callers that block in result() drive their own windows)."""
        if self._dispatcher is not None and self._dispatcher.is_alive():
            return
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="mpisppy-torch-dispatch")
        self._dispatcher.start()

    def _dispatch_loop(self):
        """Supervised daemon body: any escape fails every queued ticket
        fast instead of leaving it to wait on a dead thread."""
        try:
            self._dispatch_loop_inner()
        except BaseException as e:  # noqa: BLE001 — the supervisor seam
            self._on_dispatcher_death(e)

    def _dispatch_loop_inner(self):
        wait_s = max(self.options.max_wait_ms, 0.1) / 1e3
        while True:
            plan = self.fault_plan
            if plan is not None:
                plan.maybe_kill_dispatcher()
            with self._lock:
                now = time.perf_counter()
                open_w = [w for w in self._pending.values()
                          if not w.claimed]
                due = [w for w in open_w
                       if w.due or now - w.t0 >= wait_s]
                if not due:
                    if self._closed:
                        return
                    if open_w:
                        deadline = min(w.t0 + wait_s for w in open_w)
                        self._wake.wait(timeout=max(deadline - now, 1e-4))
                    else:
                        self._wake.wait()
                    continue
            for w in due:
                self._drive(w, cause="expedite" if w.due else "timer")

    def _on_dispatcher_death(self, exc: BaseException):
        """Every ticket still queued in an unclaimed window resolves with
        SolveFailed('dispatcher-died') now, and the queue empties."""
        with self._lock:
            wins = [w for w in self._pending.values() if not w.claimed]
            for w in wins:
                w.claimed = True
                w.frozen = True
            self._pending = {}
            self._dispatcher_deaths += 1
        failed = 0
        for w in wins:
            for t in w.tickets:
                if not t.done():
                    t._exc = SolveFailed(
                        "dispatcher-died", lanes=t._lanes,
                        detail=f"{type(exc).__name__}: {exc}")
                    t._event.set()
                    failed += 1
        _metrics.REGISTRY.inc("dispatch_dispatcher_deaths_total")
        self._emit_event(
            "watchdog", component="dispatcher", action="fail-fast",
            failed_tickets=failed,
            error=f"{type(exc).__name__}: {exc}")

    def _expedite(self, win: _Window):
        """Mark the window due and wake the dispatcher."""
        with self._lock:
            if win.claimed:
                return
            win.due = True
            self._ensure_dispatcher()
            self._wake.notify_all()

    def _drive(self, win: _Window, cause: str = "inline"):
        """Claim-and-run a window; loses the race gracefully when
        another thread got there first."""
        with self._lock:
            if win.claimed:
                return
            win.claimed = True
            win.cause = cause
        try:
            self._run_window(win)
        except BaseException as e:  # noqa: BLE001 — fanned out below
            with self._lock:
                win.frozen = True
                if self._pending.get(win.key) is win:
                    del self._pending[win.key]
            for t in win.tickets:
                if not t.done():
                    t._exc = e
                    t._event.set()
            raise

    def _run_window(self, win: _Window):
        # backpressure FIRST: while this thread waits on the semaphore
        # the window is still open and keeps accumulating requests
        self._sem.acquire()
        try:
            with self._lock:
                win.frozen = True
                if self._pending.get(win.key) is win:
                    del self._pending[win.key]
                reqs = list(win.reqs)
                tickets = list(win.tickets)
                self._inflight += 1
                self._inflight_max = max(self._inflight_max,
                                         self._inflight)
                _metrics.REGISTRY.set_gauge("dispatch_inflight",
                                            self._inflight)
            t_launch = time.perf_counter()
            self._solve_recover(win, reqs, tickets, t_launch)
        finally:
            with self._lock:
                self._inflight -= 1
                _metrics.REGISTRY.set_gauge("dispatch_inflight",
                                            self._inflight)
            self._sem.release()

    def _solve_recover(self, win: _Window, reqs, tickets,
                       t_launch: float, bisected: bool = False):
        """Solve this request set with retry + exponential backoff; a
        set still failing after its budget BISECTS by lanes (each half
        with a fresh budget); a single request that still fails is
        QUARANTINED.  The compile guard's AssertionError (and
        KeyboardInterrupt/SystemExit) propagate immediately."""
        last: BaseException | None = None
        attempts = 0
        for attempt in range(max(0, self.options.retry_max) + 1):
            if attempt:
                backoff = self.options.retry_backoff_s * (2 ** (attempt - 1))
                self._retry_note(reqs, attempt, last, backoff)
                time.sleep(backoff)
            attempts += 1
            try:
                res, sizes, S_pad, sig = self._solve_merged(reqs)
            except AssertionError:
                raise          # the compile guard must stay loud
            except Exception as e:  # noqa: BLE001 — the retryable class
                last = e
                continue
            self._deliver(reqs, tickets, res, sizes)
            self._record(win, reqs, sizes, S_pad, sig, t_launch)
            return
        if len(reqs) > 1:
            mid = _buckets.balanced_split([_lanes(r) for r in reqs])
            self._solve_recover(win, reqs[:mid], tickets[:mid], t_launch,
                                True)
            self._solve_recover(win, reqs[mid:], tickets[mid:], t_launch,
                                True)
            return
        self._quarantine(reqs[0], tickets[0], attempts, last, bisected)

    def _solve_attempt(self, reqs, qp, d_col, int_cols, opts, kwargs):
        """One bounded solve attempt: with dispatch_timeout_s set the
        solve runs on a worker thread and a hang becomes a typed
        _DispatchTimeout after the budget (the abandoned worker runs on
        until its device work returns).  The fault plan's seam runs
        INSIDE the attempt, so an injected hang consumes the timeout
        exactly like a real one."""
        with self._lock:
            idx = self._attempts
            self._attempts += 1
        plan = self.fault_plan

        def run():
            if plan is not None:
                plan.before_dispatch(idx, [r[5] for r in reqs])
            return self.solve_fn(qp, d_col, int_cols, opts, **kwargs)

        timeout = self.options.dispatch_timeout_s
        if timeout is None:
            return run()
        box: dict = {}
        done = threading.Event()

        def worker():
            try:
                box["res"] = run()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["exc"] = e
            finally:
                done.set()

        threading.Thread(target=worker, daemon=True,
                         name="mpisppy-torch-dispatch-solve").start()
        if not done.wait(float(timeout)):
            raise _DispatchTimeout(
                f"dispatch exceeded its {timeout}s timeout")
        if "exc" in box:
            raise box["exc"]
        return box["res"]

    def _deliver(self, reqs, tickets, res, sizes):
        off = 0
        plan = self.fault_plan
        for t, S, r in zip(tickets, sizes, reqs):
            if plan is not None and plan.drop_ticket(r[5]):
                # injected result loss: the ticket stays unresolved and
                # its deadline turns the would-be hang into SolveFailed
                off += S
                continue
            # per-request slices exclude the pad lanes (they sit past
            # the last real lane)
            t._result = _buckets._map_leading(
                res, lambda a, o=off, s=S: a[o:o + s])
            t._event.set()
            off += S

    def _retry_note(self, reqs, attempt: int, exc: BaseException | None,
                    backoff_s: float):
        with self._lock:
            self._retries += 1
        _metrics.REGISTRY.inc("dispatch_retries_total")
        self._emit_event(
            "dispatch-retry", attempt=attempt, requests=len(reqs),
            lanes=sum(_lanes(r) for r in reqs), backoff_s=backoff_s,
            error="" if exc is None else f"{type(exc).__name__}: {exc}")

    def _quarantine(self, req, ticket, attempts: int,
                    exc: BaseException | None, bisected: bool = False):
        """Terminal isolation of one poisoned request: its ticket
        resolves with SolveFailed and its lanes are accounted."""
        lanes = _lanes(req)
        reason = "timeout" if isinstance(exc, _DispatchTimeout) \
            else "exception"
        detail = "" if exc is None else f"{type(exc).__name__}: {exc}"
        with self._lock:
            self._quarantined_lanes += lanes
            self._quarantined_requests += 1
        _metrics.REGISTRY.inc("dispatch_quarantined_lanes_total", lanes)
        _metrics.REGISTRY.inc("dispatch_quarantined_requests_total")
        self._emit_event(
            "dispatch-quarantine", submit=req[5], lanes=lanes,
            attempts=attempts, reason=reason, bisected=bisected,
            error=detail)
        if not ticket.done():
            ticket._exc = SolveFailed(reason, detail=detail,
                                      attempts=attempts, lanes=lanes)
            ticket._event.set()

    def _emit_event(self, kind: str, **data):
        if self.bus is None:
            return
        self.bus.emit(kind, run=self.run, cyl="dispatch",
                      hub_iter=_hub_iter, **data)

    def _solve_merged(self, reqs):
        """Concatenate the window's requests, pad up the ladder, solve.
        Returns (result, per-request sizes, padded lane count, shape
        signature)."""
        sizes = [_lanes(r) for r in reqs]
        S_tot = sum(sizes)
        qp, d_col = self._merge(reqs) if len(reqs) > 1 \
            else (reqs[0][0], reqs[0][1])
        int_cols, opts, kwargs = reqs[0][2], reqs[0][3], reqs[0][4]
        S_pad = self.ladder.bucket(S_tot) if self.options.pad_batch \
            else S_tot
        S_pad = max(S_pad, S_tot)
        qp, d_col = _buckets.pad_qp_batch(qp, d_col, S_pad)
        if S_pad > S_tot and kwargs:
            # per-lane kwargs (x_warm/y_warm) ride the same padding
            kwargs = {k: _buckets.pad_leading_rows(v, S_tot, S_pad)
                      for k, v in kwargs.items()}
        sig = _buckets.shape_signature(qp, d_col) + (opts,)
        with self._lock:
            warm = sig in self._buckets
        before = self._watch.total()
        _cw.note_signature(sig)
        res = self._solve_attempt(reqs, qp, d_col, int_cols, opts, kwargs)
        compiled = self._watch.total() - before
        with self._lock:
            self._dispatch_compiles += compiled
            solo = self._inflight == 1
        if warm and compiled and solo:
            # advisory: compile events from another thread can land in
            # the window too — compile_guard is the strict mode
            with self._lock:
                self._unexpected_recompiles += compiled
            _metrics.REGISTRY.inc("dispatch_unexpected_recompiles_total",
                                  compiled)
            if self.options.compile_guard:
                raise AssertionError(
                    f"compile-cache discipline violated: {compiled} "
                    f"compile event(s) against warm bucket {sig[:3]} "
                    "(run without --dispatch-compile-guard if this "
                    "workload legitimately builds kernels mid-run)")
        with self._lock:
            self._buckets[sig] = self._buckets.get(sig, 0) + 1
        return res, sizes, S_pad, sig

    def _merge(self, reqs):
        """One megabatch BoxQP from same-key requests: batched fields
        concatenate along the lane axis, shared fields (same object by
        key construction) pass through; a field shared in one request
        but batched in another broadcasts before the concat."""
        qps = [r[0] for r in reqs]
        d_cols = [r[1] for r in reqs]
        sizes = [_lanes(r) for r in reqs]

        def cat(fields, batched_ndim):
            if all(getattr(f, "ndim", 0) < batched_ndim for f in fields) \
                    and all(f is fields[0] for f in fields):
                return fields[0]
            return torch.cat(
                [f.expand((s,) + tuple(f.shape[-(batched_ndim - 1):]))
                 if f.ndim < batched_ndim else f
                 for f, s in zip(fields, sizes)], dim=0)

        A0 = qps[0].A
        if hasattr(A0, "vals"):
            A = A0.with_vals(torch.cat([q.A.vals for q in qps], dim=0)) \
                if A0.vals.ndim == 3 else A0
        elif A0.ndim == 3:
            A = torch.cat([q.A for q in qps], dim=0)
        else:
            A = A0      # shared dense A: the key guarantees identity
        qp = dataclasses.replace(
            qps[0],
            c=cat([q.c for q in qps], 2), q=cat([q.q for q in qps], 2),
            A=A,
            bl=cat([q.bl for q in qps], 2), bu=cat([q.bu for q in qps], 2),
            l=cat([q.l for q in qps], 2), u=cat([q.u for q in qps], 2))
        return qp, cat(d_cols, 2)

    def _key_label(self, win: _Window) -> str:
        """Compact label of a coalesce key for the by_key breakdown."""
        n, m, dtype = win.key[0], win.key[1], win.key[2]
        digest = abs(hash(win.key)) & 0xFFFF
        return f"n{n}m{m}:{dtype.replace('torch.', '')}:k{digest:04x}"

    def _session_breakdown(self, reqs, sizes) -> list[dict]:
        """Per-session (run, iter, lanes) aggregation of a megabatch's
        requests from their captured DispatchContext tokens."""
        agg: dict[tuple, dict] = {}
        for r, S in zip(reqs, sizes):
            ctx = r[6]
            a = agg.setdefault((ctx.run, ctx.hub_iter),
                               {"run": ctx.run, "iter": ctx.hub_iter,
                                "lanes": 0, "requests": 0})
            a["lanes"] += S
            a["requests"] += 1
            if ctx.trace_id and "trace_id" not in a:
                a["trace_id"] = ctx.trace_id
                a["span_id"] = ctx.span_id
        return list(agg.values())

    def _record(self, win: _Window, reqs, sizes, S_pad: int, sig,
                t_launch: float):
        real = sum(sizes)
        occ = real / max(1, S_pad)
        sessions = self._session_breakdown(reqs, sizes)
        runs = {s["run"] for s in sessions}
        key_label = self._key_label(win)
        with self._lock:
            self._batches += 1
            self._lanes += real
            self._pad_lanes += S_pad - real
            if len(sizes) > 1:
                self._coalesced_lanes += real
            self._by_cause[win.cause] = \
                self._by_cause.get(win.cause, 0) + 1
            bk = self._by_key.setdefault(
                key_label, {"batches": 0, "lanes": 0, "pad_lanes": 0,
                            "coalesced_lanes": 0, "runs": set()})
            bk["batches"] += 1
            bk["lanes"] += real
            bk["pad_lanes"] += S_pad - real
            if len(sizes) > 1:
                bk["coalesced_lanes"] += real
            bk["runs"].update(runs)
            queue_depth = sum(len(w.reqs) for w in self._pending.values())
            n_buckets = len(self._buckets)
            dispatch_compiles = self._dispatch_compiles
            inflight_max = self._inflight_max
        R = _metrics.REGISTRY
        R.inc("dispatch_batches_total")
        R.inc("dispatch_lanes_total", real)
        R.inc("dispatch_pad_lanes_total", S_pad - real)
        R.set_gauge("dispatch_batch_occupancy", occ)
        R.set_gauge("dispatch_queue_depth", queue_depth)
        R.set_gauge("dispatch_buckets_active", n_buckets)
        R.set_counter("dispatch_backend_compiles_total", dispatch_compiles)
        if self.bus is not None:
            from mpisppy_tpu_torch import telemetry as tel
            # one riding session: the event joins that session's
            # timeline; a mixed batch keeps the scheduler's run with the
            # per-session breakdown carrying the attribution
            ev_run, ev_iter, ev_trace = self.run, _hub_iter, None
            if len(sessions) == 1 and sessions[0]["run"]:
                ev_run = sessions[0]["run"]
                ev_iter = sessions[0]["iter"]
                ctx0 = reqs[0][6]
                ev_trace = ctx0 if ctx0.trace_id else None
            self.bus.emit(
                tel.DISPATCH, run=ev_run, cyl="dispatch",
                hub_iter=ev_iter, trace=ev_trace,
                requests=len(sizes), lanes=real, padded_to=S_pad,
                occupancy=occ, bucket=list(sig[:3]), key=key_label,
                wait_ms=1e3 * (t_launch - win.t0),
                queue_depth=queue_depth, cause=win.cause,
                inflight_max=inflight_max,
                **({"sessions": sessions}
                   if any(s["run"] for s in sessions)
                   and (len(runs) > 1 or runs != {self.run}) else {}))


# -- the process-default scheduler ------------------------------------------
_default_lock = threading.Lock()
_default: SolveScheduler | None = None


def get_scheduler(create: bool = True) -> SolveScheduler | None:
    """The process-default scheduler every library call site routes
    through; created lazily with default options on first use."""
    global _default
    with _default_lock:
        if _default is None and create:
            _default = SolveScheduler()
        return _default


def configure(options: DispatchOptions | None = None, bus=None,
              run: str = "") -> SolveScheduler:
    """(Re)build the process-default scheduler (the CLI calls this off
    the --dispatch-* group).  Any previous default is flushed first, and
    the calling thread's session token and the hub-iteration stamp are
    reset (a fresh scheduler means a fresh run)."""
    global _default
    with _default_lock:
        old, _default = _default, None
    if old is not None:
        old.close()
    clear_session_context()
    set_hub_iter(-1)
    sched = SolveScheduler(options or DispatchOptions(), bus=bus, run=run)
    with _default_lock:
        _default = sched
    return sched


def from_cfg(cfg, bus=None, run: str = "") -> SolveScheduler:
    """Build + install the default scheduler from the dispatch_args
    Config group (utils/config.py)."""
    timeout = cfg.get("dispatch_timeout_s")
    deadline = cfg.get("dispatch_deadline_s")
    return configure(DispatchOptions(
        coalesce=bool(cfg.get("dispatch_coalesce", True)),
        max_batch=int(cfg.get("dispatch_max_batch", 4096)),
        max_wait_ms=float(cfg.get("dispatch_max_wait_ms", 2.0)),
        max_inflight=int(cfg.get("dispatch_max_inflight", 2)),
        pad_batch=bool(cfg.get("dispatch_pad", True)),
        bucket_growth=float(cfg.get("dispatch_bucket_growth", 2.0)),
        compile_guard=bool(cfg.get("dispatch_compile_guard", False)),
        dispatch_timeout_s=None if timeout is None else float(timeout),
        retry_max=int(cfg.get("dispatch_retry_max", 2)),
        retry_backoff_s=float(cfg.get("dispatch_retry_backoff_s", 0.05)),
        deadline_s=None if deadline is None else float(deadline),
    ), bus=bus, run=run)


def solve_mip(qp, d_col, int_cols, opts=None, **kwargs):
    """One solve through the process-default scheduler (the drop-in for
    ops.bnb.solve_mip at every oracle call site)."""
    return get_scheduler().solve_mip(qp, d_col, int_cols, opts, **kwargs)


def scheduler_stats() -> dict | None:
    """stats() of the default scheduler, None when none exists yet."""
    sched = get_scheduler(create=False)
    return None if sched is None else sched.stats()
