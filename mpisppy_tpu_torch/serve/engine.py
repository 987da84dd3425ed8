###############################################################################
# Session solve engines (port of mpisppy_tpu/serve/engine.py;
# docs/serving.md).
#
# WheelEngine turns one admitted session into one cylinder wheel built
# through the SAME recipe surface the CLI uses (generic_cylinders
# build_wheel over a parsed Config) — a serve session is exactly a
# `python -m mpisppy_tpu_torch --fused-wheel --lagrangian --xhatxbar`
# run with the session's model/scale/gap substituted, plus the
# serve-layer wiring:
#
#   * the wheel runs on the ENGINE's device (the server's: CUDA unless
#     it was started with --device cpu): `--device <dev>` is appended
#     after the client's args, so the last --device, the engine's, wins;
#   * the session's scoped telemetry bus becomes the hub's bus (every
#     wheel event lands in session-<sid>.jsonl and streams to the
#     client);
#   * the session's run id becomes the hub run id (one run per trace);
#   * the batch's shared structure is INTERNED (serve/multiplex.py) so
#     equal-structure sessions coalesce their oracle dispatches into
#     shared megabatches;
#   * with multiplexing on, the wheel runs the async hub with
#     the server's ExchangeRing gating the host-complete half — one
#     device stream advances several tenants between host exchanges;
#   * a checkpoint path under the server spool makes the session
#     preemption-safe: a SimulatedPreemption (or real SIGTERM relayed
#     as PreemptionError) returns a 'preempted' verdict after the
#     emergency save, and the re-admitted session restores and resumes
#     with no client-visible state loss.
#
# SyntheticEngine is the load/chaos test double: the same outcome
# surface and fault seams without device work, so admission fairness
# and storm invariants test in milliseconds.
###############################################################################
from __future__ import annotations

import importlib
import os
import time

from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.resilience.faults import PreemptionError
from mpisppy_tpu_torch.serve import multiplex
from mpisppy_tpu_torch.serve.protocol import MODELS, SubmitRequest


#: per-model argv defaults keeping serve sessions small enough for a
#: shared wheel (clients override via SubmitRequest.args, which parse
#: LAST and win)
_MODEL_ARGS = {
    "farmer": ("--default-rho", "1.0"),
    # the synthetic 5x25 instance, LP-relaxed, at rho 20 (the headline
    # sslp recipe scaled to an interactive session)
    "sslp": ("--sslp-lp-relax", "--default-rho", "20.0"),
    "uc": ("--uc-n-gens", "3", "--uc-n-hours", "6",
           "--slammax", "--sensi-rho", "--subproblem-windows", "10"),
    # 3-stage OPF on the default (3, 3) tree; clients opt into the
    # conic branch-flow mode with --soc in their args
    "ccopf": (),
}


def session_argv(spec: SubmitRequest, multiplexed: bool = False,
                 device: str = "cuda") -> list:
    """The generic_cylinders argv a session's spec translates to: the
    JAX package's with the port's model module, then `--device
    <device>` after the client's args."""
    argv = [
        "--module-name", MODELS[spec.model],
        "--num-scens", str(spec.num_scens),
        "--fused-wheel",
        "--lagrangian", "--xhatxbar",
        "--rel-gap", str(spec.gap_target),
        "--max-iterations", str(spec.max_iterations),
        "--flight-recorder", "false",
    ]
    if multiplexed:
        argv += ["--async-staleness", "1"]
    argv += list(_MODEL_ARGS.get(spec.model, ()))
    argv += list(spec.args)
    argv += ["--device", str(device)]
    return argv


class WheelEngine:
    """The production engine: one fused wheel per session."""

    def __init__(self, multiplexed: bool = True,
                 interner: multiplex.StructureInterner | None = None,
                 checkpoint_every_s: float = 30.0, device: str = "cuda"):
        self.multiplexed = multiplexed
        self.interner = interner or multiplex.default_interner()
        self.checkpoint_every_s = checkpoint_every_s
        self.device = str(device)

    def _build(self, session, ring, fault_plan):
        from mpisppy_tpu_torch import generic_cylinders as gc
        spec = session.spec
        module = importlib.import_module(MODELS[spec.model])
        try:
            cfg = gc._parse_args(module, session_argv(
                spec, self.multiplexed, self.device))
        except SystemExit as e:
            # argparse exits on unknown/malformed session args — that
            # is a BaseException, which would skip the worker's typed
            # settle and leave the client hanging; type it instead
            raise ValueError(
                f"bad session args {list(spec.args)!r}: {e}") from e
        hub, spokes, names, specs, batch = gc.build_wheel(cfg, module)
        hub = dict(hub)
        opt_kwargs = dict(hub.get("opt_kwargs", {}))
        if opt_kwargs.get("batch") is not None:
            # cross-session coalescing: equal shared structure interned
            # to one object so the scheduler's identity keys match
            opt_kwargs["batch"] = multiplex.intern_batch(
                opt_kwargs["batch"], self.interner)
        hub["opt_kwargs"] = opt_kwargs
        hub["hub_kwargs"] = dict(hub.get("hub_kwargs", {}))
        hub_opts = dict(hub["hub_kwargs"].get("options", {}))
        hub_opts["run_id"] = session.run_id
        hub_opts["telemetry_bus"] = session.bus
        if session.checkpoint_path:
            hub_opts["checkpoint_path"] = session.checkpoint_path
            hub_opts["checkpoint_every_s"] = self.checkpoint_every_s
        # live-migration drain: the hub checks this event at
        # every sync prologue and raises PreemptionError (emergency
        # checkpoint) when the fleet router asks the session to move
        hub_opts["preempt_event"] = session.preempt_event
        if fault_plan is not None:
            hub_opts["fault_plan"] = fault_plan
        if self.multiplexed:
            hub["hub_class"] = multiplex.make_multiplexed_hub_class()
            if ring is not None:
                hub_opts["exchange_ring"] = ring
        hub["hub_kwargs"]["options"] = hub_opts
        return hub, spokes

    def run(self, session, ring=None, fault_plan=None) -> tuple:
        """Solve one session.  Returns ('done', payload) or
        ('preempted', payload); raises on a failed solve (the server
        types it for the client)."""
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        if getattr(session, "streaming", False):
            # rolling-horizon MPC stream: one long-lived
            # session, one wheel per window, per-step protocol lines +
            # per-step WFQ charging + its own stream checkpoint
            from mpisppy_tpu_torch.mpc.stream import run_stream
            return run_stream(session, fault_plan=fault_plan,
                              device=self.device)
        if fault_plan is not None:
            # serve chaos seams: an injected hang consumes the session
            # deadline, an injected poison surfaces as a typed failure
            fault_plan.serve_before_solve(session.tenant,
                                          session.ordinal)
        hub, spokes = self._build(session, ring, fault_plan)
        wheel = WheelSpinner(hub, spokes)
        wheel.build()
        if session.restore and session.checkpoint_path \
                and wheel.spcomm._checkpoint_candidates(
                    session.checkpoint_path):
            wheel.spcomm.load_checkpoint(session.checkpoint_path)
        t0 = time.perf_counter()
        try:
            wheel.spin()
        except PreemptionError as e:
            # WheelSpinner.spin already wrote the emergency snapshot;
            # the server re-admits the session with restore=True
            return "preempted", {"iter": wheel.spcomm._iter,
                                 "detail": str(e)}
        abs_gap, rel_gap = wheel.spcomm.compute_gaps()
        if session.checkpoint_path:
            for cand in wheel.spcomm._checkpoint_candidates(
                    session.checkpoint_path):
                try:
                    os.remove(cand)
                except OSError:
                    pass
        return "done", {
            "outer": float(wheel.BestOuterBound),
            "inner": float(wheel.BestInnerBound),
            "rel_gap": float(rel_gap),
            "iterations": wheel.spcomm._iter,
            "solve_seconds": round(time.perf_counter() - t0, 4),
            "preemptions": session.preemptions,
        }


class SyntheticEngine:
    """Deterministic test double: emits the same event stream shape
    (run-start, hub-iteration rows with a closing gap, run-end) and
    honors the serve fault seams, in ~iters*step_s wall seconds.  A
    `preempt_at` map {(tenant, ordinal): iter} simulates preemption
    with checkpoint-free resume (the resumed session continues from
    the recorded iteration).  The resume cursor lives ON the session
    (session.resume_iter), so a fleet-migrated session resumes
    correctly even on a DIFFERENT engine instance — the synthetic
    analogue of the checkpoint travelling through the shared spool."""

    def __init__(self, iters: int = 6, step_s: float = 0.005,
                 preempt_at: dict | None = None):
        self.iters = iters
        self.step_s = step_s
        self.preempt_at = dict(preempt_at or {})

    def run(self, session, ring=None, fault_plan=None) -> tuple:
        if fault_plan is not None:
            fault_plan.serve_before_solve(session.tenant,
                                          session.ordinal)
        key = (session.tenant, session.ordinal)
        start = session.resume_iter
        if start == 0:
            session.bus.emit(tel.RUN_START, run=session.run_id,
                             cyl="hub", hub_class="SyntheticEngine",
                             num_spokes=0)
        gap0 = 0.20
        target = session.spec.gap_target
        for it in range(start + 1, self.iters + 1):
            if session.preempt_event.is_set():
                # migration drain: stop at the iteration boundary, the
                # synthetic stand-in for the emergency checkpoint
                session.resume_iter = it - 1
                return "preempted", {"iter": it - 1,
                                     "detail": "drain-requested"}
            time.sleep(self.step_s)
            frac = it / self.iters
            rel_gap = gap0 * (1.0 - frac) + target * 0.5 * frac
            session.bus.emit(
                tel.HUB_ITERATION, run=session.run_id, cyl="hub",
                hub_iter=it, iter=it, outer=-100.0 - rel_gap * 100.0,
                inner=-100.0, abs_gap=rel_gap * 100.0,
                rel_gap=rel_gap)
            if self.preempt_at.get(key) == it:
                del self.preempt_at[key]     # fire once
                session.resume_iter = it
                return "preempted", {"iter": it, "detail": "synthetic"}
        session.bus.emit(tel.RUN_END, run=session.run_id, cyl="hub",
                         hub_iter=self.iters, reason="converged",
                         outer=-100.05, inner=-100.0, abs_gap=0.05,
                         rel_gap=target * 0.5, iterations=self.iters)
        return "done", {
            "outer": -100.05, "inner": -100.0,
            "rel_gap": float(target * 0.5),
            "iterations": self.iters,
            "solve_seconds": round(
                (self.iters - start) * self.step_s, 4),
            "preemptions": session.preemptions,
        }
