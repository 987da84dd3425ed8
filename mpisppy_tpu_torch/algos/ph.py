###############################################################################
# Progressive Hedging (port of mpisppy_tpu/algos/ph.py).
#
# One PH step is tensor math over the scenario batch:
#
#   x_non   = gather nonants from the batched PDHG iterates   (S, N)
#   xbar    = node_average(x_non)           <- the Allreduce analog
#   W      += rho * (x_non - xbar)          (ref:phbase.py:301-326)
#   conv    = E[ ||x_non - xbar||_1 ] / N   (ref:phbase.py:349-371)
#   qp_eff  = base qp + W·x + rho/2 (x - xbar)^2 on nonant slots
#   solver  = solve_fixed(qp_eff, n_windows) warm-started
#
# Iter0 solves WITHOUT W/prox and seeds W = rho(x - xbar)
# (ref:phbase.py:829-946); the trivial bound is the dual-certified
# wait-and-see expectation E[min f_s] (ref:spopt.py:377).
###############################################################################
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.core.batch import ScenarioBatch, concretize
from mpisppy_tpu_torch.ops import boxqp, pdhg
from mpisppy_tpu_torch.telemetry import profiler as _prof

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PHOptions:
    """PH options (ref Config group ph_args,
    ref:mpisppy/utils/config.py:250-315)."""

    default_rho: float = 1.0
    max_iterations: int = 100
    conv_thresh: float = 1e-4          # ref 'convthresh'
    subproblem_windows: int = 8        # PDHG restart windows per PH iter
    iter0_windows: int = 400           # budget for the cold iter0 solves
    pdhg: pdhg.PDHGOptions = pdhg.PDHGOptions(tol=1e-6)
    smoothed: bool = False             # ref 'smoothed' / Update_z
    smooth_beta: float = 0.2           # ref 'defaultPHbeta'
    smooth_p: float = 0.0              # ref 'defaultPHp' (coef of (x-z)^2/2)
    compute_xsqbar: bool = False       # node avg of x^2 (fixer variance test)
    display_progress: bool = False
    time_limit: float | None = None


@dataclasses.dataclass(frozen=True)
class PHState:
    solver: pdhg.PDHGState  # scaled-space subproblem iterates
    W: Tensor               # (S, N) duals, original space
    z: Tensor               # (S, N) smoothing state (unused unless smoothed)
    xbar: Tensor            # (S, N) per-scenario view of node averages
    xbar_nodes: Tensor      # (num_nodes, N) node averages
    xsqbar: Tensor          # (S, N) node avg of x^2 (zeros unless enabled)
    conv: Tensor            # () scaled ||x - xbar||_1
    rho: Tensor             # (N,) per-slot penalty


def _xbar_w_conv(batch: ScenarioBatch, st: PHState, beta: float,
                 smoothed: bool, compute_xsqbar: bool):
    """Compute_Xbar + Update_W (+Update_z) + convergence_diff, fused
    (ref:mpisppy/phbase.py:301-371)."""
    x_non = batch.nonants(st.solver.x)
    xbar, xbar_nodes = batch.node_average(x_non)
    if compute_xsqbar:
        xsqbar, _ = batch.node_average(x_non * x_non)
    else:
        xsqbar = st.xsqbar
    W = st.W + st.rho * (x_non - xbar)
    if batch.var_prob is not None:
        # variable probability: mask W and the convergence metric on
        # absent (weight-0) slots (ref:mpisppy/spbase.py:398-441)
        W = W * (batch.var_prob > 0.0).to(W.dtype)
        conv = torch.sum(batch.var_prob * (x_non - xbar).abs()) \
            / batch.num_nonants
    else:
        conv = batch.expectation(
            (x_non - xbar).abs().sum(dim=-1)) / batch.num_nonants
    z = (1.0 - beta) * st.z + beta * x_non if smoothed else st.z
    return x_non, xbar, xbar_nodes, xsqbar, W, z, conv


def _prox_qp(batch: ScenarioBatch, W: Tensor, xbar: Tensor, z: Tensor,
             rho: Tensor, smooth_p: float):
    """base objective + W·x + rho/2 (x-xbar)^2 [+ p/2 (x-z)^2] on nonant
    slots (ref:mpisppy/phbase.py:670-760)."""
    lin = W - rho * xbar - smooth_p * z
    quad = torch.broadcast_to(rho + smooth_p, xbar.shape)
    return batch.with_nonant_linear_quad(lin, quad)


def iter0_solve_and_certify(batch: ScenarioBatch, windows: int,
                            pdhg_opts: pdhg.PDHGOptions):
    """Plain scenario solves + dual-certified trivial bound.  Returns
    (solver_state, trivial_bound, certified); both bounds are tensors."""
    st0 = pdhg.init_state(batch.qp, pdhg_opts)
    solver = pdhg.solve_fixed(batch.qp, windows, pdhg_opts, st0)
    dual = boxqp.dual_objective(batch.qp, solver.x, solver.y)
    _, rd, _ = boxqp.kkt_residuals(batch.qp, solver.x, solver.y)
    tol = max(pdhg_opts.tol, 5.0 * torch.finfo(solver.x.dtype).eps)
    certified = batch.all_real(rd <= 10.0 * tol)
    return solver, batch.expectation(dual), certified


def ph_iter0(batch: ScenarioBatch, rho: Tensor, opts: PHOptions):
    """Iter0: plain scenario solves, xbar, W seed, trivial bound
    (ref:mpisppy/phbase.py:829-946).  Returns
    (state, trivial_bound, certified)."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    solver, trivial_bound, certified = iter0_solve_and_certify(
        batch, opts.iter0_windows, opts.pdhg)
    dt, dev = batch.qp.c.dtype, batch.device
    zeros = torch.zeros((batch.num_scenarios, batch.num_nonants),
                        dtype=dt, device=dev)
    zeros_nodes = torch.zeros((batch.tree.num_nodes, batch.num_nonants),
                              dtype=dt, device=dev)
    st = PHState(solver=solver, W=zeros, z=zeros, xbar=zeros,
                 xbar_nodes=zeros_nodes, xsqbar=zeros,
                 conv=torch.tensor(float("inf"), dtype=dt, device=dev),
                 rho=rho)
    x_non, xbar, xbar_nodes, xsqbar, W, z, conv = _xbar_w_conv(
        batch, st, opts.smooth_beta, False, opts.compute_xsqbar)
    return (dataclasses.replace(st, W=W, xbar=xbar, xbar_nodes=xbar_nodes,
                                xsqbar=xsqbar, conv=conv),
            trivial_bound, certified)


def ph_state_template(batch: ScenarioBatch, opts) -> PHState:
    """ph_iter0's state as shapes and dtypes (meta-device tensors, no
    solve): built from the batch's dimensions and the PDHG options."""
    S, N = batch.num_scenarios, batch.num_nonants
    dt = batch.qp.c.dtype

    def t(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    return PHState(
        solver=pdhg.state_template((S,), batch.qp.n, batch.qp.m, dt,
                                   opts.pdhg),
        W=t(S, N), z=t(S, N), xbar=t(S, N),
        xbar_nodes=t(batch.tree.num_nodes, N), xsqbar=t(S, N), conv=t(),
        rho=t(N))


def ph_iterk(batch: ScenarioBatch, st: PHState, opts: PHOptions) -> PHState:
    """One PH iteration: solve with current (W, xbar), then refresh
    xbar/W/conv from the new iterates (ref:mpisppy/phbase.py:949-1061)."""
    batch = concretize(batch)  # scengen: draw the scenario data here
    smooth_p = opts.smooth_p if opts.smoothed else 0.0
    qp_eff = _prox_qp(batch, st.W, st.xbar, st.z, st.rho, smooth_p)
    solver = pdhg.solve_fixed(qp_eff, opts.subproblem_windows, opts.pdhg,
                              st.solver)
    st = dataclasses.replace(st, solver=solver)
    x_non, xbar, xbar_nodes, xsqbar, W, z, conv = _xbar_w_conv(
        batch, st, opts.smooth_beta, opts.smoothed, opts.compute_xsqbar)
    return dataclasses.replace(st, W=W, z=z, xbar=xbar,
                               xbar_nodes=xbar_nodes, xsqbar=xsqbar,
                               conv=conv)


def ph_eobjective(batch: ScenarioBatch, st: PHState) -> Tensor:
    """E[f_s(x_s)] at current iterates (ref:mpisppy/spopt.py:344-376)."""
    batch = concretize(batch)
    return batch.expectation(batch.objective(st.solver.x))


class PH:
    """Host-side PH driver (ref:mpisppy/opt/ph.py:24-76).

    `extensions` is an object, class or factory with the hook methods of
    extensions/extension.py (missing hooks are skipped); `converger`
    gets is_converged(); `spcomm` (set by the cylinder layer) gets
    sync()/is_converged()."""

    def __init__(self, options: PHOptions, batch: ScenarioBatch,
                 scenario_names=None, rho: Tensor | float | None = None,
                 extensions=None, converger=None, rho_setter=None):
        self.options = options
        self.batch = batch
        self.scenario_names = scenario_names or [
            f"scen{i}" for i in range(batch.num_real)]
        if rho is None:
            rho = options.default_rho
        dt, dev = batch.qp.c.dtype, batch.device
        if rho_setter is not None:
            rho = rho_setter(batch)
        self.rho = torch.broadcast_to(
            torch.as_tensor(rho, dtype=dt, device=dev),
            (batch.num_nonants,)).clone()

        def _build(thing):
            # classes, functions and partials are factories taking the
            # driver; built objects (not callable) pass through
            if thing is None:
                return None
            if isinstance(thing, type) or callable(thing):
                return thing(self)
            return thing
        self.extobject = _build(extensions)
        self.converger_object = _build(converger)
        self.spcomm = None
        self.state: PHState | None = None
        self.trivial_bound: float | None = None
        self.trivial_bound_certified: bool = False
        self._iter = 0

    def _ext(self, hook: str):
        obj = self.extobject
        if obj is not None and hasattr(obj, hook):
            getattr(obj, hook)()

    @property
    def local_scenarios(self):
        """The scenario names (the reference's per-rank dict; one
        program holds them all)."""
        return self.scenario_names

    _label = "PH"

    def state_template(self):
        """Shape/dtype template of this driver's state (meta-device
        tensors) — the unflatten template of a checkpoint restore
        (hub.load_checkpoint) without paying an Iter0 solve (APH has its
        own, aph.aph_state_template)."""
        return ph_state_template(self.batch, self.options)

    # -- algorithm step hooks (overridden by FusedPH) ---------------------
    def _iter0_impl(self):
        return ph_iter0(self.batch, self.rho, self.options)

    def _iterk_impl(self):
        return ph_iterk(self.batch, self.state, self.options)

    def _iter_msg(self, k: int, conv: float) -> str:
        return f"{self._label} iter {k}: conv = {conv:.3e}"

    def _read_conv(self) -> float:
        """Per-iteration convergence read (one device scalar transfer;
        FusedPH serves it from the packed scalar cache instead)."""
        return float(self.state.conv)

    def Eobjective(self) -> float:
        return float(ph_eobjective(self.batch, self.state))

    def Iter0(self) -> float:
        self._ext("pre_iter0")
        self._ext("iter0_post_solver_creation")
        with _prof.annotate("wheel/iter0_solve"):
            t0 = time.perf_counter()
            self.state, tb, cert = self._iter0_impl()
            dt = time.perf_counter() - t0
        if self.spcomm is not None:
            self.spcomm.emit_span("iter0_solve", dt)
        self.trivial_bound = float(tb)
        self.trivial_bound_certified = bool(cert)
        self._ext("post_iter0")
        if self.spcomm is not None:
            self.spcomm.sync()
        self._ext("post_iter0_after_sync")
        global_toc(f"{self._label} Iter0: trivial bound = "
                   f"{self.trivial_bound:.6g}",
                   self.options.display_progress)
        return self.trivial_bound

    def iterk_loop(self):
        t0 = time.time()
        for k in range(self._iter + 1, self.options.max_iterations + 1):
            self._iter = k
            self._ext("miditer")
            self._ext("pre_solve_loop")
            with _prof.annotate("wheel/subproblem_solve"):
                t_solve = time.perf_counter()
                self.state = self._iterk_impl()
                dt_solve = time.perf_counter() - t_solve
            if self.spcomm is not None:
                # host wall of the step's launches: the device wait shows
                # in the next blocking read (the hub's harvest span)
                self.spcomm.emit_span("subproblem_solve", dt_solve)
            self._ext("post_solve_loop")
            conv = self._read_conv()
            self._ext("enditer")
            if self.spcomm is not None:
                self.spcomm.sync()
            self._ext("enditer_after_sync")
            global_toc(self._iter_msg(k, conv),
                       self.options.display_progress)
            # the hub takes precedence over the local convergence metric
            # (ref:mpisppy/phbase.py:996-1015 ordering)
            if self.spcomm is not None and self.spcomm.is_converged():
                break
            if (self.converger_object is not None
                    and self.converger_object.is_converged()):
                break
            if conv <= self.options.conv_thresh:
                global_toc(f"{self._label} converged at iter {k} "
                           f"(conv={conv:.3e})",
                           self.options.display_progress)
                if self.spcomm is not None:
                    self.spcomm._term_reason = "conv-thresh"
                break
            if (self.options.time_limit is not None
                    and time.time() - t0 > self.options.time_limit):
                if self.spcomm is not None:
                    self.spcomm._term_reason = "time-limit"
                break
        return float(self.state.conv)

    def post_loops(self) -> float:
        self._ext("post_everything")
        return self.Eobjective()

    def ph_main(self):
        """Returns (conv, Eobj, trivial_bound) (ref:opt/ph.py:31-76).
        A state preloaded by a checkpoint restore skips Iter0 and the
        loop continues from the restored iteration counter."""
        tb = self.Iter0() if self.state is None else self.trivial_bound
        conv = self.iterk_loop()
        eobj = self.post_loops()
        return conv, eobj, tb

    # -- solution access (ref:spbase.py:561-672 analogs) -----------------
    def nonant_values(self) -> np.ndarray:
        """(num_nodes, N) per-node nonant values (xbar)."""
        return self.state.xbar_nodes.cpu().numpy()

    def first_stage_solution(self) -> np.ndarray:
        """(n_root_slots,) root-node nonant values."""
        nodes = self.nonant_values()
        root = np.nonzero(self.batch.tree.slot_stage == 1)[0]
        return nodes[0, root]
