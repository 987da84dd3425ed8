# Port parity: the remaining models through the port's solver paths,
# against the JAX package on the CPU on the same (bit-identical,
# tests/test_torch_models_zoo.py) batches: PH, the extensive form and
# sslp's exact candidate values (the wheels and admm runs are in
# tests/test_torch_models_wheels.py, usar's MIP bracket in
# tests/test_torch_models_mip.py).
#
# PH: both packages run from one power-iteration norm estimate, the JAX
# package's handed to the port (ROADMAP C1: XLA's CPU reduction order
# follows the host's vector ISA), and the PDHG primal weight omega is
# shared as each PH iteration starts (C1: at the f32 floor of a lane's
# KKT score each restart sets omega from rounding noise).  conv and the
# expected objective are then held to 1e-4 of their scale at every
# iteration (f32 sums taken in another order).  The extensive form's
# objective is held to the JAX package's and to scipy's HiGHS optimum at
# 1e-4 relative; sslp's exact candidate values to the JAX package's at
# 1e-4 relative.
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ef as jef
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.algos.ef import build_ef as jbuild_ef
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ef as tef
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import pdhg as tpdhg

from test_torch_models_zoo import MODELS

torch.set_num_threads(1)

PH_TOL = 1e-4
EF_TOL = 1e-4


def _batches(model, S=None):
    """(JAX batch, port batch on the CPU, JAX specs, JAX tree) of a
    MODELS entry."""
    jm, tm, names, kw = MODELS[model]
    jkw, tkw = kw(jm, tm)
    bfs = jkw.get("branching_factors")
    jt, tt = (None, None) if bfs is None else (jm.make_tree(bfs),
                                               tm.make_tree(bfs))
    jspecs = [jm.scenario_creator(nm, **jkw) for nm in names]
    tspecs = [tm.scenario_creator(nm, **tkw) for nm in names]
    return (jbatch.from_specs(jspecs, tree=jt),
            tbatch.from_specs(tspecs, tree=tt, device="cpu"), jspecs,
            tspecs, jt, tt)


def highs_ef(specs, tree=None):
    """scipy HiGHS optimum of the unscaled extensive form's LP
    relaxation (tests/test_hydro.py::scipy_ef_solve_tree's recipe on
    the JAX package's EF)."""
    from scipy.optimize import linprog
    efp = jbuild_ef(specs, tree=tree, scale=False)
    qp = efp.qp
    A = np.asarray(qp.A.toarray() if hasattr(qp.A, "toarray") else qp.A,
                   np.float64)
    bl, bu = np.asarray(qp.bl, np.float64), np.asarray(qp.bu, np.float64)
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for i in range(A.shape[0]):
        if bl[i] == bu[i]:
            A_eq.append(A[i])
            b_eq.append(bu[i])
            continue
        if np.isfinite(bu[i]):
            A_ub.append(A[i])
            b_ub.append(bu[i])
        if np.isfinite(bl[i]):
            A_ub.append(-A[i])
            b_ub.append(-bl[i])
    res = linprog(np.asarray(qp.c, np.float64),
                  A_ub=np.array(A_ub) if A_ub else None,
                  b_ub=np.array(b_ub) if b_ub else None,
                  A_eq=np.array(A_eq) if A_eq else None,
                  b_eq=np.array(b_eq) if b_eq else None,
                  bounds=list(zip(np.asarray(qp.l, np.float64),
                                  np.asarray(qp.u, np.float64))),
                  method="highs")
    assert res.status == 0
    return float(res.fun)


def _share_jax_norm(monkeypatch, jb, tb):
    """The port's estimate_norm returns the JAX package's estimate for
    the batch's constraint matrix."""
    L = torch.as_tensor(np.array(jpdhg.estimate_norm(jb.qp)))
    own = tpdhg.estimate_norm

    def estimate(p, iters=30):
        if p.A is tb.qp.A and iters == 30:
            return L.clone()
        return own(p, iters)
    monkeypatch.setattr(tpdhg, "estimate_norm", estimate)


def _recorder(rows, shared, jax_side):
    """Records (conv, eobj, max |x̄|) at every iteration's end and whether
    iter0's solves converged; shares the PDHG primal weight as each PH
    iteration starts (the JAX side records it, the port's side takes
    it)."""
    side = "jax" if jax_side else "port"

    class Recorder(Extension):
        def post_iter0(self):
            shared["iter0_done", side] = bool(np.asarray(convert.arrays_of(
                self.opt.state.solver.done)).all())

        def miditer(self):
            st = self.opt.state
            if jax_side:
                shared.setdefault("omega", []).append(
                    np.array(st.solver.omega))
                return
            omega = torch.as_tensor(shared["omega"][self.opt._iter - 1])
            self.opt.state = dataclasses.replace(
                st, solver=dataclasses.replace(st.solver, omega=omega))

        def enditer(self):
            st = self.opt.state
            rows.append((float(np.asarray(convert.arrays_of(st.conv))),
                         float(self.opt.Eobjective()),
                         float(np.abs(np.asarray(convert.arrays_of(
                             st.xbar_nodes))).max())))
    return Recorder


# model -> (rho, subproblem windows, PH iterations), the JAX tests' rho
PH_CASES = {"hydro": (1.0, 10, 5), "gbd": (5.0, 8, 3), "sizes": (0.5, 8, 3),
            "apl1p": (2.0, 8, 3), "netdes": (300.0, 8, 3),
            "battery": (0.05, 8, 3)}


@pytest.mark.parametrize("model", sorted(PH_CASES))
def test_ph_matches_jax(model, monkeypatch):
    rho, windows, iters = PH_CASES[model]
    jb, tb, jspecs, _, jt, _ = _batches(model)
    _share_jax_norm(monkeypatch, jb, tb)

    def opts(mod, pdhg_mod):
        return mod.PHOptions(default_rho=rho, max_iterations=iters,
                             conv_thresh=0.0, subproblem_windows=windows,
                             pdhg=pdhg_mod.PDHGOptions(tol=1e-7,
                                                       restart_period=40))
    jrows, trows, shared = [], [], {}
    jalgo = jph.PH(opts(jph, jpdhg), jb,
                   extensions=_recorder(jrows, shared, True))
    talgo = tph.PH(opts(tph, tpdhg), tb,
                   extensions=_recorder(trows, shared, False))
    jconv, jeobj, jtb = jalgo.ph_main()
    tconv, teobj, ttb = talgo.ph_main()
    assert len(trows) == len(jrows) == iters
    scale = max(1.0, abs(jeobj))
    for k, ((jc, je, jx), (tc, te, _)) in enumerate(zip(jrows, trows)):
        # conv sums |x - x̄|: its rounding floor is that of x
        assert abs(tc - jc) <= PH_TOL * max(1.0, jx), (k, tc, jc, jx)
        assert abs(te - je) <= PH_TOL * scale, (k, te, je)
    assert abs(teobj - jeobj) <= PH_TOL * scale
    # the trivial bound is the Fenchel dual value at iter0's iterate: held
    # at PH_TOL where iter0's solves converge in both packages.  Where
    # one runs to the window cap (sizes and battery: 16,000 iterations;
    # hydro: its last lane, in one package), omega follows the rounding
    # noise of y (ROADMAP C1), the dual value at the last iterate moves
    # with it, and both packages' values must be valid: at or below the
    # HiGHS EF optimum
    if shared["iter0_done", "jax"] and shared["iter0_done", "port"]:
        assert abs(ttb - jtb) <= PH_TOL * max(1.0, abs(jtb))
    else:
        opt = highs_ef(jspecs, jt)
        for v in (ttb, jtb):
            assert v <= opt + PH_TOL * max(1.0, abs(opt))


def test_hydro_ef_matches_jax_and_scipy():
    """ExtensiveForm on hydro (3, 3) in both packages (tol 1e-7), against
    each other and HiGHS at 1e-4; the reference's known answer, Scen7's
    Pgt[2] = 60."""
    jm, tm, _, _ = MODELS["hydro"]
    names = jm.scenario_names_creator(9)
    kw = {"branching_factors": (3, 3)}
    opts = {"tol": 1e-7, "max_iters": 300_000}
    jef_ = jef.ExtensiveForm(opts, names, jm.scenario_creator, kw,
                             tree=jm.make_tree((3, 3)))
    tef_ = tef.ExtensiveForm(opts, names, tm.scenario_creator, kw,
                             tree=tm.make_tree((3, 3)), device="cpu")
    jef_.solve_extensive_form()
    st = tef_.solve_extensive_form()
    assert bool(st.done.all())
    jobj, tobj = jef_.get_objective_value(), tef_.get_objective_value()
    sobj = highs_ef([jm.scenario_creator(nm, **kw) for nm in names],
                    jm.make_tree((3, 3)))
    assert abs(tobj - jobj) <= EF_TOL * abs(jobj)
    assert abs(tobj - sobj) <= EF_TOL * abs(sobj)
    assert tef_.x[6, 1] == pytest.approx(60.0, abs=1.0)


def test_eval_candidates_exact_matches_jax():
    """sslp 5x15, 8 scenarios, 2 candidates: the exact inner values of
    the port (its batched LP on the CPU) against the JAX package's."""
    jinst = jsslp.synthetic_instance(5, 15, seed=0)
    tinst = tsslp.synthetic_instance(5, 15, seed=0)
    cps = [jsslp.synthetic_client_present(15, s) for s in range(8)]
    xh = np.array([[1.0, 0.0, 1.0, 1.0, 0.0], [0.0, 1.0, 1.0, 0.0, 1.0]])
    j = jsslp.eval_candidates_exact(jinst, cps, xh)
    t = tsslp.eval_candidates_exact(tinst, cps, torch.as_tensor(xh))
    for a, b in zip(t, j):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b))
    b, qp = tsslp.candidates_batch(tinst, cps, xh, device="cpu")
    assert b.device.type == "cpu" and qp.A.ndim == 2
    assert b.num_scenarios == 16
