# Port parity: Progressive Hedging on farmer.  Both packages run PH from
# the same batch (carried across with mpisppy_tpu_torch.convert) and from
# one power-iteration norm estimate: the JAX package's, handed to the
# port.  The port's own estimate agrees with it to 1e-7 relative
# (tests/test_torch_random_normal.py), but not bit for bit on every CPU:
# XLA's reduction order depends on the host's vector ISA.  The PDHG
# primal weight omega is shared the same way, at the start of every PH
# iteration: each restart sets omega from |dx|/|dy| of the window, and
# for a lane at the f32 floor of its KKT score those displacements are
# rounding noise, so omega, carried from one PH iteration to the next,
# follows the noise of each package's f32 sums (one ulp in y moves it by
# 20% in one PH step while x̄ moves by 2e-7;
# test_farmer_ph_primal_weight_follows_rounding_noise).  An enditer
# extension records conv, x̄ and W every iteration.  Farmer's constraint
# matrix varies by scenario, so both sides run the plain PDHG iteration.
# Over the first five iterations the trajectories agree to 1e-5 of their
# scale (f32 sums in another order).  Iterations 6-10 are held to 5e-3 of
# the scale of x (conv and x̄, both in acres) and of W: iteration 6 is
# the one where the inexact fixed-budget subproblem solves amplify that
# noise most (7.5e-5 of conv's scale with omega shared, ~5e-3 without).
# The free-running expected objective is held to 1e-4 relative (4.4e-7
# measured), and so is each of the ten port steps taken from the JAX
# state of the step before (its conv, x̄ and W to 1e-4 of their scale).
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)


def _recorder(rows):
    class Recorder(Extension):
        def enditer(self):
            st = self.opt.state
            rows.append(tuple(np.array(convert.arrays_of(v)) for v in
                              (st.conv, st.xbar_nodes, st.W)))
    return Recorder


def _farmer(S=3):
    specs = [jfarmer.scenario_creator(nm, num_scens=S)
             for nm in jfarmer.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def _opts(mod, pdhg_mod, **kw):
    return mod.PHOptions(default_rho=1.0, subproblem_windows=10,
                         pdhg=pdhg_mod.PDHGOptions(tol=1e-7,
                                                   restart_period=40), **kw)


def _share_jax_norm(monkeypatch, jb, tb):
    """The port's estimate_norm returns the JAX package's estimate for
    the batch's constraint matrix (every PH subproblem shares it)."""
    L = torch.as_tensor(np.array(jpdhg.estimate_norm(jb.qp)))
    own = tpdhg.estimate_norm

    def estimate(p, iters=30):
        if p.A is tb.qp.A and iters == 30:
            return L.clone()
        return own(p, iters)
    monkeypatch.setattr(tpdhg, "estimate_norm", estimate)


def _omega_shared(rows, omegas, jax_side):
    """_recorder's extension that also shares the PDHG primal weight:
    the JAX side records omega as each PH iteration starts, the port's
    side takes the recorded value at the same point."""
    base = _recorder(rows)

    class OmegaShared(base):
        def miditer(self):
            st = self.opt.state
            if jax_side:
                omegas.append(np.array(st.solver.omega))
                return
            omega = torch.as_tensor(omegas[self.opt._iter - 1])
            self.opt.state = dataclasses.replace(
                st, solver=dataclasses.replace(st.solver, omega=omega))
    return OmegaShared


def test_farmer_ph_trajectory_matches_jax(monkeypatch):
    jb, tb = _farmer()
    _share_jax_norm(monkeypatch, jb, tb)
    jrows, trows, omegas = [], [], []
    jalgo = jph.PH(_opts(jph, jpdhg, max_iterations=10, conv_thresh=0.0),
                   jb, extensions=_omega_shared(jrows, omegas, True))
    talgo = tph.PH(_opts(tph, tpdhg, max_iterations=10, conv_thresh=0.0),
                   tb, extensions=_omega_shared(trows, omegas, False))
    jconv, jeobj, jtb = jalgo.ph_main()
    tconv, teobj, ttb = talgo.ph_main()
    assert len(trows) == len(jrows) == 10
    assert ttb == np.float32(jtb) or abs(ttb - jtb) <= 1e-5 * abs(jtb)
    for k, (jr, tr) in enumerate(zip(jrows, trows)):
        xscale = np.abs(jr[1]).max()
        for name, j, t in zip(("conv", "xbar", "W"), jr, tr):
            if k < 5:
                atol = 1e-5 * np.abs(j).max()
            else:
                atol = 5e-3 * (np.abs(j).max() if name == "W" else xscale)
            np.testing.assert_allclose(t, j, atol=atol, rtol=0,
                                       err_msg=f"iter {k + 1} {name}")
    assert abs(teobj - jeobj) <= 1e-4 * abs(jeobj)
    # each PH step from the JAX state of the step before
    jo, to = jph.kernel_opts(_opts(jph, jpdhg)), _opts(tph, tpdhg)
    jst, _, _ = jph.ph_iter0(jb, jalgo.rho, jo)
    for k in range(10):
        tst = tph.ph_iterk(
            tb, convert.ph_state_from_arrays(convert.arrays_of(jst), "cpu"),
            to)
        jst = jph.ph_iterk(jb, jst, jo)
        xscale = np.abs(np.asarray(jst.xbar_nodes)).max()
        for name in ("conv", "xbar_nodes", "W"):
            j = np.asarray(getattr(jst, name))
            atol = 1e-4 * (np.abs(j).max() if name == "W" else xscale)
            np.testing.assert_allclose(getattr(tst, name).numpy(), j,
                                       atol=atol, rtol=0,
                                       err_msg=f"step {k + 1} {name}")
        jeobj = float(jph.ph_eobjective(jb, jst))
        teobj = float(tph.ph_eobjective(tb, tst))
        assert teobj == pytest.approx(jeobj, rel=1e-4), f"step {k + 1}"


def test_farmer_ph_converges_to_textbook_acres():
    """The port alone, to convergence: WHEAT 170, CORN 80, BEETS 250."""
    _, tb = _farmer()
    algo = tph.PH(_opts(tph, tpdhg, max_iterations=150, conv_thresh=5e-2),
                  tb)
    conv, eobj, tbound = algo.ph_main()
    assert conv <= 5e-2
    assert tbound <= -108390.0 + 1.0
    np.testing.assert_allclose(algo.first_stage_solution(),
                               [170.0, 80.0, 250.0], atol=5.0)


def test_farmer_ph_primal_weight_follows_rounding_noise():
    """Why the trajectory test shares omega: in the port alone, one ulp
    in the dual iterate after iter0 leaves x̄ within 1e-5 of its scale
    after one PH step but moves the primal weight of some lane by more
    than 1% (ROADMAP.md queue C, item 1)."""
    _, tb = _farmer()
    to = _opts(tph, tpdhg)
    a, _, _ = tph.ph_iter0(tb, torch.ones(tb.num_nonants), to)
    y = a.solver.y
    b = dataclasses.replace(a, solver=dataclasses.replace(
        a.solver, y=torch.nextafter(y, torch.full_like(y, np.inf))))
    a, b = tph.ph_iterk(tb, a, to), tph.ph_iterk(tb, b, to)
    xscale = float(a.xbar_nodes.abs().max())
    assert float((a.xbar_nodes - b.xbar_nodes).abs().max()) <= 1e-5 * xscale
    domega = (a.solver.omega - b.solver.omega).abs() / a.solver.omega
    assert float(domega.max()) > 1e-2
