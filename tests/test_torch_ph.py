# Port parity: Progressive Hedging on farmer.  Both packages run PH from
# the same batch (carried across with mpisppy_tpu_torch.convert) and the
# same power-iteration norm estimate (the port's estimate_norm is patched
# to return the JAX one, whose PRNGKey(7) start vector torch cannot
# reproduce); an enditer extension records conv, x̄ and W every
# iteration.  Farmer's constraint matrix varies by scenario, so both
# sides run the plain PDHG iteration.  Over the first five iterations
# the trajectories agree to 1e-5 of their scale (f32 sums in another
# order).  The inexact fixed-budget subproblem solves then amplify that
# noise once: the adaptive restart test (score <= decay * score at the
# last restart) flips in one window of iteration 6, which moves x̄ and W
# by ~1e-3 of their scale; iterations 6-10 are held to 5e-3 of the scale
# of x (conv and x̄, both in acres) and of W.
import jax.numpy as jnp
import numpy as np
import torch

from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)


def jax_norm_estimate(p, iters=30, generator=None):
    """The JAX package's ||A|| estimate of a port BoxQP."""
    arrs = convert.arrays_of(p)
    jp = jboxqp.BoxQP(**{k: jnp.asarray(arrs[k])
                         for k in ("c", "q", "A", "bl", "bu", "l", "u")})
    return torch.as_tensor(np.array(jpdhg.estimate_norm(jp, iters)))


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


def test_farmer_ph_trajectory_matches_jax(monkeypatch):
    monkeypatch.setattr(tpdhg, "estimate_norm", jax_norm_estimate)
    jb, tb = _farmer()
    jrows, trows = [], []
    jalgo = jph.PH(_opts(jph, jpdhg, max_iterations=10, conv_thresh=0.0),
                   jb, extensions=_recorder(jrows))
    talgo = tph.PH(_opts(tph, tpdhg, max_iterations=10, conv_thresh=0.0),
                   tb, extensions=_recorder(trows))
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
