# Port parity: FBBT presolve (ops/fbbt.py) against the JAX package, on
# the same batches (built from the same specs in each package):
#   * presolve_batch on sslp 5x15 at S=8 (a dense shared A, integer
#     first stage) and on the strengthened sslp (y_ij <= x_j rows, an ELL
#     A), on uc 10x24 at S=4 (ELL, LP relaxation), and on the ccopf --soc
#     batch (dense A with SOC blocks: the norm-ball relaxation);
#   * fbbt's infinite-term counting on the JAX tests' hand examples.
# Tightened bounds agree to 1e-6 of their scale (f32 interval sums over
# at most n terms in another order), the tightened_bounds count and the
# infeasible mask exactly.
#
# On an ELL batch the JAX reference is its DENSE sweep over the same
# scaled matrix: the JAX package's ELL sweep raises on any batch whose
# bounds carry a scenario axis (mpisppy_tpu/ops/fbbt.py:142-147 takes the
# batch shape from the shared vals, not from the per-scenario slot
# bounds), which is every presolve of a shared ELL A.
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import fbbt as jfbbt
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.ops import fbbt as tfbbt

torch.set_num_threads(1)


def _sslp(S, strengthen=False):
    from mpisppy_tpu.models import sslp as jm
    from mpisppy_tpu_torch.models import sslp as tm
    ji, ti = jm.synthetic_instance(5, 15), tm.synthetic_instance(5, 15)
    names = tm.scenario_names_creator(S)
    return (jbatch.from_specs([jm.scenario_creator(
                nm, instance=ji, num_scens=S, strengthen=strengthen)
                for nm in names]),
            tbatch.from_specs([tm.scenario_creator(
                nm, instance=ti, num_scens=S, strengthen=strengthen)
                for nm in names], device="cpu"))


def _uc(S):
    from mpisppy_tpu.models import uc as jm
    from mpisppy_tpu_torch.models import uc as tm
    ji, ti = jm.synthetic_instance(10, 24), tm.synthetic_instance(10, 24)
    names = tm.scenario_names_creator(S)
    return (jbatch.from_specs([jm.scenario_creator(nm, instance=ji,
                                                   num_scens=S)
                               for nm in names]),
            tbatch.from_specs([tm.scenario_creator(nm, instance=ti,
                                                   num_scens=S)
                               for nm in names], device="cpu"))


def _ccopf():
    from mpisppy_tpu.models import ccopf as jm
    jb = jbatch.from_specs(
        [jm.scenario_creator(nm, branching_factors=(3, 3), soc=True)
         for nm in jm.scenario_names_creator(9)],
        tree=jm.make_tree((3, 3)))
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


CASES = {"sslp_dense": lambda: _sslp(8),
         "sslp_vub_ell": lambda: _sslp(8, strengthen=True),
         "uc_ell": lambda: _uc(4),
         "ccopf_soc": _ccopf}


def _assert_bounds_close(t, j):
    j = np.asarray(j)
    t = t.numpy()
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
    fin = np.isfinite(j)
    scale = max(1.0, np.abs(j[fin]).max())
    np.testing.assert_allclose(t[fin], j[fin], rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_presolve_batch_matches_jax(case):
    jb, tb = CASES[case]()
    if case.endswith("ell"):
        from mpisppy_tpu_torch.ops.sparse import EllMatrix
        assert isinstance(tb.qp.A, EllMatrix)
        jb = dataclasses.replace(jb, qp=dataclasses.replace(
            jb.qp, A=jnp.asarray(jb.qp.A.toarray())))
    jpre, jinfo = jfbbt.presolve_batch(jb, n_sweeps=3)
    tpre, tinfo = tfbbt.presolve_batch(tb, n_sweeps=3)
    _assert_bounds_close(tpre.qp.l, jpre.qp.l)
    _assert_bounds_close(tpre.qp.u, jpre.qp.u)
    assert tinfo["tightened_bounds"] == jinfo["tightened_bounds"] > 0
    np.testing.assert_array_equal(tinfo["infeasible"], jinfo["infeasible"])


def test_presolve_detects_the_same_infeasible_scenario():
    """x0 + x1 >= 5 with boxes [0, 1]: the scenario is infeasible, and
    the cross-scenario intersection empties every member's nonant box."""
    specs = {}
    for pkg, mod in (("j", jbatch), ("t", tbatch)):
        mk = []
        for name, bl in (("ok", 1.0), ("bad", 5.0)):
            mk.append(mod.ScenarioSpec(
                name=name, c=np.zeros(2), A=np.array([[1.0, 1.0]]),
                bl=np.array([bl]), bu=np.array([np.inf]), l=np.zeros(2),
                u=np.ones(2), nonant_idx=np.array([0], np.int32)))
        specs[pkg] = mk
    jb = jbatch.from_specs(specs["j"], scale=False)
    tb = tbatch.from_specs(specs["t"], scale=False, device="cpu")
    with pytest.raises(ValueError, match="infeasible"):
        tfbbt.presolve_batch(tb)
    _, jinfo = jfbbt.presolve_batch(jb, raise_on_infeasible=False)
    _, tinfo = tfbbt.presolve_batch(tb, raise_on_infeasible=False)
    np.testing.assert_array_equal(tinfo["infeasible"], jinfo["infeasible"])
    assert tinfo["infeasible"].all()


@pytest.mark.parametrize("row,box", [
    # an unbounded column in the row: the finite terms must still count
    ([1.0, 1.0], ([0.0, -np.inf], [1.0, np.inf])),
    # two infinite terms: nothing tightens from that side
    ([1.0, -1.0, 1.0], ([0.0, 0.0, -np.inf], [np.inf, 3.0, np.inf])),
    # one infinite term: only its own column tightens
    ([2.0, 1.0, 1.0], ([-np.inf, 0.0, 0.0], [np.inf, 1.0, 2.0])),
])
@pytest.mark.parametrize("sparse", [False, True])
def test_fbbt_infinite_term_counting_matches_jax(row, box, sparse):
    n = len(row)
    A = np.array([row])
    kw = dict(c=np.zeros(n), A=A, bl=np.array([-1.0]), bu=np.array([4.0]),
              l=np.array(box[0]), u=np.array(box[1]))
    jp = jboxqp.make_boxqp(**kw)
    tp = convert.boxqp_from_arrays(convert.arrays_of(jp), "cpu")
    if sparse:
        import scipy.sparse as sps

        from mpisppy_tpu.ops import sparse as jsparse
        from mpisppy_tpu_torch.ops import sparse as tsparse
        M = sps.csr_matrix(A)
        jp = dataclasses.replace(jp, A=jsparse.ell_from_scipy(M,
                                                              jnp.float32))
        tp = dataclasses.replace(tp, A=tsparse.ell_from_scipy(M))
    jl, ju = jfbbt.fbbt(jp, n_sweeps=2)
    tl, tu = tfbbt.fbbt(tp, n_sweeps=2)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
