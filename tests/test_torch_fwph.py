# Port parity: Frank-Wolfe Progressive Hedging (algos/fwph.py) and its
# spoke, against the JAX package on the CPU.
#
# fwph_init plus three fwph_iter on tests/test_fwph.py's farmer3 fixture
# (per-scenario dense A) and on uc 10x24 at S=4 (shared ELL A), each
# package from its own cold state: the certified best bound agrees to
# 1e-4 relative (measured 4e-5 on both).  The inner simplex QP is
# degenerate when columns are nearly collinear (its weights move by up to
# ~0.4 between the packages while V'lam moves by ~1e-3 of its scale), so
# the per-iteration comparison from one shared state (carried across with
# mpisppy_tpu_torch.convert) holds the dual bound at 1e-4 and x̄ at 1e-2
# of its scale, not the weights.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fwph as jfwph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fwph as tfwph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

FARMER_OPTS = dict(fw_iter_limit=2, max_columns=16, oracle_windows=12)


def _case(model):
    """(JAX batch, port batch, JAX options, port options, rho)."""
    if model == "farmer":
        from mpisppy_tpu.models import farmer as jm
        from mpisppy_tpu_torch.models import farmer as tm
        names = tm.scenario_names_creator(3)
        jb = jbatch.from_specs([jm.scenario_creator(nm, num_scens=3)
                                for nm in names])
        tb = tbatch.from_specs([tm.scenario_creator(nm, num_scens=3)
                                for nm in names], device="cpu")
        return (jb, tb,
                jfwph.FWPHOptions(**FARMER_OPTS,
                                  pdhg=jpdhg.PDHGOptions(tol=1e-7)),
                tfwph.FWPHOptions(**FARMER_OPTS,
                                  pdhg=tpdhg.PDHGOptions(tol=1e-7)), 1.0)
    from mpisppy_tpu.models import uc as jm
    from mpisppy_tpu_torch.models import uc as tm
    ji, ti = jm.synthetic_instance(10, 24), tm.synthetic_instance(10, 24)
    names = tm.scenario_names_creator(4)
    jb = jbatch.from_specs([jm.scenario_creator(nm, instance=ji, num_scens=4)
                            for nm in names])
    tb = tbatch.from_specs([tm.scenario_creator(nm, instance=ti, num_scens=4)
                            for nm in names], device="cpu")
    # the FWPH spoke of bench.py's uc wheel: default options, rho 200
    return jb, tb, jfwph.FWPHOptions(), tfwph.FWPHOptions(), 200.0


@pytest.fixture(scope="module", params=["farmer", "uc"])
def runs(request):
    jb, tb, jo, to, rho = _case(request.param)
    N = tb.num_nonants
    jst, jtb, jcert = jfwph.fwph_init(jb, jnp.full((N,), rho, jnp.float32),
                                      jo)
    tst, ttb, tcert = tfwph.fwph_init(tb, torch.full((N,), rho), to)
    hist = [(jst, tst)]
    for _ in range(3):
        jst = jfwph.fwph_iter(jb, jst, jo)
        tst = tfwph.fwph_iter(tb, tst, to)
        hist.append((jst, tst))
    return jb, tb, jo, to, (float(jtb), bool(jcert)), \
        (float(ttb), bool(tcert)), hist


def test_fwph_best_bound_matches_jax(runs):
    _, _, _, _, jinit, tinit, hist = runs
    assert jinit[1] and tinit[1]
    assert tinit[0] == pytest.approx(jinit[0], rel=1e-4)
    for jst, tst in hist:
        assert bool(tst.certified) == bool(jst.certified)
        assert float(tst.best_bound) == pytest.approx(
            float(jst.best_bound), rel=1e-4)
        assert float(tst.conv) == pytest.approx(float(jst.conv), rel=2e-2)


def test_fwph_iter_from_the_same_state_matches_jax(runs):
    jb, tb, jo, to, _, _, hist = runs
    jst = hist[-1][0]
    tst = convert.fwph_state_from_arrays(convert.arrays_of(jst), "cpu")
    assert tst.next_slot == int(jst.next_slot)
    jst = jfwph.fwph_iter(jb, jst, jo)
    tst = tfwph.fwph_iter(tb, tst, to)
    assert float(tst.bound) == pytest.approx(float(jst.bound), rel=1e-4)
    xbar = np.asarray(jst.xbar)
    np.testing.assert_allclose(tst.xbar.numpy(), xbar,
                               atol=1e-2 * np.abs(xbar).max())
    np.testing.assert_array_equal(tst.valid.numpy(), np.asarray(jst.valid))


def test_push_column_fills_in_order_then_evicts_least_weight():
    S, K, n = 2, 3, 4
    st = tfwph.FWPHState(
        cols=torch.zeros(S, K, n), valid=torch.zeros(S, K, dtype=torch.bool),
        next_slot=0, lam=torch.zeros(S, K), x=torch.zeros(S, n),
        W=torch.zeros(S, 1), xbar=torch.zeros(S, 1),
        xbar_nodes=torch.zeros(1, 1), conv=torch.zeros(()),
        rho=torch.ones(1), oracle=None, bound=torch.zeros(()),
        best_bound=torch.zeros(()), certified=torch.zeros((), dtype=bool),
        gamma=torch.zeros(S))
    for k in range(K):
        st = tfwph._push_column(st, torch.full((S, n), float(k + 1)))
    assert st.valid.all() and st.next_slot == K
    st = tfwph.FWPHState(**{**st.__dict__,
                            "lam": torch.tensor([[0.5, 0.1, 0.4],
                                                 [0.2, 0.3, 0.5]])})
    st = tfwph._push_column(st, torch.full((S, n), 9.0))
    assert st.cols[0, 1, 0] == 9.0 and st.cols[1, 0, 0] == 9.0
    assert st.lam[0, 1] == 0.0 and st.lam[1, 0] == 0.0
    torch.testing.assert_close(st.lam.sum(-1), torch.ones(S))
