# Port parity: the bound evaluators behind the fused planes — the
# Lagrangian bound L(W) (algos/lagrangian.py) and the x̂ recourse
# evaluation with its rescue tiers (algos/xhat.py, which the fused x̂-x̄
# spoke runs when the in-loop plane stalls) — against the JAX package on
# sslp(5,15), from the same batch, each from its own norm estimate (they
# agree to 1e-5).  Both solve to tolerance, so bounds agree to 1e-4
# relative.
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import lagrangian as jlag
from mpisppy_tpu.algos import xhat as jxhat
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import lagrangian as tlag
from mpisppy_tpu_torch.algos import xhat as txhat
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)


@pytest.fixture()
def sslp8():
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=8,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(8)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def test_lagrangian_bound_matches_jax(sslp8):
    jb, tb = sslp8
    rng = np.random.default_rng(0)
    W = rng.normal(scale=5.0, size=(8, jb.num_nonants)).astype(np.float32)
    W -= W.mean(axis=0)   # node mean of W ~ 0: a valid outer bound
    kw = dict(tol=1e-6, max_iters=20_000)
    jr = jlag.lagrangian_bound(jb, W, jpdhg.PDHGOptions(**kw))
    tr = tlag.lagrangian_bound(tb, torch.as_tensor(W),
                               tpdhg.PDHGOptions(**kw))
    assert bool(tr.certified) == bool(jr.certified) is True
    assert float(tr.bound) == pytest.approx(float(jr.bound), rel=1e-4)
    np.testing.assert_allclose(tr.per_scenario.numpy(),
                               np.asarray(jr.per_scenario), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("xbar", [[0.2, 0.7, 0.45, 0.9, 0.1],
                                  [1.0, 1.0, 0.0, 1.0, 0.0]])
def test_xhat_evaluate_matches_jax(sslp8, xbar):
    """Candidates through the cold evaluation + rescue tiers, and the
    warm variant the fused spoke's fallback uses (LP relaxation: the
    candidate is x̄ itself, no integer slot to round)."""
    jb, tb = sslp8
    xbar = np.array([xbar], np.float32)
    jc = jxhat.round_integers(jb, xbar)
    tc = txhat.round_integers(tb, torch.as_tensor(xbar))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    opts = dict(tol=1e-6, max_iters=20_000, restart_period=40, omega0=0.1)
    jr = jxhat.evaluate(jb, jc, jpdhg.PDHGOptions(**opts))
    tr = txhat.evaluate(tb, tc, tpdhg.PDHGOptions(**opts))
    assert bool(tr.feasible) == bool(jr.feasible) is True
    assert float(tr.value) == pytest.approx(float(jr.value), rel=1e-4)
    assert txhat.comp_tight(tb, tr) == jxhat.comp_tight(jb, jr)
    np.testing.assert_array_equal(tr.status.numpy(), np.asarray(jr.status))
    st0 = tpdhg.init_state(tb.with_fixed_nonants(tc),
                           tpdhg.PDHGOptions(**opts))
    wr, wst = txhat.evaluate_warm(tb, tc, st0, tpdhg.PDHGOptions(**opts))
    assert bool(wr.feasible)
    assert float(wr.value) == pytest.approx(float(tr.value), rel=1e-4)


@pytest.mark.parametrize("mode", ["nearest", "ceil", "floor"])
def test_round_integers_matches_jax(mode):
    """The x̄ plane's rounding tiers on integer nonant slots (sslp
    without the LP relaxation's cleared integrality mask)."""
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=2)
             for nm in jsslp.scenario_names_creator(2)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    xbar = np.array([[0.2, 0.5, 0.995, 1.5, 0.006]], np.float32)
    np.testing.assert_array_equal(
        txhat.round_integers(tb, torch.as_tensor(xbar), mode).numpy(),
        np.asarray(jxhat.round_integers(jb, xbar, mode)))
