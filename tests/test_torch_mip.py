# Port parity: the certified MIP oracles of mpisppy_tpu_torch/algos/mip.py
# against the JAX package on the CPU, on synthetic sslp 4x8 with integer
# recourse at S=4 (the batch carried from the JAX package by convert.py),
# with the scipy HiGHS MILP of the extensive form as the oracle
# (tests/test_mip_bnb.py::_sslp_ef_oracle):
#   * lagrangian_mip_bound at a mean-zero W: both bounds lie below the
#     oracle, and each scenario's port bracket overlaps the JAX one;
#   * evaluate_mip and evaluate_mip_many: every value at or above the
#     oracle, equal to the per-scenario MILPs with the first stage fixed
#     (2e-3 relative), and the two packages' values equal (to 2 gap_tol)
#     where both closed their gap;
#   * ef_mip: both brackets contain the oracle and overlap, inner values
#     equal (to 2 gap_tol) where both closed.
# Both packages run the same lean budgets (the certificate holds at any
# budget; closure is not what is compared).  certified_mip_gap is in
# tests/test_torch_mip_gap.py.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ef as jef
from mpisppy_tpu.algos import mip as jmip
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops.bnb import BnBOptions as JOpts
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ef as tef
from mpisppy_tpu_torch.algos import mip as tmip
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops.bnb import BnBOptions as TOpts

from test_mip_bnb import _sslp_ef_oracle, milp_oracle

torch.set_num_threads(1)

LEAN = dict(gap_tol=1e-3, pool_size=16, max_rounds=60, dive_tail=16,
            pump_rounds=0, swap_rounds=-1)
GAP_TOL = LEAN["gap_tol"]


@pytest.fixture(scope="module")
def sslp48():
    inst = jsslp.synthetic_instance(4, 8, seed=2)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=4)
             for nm in jsslp.scenario_names_creator(4)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    return specs, jb, tb, _sslp_ef_oracle(specs)


def _tol(ref, k=2e-3):
    return k * (1.0 + abs(ref))


def test_lagrangian_mip_bound_matches_jax(sslp48):
    specs, jb, tb, ref = sslp48
    W = np.random.RandomState(1).randn(4, jb.num_nonants).astype(np.float32)
    W -= W.mean(axis=0)
    j = jmip.lagrangian_mip_bound(jb, jnp.asarray(W), JOpts(**LEAN))
    t = tmip.lagrangian_mip_bound(tb, torch.as_tensor(W), TOpts(**LEAN))
    for r in (j, t):
        assert np.isfinite(r["bound"]) and r["bound"] <= ref + _tol(ref)
    jr, tr = j["result"], t["result"]
    jo, ji = np.asarray(jr.outer), np.asarray(jr.inner)
    to, ti = tr.outer.numpy(), tr.inner.numpy()
    scale = 1.0 + np.abs(ji)
    assert np.all(to <= ji + 1e-3 * scale) and np.all(jo <= ti + 1e-3 * scale)
    assert t["bound"] == pytest.approx(j["bound"], rel=1e-2, abs=1e-2)


def _per_scenario_oracle(specs, xhat):
    vals = []
    for sp in specs:
        l, u = sp.l.copy(), sp.u.copy()  # noqa: E741
        l[sp.nonant_idx] = xhat
        u[sp.nonant_idx] = xhat
        r = milp_oracle(sp.c, sp.A, sp.bl, sp.bu, l, u, sp.integer)
        assert r.success
        vals.append(r.fun)
    return float(np.mean(vals))


def test_evaluate_mip_and_many_match_jax(sslp48):
    specs, jb, tb, ref = sslp48
    cands = [np.ones(4, np.float32), np.array([1, 0, 1, 1], np.float32)]
    j1 = jmip.evaluate_mip(jb, jnp.asarray(cands[0]), JOpts(**LEAN))
    t1 = tmip.evaluate_mip(tb, cands[0], TOpts(**LEAN))
    jm = jmip.evaluate_mip_many(jb, cands, JOpts(**LEAN))
    tm = tmip.evaluate_mip_many(tb, cands, TOpts(**LEAN))
    assert len(tm) == 2 and np.array_equal(tm[1]["xhat"], cands[1])
    for k, xhat in enumerate(cands):
        exact = _per_scenario_oracle(specs, xhat)
        evs = [jm[k], tm[k]] + ([j1, t1] if k == 0 else [])
        for ev in evs:
            assert ev["feasible"]
            assert ev["value"] >= ref - _tol(ref)
            assert ev["value"] == pytest.approx(exact, abs=_tol(exact))
            assert ev["value_lower"] <= exact + _tol(exact)
        assert abs(tm[k]["value"] - jm[k]["value"]) \
            <= 2 * GAP_TOL * (1.0 + abs(exact))


def test_ef_mip_matches_jax_and_oracle(sslp48):
    specs, _, _, ref = sslp48
    j = jmip.ef_mip(jef.build_ef(specs), specs, JOpts(**LEAN))
    tspecs = [tsslp.scenario_creator(sp.name, instance=tsslp.
                                     synthetic_instance(4, 8, seed=2),
                                     num_scens=4) for sp in specs]
    t = tmip.ef_mip(tef.build_ef(tspecs, device="cpu"), tspecs,
                    TOpts(**LEAN))
    for r in (j, t):
        assert r["outer"] <= ref + _tol(ref), (r, ref)
        assert r["inner"] >= ref - _tol(ref), (r, ref)
    assert t["outer"] <= j["inner"] + _tol(ref)
    assert j["outer"] <= t["inner"] + _tol(ref)
    if j["gap"] <= GAP_TOL and t["gap"] <= GAP_TOL:
        assert abs(t["inner"] - j["inner"]) <= 2 * GAP_TOL * (1 + abs(ref))
    assert t["x"].shape == (4, tef.build_ef(tspecs, device="cpu").n_per_scen)
