# Port parity: the Schur-complement interior point (algos/sc.py), held to
# the values tests/test_sc.py asserts — the scipy EF optimum (HiGHS
# linprog; trust-constr for the QP) and the textbook farmer acres — not
# to the JAX package, whose solve needs jax.experimental.enable_x64
# (absent from this JAX).  Tolerances are tests/test_sc.py's: farmer LP
# 1e-5 relative with x within 0.1 acre, the quadratic farmer 1e-4, the
# sslp 3x9 LP relaxation 1e-4, and the same 1e-4 for the sslp 5x15
# relaxation at S=16 (tol 1e-12; it lands 1.8e-5 from HiGHS, where the
# JAX algorithm run under x64 lands too: ROADMAP C).  The port runs in
# f64 on the batch's device (the CPU here).
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.algos.sc import SchurComplement, SCOptions
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import farmer, sslp

from test_farmer_ef_ph import farmer_specs, scipy_ef_solve
from test_sc import scipy_qp_oracle

torch.set_num_threads(1)


def _farmer(S=3, q=None):
    specs = [farmer.scenario_creator(nm, num_scens=S)
             for nm in farmer.scenario_names_creator(S)]
    if q is not None:
        specs = [dataclasses.replace(
            sp, q=np.concatenate([q, np.zeros(sp.c.shape[0] - len(q))]))
            for sp in specs]
    return tbatch.from_specs(specs, device="cpu")


def _sslp(n_fac, n_cli, S, seed=None):
    kw = {} if seed is None else {"seed": seed}
    inst = sslp.synthetic_instance(n_fac, n_cli, **kw)
    return [sslp.scenario_creator(nm, instance=inst, num_scens=S,
                                  lp_relax=True)
            for nm in sslp.scenario_names_creator(S)]


def test_sc_farmer_matches_ef():
    sobj, _ = scipy_ef_solve(farmer_specs(3))
    res = SchurComplement(SCOptions(max_iter=60, tol=1e-8),
                          _farmer()).solve()
    assert res["converged"]
    assert res["objective"] == pytest.approx(sobj, rel=1e-5)
    np.testing.assert_allclose(res["x"], [170.0, 80.0, 250.0], atol=0.1)


def test_sc_farmer_quadratic():
    q = np.full(3, 0.1)
    jspecs = [dataclasses.replace(
        sp, q=np.concatenate([q, np.zeros(sp.c.shape[0] - 3)]))
        for sp in farmer_specs(3)]
    sobj, _ = scipy_qp_oracle(jspecs)
    res = SchurComplement(SCOptions(max_iter=60, tol=1e-8),
                          _farmer(q=q)).solve()
    assert res["converged"]
    assert res["objective"] == pytest.approx(sobj, rel=1e-4)


@pytest.mark.parametrize("size,S,opts,rel", [
    ((3, 9, 2), 4, SCOptions(max_iter=250, tol=1e-10), 1e-4),
    ((5, 15, None), 16, SCOptions(max_iter=250, tol=1e-12), 1e-4)])
def test_sc_sslp_lp_relaxation(size, S, opts, rel):
    specs = _sslp(*size[:2], S, seed=size[2])
    sobj, _ = scipy_ef_solve(specs)
    res = SchurComplement(opts, tbatch.from_specs(specs,
                                                  device="cpu")).solve()
    assert res["converged"]
    assert res["objective"] == pytest.approx(sobj, rel=rel)


def test_sc_rejects_integer_and_multistage():
    inst = sslp.synthetic_instance(3, 9, seed=2)
    specs = [sslp.scenario_creator("Scenario0", instance=inst,
                                   num_scens=1, lp_relax=False)]
    with pytest.raises(ValueError, match="continuous"):
        SchurComplement(SCOptions(), tbatch.from_specs(specs, device="cpu"))
    from mpisppy_tpu_torch.models import ccopf
    cspecs = [ccopf.scenario_creator(nm, branching_factors=(2, 2))
              for nm in ccopf.scenario_names_creator(4)]
    cb = tbatch.from_specs(cspecs, tree=ccopf.make_tree((2, 2)),
                           device="cpu")
    with pytest.raises(ValueError, match="two-stage|equality"):
        SchurComplement(SCOptions(), cb)


def test_sc_backend_and_timing_recorded():
    """The result records where the f64 loop ran and how long it took;
    its iterates are f64 (never dropped to f32)."""
    res = SchurComplement({}, _farmer()).solve()
    assert res["backend_used"] == "cpu"
    assert res["solve_seconds"] > 0.0
    assert res["converged"]
    assert res["x"].dtype == np.float64 and res["v"].dtype == np.float64
