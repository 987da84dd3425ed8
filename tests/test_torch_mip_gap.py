# Port parity: the certified MIP gap driver (mpisppy_tpu_torch/algos/
# mip.py::certified_mip_gap: LP PH, candidate first stages, the MIP
# inner and Lagrangian outer bounds, first-stage decomposition B&B)
# against the JAX package on the CPU, on synthetic sslp 4x8 with integer
# recourse at S=4 (the batch carried across by convert.py), with the
# same lean budgets in both (PH 20 iterations at rho 10, B&B pool 16 and
# 60 rounds, no pump, 2 decomposition nodes).  Both brackets must contain
# the scipy HiGHS MILP optimum of the extensive form and overlap each
# other; the inner values agree to 2 gap_tol where both gaps closed.
import numpy as np
import torch

from mpisppy_tpu.algos import mip as jmip
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops.bnb import BnBOptions as JOpts
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import mip as tmip
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.ops.bnb import BnBOptions as TOpts

from test_mip_bnb import _sslp_ef_oracle

torch.set_num_threads(1)

LEAN = dict(gap_tol=1e-3, pool_size=16, max_rounds=60, dive_tail=16,
            pump_rounds=0)
PH = dict(max_iterations=20, default_rho=10.0)


def test_certified_mip_gap_matches_jax_and_oracle():
    inst = jsslp.synthetic_instance(4, 8, seed=2)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=4)
             for nm in jsslp.scenario_names_creator(4)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    ref = _sslp_ef_oracle(specs)
    j = jmip.certified_mip_gap(jb, jph.PHOptions(**PH), JOpts(**LEAN),
                               dd_nodes=2)
    t = tmip.certified_mip_gap(tb, tph.PHOptions(**PH), TOpts(**LEAN),
                               dd_nodes=2)
    tol = 2e-3 * (1.0 + abs(ref))
    for r in (j, t):
        assert np.isfinite(r.inner) and np.isfinite(r.outer)
        assert r.outer <= ref + tol and r.inner >= ref - tol, (r, ref)
    assert t.outer <= j.inner + tol and j.outer <= t.inner + tol
    if j.gap <= LEAN["gap_tol"] and t.gap <= LEAN["gap_tol"]:
        assert abs(t.inner - j.inner) <= 2 * LEAN["gap_tol"] * (1 + abs(ref))
    assert t.xhat.shape == (jb.num_nonants,)
    assert t.trivial_bound <= ref + tol
