# Port parity: usar's certified MIP bracket on the CPU.  certified_mip_gap
# on the JAX usar test's instance (3 depots, 5 sites, horizon 4, one
# active depot, 3 scenarios; tests/test_models_zoo2.py) with its options
# in both packages: the port's bracket must overlap the JAX package's and
# contain scipy's MILP optimum of the extensive form, to 2e-3 of
# (1 + |optimum|) (chip_smoke.py's in_bracket).  MIP searches diverge on
# f32-level node-LP differences (ROADMAP C1), so brackets are compared,
# never search paths.  A file of its own: the two runs take ~60 s.
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import mip as jmip
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.algos.ef import build_ef as jbuild_ef
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import usar as jusar
from mpisppy_tpu.ops import bnb as jbnb
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch.algos import mip as tmip
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import usar as tusar
from mpisppy_tpu_torch.ops import bnb as tbnb
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)


def test_usar_certified_bracket():
    """certified_mip_gap on the JAX usar test's instance: the port's
    bracket overlaps the JAX package's and contains scipy's MILP optimum
    of the extensive form; the incumbent activates exactly one depot."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    kw = dict(num_depots=3, num_sites=5, time_horizon=4,
              num_active_depots=1, seed=2)
    names = jusar.scenario_names_creator(3)
    jspecs = [jusar.scenario_creator(nm, instance=jusar.generate_instance(
        **kw), num_scens=3) for nm in names]
    tspecs = [tusar.scenario_creator(nm, instance=tusar.generate_instance(
        **kw), num_scens=3) for nm in names]
    efp = jbuild_ef(jspecs, scale=False, sparse=False)
    n = efp.n_per_scen
    q = efp.qp
    opt = milp(np.asarray(q.c, float), constraints=LinearConstraint(
        np.asarray(q.A, float), np.asarray(q.bl, float),
        np.asarray(q.bu, float)),
        bounds=Bounds(np.asarray(q.l, float), np.asarray(q.u, float)),
        integrality=np.tile(jspecs[0].integer, len(jspecs)).astype(int)).fun
    assert n == jspecs[0].c.shape[0]

    def run(mip_mod, ph_mod, pdhg_mod, bnb_mod, batch):
        return mip_mod.certified_mip_gap(
            batch, ph_options=ph_mod.PHOptions(
                default_rho=5.0, max_iterations=60, conv_thresh=1e-3,
                pdhg=pdhg_mod.PDHGOptions(tol=1e-6)),
            opts=bnb_mod.BnBOptions(max_rounds=120), dd_nodes=4)
    jres = run(jmip, jph, jpdhg, jbnb, jbatch.from_specs(jspecs))
    tres = run(tmip, tph, tpdhg, tbnb, tbatch.from_specs(tspecs,
                                                         device="cpu"))
    tol = 2e-3 * (1.0 + abs(opt))
    assert tres.outer <= opt + tol and tres.inner >= opt - tol
    assert tres.outer <= jres.inner + tol and jres.outer <= tres.inner + tol
    assert np.round(tres.xhat[:3]).sum() == pytest.approx(1.0)
