# Port parity: the uc model (models/uc.py), its scengen program, SepRho
# (extensions/rho_setters.py) and the uc wheel of bench.py's
# bench_uc_fwph, against the JAX package on the CPU.
#   * scenario specs: equal (the same numpy builders, RandomState seeds);
#   * the scengen program: the template and scaling equal; the demand
#     rows to 1e-6 relative (the AR(1) weight sum over the same threefry
#     normals adds 24 f32 terms in another order);
#   * SepRho's rho from the same iter0 nonants: 1e-5 relative;
#   * the wheel at S=4 (PH hub, rho 1 with SepRho(multiplier=2), the
#     FWPH spoke at rho 200, the fused Lagrangian, x̂-x̄ and slam planes,
#     spoke_sync_period 5), 20 hub iterations in each package from its own
#     cold state: both bounds finite and within 2e-3 relative of JAX's.
import dataclasses
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import hub as jhub
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.extensions import rho_setters as jrho
from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.scengen import virtual as jvirtual
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import scengen
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import hub as thub
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.extensions import rho_setters as trho
from mpisppy_tpu_torch.models import uc as tuc
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.ops.sparse import EllMatrix
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)


def _batches(S=4):
    ji, ti = juc.synthetic_instance(10, 24), tuc.synthetic_instance(10, 24)
    names = tuc.scenario_names_creator(S)
    return (jbatch.from_specs([juc.scenario_creator(nm, instance=ji,
                                                    num_scens=S)
                               for nm in names]),
            tbatch.from_specs([tuc.scenario_creator(nm, instance=ti,
                                                    num_scens=S)
                               for nm in names], device="cpu"))


@pytest.mark.parametrize("gens,hours,seed", [(10, 24, 0), (3, 6, 5)])
def test_uc_specs_match_jax(gens, hours, seed):
    ji = juc.synthetic_instance(gens, hours, seed)
    ti = tuc.synthetic_instance(gens, hours, seed)
    for nm in tuc.scenario_names_creator(3):
        js = juc.scenario_creator(nm, instance=ji, num_scens=3)
        ts = tuc.scenario_creator(nm, instance=ti, num_scens=3)
        assert (js.A != ts.A).nnz == 0
        for f in ("c", "bl", "bu", "l", "u", "nonant_idx", "integer"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert ts.probability == js.probability


def test_uc_program_materializes_like_jax():
    jp = juc.scenario_program(6, seed=3)
    tp = tuc.scenario_program(6, seed=3)
    np.testing.assert_array_equal(tp.scaling.d_row, jp.scaling.d_row)
    np.testing.assert_array_equal(tp.scaling.d_col, jp.scaling.d_col)
    tm = scengen.materialize(tp, device="cpu")
    jm = jvirtual.materialize(jp)
    assert isinstance(tm.qp.A, EllMatrix)
    np.testing.assert_array_equal(tm.qp.A.vals.numpy(),
                                  np.asarray(jm.qp.A.vals))
    for f in ("bl", "bu"):
        j = np.asarray(getattr(jm.qp, f))
        t = getattr(tm.qp, f).numpy()
        np.testing.assert_array_equal(np.isfinite(t), np.isfinite(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(t[fin], j[fin], rtol=1e-6)
    # host materialization and device synthesis are the same function
    th = tbatch.from_specs(tp.to_specs(), scaling=tp.scaling, device="cpu")
    assert torch.equal(th.qp.bl, tm.qp.bl) and torch.equal(th.qp.bu,
                                                           tm.qp.bu)
    assert torch.equal(th.qp.A.vals, tm.qp.A.vals)
    # at 1,000 scenarios the VirtualBatch holds the shared ELL A (and its
    # transposed pattern) once, the materialized batch (S, m) bound rows
    vb = scengen.virtual_batch(tuc.scenario_program(1000), device="cpu")
    assert vb.persistent_bytes() < vb.materialized_bytes() / 10


@dataclasses.dataclass(frozen=True)
class _Iter0State:
    """The part of a PH state SepRho reads and writes."""

    solver: object
    rho: object = None


def test_sep_rho_matches_jax():
    """SepRho's rule on the same iter0 nonants (a JAX iter0 solve)."""
    jb, tb = _batches()
    o = jpdhg.PDHGOptions(tol=1e-6)
    x = np.asarray(jpdhg.solve_fixed(jb.qp, 50, o,
                                     jpdhg.init_state(jb.qp, o)).x)
    phs = []
    for batch, xs, mod in ((jb, jnp.asarray(x), jrho),
                           (tb, torch.as_tensor(x), trho)):
        ph = types.SimpleNamespace(
            batch=batch, options=object(), rho=None,
            state=_Iter0State(solver=types.SimpleNamespace(x=xs)))
        mod.SepRho(ph, multiplier=2.0).post_iter0()
        phs.append(ph)
    jrho_, trho_ = np.asarray(phs[0].rho), phs[1].rho.numpy()
    np.testing.assert_allclose(trho_, jrho_, rtol=1e-5)
    np.testing.assert_array_equal(phs[1].state.rho.numpy(), trho_)
    assert np.all(trho_ > 0)


def _wheel(pkg, batch, iters):
    if pkg == "jax":
        ph_mod, pdhg, fw, sm, hm, spinner, rho = (
            jph, jpdhg, jfw, jspoke, jhub, JWheelSpinner, jrho)
    else:
        ph_mod, pdhg, fw, sm, hm, spinner, rho = (
            tph, tpdhg, tfw, tspoke, thub, TWheelSpinner, trho)
    ph_opts = ph_mod.PHOptions(
        default_rho=1.0, max_iterations=iters, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-6, restart_period=40,
                              iter_precision="bf16x3"))
    spoke_pdhg = pdhg.PDHGOptions(tol=1e-6, max_iters=4_000)
    spokes = [
        {"spoke_class": sm.FWPHOuterBound,
         "opt_kwargs": {"options": {"rho": 200.0,
                                    "pdhg_opts": spoke_pdhg}}},
        {"spoke_class": sm.FusedLagrangianOuterBound,
         "opt_kwargs": {"options": {}}},
        {"spoke_class": sm.FusedXhatXbarInnerBound,
         "opt_kwargs": {"options": {}}},
        {"spoke_class": sm.FusedSlamHeuristic,
         "opt_kwargs": {"options": {}}},
    ]
    hub = {"hub_class": hm.PHHub, "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": ph_opts, "batch": batch,
                          "wheel_options": fw.FusedWheelOptions(
                              slam_windows=2),
                          "extensions": functools.partial(rho.SepRho,
                                                          multiplier=2.0)},
           "hub_kwargs": {"options": {"rel_gap": 0.01,
                                      "spoke_sync_period": 5}}}
    return spinner(hub, spokes).spin()


def test_uc_wheel_matches_jax():
    jb, tb = _batches()
    jw = _wheel("jax", jb, 20)
    tw = _wheel("torch", tb, 20)
    for j, t in ((jw.BestOuterBound, tw.BestOuterBound),
                 (jw.BestInnerBound, tw.BestInnerBound)):
        assert np.isfinite(j) and np.isfinite(t)
        assert t == pytest.approx(j, rel=2e-3)
    assert tw.BestOuterBound <= tw.BestInnerBound
    # SepRho replaced the scalar default rho with per-slot values
    assert tw.opt.state.rho.shape == (tb.num_nonants,)
    assert float(tw.opt.state.rho.std()) > 0
