# Port parity: the sslp fused PH wheel end to end — the mirror of
# tests/test_fused_wheel.py::test_fused_wheel_sslp_matches_classic_bracket.
# WheelSpinner(hub_dict, spokes).spin() runs a PH hub with the fused
# Lagrangian outer bound and the fused x̂-x̄ inner bound on sslp(5,15) at
# S=16, once per dispatch path, in the JAX package and in the port from
# the same batch and norm estimate.  The port must certify rel_gap <= 1%
# and its bounds must lie within 1e-3 relative of the JAX wheel's (both
# run f32; the port's shared-A windows take the kernel's hoisted form).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import fused_wheel as jfw
from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.cylinders import spoke as jspoke
from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import fused_wheel as tfw
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.cylinders import spoke as tspoke
from mpisppy_tpu_torch.cylinders.hub import PHHub as TPHHub
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TWheelSpinner

torch.set_num_threads(1)


def jax_norm_estimate(p, iters=30, generator=None):
    arrs = convert.arrays_of(p)
    jp = jboxqp.BoxQP(**{k: jnp.asarray(arrs[k])
                         for k in ("c", "q", "A", "bl", "bu", "l", "u")})
    return torch.as_tensor(np.array(jpdhg.estimate_norm(jp, iters)))


def _wheel(ph_mod, pdhg_mod, fw_mod, spoke_mod, hub_cls, spinner, batch,
           split):
    opts = ph_mod.PHOptions(default_rho=20.0, max_iterations=200,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg_mod.PDHGOptions(tol=1e-7))
    hub = {"hub_class": hub_cls,
           "hub_kwargs": {"options": {"rel_gap": 1e-2}},
           "opt_class": fw_mod.FusedPH,
           "opt_kwargs": {"options": opts, "batch": batch,
                          "wheel_options": fw_mod.FusedWheelOptions(
                              split_dispatch=split)}}
    spokes = [{"spoke_class": spoke_mod.FusedLagrangianOuterBound,
               "opt_kwargs": {"options": {}}},
              {"spoke_class": spoke_mod.FusedXhatXbarInnerBound,
               "opt_kwargs": {"options": {}}}]
    return spinner(hub, spokes).spin()


@pytest.fixture(scope="module")
def sslp16():
    """The sslp(5,15) S=16 batch and the JAX wheel's bounds on it (the
    JAX package's own dispatch choice at S=16: one fused program; its
    split path agrees with it to ~1e-4 on these bounds)."""
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=16,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(16)]
    jb = jbatch.from_specs(specs)
    jws = _wheel(jph, jpdhg, jfw, jspoke, JPHHub, JWheelSpinner, jb, None)
    return jb, (jws.BestOuterBound, jws.BestInnerBound)


@pytest.mark.parametrize("split", [True, False])
def test_sslp_fused_wheel_matches_jax(split, sslp16, monkeypatch):
    monkeypatch.setattr(tpdhg, "estimate_norm", jax_norm_estimate)
    jb, jbounds = sslp16
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    tws = _wheel(tph, tpdhg, tfw, tspoke, TPHHub, TWheelSpinner, tb, split)
    outer, inner = tws.BestOuterBound, tws.BestInnerBound
    assert np.isfinite(inner) and np.isfinite(outer)
    assert (inner - outer) / abs(inner) <= 1e-2 + 1e-6
    assert outer <= inner
    for t, j in zip((outer, inner), jbounds):
        assert abs(t - j) <= 1e-3 * abs(j), (t, j)
    # the incumbent's solution is retrievable, one row per tree node
    assert tws.spcomm.best_nonants().shape == (1, tb.num_nonants)
    assert len(tws.spcomm.trace) == tws.spcomm._iter


def test_wheel_never_launches_the_kernel_on_cpu_tensors():
    """On the CPU the wrapper takes the plain version: the kernel's
    launch count does not move."""
    inst = tsslp.synthetic_instance(5, 15, seed=0)
    specs = [tsslp.scenario_creator(nm, instance=inst, num_scens=4,
                                    lp_relax=True)
             for nm in tsslp.scenario_names_creator(4)]
    tb = tbatch.from_specs(specs, device="cpu")
    before = dict(pdhg_window.run_window.launches)
    opts = tph.PHOptions(default_rho=20.0, max_iterations=2,
                         conv_thresh=0.0, iter0_windows=4)
    hub = {"hub_class": TPHHub, "hub_kwargs": {"options": {"rel_gap": 1e-2}},
           "opt_class": tfw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": tb}}
    ws = TWheelSpinner(hub, [
        {"spoke_class": tspoke.FusedLagrangianOuterBound,
         "opt_kwargs": {"options": {}}}]).spin()
    assert ws.spcomm._iter == 3  # the sync after Iter0, then two
    assert dict(pdhg_window.run_window.launches) == before


def test_slam_and_shuffle_planes_are_refused():
    specs = [tsslp.scenario_creator(nm, n_servers=3, n_clients=4,
                                    num_scens=2, lp_relax=True)
             for nm in tsslp.scenario_names_creator(2)]
    tb = tbatch.from_specs(specs, device="cpu")
    with pytest.raises(NotImplementedError, match="slam"):
        tfw.FusedPH(tph.PHOptions(), tb,
                    wheel_options=tfw.FusedWheelOptions(slam_windows=1))
