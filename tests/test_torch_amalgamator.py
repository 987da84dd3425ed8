# Port parity: the Amalgamator (mpisppy_tpu_torch/utils/amalgamator.py)
# and the wheel's extension hook sequence against the JAX package's, the
# cases of tests/test_amalgamator_hooks.py.  Farmer S=3: the EF through
# both Amalgamators (1e-4 relative), a decomposition wheel through both
# (its bounds at 1e-3), and the hook record of a wheel with a hub-side
# TestExtension, which equals the JAX package's list.
import numpy as np
import pytest
import torch

from mpisppy_tpu.utils import amalgamator as jama
from mpisppy_tpu.utils.config import Config as JConfig
from mpisppy_tpu_torch.utils import amalgamator as tama
from mpisppy_tpu_torch.utils.config import Config

torch.set_num_threads(1)


def _cfg(cls, port, **kw):
    cfg = cls()
    cfg.popular_args()
    cfg.ph_args()
    cfg.two_sided_args()
    cfg.quick_assign("num_scens", int, 3)
    if port:
        cfg.quick_assign("device", str, "cpu")
    for k, v in kw.items():
        cfg.quick_assign(k, type(v), v)
    return cfg


def test_amalgamator_ef_equals_jax():
    j = jama.from_module("mpisppy_tpu.models.farmer",
                         _cfg(JConfig, False, EF=True))
    t = tama.from_module("mpisppy_tpu_torch.models.farmer",
                         _cfg(Config, True, EF=True))
    j.run()
    t.run()
    assert t.EF_Obj == pytest.approx(j.EF_Obj, rel=1e-4)
    assert abs(t.EF_Obj - (-108390.0)) / 108390.0 < 1e-3
    assert t.best_inner_bound == t.best_outer_bound == t.EF_Obj
    np.testing.assert_allclose(t.first_stage_solution,
                               j.first_stage_solution, rtol=1e-3, atol=1e-2)


def test_amalgamator_decomp_equals_jax():
    kw = dict(max_iterations=20, default_rho=1.0, lagrangian=True,
              xhatxbar=True, rel_gap=0.01, display_progress=False)
    j = jama.from_module("mpisppy_tpu.models.farmer", _cfg(JConfig, False,
                                                           **kw))
    t = tama.from_module("mpisppy_tpu_torch.models.farmer",
                         _cfg(Config, True, **kw))
    j.run()
    t.run()
    assert t.wheel is not None
    assert t.best_outer_bound == pytest.approx(j.best_outer_bound, rel=1e-3)
    assert t.best_inner_bound == pytest.approx(j.best_inner_bound, rel=1e-3)
    assert t.best_outer_bound <= -108390.0 + 200
    assert t.best_inner_bound >= -108390.0 - 200
    assert len(t.first_stage_solution) == 3
    np.testing.assert_allclose(t.first_stage_solution,
                               j.first_stage_solution, rtol=1e-2, atol=1.0)


def test_amalgamator_refuses_an_incomplete_module():
    import types

    mod = types.SimpleNamespace(scenario_creator=None)
    with pytest.raises(RuntimeError, match="five-function"):
        tama.Amalgamator(_cfg(Config, True), mod)


def test_amalgamator_from_the_command_line():
    t = tama.from_module(
        "mpisppy_tpu_torch.models.farmer", None, use_command_line=True,
        args=["--module-name", "mpisppy_tpu_torch.models.farmer",
              "--num-scens", "3", "--EF", "--device", "cpu"])
    t.run()
    assert abs(t.EF_Obj - (-108390.0)) / 108390.0 < 1e-3


def test_wheel_drives_hub_side_extension_hooks():
    """The full hook plane of a wheel run, in both packages: the hub
    drives setup_hub / initialize_spoke_indices at wheel setup and
    sync_with_spokes at every sync, between PH's own callouts; the two
    records are the same list."""
    from mpisppy_tpu.algos import ph as jph
    from mpisppy_tpu.core import batch as jbatch
    from mpisppy_tpu.cylinders import hub as jhub
    from mpisppy_tpu.cylinders.spoke import LagrangianOuterBound as JLag
    from mpisppy_tpu.extensions.test_extension import TestExtension as JT
    from mpisppy_tpu.models import farmer as jfarmer
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWS
    from mpisppy_tpu_torch import convert
    from mpisppy_tpu_torch.algos import ph as tph
    from mpisppy_tpu_torch.cylinders import hub as thub
    from mpisppy_tpu_torch.cylinders.spoke import LagrangianOuterBound
    from mpisppy_tpu_torch.extensions.test_extension import TestExtension
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

    specs = [jfarmer.scenario_creator(nm, num_scens=3)
             for nm in jfarmer.scenario_names_creator(3)]
    jb = jbatch.from_specs(specs)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    calls = {}
    for side, hub_mod, ph_mod, b, ext, lag, ws in (
            ("jax", jhub, jph, jb, JT, JLag, JWS),
            ("port", thub, tph, tb, TestExtension, LagrangianOuterBound,
             WheelSpinner)):
        hub = {"hub_class": hub_mod.PHHub,
               "hub_kwargs": {"options": {"rel_gap": 1e-9}},
               "opt_class": ph_mod.PH,
               "opt_kwargs": {"options": ph_mod.PHOptions(max_iterations=3),
                              "batch": b, "extensions": ext}}
        spokes = [{"spoke_class": lag, "opt_kwargs": {"options": {}}}]
        calls[side] = ws(hub, spokes).spin().opt._TestExtension_who_is_called
    assert calls["port"] == calls["jax"]
    c = calls["port"]
    assert c[:7] == ["setup_hub", "initialize_spoke_indices", "pre_iter0",
                     "iter0_post_solver_creation", "post_iter0",
                     "sync_with_spokes", "post_iter0_after_sync"], c
    assert c[7:13] == ["miditer", "pre_solve_loop", "post_solve_loop",
                       "enditer", "sync_with_spokes",
                       "enditer_after_sync"], c
    assert c[-1] == "post_everything"
    assert len(set(c)) == 13
