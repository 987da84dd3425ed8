# Port parity: cross-scenario cuts (algos/cross_scen.py, the hub's
# CrossScenarioExtension and the CrossScenarioCutSpoke), after
# tests/test_cross_scen.py, against the JAX package on the CPU.
#
# Tolerances: the augmented views (per-scenario dense A: farmer; shared
# dense A: sslp 5x15; shared ELL A: uc 3x6) equal the JAX package's
# bit for bit, before and after the same cut packages are written; one
# launch_cuts from the same nonants gives g and the cut's value at the
# candidate within 1e-5 of their scale and alpha within 1e-4 (x̂ ~ 10^2
# multiplies g's f32 noise); every farmer optimality cut lower-bounds the true
# recourse value at another candidate (to 1.0, as the JAX test); the EF
# check bound from the same meta after 40 windows agrees to 1e-5
# relative, and lies below the scipy EF optimum after 40 and 400.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import cross_scen as jcs
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import cross_scen as tcs
from mpisppy_tpu_torch.algos import xhat as txhat
from mpisppy_tpu_torch.ops import pdhg as tpdhg

from test_farmer_ef_ph import farmer_specs, scipy_ef_solve

torch.set_num_threads(1)


def _specs(model):
    if model == "farmer":
        return farmer_specs(3)
    if model == "sslp":
        from mpisppy_tpu.models import sslp
        inst = sslp.synthetic_instance(5, 15)
        return [sslp.scenario_creator(nm, instance=inst, num_scens=4,
                                      lp_relax=True)
                for nm in sslp.scenario_names_creator(4)]
    from mpisppy_tpu.models import uc
    inst = uc.synthetic_instance(3, 6)
    return [uc.scenario_creator(nm, instance=inst, num_scens=3)
            for nm in uc.scenario_names_creator(3)]


def _batches(model):
    jb = jbatch.from_specs(_specs(model))
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def _opts(mod):
    return mod.PDHGOptions(tol=1e-7, max_iters=100_000, detect_infeas=True)


def _assert_views_equal(tmeta, jmeta):
    for view in ("aug_ph", "aug_ef"):
        t = convert.arrays_of(getattr(tmeta, view))
        j = convert.arrays_of(getattr(jmeta, view))
        for k in ("c", "q", "l", "u", "bl", "bu"):
            np.testing.assert_array_equal(t["qp"][k], j["qp"][k],
                                          err_msg=f"{view} {k}")
        tA, jA = t["qp"]["A"], j["qp"]["A"]
        if isinstance(jA, dict):
            for k in ("vals", "cols"):
                np.testing.assert_array_equal(tA[k], jA[k],
                                              err_msg=f"{view} A.{k}")
        else:
            np.testing.assert_array_equal(tA, jA, err_msg=f"{view} A")
        for k in ("d_col", "d_row"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{view} {k}")
    np.testing.assert_array_equal(tmeta.is_opt, jmeta.is_opt)
    assert tmeta.rounds_used == jmeta.rounds_used


@pytest.mark.parametrize("model", ["farmer", "sslp", "uc"])
def test_augmented_views_match_jax(model):
    jb, tb = _batches(model)
    S, n, m = tb.num_scenarios, tb.qp.n, tb.qp.m
    eta_lb = np.full(S, -1e6)
    jmeta = jcs.make_meta(jb, eta_lb, max_rounds=2)
    tmeta = tcs.make_meta(tb, eta_lb, max_rounds=2)
    assert tmeta.aug_ph.qp.n == n and tmeta.aug_ph.qp.m == m + 2 * S
    assert tmeta.aug_ef.qp.n == n + S and tmeta.aug_ef.qp.m == m + 2 * S
    assert (type(tmeta.aug_ph.qp.A).__name__ == "EllMatrix") == \
        (model == "uc")
    _assert_views_equal(tmeta, jmeta)
    if model != "uc":
        # the PH view still solves with its rows inactive (uc's LP needs
        # more than this budget at 1e-6 with or without the rows)
        st = tpdhg.solve(tmeta.aug_ph.qp,
                         tpdhg.PDHGOptions(tol=1e-6, max_iters=100_000))
        assert bool(st.done.all())


def test_cuts_match_jax_and_are_valid_on_farmer():
    jb, tb = _batches("farmer")
    jo, to = _opts(jpdhg), _opts(tpdhg)
    st = jpdhg.solve(jb.qp, jo)
    x_non = np.asarray(jb.nonants(st.x))
    xbar = x_non.mean(0, keepdims=True)
    jpkg = jcs.package_cuts(jcs.launch_cuts(jb, jnp.asarray(x_non),
                                            jnp.asarray(xbar), jo), jo)
    tpkg = tcs.package_cuts(tcs.launch_cuts(tb, torch.tensor(x_non),
                                            torch.tensor(xbar), to), to)
    np.testing.assert_array_equal(tpkg["xhat"], jpkg["xhat"])
    for k in ("infeas", "usable"):
        np.testing.assert_array_equal(tpkg[k], jpkg[k])
    # g to 1e-5 of its scale, the cut's value at the candidate (the
    # dual value) to 1e-5, alpha = value - g·x̂ to 1e-4: x̂ (~10^2 acres)
    # multiplies g's f32 noise
    np.testing.assert_allclose(tpkg["opt_g"], jpkg["opt_g"], rtol=0,
                               atol=1e-5 * np.abs(jpkg["opt_g"]).max())
    x0 = jpkg["xhat"]
    jval = jpkg["opt_alpha"] + jpkg["opt_g"] @ x0
    np.testing.assert_allclose(tpkg["opt_alpha"] + tpkg["opt_g"] @ x0,
                               jval, rtol=0, atol=1e-5 * np.abs(jval).max())
    np.testing.assert_allclose(tpkg["opt_alpha"], jpkg["opt_alpha"],
                               rtol=0,
                               atol=1e-4 * np.abs(jpkg["opt_alpha"]).max())
    assert not tpkg["infeas"].any()  # farmer recourse is always feasible
    # weak duality: each cut lower-bounds f_s at another candidate
    res = txhat.evaluate(tb, torch.as_tensor(xbar[0]), to)
    cut_vals = tpkg["opt_alpha"] + tpkg["opt_g"] @ xbar[0]
    assert (cut_vals <= res.per_scenario.numpy() + 1.0).all()


@pytest.mark.parametrize("model", ["farmer", "sslp"])
def test_write_cuts_and_ef_check_bound_match_jax(model):
    jb, tb = _batches(model)
    jo, to = _opts(jpdhg), _opts(tpdhg)
    eta_lb = jcs.eta_lower_bounds(jb, jo)
    np.testing.assert_allclose(tcs.eta_lower_bounds(tb, to), eta_lb,
                               rtol=1e-5, atol=1e-5)
    jmeta = jcs.make_meta(jb, eta_lb, max_rounds=4)
    tmeta = convert.cross_scen_meta_from_arrays(convert.arrays_of(jmeta),
                                                "cpu")
    st = jpdhg.solve(jb.qp, jo)
    x_non = jb.nonants(st.x)
    # three rounds, each at the scenario farthest from another point
    for r in range(3):
        pkg = jcs.package_cuts(jcs.launch_cuts(jb, x_non, x_non[r:r + 1],
                                               jo), jo)
        jcs.write_cuts(jmeta, pkg)
        tcs.write_cuts(tmeta, pkg)
    _assert_views_equal(tmeta, jmeta)
    # 40 windows from the same start: the same certified bound; the
    # default 400 truncated windows drift apart at the f32 floor, and
    # both stay valid
    jbound, _ = jcs.ef_check_bound(jmeta, jo, windows=40)
    tbound, _ = tcs.ef_check_bound(tmeta, to, windows=40)
    assert tbound is not None and jbound is not None
    assert tbound == pytest.approx(jbound, rel=1e-5)
    sobj, _ = scipy_ef_solve(_specs(model))
    for b in (tbound, tcs.ef_check_bound(tmeta, to)[0]):
        assert b is None or b <= sobj + 1e-3 * max(1.0, abs(sobj))
    # the ring buffer: a fifth round overwrites round 1's rows
    for r in range(2):
        pkg = jcs.package_cuts(jcs.launch_cuts(jb, x_non, x_non[r:r + 1],
                                               jo), jo)
        jcs.write_cuts(jmeta, pkg)
        tcs.write_cuts(tmeta, pkg)
    assert tmeta.rounds_used == 5
    _assert_views_equal(tmeta, jmeta)


def test_cross_scen_wheel_matches_jax():
    """The CLI's --cross-scenario-cuts on a PH hub over sslp 5x15 (S=8,
    rho 20) with a Lagrangian and a shuffle spoke: cuts are installed,
    the PH batch is the row-augmented view, and the bounds agree with
    the JAX CLI's to 1e-3 relative."""
    from mpisppy_tpu import generic_cylinders as jgc
    from mpisppy_tpu.models import sslp as jm
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheel
    from mpisppy_tpu_torch import generic_cylinders as tgc
    args = ["--num-scens", "8", "--sslp-lp-relax", "--rel-gap", "0.01",
            "--cross-scenario-cuts", "--cross-scenario-iter-cnt", "2",
            "--lagrangian", "--xhatshuffle", "--max-iterations", "8",
            "--default-rho", "20"]
    jcfg = jgc._parse_args(jm, ["--module-name", "mpisppy_tpu.models.sslp"]
                           + args)
    jhub, jspokes, *_ = jgc.build_wheel(jcfg, jm)
    jw = JWheel(jhub, jspokes).spin()
    tw = tgc.main(["--module-name", "mpisppy_tpu_torch.models.sslp",
                   "--device", "cpu"] + args)
    ext = tw.opt.extobject
    assert ext.cuts_installed > 0
    assert tw.opt.batch.qp.m == ext.meta.aug_ph.qp.m
    assert tw.BestOuterBound == pytest.approx(jw.BestOuterBound, rel=1e-3)
    assert tw.BestInnerBound == pytest.approx(jw.BestInnerBound, rel=1e-3)
