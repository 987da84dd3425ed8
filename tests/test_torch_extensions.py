# Port parity: the extension plane and the convergers
# (mpisppy_tpu_torch/extensions/, convergers/) against the JAX package's,
# the cases of tests/test_extensions.py.  The JAX package runs PH and
# records its state at every enditer; each case then puts the same state
# (carried across with mpisppy_tpu_torch.convert) into a JAX PH object
# and a port one and calls the same hook on both, so the rows, rhos, boxes
# and files are compared at 1e-4 of their scale without the trajectory
# drift of two free-running PH loops (omega at the f32 floor follows
# rounding noise, ROADMAP.md C1).  The hook order is compared on full
# runs of both PH objects.  Farmer S=3 (continuous) and sslp 5x10 S=4
# (binary first stage) at 1e-7 PDHG tolerance.
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)

RTOL = 1e-4


def _opts(mod, pdhg_mod, **kw):
    base = dict(default_rho=1.0, max_iterations=30, conv_thresh=1e-3,
                subproblem_windows=8)
    base.update(kw)
    return mod.PHOptions(pdhg=pdhg_mod.PDHGOptions(tol=1e-7), **base)


def farmer_pair(S=3):
    specs = [jfarmer.scenario_creator(nm, num_scens=S)
             for nm in jfarmer.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def sslp_pair(S=4, n_servers=5, n_clients=10):
    inst = jsslp.synthetic_instance(n_servers, n_clients, 0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=S)
             for nm in jsslp.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def port_state(jst):
    return convert.ph_state_from_arrays(convert.arrays_of(jst), "cpu")


class Twins:
    """A JAX PH run's per-iteration states, and a JAX and a port PH object
    that are put at any of them (`at(k)`: k = 0 is the Iter0 state)."""

    def __init__(self, jb, tb, iters, **kw):
        self.states = []
        states = self.states

        class Rec:
            def __init__(self, ph):
                self.opt = ph

            def post_iter0(self):
                states.append(self.opt.state)

            def enditer(self):
                states.append(self.opt.state)

        self.jalgo = jph.PH(_opts(jph, jpdhg, max_iterations=iters,
                                  conv_thresh=0.0, **kw), jb, extensions=Rec)
        self.jalgo.Iter0()
        self.jalgo.iterk_loop()
        self.jalgo.extobject = None
        self.talgo = tph.PH(_opts(tph, tpdhg, max_iterations=iters,
                                  conv_thresh=0.0, **kw), tb,
                            scenario_names=list(self.jalgo.scenario_names))
        self.talgo.trivial_bound = self.jalgo.trivial_bound

    def at(self, k):
        js = self.states[k]
        self.jalgo.state, self.talgo.state = js, port_state(js)
        self.jalgo._iter = self.talgo._iter = k
        self.jalgo.rho = js.rho
        self.talgo.rho = self.talgo.state.rho
        return self.jalgo, self.talgo


@pytest.fixture(scope="module")
def farmer_twins():
    jb, tb = farmer_pair()
    return Twins(jb, tb, 8)


@pytest.fixture(scope="module")
def sslp_twins():
    jb, tb = sslp_pair()
    return Twins(jb, tb, 30, default_rho=20.0, subproblem_windows=10)


def close(t, j, what, rtol=RTOL):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1e-30) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ---- the hook plane ---------------------------------------------------------
def test_hook_sequence_equals_jax():
    """TestExtension's record of a 2-iteration PH run, and MultiExtension's
    fan-out order, are the JAX package's."""
    from mpisppy_tpu.extensions.extension import MultiExtension as JMulti
    from mpisppy_tpu.extensions.test_extension import TestExtension as JT
    from mpisppy_tpu_torch.extensions.extension import MultiExtension
    from mpisppy_tpu_torch.extensions.test_extension import TestExtension

    jb, tb = farmer_pair()
    j = jph.PH(jph.PHOptions(max_iterations=2), jb, extensions=JT)
    t = tph.PH(tph.PHOptions(max_iterations=2), tb, extensions=TestExtension)
    j.ph_main()
    t.ph_main()
    assert t._TestExtension_who_is_called == j._TestExtension_who_is_called
    assert t._TestExtension_who_is_called[:4] == [
        "pre_iter0", "iter0_post_solver_creation", "post_iter0",
        "post_iter0_after_sync"]
    assert t.local_scenarios == t.scenario_names == ["scen0", "scen1",
                                                     "scen2"]

    def fan(base, seen):
        class A(base):
            def enditer(self):
                seen.append("A")

        class B(base):
            def enditer(self):
                seen.append("B")
        return [A, B]

    from mpisppy_tpu.extensions.extension import Extension as JExt
    from mpisppy_tpu_torch.extensions.extension import Extension as TExt
    jseen, tseen = [], []
    jph.PH(_opts(jph, jpdhg, max_iterations=2), jb, extensions=functools
           .partial(JMulti, ext_classes=fan(JExt, jseen))).ph_main()
    tph.PH(_opts(tph, tpdhg, max_iterations=2), tb, extensions=functools
           .partial(MultiExtension, ext_classes=fan(TExt, tseen))).ph_main()
    assert tseen == jseen == ["A", "B", "A", "B"]


def test_gapper_schedule_equals_jax():
    from mpisppy_tpu.extensions.mipgapper import Gapper as JG
    from mpisppy_tpu_torch.extensions.mipgapper import Gapper

    jb, tb = farmer_pair()
    sched = {2: 4, 5: 12}
    seen = {}
    for name, mod, pmod, b, cls in (("jax", jph, jpdhg, jb, JG),
                                    ("port", tph, tpdhg, tb, Gapper)):
        windows = []

        class Probe(cls):
            def enditer(self):
                windows.append(self.opt.options.subproblem_windows)
        algo = mod.PH(_opts(mod, pmod, max_iterations=6, conv_thresh=0.0),
                      b, extensions=functools.partial(Probe, schedule=sched))
        algo.ph_main()
        assert algo.options.subproblem_windows == 12
        seen[name] = windows
    assert seen["port"] == seen["jax"] == [8, 4, 4, 4, 12, 12]


# ---- Fixer ------------------------------------------------------------------
def test_fixer_collapses_the_same_boxes(sslp_twins):
    """From the same converged sslp state, one enditer with lag 1 fixes
    the same binary slots at the same values in both packages."""
    from mpisppy_tpu.extensions.fixer import Fixer as JF
    from mpisppy_tpu_torch.extensions.fixer import Fixer

    j, t = sslp_twins.at(len(sslp_twins.states) - 1)
    jb0, tb0 = j.batch, t.batch
    try:
        jf, tf = JF(j), Fixer(t)
        for f in (jf, tf):
            f.lag, f.tol = 1, 5e-2
        jf.enditer()
        tf.enditer()
        assert tf.nfixed() == jf.nfixed() > 0
        np.testing.assert_array_equal(tf.fixed_mask, jf.fixed_mask)
        for name in ("l", "u"):
            close(getattr(t.batch.qp, name).numpy(),
                  np.broadcast_to(np.asarray(getattr(j.batch.qp, name)),
                                  t.batch.qp.c.shape), f"fixed {name}")
        cols = t.batch.nonant_idx.numpy()[tf.fixed_mask]
        np.testing.assert_array_equal(t.batch.qp.l[:, cols],
                                      t.batch.qp.u[:, cols])
    finally:
        j.batch, t.batch = jb0, tb0


def test_fixer_in_a_port_run():
    """The port alone, the JAX test's run: after PH on sslp the binary
    slots get fixed and the live batch carries their collapsed boxes."""
    from mpisppy_tpu_torch.extensions.fixer import Fixer

    _, tb = sslp_pair()
    holder = {}

    def make(ph):
        f = Fixer(ph)
        f.lag, f.tol = 3, 5e-2
        holder["f"] = f
        return f
    algo = tph.PH(_opts(tph, tpdhg, default_rho=20.0, max_iterations=40,
                        conv_thresh=0.0, subproblem_windows=10), tb,
                  extensions=make)
    algo.ph_main()
    f = holder["f"]
    assert f.nfixed() > 0
    cols = algo.batch.nonant_idx.numpy()[f.fixed_mask]
    np.testing.assert_allclose(algo.batch.qp.l[..., cols].numpy(),
                               algo.batch.qp.u[..., cols].numpy(), atol=1e-6)


# ---- rho setters ------------------------------------------------------------
@pytest.mark.parametrize("name", ["SepRho", "CoeffRho"])
def test_static_rho_setters_equal_jax(farmer_twins, name):
    from mpisppy_tpu.extensions import rho_setters as jrs
    from mpisppy_tpu_torch.extensions import rho_setters as trs

    j, t = farmer_twins.at(0)
    getattr(jrs, name)(j).post_iter0()
    getattr(trs, name)(t).post_iter0()
    close(t.state.rho.numpy(), j.state.rho, name)
    close(t.rho.numpy(), j.rho, name)
    rho = t.state.rho.numpy()
    assert (rho > 0).all() and rho.std() > 0


def test_norm_rho_updater_equals_jax(farmer_twins):
    from mpisppy_tpu.extensions.rho_setters import NormRhoUpdater as JN
    from mpisppy_tpu_torch.extensions.rho_setters import NormRhoUpdater

    j, t = farmer_twins.at(0)
    jn, tn = JN(j), NormRhoUpdater(t)
    for k in range(1, len(farmer_twins.states)):
        js = farmer_twins.states[k]
        # the updater carries its rho forward: put each side's own rho
        # into the next recorded state
        j.state = dataclasses.replace(js, rho=j.state.rho)
        t.state = port_state(j.state)
        j._iter = t._iter = k
        jn.enditer()
        tn.enditer()
        close(t.state.rho.numpy(), j.state.rho, f"iter {k}")
    algo = tph.PH(_opts(tph, tpdhg), farmer_pair()[1],
                  extensions=NormRhoUpdater)
    _, eobj, _ = algo.ph_main()
    assert np.isfinite(eobj)


# ---- trackers and diagnostics -----------------------------------------------
def test_wtracker_equals_jax(farmer_twins, tmp_path):
    from mpisppy_tpu.utils.wtracker import WTrackerExtension as JW
    from mpisppy_tpu_torch.extensions.wtracker_extension import (
        WTrackerExtension, Wtracker_extension,
    )

    assert Wtracker_extension is WTrackerExtension
    j, t = farmer_twins.at(0)
    jw, tw = JW(j, window=5), WTrackerExtension(t, window=5)
    for k in range(1, len(farmer_twins.states)):
        farmer_twins.at(k)
        jw.enditer()
        tw.enditer()
    for a, b in zip(tw.tracker.compute_moving_stats(),
                    jw.tracker.compute_moving_stats()):
        close(a, b, "moving stats")
    assert tw.tracker.report_by_moving_stats(0.0) \
        == jw.tracker.report_by_moving_stats(0.0)
    tw.tracker.write_csv(str(tmp_path / "t.csv"))
    jw.tracker.write_csv(str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    tw.post_everything()


def test_phtracker_rows_equal_jax(farmer_twins, tmp_path):
    from mpisppy_tpu.extensions.phtracker import PHTracker as JP
    from mpisppy_tpu_torch.extensions.phtracker import PHTracker

    kw = dict(track_nonants=True, track_duals=True, track_xbars=True,
              track_scen_gaps=True, write_every=2)
    j, t = farmer_twins.at(0)
    jp = JP(j, folder=str(tmp_path / "j"), **kw)
    tp = PHTracker(t, folder=str(tmp_path / "t"), **kw)
    for k in range(1, 5):
        farmer_twins.at(k)
        jp.enditer()
        tp.enditer()
    jp.post_everything()
    tp.post_everything()
    for name in ("convergence", "gaps", "bounds", "nonants", "duals",
                 "xbars", "scen_gaps"):
        jl = (tmp_path / "j" / "hub" / f"{name}.csv").read_text().split()
        tl = (tmp_path / "t" / "hub" / f"{name}.csv").read_text().split()
        assert tl[0] == jl[0], name              # the header
        assert len(tl) == len(jl) == 5, name     # one row per iteration
        jv = np.array([[float(v) for v in r.split(",")] for r in jl[1:]])
        tv = np.array([[float(v) for v in r.split(",")] for r in tl[1:]])
        np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
        finite = ~np.isnan(jv)
        if name == "scen_gaps":   # KKT scores of the one state: 1e-4 of 1
            np.testing.assert_allclose(tv[finite], jv[finite], atol=1e-4)
        else:
            close(tv[finite], jv[finite], name)


def test_diagnoser_files_equal_jax(farmer_twins, tmp_path):
    from mpisppy_tpu.extensions.diagnoser import Diagnoser as JD
    from mpisppy_tpu_torch.extensions import Diagnoser

    j, t = farmer_twins.at(0)
    jd = JD(j, options={"diagnoser_outdir": str(tmp_path / "j")})
    td = Diagnoser(t, options={"diagnoser_outdir": str(tmp_path / "t"),
                               "flush_period": 2})
    jd.post_iter0()
    td.post_iter0()
    for k in (1, 2, 3):
        farmer_twins.at(k)
        jd.enditer()
        td.enditer()
    jd.post_everything()
    td.post_everything()
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j")) \
        == ["scen0.dag", "scen1.dag", "scen2.dag"]
    for fn in files:
        tv, jv = (np.loadtxt(tmp_path / side / fn, delimiter=",")
                  for side in ("t", "j"))
        assert list(tv[:, 0]) == list(jv[:, 0]) == [0, 1, 2, 3]
        close(tv, jv, fn)
    with pytest.raises(RuntimeError):
        Diagnoser(t, options={"diagnoser_outdir": str(tmp_path / "t")})


def test_minmaxavg_equals_jax(farmer_twins, capsys):
    from mpisppy_tpu.extensions import MinMaxAvg as JM
    from mpisppy_tpu_torch.extensions import MinMaxAvg

    j, t = farmer_twins.at(3)
    for comp in ("objective", "nonant:1"):
        jv = JM(j, compstr=comp).avg_min_max()
        tv = MinMaxAvg(t, compstr=comp).avg_min_max()
        close(tv, jv, comp)
        assert tv[1] <= tv[0] <= tv[2]
    MinMaxAvg(t, compstr="objective").enditer()
    assert "###  objective: avg, min, max, max-min" in capsys.readouterr().err


def test_xhat_closest_equals_jax(farmer_twins):
    from mpisppy_tpu.extensions import XhatClosest as JX
    from mpisppy_tpu_torch.extensions import XhatClosest

    j, t = farmer_twins.at(len(farmer_twins.states) - 1)
    jx, tx = JX(j), XhatClosest(t)
    assert tx.closest_scenario() == jx.closest_scenario()
    jx.post_everything()
    tx.post_everything()
    assert t._final_xhat_closest_obj is not None
    assert t._final_xhat_closest_obj == pytest.approx(
        j._final_xhat_closest_obj, rel=RTOL)
    close(t._xhat_closest_xhat, j._xhat_closest_xhat, "x̂")
    assert t._final_xhat_closest_obj >= -108390.0 - 1.0


# ---- convergers -------------------------------------------------------------
@pytest.mark.parametrize("name", ["PrimalDualConverger", "NormRhoConverger",
                                  "FractionalConverger"])
@pytest.mark.parametrize("model", ["farmer", "sslp"])
def test_converger_values_equal_jax(farmer_twins, sslp_twins, name, model):
    import mpisppy_tpu.convergers as jc
    import mpisppy_tpu_torch.convergers as tc

    tw = farmer_twins if model == "farmer" else sslp_twins
    j, t = tw.at(0)
    jconv, tconv = getattr(jc, name)(j), getattr(tc, name)(t)
    for k in range(1, min(len(tw.states), 9)):
        tw.at(k)
        assert tconv.is_converged() == jconv.is_converged(), k
        close(tconv.conv_value, jconv.conv_value, f"{name} iter {k}")
    if name == "PrimalDualConverger":
        close(np.nan_to_num(np.array(tconv.trace), posinf=0.0),
              np.nan_to_num(np.array(jconv.trace), posinf=0.0), "trace")


def test_convergers_stop_port_runs():
    from mpisppy_tpu_torch.convergers import (
        FractionalConverger, NormRhoConverger, PrimalDualConverger,
    )

    _, tb = farmer_pair()
    algo = tph.PH(_opts(tph, tpdhg), tb, converger=functools.partial(
        PrimalDualConverger, tol=50.0))
    algo.ph_main()
    assert algo.converger_object.conv_value is not None
    assert algo._iter < 30 and len(algo.converger_object.trace) >= 1
    # farmer has no integer nonants: converged at iteration 1
    algo = tph.PH(_opts(tph, tpdhg), tb, converger=FractionalConverger)
    algo.ph_main()
    assert algo._iter == 1
    algo = tph.PH(_opts(tph, tpdhg, max_iterations=3), tb,
                  converger=NormRhoConverger)
    algo.ph_main()
    assert algo.converger_object.conv_value is not None
