# Port parity: the decomposition algorithms on a batch split over two
# gloo ranks (parallel/mesh.py), each against the unsharded port on the
# same batch and, where __graft_entry__.py::dryrun_multichip runs the
# algorithm, against the JAX package's sharded run on its 8-device
# virtual mesh:
#   * FWPH (fwph_init + fwph_iter on the dry run's farmer batch, the
#     FWPH driver and the FWPH outer-bound spoke under a PH hub);
#   * L-shaped (the method, single- and multi-cut, with the master solved
#     on rank 0 and broadcast; the L-shaped hub with its x̂ spoke) and the
#     subproblem cuts against the JAX package's;
#   * cross-scenario cuts (eta bounds, the winner, one round written into
#     both views, the EF check; the extension and the cut spoke under a
#     PH hub) and launch_cuts against the JAX package's.
# Tolerances, unless stated: the two ranks print bit-identical results;
# bounds, objectives and x̂ within 1e-5 x max(1, |v|) of the unsharded
# run (tests/test_torch_mesh.py's fused-wheel tolerance); discrete
# choices (the winner, cut counts) equal.
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import cross_scen as jcs
from mpisppy_tpu.algos import fwph as jfwph
from mpisppy_tpu.algos import lshaped as jls
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.parallel import mesh as jmesh
from mpisppy_tpu_torch import convert
from test_torch_mesh import spawn

torch.set_num_threads(1)

REL = 1e-5          # bounds, objectives, x̂: x max(1, |v|)


def close(a, w, rel=REL):
    a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
    fin = np.isfinite(w)
    assert np.array_equal(fin, np.isfinite(a)), (a, w)
    assert np.array_equal(a[~fin], w[~fin]), (a, w)
    assert np.all(np.abs(a[fin] - w[fin])
                  <= rel * np.maximum(1.0, np.abs(w[fin]))), (a, w)


def same_on_ranks(outs):
    assert outs[0]["split"] == outs[1]["split"]


def jax_mesh():
    assert len(jax.devices()) >= 8
    return jmesh.make_mesh(8)


# ---------------------------------------------------------------------------
# FWPH
# ---------------------------------------------------------------------------
FWPH_BATCH = """
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import farmer
        names = farmer.scenario_names_creator(16)
        b = batch_mod.from_specs(
            [farmer.scenario_creator(nm, num_scens=16, crops_multiplier=2)
             for nm in names], device="cpu")
"""


def test_two_rank_fwph_matches_unsharded_and_jax(tmp_path):
    """fwph_init + one fwph_iter at the dry run's options, the FWPH
    driver (2 outer iterations; its weights the whole axis's) and the
    FWPH spoke under a PH hub (2 hub iterations)."""
    # the JAX package's sharded run, as its dry run does it
    specs = [jfarmer.scenario_creator(nm, num_scens=16, crops_multiplier=2)
             for nm in jfarmer.scenario_names_creator(16)]
    jb = jmesh.shard_batch(jbatch.from_specs(specs), jax_mesh())
    jo = jfwph.FWPHOptions(fw_iter_limit=1, max_columns=4,
                           iter0_windows=20, oracle_windows=2)
    jst0, jtb, _ = jfwph.fwph_init(jb, jnp.ones(jb.num_nonants), jo)
    jst = jfwph.fwph_iter(jb, jst0, jo)
    with open(str(tmp_path / "store") + "_jst.pkl", "wb") as f:
        pickle.dump(convert.arrays_of(jst0), f)
    outs = spawn(tmp_path, FWPH_BATCH + """
        import numpy as np
        from mpisppy_tpu_torch.algos import fwph
        from mpisppy_tpu_torch.algos import ph as ph_mod
        from mpisppy_tpu_torch.cylinders import spoke
        from mpisppy_tpu_torch.cylinders.hub import PHHub
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        opts = fwph.FWPHOptions(fw_iter_limit=1, max_columns=4,
                                iter0_windows=20, oracle_windows=2)
        rho = torch.ones(b.num_nonants)

        def run(batch):
            st, tb, cert = fwph.fwph_init(batch, rho, opts)
            st = fwph.fwph_iter(batch, st, opts)
            drv = fwph.FWPH(fwph.FWPHOptions(
                fw_iter_limit=2, max_columns=4, iter0_windows=20,
                oracle_windows=4, max_iterations=2, conv_thresh=0.0),
                batch, scenario_names=names)
            itr, weights, xbar_nodes = drv.fwph_main()
            ws = WheelSpinner(
                {"hub_class": PHHub,
                 "hub_kwargs": {"options": {"rel_gap": 1e-9}},
                 "opt_class": ph_mod.PH,
                 "opt_kwargs": {"options": ph_mod.PHOptions(
                     max_iterations=2, default_rho=1.0, iter0_windows=20,
                     subproblem_windows=4), "batch": batch}},
                [{"spoke_class": spoke.FWPHOuterBound,
                  "opt_kwargs": {"options": {"fw_opts": opts}}}]).spin()
            return {"tb": float(tb), "cert": bool(cert),
                    "bound": float(st.bound), "conv": float(st.conv),
                    "xbar": st.xbar_nodes[0].tolist(),
                    "drv_best": drv.best_bound, "drv_iters": itr,
                    "drv_xbar": xbar_nodes[0].tolist(),
                    "n_weights": len(weights),
                    "weight_sums": [float(w.sum()) for w in
                                    weights.values()],
                    "spoke_bound": ws.spcomm.spokes[0].bound}
        sb = mesh_mod.shard_batch(b, mesh)
        out = {"whole": run(b), "split": run(sb), "calls": dict(mesh.calls)}
        # one fwph_iter from the JAX package's sharded init state (the
        # init's LP has many optimal x, so the W each package starts its
        # iteration from differs by more than rounding): this rank's rows
        import pickle
        from mpisppy_tpu_torch import convert
        with open(sys.argv[3] + "_jst.pkl", "rb") as f:
            jst = pickle.load(f)

        def rows(d):
            if isinstance(d, dict):
                return {k: rows(v) for k, v in d.items()}
            if isinstance(d, np.ndarray) and d.ndim and d.shape[0] == 16:
                return d[sb.scen_offset:sb.scen_offset + sb.num_scenarios]
            return d
        st = fwph.fwph_iter(sb, convert.fwph_state_from_arrays(
            rows(jst), "cpu"), opts)
        out["from_jax"] = float(st.bound)
    """)
    same_on_ranks(outs)
    assert outs[0]["from_jax"] == outs[1]["from_jax"]
    o = outs[0]
    w, s = o["whole"], o["split"]
    assert o["calls"]["all_reduce"] > 0 and o["calls"]["all_gather"] > 0
    for k in ("tb", "bound", "conv", "drv_best", "spoke_bound"):
        close(s[k], w[k])
    assert s["cert"] == w["cert"] and s["drv_iters"] == w["drv_iters"]
    # x̄ after the oracle's 2 windows and the simplex QP is a solve's
    # output, held like x̂ (the all-reduce's summation order moves it by
    # ~1e-6 of its scale; the reduction itself is held at 1e-6 by
    # tests/test_torch_mesh.py's hydro node averages).  After the
    # driver's second inner iteration the simplex QP is degenerate (its
    # columns nearly collinear): x̄ is held at tests/test_torch_fwph.py's
    # 1e-2 of its scale
    close(s["xbar"], w["xbar"])
    np.testing.assert_allclose(s["drv_xbar"], w["drv_xbar"], rtol=0,
                               atol=1e-2 * np.abs(w["drv_xbar"]).max())
    # the driver's weights cover the whole axis on every rank
    assert s["n_weights"] == 16
    np.testing.assert_allclose(s["weight_sums"], 1.0, atol=1e-5)
    # the trivial bound at rtol 1e-5; the bound after one iteration from
    # the same state at tests/test_torch_fwph.py's 1e-4
    assert s["tb"] == pytest.approx(float(jtb), rel=1e-5)
    assert o["from_jax"] == pytest.approx(float(jst.bound), rel=1e-4)


# ---------------------------------------------------------------------------
# L-shaped
# ---------------------------------------------------------------------------
def test_two_rank_lshaped_matches_unsharded(tmp_path):
    """LShapedMethod on farmer S=3 padded to 4 (a zero-probability pad
    lane on rank 1), single- and multi-cut, 4 Benders iterations: every
    trace row's bounds and cut count equal the unsharded run's, the
    master broadcast from rank 0; then the L-shaped hub with its x̂
    spoke."""
    outs = spawn(tmp_path, """
        from mpisppy_tpu_torch.algos import lshaped
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import farmer
        from mpisppy_tpu_torch.ops import pdhg
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        from mpisppy_tpu_torch.utils import cfg_vanilla as vanilla
        from mpisppy_tpu_torch.utils.config import Config
        b = batch_mod.pad_to_multiple(batch_mod.from_specs(
            [farmer.scenario_creator(nm, num_scens=3)
             for nm in farmer.scenario_names_creator(3)], device="cpu"), 2)
        cfg = Config()
        cfg.popular_args()
        cfg.lshaped_args()
        cfg.rel_gap = 1e-9
        cfg.lshaped_max_iter = 3

        def run(batch):
            res = {}
            for multicut in (False, True):
                ls = lshaped.LShapedMethod(lshaped.LShapedOptions(
                    max_iter=4, tol=1e-9, multicut=multicut,
                    sub_pdhg=pdhg.PDHGOptions(tol=1e-6, max_iters=20_000,
                                              detect_infeas=True)), batch)
                r = ls.lshaped_algorithm()
                res[f"mc{int(multicut)}"] = {
                    "bound": r["bound"], "ub": r["ub"],
                    "xhat": [float(v) for v in r["xhat"]],
                    "rows": [(t["lb"], t["ub"], t["ncuts"])
                             for t in ls.trace]}
            ws = WheelSpinner(vanilla.lshaped_hub(cfg, batch),
                              [vanilla.xhatlshaped_spoke(cfg)]).spin()
            res["hub"] = [ws.BestOuterBound, ws.BestInnerBound]
            return res
        whole = run(b)
        before = dict(mesh.calls)
        out = {"whole": whole, "split": run(mesh_mod.shard_batch(b, mesh))}
        out["calls"] = {k: mesh.calls[k] - before[k] for k in before}
    """)
    same_on_ranks(outs)
    o = outs[0]
    assert o["calls"]["broadcast"] > 0 and o["calls"]["all_gather"] > 0
    for mc in ("mc0", "mc1"):
        w, s = o["whole"][mc], o["split"][mc]
        close(s["bound"], w["bound"])
        close(s["ub"], w["ub"])
        close(s["xhat"], w["xhat"])
        assert len(s["rows"]) == len(w["rows"]) == 4
        for rs, rw in zip(s["rows"], w["rows"]):
            close(rs[:2], rw[:2])
            assert rs[2] == rw[2]          # the Benders cut count
    close(o["split"]["hub"], o["whole"]["hub"])


def test_two_rank_subproblem_cuts_match_jax(tmp_path):
    """_subproblem_cuts on sslp 5x15 (S=8) at x̂ = 0.5: the two ranks'
    gathered duals and cut coefficients against the unsharded port's and
    the JAX package's on its 8-device mesh (tests/test_torch_lshaped.py's
    1e-5 of scale)."""
    outs = spawn(tmp_path, """
        from mpisppy_tpu_torch.algos import lshaped
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        inst = sslp.synthetic_instance(5, 15)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=8,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(8)], device="cpu")
        xhat = torch.full((b.num_nonants,), 0.5)

        def run(batch):
            r = lshaped._subproblem_cuts(
                batch, xhat, lshaped.LShapedOptions().sub_pdhg)
            keys = ("alpha", "g", "dual", "obj", "status")
            return dict(zip(keys, (a.tolist() for a in batch.scen_host(
                *(r[k] for k in keys)))))
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    specs = [jsslp.scenario_creator(nm, instance=jsslp.synthetic_instance(
        5, 15), num_scens=8, lp_relax=True)
        for nm in jsslp.scenario_names_creator(8)]
    jb = jmesh.shard_batch(jbatch.from_specs(specs), jax_mesh())
    jr = jls._subproblem_cuts(jb, np.full(jb.num_nonants, 0.5, np.float32),
                              jls.LShapedOptions().sub_pdhg)
    assert s["status"] == w["status"] == np.asarray(jr["status"]).tolist()
    for k in ("alpha", "g", "dual", "obj"):
        j = np.asarray(jr[k])
        for got in (s[k], w[k]):
            np.testing.assert_allclose(got, j, rtol=0,
                                       atol=1e-5 * np.abs(j).max(),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# cross-scenario cuts
# ---------------------------------------------------------------------------
CROSS_BATCH = """
        import numpy as np
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        from mpisppy_tpu_torch.ops import pdhg
        inst = sslp.synthetic_instance(5, 15)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=8,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(8)], device="cpu")
        opts = pdhg.PDHGOptions(tol=1e-4, max_iters=400, restart_period=40,
                                detect_infeas=True)
        rng = np.random.default_rng(3)
        nonants = torch.as_tensor(rng.uniform(0.0, 1.0, (8, b.num_nonants))
                                  .astype(np.float32))
"""


def test_two_rank_cross_scen_matches_unsharded_and_jax(tmp_path):
    """One round of cross-scenario cuts on sslp 5x15 (S=8): the eta
    bounds, the winner (the global first-index argmax), the package,
    both views' cut rows and the EF check's bound against the unsharded
    run; then the extension and the cut spoke under a PH hub (3 hub
    iterations); launch_cuts against the JAX package's sharded run."""
    outs = spawn(tmp_path, CROSS_BATCH + """
        from mpisppy_tpu_torch.algos import cross_scen
        from mpisppy_tpu_torch.algos import ph as ph_mod
        from mpisppy_tpu_torch.cylinders import spoke
        from mpisppy_tpu_torch.cylinders.hub import PHHub
        from mpisppy_tpu_torch.extensions.cross_scen_extension import (
            CrossScenarioExtension)
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        import functools
        launch, winners = cross_scen.launch_cuts, []

        def logged(*args):
            raw = launch(*args)
            winners.append(raw["sid"])
            return raw
        cross_scen.launch_cuts = logged

        def run(batch):
            winners.clear()
            off, S = batch.scen_start, batch.num_scenarios
            eta_lb = cross_scen.eta_lower_bounds(batch, opts, windows=20)
            meta = cross_scen.make_meta(batch, eta_lb, max_rounds=2)
            raw = cross_scen.launch_cuts(batch, nonants[off:off + S],
                                         nonants.mean(0), opts)
            pkg = cross_scen.package_cuts(raw, opts)
            cross_scen.write_cuts(meta, pkg)
            bound, _ = cross_scen.ef_check_bound(meta, opts, windows=20)
            rows = meta.m_orig + np.arange(meta.S)
            ph_bu, ef_bu = batch.scen_host(
                torch.broadcast_to(meta.aug_ph.qp.bu, (S, meta.aug_ph.qp.m)),
                torch.broadcast_to(meta.aug_ef.qp.bu, (S, meta.aug_ef.qp.m)))
            ws = WheelSpinner(
                {"hub_class": PHHub,
                 "hub_kwargs": {"options": {"rel_gap": 1e-9}},
                 "opt_class": ph_mod.PH,
                 "opt_kwargs": {"options": ph_mod.PHOptions(
                     max_iterations=3, default_rho=20.0, iter0_windows=100,
                     subproblem_windows=25), "batch": batch,
                     "extensions": functools.partial(
                         CrossScenarioExtension,
                         check_bound_improve_iterations=1)}},
                [{"spoke_class": spoke.CrossScenarioCutSpoke,
                  "opt_kwargs": {"options": {}}}]).spin()
            ext = ws.opt.extobject
            return {"eta_lb": eta_lb.tolist(), "sid": raw["sid"],
                    "xhat": pkg["xhat"].tolist(),
                    "dual": raw["dual"].tolist(),
                    "infeas": pkg["infeas"].tolist(),
                    "usable": pkg["usable"].tolist(),
                    "opt_g": pkg["opt_g"].tolist(),
                    "alpha": pkg["opt_alpha"].tolist(),
                    "ph_rows": ph_bu[:, rows].tolist(),
                    "ef_rows": ef_bu[:, rows].tolist(),
                    "is_opt": meta.is_opt.tolist(),
                    "bound": None if bound is None else float(bound),
                    "wheel": [ws.BestOuterBound, ws.BestInnerBound],
                    "winners": list(winners),
                    "cuts": ext.cuts_installed}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    assert s["sid"] == w["sid"]
    for k in ("infeas", "usable", "is_opt", "cuts"):
        assert s[k] == w[k], k
    for k in ("eta_lb", "xhat", "dual", "opt_g", "alpha", "ph_rows",
              "ef_rows"):
        close(s[k], w[k])
    # the wheel's rounds pick the same winners; its outer bound is the EF
    # check's max over the scenarios whose dual residual clears 10 tol, a
    # gate that f32 noise of the all-reduce order (~1e-6 in the hub's
    # nonants by the third iteration) can flip for one lane: held at the
    # slice-9 phases' 1e-3 against the unsharded wheel (the EF check
    # itself at 1e-5 above; bit for bit on one rank, chip_smoke.py)
    assert s["winners"] == w["winners"]
    assert s["wheel"][1] == w["wheel"][1] == float("inf")
    close(s["wheel"][0], w["wheel"][0], rel=1e-3)
    assert w["bound"] is not None
    close(s["bound"], w["bound"])
    # the JAX package's launch_cuts on its 8-device mesh, from the same
    # nonants: the chosen scenario's x̂ and the duals (1e-5 of scale)
    specs = [jsslp.scenario_creator(nm, instance=jsslp.synthetic_instance(
        5, 15), num_scens=8, lp_relax=True)
        for nm in jsslp.scenario_names_creator(8)]
    jb = jmesh.shard_batch(jbatch.from_specs(specs), jax_mesh())
    x_non = np.random.default_rng(3).uniform(
        0.0, 1.0, (8, jb.num_nonants)).astype(np.float32)
    jo = jpdhg.PDHGOptions(tol=1e-4, max_iters=400, restart_period=40,
                           detect_infeas=True)
    raw = jcs.launch_cuts(jb, jnp.asarray(x_non),
                          jnp.asarray(x_non.mean(0)), jo)
    np.testing.assert_array_equal(s["xhat"], np.asarray(raw["xhat"]))
    assert s["xhat"] == x_non[s["sid"]].tolist()
    j = np.asarray(raw["dual"])
    np.testing.assert_allclose(s["dual"], j, rtol=0,
                               atol=1e-5 * np.abs(j).max())
