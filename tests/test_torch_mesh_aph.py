# Port parity: APH, the async wheel, the Schur complement and the
# reduced-costs spoke on a batch split over two gloo ranks
# (parallel/mesh.py), each against the unsharded port on the same batch:
#   * APH (sslp 5x15 LP, S=8, half the scenarios dispatched): every
#     iteration's dispatch record (the global stale-first top-k), conv,
#     theta and node averages; the APH hub's checkpoint saved gathered (one
#     file, the whole axis, rank 0 writes) and restored sliced (each rank
#     its rows);
#   * the async wheel (AsyncFusedPH + AsyncPHHub at staleness 1): its
#     trace rows;
#   * SchurComplement (sslp 3x9 LP, S=4): objective and x against the
#     unsharded run and tests/test_torch_sc.py's scipy EF optimum;
#   * ReducedCostsSpoke: the published rc_global and rc_scenario.
# Tolerances: the two ranks print bit-identical results; bounds,
# objectives, conv, theta and x within 1e-5 x max(1, |v|) of the
# unsharded run; node averages (solve outputs) the same; dispatch
# records and restored rows equal.
import numpy as np
import pytest

from test_farmer_ef_ph import scipy_ef_solve
from test_torch_mesh import spawn
from test_torch_mesh_decomp import close, same_on_ranks
from test_torch_sc import _sslp

SSLP_8 = """
        import numpy as np
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        inst = sslp.synthetic_instance(5, 15)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=8,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(8)], device="cpu")
"""


def test_two_rank_aph_matches_unsharded(tmp_path):
    outs = spawn(tmp_path, SSLP_8 + """
        from mpisppy_tpu_torch.algos import aph
        opts = aph.APHOptions(default_rho=20.0, dispatch_frac=0.5,
                              iter0_windows=100, subproblem_windows=25,
                              max_iterations=3, conv_thresh=0.0)
        rho = torch.full((b.num_nonants,), 20.0)

        def run(batch):
            st, tb, cert = aph.aph_iter0(batch, rho, opts)
            rows = []
            for _ in range(4):
                st = aph.aph_iterk(batch, st, opts)
                rows.append({"dispatched": batch.scen_host(
                                 st.last_solved).tolist(),
                             "conv": float(st.conv),
                             "theta": float(st.theta),
                             "xbar": st.xbar_nodes[0].tolist()})
            conv, eobj, tb2 = aph.APH(opts, batch).APH_main()
            return {"tb": float(tb), "rows": rows,
                    "main": [conv, eobj, tb2]}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    close(s["tb"], w["tb"])
    close(s["main"], w["main"])
    for rs, rw in zip(s["rows"], w["rows"]):
        # the global stale-first top-k: half of the 8 each iteration
        assert rs["dispatched"] == rw["dispatched"]
        close([rs["conv"], rs["theta"]], [rw["conv"], rw["theta"]])
        close(rs["xbar"], rw["xbar"])
    last = w["rows"][-1]["dispatched"]
    assert sorted(set(last)) != [last[0]]      # a partial dispatch


def test_two_rank_aph_checkpoint_saved_gathered_restored_sliced(tmp_path):
    """The APH hub (2 hub iterations) saves every iteration: rank 0
    writes one snapshot of the whole scenario axis; a fresh wheel on each
    rank restores its own rows, equal to the saving wheel's state."""
    outs = spawn(tmp_path, SSLP_8 + """
        import os
        from mpisppy_tpu_torch.algos import aph
        from mpisppy_tpu_torch.cylinders.hub import APHHub
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
        ckpt = sys.argv[3] + "_aph.npz"
        sb = mesh_mod.shard_batch(b, mesh)

        def wheel():
            return WheelSpinner({
                "hub_class": APHHub,
                "hub_kwargs": {"options": {
                    "rel_gap": 1e-9, "checkpoint_path": ckpt,
                    "checkpoint_every_iters": 1}},
                "opt_class": aph.APH,
                "opt_kwargs": {"options": aph.APHOptions(
                    default_rho=20.0, dispatch_frac=0.5, iter0_windows=40,
                    subproblem_windows=8, max_iterations=2,
                    conv_thresh=0.0), "batch": sb}})
        ws = wheel().spin()
        st = ws.opt.state
        torch.distributed.barrier()
        with np.load(ckpt) as d:
            leaf_rows = sorted({d[k].shape[0] for k in d.files
                                if k.startswith("leaf") and d[k].ndim})
        ws2 = wheel().build()
        ws2.spcomm.load_checkpoint(ckpt)
        st2 = ws2.opt.state
        out = {"split": {"leaf_rows": leaf_rows,
                         "iter": [ws.spcomm._last_ckpt_iter,
                                  ws2.spcomm._iter]},
               "restored_equal": all(torch.equal(getattr(st, f),
                                                 getattr(st2, f))
                                     for f in ("W", "y", "z", "xbar",
                                               "last_solved", "conv",
                                               "theta")),
               "solver_equal": torch.equal(st.solver.x, st2.solver.x)
               and torch.equal(st.solver.y, st2.solver.y),
               "rows": sb.num_scenarios}
    """)
    same_on_ranks(outs)
    for o in outs:
        assert o["restored_equal"] and o["solver_equal"] and o["rows"] == 4
    s = outs[0]["split"]
    assert 8 in s["leaf_rows"] and 4 not in s["leaf_rows"]
    assert s["iter"][0] == s["iter"][1] >= 2


def test_two_rank_async_wheel_matches_unsharded(tmp_path):
    outs = spawn(tmp_path, SSLP_8 + """
        from mpisppy_tpu_torch.algos import async_wheel as aw
        from mpisppy_tpu_torch.algos import fused_wheel as fw
        from mpisppy_tpu_torch.algos import ph as ph_mod
        from mpisppy_tpu_torch.cylinders import spoke
        from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub
        from mpisppy_tpu_torch.ops import pdhg
        from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

        def run(batch):
            ws = WheelSpinner(
                {"hub_class": AsyncPHHub,
                 "hub_kwargs": {"options": {"rel_gap": 1e-9}},
                 "opt_class": aw.AsyncFusedPH,
                 "opt_kwargs": {
                     "options": ph_mod.PHOptions(
                         default_rho=20.0, max_iterations=3,
                         subproblem_windows=25, iter0_windows=100,
                         conv_thresh=0.0, pdhg=pdhg.PDHGOptions(tol=1e-6)),
                     "batch": batch,
                     "wheel_options": fw.FusedWheelOptions(),
                     "async_options": aw.AsyncWheelOptions(staleness=1)}},
                [{"spoke_class": spoke.FusedLagrangianOuterBound,
                  "opt_kwargs": {"options": {}}},
                 {"spoke_class": spoke.FusedXhatXbarInnerBound,
                  "opt_kwargs": {"options": {}}}]).spin()
            return {"rows": [[r["iter"], r["conv"], r["outer"], r["inner"]]
                             for r in ws.spcomm.trace],
                    "theta": ws.opt.last_theta,
                    "bounds": [ws.BestOuterBound, ws.BestInnerBound]}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    assert len(s["rows"]) == len(w["rows"]) >= 3
    for rs, rw in zip(s["rows"], w["rows"]):
        assert rs[0] == rw[0]
        close(rs[1:], rw[1:])
    close(s["theta"], w["theta"])
    close(s["bounds"], w["bounds"])


def test_two_rank_schur_complement_matches_unsharded_and_ef(tmp_path):
    outs = spawn(tmp_path, """
        from mpisppy_tpu_torch.algos.sc import SchurComplement, SCOptions
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        inst = sslp.synthetic_instance(3, 9, seed=2)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=4,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(4)], device="cpu")

        def run(batch):
            r = SchurComplement(SCOptions(max_iter=250, tol=1e-10),
                                batch).solve()
            return {"objective": r["objective"], "x": r["x"].tolist(),
                    "v_rows": r["v"].shape[0], "converged": r["converged"]}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    assert s["converged"] and w["converged"]
    close(s["objective"], w["objective"])
    close(s["x"], w["x"])
    assert s["v_rows"] == w["v_rows"] == 4
    # tests/test_torch_sc.py's scipy EF optimum at its tolerance (1e-4)
    sobj, _ = scipy_ef_solve(_sslp(3, 9, 4, seed=2))
    assert s["objective"] == pytest.approx(sobj, rel=1e-4)


def test_two_rank_reduced_costs_spoke_publishes_the_global_rc(tmp_path):
    """Both ranks publish the unsharded batch's rc_global (the expected
    reduced costs over the whole axis, NaN off consensus) and the whole
    (S, N) rc_scenario.  W pushes every scenario's facilities to one
    bound (closed where W > 0, open where W < 0), so every slot is at a
    consensus bound and rc_global is finite."""
    outs = spawn(tmp_path, SSLP_8 + """
        import types
        from mpisppy_tpu_torch.cylinders.spoke import ReducedCostsSpoke
        from mpisppy_tpu_torch.ops import pdhg
        W = torch.full((8, b.num_nonants), 100.0)
        W[:, 3:] = -100.0

        def run(batch):
            off, S = batch.scen_offset, batch.num_scenarios
            sp = ReducedCostsSpoke(types.SimpleNamespace(batch=batch), {
                "pdhg_opts": pdhg.PDHGOptions(tol=1e-6)})
            sp.update({"W": W[off:off + S]})
            sp.harvest()
            rc = sp.rc_global
            return {"rc_global": [None if np.isnan(v) else float(v)
                                  for v in rc],
                    "rc_scenario": sp.rc_scenario.tolist(),
                    "bound": sp.bound}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    assert all(v is not None for v in w["rc_global"])
    assert [v is None for v in s["rc_global"]] \
        == [v is None for v in w["rc_global"]]
    close([v for v in s["rc_global"] if v is not None],
          [v for v in w["rc_global"] if v is not None])
    assert np.asarray(s["rc_scenario"]).shape[0] == 8
    close(s["rc_scenario"], w["rc_scenario"])
    close(s["bound"], w["bound"])
