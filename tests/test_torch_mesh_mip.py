# Port parity: the exact-MIP plane (algos/mip.py, ops/bnb.py) on a batch
# split over two gloo ranks (parallel/mesh.py):
#   * every driver of algos/mip.py on sslp 3x6 with integer recourse
#     (S=8, 4 scenarios a rank) against the unsharded port on the same
#     batch: the Lagrangian MIP bound, the MIP evaluations (one, many,
#     polished), the three dual ascents, the first-stage local search,
#     the decomposition B&B (its nodes and branching boxes) and
#     certified_mip_gap;
#   * one bnb_round from the JAX package's root state on the dry run's
#     sslp 3x8 batch (S=16), against the JAX package's round on its
#     8-device mesh (__graft_entry__.py::dryrun_multichip).
# Tolerances: the two ranks print bit-identical results; bounds and
# values within 1e-5 x max(1, |v|) of the unsharded run; nodes, branching
# boxes and chosen first stages equal; the B&B round at
# tests/test_torch_bnb.py's 1e-4 (nodes solved exactly).
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import bnb as jbnb
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.parallel import mesh as jmesh
from mpisppy_tpu_torch import convert
from test_torch_bnb import _close
from test_torch_mesh import spawn
from test_torch_mesh_decomp import close, same_on_ranks


def test_two_rank_mip_drivers_match_unsharded(tmp_path):
    outs = spawn(tmp_path, """
        import numpy as np
        from mpisppy_tpu_torch.algos import mip
        from mpisppy_tpu_torch.algos import ph as ph_mod
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        from mpisppy_tpu_torch.ops import bnb
        inst = sslp.synthetic_instance(3, 6, seed=4)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=8)
             for nm in sslp.scenario_names_creator(8)], device="cpu")
        N = b.num_nonants
        opts = bnb.BnBOptions(pool_size=8, max_rounds=8, dive_rounds=4,
                              dive_tail=8, pump_rounds=0)
        W = np.random.RandomState(6).randn(8, N).astype(np.float32)
        W -= W.mean(axis=0)
        xhat = np.ones(N, np.float32)
        boxes = []
        restrict = mip._restrict_first_stage

        def logged(batch, qp, int_slots, lo, hi):
            boxes.append([list(map(float, lo)), list(map(float, hi))])
            return restrict(batch, qp, int_slots, lo, hi)
        mip._restrict_first_stage = logged

        def run(batch):
            boxes.clear()
            off, S = batch.scen_start, batch.num_scenarios
            Wl = torch.as_tensor(W[off:off + S])
            lag = mip.lagrangian_mip_bound(batch, Wl, opts)
            ev = mip.evaluate_mip(batch, xhat, opts)
            many = mip.evaluate_mip_many(
                batch, [xhat, np.array([1, 0, 1], np.float32)], opts)
            pol = mip.evaluate_mip_polished(batch, xhat, opts,
                                            multistart=2, lns_rounds=2)
            asc = mip.mip_dual_ascent(batch, Wl, 1.0, 1, opts)
            polyak = mip.mip_dual_ascent_polyak(batch, Wl, ev["value"], 2,
                                                opts)
            bundle = mip.mip_dual_bundle(batch, Wl, ev["value"], 2, opts)
            ls = mip.first_stage_local_search(batch, xhat, ev["value"],
                                              opts, max_rounds=1)
            dd = mip.decomposition_bnb(batch, Wl, opts, max_nodes=3,
                                       inner0=ev["value"], xhat0=xhat)
            gap = mip.certified_mip_gap(
                batch, ph_mod.PHOptions(max_iterations=2, default_rho=10.0),
                opts, n_shuffle=2, dd_nodes=1)
            return {
                "lag": [lag["bound"], lag["per_scenario"].tolist(),
                        lag["solved"].tolist(), lag["feasible"]],
                "ev": [ev["value"], ev["value_lower"],
                       ev["per_scenario"].tolist(), ev["feasible"]],
                "many": [[e["value"], e["value_lower"], e["feasible"]]
                         for e in many],
                "polished": [pol["value"], pol["feasible"],
                             pol["x"].shape[0]],
                "ascent": [asc["bound"], asc["W"].shape[0]],
                "polyak": [polyak["bound"], polyak["history"]],
                "bundle": [bundle["bound"], bundle["history"],
                           list(bundle["W"].shape)],
                "local_search": [ls["value"], ls["xhat"].tolist()],
                "dd": [dd["inner"], dd["outer"], dd["nodes"],
                       dd["failed_nodes"],
                       None if dd["xhat"] is None
                       else np.asarray(dd["xhat"]).tolist()],
                "boxes": list(boxes),
                "gap": [gap.inner, gap.outer, gap.trivial_bound,
                        np.asarray(gap.xhat).tolist()]}
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """, timeout=600)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    # the Lagrangian MIP bound and its per-scenario outers (whole axis)
    close(s["lag"][0], w["lag"][0])
    close(s["lag"][1], w["lag"][1])
    assert s["lag"][2:] == w["lag"][2:]
    close(s["ev"][:2], w["ev"][:2])
    close(s["ev"][2], w["ev"][2])
    assert s["ev"][3] == w["ev"][3]
    for a, e in zip(s["many"], w["many"]):
        close(a[:2], e[:2])
        assert a[2] == e[2]
    close(s["polished"][0], w["polished"][0])
    assert s["polished"][1:] == w["polished"][1:] == [w["polished"][1], 8]
    close(s["ascent"][0], w["ascent"][0])
    assert s["ascent"][1] == 4 and w["ascent"][1] == 8    # rows: the rank's
    for k in ("polyak", "bundle"):
        close(s[k][0], w[k][0])
        close(s[k][1], w[k][1])
    assert s["bundle"][2] == [4, N_SLOTS] and w["bundle"][2] == [8, N_SLOTS]
    close(s["local_search"][0], w["local_search"][0])
    assert s["local_search"][1] == w["local_search"][1]
    # decomposition B&B: bounds, nodes, the incumbent's first stage and
    # every node box in order (the branching variable and split)
    close(s["dd"][:2], w["dd"][:2])
    assert s["dd"][2:] == w["dd"][2:]
    assert s["boxes"] == w["boxes"] and len(w["boxes"]) > 1
    close(s["gap"][:3], w["gap"][:3])
    assert s["gap"][3] == w["gap"][3]


N_SLOTS = 3      # sslp 3x6: one open/close binary a facility


def test_two_rank_bnb_round_matches_jax(tmp_path):
    """One bnb_round from the JAX package's cold root state on the dry
    run's sslp 3x8 integer batch (S=16), each rank its lanes, against the
    JAX round on the 8-device mesh and the unsharded port's."""
    specs = [jsslp.scenario_creator(nm, instance=jsslp.synthetic_instance(
        3, 8, seed=0), num_scens=16)
        for nm in jsslp.scenario_names_creator(16)]
    assert len(jax.devices()) >= 8
    jb = jmesh.shard_batch(jbatch.from_specs(specs), jmesh.make_mesh(8))
    jo = jbnb.BnBOptions(max_rounds=1, pump_rounds=0,
                         lp=jpdhg.PDHGOptions(tol=1e-3, max_iters=400))
    ic = jnp.asarray(np.nonzero(np.asarray(jb.integer_full))[0], jnp.int32)
    st0 = jbnb.root_state(jb.qp, jb.d_col, ic, jo)
    j1 = jbnb.bnb_round(jb.qp, jb.d_col, ic, st0, jo)
    with open(str(tmp_path / "store") + "_root.pkl", "wb") as f:
        pickle.dump(convert.arrays_of(st0), f)
    outs = spawn(tmp_path, """
        import pickle
        import numpy as np
        from mpisppy_tpu_torch import convert
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        from mpisppy_tpu_torch.ops import bnb, pdhg
        inst = sslp.synthetic_instance(3, 8, seed=0)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=16)
             for nm in sslp.scenario_names_creator(16)], device="cpu")
        opts = bnb.BnBOptions(max_rounds=1, pump_rounds=0,
                              lp=pdhg.PDHGOptions(tol=1e-3, max_iters=400))
        ic = np.nonzero(b.integer_full.numpy())[0]
        with open(sys.argv[3] + "_root.pkl", "rb") as f:
            root = pickle.load(f)

        def run(batch):
            off, S = batch.scen_start, batch.num_scenarios
            st = convert.bnb_state_from_arrays(
                {k: v[off:off + S] for k, v in root.items()}, "cpu")
            st = bnb.bnb_round(batch.qp, batch.d_col, ic, st, opts)
            return [a.tolist() for a in batch.scen_host(
                st.nodes_solved, st.outer, st.pool_bound, st.incumbent)]
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    same_on_ranks(outs)
    w, s = outs[0]["whole"], outs[0]["split"]
    assert s[0] == w[0] == np.asarray(j1.nodes_solved).tolist()
    assert sum(s[0]) > 0
    for k, name in ((1, "outer"), (2, "pool_bound"), (3, "incumbent")):
        _close(s[k], np.asarray(getattr(j1, name)))
        _close(s[k], w[k])
