# Card tests of every algorithm on the scenario mesh (marker `cuda`; skip
# without an NVIDIA GPU): an NCCL process group of one rank, each
# algorithm on a small batch unsharded and shard_batch-ed, their results
# equal bit for bit (every collective over one rank is the identity) and
# the launches by design equal.  One test per chip_smoke.py mesh phase:
# L-shaped (the master broadcast), the Lagrangian MIP bound,
# cross-scenario cuts, APH, the async wheel, FWPH and the Schur
# complement.  This file imports neither JAX nor the JAX package:
#
#     python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py -q
import json

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.ops import pdhg_window

pytestmark = pytest.mark.cuda


@pytest.fixture()
def mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cuda", timeout_s=120)
    try:
        yield mesh_mod.make_mesh()
    finally:
        mesh_mod.shutdown()


def sslp(S, n_fac=5, n_cli=15, lp_relax=True):
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp as model
    inst = model.synthetic_instance(n_fac, n_cli, seed=0)
    return batch_mod.from_specs(
        [model.scenario_creator(nm, instance=inst, num_scens=S,
                                lp_relax=lp_relax)
         for nm in model.scenario_names_creator(S)], device="cuda")


def held(mesh, batch, run, calls=("all_reduce",)):
    """run(batch) and run(its shard): equal JSON (exact floats), equal
    launches by design, a collective of each kind in `calls`."""
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    counts = pdhg_window.run_window.launches_by_design
    counts.clear()
    ref = json.dumps(run(batch), sort_keys=True)
    ref_launches = dict(counts)
    counts.clear()
    before = dict(mesh.calls)
    got = json.dumps(run(mesh_mod.shard_batch(batch, mesh)), sort_keys=True)
    assert got == ref
    assert dict(counts) == ref_launches
    for k in calls:
        assert mesh.calls[k] > before[k], k
    return ref_launches


def test_lshaped_master_broadcast(mesh):
    from mpisppy_tpu_torch.algos import lshaped
    from mpisppy_tpu_torch.ops import pdhg

    def run(b):
        ls = lshaped.LShapedMethod(lshaped.LShapedOptions(
            max_iter=2, sub_pdhg=pdhg.PDHGOptions(
                tol=1e-6, max_iters=20_000, detect_infeas=True)), b)
        r = ls.lshaped_algorithm()
        return {"lb": r["bound"], "ub": r["ub"],
                "xhat": [float(v) for v in r["xhat"]],
                "rows": [[t["lb"], t["ub"], t["ncuts"]] for t in ls.trace]}
    launches = held(mesh, sslp(16), run, ("all_gather", "broadcast"))
    assert any("split" in k for k in launches)


def test_lagrangian_mip_bound(mesh):
    from mpisppy_tpu_torch.algos import mip
    from mpisppy_tpu_torch.ops import bnb, pdhg
    b = sslp(8, 3, 8, lp_relax=False)
    W = torch.as_tensor(np.random.RandomState(6).randn(8, b.num_nonants)
                        .astype(np.float32), device="cuda")
    W -= W.mean(0)
    opts = bnb.BnBOptions(max_rounds=3, pump_rounds=0,
                          lp=pdhg.PDHGOptions(tol=1e-5, max_iters=2_000))

    def run(batch):
        lag = mip.lagrangian_mip_bound(batch, W, opts)
        return {"bound": lag["bound"],
                "outer": lag["per_scenario"].tolist()}
    assert held(mesh, b, run, ("all_gather",))


def test_cross_scen_round(mesh):
    from mpisppy_tpu_torch.algos import cross_scen
    from mpisppy_tpu_torch.ops import pdhg
    opts = pdhg.PDHGOptions(tol=1e-4, max_iters=400, detect_infeas=True)
    b = sslp(16)
    nonants = torch.rand((16, b.num_nonants), generator=torch.Generator()
                         .manual_seed(3)).to("cuda")

    def run(batch):
        eta_lb = cross_scen.eta_lower_bounds(batch, opts, windows=20)
        meta = cross_scen.make_meta(batch, eta_lb, max_rounds=2)
        raw = cross_scen.launch_cuts(batch, nonants, nonants.mean(0), opts)
        cross_scen.write_cuts(meta, cross_scen.package_cuts(raw, opts))
        bound, _ = cross_scen.ef_check_bound(meta, opts, windows=20)
        return {"sid": raw["sid"], "dual": raw["dual"].tolist(),
                "bound": bound}
    held(mesh, b, run, ("all_gather", "all_reduce"))


def test_aph_dispatch(mesh):
    from mpisppy_tpu_torch.algos import aph
    from mpisppy_tpu_torch.ops import pdhg
    opts = aph.APHOptions(default_rho=20.0, dispatch_frac=0.5,
                          iter0_windows=20, subproblem_windows=4,
                          pdhg=pdhg.PDHGOptions(tol=1e-6,
                                                iter_precision="bf16x3"))
    b = sslp(64)

    def run(batch):
        st, tb, _ = aph.aph_iter0(batch, torch.full(
            (batch.num_nonants,), 20.0, device="cuda"), opts)
        for _ in range(3):
            st = aph.aph_iterk(batch, st, opts)
        return {"tb": float(tb), "conv": float(st.conv),
                "last_solved": batch.scen_host(st.last_solved).tolist()}
    launches = held(mesh, b, run, ("all_gather", "all_reduce"))
    assert any("bf16x3" in k for k in launches)


def test_async_wheel(mesh):
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
                     default_rho=20.0, max_iterations=3, conv_thresh=0.0,
                     subproblem_windows=4, iter0_windows=40,
                     pdhg=pdhg.PDHGOptions(tol=1e-6,
                                           iter_precision="bf16x3")),
                 "batch": batch, "wheel_options": fw.FusedWheelOptions(),
                 "async_options": aw.AsyncWheelOptions(staleness=1)}},
            [{"spoke_class": spoke.FusedLagrangianOuterBound,
              "opt_kwargs": {"options": {}}}]).spin()
        return [[r["iter"], r["conv"], r["outer"]] for r in ws.spcomm.trace]
    held(mesh, sslp(64), run)


def test_fwph_no_kernel(mesh):
    from mpisppy_tpu_torch.algos import fwph
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer
    b = batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=16, crops_multiplier=2)
         for nm in farmer.scenario_names_creator(16)], device="cuda")
    opts = fwph.FWPHOptions(fw_iter_limit=1, max_columns=4,
                            iter0_windows=20, oracle_windows=2)

    def run(batch):
        st, tb, _ = fwph.fwph_init(batch, torch.ones(
            batch.num_nonants, device="cuda"), opts)
        st = fwph.fwph_iter(batch, st, opts)
        return {"tb": float(tb), "bound": float(st.bound),
                "xbar": st.xbar_nodes[0].tolist()}
    assert held(mesh, b, run) == {}      # per-scenario A: the plain route


def test_schur_complement(mesh):
    from mpisppy_tpu_torch.algos.sc import SchurComplement, SCOptions

    def run(batch):
        r = SchurComplement(SCOptions(max_iter=250, tol=1e-10),
                            batch).solve()
        return {"objective": r["objective"], "x": r["x"].tolist()}
    held(mesh, sslp(4, 3, 9), run, ("all_reduce", "all_gather"))
