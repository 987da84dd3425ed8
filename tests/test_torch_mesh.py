# Port parity: the scenario mesh (mpisppy_tpu_torch/parallel/mesh.py)
# on the CPU, over gloo process groups:
#   * shard_batch and process_local_slice: a rank's contiguous rows of
#     every scenario-major field, shared fields whole, the divisibility
#     error, zero-probability pad lanes (a materialized batch and a
#     VirtualBatch, whose shard draws its rows from their GLOBAL indices);
#   * a world-of-one gloo group (a FileStore under tmp_path, so xdist
#     workers never share a port): sharded PH equals the unsharded run
#     bit for bit (every collective over one rank is the identity);
#   * two gloo processes: PH iter0 + iterk on farmer S=3 padded to 4 —
#     both ranks print the same conv, within tests/test_sharding.py's
#     tolerances of the JAX package's 8-device sharded run; hydro (3,3)
#     node averages equal the unsharded ones; one fused-wheel iteration
#     of sslp 5x15 (S=8) whose packed scalars equal the unsharded
#     iteration's within 1e-5;
#   * every algorithm takes a batch split over several ranks.
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ph as jph
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.parallel import mesh as jmesh
from mpisppy_tpu_torch import scengen
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.parallel import mesh as mesh_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def farmer_batch(S=3):
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=S)
         for nm in farmer.scenario_names_creator(S)], device="cpu")


def fake_mesh(rank, world, size=None):
    """A layout without a process group (shard_batch reads rank/world)."""
    return mesh_mod.ScenarioMesh(group=None, rank=rank, world=world,
                                 device=None, size=size or world)


def spawn(tmp_path, body: str, world: int = 2, timeout=240) -> list:
    """Run `body` in `world` gloo ranks (a FileStore under tmp_path); each
    rank's `out` dict comes back from its last stdout line."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent("""
        import json, sys
        import torch
        torch.set_num_threads(1)
        from mpisppy_tpu_torch.parallel import mesh as mesh_mod
        rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        mesh_mod.init_multihost("file://" + store, world, rank,
                                device="cpu", timeout_s=120)
        mesh = mesh_mod.make_mesh()
        out = {}
    """) + textwrap.dedent(body) + textwrap.dedent("""
        # every rank past its last collective before the group goes
        torch.distributed.barrier()
        mesh_mod.shutdown()
        print("OUT " + json.dumps(out), flush=True)
    """))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), store],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    for p in procs:
        o, e = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e}"
        line = [ln for ln in o.splitlines() if ln.startswith("OUT ")][-1]
        outs.append(json.loads(line[4:]))
    return outs


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def test_shard_batch_slices_scenario_fields_only():
    b = batch_mod.pad_to_multiple(farmer_batch(3), 4)
    parts = [mesh_mod.shard_batch(b, fake_mesh(r, 2)) for r in (0, 1)]
    for r, sb in enumerate(parts):
        rows = slice(2 * r, 2 * r + 2)
        assert sb.num_scenarios == 2 and sb.scen_offset == 2 * r
        assert sb.num_real == 3
        assert torch.equal(sb.qp.A, b.qp.A[rows])     # farmer: per-scen A
        assert torch.equal(sb.qp.c, b.qp.c[rows])
        assert torch.equal(sb.p, b.p[rows])
        assert torch.equal(sb.nonant_idx, b.nonant_idx)
        assert sb.mesh.rank == r
    assert float(parts[1].p[1]) == 0.0       # the pad lane
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.shard_batch(farmer_batch(3), fake_mesh(0, 2))
    padded = mesh_mod.shard_batch(farmer_batch(3), fake_mesh(0, 1, 6),
                                  pad=True)
    assert padded.num_scenarios == 6
    np.testing.assert_array_equal(padded.p[3:].numpy(), np.zeros(3))
    assert float(padded.p.sum()) == pytest.approx(1.0)
    # a world of one holds every row, untouched
    whole = mesh_mod.shard_batch(b, fake_mesh(0, 1))
    assert whole.qp.A is b.qp.A and whole.p is b.p


def test_process_local_slice_and_serial_mesh():
    assert mesh_mod.process_count() == 1
    assert mesh_mod.process_local_slice(8) == slice(0, 8)
    m = mesh_mod.make_mesh(8)
    assert (m.group, m.world, m.size) == (None, 1, 8)
    assert mesh_mod.make_mesh(1).size == 1
    assert mesh_mod.make_mesh(devices=[0, 2, 3]).size == 3


def test_virtual_shard_draws_global_rows():
    """A VirtualBatch shard realizes its rows from their global scenario
    indices: rank r's realized data is rows [r*per, (r+1)*per) of the
    whole batch's realization, bit for bit (pad lanes clone the last
    real scenario, p = 0)."""
    prog = farmer.scenario_program(13, seed=0)
    vb = scengen.virtual_batch(prog, device="cpu")
    full = mesh_mod.shard_batch(vb, fake_mesh(0, 1, 4), pad=True)
    assert full.num_scenarios == 16 and full.num_real == 13
    whole = full.realize()
    for r in range(4):
        part = mesh_mod.shard_batch(vb, fake_mesh(r, 4), pad=True)
        got = part.realize()
        rows = slice(4 * r, 4 * r + 4)
        assert torch.equal(part.scenario_indices(),
                           full.scenario_indices()[rows])
        for f in ("c", "A", "bl", "bu", "l", "u"):
            a, w = getattr(got.qp, f), getattr(whole.qp, f)
            assert torch.equal(a, w[rows] if a.shape != w.shape else w), f
        assert torch.equal(got.p, whole.p[rows])
        assert got.mesh is part.mesh and got.scen_offset == 4 * r


def test_every_algorithm_takes_a_split_batch():
    """Every algorithm takes a batch split over several ranks (a layout
    without a process group: rank 0's rows of two); the two-rank runs
    are held in tests/test_torch_mesh_{decomp,mip,aph}.py."""
    from mpisppy_tpu_torch.algos import aph, async_wheel, fwph, lshaped, mip
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.algos import sc as sc_mod
    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.ops import bnb
    b = batch_mod.pad_to_multiple(farmer_batch(3), 4)
    sb = mesh_mod.shard_batch(b, fake_mesh(0, 2))
    assert sb.num_scenarios == 2 and sb.mesh.world == 2
    assert not hasattr(mesh_mod, "ShardedBatchUnsupported")
    fwph.FWPH(fwph.FWPHOptions(), sb)
    lshaped.LShapedMethod({}, sb)
    aph.APH(aph.APHOptions(), sb)
    sc_mod.SchurComplement({}, sb)
    async_wheel.AsyncFusedPH(ph_mod.PHOptions(), sb)
    inst = sslp.synthetic_instance(3, 6, seed=4)
    ib = batch_mod.from_specs(
        [sslp.scenario_creator(nm, instance=inst, num_scens=4)
         for nm in sslp.scenario_names_creator(4)], device="cpu")
    res = mip.certified_mip_gap(
        mesh_mod.shard_batch(ib, fake_mesh(0, 2)),
        ph_mod.PHOptions(max_iterations=1),
        bnb.BnBOptions(pool_size=8, max_rounds=4, dive_rounds=4,
                       dive_tail=8, pump_rounds=0), n_shuffle=1, dd_nodes=0)
    assert np.isfinite(res.outer)


# ---------------------------------------------------------------------------
# a world of one over gloo: bit for bit
# ---------------------------------------------------------------------------
def _ph_run(batch, iters=3):
    opts = tph.PHOptions(default_rho=1.0, subproblem_windows=4,
                         iter0_windows=100)
    rho = torch.ones(batch.num_nonants)
    st, tb, cert = tph.ph_iter0(batch, rho, opts)
    for _ in range(iters):
        st = tph.ph_iterk(batch, st, opts)
    return st, tb


def test_world_of_one_gloo_ph_equals_unsharded(tmp_path):
    import torch.distributed as dist
    b = batch_mod.pad_to_multiple(farmer_batch(3), 4)
    st0, tb0 = _ph_run(b)
    mesh_mod.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cpu", timeout_s=60)
    try:
        mesh = mesh_mod.make_mesh()
        assert mesh.group is not None and mesh.world == 1
        st1, tb1 = _ph_run(mesh_mod.shard_batch(b, mesh))
        assert mesh.calls["all_reduce"] > 0
    finally:
        mesh_mod.shutdown()
    assert not dist.is_initialized()
    assert float(tb1) == float(tb0)
    for f in ("W", "xbar", "xbar_nodes", "conv"):
        assert torch.equal(getattr(st1, f), getattr(st0, f)), f
    assert torch.equal(st1.solver.x, st0.solver.x)


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------
def test_two_process_gloo_ph_matches_jax_sharded(tmp_path):
    """The multi-process dry run: both ranks print the same conv and
    trivial bound, within test_sharding.py's tolerances of the JAX
    package's PH on the 8-device virtual mesh (farmer S=3 padded)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    coord = f"file://{tmp_path / 'store'}"
    cmd = [sys.executable, "-m",
           "mpisppy_tpu_torch.parallel._multihost_dryrun", coord, "2"]
    procs = [subprocess.Popen(cmd + [str(pid), "cpu"], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in (0, 1)]
    vals = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
        line = [ln for ln in out.splitlines() if ln.startswith("CONV")][0]
        f = line.split()
        assert f[5] == "2" and f[7] == "2", line
        vals.append((float(f[1]), float(f[3])))
    assert vals[0] == vals[1]
    # the JAX package's sharded run, as its dry run does it
    specs = [jfarmer.scenario_creator(nm, num_scens=3)
             for nm in jfarmer.scenario_names_creator(3)]
    jb = jbatch.pad_to_multiple(jbatch.from_specs(specs), 8)
    jb = jmesh.shard_batch(jb, jmesh.make_mesh(8))
    opts = jph.PHOptions(default_rho=1.0, subproblem_windows=4,
                         iter0_windows=100)
    st, tb, _ = jph.ph_iter0(jb, jnp.full((jb.num_nonants,), 1.0), opts)
    st = jph.ph_iterk(jb, st, opts)
    assert len(jax.devices()) >= 8
    np.testing.assert_allclose(vals[0][0], float(st.conv), rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_allclose(vals[0][1], float(tb), rtol=1e-5)


def test_two_process_hydro_node_averages(tmp_path):
    """Multistage node averages (index_add_ over the global node count,
    then the all-reduce): hydro (3,3) split over two ranks equals the
    unsharded average."""
    outs = spawn(tmp_path, """
        import numpy as np
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import hydro
        names = hydro.scenario_names_creator(9)
        b = batch_mod.from_specs(
            [hydro.scenario_creator(nm) for nm in names],
            tree=hydro.make_tree((3, 3)), device="cpu")
        b = batch_mod.pad_to_multiple(b, 2)
        vals = torch.as_tensor(np.random.default_rng(0).normal(
            size=(b.num_scenarios, b.num_nonants)).astype(np.float32))
        scen, nodes = b.node_average(vals)
        sb = mesh_mod.shard_batch(b, mesh)
        off, S = sb.scen_offset, sb.num_scenarios
        s_scen, s_nodes = sb.node_average(vals[off:off + S])
        out = {"err_nodes": float((s_nodes - nodes).abs().max()),
               "err_scen": float((s_scen - scen[off:off + S]).abs().max()),
               "scale": float(nodes.abs().max())}
    """)
    for o in outs:
        assert o["err_nodes"] <= 1e-6 * o["scale"]
        assert o["err_scen"] <= 1e-6 * o["scale"]


def test_two_process_fused_wheel_iteration(tmp_path):
    """One fused-wheel iteration (every plane: Lagrangian, x̂ with its
    straggler tail, slam, shuffle) of sslp 5x15 at S=8 split over two
    ranks: both ranks' packed scalars equal the unsharded iteration's
    within 1e-5 (relative to max(1, |value|))."""
    outs = spawn(tmp_path, """
        from mpisppy_tpu_torch.algos import fused_wheel as fw
        from mpisppy_tpu_torch.algos import ph as ph_mod
        from mpisppy_tpu_torch.core import batch as batch_mod
        from mpisppy_tpu_torch.models import sslp
        from mpisppy_tpu_torch.ops import pdhg
        inst = sslp.synthetic_instance(5, 15, seed=0)
        b = batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=8,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(8)], device="cpu")
        opts = ph_mod.PHOptions(default_rho=20.0, subproblem_windows=4,
                                iter0_windows=40,
                                pdhg=pdhg.PDHGOptions(tol=1e-6))
        wopts = fw.FusedWheelOptions(lag_windows=2, xhat_windows=2,
                                     slam_windows=1, shuffle_windows=1)
        rho = torch.full((b.num_nonants,), 20.0)

        def run(batch):
            st, _, _ = fw.fused_iter0(batch, rho, opts, wopts)
            st = fw.fused_iterk(batch, st, opts, wopts, shuf_id=5)
            return [float(v) for v in st.scalars]
        out = {"whole": run(b), "split": run(mesh_mod.shard_batch(b, mesh))}
    """)
    for o in outs:
        for a, w in zip(o["split"], o["whole"]):
            if np.isinf(w):
                assert a == w
            else:
                assert abs(a - w) <= 1e-5 * max(1.0, abs(w)), (o, a, w)
    assert outs[0]["split"] == outs[1]["split"]
