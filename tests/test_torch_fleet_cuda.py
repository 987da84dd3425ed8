# Card tests of the fleet and the scenario mesh (marker `cuda`; skip
# without an NVIDIA GPU).  Two fleet replicas live in one process, each
# with its own engine and structure interner on the same card: their
# sessions' first windows may run in two threads at once, and every
# window must reach the kernel (the launch counters count both).  An
# NCCL process group of one rank: every collective is the identity, so a
# sharded PH iteration equals the unsharded one bit for bit.  This file
# imports neither JAX nor the JAX package:
#
#     python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py -q
import threading

import pytest
import torch

from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.serve import SubmitRequest
from mpisppy_tpu_torch.serve.session import Session

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_two_replicas_first_windows_in_two_threads(cuda, tmp_path):
    from mpisppy_tpu_torch.fleet import FleetOptions, FleetRouter
    router = FleetRouter(FleetOptions(
        unix_path=str(tmp_path / "f.sock"), n_replicas=2,
        max_running_per_replica=1, multiplex=False, device="cuda"))
    engines = [r.server.engine for r in router.replicas]
    assert engines[0] is not engines[1]
    assert engines[0].interner is not engines[1].interner
    assert all(e.device == "cuda" for e in engines)
    run = pdhg_window.run_window
    before = sum(run.launches.values())
    barrier = threading.Barrier(2)
    out = {}

    def session(i):
        spec = SubmitRequest(tenant=f"t{i}", model="sslp",
                             num_scens=16 + i, max_iterations=2)
        barrier.wait(timeout=60)
        out[i] = engines[i].run(Session(spec))

    threads = [threading.Thread(target=session, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads)
    assert [out[i][0] for i in range(2)] == ["done", "done"], out
    assert sum(run.launches.values()) > before


def test_nccl_world_of_one_equals_unsharded(cuda, tmp_path):
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod

    inst = sslp.synthetic_instance(5, 15, seed=0)
    b = batch_mod.from_specs(
        [sslp.scenario_creator(nm, instance=inst, num_scens=64,
                               lp_relax=True)
         for nm in sslp.scenario_names_creator(64)], device="cuda")
    opts = ph_mod.PHOptions(default_rho=20.0, subproblem_windows=4,
                            iter0_windows=40)
    rho = torch.full((b.num_nonants,), 20.0, device="cuda")

    def run(batch):
        st, tb, _ = ph_mod.ph_iter0(batch, rho, opts)
        for _ in range(3):
            st = ph_mod.ph_iterk(batch, st, opts)
        return st, tb

    st0, tb0 = run(b)
    mesh_mod.init_multihost(f"file://{tmp_path / 'store'}", 1, 0,
                            device="cuda", timeout_s=120)
    try:
        mesh = mesh_mod.make_mesh()
        assert mesh.world == 1 and mesh.group is not None
        st1, tb1 = run(mesh_mod.shard_batch(b, mesh))
        assert mesh.calls["all_reduce"] > 0
    finally:
        mesh_mod.shutdown()
    assert float(tb1) == float(tb0)
    for f in ("W", "xbar", "xbar_nodes", "conv"):
        assert torch.equal(getattr(st1, f), getattr(st0, f)), f
