###############################################################################
# Multi-process dry run worker: one RANK of a scenario mesh (port of
# mpisppy_tpu/parallel/_multihost_dryrun.py).
#
#   python -m mpisppy_tpu_torch.parallel._multihost_dryrun \
#       <coordinator> <num_processes> <process_id> [device]
#
# device: "cpu" (gloo; what the CPU tests run) or "cuda" (NCCL, one card
# per rank; the default).  Builds the farmer batch (S=3, padded to the
# world size), shards it over the process group, runs PH iter0 + one
# iterk, and prints "CONV <value> TB <value> procs <n> devices <n>" —
# every rank must print the same values (the reductions are global).
# The reference validates its MPI layer the same way with `mpiexec -np
# 2` smoke tests (ref:mpisppy/tests/straight_tests.py:36-44).
###############################################################################
import sys


def main():
    coord, n_proc, pid = sys.argv[1:4]
    device = sys.argv[4] if len(sys.argv) > 4 else "cuda"
    import torch

    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    mesh_mod.init_multihost(coord, int(n_proc), int(pid), device=device)

    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import farmer

    torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh()
    dev = mesh.device if mesh.device is not None else device
    specs = [farmer.scenario_creator(nm, num_scens=3)
             for nm in farmer.scenario_names_creator(3)]
    batch = batch_mod.from_specs(specs, device=dev)
    batch = batch_mod.pad_to_multiple(batch, mesh.size)
    batch = mesh_mod.shard_batch(batch, mesh)

    opts = ph_mod.PHOptions(default_rho=1.0, subproblem_windows=4,
                            iter0_windows=100)
    rho = torch.full((batch.num_nonants,), opts.default_rho,
                     device=batch.device)
    state, tb, _ = ph_mod.ph_iter0(batch, rho, opts)
    state = ph_mod.ph_iterk(batch, state, opts)
    conv = float(state.conv)
    print(f"CONV {conv:.6e} TB {float(tb):.6e} "
          f"procs {mesh_mod.process_count()} devices {mesh.size}",
          flush=True)
    mesh_mod.shutdown()


if __name__ == "__main__":
    main()
