###############################################################################
# Elastic mesh dry run worker: one RANK of a multi-process scenario mesh
# under the elastic fault domain (port of
# mpisppy_tpu/parallel/_elastic_dryrun.py).
#
#   python -m mpisppy_tpu_torch.parallel._elastic_dryrun kill \
#       <coordinator> <num_processes> <process_id> <device> <workdir>
#   python -m mpisppy_tpu_torch.parallel._elastic_dryrun partition \
#       <coordinator> <num_processes> <process_id> <device> <workdir>
#   python -m mpisppy_tpu_torch.parallel._elastic_dryrun resume \
#       <workdir> [device]
#   python -m mpisppy_tpu_torch.parallel._elastic_dryrun baseline \
#       <workdir> [device]
#
# device: "cpu" (gloo) or "cuda" (NCCL, one card per rank; a single card
# runs resume and baseline, the world of one).
#
# kill: every rank spins the SAME sharded fused wheel with a
# synchronized checkpoint every 4 hub iterations (a collective gather,
# rank 0 writes).  The victim (last rank) stops beaconing one iteration
# before it dies at iteration 5; the survivor's beacon sweep sees the
# host go SUSPECT then DEAD and its harvest trips MeshDegraded (or, when
# its sweep read the last beacon late, its next collective with the dead
# peer fails, typed the same way), the emergency
# gather cannot complete without the peer (bounded by
# checkpoint_gather_timeout_s; the iteration-4 snapshot stays) and the
# process exits 75 (EX_TEMPFAIL: restartable) printing HOSTLOST.  A
# process group cannot shrink while live, so the elastic loop across
# processes is a RELAUNCH at the survivor topology: `resume` runs one
# process (the serial mesh), re-pads the S=13 program from the world of
# two's 14 rows to 13 through elastic.adapt_checkpoint_arrays, and spins
# to the certified gap.  `baseline` is the fault-free serial run.
#
# partition: the victim's beacon delivery is suppressed for beats 1-2
# (a partition, not a death).  The ranks meet only at collectives, so a
# sweep may run before the peer's beacon of the same iteration lands:
# the survivor's budget is the window (2) plus that race plus one
# (dead_after=4), and it only reaches SUSPECT; the first beat after the
# window heals the host and the wheel completes with NO reshard.
###############################################################################
import os
import sys

S = 13
KILL_ITER = 5
CKPT_EVERY = 4
REL_GAP = 5e-3
PARTITION_REL_GAP = 1e-3   # tighter target -> enough iters to heal


def _build(mesh, ckpt, rel_gap, device, extra=None):
    from mpisppy_tpu_torch import scengen
    from mpisppy_tpu_torch.algos import fused_wheel as fw
    from mpisppy_tpu_torch.algos import ph as ph_mod
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.cylinders.spoke import (
        FusedLagrangianOuterBound, FusedXhatXbarInnerBound,
    )
    from mpisppy_tpu_torch.models import farmer
    from mpisppy_tpu_torch.ops import pdhg
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner

    prog = farmer.scenario_program(S, seed=0)
    b = mesh_mod.shard_batch(scengen.virtual_batch(prog, device=device),
                             mesh, pad=True)
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=80,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    wopts = fw.FusedWheelOptions(lag_windows=4, xhat_windows=2,
                                 slam_windows=0, shuffle_windows=0,
                                 split_dispatch=False,
                                 lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
                                 xhat_pdhg=pdhg.PDHGOptions(
                                     tol=1e-7, omega0=0.1,
                                     restart_period=80))
    hub_opts = {"rel_gap": rel_gap, "checkpoint_path": ckpt,
                "checkpoint_every_s": 1e9}
    hub_opts.update(extra or {})
    hub = {"hub_class": PHHub, "hub_kwargs": {"options": hub_opts},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": opts, "batch": b,
                          "wheel_options": wopts}}
    spokes = [
        {"spoke_class": FusedLagrangianOuterBound,
         "opt_kwargs": {"options": {}}},
        {"spoke_class": FusedXhatXbarInnerBound,
         "opt_kwargs": {"options": {}}},
    ]
    return WheelSpinner(hub, spokes)


def _bracket(ws):
    inner, outer = float(ws.BestInnerBound), float(ws.BestOuterBound)
    gap = (inner - outer) / max(abs(inner), abs(outer), 1e-12)
    return inner, outer, gap


class _Victim:
    """The doomed host's harvest seam: beacons while healthy, falls
    silent one iteration before dying so the survivor's sweep sees the
    staleness, then exits without warning (a real host loss)."""

    def __init__(self, membership, self_host):
        self._mm, self._host = membership, self_host

    def harvest(self, fetch, hub_iter):
        import numpy as np
        if hub_iter >= KILL_ITER:
            sys.stdout.flush()
            os._exit(0)
        if hub_iter < KILL_ITER - 1:
            self._mm.beat(self._host)
        return np.asarray(fetch())


def _join(coord, n_proc, pid, device):
    import torch

    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    torch.set_num_threads(1)
    mesh_mod.init_multihost(coord, n_proc, pid, device=device,
                            timeout_s=60.0)
    mesh = mesh_mod.make_mesh()
    return mesh, (mesh.device if mesh.device is not None else device)


def _run_kill(coord, n_proc, pid, device, workdir):
    mesh, dev = _join(coord, n_proc, pid, device)
    from mpisppy_tpu_torch.parallel import elastic

    beacons = os.path.join(workdir, "beacons")
    os.makedirs(beacons, exist_ok=True)
    ckpt = os.path.join(workdir, "ckpt.npz")
    ws = _build(mesh, ckpt, REL_GAP, dev,
                extra={"checkpoint_every_iters": CKPT_EVERY,
                       "checkpoint_gather_timeout_s": 5.0})
    ws.build()
    mm = elastic.MeshMembership(n_proc, dead_after=2, self_host=pid,
                                beacon_dir=beacons)
    victim = pid == n_proc - 1
    if victim:
        ws.spcomm.options["mesh_runtime"] = _Victim(mm, pid)
    else:
        ws.spcomm.options["mesh_runtime"] = elastic.MeshRuntime(mm)
    try:
        ws.spin()
    except elastic.MeshDegraded as e:
        # confirm the death on the beacon ladder (whichever of the
        # sweep and the failed collective tripped first)
        for _ in range(3):
            mm.poll()
        print(f"HOSTLOST reason={e.reason} "  # telemetry: allow-print
              f"iter={e.hub_iter} "
              f"dead={mm.dead_hosts()} "
              f"ckpt={int(os.path.exists(ckpt))}", flush=True)
        os._exit(75)
    print(f"UNEXPECTED_COMPLETE "  # telemetry: allow-print
          f"iter={ws.spcomm._iter}", flush=True)
    os._exit(1)


def _run_partition(coord, n_proc, pid, device, workdir):
    mesh, dev = _join(coord, n_proc, pid, device)
    from mpisppy_tpu_torch.parallel import elastic
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    from mpisppy_tpu_torch.resilience import FaultPlan, MeshFault
    from mpisppy_tpu_torch.telemetry import EventBus

    beacons = os.path.join(workdir, "beacons")
    os.makedirs(beacons, exist_ok=True)
    ckpt = os.path.join(workdir, f"ckpt_p{pid}.npz")
    ws = _build(mesh, ckpt, PARTITION_REL_GAP, dev)
    ws.build()

    moves: list[str] = []   # membership transition history, in order

    class _Sink:
        def handle(self, event):
            if event.kind == "mesh-state":
                moves.append(f"{event.data['host']}:"
                             f"{event.data['state']}")

        def close(self):
            pass

    bus = EventBus()
    bus.subscribe(_Sink())
    mm = elastic.MeshMembership(n_proc, dead_after=4, self_host=pid,
                                beacon_dir=beacons, bus=bus,
                                run=f"p{pid}")
    victim = pid == n_proc - 1
    plan = FaultPlan(meshes=(
        MeshFault("partition", host=pid, at_beats=(1, 2)),)) \
        if victim else None
    ws.spcomm.options["mesh_runtime"] = elastic.MeshRuntime(mm, plan=plan)
    ws.spin()
    inner, outer, gap = _bracket(ws)
    print(f"PARTITION_OK "  # telemetry: allow-print
          f"inner={inner:.6e} outer={outer:.6e} "
          f"gap={gap:.3e} iter={ws.spcomm._iter} "
          f"moves={','.join(moves) or 'none'} "
          f"dead={mm.dead_hosts()} epoch={mm.epoch}", flush=True)
    mesh_mod.shutdown()


def _run_single(workdir, resume, device):
    import torch

    from mpisppy_tpu_torch.parallel import elastic
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    tag = "RESUME" if resume else "BASE"
    ckpt = os.path.join(workdir,
                        "ckpt.npz" if resume else "ckpt_base.npz")
    mesh = mesh_mod.make_mesh(1)
    ws = _build(mesh, ckpt, REL_GAP, device)
    ws.build()
    start = 0
    if resume:
        s_new = ws.spcomm.opt.batch.num_scenarios
        with __import__("numpy").load(ckpt) as d:
            s_old = int(d["leaf0"].shape[0])   # the killed layout's rows
        ws.spcomm.load_checkpoint(
            ckpt, transform=lambda arrays: elastic.adapt_checkpoint_arrays(
                arrays, S, s_old, s_new))
        start = ws.spcomm._iter
    ws.spin()
    inner, outer, gap = _bracket(ws)
    print(f"{tag} "  # telemetry: allow-print
          f"inner={inner:.6e} outer={outer:.6e} gap={gap:.3e} "
          f"start={start} iter={ws.spcomm._iter} devices={mesh.size}",
          flush=True)


def main():
    mode = sys.argv[1]
    if mode in ("kill", "partition"):
        coord, n_proc, pid, device, workdir = sys.argv[2:7]
        fn = _run_kill if mode == "kill" else _run_partition
        fn(coord, int(n_proc), int(pid), device, workdir)
    elif mode in ("resume", "baseline"):
        device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
        _run_single(sys.argv[2], mode == "resume", device)
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
