###############################################################################
# Elastic mesh: the fault domain of the sharded wheel (port of
# mpisppy_tpu/parallel/elastic.py; docs/resilience.md).
#
# parallel/mesh.py gives the wheel its "MPI"; this module gives it the
# property the reference gets from hub-and-spoke tolerance of slow
# cylinders (ref:mpisppy/cylinders/hub.py stale-window reads) at the
# layer the reference never has: the MESH.  Three guarantees:
#
#   1. membership  — a heartbeat/epoch service over the hosts of the
#      mesh (UP -> SUSPECT -> sticky DEAD, the fleet health ladder of
#      fleet/health.py applied to mesh hosts).  A SUSPECT host whose
#      beats return rejoins UP at the next epoch WITHOUT a reshard (a
#      healed partition); a DEAD host never comes back (fencing — no
#      split brain between a zombie host and its re-sharded range).
#   2. bounded harvest — the ONE place the hub loop blocks on the mesh
#      (the packed-scalar read in FusedPH._cache_scalars, which waits
#      for the iteration's all-reduces) gets a wall-clock deadline: a
#      straggler or wedged collective trips a typed MeshDegraded instead
#      of hanging the hub, and the watchdog ladder
#      (resilience/watchdog.py) escalates degrade -> shrink -> abort.  A
#      torn transfer (non-finite scalars off an intact device value) is
#      detected and synchronously re-fetched.
#   3. elastic re-shard — on host loss the wheel emergency-checkpoints
#      the hub plane (MeshDegraded IS a PreemptionError), re-partitions
#      the VirtualBatch rows across the survivors
#      (scengen/virtual.repartition — zero scenario bytes move), maps the
#      checkpointed scenario-major state leaves onto the new padded axis
#      (adapt_checkpoint_arrays) and resumes — the certified outer/inner
#      bracket holds across the reshard because pad lanes carry zero
#      probability mass in every reduction.
#
# A gloo or NCCL process group cannot shrink while it is live: across
# processes the re-shard is a relaunch at the survivor topology
# (_elastic_dryrun.py's kill -> resume).  In one process, run_elastic
# rebuilds the wheel on a mesh of fewer device slots (a different pad
# multiple) and resumes through load_checkpoint(transform=...).
#
# Everything here is host-side: a wheel without a MeshRuntime in its
# options pays one dict lookup.
###############################################################################
from __future__ import annotations

import os
import threading
import time

import numpy as np

from mpisppy_tpu_torch.resilience.faults import PreemptionError
from mpisppy_tpu_torch.utils.atomic_io import atomic_write_text

UP = "UP"
SUSPECT = "SUSPECT"
DEAD = "DEAD"


class MeshDegraded(PreemptionError):
    """The mesh can no longer complete collectives at the current
    topology — a host was lost, a harvest missed its deadline, or a
    partition outlived the miss budget.  Subclasses PreemptionError ON
    PURPOSE: WheelSpinner.spin converts it into one synchronous
    emergency checkpoint before re-raising, which is exactly the state
    hand-off the elastic re-shard resumes from."""

    def __init__(self, reason: str, host: int | None = None,
                 hub_iter: int = -1, detail: str = ""):
        self.reason = reason      # 'host-lost' | 'straggler-deadline'
        #                           | 'collective-failed' (a process
        #                           group's collective raised: a peer
        #                           rank died)
        self.host = host          # the lost host, when known
        self.hub_iter = hub_iter
        super().__init__(
            f"mesh degraded ({reason}"
            + (f", host {host}" if host is not None else "")
            + (f", hub iter {hub_iter}" if hub_iter >= 0 else "")
            + (f": {detail}" if detail else "") + ")")


class MeshMembership:
    """Host membership over the mesh: the fleet health ladder
    (fleet/health.py UP -> SUSPECT -> sticky DEAD) keyed by host index,
    plus an EPOCH counter that increments on every transition — the
    version number a reshard is keyed by, and the proof a healed
    partition rejoined without one (epoch moves, device count does
    not).

    Beats arrive either in-process (`beat(host)` / `observe`) or as
    file beacons under `beacon_dir` (the multi-process gloo harness:
    gloo gives the processes no side channel, so liveness rides a
    shared filesystem the same way the checkpoint spool does).  A host
    whose beat is stale turns SUSPECT; `dead_after` consecutive stale
    polls turns it DEAD — sticky, the fencing guarantee."""

    def __init__(self, num_hosts: int, dead_after: int = 3,
                 self_host: int = 0, beacon_dir: str | None = None,
                 bus=None, run: str = ""):
        self.num_hosts = int(num_hosts)
        self.dead_after = max(1, int(dead_after))
        self.self_host = int(self_host)
        self.beacon_dir = beacon_dir
        self.bus = bus
        self.run = run
        self.epoch = 0
        self._lock = threading.Lock()
        self._state = {h: UP for h in range(self.num_hosts)}
        self._missed = {h: 0 for h in range(self.num_hosts)}
        self._last_beat = {h: -1 for h in range(self.num_hosts)}
        self._gauges()

    # -- beats ------------------------------------------------------------
    def beat(self, host: int, counter: int | None = None,
             plan=None) -> bool:
        """Record (or beacon) one liveness beat from `host`.  With a
        beacon_dir the beat is WRITTEN for other processes to poll;
        a plan's partition seam may suppress it (returns False)."""
        with self._lock:
            n = self._last_beat[host] + 1 if counter is None else counter
            # the beat was PRODUCED either way — a partition drops its
            # delivery, not the host's clock (the next beat after the
            # window must carry a fresh counter, or healing is
            # indistinguishable from the stale pre-partition beat)
            self._last_beat[host] = n
        if plan is not None and plan.mesh_partitioned(host, n):
            return False
        if self.beacon_dir is not None:
            atomic_write_text(
                os.path.join(self.beacon_dir, f"host{host}.beat"), str(n))
        self.observe(host, fresh=True, counter=n)
        return True

    def poll(self) -> list[int]:
        """One membership sweep: read every host's beacon (when
        beacon_dir is set) and run the ladder on freshness.  Returns
        hosts that transitioned to DEAD this sweep."""
        died = []
        for h in range(self.num_hosts):
            if h == self.self_host:
                continue
            fresh, counter = True, None
            if self.beacon_dir is not None:
                counter = self._read_beacon(h)
                with self._lock:
                    fresh = counter is not None \
                        and counter != self._last_beat[h]
            if self.observe(h, fresh=fresh, counter=counter) == DEAD:
                died.append(h)
        return died

    def _read_beacon(self, host: int) -> int | None:
        try:
            with open(os.path.join(self.beacon_dir,
                                   f"host{host}.beat")) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    # -- the ladder -------------------------------------------------------
    def observe(self, host: int, fresh: bool,
                counter: int | None = None, reason: str = "") -> str | None:
        """Apply one freshness observation; returns the NEW state when
        a transition happened, else None.  DEAD is sticky."""
        with self._lock:
            old = self._state[host]
            if counter is not None:
                self._last_beat[host] = counter
            if fresh:
                self._missed[host] = 0
                new = UP
                reason = reason or (
                    "partition-healed" if old == SUSPECT else "beat")
            else:
                self._missed[host] += 1
                new = DEAD if self._missed[host] >= self.dead_after \
                    else SUSPECT
                reason = reason or ("missed-beats"
                                    if new == DEAD else "stale-beat")
            return self._move(host, new, reason)

    def force(self, host: int, state: str, reason: str) -> str | None:
        """Out-of-band transition (a fault plan's host_lost, a test)."""
        with self._lock:
            return self._move(host, state, reason)

    def _move(self, host: int, new: str, reason: str) -> str | None:
        # guarded-by: _lock (both callers hold it)
        old = self._state[host]
        if old == new or old == DEAD:   # sticky DEAD: fencing
            return None
        self._state[host] = new
        self.epoch += 1
        epoch = self.epoch
        self._gauges()
        if self.bus is not None:
            from mpisppy_tpu_torch import telemetry as tel
            self.bus.emit(tel.MESH_STATE, run=self.run, cyl="mesh",
                          host=host, state=new, prev=old, epoch=epoch,
                          reason=reason)
        return new

    def _gauges(self) -> None:
        from mpisppy_tpu_torch.telemetry import metrics as _metrics
        up = sum(1 for s in self._state.values() if s != DEAD)
        _metrics.REGISTRY.set_gauge("mesh_hosts_up", float(up))
        _metrics.REGISTRY.set_gauge("mesh_epoch", float(self.epoch))

    # -- views ------------------------------------------------------------
    def state(self, host: int) -> str:
        with self._lock:
            return self._state[host]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._state)

    def dead_hosts(self) -> list[int]:
        with self._lock:
            return sorted(h for h, s in self._state.items() if s == DEAD)

    def live_hosts(self) -> list[int]:
        """UP + SUSPECT: a suspect host keeps its shard until the
        ladder declares it DEAD — suspicion alone never reshards."""
        with self._lock:
            return sorted(h for h, s in self._state.items() if s != DEAD)


def device_groups(devices, num_hosts: int) -> list[list]:
    """Partition the device slots (ranks, or a single process's virtual
    slots) into per-host groups: `num_hosts` contiguous groups — the
    same process-major layout process_local_slice uses."""
    devices = list(devices)
    per = max(1, len(devices) // num_hosts)
    return [list(devices[i * per:(i + 1) * per])
            for i in range(num_hosts)]


def survivor_devices(devices, num_hosts: int, dead_hosts) -> list:
    """The flat device list after dropping every dead host's group."""
    dead = set(dead_hosts)
    out = []
    for h, group in enumerate(device_groups(devices, num_hosts)):
        if h not in dead:
            out.extend(group)
    return out


def adapt_checkpoint_arrays(arrays: dict, num_real: int, s_old: int,
                            s_new: int) -> dict:
    """Map a checkpoint's scenario-major state leaves from the old
    padded scenario axis (s_old) onto the new one (s_new) — the
    `transform` hook of hub.load_checkpoint on the re-shard path.

    Leaves whose leading axis is s_old are sliced to the real prefix
    and re-padded by cloning the last real row — exactly the
    pad_to_multiple / VirtualBatch.realize() pad contract, so a pad
    lane resumes iterating on the last real scenario's data and its
    zero probability keeps it out of every reduction.  Everything else
    (bounds, spoke bests, xbar nodes, scalars) passes through
    untouched."""
    if s_old == s_new:
        return arrays
    out = dict(arrays)
    for k, v in arrays.items():
        if not k.startswith("leaf") or v.ndim < 1 or v.shape[0] != s_old:
            continue
        real = v[:min(num_real, s_old)]
        if s_new > real.shape[0]:
            pad = np.repeat(real[-1:], s_new - real.shape[0], axis=0)
            out[k] = np.concatenate([real, pad], axis=0)
        else:
            out[k] = real[:s_new]
    return out


class MeshRuntime:
    """The hub-side handle of the mesh fault domain: FusedPH routes its
    per-iteration packed-scalar fetch (the collective-completing
    device->host transfer) through `harvest`, which layers on the
    deadline, the chaos seams, and the membership sweep.  Installed as
    opt options['mesh_runtime']; absent, the wheel runs the
    zero-overhead default path."""

    def __init__(self, membership: MeshMembership | None = None,
                 plan=None, deadline_s: float | None = None,
                 bus=None, run: str = ""):
        self.membership = membership
        self.plan = plan
        self.deadline_s = deadline_s
        self.bus = bus
        self.run = run

    # -- the bounded, chaos-seamed harvest --------------------------------
    def harvest(self, fetch, hub_iter: int) -> np.ndarray:
        """Run `fetch` (the blocking np.asarray of the packed scalar
        vector) under the mesh fault domain.  Every caller observes a
        result, a typed MeshDegraded, or the watchdog's abort — never
        a hang (docs/resilience.md failure-semantics table)."""
        if self.membership is not None \
                and self.membership.beacon_dir is not None:
            # beacon mode (multi-process gloo): liveness rides the hub
            # loop cadence — one self-beat per harvest, suppressed by
            # the plan's partition seam when this host is partitioned
            self.membership.beat(self.membership.self_host,
                                 plan=self.plan)
        self._check_hosts(hub_iter)
        delay = self.plan.mesh_harvest_delay(hub_iter) \
            if self.plan is not None else 0.0
        t0 = time.perf_counter()
        vals = self._bounded(fetch, delay, hub_iter)
        if self.plan is not None and self.plan.mesh_torn_harvest(hub_iter):
            vals = np.full_like(np.asarray(vals), np.nan)
        if not np.all(np.isfinite(vals)):
            # a torn transfer leaves the DEVICE value intact: one
            # synchronous re-fetch separates a tear from a genuinely
            # non-finite state (which passes through to the hub's own
            # bound guards)
            refetched = np.asarray(fetch())
            if np.all(np.isfinite(refetched)):
                self._straggle_event("torn", hub_iter,
                                     time.perf_counter() - t0)
                from mpisppy_tpu_torch.telemetry import metrics as _metrics
                _metrics.REGISTRY.inc("mesh_torn_harvests_total")
            vals = refetched
        return vals

    def _bounded(self, fetch, delay: float, hub_iter: int):
        def run():
            if delay > 0.0:
                time.sleep(delay)   # the injected slow collective
            return np.asarray(fetch())

        if self.deadline_s is None:
            return run()
        box: list = []
        t = threading.Thread(
            target=lambda: box.append(run()), daemon=True,
            name="mpisppy-torch-mesh-harvest")
        t0 = time.perf_counter()
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            waited = time.perf_counter() - t0
            self._straggle_event("deadline", hub_iter, waited)
            from mpisppy_tpu_torch.telemetry import metrics as _metrics
            _metrics.REGISTRY.inc("mesh_stragglers_total")
            # the worker is abandoned (daemon): the run is unwinding to
            # an emergency checkpoint and a rebuilt wheel anyway
            raise MeshDegraded(
                "straggler-deadline", hub_iter=hub_iter,
                detail=f"harvest exceeded {self.deadline_s}s "
                       f"(waited {waited:.2f}s)")
        return box[0]

    def _check_hosts(self, hub_iter: int) -> None:
        """Membership sweep + the host_lost chaos seam: any host newly
        DEAD orphans its shard and degrades the mesh NOW."""
        lost: list[int] = []
        if self.plan is not None:
            h = self.plan.mesh_lost_host(hub_iter)
            if h is not None:
                lost.append(h)
        if self.membership is not None:
            if self.membership.beacon_dir is not None:
                lost.extend(self.membership.poll())
            for h in lost:
                self.membership.force(h, DEAD, "lost")
        if not lost:
            return
        from mpisppy_tpu_torch.telemetry import metrics as _metrics
        for h in lost:
            _metrics.REGISTRY.inc("mesh_hosts_lost_total")
            if self.bus is not None:
                from mpisppy_tpu_torch import telemetry as tel
                survivors = self.membership.live_hosts() \
                    if self.membership is not None else []
                self.bus.emit(tel.MESH_HOST_LOST, run=self.run,
                              cyl="mesh", host=h, hub_iter=hub_iter,
                              epoch=getattr(self.membership, "epoch", 0),
                              survivors=survivors)
        raise MeshDegraded("host-lost", host=lost[0], hub_iter=hub_iter)

    def _straggle_event(self, kind: str, hub_iter: int,
                        waited: float) -> None:
        if self.bus is None:
            return
        from mpisppy_tpu_torch import telemetry as tel
        # payload field is `mode` (not `kind` — that's the event kind)
        self.bus.emit(tel.MESH_STRAGGLER, run=self.run, cyl="mesh",
                      hub_iter=hub_iter, mode=kind,
                      waited_s=round(waited, 4),
                      budget_s=self.deadline_s)


def run_elastic(build_fn, *, num_hosts: int, checkpoint_path: str,
                plan=None, bus=None, run_id: str = "",
                harvest_deadline_s: float | None = None,
                membership: MeshMembership | None = None,
                devices=None, max_reshards: int | None = None):
    """Spin a wheel elastically: build at the current topology, run,
    and on MeshDegraded re-shard across the survivors and resume from
    the emergency checkpoint — the keyed re-sharding loop.

    build_fn(mesh) -> WheelSpinner for that mesh.  The caller shards
    its batch with `mesh_mod.shard_batch(batch, mesh, pad=True)` (pad
    lanes carry zero probability, so the certified bracket is
    layout-invariant) and must set options['checkpoint_path'] to
    `checkpoint_path` so the MeshDegraded -> PreemptionError unwind
    lands the emergency snapshot this loop resumes from.

    Returns (spinner, info): info['reshards'] records every
    (hub_iter, old_devices, new_devices, epoch) transition,
    info['resumed'] whether any re-shard happened.  A resumed run that
    still cannot finish counts into mesh_reshards_lost_total before
    the error propagates."""
    from mpisppy_tpu_torch.parallel import mesh as mesh_mod
    from mpisppy_tpu_torch.telemetry import metrics as _metrics

    all_devices = list(devices) if devices is not None \
        else list(range(max(num_hosts, mesh_mod.process_count())))
    if membership is None:
        membership = MeshMembership(num_hosts, bus=bus, run=run_id)
    if max_reshards is None:
        max_reshards = num_hosts - 1
    # causal trace: the elastic run is ONE trace; every
    # build-at-a-topology attempt is a child segment span of the same
    # root, so a reshard renders as sibling segments with the
    # MESH_HOST_LOST/MESH_RESHARD rows between them — the reshard gap
    # on the critical path
    root = None
    if bus is not None and hasattr(bus, "set_trace"):
        from mpisppy_tpu_torch import telemetry as tel
        root = bus.trace
        if root is None:
            root = tel.TraceContext.mint()
            bus.set_trace(root)
            bus.emit(tel.SPAN_START, run=run_id, cyl="mesh",
                     name="mesh-run", num_hosts=num_hosts)
    reshards: list[dict] = []
    prev_s = prev_nreal = None
    while True:
        devs = survivor_devices(all_devices, num_hosts,
                                membership.dead_hosts())
        if not devs:
            raise MeshDegraded("host-lost", detail="no survivors")
        if root is not None:
            from mpisppy_tpu_torch import telemetry as tel
            seg = root.child()
            bus.set_trace(seg)
            bus.emit(tel.SPAN_START, run=run_id, cyl="mesh",
                     name="mesh-segment", devices=len(devs),
                     epoch=membership.epoch, resumed=bool(reshards))
        mesh = mesh_mod.make_mesh(devices=devs)
        ws = build_fn(mesh)
        ws.build()
        rt = MeshRuntime(membership, plan=plan,
                         deadline_s=harvest_deadline_s, bus=bus,
                         run=run_id)
        ws.spcomm.options["mesh_runtime"] = rt
        batch = ws.spcomm.opt.batch
        mesh_of = getattr(batch, "mesh", None)
        s_new = batch.num_scenarios * (
            mesh_of.world if mesh_of is not None else 1)
        n_real = getattr(batch, "num_real", s_new)
        if reshards or (prev_s is not None and prev_s != s_new):
            transform = (lambda arrays: adapt_checkpoint_arrays(
                arrays, prev_nreal, prev_s, s_new))
            ws.spcomm.load_checkpoint(checkpoint_path,
                                      transform=transform)
        prev_s, prev_nreal = s_new, n_real
        try:
            ws.spin()
            return ws, {"reshards": reshards, "resumed": bool(reshards),
                        "final_devices": len(devs),
                        "epoch": membership.epoch}
        except MeshDegraded as e:
            # spin() already wrote the emergency checkpoint (the
            # PreemptionError contract); account the transition and go
            # around — same topology for a straggler trip, fewer
            # devices after a host loss
            new_devs = survivor_devices(all_devices, num_hosts,
                                        membership.dead_hosts())
            if len(reshards) >= max_reshards:
                _metrics.REGISTRY.inc("mesh_reshards_lost_total")
                raise
            reshards.append({
                "hub_iter": e.hub_iter, "reason": e.reason,
                "old_devices": len(devs), "new_devices": len(new_devs),
                "epoch": membership.epoch})
            _metrics.REGISTRY.inc("mesh_reshards_total")
            if bus is not None:
                from mpisppy_tpu_torch import telemetry as tel
                # dedicated reshard child span (like a fleet
                # migration): its start to the next segment's start is
                # the reshard gap on the critical path
                rs = root.child() if root is not None else None
                if rs is not None:
                    bus.emit(tel.SPAN_START, run=run_id, cyl="mesh",
                             trace=rs, name="reshard",
                             epoch=membership.epoch)
                bus.emit(tel.MESH_RESHARD, run=run_id, cyl="mesh",
                         trace=rs,
                         old_devices=len(devs),
                         new_devices=len(new_devs),
                         epoch=membership.epoch, hub_iter=e.hub_iter,
                         scenarios=n_real,
                         pad=(-n_real) % max(1, len(new_devs)))
        except Exception:
            if reshards:
                _metrics.REGISTRY.inc("mesh_reshards_lost_total")
            raise
