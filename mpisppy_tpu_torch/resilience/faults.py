###############################################################################
# Deterministic fault injection for the cylinder wheel (port of
# mpisppy_tpu/resilience/faults.py, whole: the serve, replica and mesh
# seams wait for the queue items that port those layers).
#
# The reference wheel survives solver/license hiccups with per-scenario
# solve retries (ref:mpisppy/spopt.py:931-960) and tolerates slow or
# dead cylinders by never reading stale RMA windows.  A one-process
# accelerator wheel fails differently — a NaN spoke bound, a diverged
# PDHG lane, a preemption mid-run (cf. the restarted-PDHG robustness
# discussion in MPAX, arXiv:2412.09734) — and
# a fault model you cannot *inject* is a fault model you cannot test.
#
# A FaultPlan arms named HOST-SIDE seams:
#
#   * spoke harvest   — poison a harvested bound (NaN / wrong-sense /
#                       stale) between `sp.harvest()` and the hub's
#                       bound bookkeeping (hub._harvest_all);
#   * PDHG lanes      — scale or NaN chosen scenario lanes of the hub
#                       solver state at a hub iteration, forcing the
#                       per-lane divergence guard in ops/pdhg.py to fire
#                       at the next restart boundary (hub.sync);
#   * checkpoint      — tear (truncate) or corrupt (bit-flip) a rotated
#                       checkpoint file right after it lands on disk
#                       (hub._write_checkpoint);
#   * preemption      — raise SimulatedPreemption at hub iteration k
#                       (hub._sync_prologue; WheelSpinner.spin saves);
#   * async exchange  — drop or tear an exchange-plane write, or slow
#                       the host-complete half (algos/async_wheel.py,
#                       cylinders/hub.AsyncPHHub);
#   * dispatch        — fault the solve-dispatch layer (its failure
#                       semantics, dispatch/scheduler.py): hang a
#                       megabatch dispatch, raise from it, poison a
#                       specific submitted request (raises every time
#                       its lanes are in the batch — the bisection
#                       quarantine's target), drop a ticket's result
#                       delivery, jitter the "device" with slow sleeps,
#                       or kill the dispatcher daemon thread
#                       (dispatch/scheduler.py seams).
#
# Every seam is a plain Python call on the host driver loop: nothing
# reaches a kernel, so a disarmed (or absent) plan has zero overhead.
# Injection is deterministic: seams fire at configured hub
# iterations / write indices, and any randomness (corruption offsets)
# comes from the plan's own seeded generator.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np


class PreemptionError(RuntimeError):
    """The run must stop NOW and persist state (SIGTERM/SIGINT on a
    preemptible pool, or a simulated preemption from a FaultPlan).
    WheelSpinner.spin catches this, writes a synchronous emergency
    checkpoint, and re-raises so the caller can exit/restart."""


class SimulatedPreemption(PreemptionError):
    """Preemption injected by a FaultPlan (not a real signal)."""


@dataclasses.dataclass(frozen=True)
class SpokeBoundFault:
    """Poison a spoke's harvested bound at the hub harvest seam.

    kind: 'nan'          -> bound becomes NaN
          'wrong_sense'  -> outer bounds jump UP past the incumbent,
                            inner bounds jump DOWN past the outer bound
                            (sense-violating by `magnitude`)
          'stale'        -> re-deliver the first bound ever harvested
                            from this spoke (a slow cylinder's old
                            window content)
    spoke_index: which spoke (position in hub.spokes); None = every one.
    at_iters: hub iterations to fire on; empty = every iteration.
    """

    kind: str
    spoke_index: int | None = None
    at_iters: tuple[int, ...] = ()
    magnitude: float = 1e8

    def __post_init__(self):
        if self.kind not in ("nan", "wrong_sense", "stale"):
            raise ValueError(f"unknown spoke-bound fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class LaneFault:
    """Corrupt chosen scenario lanes of the hub's PDHG solver state at
    hub iteration `at_iter` (host-side, between jitted steps).

    mode: 'scale' multiplies x/y by `scale` (forces the magnitude
    branch of the lane guard); 'nan' sets them to NaN (forces the
    non-finite branch — NaN never self-heals, so recovery proves the
    quarantine reset works)."""

    at_iter: int
    lanes: tuple[int, ...]
    mode: str = "scale"
    scale: float = 1e25

    def __post_init__(self):
        if self.mode not in ("scale", "nan"):
            raise ValueError(f"unknown lane fault mode {self.mode!r}")


class DispatchPoison(RuntimeError):
    """Injected NaN-poisoned-batch analog: the dispatch raises whenever
    the poisoned submit's lanes ride in the megabatch, so retry never
    clears it and only bisection can isolate it (dispatch/scheduler.py
    _solve_recover)."""


@dataclasses.dataclass(frozen=True)
class DispatchFault:
    """One dispatch-layer fault (host-only seams inside
    dispatch/scheduler.py; zero jit-graph impact — the seams run on the
    host dispatch path around `solve_fn`, never inside it).

    kind: 'hang'            -> the dispatch blocks for hang_s seconds
                               (exercises the dispatch timeout + retry)
          'exception'       -> the dispatch raises RuntimeError
          'slow'            -> seeded jitter sleep in [0, jitter_s]
                               (a slow device, not a failure)
          'poison'          -> raise DispatchPoison whenever any submit
                               in `submits` rides in the batch — retry
                               cannot clear it; bisection isolates and
                               quarantines exactly those requests
          'drop_ticket'     -> complete the solve but never deliver the
                               result to the `submits` tickets (a lost
                               result; the ticket deadline converts the
                               would-be hang into a typed SolveFailed)
          'kill_dispatcher' -> raise inside the dispatcher daemon loop
                               (thread death; the supervisor must fail
                               queued tickets fast, once)

    at_dispatches: dispatch-attempt indices (0-based, counting every
    attempt including retries) that hang/exception/slow fire on; empty
    means every attempt.  submits: 0-based submit indices (the order
    requests entered `SolveScheduler.submit`) for poison/drop_ticket.
    """

    kind: str
    at_dispatches: tuple[int, ...] = ()
    submits: tuple[int, ...] = ()
    hang_s: float = 3600.0
    jitter_s: float = 0.05

    def __post_init__(self):
        if self.kind not in ("hang", "exception", "slow", "poison",
                             "drop_ticket", "kill_dispatcher"):
            raise ValueError(f"unknown dispatch fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class AsyncExchangeFault:
    """One async-exchange fault (docs/async_wheel.md): the
    host-side seams of the double-buffered exchange plane in
    algos/async_wheel.AsyncFusedPH + cylinders/hub.AsyncPHHub.

    kind: 'drop_plane_write' -> the due plane write is dropped (the
                                slot keeps its previous generation, so
                                observed staleness exceeds the bound —
                                validity must not depend on it)
          'torn_swap'        -> the slot gets a MIXED plane: duals and
                                primal iterates from the OLD
                                generation, averages from the new (a
                                torn pointer swap)
          'slow_harvest'     -> the host-complete half sleeps delay_s
                                seconds (a slow host; pushed past the
                                watchdog budget this is the wedged
                                exchange the hub watchdog must catch)

    at_iters: hub iterations to fire on; empty = every iteration."""

    kind: str
    at_iters: tuple[int, ...] = ()
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in ("drop_plane_write", "torn_swap",
                             "slow_harvest"):
            raise ValueError(f"unknown async-exchange fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ServeFault:
    """One serve-layer fault (docs/serving.md): the
    host-only seams of the multi-tenant wheel server
    (mpisppy_tpu/serve/) and its load harness.

    kind: 'hang'       -> the session's solve blocks hang_s seconds
                          before starting (a wedged worker; the
                          session deadline must convert it to a typed
                          SolveFailed at the client, never a hang)
          'poison'     -> the session's solve raises (a poisoned
                          problem instance; the client observes a
                          typed failure, siblings proceed)
          'disconnect' -> the server drops the session's client
                          connection mid-run (the session must still
                          reach a terminal state and release its
                          tenant quota)
          'flood'      -> the load generator multiplies this tenant's
                          submit count by flood_factor (admission
                          backpressure must reject typed, and healthy
                          tenants' latency must hold — the isolation
                          acceptance line)

    tenant: which tenant's sessions the fault fires on ("" = every
    tenant).  at_sessions: per-tenant session ordinals (0-based, in
    admission order) for hang/poison/disconnect; empty = every
    session of the tenant."""

    kind: str
    tenant: str = ""
    at_sessions: tuple[int, ...] = ()
    hang_s: float = 3600.0
    flood_factor: int = 10

    def __post_init__(self):
        if self.kind not in ("hang", "poison", "disconnect", "flood"):
            raise ValueError(f"unknown serve fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class ReplicaFault:
    """One fleet-replica fault (docs/serving.md): the
    host-only seams of the fleet router's health plane
    (mpisppy_tpu/fleet/).

    kind: 'kill'           -> the replica dies at its at_beats[0]-th
                              heartbeat: the beat loop stops (the
                              router declares it dead after the miss
                              budget) and no new work is assigned;
                              in-flight sessions drain through the
                              SIGTERM-grace emergency-checkpoint path
                              and migrate to live replicas
          'partition'      -> heartbeats AND router status probes are
                              suppressed while the beat index is
                              inside the at_beats window; a window
                              longer than the miss budget migrates the
                              replica's sessions, and the replica
                              stays FENCED (dead to the router) even
                              after connectivity returns — no split
                              brain, the settle latch still guarantees
                              one terminal outcome if a partitioned
                              worker races a migrated copy
          'slow_heartbeat' -> every beat is delayed delay_s extra
                              (clock skew / an overloaded host; at
                              worst the replica turns SUSPECT, never
                              loses a session)

    replica: which replica id the fault fires on ("" = every
    replica).  at_beats: 0-based beat indices — the kill beat for
    'kill' (empty = beat 0), the suppressed window for 'partition'
    (empty = never)."""

    kind: str
    replica: str = ""
    at_beats: tuple[int, ...] = ()
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in ("kill", "partition", "slow_heartbeat"):
            raise ValueError(f"unknown replica fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class MeshFault:
    """One mesh-layer fault (docs/resilience.md): the
    host-only seams of the elastic mesh fault domain
    (mpisppy_tpu/parallel/elastic.py).

    kind: 'host_lost'    -> the named host drops out of the mesh at
                            hub iteration at_iters[0] (fires once):
                            membership marks it DEAD, the elastic
                            runner emergency-checkpoints the hub
                            plane and re-shards the wheel across the
                            survivors
          'partition'    -> the host's heartbeat beacons are
                            suppressed while the beat index is inside
                            the at_beats window; shorter than the
                            DEAD budget the host turns SUSPECT and
                            rejoins UP at the next epoch WITHOUT a
                            reshard (the partition-heals case)
          'straggler'    -> the hub-harvest device fetch is delayed
                            delay_s seconds at each of at_iters (a
                            slow collective; pushed past the harvest
                            deadline this trips a typed MeshDegraded,
                            never a hang)
          'torn_harvest' -> the harvested scalar vector is corrupted
                            to NaN at each of at_iters (fires once
                            per iteration): the caller must detect
                            the tear and synchronously re-fetch — the
                            device value is intact, only the transfer
                            tore

    host: which host index the fault names (host_lost/partition);
    at_iters: hub iterations (host_lost fires once at the first);
    at_beats: suppressed heartbeat window for 'partition'."""

    kind: str
    host: int = 1
    at_iters: tuple[int, ...] = ()
    at_beats: tuple[int, ...] = ()
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in ("host_lost", "partition", "straggler",
                             "torn_harvest"):
            raise ValueError(f"unknown mesh fault {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class CheckpointFault:
    """Damage the `at_write`-th completed checkpoint file (0-based).

    kind: 'torn' truncates the file to half (a kill mid-write on a
    non-atomic filesystem); 'corrupt' flips bytes in the middle (bit
    rot — survives np.load, caught by the checksum)."""

    kind: str
    at_write: int = 0

    def __post_init__(self):
        if self.kind not in ("torn", "corrupt"):
            raise ValueError(f"unknown checkpoint fault {self.kind!r}")


class FaultPlan:
    """A seeded, deterministic schedule of faults for one wheel run.

    Build one, put it in the hub options as ``options['fault_plan']``,
    and spin.  The hub and WheelSpinner call the seam methods below at
    the named points; a plan with no faults armed (or no plan at all)
    never changes behavior.  ``plan.fired`` records every injection as
    ``(seam, detail)`` tuples so tests can assert the schedule ran.
    """

    def __init__(self, seed: int = 0, spoke_bounds=(), lanes=(),
                 checkpoints=(), preempt_at_iter: int | None = None,
                 dispatches=(), exchanges=(), serves=(), replicas=(),
                 meshes=()):
        self.rng = np.random.default_rng(seed)
        self.spoke_bounds = tuple(spoke_bounds)
        self.lanes = tuple(lanes)
        self.checkpoints = tuple(checkpoints)
        self.preempt_at_iter = preempt_at_iter
        self.dispatches = tuple(dispatches)
        self.exchanges = tuple(exchanges)
        self.serves = tuple(serves)
        self.replicas = tuple(replicas)
        self.meshes = tuple(meshes)
        self.fired: list[tuple[str, str]] = []
        self._writes = 0
        self._first_seen: dict[int, float] = {}
        self._preempted = False
        self._dropped: set[int] = set()
        self._killed_dispatcher = False
        self._served_disconnects: set[tuple[str, int]] = set()
        self._killed_replicas: set[str] = set()
        self._partitions_fired: set[tuple[str, int]] = set()
        self._slow_replicas: set[str] = set()
        self._lost_hosts: set[int] = set()
        self._mesh_partitions_fired: set[tuple[int, int]] = set()
        self._torn_harvests: set[int] = set()
        self._stragglers_fired: set[tuple[int, int]] = set()
        # set by the hub when the plan is armed in its options: every
        # injection also lands in the telemetry stream as a
        # fault-injected event (docs/telemetry.md), so a chaos run's
        # trace shows WHAT was injected next to what the guards did.
        # telemetry_iter is the hub-iteration stamp (-1 pre-wheel),
        # refreshed by the hub each sync AND by every seam that
        # receives the iteration directly, so the analyzer joins
        # injections to the timeline exactly.
        self.telemetry = None
        self.telemetry_run = ""
        self.telemetry_iter = -1

    def _fire(self, seam: str, detail: str) -> None:
        self.fired.append((seam, detail))
        if self.telemetry is not None:
            from mpisppy_tpu_torch.telemetry import FAULT_INJECTED
            self.telemetry.emit(FAULT_INJECTED, run=self.telemetry_run,
                                cyl="fault-plan", seam=seam,
                                detail=detail,
                                hub_iter=self.telemetry_iter)

    @property
    def armed(self) -> bool:
        return bool(self.spoke_bounds or self.lanes or self.checkpoints
                    or self.dispatches or self.exchanges or self.serves
                    or self.replicas or self.meshes
                    or self.preempt_at_iter is not None)

    # -- seams: serve layer (mpisppy_tpu/serve; docs/serving.md) ----------
    def _serve_hits(self, kind: str, tenant: str, ordinal: int):
        for f in self.serves:
            if f.kind != kind:
                continue
            if f.tenant and f.tenant != tenant:
                continue
            if f.at_sessions and ordinal not in f.at_sessions:
                continue
            return f
        return None

    def serve_before_solve(self, tenant: str, ordinal: int) -> None:
        """Called by the serve engine right before a session's solve
        starts; may sleep (hang) or raise (poison) — both must surface
        at the client as a typed terminal outcome, never a hang."""
        import time as _time
        f = self._serve_hits("hang", tenant, ordinal)
        if f is not None:
            self._fire("serve", f"hang {tenant}#{ordinal}")
            _time.sleep(float(f.hang_s))
        f = self._serve_hits("poison", tenant, ordinal)
        if f is not None:
            self._fire("serve", f"poison {tenant}#{ordinal}")
            raise RuntimeError(
                f"injected serve poison ({tenant} session {ordinal})")

    def serve_drop_connection(self, tenant: str, ordinal: int) -> bool:
        """True when the server must drop this session's client
        connection now (fires once per (tenant, ordinal))."""
        f = self._serve_hits("disconnect", tenant, ordinal)
        if f is None or (tenant, ordinal) in self._served_disconnects:
            return False
        self._served_disconnects.add((tenant, ordinal))
        self._fire("serve", f"disconnect {tenant}#{ordinal}")
        return True

    def serve_flood_factor(self, tenant: str) -> int:
        """Submit-count multiplier the load generator applies to this
        tenant (1 = no flood armed)."""
        for f in self.serves:
            if f.kind == "flood" and (not f.tenant or f.tenant == tenant):
                self._fire("serve", f"flood {tenant} x{f.flood_factor}")
                return max(1, int(f.flood_factor))
        return 1

    # -- seams: fleet replicas (mpisppy_tpu/fleet; docs/serving.md) -------
    def _replica_hits(self, kind: str, rid: str):
        for f in self.replicas:
            if f.kind == kind and (not f.replica or f.replica == rid):
                return f
        return None

    def replica_kill(self, rid: str, beat: int) -> bool:
        """True when this replica must die NOW — called from the
        replica's heartbeat loop; fires once per replica."""
        f = self._replica_hits("kill", rid)
        if f is None or rid in self._killed_replicas:
            return False
        if beat < (f.at_beats[0] if f.at_beats else 0):
            return False
        self._killed_replicas.add(rid)
        self._fire("replica", f"kill {rid}@beat{beat}")
        return True

    def replica_partitioned(self, rid: str, beat: int) -> bool:
        """True while the replica's heartbeats and the router's status
        probes must be dropped (the partition window)."""
        f = self._replica_hits("partition", rid)
        if f is None or beat not in f.at_beats:
            return False
        if (rid, beat) not in self._partitions_fired:
            self._partitions_fired.add((rid, beat))
            self._fire("replica", f"partition {rid}@beat{beat}")
        return True

    def replica_beat_delay(self, rid: str) -> float:
        """Extra per-beat delay (slow_heartbeat); 0.0 unarmed.  Fires
        into the record once per replica, applies every beat."""
        f = self._replica_hits("slow_heartbeat", rid)
        if f is None:
            return 0.0
        if rid not in self._slow_replicas:
            self._slow_replicas.add(rid)
            self._fire("replica",
                       f"slow-heartbeat {rid} +{f.delay_s}s")
        return float(f.delay_s)

    # -- seams: elastic mesh (parallel/elastic.py; docs/resilience.md) ----
    def _mesh_hits(self, kind: str):
        return [f for f in self.meshes if f.kind == kind]

    def mesh_lost_host(self, hub_iter: int) -> int | None:
        """Host index that drops out of the mesh NOW, or None.  Fires
        once per host, at the first armed hub iteration reached."""
        self.telemetry_iter = hub_iter
        for f in self._mesh_hits("host_lost"):
            if f.host in self._lost_hosts:
                continue
            first = f.at_iters[0] if f.at_iters else 0
            if hub_iter < first:
                continue
            self._lost_hosts.add(f.host)
            self._fire("mesh", f"host_lost host{f.host} iter{hub_iter}")
            return f.host
        return None

    def mesh_partitioned(self, host: int, beat: int) -> bool:
        """True while the host's heartbeat beacons must be suppressed
        (the DCN partition window)."""
        for f in self._mesh_hits("partition"):
            if f.host != host or beat not in f.at_beats:
                continue
            if (host, beat) not in self._mesh_partitions_fired:
                self._mesh_partitions_fired.add((host, beat))
                self._fire("mesh", f"partition host{host}@beat{beat}")
            return True
        return False

    def mesh_harvest_delay(self, hub_iter: int) -> float:
        """Extra seconds the hub-harvest fetch must sleep this
        iteration (the straggler collective); 0.0 unarmed."""
        self.telemetry_iter = hub_iter
        delay = 0.0
        for i, f in enumerate(self._mesh_hits("straggler")):
            if f.at_iters and hub_iter not in f.at_iters:
                continue
            if (i, hub_iter) in self._stragglers_fired:
                # fires once per (fault, iteration): a resumed run that
                # re-executes the trip iteration must not re-straggle —
                # the injected collective was transiently slow, not
                # permanently wedged (a re-trip would livelock the
                # elastic runner into its max_reshards budget)
                continue
            self._stragglers_fired.add((i, hub_iter))
            self._fire("mesh", f"straggler +{f.delay_s}s iter{hub_iter}")
            delay += float(f.delay_s)
        return delay

    def mesh_torn_harvest(self, hub_iter: int) -> bool:
        """True when the fetched scalar vector must be torn (NaN) this
        iteration; fires once per iteration."""
        self.telemetry_iter = hub_iter
        for f in self._mesh_hits("torn_harvest"):
            if f.at_iters and hub_iter not in f.at_iters:
                continue
            if hub_iter in self._torn_harvests:
                return False
            self._torn_harvests.add(hub_iter)
            self._fire("mesh", f"torn_harvest iter{hub_iter}")
            return True
        return False

    # -- seams: async exchange (async_wheel.AsyncFusedPH / AsyncPHHub) ----
    def filter_plane_write(self, hub_iter: int, new_plane, old_plane):
        """Return the plane the slot should actually receive: the old
        one (dropped write), a torn old/new mix, or the new one
        untouched.  Host-side reference surgery only — no step writes a
        plane's tensors in place, so a torn swap is a REF mix, never a
        torn tensor."""
        for f in self.exchanges:
            if f.at_iters and hub_iter not in f.at_iters:
                continue
            if f.kind == "drop_plane_write":
                self._fire("exchange",
                           f"drop_plane_write iter{hub_iter}")
                return old_plane
            if f.kind == "torn_swap":
                self._fire("exchange", f"torn_swap iter{hub_iter}")
                return dataclasses.replace(
                    new_plane, W=old_plane.W, x=old_plane.x)
        return new_plane

    def before_harvest(self, hub_iter: int) -> None:
        """Called at the top of the host-complete half; may sleep."""
        import time as _time
        for f in self.exchanges:
            if f.kind != "slow_harvest":
                continue
            if f.at_iters and hub_iter not in f.at_iters:
                continue
            self._fire("exchange",
                       f"slow_harvest {f.delay_s}s iter{hub_iter}")
            _time.sleep(float(f.delay_s))

    # -- seam: spoke harvest (hub._harvest_all) ---------------------------
    def filter_bound(self, spoke_index: int, sense: str, bound: float,
                     hub_iter: int) -> float:
        """Return the (possibly poisoned) bound the hub should see."""
        self.telemetry_iter = hub_iter
        if spoke_index not in self._first_seen and np.isfinite(bound):
            self._first_seen[spoke_index] = bound
        for f in self.spoke_bounds:
            if f.spoke_index is not None and f.spoke_index != spoke_index:
                continue
            if f.at_iters and hub_iter not in f.at_iters:
                continue
            if f.kind == "nan":
                poisoned = float("nan")
            elif f.kind == "wrong_sense":
                poisoned = bound + f.magnitude if sense == "outer" \
                    else bound - f.magnitude
            else:  # stale
                poisoned = self._first_seen.get(spoke_index, bound)
            self._fire("spoke_bound",
                       f"{f.kind} spoke{spoke_index} iter{hub_iter}")
            return poisoned
        return bound

    # -- seam: PDHG lanes (hub.sync, host-side) ---------------------------
    def corrupt_lanes(self, hub_iter: int, opt) -> bool:
        """Scale/NaN the configured lanes of opt.state.solver.  Returns
        True when something was corrupted."""
        self.telemetry_iter = hub_iter
        todo = [f for f in self.lanes if f.at_iter == hub_iter]
        if not todo or getattr(opt, "state", None) is None:
            return False
        import torch
        st = opt.state
        solver = st.solver
        # out of place (clones): an exchange plane or a spoke may still
        # hold the uncorrupted iterates
        x, y = solver.x.clone(), solver.y.clone()
        for f in todo:
            lanes = torch.as_tensor(np.asarray(f.lanes, np.int64),
                                    device=x.device)
            if f.mode == "scale":
                x[lanes] = x[lanes] * f.scale
                y[lanes] = y[lanes] * f.scale
            else:
                x[lanes] = float("nan")
                y[lanes] = float("nan")
            self._fire("lanes", f"{f.mode} lanes{f.lanes} iter{hub_iter}")
        opt.state = dataclasses.replace(
            st, solver=dataclasses.replace(solver, x=x, y=y))
        # FusedPH carries the authoritative state in wstate; keep the
        # two views consistent so the corruption is not silently dropped
        wstate = getattr(opt, "wstate", None)
        if wstate is not None and wstate.ph is st:
            opt.wstate = dataclasses.replace(wstate, ph=opt.state)
        return True

    # -- seam: checkpoint write (hub._write_checkpoint) -------------------
    def on_checkpoint_written(self, path: str) -> None:
        """Called after a checkpoint file fully lands (post-rename)."""
        idx = self._writes
        self._writes += 1
        for f in self.checkpoints:
            if f.at_write != idx:
                continue
            import os
            size = os.path.getsize(path)
            if f.kind == "torn":
                with open(path, "r+b") as fh:
                    fh.truncate(max(1, size // 2))
            else:  # corrupt: flip bytes in the middle of the file
                off = size // 3 + int(self.rng.integers(0, max(1, size // 3)))
                with open(path, "r+b") as fh:
                    fh.seek(off)
                    chunk = fh.read(8)
                    fh.seek(off)
                    fh.write(bytes(b ^ 0xFF for b in chunk))
            self._fire("checkpoint", f"{f.kind} write{idx} {path}")

    # -- seams: dispatch layer (dispatch/scheduler.py) --------------------
    # All three run on the host dispatch path — before_dispatch inside
    # the (possibly worker-threaded) solve attempt, drop_ticket at
    # result delivery, maybe_kill_dispatcher at the top of the daemon
    # loop.  The bus is thread-safe, so _fire from these threads is
    # safe; the seeded rng draws keep 'slow' jitter deterministic in
    # submission order under the scheduler's lock-serialized delivery.
    def before_dispatch(self, index: int, submit_ids) -> None:
        """Called with the dispatch-attempt index and the submit ids of
        every request riding this megabatch; may sleep or raise."""
        import time as _time
        for f in self.dispatches:
            if f.kind == "poison":
                hit = sorted(set(submit_ids) & set(f.submits))
                if hit:
                    self._fire("dispatch",
                               f"poison submits{hit} attempt{index}")
                    raise DispatchPoison(
                        f"injected poison in submits {hit}")
            elif f.kind in ("hang", "exception", "slow"):
                if f.at_dispatches and index not in f.at_dispatches:
                    continue
                if f.kind == "hang":
                    self._fire("dispatch", f"hang attempt{index}")
                    _time.sleep(f.hang_s)
                elif f.kind == "exception":
                    self._fire("dispatch", f"exception attempt{index}")
                    raise RuntimeError(
                        f"injected dispatch exception (attempt {index})")
                else:
                    self._fire("dispatch", f"slow attempt{index}")
                    _time.sleep(float(self.rng.uniform(0.0, f.jitter_s)))

    def drop_ticket(self, submit_id: int) -> bool:
        """True when this submit's completed result must be withheld
        from its ticket (a lost delivery; fires once per submit)."""
        for f in self.dispatches:
            if f.kind == "drop_ticket" and submit_id in f.submits \
                    and submit_id not in self._dropped:
                self._dropped.add(submit_id)
                self._fire("dispatch", f"drop_ticket submit{submit_id}")
                return True
        return False

    def maybe_kill_dispatcher(self) -> None:
        """Raise inside the dispatcher daemon loop, once."""
        if self._killed_dispatcher:
            return
        for f in self.dispatches:
            if f.kind == "kill_dispatcher":
                self._killed_dispatcher = True
                self._fire("dispatch", "kill_dispatcher")
                raise RuntimeError("injected dispatcher-thread death")

    # -- seam: preemption (hub.sync) --------------------------------------
    def maybe_preempt(self, hub_iter: int) -> None:
        self.telemetry_iter = hub_iter
        if (self.preempt_at_iter is not None and not self._preempted
                and hub_iter >= self.preempt_at_iter):
            self._preempted = True
            self._fire("preemption", f"iter{hub_iter}")
            raise SimulatedPreemption(
                f"simulated preemption at hub iteration {hub_iter}")
