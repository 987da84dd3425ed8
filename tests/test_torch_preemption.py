# Port parity: preemption and the checkpoint fault domain — the mirror of
# tests/test_chaos.py's checkpoint tests and tests/test_async_wheel.py's
# resume tests, on farmer S=3 (the JAX tests' wheels and options; the
# chaos round trip is tests/test_torch_chaos_round_trip.py, the resumes
# tests/test_torch_resume.py):
#   * a torn or corrupt newest snapshot falls back to the rotated one, a
#     tampered array fails the CRC, a skipped background save does not
#     consume its cadence slot, the signal handlers are installed and
#     restored, the watchdog's abort saves before exiting 75, and a
#     preemption leaves a flight-recorder black box the JAX analyzer
#     reads;
#   * a SIGTERM raised inside an extension hook saves the last completed
#     state (never a half-built one), and a background save begun at
#     iteration k holds the state of iteration k although the hub runs
#     on;
#   * write_first_stage_solution writes .npy with np.save and .csv text,
#     and write_tree_solution writes the JAX package's files on the
#     multistage ccopf (3,3) tree.
# No test depends on when a signal lands: every signal is sent in-process
# from a hook at a fixed iteration.
import copy
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from mpisppy_tpu.telemetry import analyze as an
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.algos import async_wheel as aw
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders import spoke as spoke_mod
from mpisppy_tpu_torch.cylinders.hub import AsyncPHHub, PHHub
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.ops import pdhg
from mpisppy_tpu_torch.resilience.faults import (
    CheckpointFault, FaultPlan, PreemptionError, SimulatedPreemption,
)
from mpisppy_tpu_torch.resilience.watchdog import HubWatchdog
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import metrics as metrics_mod
from mpisppy_tpu_torch.utils import wxbarutils as wx

torch.set_num_threads(1)

FARMER_EF_OBJ = -108390.0


@pytest.fixture(scope="module")
def batch():
    names = farmer.scenario_names_creator(3)
    return batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3) for nm in names],
        device="cpu")


def ph_options(max_iterations=150, lane_guard=True):
    return ph_mod.PHOptions(
        default_rho=1.0, max_iterations=max_iterations, conv_thresh=0.0,
        subproblem_windows=10,
        pdhg=pdhg.PDHGOptions(tol=1e-7, lane_guard=lane_guard))


def hub_dict(batch, hub_extra=None, max_iterations=150, rel_gap=5e-3,
             extensions=None):
    """tests/test_chaos.py's hub_dict: a PH hub, rel_gap 5e-3."""
    return {"hub_class": PHHub,
            "hub_kwargs": {"options": {"rel_gap": rel_gap,
                                       **(hub_extra or {})}},
            "opt_class": ph_mod.PH,
            "opt_kwargs": {"options": ph_options(max_iterations),
                           "batch": batch, "extensions": extensions}}


def both_spokes():
    return [{"spoke_class": spoke_mod.LagrangianOuterBound,
             "opt_kwargs": {"options": {}}},
            {"spoke_class": spoke_mod.XhatXbarInnerBound,
             "opt_kwargs": {"options": {}}}]


def wheel_dict(batch, staleness=None, rel_gap=1e-2, max_iterations=120,
               hub_extra=None, extensions=None):
    """tests/test_async_wheel.py's farmer wheel: the four fused spokes,
    the sync pair or the async pair at `staleness`."""
    opts = ph_mod.PHOptions(default_rho=1.0, max_iterations=max_iterations,
                            conv_thresh=0.0, subproblem_windows=10,
                            pdhg=pdhg.PDHGOptions(tol=1e-7))
    wopts = fw.FusedWheelOptions(
        slam_windows=2, shuffle_windows=4, slam_sense_max=False,
        lag_pdhg=pdhg.PDHGOptions(tol=1e-7),
        xhat_pdhg=pdhg.PDHGOptions(tol=1e-7, omega0=0.1, restart_period=80))
    d = {"hub_class": PHHub,
         "hub_kwargs": {"options": {"rel_gap": rel_gap,
                                    **(hub_extra or {})}},
         "opt_class": fw.FusedPH,
         "opt_kwargs": {"options": opts, "batch": batch,
                        "wheel_options": wopts, "extensions": extensions}}
    if staleness is not None:
        d["hub_class"], d["opt_class"] = AsyncPHHub, aw.AsyncFusedPH
        d["opt_kwargs"]["async_options"] = aw.AsyncWheelOptions(staleness)
    return d


def fused_spokes():
    return [{"spoke_class": c, "opt_kwargs": {"options": {}}} for c in (
        spoke_mod.FusedLagrangianOuterBound,
        spoke_mod.FusedXhatXbarInnerBound,
        spoke_mod.FusedXhatShuffleInnerBound, spoke_mod.FusedSlamHeuristic)]


def state_arrays(st):
    return [wx.leaf_array(x) for x in wx.state_leaves(st)]


def snapshot_leaves(path):
    with np.load(path) as d:
        n = sum(1 for k in d.files if k.startswith("leaf"))
        return [np.asarray(d[f"leaf{i}"]) for i in range(n)]


def assert_same_leaves(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# rotation, checksum, fallback, cadence (tests/test_chaos.py:400-508)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spun(batch, tmp_path_factory):
    """tests/test_chaos.py's 4-iteration wheel (checkpoint_keep 3), spun
    once for the rotation tests; each test points it at its own file and
    fault plan."""
    ckpt = str(tmp_path_factory.mktemp("spun") / "w.npz")
    return WheelSpinner(hub_dict(batch, {
        "checkpoint_path": ckpt, "checkpoint_every_s": 1e9,
        "checkpoint_keep": 3}, max_iterations=4), both_spokes()).spin()


def _spun_wheel_with_ckpt_opts(spun, tmp_path, plan=None):
    ckpt = str(tmp_path / "w.npz")
    spun.spcomm.options["fault_plan"] = plan
    return spun, ckpt


@pytest.mark.parametrize("kind", ["torn", "corrupt"])
def test_damaged_checkpoint_falls_back_to_rotated(batch, spun, tmp_path,
                                                 kind):
    """The second write (the newest file) is torn mid-stream or
    bit-flipped by the plan; the restore skips it for the last good
    rotated snapshot."""
    plan = FaultPlan(seed=3 if kind == "torn" else 4,
                     checkpoints=(CheckpointFault(kind, at_write=1),))
    ws, ckpt = _spun_wheel_with_ckpt_opts(spun, tmp_path, plan)
    hub = ws.spcomm
    it0 = hub._iter
    assert hub.save_checkpoint(ckpt)          # write 0: clean
    it_saved = hub._iter
    hub._iter += 1                            # pretend progress
    assert hub.save_checkpoint(ckpt)          # write 1: damaged
    assert ("checkpoint", f"{kind} write1 {ckpt}") in plan.fired
    assert os.path.exists(ckpt + ".1")
    ws2 = WheelSpinner(hub_dict(batch, {"checkpoint_path": ckpt},
                                max_iterations=4), both_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    assert ws2.spcomm._iter == it_saved
    assert np.isfinite(ws2.spcomm.BestOuterBound)
    hub._iter = it0


def test_checksum_rejects_silently_tampered_arrays(spun, tmp_path):
    ws, ckpt = _spun_wheel_with_ckpt_opts(spun, tmp_path)
    hub = ws.spcomm
    assert hub.save_checkpoint(ckpt)
    with np.load(ckpt) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    # a valid zip with a stale crc: only the checksum can notice
    arrays["bounds"] = arrays["bounds"] + 1.0
    np.savez(ckpt, **arrays)
    with pytest.raises(ValueError, match="checksum mismatch"):
        hub._read_checkpoint_arrays(ckpt)
    for cand in hub._checkpoint_candidates(ckpt)[1:]:
        os.remove(cand)
    with pytest.raises(FileNotFoundError, match="no valid checkpoint"):
        hub.load_checkpoint(ckpt)


class _DummyOpt:
    state = torch.zeros(2)
    wstate = None
    trivial_bound = None
    trivial_bound_certified = False
    _iter = 0


def test_maybe_checkpoint_cadence_not_consumed_by_skipped_save(tmp_path):
    """A save skipped because the previous write thread is still alive
    does NOT advance _last_ckpt_t (a slow write must not halve the
    checkpoint frequency)."""
    ckpt = str(tmp_path / "c.npz")
    hub = PHHub(opt=_DummyOpt(), options={"checkpoint_path": ckpt,
                                          "checkpoint_every_s": 0.0})
    hub._last_ckpt_t = 1.0  # long overdue
    gate = threading.Event()
    blocker = threading.Thread(target=gate.wait)
    blocker.start()
    hub._ckpt_thread = blocker
    try:
        hub._maybe_checkpoint()
        assert hub._last_ckpt_t == 1.0  # slot NOT consumed: will retry
        assert not os.path.exists(ckpt)
    finally:
        gate.set()
        blocker.join()
    hub._maybe_checkpoint()
    assert hub._last_ckpt_t != 1.0      # the real save consumed it
    hub._ckpt_thread.join()
    assert os.path.exists(ckpt)


def test_preemption_handlers_installed_and_restored(batch, tmp_path):
    prev_int = signal.getsignal(signal.SIGINT)
    prev_term = signal.getsignal(signal.SIGTERM)
    seen = {}

    class Probe(Extension):
        def enditer(self):
            seen["term"] = signal.getsignal(signal.SIGTERM)

    WheelSpinner(wheel_dict(batch, max_iterations=2,
                            hub_extra={"checkpoint_path": str(tmp_path / "w"),
                                       "checkpoint_every_s": 1e9},
                            extensions=Probe), fused_spokes()).spin()
    assert seen["term"] is not prev_term     # armed during the spin
    assert signal.getsignal(signal.SIGINT) is prev_int
    assert signal.getsignal(signal.SIGTERM) is prev_term
    # the latch: the first signal raises, a second (during the save
    # the first one started) is ignored
    prev = WheelSpinner._install_preemption_handlers()
    try:
        handler = signal.getsignal(signal.SIGTERM)
        with pytest.raises(PreemptionError, match="received signal 15"):
            handler(signal.SIGTERM, None)
        assert handler(signal.SIGINT, None) is None
    finally:
        WheelSpinner._restore_preemption_handlers(prev)
    assert signal.getsignal(signal.SIGTERM) is prev_term
    # off the main thread no handler is installed (signal.signal would
    # raise there)
    box = []
    t = threading.Thread(target=lambda: box.append(
        WheelSpinner._install_preemption_handlers()))
    t.start()
    t.join()
    assert box == [None]


# ---------------------------------------------------------------------------
# the watchdog's save before exit 75 (tests/test_chaos.py:561-600)
# ---------------------------------------------------------------------------
class _WatchdogHub:
    """Duck-typed hub for the watchdog."""

    def __init__(self, bus, ckpt_path):
        self.telemetry = bus
        self.run_id = "wdtest"
        self.options = {"checkpoint_path": ckpt_path}
        self.saved = []

    def emergency_checkpoint(self, path):
        self.saved.append(path)
        return True


def test_watchdog_trips_abort_with_checkpoint_and_exit75(tmp_path):
    seen = []

    class Probe:
        def handle(self, ev):
            seen.append(ev)

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    rec = tel.FlightRecorder(capacity=16, dump_dir=str(tmp_path))
    bus.subscribe(rec)
    hub = _WatchdogHub(bus, ckpt_path=str(tmp_path / "w.npz"))
    codes = []
    wd = HubWatchdog(hub, budget_s=0.15, action="abort",
                     interval_s=0.02, abort_fn=codes.append).start()
    wd.beat(1, -100.0, -90.0)
    deadline = time.perf_counter() + 5.0
    while not codes and time.perf_counter() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert codes == [75], "watchdog never aborted (or wrong exit code)"
    assert hub.saved == [str(tmp_path / "w.npz")]  # last-gasp save ran
    events = [e for e in seen if e.kind == "watchdog"]
    assert events and events[0].data["action"] == "abort"
    assert events[0].data["stalled_s"] >= 0.15
    assert rec.dumped_to, "no flight-recorder black box on the trip"
    assert metrics_mod.REGISTRY.get("watchdog_trips_total") >= 1


# ---------------------------------------------------------------------------
# the flight recorder on preemption (tests/test_chaos.py:726)
# ---------------------------------------------------------------------------
def test_flight_recorder_black_box_on_preemption(batch, tmp_path):
    bus = tel.EventBus()
    rec = tel.FlightRecorder(capacity=64, dump_dir=str(tmp_path))
    bus.subscribe(rec)
    ckpt = str(tmp_path / "wheel.npz")
    plan = FaultPlan(seed=3, preempt_at_iter=4)
    ws = WheelSpinner(
        hub_dict(batch, {"telemetry_bus": bus, "fault_plan": plan,
                         "checkpoint_path": ckpt,
                         "checkpoint_every_s": 1e9}),
        both_spokes())
    with pytest.raises(SimulatedPreemption):
        ws.spin()
    path = tmp_path / f"flight-{ws.spcomm.run_id}.jsonl"
    assert path.exists(), "crash left no black box"
    assert rec.dumped_to == str(path)
    rows = [json.loads(line) for line in open(path)]
    assert rows[0]["kind"] == "flight-recorder"
    assert "SimulatedPreemption" in rows[0]["reason"]
    seqs = [r["seq"] for r in rows[1:]]
    assert seqs == sorted(seqs)
    kinds = {r["kind"] for r in rows[1:]}
    assert {"hub-iteration", "fault-injected", "run-end",
            "checkpoint-write"} <= kinds
    end = [r for r in rows if r["kind"] == "run-end"][0]
    assert end["data"]["reason"] == "preemption"
    assert "SimulatedPreemption" in end["data"]["error"]
    # the save lands before the run-end record
    order = [r["kind"] for r in rows[1:]]
    assert order.index("checkpoint-write") < order.index("run-end")
    fault = [r for r in rows if r["kind"] == "fault-injected"][0]
    assert fault["iter"] == 4 and fault["data"]["seam"] == "preemption"
    rep = an.analyze_path(str(path))
    assert rep["run"]["exit"]["reason"] == "preemption"
    assert rep["resilience"]["faults_injected"]["preemption"] == 1


# ---------------------------------------------------------------------------
# signals and background saves against the state they must hold
# ---------------------------------------------------------------------------
def test_sigterm_inside_a_hook_saves_the_last_completed_state(batch,
                                                               tmp_path):
    """SIGTERM sent from the pre_solve_loop hook of iteration 5 (state of
    iteration 4 complete, iteration 5's step not started): the handler
    raises inside the hook, and the emergency save writes exactly that
    state, which restores and resumes to the certified gap."""
    ckpt = str(tmp_path / "sig.npz")
    held = {}

    class Kill(Extension):
        def pre_solve_loop(self):
            if self.opt._iter == 5:
                held["state"] = copy.deepcopy(
                    state_arrays(self.opt.wstate))
                held["hub_iter"] = self.opt.spcomm._iter
                os.kill(os.getpid(), signal.SIGTERM)
                time.sleep(5.0)   # the handler raises at this call
                held["unreached"] = True

    extra = {"checkpoint_path": ckpt, "checkpoint_every_s": 1e9}
    ws = WheelSpinner(wheel_dict(batch, hub_extra=extra, extensions=Kill),
                      fused_spokes())
    with pytest.raises(PreemptionError, match="received signal"):
        ws.spin()
    assert ws.preempted and "unreached" not in held
    assert_same_leaves(snapshot_leaves(ckpt), held["state"])
    with np.load(ckpt) as d:
        assert bytes(d["which"]).decode() == "wstate"
        assert int(d["hub_iter"]) == held["hub_iter"] == 5
        assert int(d["opt_iter"]) == 5
    ws2 = WheelSpinner(wheel_dict(batch, hub_extra=extra),
                       fused_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    assert_same_leaves(state_arrays(ws2.opt.wstate), held["state"])
    ws2.spin()
    assert ws2.spcomm.compute_gaps()[1] <= 1e-2 + 1e-6


def test_background_save_holds_the_state_it_began_at(batch, tmp_path):
    """A background save begun at iteration 3 runs while the hub goes on
    to iteration 6; the file holds iteration 3's state."""
    ckpt = str(tmp_path / "bg.npz")
    held = {}

    class Save(Extension):
        def enditer_after_sync(self):
            hub = self.opt.spcomm
            if hub._iter == 3:
                held["state"] = copy.deepcopy(
                    state_arrays(self.opt.wstate))
                held["inflight"] = self.opt._scalars_inflight
                gate = threading.Event()
                real = hub._write_checkpoint

                def slow(*a):
                    gate.wait(30)  # the write waits for the hub to move on
                    real(*a)
                hub._write_checkpoint = slow
                assert hub.save_checkpoint(ckpt, background=True)
                hub._write_checkpoint = real
                held["gate"] = gate
            elif hub._iter == 6:
                held["gate"].set()

    ws = WheelSpinner(wheel_dict(batch, rel_gap=0.0, max_iterations=6,
                                 hub_extra={"checkpoint_path": ckpt,
                                            "checkpoint_every_s": 1e9},
                                 extensions=Save), fused_spokes()).spin()
    assert ws.spcomm._iter == 7
    assert not ws.spcomm._ckpt_thread.is_alive()   # finalize joined it
    assert_same_leaves(snapshot_leaves(ckpt), held["state"])
    with np.load(ckpt) as d:
        assert int(d["hub_iter"]) == 3
        # the scalar copy in flight at iteration 3, read by the writer
        np.testing.assert_array_equal(d["extra_fw_inflight"],
                                      held["inflight"].values()[0])


def test_preempt_event_drains_at_the_next_sync(batch, tmp_path):
    """A set options['preempt_event'] (a migration drain) raises
    PreemptionError in the prologue of the next sync: the emergency save
    holds that sync's iteration, and the restored wheel resumes there to
    the certified gap."""
    ckpt = str(tmp_path / "drain.npz")
    drain = threading.Event()

    class Drain(Extension):
        def enditer_after_sync(self):
            if self.opt.spcomm._iter == 4:
                drain.set()

    extra = {"checkpoint_path": ckpt, "checkpoint_every_s": 1e9}
    ws = WheelSpinner(wheel_dict(
        batch, hub_extra={**extra, "preempt_event": drain},
        extensions=Drain), fused_spokes())
    with pytest.raises(PreemptionError,
                       match="migration drain requested at iter 5"):
        ws.spin()
    assert ws.preempted
    with np.load(ckpt) as d:
        assert int(d["hub_iter"]) == 5
    ws2 = WheelSpinner(wheel_dict(batch, hub_extra=extra),
                       fused_spokes()).build()
    ws2.spcomm.load_checkpoint(ckpt)
    assert ws2.spcomm._iter == 5
    ws2.spin()
    assert ws2.spcomm._iter > 5
    assert ws2.spcomm.compute_gaps()[1] <= 1e-2 + 1e-6


def test_checkpoint_every_iters_saves_synchronously_on_its_cadence(
        batch, tmp_path):
    """checkpoint_every_iters=2 saves at hub iterations 2, 4, 6 on the
    hub thread and takes precedence over the wall-clock cadence (here
    due at every sync); the rotation keeps the newest three."""
    ckpt = str(tmp_path / "it.npz")
    written = []

    class Probe:
        def handle(self, ev):
            if ev.kind == tel.CHECKPOINT_WRITE:
                written.append((ev.hub_iter,
                                threading.current_thread()))

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    ws = WheelSpinner(hub_dict(batch, {
        "telemetry_bus": bus, "checkpoint_path": ckpt,
        "checkpoint_every_iters": 2, "checkpoint_every_s": 0.0,
        "checkpoint_keep": 3}, max_iterations=6, rel_gap=0.0),
        both_spokes()).spin()
    assert ws.spcomm._iter == 7
    assert [it for it, _ in written] == [2, 4, 6]
    assert all(t is threading.main_thread() for _, t in written)
    assert getattr(ws.spcomm, "_ckpt_thread", None) is None
    stored = []
    for cand in ws.spcomm._checkpoint_candidates(ckpt):
        with np.load(cand) as d:
            stored.append(int(d["hub_iter"]))
    assert stored == [6, 4, 2]


# ---------------------------------------------------------------------------
# solution files (ROADMAP.md C4)
# ---------------------------------------------------------------------------
def test_first_stage_solution_npy_and_csv_match_jax(batch, tmp_path):
    from mpisppy_tpu.core import batch as jbatch
    from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
    from mpisppy_tpu.algos import ph as jph
    from mpisppy_tpu.models import farmer as jfarmer
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
    jb = jbatch.from_specs([jfarmer.scenario_creator(nm, num_scens=3)
                            for nm in jfarmer.scenario_names_creator(3)])
    xhat = np.asarray([170.0, 80.0, 250.0], np.float32)
    files = {}
    for pkg, spinner, hub_cls, mod, b in (
            ("jax", JWheelSpinner, JPHHub, jph, jb),
            ("torch", WheelSpinner, PHHub, ph_mod, batch)):
        ws = spinner({"hub_class": hub_cls, "hub_kwargs": {"options": {}},
                      "opt_class": mod.PH,
                      "opt_kwargs": {"options": mod.PHOptions(),
                                     "batch": b}}, []).build()
        ws.spcomm._best_inner_xhat = xhat
        for ext in ("npy", "csv"):
            files[pkg, ext] = str(tmp_path / f"{pkg}.{ext}")
            ws.write_first_stage_solution(files[pkg, ext])
    got = np.load(files["torch", "npy"])
    np.testing.assert_array_equal(got, np.load(files["jax", "npy"]))
    assert got.dtype == np.float32 and got.shape == (3,)
    assert open(files["torch", "csv"]).read() == \
        open(files["jax", "csv"]).read() == \
        "x0,170.0\nx1,80.0\nx2,250.0\n"


def test_tree_solution_matches_jax_on_ccopf(tmp_path):
    """One csv per nonant node of the (3,3) tree (4), each with its
    stage's slots, byte for byte as the JAX package writes them."""
    from mpisppy_tpu.core import batch as jbatch
    from mpisppy_tpu.cylinders.hub import PHHub as JPHHub
    from mpisppy_tpu.algos import ph as jph
    from mpisppy_tpu.models import ccopf as jccopf
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheelSpinner
    bfs = (3, 3)
    tree = jccopf.make_tree(bfs)
    jb = jbatch.from_specs(
        [jccopf.scenario_creator(nm, branching_factors=bfs, soc=True)
         for nm in jccopf.scenario_names_creator(9)], tree=tree)
    tb = convert.batch_from_arrays(convert.arrays_of(jb), "cpu")
    rng = np.random.default_rng(1)
    nodes = rng.normal(size=(tree.num_nodes, jb.num_nonants)).astype(
        np.float32)
    out = {}
    for pkg, spinner, hub_cls, mod, b in (
            ("jax", JWheelSpinner, JPHHub, jph, jb),
            ("torch", WheelSpinner, PHHub, ph_mod, tb)):
        ws = spinner({"hub_class": hub_cls, "hub_kwargs": {"options": {}},
                      "opt_class": mod.PH,
                      "opt_kwargs": {"options": mod.PHOptions(),
                                     "batch": b}}, []).build()
        ws.spcomm._best_inner_xhat = nodes
        out[pkg] = tmp_path / pkg
        ws.write_tree_solution(str(out[pkg]))
    names = sorted(p.name for p in out["jax"].iterdir())
    assert len(names) == tree.num_nodes == 4   # the root and 3 children
    assert sorted(p.name for p in out["torch"].iterdir()) == names
    for nm in names:
        assert (out["torch"] / nm).read_text() == \
            (out["jax"] / nm).read_text(), nm
