# Port parity: MPC streams on the wheel server (mpisppy_tpu_torch/mpc/
# stream.py, mpc/horizon.py::horizon_for, the streaming half of serve/)
# against the JAX package on the CPU:
#   * horizon_for gives the JAX HorizonSpec argv (the port's ccopf recipe
#     adds --convthresh 0, ROADMAP C1);
#   * a 3-step uc stream (2 units, 4 hours, 3 scenarios, 2 hub iterations
#     a window: window 1 keeps its warm start, window 2 falls back cold
#     and ends degraded) through the port's engine and the JAX engine:
#     the same warm/fallback/degraded flags, the bounds of each warm
#     window within UC_REL (tests/test_torch_mpc.py's
#     test_uc_mpc_step_cli_matches_jax) and of the cold window 0 within
#     UC_COLD_REL;
#   * a stream preempted entering step 1 resumes from its spool
#     checkpoint bit-identically, with one terminal outcome and one
#     causal trace;
#   * a stream checkpoint written by either package resumes in the other:
#     the resumed window starts from the file's step with the file's
#     plane, and its bounds are the writer's within UC_REL;
#   * the step-miss reaper, a healthy stream outliving the session's wall
#     deadline, and the per-step WFQ charge.
import os
import shutil
import time

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.mpc import horizon as jhz
from mpisppy_tpu.serve import engine as jeng
from mpisppy_tpu.serve import protocol as jproto
from mpisppy_tpu.serve import session as jsess
from mpisppy_tpu_torch.mpc import RollingDriver, horizon_for
from mpisppy_tpu_torch.serve import (
    FairQueue, ServeOptions, SubmitRequest, WheelServer,
)
from mpisppy_tpu_torch.serve import loadgen
from mpisppy_tpu_torch.serve.engine import SyntheticEngine, WheelEngine
from mpisppy_tpu_torch.serve.session import Session

torch.set_num_threads(1)

# test_uc_mpc_step_cli_matches_jax's tolerance for a window's bounds
UC_REL = 2e-3
# the cold window 0 parts from the JAX package's by 2.7e-3 on the CPU
# (400 cold iter0 windows at the f32 floor, ROADMAP C1); 5e-3 is what
# chip_smoke.py's [mpc_uc_cli] holds the same uc window to
UC_COLD_REL = 5e-3
STEPS = 3
UC_ARGS = ("--uc-n-gens", "2", "--uc-n-hours", "4")


def _spec(cls=SubmitRequest, steps=STEPS, **kw):
    kw.setdefault("tenant", "grid")
    kw.setdefault("model", "uc")
    kw.setdefault("gap_target", 0.05)
    kw.setdefault("max_iterations", 2)
    kw.setdefault("args", UC_ARGS)
    if steps:
        kw.setdefault("step_deadline_s", 600.0)
    return cls(mpc_steps=steps, **kw)


def _jax_argv(argv):
    return tuple(a.replace("mpisppy_tpu.", "mpisppy_tpu_torch.")
                 for a in argv)


def test_horizon_for_matches_jax():
    """uc geometry read back from the args, stray step flags stripped,
    --soc routed to the SOC horizon, a model without a hook refused; the
    port's ccopf recipe is the JAX one given --convthresh 0 (C1)."""
    args = ("--uc-n-gens", "2", "--uc-n-hours=4", "--uc-mpc-step", "9",
            "--uc-mpc-step=3", "--uc-seed", "5")
    for kw in (dict(args=args), dict(args=()),
               dict(model="ccopf", num_scens=9,
                    args=("--soc", "--ccopf-mpc-step", "2")),
               dict(model="ccopf", args=("--rel-gap", "0.2"))):
        d = _spec(steps=4, gap_target=0.02, max_iterations=77, **kw)
        t = horizon_for(d)
        j = jhz.horizon_for(_spec(jproto.SubmitRequest, steps=4,
                                  gap_target=0.02, max_iterations=77, **kw))
        jbase = j.base_argv
        if j.model == "ccopf":
            jbase = jhz.ccopf_horizon(
                soc=j.name == "ccopf-soc", gap_target=j.gap_target,
                max_step_iterations=j.max_step_iterations,
                extra_args=("--convthresh", "0")
                + j.base_argv[len(jhz.ccopf_horizon(
                    soc=j.name == "ccopf-soc").base_argv):]).base_argv
        assert t.base_argv == _jax_argv(jbase)
        assert (t.name, t.model, t.window, t.stride, t.step_flag,
                t.gap_target, t.max_step_iterations) == (
            j.name, j.model, j.window, j.stride, j.step_flag,
            j.gap_target, j.max_step_iterations)
        np.testing.assert_array_equal(t.plan.src_idx, j.plan.src_idx)
        argv = t.step_argv(2)
        assert argv.count(t.step_flag) == 1 and argv[-1] == "2"
    assert horizon_for(_spec(args=args)).window == 4
    with pytest.raises(ValueError, match="rolling-horizon"):
        horizon_for(_spec(model="farmer"))


class _PlaneSpy:
    """Records the warm plane each RollingDriver.run_step receives."""

    def __init__(self, mp):
        self.planes = {}
        real = RollingDriver.run_step
        spy = self

        def run_step(drv, step, warm_plane=None, strict=False):
            spy.planes[step] = warm_plane
            return real(drv, step, warm_plane=warm_plane, strict=strict)

        mp.setattr(RollingDriver, "run_step", run_step)


def _copy_after_step0(session, dst):
    """on_step hook: keep the stream checkpoint written after window 0."""
    def hook(sess):
        if sess.mpc_step == 1:
            shutil.copy(sess.checkpoint_path, dst)
    session.on_step = hook


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    out = {"tmp": tmp}
    # the JAX stream, keeping its checkpoint after window 0
    jlines = []
    js = jsess.Session(_spec(jproto.SubmitRequest), outbox=jlines.append)
    js.checkpoint_path = str(tmp / "jax.npz")
    _copy_after_step0(js, tmp / "jax_after0.npz")
    out["jax"] = jeng.WheelEngine(multiplexed=False).run(js)
    out["jax_lines"] = jlines
    eng = WheelEngine(multiplexed=False, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        spy = _PlaneSpy(mp)
        # the port's fault-free stream, keeping its checkpoint likewise
        base = []
        s0 = Session(_spec(), outbox=base.append)
        s0.checkpoint_path = str(tmp / "port.npz")
        _copy_after_step0(s0, tmp / "port_after0.npz")
        out["port"] = eng.run(s0)
        out["port_lines"], out["port_planes"] = base, dict(spy.planes)
        # a 2-window stream preempted entering window 1, then resumed
        chaos = []
        os.makedirs(tmp / "traces")
        s1 = Session(_spec(steps=2), outbox=chaos.append,
                     trace_dir=str(tmp / "traces"))
        s1.checkpoint_path = str(tmp / "chaos.npz")
        s1.on_step = (lambda sess: sess.preempt_event.set()
                      if sess.mpc_step == 1 else None)
        out["preempted"] = eng.run(s1)
        out["ckpt_existed"] = os.path.exists(s1.checkpoint_path)
        s1.preempt_event.clear()
        s1.on_step = None
        s1.restore, s1.preemptions = True, 1
        spy.planes.clear()
        out["resumed"] = eng.run(s1)
        out["resumed_planes"] = dict(spy.planes)
        s1.transition("ADMITTED")
        s1.transition("RUNNING")
        out["settled"] = (s1.settle("done", **out["resumed"][1]),
                          s1.settle("done", **out["resumed"][1]))
        out["chaos_lines"], out["chaos_session"] = chaos, s1
        # the port resumes the JAX package's checkpoint
        from_jax = []
        s2 = Session(_spec(steps=2), outbox=from_jax.append)
        s2.checkpoint_path = str(tmp / "from_jax.npz")
        shutil.copy(tmp / "jax_after0.npz", s2.checkpoint_path)
        s2.restore = True
        spy.planes.clear()
        out["from_jax"] = eng.run(s2)
        out["from_jax_lines"] = from_jax
        out["from_jax_planes"] = dict(spy.planes)
    # the JAX package resumes the port's
    from_port = []
    s3 = jsess.Session(_spec(jproto.SubmitRequest, steps=2),
                       outbox=from_port.append)
    s3.checkpoint_path = str(tmp / "from_port.npz")
    shutil.copy(tmp / "port_after0.npz", s3.checkpoint_path)
    s3.restore = True
    out["from_port"] = jeng.WheelEngine(multiplexed=False).run(s3)
    out["from_port_lines"] = from_port
    return out


def _steps(lines):
    return {m["step"]: m for m in lines if m.get("event") == "step"}


def _close(a, b, rel):
    if not (np.isfinite(a) and np.isfinite(b)):
        return a == b
    return abs(a - b) <= rel * max(1.0, abs(b))


def test_uc_stream_matches_jax(streams):
    (tv, tp), (jv, jp) = streams["port"], streams["jax"]
    assert tv == jv == "done"
    for f in ("steps", "warm_steps", "cold_fallbacks", "degraded_steps"):
        assert tp[f] == jp[f], f
    assert (tp["warm_steps"], tp["cold_fallbacks"],
            tp["degraded_steps"]) == (1, 1, 1)
    t, j = _steps(streams["port_lines"]), _steps(streams["jax_lines"])
    assert sorted(t) == sorted(j) == list(range(STEPS))
    for k in range(STEPS):
        assert (t[k]["warm"], t[k]["degraded"]) == (
            j[k]["warm"], j[k]["degraded"]), k
        rel = UC_COLD_REL if k == 0 else UC_REL
        for f in ("outer", "inner"):
            assert _close(t[k][f], j[k][f], rel), (k, f, t[k][f], j[k][f])
        assert len(t[k]["x_root"]) == len(j[k]["x_root"]) == 2 * 4
    # the stream's windows are the RollingDriver's: window k+1 starts
    # from the shifted plane of window k
    planes = streams["port_planes"]
    assert planes[0] is None and set(planes) == set(range(STEPS))


def test_preempted_stream_resumes_bit_identically(streams):
    v1, p1 = streams["preempted"]
    assert (v1, p1["step"]) == ("preempted", 1)
    assert streams["ckpt_existed"]
    v2, p2 = streams["resumed"]
    assert v2 == "done" and p2["preemptions"] == 1
    base, chaos = _steps(streams["port_lines"]), \
        _steps(streams["chaos_lines"])
    assert sorted(chaos) == [0, 1]
    for k in (0, 1):
        for f in ("outer", "inner", "rel_gap", "x_root", "warm"):
            assert chaos[k][f] == base[k][f], (k, f)
    for key, arr in streams["resumed_planes"][1].items():
        np.testing.assert_array_equal(arr,
                                      streams["port_planes"][1][key])
    terminals = [m for m in streams["chaos_lines"]
                 if m.get("event") in ("done", "failed", "rejected")]
    assert [m["event"] for m in terminals] == ["done"]
    assert streams["settled"] == (True, False)
    assert not os.path.exists(streams["chaos_session"].checkpoint_path)
    # one causal trace across the preemption: every window's mpc-step
    # span under the request root, no orphans
    from mpisppy_tpu_torch.telemetry import spans
    rows = spans.load_rows(streams["chaos_session"].trace_path)
    (tid,) = spans.trace_ids(rows)
    rep = spans.assemble(rows, tid)
    assert rep["orphans"] == []
    root = rep["spans"][0]
    assert root["name"] == "request"
    steps = [sp for sp in rep["spans"] if sp["name"] == "mpc-step"]
    assert len(steps) >= 3
    assert all(sp["parent_span_id"] == root["span_id"] for sp in steps)


def test_stream_checkpoints_cross_packages(streams):
    """Each package resumes the other's stream checkpoint (the JAX .npz
    layout): the resumed stream starts at the file's next_step with the
    file's plane, and window 1 matches the writer's within UC_REL."""
    with np.load(streams["tmp"] / "jax_after0.npz") as z:
        assert int(z["next_step"]) == 1
        jplane = {k: np.asarray(z[k]) for k in ("W", "xbar_nodes", "x")}
    assert sorted(streams["from_jax_planes"]) == [1]
    for k, arr in streams["from_jax_planes"][1].items():
        np.testing.assert_array_equal(arr, jplane[k])
    for name, ref in (("from_jax", "jax_lines"),
                      ("from_port", "port_lines")):
        verdict, payload = streams[name]
        assert verdict == "done" and payload["warm_steps"] == 1, name
        got, want = _steps(streams[name + "_lines"]), _steps(streams[ref])
        assert sorted(got) == [1], name
        assert got[1]["warm"] and want[1]["warm"]
        for f in ("outer", "inner"):
            assert _close(got[1][f], want[1][f], UC_REL), (name, f)


# ---------------------------------------------------------------------------
# the streaming reaper and the per-step charge
# ---------------------------------------------------------------------------
def _serve(tmp_path, engine, **kw):
    kw.setdefault("unix_path", str(tmp_path / "wheel.sock"))
    kw.setdefault("spool_dir", str(tmp_path / "spool"))
    kw.setdefault("multiplex", False)
    kw.setdefault("device", "cpu")
    kw["engine"] = engine
    return WheelServer(ServeOptions(**kw)).start()


def test_steps_overdue_counts_whole_windows():
    s = Session(_spec(step_deadline_s=0.2))
    assert s.streaming
    s.reset_step_anchor()
    now = time.perf_counter()
    assert s.steps_overdue(now + 0.19) == 0
    assert s.steps_overdue(now + 0.41) == 2
    s.note_step(0)
    assert s.mpc_step == 1 and s.steps_overdue(time.perf_counter()) == 0
    assert Session(_spec(steps=3, step_deadline_s=None)).steps_overdue(
        time.perf_counter() + 999.0) == 0


def test_stalled_stream_reaped_on_step_miss_budget(tmp_path):
    srv = _serve(tmp_path, SyntheticEngine(iters=400, step_s=0.02),
                 step_miss_budget=2)
    try:
        cl = loadgen.ServeClient(srv.address, timeout=30.0)
        rec = loadgen.run_session(cl, _spec(step_deadline_s=0.1))
        cl.close()
    finally:
        srv.stop()
    assert (rec["outcome"], rec["reason"]) == ("failed", "step-deadline")


def test_healthy_stream_outlives_session_wall_deadline(tmp_path):
    srv = _serve(tmp_path, SyntheticEngine(iters=30, step_s=0.02))
    try:
        cl = loadgen.ServeClient(srv.address, timeout=30.0)
        rec = loadgen.run_session(cl, _spec(steps=2, step_deadline_s=60.0,
                                            deadline_s=0.2))
        cl.close()
    finally:
        srv.stop()
    assert rec["outcome"] == "done", rec


def test_charge_step_bills_wfq_without_touching_quota():
    q = FairQueue(max_queued=8, default_quota=2)
    a = Session(_spec(tenant="A", steps=4))
    q.submit(a)
    assert q.pop() is a
    st0 = q.stats()["tenants"]["A"]
    for _ in range(3):
        q.charge_step(a)
    st = q.stats()["tenants"]["A"]
    assert st["steps_charged"] == 3 and st["inflight"] == 1
    assert st["vfinish"] > st0["vfinish"]
    q.submit(Session(_spec(tenant="A", steps=0)))
    q.submit(Session(_spec(tenant="B", steps=0)))
    assert q.pop().tenant == "B"
