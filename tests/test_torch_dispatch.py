# The port's dispatch subsystem (mpisppy_tpu_torch/dispatch) on the CPU:
# the device-independent cases of tests/test_dispatch.py against the
# port's scheduler, most with fake solve_fns that answer instantly with
# request-identifying values (inner = sum of c per lane):
#   * the bucket ladder and the pad/slice round trip equal to the JAX
#     package's for many sizes (pad lanes are copies of lane 0);
#   * coalescing into one megabatch, the max_batch cap, overflow
#     rotation, fire-and-forget without coalescing, backpressure under a
#     12-thread storm (in-flight never above the cap, every request gets
#     its own lanes back);
#   * deadlines, result(timeout=), hung-dispatch timeout and retry,
#     bisection quarantine of a poisoned request, dispatcher death,
#     exception fan-out, the dispatch-cause split, degrade;
#   * the compile guard (a warm signature that sees a compile event
#     raises) and the signature count bounded by the buckets touched;
#   * real solves: a padded solve_mip against the direct one (bounds to
#     gap_tol, feasibility equal, the certified bracket around the scipy
#     optimum), warm-start kwargs riding the padding, the Lagrangian
#     oracle through the default scheduler against the direct path, and
#     decomposition_bnb's node fan-out coalescing;
#   * the --dispatch-* Config group and from_cfg; the session stamps;
#     a plane ticket (submit_plane) returning its value.
import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.dispatch import buckets as jbuckets
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch import dispatch
from mpisppy_tpu_torch.dispatch import (
    BucketLadder, CompileWatch, DispatchOptions, SolveFailed,
    SolveScheduler, pad_qp_batch, slice_result,
)
from mpisppy_tpu_torch.dispatch import compilewatch
from mpisppy_tpu_torch.dispatch.buckets import (
    balanced_split, pad_leading_rows, shape_signature,
)
from mpisppy_tpu_torch.ops import bnb
from mpisppy_tpu_torch.ops.bnb import BnBOptions, BnBResult

from test_mip_bnb import random_mips

torch.set_num_threads(1)

LEAN = BnBOptions(pool_size=8, max_rounds=20, dive_rounds=4, dive_tail=8,
                  pump_rounds=0)
IC = np.arange(2, dtype=np.int64)


def _qp(S=3, seed=0, n=8, m=5):
    return convert.boxqp_from_arrays(
        convert.arrays_of(random_mips(S=S, seed=seed, n=n, m=m)[0]), "cpu")


def _mip(S, seed):
    jqp, integer, ref = random_mips(S=S, seed=seed)
    return (convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu"),
            np.nonzero(integer)[0], ref)


def _d(qp):
    return torch.ones(qp.c.shape[-1])


def _fake_result(qp):
    S = qp.c.shape[0]
    inner = qp.c.sum(dim=-1)                 # request-identifying value
    return BnBResult(x=torch.zeros_like(qp.c), inner=inner,
                     outer=inner - 1.0, gap=torch.zeros(S),
                     feasible=torch.ones(S, dtype=torch.bool),
                     nodes_solved=torch.ones(S, dtype=torch.int32))


def _fake(qp, d, ic, o, **kw):
    return _fake_result(qp)


def _sum_c(qp):
    return qp.c.sum(dim=-1).numpy()


def _wait(t, secs=5.0):
    deadline = time.perf_counter() + secs
    while not t.done() and time.perf_counter() < deadline:
        time.sleep(0.01)
    return t.done()


# -- buckets ----------------------------------------------------------------
@pytest.mark.parametrize("growth", [2.0, 1.5, 1.25])
def test_ladder_equals_jax(growth):
    t, j = BucketLadder(growth), jbuckets.BucketLadder(growth)
    assert t.rungs(5000) == j.rungs(5000)
    for size in range(1, 300):
        assert t.bucket(size) == j.bucket(size)
        assert t.bucket_floor(size) == j.bucket_floor(size)
    with pytest.raises(ValueError):
        t.bucket(0)
    with pytest.raises(ValueError):
        BucketLadder(1.0)


@pytest.mark.parametrize("S", [1, 3, 5, 8, 13])
def test_pad_slice_round_trip_equals_jax(S):
    jqp = random_mips(S=S, seed=S)[0]
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu")
    to = BucketLadder().bucket(S)
    d = np.arange(1, 9, dtype=np.float32)[None].repeat(S, 0)
    jp, jd = jbuckets.pad_qp_batch(jqp, jnp.asarray(d), to)
    tp, td = pad_qp_batch(tqp, torch.as_tensor(d), to)
    for f in ("c", "q", "A", "bl", "bu", "l", "u"):
        assert np.array_equal(getattr(tp, f).numpy(),
                              np.asarray(getattr(jp, f))), f
    assert np.array_equal(td.numpy(), np.asarray(jd))
    # pad lanes are copies of lane 0
    assert torch.equal(tp.c[S:], tqp.c[:1].expand(to - S, -1))
    x = torch.arange(to * 2.0).reshape(to, 2)
    assert torch.equal(pad_leading_rows(x[:S], S, to)[S:],
                       x[:1].expand(to - S, -1))
    res = slice_result(_fake_result(tp), S)
    assert res.inner.shape == (S,)
    assert np.array_equal(res.inner.numpy(), _sum_c(tqp))
    assert shape_signature(tp, td)[:4] \
        == jbuckets.shape_signature(jp, jd)[:4]
    if to > S:
        with pytest.raises(ValueError):
            pad_qp_batch(tqp, _d(tqp), S - 1 if S > 1 else 0)


def test_balanced_split_halves_lanes():
    assert balanced_split([3, 3, 3]) == 1
    assert balanced_split([1, 1, 8]) == 2
    assert balanced_split([8, 1, 1]) == 1
    for sizes in ([2, 5, 1, 9], [4, 4], [1, 1, 1, 1, 1]):
        assert balanced_split(sizes) == jbuckets.balanced_split(sizes)
    with pytest.raises(ValueError):
        balanced_split([4])


# -- coalescing and backpressure ---------------------------------------------
def test_coalesced_megabatch_returns_each_requests_lanes():
    sched = SolveScheduler(DispatchOptions(max_wait_ms=500.0),
                           solve_fn=_fake)
    qps = [_qp(3, s) for s in (1, 2, 3)]
    d = _d(qps[0])
    tickets = [sched.submit(qp, d, IC, LEAN) for qp in qps]
    for t, qp in zip(tickets, qps):
        assert np.allclose(t.result().inner.numpy(), _sum_c(qp))
    st = sched.stats()
    assert st["batches"] == 1 and st["coalesced_lanes"] == 9
    assert st["lanes"] == 9 and st["pad_lanes"] == 7        # 9 -> 16
    assert st["occupancy"] == pytest.approx(9 / 16)


def test_coalesce_respects_max_batch():
    sched = SolveScheduler(DispatchOptions(max_batch=4, max_wait_ms=500.0),
                           solve_fn=_fake)
    qps = [_qp(3, s) for s in range(3)]
    d = _d(qps[0])
    tickets = [sched.submit(qp, d, IC, LEAN) for qp in qps]
    for t, qp in zip(tickets, qps):
        assert np.allclose(t.result().inner.numpy(), _sum_c(qp))
    assert sched.stats()["batches"] == 3


def test_overflow_rotation_dispatches_displaced_window():
    sched = SolveScheduler(DispatchOptions(max_batch=8,
                                           max_wait_ms=60_000.0),
                           solve_fn=_fake)
    qps = [_qp(3, s) for s in range(3)]
    d = _d(qps[0])
    t1 = sched.submit(qps[0], d, IC, LEAN)
    t2 = sched.submit(qps[1], d, IC, LEAN)
    t3 = sched.submit(qps[2], d, IC, LEAN)       # 6 + 3 > 8: rotation
    assert t1.done() and t2.done()
    assert np.allclose(t2.result().inner.numpy(), _sum_c(qps[1]))
    t3.result()
    assert sched.stats()["by_cause"].get("overflow") == 1


def test_coalesce_off_fire_and_forget_still_dispatches():
    sched = SolveScheduler(DispatchOptions(coalesce=False, max_wait_ms=20.0),
                           solve_fn=_fake)
    qp = _qp()
    t = sched.submit(qp, _d(qp), IC, LEAN)
    assert _wait(t), "fire-and-forget submit never dispatched"


def test_backpressure_bounds_inflight_under_storm():
    state = {"now": 0, "max": 0}
    lock = threading.Lock()

    def slow_solve(qp, d_col, int_cols, opts, **kw):
        with lock:
            state["now"] += 1
            state["max"] = max(state["max"], state["now"])
        time.sleep(0.05)
        with lock:
            state["now"] -= 1
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(max_inflight=2, max_wait_ms=5.0),
                           solve_fn=slow_solve)
    rng = np.random.RandomState(0)
    cs = [rng.randn(2, 6).astype(np.float32) for _ in range(12)]
    base = _qp(2, n=6, m=4)
    d = _d(base)
    errs = []

    def one(c):
        try:
            qp = dataclasses.replace(base, c=torch.as_tensor(c))
            res = sched.solve_mip(qp, d, IC, LEAN)
            assert np.allclose(res.inner.numpy(), c.sum(-1)), \
                "lane routing under the storm returned foreign lanes"
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=one, args=(c,)) for c in cs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs, errs
    st = sched.stats()
    assert state["max"] <= 2 and st["inflight_max"] <= 2
    assert st["batches"] < 12 and st["lanes"] == 24


# -- fault domain -------------------------------------------------------------
def test_ticket_result_timeout_never_hangs():
    def slow(qp, d, ic, o, **kw):
        time.sleep(0.3)
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(max_wait_ms=1.0), solve_fn=slow)
    qp = _qp()
    t = sched.submit(qp, _d(qp), IC, LEAN)
    t0 = time.perf_counter()
    with pytest.raises(SolveFailed) as ei:
        t.result(timeout=0.05)
    assert ei.value.reason == "deadline"
    assert time.perf_counter() - t0 < 0.25
    assert np.allclose(t.result().inner.numpy(), _sum_c(qp))


def test_submit_deadline_bounds_every_result_call():
    def hang(qp, d, ic, o, **kw):
        time.sleep(2.0)
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(max_wait_ms=1.0, deadline_s=0.08),
                           solve_fn=hang)
    qp = _qp()
    t = sched.submit(qp, _d(qp), IC, LEAN)
    t0 = time.perf_counter()
    with pytest.raises(SolveFailed) as ei:
        t.result()
    assert ei.value.reason == "deadline"
    assert time.perf_counter() - t0 < 1.0


def test_hung_dispatch_times_out_and_retry_succeeds():
    calls = []

    def flaky(qp, d, ic, o, **kw):
        calls.append(1)
        if len(calls) == 1:
            time.sleep(2.0)                  # the first attempt hangs
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(dispatch_timeout_s=0.1,
                                           retry_max=2,
                                           retry_backoff_s=0.01),
                           solve_fn=flaky)
    qp = _qp()
    res = sched.solve_mip(qp, _d(qp), IC, LEAN)
    assert np.allclose(res.inner.numpy(), _sum_c(qp))
    st = sched.stats()
    assert st["retries_total"] == 1 and st["quarantined_lanes"] == 0


def test_poison_request_bisected_and_quarantined():
    """One poisoned request (its c carries a marker) in a coalesced
    megabatch fails every attempt: bisection isolates it, its ticket
    raises, the healthy requests get their own lanes."""
    def poisoned(qp, d, ic, o, **kw):
        if bool((qp.c == 99.0).any()):
            raise RuntimeError("synthetic poison")
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(max_wait_ms=500.0, retry_max=1,
                                           retry_backoff_s=0.001),
                           solve_fn=poisoned)
    qps = [_qp(3, s) for s in range(3)]
    qps[1] = dataclasses.replace(qps[1], c=qps[1].c.clone().fill_(99.0))
    d = _d(qps[0])
    tickets = [sched.submit(qp, d, IC, LEAN) for qp in qps]
    for k in (0, 2):
        assert np.allclose(tickets[k].result().inner.numpy(),
                           _sum_c(qps[k]))
    with pytest.raises(SolveFailed) as ei:
        tickets[1].result()
    assert ei.value.reason == "exception" and ei.value.lanes == 3
    assert "synthetic poison" in ei.value.detail
    st = sched.stats()
    assert st["quarantined_lanes"] == 3 and st["quarantined_requests"] == 1
    assert st["retries_total"] >= 1


def test_dispatcher_death_fails_queued_tickets_fast(monkeypatch):
    sched = SolveScheduler(DispatchOptions(max_wait_ms=20.0), solve_fn=_fake)
    orig = sched._dispatch_loop_inner
    calls = []

    def dies():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("dispatcher killed")
        return orig()

    monkeypatch.setattr(sched, "_dispatch_loop_inner", dies)
    qp = _qp()
    t = sched.submit(qp, _d(qp), IC, LEAN)
    assert _wait(t), "queued ticket hung on a dead dispatcher"
    with pytest.raises(SolveFailed) as ei:
        t.result()
    assert ei.value.reason == "dispatcher-died"
    assert sched.stats()["dispatcher_deaths"] == 1
    t2 = sched.submit(qp, _d(qp), IC, LEAN)      # the daemon restarts
    assert t2.result().inner.shape == (3,)


def test_exception_raising_dispatch_propagates_to_all_window_tickets():
    def bad(qp, d, ic, o, **kw):
        raise RuntimeError("synthetic device failure")

    sched = SolveScheduler(DispatchOptions(max_wait_ms=10.0, retry_max=1,
                                           retry_backoff_s=0.001),
                           solve_fn=bad)
    qp = _qp()
    d = _d(qp)
    t1 = sched.submit(qp, d, IC, LEAN)
    t2 = sched.submit(qp, d, IC, LEAN)
    assert _wait(t1) and _wait(t2)
    for t in (t1, t2):
        with pytest.raises(SolveFailed) as ei:
            t.result(timeout=1.0)
        assert "synthetic device failure" in ei.value.detail


def test_stats_split_dispatch_cause_and_degrade():
    sched = SolveScheduler(DispatchOptions(max_batch=6, max_wait_ms=30.0),
                           solve_fn=_fake)
    qa, qb = _qp(3, 0), _qp(3, 1)
    d = _d(qa)
    ta, tb = sched.submit(qa, d, IC, LEAN), sched.submit(qb, d, IC, LEAN)
    ta.result(), tb.result()                       # size
    sched.solve_mip(_qp(2, 2), _d(qa), IC, LEAN)    # inline
    td = sched.submit(_qp(2, 3), _d(qa), IC, LEAN)  # timer
    assert _wait(td)
    by = sched.stats()["by_cause"]
    assert by == {"size": 1, "inline": 1, "timer": 1}, by
    sched.degrade()
    assert not sched.options.coalesce and sched.stats()["degraded"]
    t1, t2 = sched.submit(qa, d, IC, LEAN), sched.submit(qa, d, IC, LEAN)
    t1.result(), t2.result()
    assert sched.stats()["batches"] == 5


# -- compile discipline -------------------------------------------------------
def test_compile_guard_raises_on_warm_signature_compile():
    def leaky_solve(qp, d_col, int_cols, opts, **kw):
        compilewatch.record(0.01)    # a kernel build inside every dispatch
        return _fake_result(qp)

    sched = SolveScheduler(DispatchOptions(compile_guard=True,
                                           coalesce=False),
                           solve_fn=leaky_solve)
    qp = _qp(4)
    sched.solve_mip(qp, _d(qp), IC, LEAN)          # first touch: allowed
    with pytest.raises(AssertionError, match="compile-cache discipline"):
        sched.solve_mip(qp, _d(qp), IC, LEAN)      # warm: caught


def test_signature_compiles_bounded_by_buckets():
    """Variably sized solves count one compile event per padded
    signature first seen; re-dispatching warm sizes counts none."""
    sched = SolveScheduler(DispatchOptions(coalesce=False), solve_fn=_fake)
    opts = dataclasses.replace(LEAN, pool_size=7)   # a fresh signature set
    watch = CompileWatch()
    for s, size in [(0, 3), (1, 4), (2, 5), (3, 6)]:
        qp = _qp(size, s)
        sched.solve_mip(qp, _d(qp), IC, opts)
    assert sched.stats()["buckets"] == 2 and watch.delta() == 2
    watch.mark()
    for s, size in [(7, 3), (8, 6), (9, 4), (10, 5)]:
        qp = _qp(size, s)
        sched.solve_mip(qp, _d(qp), IC, opts)
    assert watch.delta() == 0
    st = sched.stats()
    assert st["unexpected_recompiles"] == 0 and st["buckets"] == 2
    assert st["backend_compiles"] == 2


# -- real solves --------------------------------------------------------------
def test_padded_solve_mip_equals_direct():
    qp, ic, ref = _mip(5, 7)
    direct = bnb.solve_mip(qp, _d(qp), ic, LEAN)
    sched = SolveScheduler()                       # pads 5 -> 8
    via = sched.solve_mip(qp, _d(qp), ic, LEAN)
    assert torch.equal(direct.feasible, via.feasible)
    tol = LEAN.gap_tol * (1.0 + np.abs(ref))
    assert np.allclose(direct.outer.numpy(), via.outer.numpy(),
                       atol=tol.max(), rtol=1e-4)
    feas = direct.feasible.numpy()
    assert np.allclose(direct.inner.numpy()[feas], via.inner.numpy()[feas],
                       atol=tol.max(), rtol=1e-4)
    st = sched.stats()
    assert (st["batches"], st["lanes"], st["pad_lanes"]) == (1, 5, 3)
    assert np.all(via.outer.numpy() <= ref + 1e-3 * (1.0 + np.abs(ref)))
    # warm-start kwargs ride the same padding
    S, n = qp.c.shape
    res = sched.solve_mip(qp, _d(qp), ic, LEAN, x_warm=torch.zeros(S, n),
                          y_warm=torch.zeros(S, qp.m))
    assert res.inner.shape == (5,)


@pytest.fixture()
def sslp36():
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import sslp
    inst = sslp.synthetic_instance(3, 6, seed=4)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=3)
             for nm in sslp.scenario_names_creator(3)]
    yield batch_mod.from_specs(specs, device="cpu")
    dispatch.configure()      # a fresh default scheduler for what follows


def test_lagrangian_oracle_matches_direct_path(sslp36):
    from mpisppy_tpu_torch.algos import mip
    batch = sslp36
    dispatch.configure()
    W = torch.zeros((batch.num_scenarios, batch.num_nonants))
    lag = mip.lagrangian_mip_bound(batch, W, LEAN)
    qp = batch.with_nonant_linear_quad(W, torch.zeros_like(W))
    res = bnb.solve_mip(qp, batch.d_col, mip._int_cols(batch), LEAN)
    p = batch.p.numpy()
    direct = float(np.sum(np.where(p > 0.0, p * res.outer.numpy(), 0.0)))
    assert lag["bound"] == pytest.approx(direct, rel=1e-3, abs=1e-3)
    assert dispatch.scheduler_stats()["pad_lanes"] == 1       # 3 -> 4


def test_decomposition_bnb_fanout_keeps_bracket(sslp36):
    from mpisppy_tpu_torch.algos import mip
    batch = sslp36
    W = torch.zeros((batch.num_scenarios, batch.num_nonants))
    before = dispatch.get_scheduler().stats()["coalesced_lanes"]
    dd = mip.decomposition_bnb(batch, W, LEAN, max_nodes=6, node_fanout=3)
    assert dd["outer"] <= dd["inner"] + 1e-6
    assert dd["nodes"] <= 6 and dd["failed_nodes"] == 0
    after = dispatch.get_scheduler().stats()["coalesced_lanes"]
    assert after > before, "node fanout produced no coalesced dispatch"


# -- CLI knobs -----------------------------------------------------------------
def test_dispatch_cli_knobs_and_from_cfg():
    from mpisppy_tpu_torch.utils.config import Config
    cfg = Config()
    cfg.dispatch_args()
    cfg.parse_command_line("t", [
        "--dispatch-max-inflight", "3", "--dispatch-max-batch", "64",
        "--dispatch-coalesce", "false", "--dispatch-bucket-growth",
        "1.5", "--dispatch-compile-guard",
        "--dispatch-timeout-s", "30", "--dispatch-retry-max", "4",
        "--dispatch-retry-backoff-s", "0.2",
        "--dispatch-deadline-s", "120"])
    try:
        sched = dispatch.from_cfg(cfg)
        assert sched is dispatch.get_scheduler()
        o = sched.options
        assert o.max_inflight == 3 and o.max_batch == 64
        assert o.coalesce is False and o.compile_guard is True
        assert sched.ladder.growth == 1.5
        assert o.dispatch_timeout_s == 30.0 and o.retry_max == 4
        assert o.retry_backoff_s == 0.2 and o.deadline_s == 120.0
    finally:
        dispatch.configure()


def test_session_context_and_hub_iter():
    dispatch.set_hub_iter(7)
    assert dispatch.current_context().hub_iter == 7
    dispatch.set_session_context("run-a", 3)
    dispatch.set_hub_iter(4)
    ctx = dispatch.current_context()
    assert (ctx.run, ctx.hub_iter) == ("run-a", 4)
    dispatch.configure()                  # a fresh run resets both stamps
    assert dispatch.current_context().run == ""
    assert dispatch.current_hub_iter() == -1


def test_plane_ticket_returns_its_value_and_counts():
    """submit_plane runs its function inline; a CPU value is ready at
    once, so result() returns it under any deadline."""
    sched = SolveScheduler(solve_fn=_fake)
    x = torch.arange(4.0)
    t = sched.submit_plane(lambda v: v * 2.0, x, label="p",
                           deadline_s=0.0)
    assert t.done() and torch.equal(t.result(), x * 2.0)
    assert torch.equal(t.result(timeout=0.01), x * 2.0)
    assert sched.stats()["plane_tickets"] == 1
    assert sched.stats()["plane_deadline_misses"] == 0
