# Port parity: batched branch-and-bound (mpisppy_tpu_torch/ops/bnb.py) and
# the certified dual bound (ops/boxqp.py), against the JAX package on the
# CPU, on numpy-seeded inputs fed to both:
#   * certified_dual_bound on random iterates (infinite rows and boxes,
#     q > 0): 1e-5 relative (sums in another order);
#   * _node_qp: exact; detect_sos1_groups (dense and ELL A): equal;
#     merge_incumbents: exact;
#   * one bnb_round and one dive_round from the same state, carried from
#     the JAX package by convert.py, on the Lagrangian sslp subproblems
#     (a dense shared A: the window kernel's route, its plain version
#     here): the pools, depths, masks and integer bounds are equal (the
#     same selected slot and branch column), bounds and objectives agree
#     to 1e-4 relative;
#   * solve_mip on the random MIPs of tests/test_mip_bnb.py: both
#     packages' certified brackets contain the scipy MILP optimum and
#     overlap each other.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import bnb as jbnb
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.ops import bnb as tbnb
from mpisppy_tpu_torch.ops import boxqp as tboxqp

from test_mip_bnb import random_mips

torch.set_num_threads(1)

REL = 1e-4
# lean budgets: these tests hold the two packages to each other, not the
# search to closure
LEAN = dict(pool_size=8, max_rounds=20, dive_rounds=4, dive_tail=8,
            pump_rounds=0)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a)).to(dtype)


def _close(t, j, rel=REL):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t)), (t, j)
    assert np.array_equal(t[~fin], j[~fin])
    assert np.all(np.abs(t[fin] - j[fin])
                  <= rel * np.maximum(1.0, np.abs(j[fin]))), (t, j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_certified_dual_bound_matches_jax(seed):
    rng = np.random.RandomState(seed)
    S, m, n = 3, 5, 7
    bl = rng.randn(S, m) - 1.0
    bu = bl + rng.rand(S, m) * 3.0
    bl[:, 0] = -np.inf                       # one-sided rows
    bu[:, 1] = np.inf
    bu[:, 2] = bl[:, 2]                      # an equality row
    lo = -rng.rand(S, n)
    up = rng.rand(S, n) + 0.5
    lo[:, 0] = -np.inf                       # infinite boxes
    up[:, 1] = np.inf
    fields = dict(c=rng.randn(S, n), q=np.abs(rng.randn(S, n)) * 0.1,
                  A=rng.randn(m, n), bl=bl, bu=bu, l=lo, u=up)
    jqp = jboxqp.BoxQP(**{k: jnp.asarray(v, jnp.float32)
                          for k, v in fields.items()})
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu")
    for trial in range(4):
        x = rng.randn(S, n).astype(np.float32)
        y = rng.randn(S, m).astype(np.float32)
        if trial == 0:
            # a bound free of adverse infinite pairings: finite everywhere
            x[:, :2] = 0.0
        jb = np.asarray(jboxqp.certified_dual_bound(jqp, jnp.asarray(x),
                                                    jnp.asarray(y)))
        tb = tboxqp.certified_dual_bound(tqp, _t(x), _t(y)).numpy()
        _close(tb, jb, rel=1e-5)


def test_node_qp_is_exact():
    rng = np.random.RandomState(3)
    S, n = 4, 9
    ic = np.array([0, 2, 3, 7])
    jqp, _, _ = random_mips(S=S, n=n)
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu")
    d = (0.5 + rng.rand(n)).astype(np.float32)
    lo = rng.randint(0, 2, (S, len(ic))).astype(np.float32)
    hi = lo + rng.randint(0, 3, (S, len(ic))).astype(np.float32)
    jn = jbnb._node_qp(jqp, jnp.asarray(d), jnp.asarray(ic),
                       jnp.asarray(lo), jnp.asarray(hi))
    tn = tbnb._node_qp(tqp, _t(d), torch.as_tensor(ic), _t(lo), _t(hi))
    assert np.array_equal(tn.l.numpy(), np.asarray(jn.l))
    assert np.array_equal(tn.u.numpy(), np.asarray(jn.u))


def _sslp(S, strengthen=False):
    inst = jsslp.synthetic_instance(3, 6, seed=4)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=S,
                                    strengthen=strengthen)
             for nm in jsslp.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


@pytest.mark.parametrize("strengthen", [False, True],
                         ids=["dense", "ell"])
def test_detect_sos1_groups_equal(strengthen):
    jb, tb = _sslp(4, strengthen)
    ic = np.nonzero(np.asarray(jb.integer_full))[0].astype(np.int32)
    jg, ja = jbnb.detect_sos1_groups(jb.qp, jb.d_col, jnp.asarray(ic))
    tg, ta = tbnb.detect_sos1_groups(tb.qp, tb.d_col, ic)
    assert jg is not None and jg.shape[0] >= 4   # the clients present
    assert np.array_equal(tg.numpy(), np.asarray(jg))
    assert np.array_equal(ta.numpy(), np.asarray(ja))


def test_merge_incumbents_exact():
    rng = np.random.RandomState(5)
    S, n = 6, 4
    inc = rng.randn(S).astype(np.float32)
    inc[1] = np.inf
    cand = rng.randn(S).astype(np.float32)
    cand[2] = np.inf
    feas = np.array([1, 0, 1, 1, 0, 1], bool)
    cfeas = np.array([1, 1, 0, 1, 1, 0], bool)
    x, cx = (rng.randn(S, n).astype(np.float32) for _ in range(2))
    j = jbnb.merge_incumbents(*(jnp.asarray(v) for v in
                                (inc, x, feas, cand, cx, cfeas)))
    t = tbnb.merge_incumbents(*(torch.as_tensor(v) for v in
                                (inc, x, feas, cand, cx, cfeas)))
    for a, b in zip(t, j):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def lag_problem():
    """The sslp 3x6 Lagrangian subproblems at S=4 (W mean-zero), in both
    packages, with their integer columns and SOS1 groups."""
    jb, tb = _sslp(4)
    W = np.random.RandomState(6).randn(4, jb.num_nonants).astype(np.float32)
    W -= W.mean(axis=0)
    jqp = jb.with_nonant_linear_quad(jnp.asarray(W), jnp.zeros_like(W))
    tqp = tb.with_nonant_linear_quad(_t(W), torch.zeros(W.shape))
    ic = np.nonzero(np.asarray(jb.integer_full))[0].astype(np.int32)
    return jb, tb, jqp, tqp, ic


def test_bnb_round_matches_jax(lag_problem):
    """Three JAX rounds from the root grow a pool; its state crosses to
    the port and one more round runs in each package."""
    jb, tb, jqp, tqp, ic = lag_problem
    opts_j = jbnb.BnBOptions(**LEAN)
    st = jbnb.root_state(jqp, jb.d_col, jnp.asarray(ic), opts_j)
    for _ in range(3):
        st = jbnb.bnb_round(jqp, jb.d_col, jnp.asarray(ic), st, opts_j)
    tst = convert.bnb_state_from_arrays(convert.arrays_of(st), "cpu")
    j1 = jbnb.bnb_round(jqp, jb.d_col, jnp.asarray(ic), st, opts_j)
    t1 = tbnb.bnb_round(tqp, tb.d_col, ic, tst, tbnb.BnBOptions(**LEAN))
    assert int(np.asarray(j1.nodes_solved).sum()) > 3   # a live search
    for f in ("pool_active", "pool_depth", "pool_lo", "pool_hi", "done",
              "nodes_solved"):
        assert np.array_equal(getattr(t1, f).numpy(),
                              np.asarray(getattr(j1, f))), f
    for f in ("pool_bound", "incumbent", "fathom_floor", "lost_bound",
              "outer"):
        _close(getattr(t1, f).numpy(), np.asarray(getattr(j1, f)))


@pytest.mark.parametrize("mode", ["wave", "group", "single"])
def test_dive_round_matches_jax(lag_problem, mode):
    """One dive_round from the root box, warm from the same iterates."""
    jb, tb, jqp, tqp, ic = lag_problem
    opts_j = jbnb.BnBOptions(**LEAN)
    lo, hi = jbnb._root_bounds(jqp, jb.d_col, ic)
    sos1 = jbnb.detect_sos1_groups(jqp, jb.d_col, jnp.asarray(ic))
    S, n = jqp.c.shape
    x0 = jnp.clip(jnp.zeros((S, n)), jqp.l, jqp.u)
    y0 = jnp.zeros((S, jqp.m))
    om = jnp.ones((S,))
    L = jnp.asarray(np.asarray(jbnb.pdhg.estimate_norm(jqp)), jnp.float32)
    j = jbnb.dive_round(jqp, jb.d_col, jnp.asarray(ic), jnp.asarray(lo),
                        jnp.asarray(hi), x0, y0, om, L, opts_j, mode,
                        sos1=sos1)
    tsos1 = tbnb.detect_sos1_groups(tqp, tb.d_col, ic)
    t = tbnb.dive_round(tqp, tb.d_col, ic, _t(lo), _t(hi), _t(x0), _t(y0),
                        _t(om), _t(L), tbnb.BnBOptions(**LEAN), mode,
                        sos1=tsos1)
    assert np.array_equal(t[0].numpy(), np.asarray(j[0]))      # lo
    assert np.array_equal(t[1].numpy(), np.asarray(j[1]))      # hi
    assert int((np.asarray(j[0]) == np.asarray(j[1])).sum()) \
        > int((lo == hi).sum())                                # pins made
    _close(t[5].numpy(), np.asarray(j[5]))                     # objective
    assert np.array_equal(t[6].numpy(), np.asarray(j[6]))      # feasible


def test_solve_mip_brackets_contain_oracle_and_overlap():
    jqp, integer, ref = random_mips()
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu")
    ic = np.nonzero(integer)[0].astype(np.int32)
    kw = dict(pool_size=32, max_rounds=300)
    j = jbnb.solve_mip(jqp, jnp.ones(jqp.c.shape[-1], jnp.float32), ic,
                       jbnb.BnBOptions(**kw))
    t = tbnb.solve_mip(tqp, torch.ones(tqp.n), ic, tbnb.BnBOptions(**kw))
    scale = 1.0 + np.abs(ref)
    brackets = [(np.asarray(j.inner), np.asarray(j.outer)),
                (t.inner.numpy(), t.outer.numpy())]
    for inner, outer in brackets:
        assert np.all(outer <= ref + 1e-3 * scale), (outer, ref)
        assert np.all(inner >= ref - 1e-3 * scale), (inner, ref)
    (ji, jo), (ti, to) = brackets
    assert np.all(to <= ji + 1e-3 * scale) and np.all(jo <= ti + 1e-3 * scale)
    assert np.asarray(t.feasible).all()
