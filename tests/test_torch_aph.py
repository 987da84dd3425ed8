# Port parity: Asynchronous Projective Hedging (algos/aph.py) and its
# hub, after tests/test_aph.py, against the JAX package on the CPU.
#
# Tolerances: aph_iter0 from the same batch, then three aph_iterk from one
# carried state (farmer S=6, dispatch_frac 0.5, so the masked merge is
# exercised) agree to 1e-5 of their scale in W, y, z, x̄ and to 1e-5
# relative in conv and theta (measured ~4e-6: f32 sums in another
# order); the dispatch record (last_solved) is equal.  The dispatch mask
# (round-robin with first-index ties) is equal over 12 iterations of
# synthetic staleness.  projective_theta is a ratio of f32 sums: held at
# 1e-5 relative.  The APH hub with Lagrangian and x̂-x̄ spokes certifies
# 1% on farmer in both packages, with outer bounds within 1e-4 relative
# (inner bounds come from different x̂ evaluation points and are held to
# the EF value at 5e-3).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import aph as japh
from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import aph as taph
from mpisppy_tpu_torch.ops import pdhg as tpdhg

torch.set_num_threads(1)


def _farmer(S):
    specs = [jfarmer.scenario_creator(nm, num_scens=S)
             for nm in jfarmer.scenario_names_creator(S)]
    jb = jbatch.from_specs(specs)
    return jb, convert.batch_from_arrays(convert.arrays_of(jb), "cpu")


def _opts(mod, pdhg_mod, **kw):
    base = dict(default_rho=1.0, subproblem_windows=10,
                pdhg=pdhg_mod.PDHGOptions(tol=1e-7, restart_period=40))
    base.update(kw)
    return mod.APHOptions(**base)


def _close(t, j, name):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * max(np.abs(j).max(), 1e-30),
                               err_msg=name)


def test_iter0_and_three_iterk_from_one_state():
    jb, tb = _farmer(6)
    jo = _opts(japh, jpdhg, dispatch_frac=0.5)
    to = _opts(taph, tpdhg, dispatch_frac=0.5)
    jst, jtb, jcert = japh.aph_iter0(jb, jnp.ones(jb.num_nonants), jo)
    _, ttb, tcert = taph.aph_iter0(tb, torch.ones(tb.num_nonants), to)
    assert bool(tcert) == bool(jcert)
    assert float(ttb) == pytest.approx(float(jtb), rel=1e-5)
    tst = convert.aph_state_from_arrays(convert.arrays_of(jst), "cpu")
    for k in range(3):
        jst = japh.aph_iterk(jb, jst, jo)
        tst = taph.aph_iterk(tb, tst, to)
        for name in ("W", "y", "z", "xbar_nodes"):
            _close(getattr(tst, name), getattr(jst, name),
                   f"iterk {k + 1} {name}")
        np.testing.assert_array_equal(tst.last_solved.numpy(),
                                      np.asarray(jst.last_solved))
        assert int(tst.it) == int(jst.it) == k + 1
        for name in ("conv", "theta", "gamma"):
            j = float(getattr(jst, name))
            if np.isfinite(j):
                assert float(getattr(tst, name)) == pytest.approx(
                    j, rel=1e-5, abs=1e-12), f"iterk {k + 1} {name}"
            else:
                assert not np.isfinite(float(getattr(tst, name)))
    # dispatch_frac 0.5 of 6: the full first dispatch, then the three
    # stalest scenarios per iteration
    np.testing.assert_array_equal(
        np.bincount(tst.last_solved.numpy(), minlength=4), [0, 0, 3, 3])


def test_dispatch_mask_round_robins_like_jax():
    """The n stalest scenarios, equal staleness rotating with the
    iteration and exact ties to the lower index; padded scenarios
    (p = 0) never win a slot."""
    jb, tb = _farmer(8)
    jo = _opts(japh, jpdhg)
    jst, _, _ = japh.aph_iter0(jb, jnp.ones(jb.num_nonants), jo)
    tst = convert.aph_state_from_arrays(convert.arrays_of(jst), "cpu")
    rng = np.random.default_rng(0)
    p = np.asarray(jb.p).copy()
    p[-1] = 0.0   # one padded scenario
    jb2 = jb.__class__(**{**jb.__dict__, "p": jnp.asarray(p)})
    tb2 = tb.__class__(**{**tb.__dict__, "p": torch.as_tensor(p)})
    for it in range(1, 13):
        last = rng.integers(0, 3, 8).astype(np.int32)  # many ties
        js = jst.__class__(**{**jst.__dict__,
                              "it": jnp.asarray(it, jnp.int32),
                              "last_solved": jnp.asarray(last)})
        ts = tst.__class__(**{**tst.__dict__,
                              "it": torch.tensor(it, dtype=torch.int32),
                              "last_solved": torch.as_tensor(last)})
        for n in (1, 2, 3, 5):
            jm = np.asarray(japh._dispatch_mask(jb2, js, n))
            tm = taph._dispatch_mask(tb2, ts, n).numpy()
            np.testing.assert_array_equal(tm, jm, err_msg=f"it {it} n {n}")
            assert tm.sum() == n and not tm[-1]


def test_projective_theta_matches_jax():
    jb, tb = _farmer(6)
    rng = np.random.default_rng(3)
    S, N = 6, jb.num_nonants
    arrs = [rng.normal(100.0, 30.0, (S, N)).astype(np.float32)
            for _ in range(4)]
    x_non, W, z_plane, W_plane = arrs
    xbar = np.broadcast_to(np.asarray(jb.p) @ x_non, (S, N)).copy()
    rho = np.full(N, 0.5, np.float32)
    for nu, gamma in ((1.0, 1.0), (0.7, 2.0)):
        j = float(japh.projective_theta(
            jb, *(jnp.asarray(a) for a in (x_non, xbar, W, z_plane,
                                           W_plane, rho)), nu, gamma))
        t = float(taph.projective_theta(
            tb, *(torch.as_tensor(a) for a in (x_non, xbar, W, z_plane,
                                               W_plane, rho)), nu, gamma))
        assert t == pytest.approx(j, rel=1e-5, abs=1e-12)


def test_aph_hub_with_spokes_matches_jax():
    from mpisppy_tpu import generic_cylinders as jgc
    from mpisppy_tpu_torch import generic_cylinders as tgc
    args = ["--num-scens", "3", "--rel-gap", "0.01", "--aph-hub",
            "--lagrangian", "--xhatxbar", "--max-iterations", "40",
            "--convthresh", "0"]
    jcfg = jgc._parse_args(
        __import__("mpisppy_tpu.models.farmer", fromlist=["x"]),
        ["--module-name", "mpisppy_tpu.models.farmer"] + args)
    jhub, jspokes, *_ = jgc.build_wheel(
        jcfg, __import__("mpisppy_tpu.models.farmer", fromlist=["x"]))
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JWheel
    jw = JWheel(jhub, jspokes).spin()
    tw = tgc.main(["--module-name", "mpisppy_tpu_torch.models.farmer",
                   "--device", "cpu"] + args)
    assert type(tw.spcomm).__name__ == "APHHub"
    assert tw.spcomm.compute_gaps()[1] <= 0.01
    assert tw.BestOuterBound == pytest.approx(jw.BestOuterBound, rel=1e-4)
    assert tw.BestInnerBound == pytest.approx(-108390.0, rel=5e-3)
    assert "theta" in tw.spcomm.trace[-1]
