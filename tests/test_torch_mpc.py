# Port parity: the rolling horizon (mpisppy_tpu_torch/mpc/, the hub's
# warm plane and uc's rolling-horizon hooks) against the JAX package on
# the CPU:
#   * the shift plans and the validation cases of tests/test_mpc.py;
#   * shift_warm_plane equal to the JAX package's bit for bit (W gathered
#     then zeroed on the fresh tail, x̄ and x gathered);
#   * uc's mpc_instance and its re-keyed demand equal to the JAX
#     package's bit for bit (the weight sum in XLA's CPU order);
#   * the hub seeds the plane into opt.state (and the fused wheel's
#     wstate) at sync 1;
#   * a 2-step RollingDriver on ccopf (3,3) --soc: per-step bounds within
#     1e-4 relative of the JAX driver's, the same warm flags, and the warm
#     window's conv-thresh stop in both packages (ROADMAP C11);
#   * the CLI with --uc-mpc-step/--uc-mpc-stride against the JAX CLI (2
#     hub rows; the outer bound within the uc wheel test's 2e-3).
import contextlib
import io
import json

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.models import uc as juc
from mpisppy_tpu.mpc import horizon as jhz
from mpisppy_tpu.mpc import shift as jshift
from mpisppy_tpu_torch.models import uc as tuc
from mpisppy_tpu_torch.mpc import HorizonSpec, ShiftPlan
from mpisppy_tpu_torch.mpc import horizon as thz
from mpisppy_tpu_torch.mpc import shift as tshift

torch.set_num_threads(1)

REL = 1e-4


def test_uc_plan_rolls_hours_and_freshens_tails():
    """uc slot (g, t) of the new window reads old (g, t + stride); the
    last `stride` hours of each generator are fresh, persistence-filled
    from the generator's final in-window hour; the JAX plan's arrays."""
    for G, T, stride in ((2, 4, 1), (2, 4, 2), (3, 24, 1), (10, 24, 5),
                         (1, 1, 1)):
        plan = tshift.uc_plan(G, T, stride)
        ref = jshift.uc_plan(G, T, stride)
        assert plan.num_nonants == G * T
        for a, b in ((plan.src_idx, ref.src_idx),
                     (plan.fresh_mask, ref.fresh_mask)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for g in range(G):
            for t in range(T):
                i = g * T + t
                rolled = t + stride < T
                assert plan.src_idx[i] == (g * T + t + stride if rolled
                                           else g * T + T - 1)
                assert plan.fresh_mask[i] == (0.0 if rolled else 1.0)


def test_ccopf_plan_promotes_stage2_to_stage1():
    ng = 3
    plan = tshift.ccopf_plan(ng)
    assert plan.num_nonants == 2 * ng
    np.testing.assert_array_equal(
        plan.src_idx, np.concatenate([np.arange(ng, 2 * ng)] * 2))
    np.testing.assert_array_equal(
        plan.fresh_mask, np.r_[np.zeros(ng), np.ones(ng)])
    np.testing.assert_array_equal(plan.src_idx,
                                  jshift.ccopf_plan(ng).src_idx)


def test_shift_plan_and_horizon_validation():
    with pytest.raises(ValueError, match="same"):
        ShiftPlan(src_idx=np.zeros(3, np.int32),
                  fresh_mask=np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="index the same window"):
        ShiftPlan(src_idx=np.array([0, 5], np.int32),
                  fresh_mask=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match="stride"):
        tshift.uc_plan(2, 4, stride=5)
    with pytest.raises(ValueError, match="bad horizon"):
        HorizonSpec(name="x", model="uc", window=4, stride=5,
                    plan=tshift.uc_plan(1, 4), base_argv=(),
                    step_flag="--uc-mpc-step")
    with pytest.raises(ValueError, match="step"):
        thz.uc_horizon(n_gens=1, n_hours=4).step_argv(-1)


def test_horizons_match_jax_recipes():
    """The port's horizons are the JAX package's with the port's model
    modules: the same argv, plan, window and step flag."""
    for t, j in ((thz.uc_horizon(2, 4, 2, extra_args=("--uc-seed", "3")),
                  jhz.uc_horizon(2, 4, 2, extra_args=("--uc-seed", "3"))),
                 (thz.ccopf_horizon(soc=True), jhz.ccopf_horizon(soc=True)),
                 (thz.ccopf_horizon(soc=False, gap_target=0.02),
                  jhz.ccopf_horizon(soc=False, gap_target=0.02))):
        assert t.base_argv == tuple(a.replace("mpisppy_tpu.", "mpisppy_"
                                              "tpu_torch.")
                                    for a in j.base_argv)
        assert (t.name, t.model, t.window, t.stride, t.step_flag,
                t.gap_target) == (j.name, j.model, j.window, j.stride,
                                  j.step_flag, j.gap_target)
        np.testing.assert_array_equal(t.plan.src_idx, j.plan.src_idx)
        assert t.step_argv(4)[-2:] == [t.step_flag, "4"]


def _rand_plane(rng, S, nodes, N):
    W = rng.normal(size=(S, N)).astype(np.float32)
    W -= W.mean(axis=0)     # uniform-p node-mean-zero PH invariant
    return {"W": W,
            "xbar_nodes": rng.normal(size=(nodes, N)).astype(np.float32),
            "x": rng.normal(size=(S, N)).astype(np.float32)}


@pytest.mark.parametrize("plan_args", [("uc", 2, 4, 2), ("uc", 3, 6, 1),
                                       ("ccopf", 3)])
def test_shift_warm_plane_matches_jax_bit_for_bit(plan_args):
    kind, *args = plan_args
    plan = getattr(tshift, f"{kind}_plan")(*args)
    jplan = getattr(jshift, f"{kind}_plan")(*args)
    rng = np.random.default_rng(7)
    plane = _rand_plane(rng, S=5, nodes=4, N=plan.num_nonants)
    plane["W"][0, -1] -= 3.0        # a negative dual on a fresh slot,
    plane["W"][1, -1] += 3.0        # the column mean kept
    out = tshift.shift_warm_plane(plane, plan)
    ref = jshift.shift_warm_plane(plane, jplan)
    for k in ("W", "xbar_nodes", "x"):
        assert out[k].dtype == ref[k].dtype == np.float32
        assert out[k].tobytes() == ref[k].tobytes(), k
    keep = 1.0 - plan.fresh_mask
    np.testing.assert_array_equal(out["W"],
                                  plane["W"][..., plan.src_idx] * keep)
    np.testing.assert_allclose(out["W"].mean(axis=0),
                               np.zeros(plan.num_nonants), atol=1e-6)
    assert np.all(out["W"][:, plan.fresh_mask == 1.0] == 0.0)


@pytest.mark.parametrize("G,T,stride,step", [(3, 24, 1, 0), (3, 24, 1, 5),
                                             (2, 4, 2, 3), (10, 24, 3, 2)])
def test_uc_mpc_instance_and_demand_match_jax(G, T, stride, step):
    """The window's instance (rolled profile, the step recorded, the
    cached structure carried over) and every scenario's re-keyed demand
    equal the JAX package's bit for bit."""
    base_t = tuc.synthetic_instance(G, T, 0)
    tuc.scenario_creator("Scenario0", instance=base_t)   # caches A
    t = tuc.mpc_instance(base_t, step, stride)
    j = juc.mpc_instance(juc.synthetic_instance(G, T, 0), step, stride)
    np.testing.assert_array_equal(t["profile"], j["profile"])
    assert (t["mpc_step"], t["mpc_stride"]) == (step, stride)
    assert t["_spec_cache"] is base_t["_spec_cache"]
    for k in range(12):
        np.testing.assert_array_equal(tuc._mpc_demand(t, k),
                                      juc._mpc_demand(j, k))
    ts = tuc.scenario_creator("Scenario4", instance=t, num_scens=5)
    js = juc.scenario_creator("Scenario4", instance=j, num_scens=5)
    np.testing.assert_array_equal(ts.bl, js.bl)
    np.testing.assert_array_equal(ts.bu, js.bu)


def test_hub_seeds_the_warm_plane_at_sync_1(monkeypatch):
    """A window given a warm plane holds it in opt.state right after
    sync 1: W equal to the plane's, x̄ the node values gathered per slot,
    and the fused wheel's wstate carries the same PH state."""
    from mpisppy_tpu_torch.cylinders.hub import PHHub
    from mpisppy_tpu_torch.mpc import RollingDriver
    seen = {}
    real = PHHub._apply_warm_plane

    def probe(self, plane):
        real(self, plane)
        st = self.opt.state
        seen.update(iter=self._iter, W=st.W.numpy().copy(),
                    xbar=st.xbar.numpy().copy(),
                    xbar_nodes=st.xbar_nodes.numpy().copy(),
                    node_of_slot=self.opt.batch.node_of_slot.numpy(),
                    same=self.opt.wstate.ph is st)
    monkeypatch.setattr(PHHub, "_apply_warm_plane", probe)
    hz = thz.ccopf_horizon(soc=True, gap_target=1.0, max_step_iterations=1)
    drv = RollingDriver(hz, device="cpu")
    rng = np.random.default_rng(3)
    plane = _rand_plane(rng, S=9, nodes=4, N=hz.plan.num_nonants)
    res = drv.run_step(1, warm_plane=plane)
    assert seen["iter"] == 1 and seen["same"]
    np.testing.assert_array_equal(seen["W"], plane["W"])
    np.testing.assert_array_equal(seen["xbar_nodes"], plane["xbar_nodes"])
    cols = np.arange(hz.plan.num_nonants)
    np.testing.assert_array_equal(
        seen["xbar"], plane["xbar_nodes"][seen["node_of_slot"], cols])
    assert res.warm or res.cold_fallback
    assert set(res.plane) == {"W", "xbar_nodes", "x"}
    assert res.plane["W"].shape == (9, hz.plan.num_nonants)


def _stream_with_hubs(drv, spinner, steps):
    """drv.stream(steps) with every window's hub kept."""
    hubs = []
    real = spinner.spin

    def spin(self):
        out = real(self)
        hubs.append(self.spcomm)
        return out
    spinner.spin = spin
    try:
        return list(drv.stream(steps)), hubs
    finally:
        spinner.spin = real


def test_rolling_driver_ccopf_matches_jax():
    """2 windows of ccopf (3,3) --soc: step 0 cold, step 1 warm from the
    shifted plane, in both packages: the same warm/fallback/degraded
    flags and hub iterations, bounds within 1e-4 relative.  ROADMAP C11,
    in both: the warm window stops at hub iteration 2 by conv-thresh
    (the seeded x̄ makes ||x - x̄|| ~1e-7 at once) while its last hub
    row's inner bound is still the first x̂ candidate's, ~9x the optimum;
    at (3,3) the final harvest lands a good bound, from (10,10) up it
    does not and the driver falls back cold."""
    from mpisppy_tpu.mpc import RollingDriver as JDriver
    from mpisppy_tpu.spin_the_wheel import WheelSpinner as JSpinner
    from mpisppy_tpu_torch.mpc import RollingDriver as TDriver
    from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner as TSpinner
    j, jhubs = _stream_with_hubs(JDriver(jhz.ccopf_horizon(soc=True)),
                                 JSpinner, 2)
    t, thubs = _stream_with_hubs(
        TDriver(thz.ccopf_horizon(soc=True), device="cpu"), TSpinner, 2)
    assert [r.step for r in t] == [0, 1]
    assert [r.warm for r in t] == [r.warm for r in j] == [False, True]
    for a, b in zip(j, t):
        assert (b.cold_fallback, b.degraded, b.iterations) == (
            a.cold_fallback, a.degraded, a.iterations)
        for f in ("outer", "inner"):
            x, y = getattr(a, f), getattr(b, f)
            assert abs(x - y) <= REL * max(abs(x), 1.0), (a.step, f, x, y)
        assert b.rel_gap <= 0.01
        np.testing.assert_allclose(b.x_root, a.x_root, rtol=0, atol=1e-3)
    for hubs, res in ((jhubs, j), (thubs, t)):
        warm = hubs[-1]
        assert (warm._term_reason, warm._iter) == ("conv-thresh", 2)
        assert warm.trace[-1]["inner"] > 5.0 * res[1].outer


def _cli_line(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_uc_mpc_step_cli_matches_jax():
    """`--uc-mpc-step 1 --uc-mpc-stride 1` on uc at the JAX test's size
    (2 units, 4 hours, 3 scenarios, the uc horizon's recipe) with
    --max-iterations 1 (2 hub rows), in both CLIs: the same rows, the
    outer bound within UC_REL of the JAX CLI's and away from both CLIs'
    window 0's.
    UC_REL is the uc wheel parity test's 2e-3 (tests/test_torch_uc.py):
    the free-running f32 wheels part at the f32 floor (ROADMAP C1)."""
    from mpisppy_tpu import generic_cylinders as jgc
    from mpisppy_tpu_torch import generic_cylinders as tgc
    UC_REL = 2e-3

    def both(step):
        args = list(jhz.uc_horizon(2, 4, 1, max_step_iterations=1)
                    .step_argv(step))
        targs = [a.replace("mpisppy_tpu.", "mpisppy_tpu_torch.")
                 for a in args] + ["--device", "cpu"]
        return _cli_line(jgc.main, args), _cli_line(tgc.main, targs)
    j, t = both(1)
    assert t["iterations"] == j["iterations"] == 2
    assert t["inner_bound"] is None and j["inner_bound"] is None
    assert abs(t["outer_bound"] - j["outer_bound"]) \
        <= UC_REL * abs(j["outer_bound"]), (t, j)
    j0, t0 = both(0)
    assert abs(t0["outer_bound"] - t["outer_bound"]) \
        > 2 * UC_REL * abs(t["outer_bound"])
    # window 1 is farther than UC_REL from the JAX CLI's window 0 too
    assert abs(t["outer_bound"] - j0["outer_bound"]) \
        > UC_REL * abs(j0["outer_bound"]), (t, j0)
