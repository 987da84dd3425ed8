# Port parity: gradient costs, Find_Rho, the rho CSV, prox_approx cuts,
# nonant sensitivities and the dynamic rho extensions
# (mpisppy_tpu_torch/utils/gradient.py, rho_utils.py, prox_approx.py,
# nonant_sensitivities.py, extensions/rho_setters.py) against the JAX
# package's, the cases of tests/test_gradient_rho.py.  Each rho is
# computed by both packages from the same PH state (test_torch_extensions
# .Twins) and held at 1e-4 of its scale; the CSV files cross between the
# packages bit for bit.  find_grad_cost solves both sides to 1e-7 from a
# cold start, so its gradients are held at 1e-4 too.
import functools

import numpy as np
import pytest
import torch

from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.utils import gradient as jgrad
from mpisppy_tpu.utils import rho_utils as jrho
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.utils import gradient as tgrad
from mpisppy_tpu_torch.utils import rho_utils as trho

from test_torch_extensions import (
    Twins, _opts, close, farmer_pair, port_state, sslp_pair,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def farmer_twins():
    jb, tb = farmer_pair()
    return Twins(jb, tb, 6)


@pytest.fixture(scope="module")
def sslp_twins():
    jb, tb = sslp_pair()
    return Twins(jb, tb, 6, default_rho=20.0, subproblem_windows=10)


@pytest.mark.parametrize("model", ["farmer", "sslp"])
def test_find_grad_cost_equals_jax(model):
    jb, tb = farmer_pair() if model == "farmer" else sslp_pair()
    if model == "farmer":
        xhat = np.array([170.0, 80.0, 250.0])
    else:
        xhat = np.array([1.0, 0.0, 1.0, 0.0, 1.0])
    opts = dict(tol=1e-7, max_iters=20_000)
    c_j = jgrad.find_grad_cost(jb, xhat, jpdhg.PDHGOptions(**opts))
    c_t = tgrad.find_grad_cost(tb, xhat, tpdhg.PDHGOptions(**opts))
    assert c_t.dtype == np.float64 and c_t.shape == c_j.shape
    close(c_t, c_j, "gradient costs")
    if model == "farmer":
        # farmer's first-stage cost: 150, 230, 260 $/acre (linear)
        np.testing.assert_allclose(
            c_t, -np.array([[150.0, 230.0, 260.0]] * 3), rtol=1e-4)


def test_order_stat_aggregate_equals_jax():
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.1, 10.0, (7, 4))
    p = rng.uniform(0.0, 1.0, 7)
    p /= p.sum()
    for a in (0.0, 0.1, 0.25, 0.5, 0.7, 1.0):
        np.testing.assert_array_equal(
            tgrad.order_stat_aggregate(rho, p, a),
            jgrad.order_stat_aggregate(rho, p, a))
    np.testing.assert_allclose(
        tgrad.order_stat_aggregate(np.array([[1.0, 4.0], [3.0, 8.0]]),
                                   np.array([0.5, 0.5]), 0.5), [2.0, 6.0])
    with pytest.raises(ValueError):
        tgrad.order_stat_aggregate(rho, p, 1.5)
    x, xb = rng.normal(size=(7, 4)), rng.normal(size=(7, 4))
    x[0, 1] = xb[0, 1]
    for f in ("w_denom", "prox_denom"):
        np.testing.assert_array_equal(getattr(tgrad, f)(x, xb),
                                      getattr(jgrad, f)(x, xb))


@pytest.mark.parametrize("model", ["farmer", "sslp"])
@pytest.mark.parametrize("mode", ["w", "prox", "indep"])
def test_find_rho_equals_jax(farmer_twins, sslp_twins, model, mode):
    tw = farmer_twins if model == "farmer" else sslp_twins
    j, t = tw.at(4)
    cfg = {"grad_order_stat": 0.3}
    kw = {"indep_denom": True} if mode == "indep" \
        else {"denom_kind": mode}
    rj = jgrad.Find_Rho(j, cfg).compute_rho(**kw)
    rt = tgrad.Find_Rho(t, cfg).compute_rho(**kw)
    assert rt.shape == (t.batch.num_nonants,)
    assert np.isfinite(rt).all() and (rt >= 0).all()
    close(rt, rj, f"{model} {mode}")


def test_rho_csv_crosses_packages(tmp_path):
    rho = np.array([1.5, 2.0, 0.25, 1.0 / 3.0], np.float32)
    fj, ft = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jrho.rhos_to_csv(rho, fj)
    trho.rhos_to_csv(rho, ft)
    assert open(fj).read() == open(ft).read()
    np.testing.assert_array_equal(trho.rhos_from_csv(fj, 4), rho)
    np.testing.assert_array_equal(jrho.rhos_from_csv(ft, 4), rho)
    with open(tmp_path / "bad.csv", "w") as f:
        f.write("ID,rho\n7,1.0\n")
    with pytest.raises(ValueError, match="out of range"):
        trho.rhos_from_csv(str(tmp_path / "bad.csv"), 4)
    _, tb = farmer_pair()
    jrho.rhos_to_csv(rho[:3], fj)
    setter = tgrad.Set_Rho({"rho_file_in": fj})
    np.testing.assert_array_equal(setter.rho_setter(tb), rho[:3])
    # PH takes it as its starting rho
    algo = tph.PH(_opts(tph, tpdhg), tb, rho_setter=setter.rho_setter)
    np.testing.assert_array_equal(algo.rho.numpy(), rho[:3])


def test_prox_approx_equals_jax():
    from mpisppy_tpu.utils.prox_approx import ProxApproxManager as JM
    from mpisppy_tpu_torch.utils.prox_approx import (
        ProxApproxManager, tangent_cut,
    )

    s, b = tangent_cut(np.array(2.0))
    xs = np.linspace(-5, 5, 101)
    assert (s * xs + b <= xs * xs + 1e-12).all()
    assert s * 2.0 + b == pytest.approx(4.0)
    jm, tm = JM(3, tol=1e-3), ProxApproxManager(3, tol=1e-3)
    pts = np.array([3.7, -1.2, 0.4])
    for _ in range(30):
        if tm.check_and_add(pts) == 0:
            break
        jm.check_and_add(pts)
    assert tm.cuts == jm.cuts
    for i, x in enumerate(pts):
        assert x * x - tm.evaluate(i, float(x)) <= 1e-3
        for xx in np.linspace(-6, 6, 25):
            assert tm.evaluate(i, float(xx)) <= xx * xx + 1e-9


@pytest.mark.parametrize("model", ["farmer", "sslp"])
def test_sensitivities_equal_jax(farmer_twins, sslp_twins, model):
    from mpisppy_tpu.utils.nonant_sensitivities import (
        nonant_sensitivities as jsens,
    )
    from mpisppy_tpu_torch.utils.nonant_sensitivities import (
        nonant_sensitivities,
    )

    tw = farmer_twins if model == "farmer" else sslp_twins
    j, t = tw.at(0)
    sj = jsens(j.batch, j.state.solver)
    st = nonant_sensitivities(t.batch, t.state.solver)
    assert st.dtype == np.float64 and st.shape == sj.shape
    assert np.isfinite(st).all()
    # a reduced cost is c + q x + A'y: at an optimal nonant it cancels to
    # f32 noise of the cost's scale, so that is the scale held
    from mpisppy_tpu_torch.extensions.rho_setters import _orig_cost_per_slot
    scale = max(np.abs(sj).max(), _orig_cost_per_slot(t.batch).max())
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("name,hook,k", [
    ("SensiRho", "post_iter0", 0), ("ReducedCostsRho", "post_iter0", 0),
    ("MultRhoUpdater", "miditer", 2), ("Gradient_extension", "miditer", 2),
    ("Gradient_extension", "miditer", 3)])
def test_dynamic_rho_extensions_equal_jax(farmer_twins, sslp_twins, name,
                                          hook, k):
    from mpisppy_tpu.extensions import rho_setters as jrs
    from mpisppy_tpu_torch.extensions import rho_setters as trs

    kw = {"Gradient_extension": {"grad_rho_update_interval": 2},
          "MultRhoUpdater": {"mult_rho_update_factor": 3.0}}.get(name, {})
    # the sensitivity rhos on sslp, whose iter0 nonants sit at their
    # bounds with nonzero reduced costs (farmer's cancel to f32 noise)
    tw = sslp_twins if hook == "post_iter0" else farmer_twins
    j, t = tw.at(k)
    rho0 = t.state.rho.numpy().copy()
    getattr(getattr(jrs, name)(j, **kw), hook)()
    getattr(getattr(trs, name)(t, **kw), hook)()
    close(t.state.rho.numpy(), j.state.rho, name)
    close(t.rho.numpy(), j.rho, name)
    moved = not np.array_equal(t.state.rho.numpy(), rho0)
    # Gradient_extension acts at iteration 2 and every 2 after: not at 3
    assert moved == (k != 3), (name, k)


def test_dynamic_rho_extensions_run_in_port_ph():
    """The JAX test's runs through the port's PH loop: the multiplicative
    schedule raises rho, SensiRho moves it off the default, and the
    gradient rho updates mid-run without breaking PH."""
    from mpisppy_tpu_torch.extensions.rho_setters import (
        Gradient_extension, MultRhoUpdater, SensiRho,
    )

    _, tb = farmer_pair()
    opts = _opts(tph, tpdhg, max_iterations=8, conv_thresh=0.0)
    algo = tph.PH(opts, tb, extensions=functools.partial(
        MultRhoUpdater, mult_rho_update_factor=2.0,
        mult_rho_update_interval=2))
    algo.ph_main()
    assert float(algo.state.rho[0]) == 16.0   # iterations 2, 4, 6, 8
    algo = tph.PH(opts, tb, extensions=SensiRho)
    algo.ph_main()
    assert not np.allclose(algo.state.rho.numpy(), 1.0)
    algo = tph.PH(opts, tb, extensions=functools.partial(
        Gradient_extension, grad_rho_update_interval=3))
    _, eobj, _ = algo.ph_main()
    assert np.isfinite(eobj) and (algo.state.rho.numpy() > 0).all()


def test_gradient_extension_reads_nothing_between_updates(farmer_twins,
                                                          monkeypatch):
    """Off its cadence the gradient rho hook leaves the device alone: no
    tensor of the state is read to the host."""
    from mpisppy_tpu_torch.extensions.rho_setters import Gradient_extension

    _, t = farmer_twins.at(3)
    ext = Gradient_extension(t, grad_rho_update_interval=2)
    reads = []
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: reads.append(1) or self)
    ext.miditer()
    assert reads == []
    t.state = port_state(farmer_twins.states[3])
