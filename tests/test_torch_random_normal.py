# Port parity: scengen.random.normal against jax.random.normal, and the
# power-iteration norm estimate that draws its start vector from it.
#
# normal() writes out XLA's f32 arithmetic (Giles' ErfInv polynomial,
# XLA's log1p and CPU log, fused multiply-adds emulated in f64), so it
# is held to >= 99% bit-equal draws and at most 2 ulp anywhere over 10^6
# draws a key; on this CPU every draw is bit-equal (fraction 1.0).  The
# port's own estimate_norm, with nothing carried across from JAX, is
# held to JAX's at 1e-5 relative (before normal() the port drew with
# torch.randn and was 5.5e-2 low on farmer S=3, scenario 1).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.scengen.program import scen_key as jscen_key
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.scengen import random as trandom
from mpisppy_tpu_torch.scengen.program import scen_key as tscen_key

torch.set_num_threads(1)

N_DRAWS = 1_000_000


def ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of f32 (sign-magnitude ints)."""
    def ordered(v):
        i = np.asarray(v, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _jax_and_port(kind):
    if kind == "key7":
        return (jax.random.normal(jax.random.PRNGKey(7), (N_DRAWS,),
                                  jnp.float32),
                trandom.normal(trandom.prng_key(7), (N_DRAWS,)))
    if kind == "key3":
        return (jax.random.normal(jax.random.PRNGKey(3), (1000, 1000),
                                  jnp.float32),
                trandom.normal(trandom.prng_key(3), (1000, 1000)))
    # scen_key draws, the uc sampler's: 40,000 scenarios x 25 hours
    idx = np.arange(40_000)
    j = jax.vmap(lambda i: jax.random.normal(
        jscen_key(jax.random.PRNGKey(11), i), (25,), jnp.float32))(
        jnp.asarray(idx, jnp.int32))
    t = trandom.normal(tscen_key(trandom.prng_key(11),
                                 torch.as_tensor(idx)), (25,))
    return j, t


@pytest.mark.parametrize("kind", ["key7", "key3", "scen_key"])
def test_normal_matches_jax_random_normal(kind):
    j, t = _jax_and_port(kind)
    j, t = np.asarray(j), t.numpy()
    assert j.shape == t.shape and j.size >= N_DRAWS
    d = ulp_distance(j, t)
    assert (d == 0).mean() >= 0.99
    assert d.max() <= 2


def test_erfinv_edges_match_jax():
    """u = +-1 map to +-inf, 0 to 0, as XLA's ErfInv."""
    u = np.asarray([-1.0, -0.9999999, -0.5, 0.0, 0.3, 0.9966, 1.0],
                   np.float32)
    j = np.asarray(jax.scipy.special.erfinv(jnp.asarray(u)))
    t = trandom.erfinv(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(t, j)


def _farmer(S):
    from mpisppy_tpu.models import farmer as jm
    from mpisppy_tpu_torch.models import farmer as tm
    return ([jm.scenario_creator(f"scen{i}", num_scens=S) for i in range(S)],
            [tm.scenario_creator(f"scen{i}", num_scens=S) for i in range(S)])


def _sslp(S):
    from mpisppy_tpu.models import sslp as jm
    from mpisppy_tpu_torch.models import sslp as tm
    ji, ti = jm.synthetic_instance(5, 15), tm.synthetic_instance(5, 15)
    names = tm.scenario_names_creator(S)
    return ([jm.scenario_creator(nm, instance=ji, num_scens=S)
             for nm in names],
            [tm.scenario_creator(nm, instance=ti, num_scens=S)
             for nm in names])


def _uc(S):
    from mpisppy_tpu.models import uc as jm
    from mpisppy_tpu_torch.models import uc as tm
    ji, ti = jm.synthetic_instance(10, 24), tm.synthetic_instance(10, 24)
    names = tm.scenario_names_creator(S)
    return ([jm.scenario_creator(nm, instance=ji, num_scens=S)
             for nm in names],
            [tm.scenario_creator(nm, instance=ti, num_scens=S)
             for nm in names])


@pytest.mark.parametrize("model,S", [("farmer", 3), ("sslp", 8), ("uc", 4)])
def test_estimate_norm_matches_jax(model, S):
    """The port's own power iteration (farmer: per-scenario dense A;
    sslp 5x15: shared dense A; uc: shared ELL A) lands within 1e-5 of
    JAX's estimate, relative, on every scenario."""
    jspecs, tspecs = {"farmer": _farmer, "sslp": _sslp, "uc": _uc}[model](S)
    jb = jbatch.from_specs(jspecs)
    tb = tbatch.from_specs(tspecs, device="cpu")
    j = np.asarray(jpdhg.estimate_norm(jb.qp))
    t = tpdhg.estimate_norm(tb.qp).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5)


def test_farmer_step_condition_holds():
    """tau * sigma * ||A||^2 < 1 with the true ||A||_2 (numpy SVD) on
    every farmer scenario: the estimate is within 1e-3 of the truth
    (2e-4 low after 30 power iterations), so step_margin 0.99 keeps the
    product at ~0.98 (the torch.randn start gave ~1.10 on scenario 1)."""
    _, tspecs = _farmer(3)
    tb = tbatch.from_specs(tspecs, device="cpu")
    L = tpdhg.estimate_norm(tb.qp).numpy()
    true = np.linalg.svd(tb.qp.A.numpy().astype(np.float64),
                         compute_uv=False)[:, 0]
    margin = tpdhg.PDHGOptions().step_margin
    assert np.all(margin ** 2 * (true / L) ** 2 < 1.0)
    np.testing.assert_allclose(L, true, rtol=1e-3)
