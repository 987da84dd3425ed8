# Port parity: the batched simplex QP (ops/simplex_qp.py), FWPH's inner
# solver, against the JAX package on the same numpy-seeded inputs.
# Tolerances: the sort-and-threshold projection 1e-6 (absolute, weights
# in [0, 1]); FISTA with gradient restart 1e-5 (f32 products over K <= 16
# in another order, 200 iterations); the power-iteration start vector
# (jax.random.normal(PRNGKey(3))) is drawn bit for bit by the port.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpisppy_tpu.ops import simplex_qp as jqp
from mpisppy_tpu_torch.ops import simplex_qp as tqp

torch.set_num_threads(1)


def _inputs(S=6, K=7, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(S, K, 12))
    H = np.einsum("skn,sjn->skj", V, V).astype(np.float32)
    g = rng.normal(size=(S, K)).astype(np.float32)
    valid = rng.uniform(size=(S, K)) < 0.7
    valid[:, 0] = True
    valid[1, :] = True                       # one scenario: all columns
    return H, g, valid


def test_project_simplex_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(9, 7)).astype(np.float32) * 2.0
    valid = rng.uniform(size=(9, 7)) < 0.6
    valid[:, 3] = True
    j = np.asarray(jqp.project_simplex(jnp.asarray(v), jnp.asarray(valid)))
    t = tqp.project_simplex(torch.as_tensor(v), torch.as_tensor(valid))
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)
    assert (t.numpy()[~valid] == 0.0).all()
    np.testing.assert_allclose(t.numpy().sum(-1), 1.0, atol=1e-6)


def test_estimate_L_matches_jax():
    H, _, valid = _inputs()
    j = np.asarray(jqp._estimate_L(jnp.asarray(H), jnp.asarray(valid)))
    t = tqp._estimate_L(torch.as_tensor(H), torch.as_tensor(valid))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_simplex_qp_matches_jax(warm):
    H, g, valid = _inputs()
    lam0 = None
    if warm:
        lam0 = np.abs(np.random.default_rng(2).normal(
            size=g.shape)).astype(np.float32)
    j = np.asarray(jqp.solve_simplex_qp(
        jnp.asarray(H), jnp.asarray(g), jnp.asarray(valid),
        None if lam0 is None else jnp.asarray(lam0), iters=200))
    t = tqp.solve_simplex_qp(
        torch.as_tensor(H), torch.as_tensor(g), torch.as_tensor(valid),
        None if lam0 is None else torch.as_tensor(lam0), iters=200)
    np.testing.assert_allclose(t.numpy(), j, atol=1e-5)
    assert (t.numpy()[~valid] == 0.0).all()


def test_simplex_qp_known_answer():
    """min 1/2||lam - t||^2 over the simplex is the projection of t
    (tests/test_fwph.py's case), with and without a column mask."""
    H = torch.eye(5)[None]
    t = torch.tensor([[0.4, 0.4, 0.1, 0.05, 0.05]])
    lam = tqp.solve_simplex_qp(H, -t, torch.ones(1, 5, dtype=torch.bool),
                               iters=300)
    torch.testing.assert_close(lam, t, atol=1e-4, rtol=0)
    valid = torch.tensor([[True, True, False, False, False]])
    lam2 = tqp.solve_simplex_qp(H, -t, valid, iters=300)
    assert (lam2[0, 2:] == 0).all()
    torch.testing.assert_close(lam2[0, :2], torch.full((2,), 0.5),
                               atol=1e-4, rtol=0)
