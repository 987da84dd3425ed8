# Port parity: scenario batches, BoxQP residuals and the model builders
# of mpisppy_tpu_torch against the JAX package, on the CPU.  The same
# numpy specs go through both from_specs; the port runs Ruiz in numpy
# f64 on the f32 problem exactly as the JAX package does, so the scaled
# arrays must match bit for bit.
import numpy as np
import pytest
import torch

from mpisppy_tpu.core import batch as jbatch
from mpisppy_tpu.core import tree as jtree
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import boxqp as jboxqp
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.core import tree as ttree
from mpisppy_tpu_torch.models import farmer as tfarmer
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import boxqp as tboxqp

torch.set_num_threads(1)


def _sslp_specs(mod, S, n_servers=15, n_clients=45):
    inst = mod.synthetic_instance(n_servers, n_clients, seed=0)
    return [mod.scenario_creator(nm, instance=inst, num_scens=S,
                                 lp_relax=True)
            for nm in mod.scenario_names_creator(S)]


def _farmer_specs(mod, S):
    return [mod.scenario_creator(nm, num_scens=S)
            for nm in mod.scenario_names_creator(S)]


def _assert_batches_equal(jb, tb):
    ja, ta = convert.arrays_of(jb), convert.arrays_of(tb)
    for k in ("c", "q", "A", "bl", "bu", "l", "u"):
        np.testing.assert_array_equal(ta["qp"][k], ja["qp"][k], err_msg=k)
    for k in ("d_col", "d_row", "d_non", "p", "nonant_idx", "node_of_slot",
              "integer_slot", "integer_full"):
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    assert tb.num_real == jb.num_real
    assert tb.tree.num_nodes == jb.tree.num_nodes


@pytest.mark.parametrize("model", ["sslp", "farmer"])
def test_from_specs_matches_jax_bit_for_bit(model):
    if model == "sslp":
        jspecs, tspecs = _sslp_specs(jsslp, 16), _sslp_specs(tsslp, 16)
    else:
        jspecs, tspecs = _farmer_specs(jfarmer, 3), _farmer_specs(tfarmer, 3)
    for js, ts in zip(jspecs, tspecs):
        for f in ("c", "A", "bl", "bu", "l", "u", "nonant_idx", "integer"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    _assert_batches_equal(jbatch.from_specs(jspecs),
                          tbatch.from_specs(tspecs, device="cpu"))


@pytest.mark.parametrize("model", ["sslp", "farmer"])
def test_kkt_residuals_match_jax(model):
    """Residuals at the same random iterate agree at 1e-6 relative (f32
    reductions in another order)."""
    if model == "sslp":
        jb = jbatch.from_specs(_sslp_specs(jsslp, 16))
    else:
        jb = jbatch.from_specs(_farmer_specs(jfarmer, 3))
    tb = convert.batch_from_arrays(convert.arrays_of(jb), device="cpu")
    rng = np.random.default_rng(0)
    S, n, m = jb.num_scenarios, jb.qp.n, jb.qp.m
    x = rng.uniform(0.0, 1.0, (S, n)).astype(np.float32)
    y = rng.normal(size=(S, m)).astype(np.float32)
    jres = jboxqp.kkt_residuals(jb.qp, x, y)
    tres = tboxqp.kkt_residuals(tb.qp, torch.as_tensor(x), torch.as_tensor(y))
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)
    np.testing.assert_allclose(
        tboxqp.dual_objective(tb.qp, torch.as_tensor(x),
                              torch.as_tensor(y)).numpy(),
        np.asarray(jboxqp.dual_objective(jb.qp, x, y)), rtol=1e-6)


def test_batch_maps_match_jax_with_multistage_tree():
    """nonants / node_average (the multi-node index_add_ branch) /
    expectation / with_nonant_linear_quad / with_fixed_nonants on a
    3-stage tree over 4 farmer scenarios."""
    jt = jtree.ScenarioTree(branching_factors=(2, 2),
                            nonants_per_stage=(2, 1))
    tt = ttree.ScenarioTree(branching_factors=(2, 2),
                            nonants_per_stage=(2, 1))
    jb = jbatch.from_specs(_farmer_specs(jfarmer, 4), tree=jt)
    tb = tbatch.from_specs(_farmer_specs(tfarmer, 4), tree=tt, device="cpu")
    _assert_batches_equal(jb, tb)
    rng = np.random.default_rng(1)
    S, N = 4, 3
    vals = rng.normal(size=(S, N)).astype(np.float32)
    javg, jnodes = jb.node_average(vals)
    tavg, tnodes = tb.node_average(torch.as_tensor(vals))
    np.testing.assert_allclose(tavg.numpy(), np.asarray(javg), rtol=1e-6)
    np.testing.assert_allclose(tnodes.numpy(), np.asarray(jnodes), rtol=1e-6)
    x = rng.uniform(0, 100, (S, jb.qp.n)).astype(np.float32)
    np.testing.assert_allclose(tb.nonants(torch.as_tensor(x)).numpy(),
                               np.asarray(jb.nonants(x)), rtol=1e-7)
    np.testing.assert_allclose(
        float(tb.expectation(torch.as_tensor(vals[:, 0]))),
        float(jb.expectation(vals[:, 0])), rtol=1e-6)
    w = rng.normal(size=(S, N)).astype(np.float32)
    rho = np.full(N, 3.0, np.float32)
    jq = jb.with_nonant_linear_quad(w, rho)
    tq = tb.with_nonant_linear_quad(torch.as_tensor(w), torch.as_tensor(rho))
    np.testing.assert_array_equal(tq.c.numpy(), np.asarray(jq.c))
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    xhat = np.array(jnodes)
    jf = jb.with_fixed_nonants(xhat)
    tf = tb.with_fixed_nonants(torch.as_tensor(xhat))
    np.testing.assert_array_equal(tf.l.numpy(), np.asarray(jf.l))
    np.testing.assert_array_equal(tf.u.numpy(), np.asarray(jf.u))


def test_pad_to_multiple_matches_jax():
    jb = jbatch.pad_to_multiple(
        jbatch.from_specs(_sslp_specs(jsslp, 5, 5, 15)), 4)
    tb = tbatch.pad_to_multiple(
        tbatch.from_specs(_sslp_specs(tsslp, 5, 5, 15), device="cpu"), 4)
    assert tb.num_scenarios == 8 and tb.num_real == 5
    _assert_batches_equal(jb, tb)


def test_parse_dat_matches_jax(tmp_path):
    """SIPLIB AMPL .dat subset: scalars, indexed lists and a table."""
    path = tmp_path / "Scenario1.dat"
    path.write_text(
        "# sslp scenario\n"
        "param NumServers := 2 ;\n"
        "param NumClients := 3 ;\n"
        "param FixedCost := 1 40 2 55 ;\n"
        "param Capacity := 60 ;\n"
        "param ClientPresent := 1 1 2 0 3 1 ;\n"
        "param Demand :\n 1 2 :=\n 1 5 7\n 2 3 9\n 3 4 1 ;\n")
    jd, td = jsslp.parse_dat(str(path)), tsslp.parse_dat(str(path))
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]))
    assert td["Demand"].shape == (3, 2)


def test_precision_aliases_all_kept():
    from mpisppy_tpu.ops.boxqp import PRECISION_ALIASES as jaliases
    assert set(tboxqp.PRECISION_ALIASES) == set(jaliases)
    assert tboxqp.as_precision("high") == "bf16x3"
    assert tboxqp.as_precision("HIGHEST") == "f32"
    with pytest.raises(ValueError, match="valid aliases"):
        tboxqp.as_precision("bf16x4")


def test_entry_points_default_to_cuda():
    """Without device="cpu" the builders run on CUDA, and raise where
    there is none — never a silent CPU fallback."""
    specs = _sslp_specs(tsslp, 2, 5, 15)
    if torch.cuda.is_available():
        assert tbatch.from_specs(specs).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbatch.from_specs(specs)
