# Port parity: the extensive form (mpisppy_tpu_torch/algos/ef.py) against
# the JAX package on the CPU.  Each package builds the EF from its own
# model's scenario specs (the models are equal spec for spec):
#   * build_ef for farmer (dense), sslp with integer recourse (dense) and
#     strengthened (ELL), and ccopf --soc on a 2x2 tree (cone blocks
#     shifted by their scenario block's row offset): c, q, A, bounds and
#     the Ruiz scaling to 1e-6 relative, the cone layout equal;
#   * root_fix_columns equal;
#   * ExtensiveForm on farmer (3 scenarios): the objective to 1e-4
#     relative of the JAX package's, and both at the known -108390.
import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ef as jef
from mpisppy_tpu.models import ccopf as jccopf
from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos import ef as tef
from mpisppy_tpu_torch.models import ccopf as tccopf
from mpisppy_tpu_torch.models import farmer as tfarmer
from mpisppy_tpu_torch.models import sslp as tsslp

torch.set_num_threads(1)


def _specs(model, case):
    if case == "farmer":
        return [model.scenario_creator(nm, num_scens=3)
                for nm in model.scenario_names_creator(3)]
    if case in ("sslp", "sslp_ell"):
        inst = model.synthetic_instance(3, 6, seed=2)
        return [model.scenario_creator(nm, instance=inst, num_scens=3,
                                       strengthen=case == "sslp_ell")
                for nm in model.scenario_names_creator(3)]
    inst = model.feeder_instance(n_buses=4)
    return [model.scenario_creator(nm, instance=inst,
                                   branching_factors=(2, 2), soc=True)
            for nm in model.scenario_names_creator(4)]


def _tree(model, case):
    if case == "ccopf":
        return model.make_tree((2, 2), model.feeder_instance(n_buses=4))
    return None


def _dense(A):
    if isinstance(A, dict):             # an EllMatrix's fields
        m, k = A["cols"].shape
        out = np.zeros((m, int(A["n"])))
        np.add.at(out, (np.repeat(np.arange(m), k), A["cols"].reshape(-1)),
                  A["vals"].reshape(-1))
        return out
    return np.asarray(A, np.float64)


def _close(t, j, rel=1e-6):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t))
    assert np.array_equal(t[~fin], j[~fin])
    assert np.all(np.abs(t[fin] - j[fin])
                  <= rel * np.maximum(1.0, np.abs(j[fin])))


@pytest.mark.parametrize("case", ["farmer", "sslp", "sslp_ell", "ccopf"])
def test_build_ef_matches_jax(case):
    jp = jef.build_ef(_specs(jfarmer if case == "farmer" else jsslp
                             if case.startswith("sslp") else jccopf, case),
                      tree=_tree(jccopf, case))
    tp = tef.build_ef(_specs(tfarmer if case == "farmer" else tsslp
                             if case.startswith("sslp") else tccopf, case),
                      tree=_tree(tccopf, case), device="cpu")
    jd, td = convert.arrays_of(jp.qp), convert.arrays_of(tp.qp)
    assert isinstance(jd["A"], dict) == (case == "sslp_ell") \
        == isinstance(td["A"], dict)
    for f in ("c", "q", "bl", "bu", "l", "u"):
        _close(td[f], jd[f])
    _close(_dense(td["A"]), _dense(jd["A"]))
    _close(tp.scaling.d_row, jp.scaling.d_row)
    _close(tp.scaling.d_col, jp.scaling.d_col)
    assert tp.n_per_scen == jp.n_per_scen
    assert np.array_equal(tp.probs, jp.probs)
    assert np.array_equal(tp.nonant_idx, jp.nonant_idx)
    if case == "ccopf":
        jc, tc = jd["cones"], td["cones"]
        for f in ("is_soc", "is_head", "seg"):
            assert np.array_equal(tc[f], jc[f]), f
        assert (tc["num_cones"], tc["max_dim"], tuple(tc["head_rows"])) \
            == (jc["num_cones"], jc["max_dim"], tuple(jc["head_rows"]))
        assert tc["num_cones"] > 0
    else:
        assert jd.get("cones") is None and td["cones"] is None
    for a, b in zip(tef.root_fix_columns(tp), jef.root_fix_columns(jp)):
        _close(a, b)


def test_extensive_form_objective_matches_jax():
    names = tfarmer.scenario_names_creator(3)
    opts = {"tol": 1e-6}
    j = jef.ExtensiveForm(opts, names, jfarmer.scenario_creator,
                          {"num_scens": 3})
    j.solve_extensive_form()
    t = tef.ExtensiveForm(opts, names, tfarmer.scenario_creator,
                          {"num_scens": 3}, device="cpu")
    st = t.solve_extensive_form()
    assert bool(st.done.all())
    jo, to = j.get_objective_value(), t.get_objective_value()
    assert to == pytest.approx(jo, rel=1e-4)
    assert to == pytest.approx(-108390.0, rel=1e-4)
    assert t.x.shape == (3, t.ef.n_per_scen)
    root = t.get_root_solution()
    assert sum(root.values()) == pytest.approx(500.0, rel=1e-3)
    # fixing the root at the EF's own first stage keeps the objective
    t.fix_root_nonants(np.asarray(list(root.values())))
    t.solve_extensive_form()
    assert t.get_objective_value() == pytest.approx(to, rel=1e-4)
