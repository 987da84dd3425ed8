# The remaining models through the port's CLI on the CPU: each model
# module of mpisppy_tpu_torch/models through generic_cylinders.main
# (`--device cpu`, in this process) with the fused wheel, the Lagrangian
# and x̂-x̄ spokes capped at 2 hub iterations, against the JAX package's
# CLI with the same flags on the same model: the outer and inner bounds
# of the final JSON line agree to 1e-3 relative (tests/test_torch_wheel.py's
# bound agreement; a bound the JAX CLI does not publish at that depth
# must be missing in the port's line too), and hydro and aircond's trees
# come from --branching-factors (on three stages the x̄ spoke is the
# root-fixed EF spoke).  sizes' and battery's outer bound at that depth
# is iter0's trivial bound, a dual value at an iterate whose solves run
# to their window cap in both packages, where the PDHG primal weight
# follows rounding noise (ROADMAP C1): the two packages publish other
# valid bounds there, so for those two models both packages' bounds must
# bracket the HiGHS optimum of the extensive form instead (to 1e-4
# relative).  --EF prints the JAX CLI's EF objective to 1e-4 relative
# where the JAX CLI's EF converges.
import contextlib
import importlib
import io
import json

import pytest
import torch

from mpisppy_tpu import generic_cylinders as jgc
from mpisppy_tpu_torch import generic_cylinders as tgc

from test_torch_models_paths import highs_ef

torch.set_num_threads(1)

WHEEL = ["--fused-wheel", "--lagrangian", "--xhatxbar", "--max-iterations",
         "2"]
# model -> its flags at a small size
MODELS = {
    "gbd": ["--num-scens", "5"],
    "sizes": ["--num-scens", "3"],
    "apl1p": ["--num-scens", "6"],
    "netdes": ["--num-scens", "4"],
    "battery": ["--num-scens", "6", "--battery-use-lp"],
    "usar": ["--num-scens", "4"],
    "aircond": ["--branching-factors", "2", "2"],
    "hydro": ["--branching-factors", "3", "3"],
}
BOUND_REL = 1e-3
EF_REL = 1e-4
# held by the bracket (C1), not to the JAX CLI's bounds
ITER0_BOUND = ("sizes", "battery")


def _last_line(main, pkg, model, args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = main(["--module-name", f"{pkg}.models.{model}", *args])
    return json.loads(out.getvalue().strip().splitlines()[-1]), ret


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_cli_matches_jax(model):
    args = MODELS[model] + WHEEL
    jres, _ = _last_line(jgc.main, "mpisppy_tpu", model, args)
    tres, ws = _last_line(tgc.main, "mpisppy_tpu_torch", model,
                          args + ["--device", "cpu"])
    assert ws.opt.batch.device.type == "cpu"
    assert tres["iterations"] == jres["iterations"]
    if model in ITER0_BOUND:
        mod = importlib.import_module(f"mpisppy_tpu.models.{model}")
        names, kwargs, tree = jgc._model_plumbing(
            jgc._parse_args(mod, MODELS[model]), mod)
        opt = highs_ef([mod.scenario_creator(nm, **kwargs)
                        for nm in names], tree)
        tol = EF_REL * abs(opt)
        for res in (jres, tres):
            assert res["outer_bound"] <= opt + tol
            assert res["inner_bound"] is None \
                or res["inner_bound"] >= opt - tol
        return
    for key in ("outer_bound", "inner_bound"):
        j, t = jres[key], tres[key]
        assert (j is None) == (t is None), key
        if j is not None:
            assert abs(t - j) <= BOUND_REL * max(1.0, abs(j)), (key, t, j)
    if model in ("aircond", "hydro"):
        names = [type(sp).__name__ for sp in ws.spcomm.spokes]
        assert "EFXhatInnerBound" in names


@pytest.mark.parametrize("model", ["gbd", "apl1p", "usar", "aircond",
                                   "hydro"])
def test_model_cli_ef_matches_jax(model):
    jres, _ = _last_line(jgc.main, "mpisppy_tpu", model,
                         MODELS[model] + ["--EF"])
    tres, _ = _last_line(tgc.main, "mpisppy_tpu_torch", model,
                         MODELS[model] + ["--EF", "--device", "cpu"])
    assert jres["converged"] and tres["converged"]
    assert abs(tres["EF_objective"] - jres["EF_objective"]) <= \
        EF_REL * abs(jres["EF_objective"])
