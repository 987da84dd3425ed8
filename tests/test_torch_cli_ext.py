# The CLI's extension, converger, rho, W/x̄ and bundle flags
# (`python -m mpisppy_tpu_torch`, generic_cylinders.main in this
# process): every one of the 21 flags parses and runs on farmer S=3 (S=6
# for the bundles) through the fused wheel at a depth of a few hub
# iterations; --grad-rho, --sensi-rho, --mult-rho and
# --use-primal-dual-converger give the JAX CLI's bounds at 1e-3 (8 hub
# iterations; measured within 2.5e-4); the W/x̄/rho files a run writes
# are the JAX CLI's format, and a second run installs them; pickled and
# unpickled bundles give the same hub rows.  Only the serving flags and
# --pallas-pipeline stay refused.
import contextlib
import io

import numpy as np
import pytest
import torch

from mpisppy_tpu import generic_cylinders as jgc
from mpisppy_tpu_torch import generic_cylinders as tgc
from mpisppy_tpu_torch.utils import rho_utils

torch.set_num_threads(1)

BASE = ["--num-scens", "3", "--rel-gap", "0.001", "--convthresh", "0",
        "--lagrangian", "--xhatxbar", "--fused-wheel"]
PORT = ["--module-name", "mpisppy_tpu_torch.models.farmer", "--device",
        "cpu"] + BASE
JAX = ["--module-name", "mpisppy_tpu.models.farmer"] + BASE

A8_FLAGS = (
    "grad_rho", "grad_order_stat", "grad_rho_update_interval",
    "grad_rho_relative_bound", "grad_rho_indep_denom", "rho_file_in",
    "rho_file_out", "sensi_rho", "sensi_rho_multiplier", "mult_rho",
    "mult_rho_update_factor", "mult_rho_update_interval",
    "use_primal_dual_converger", "primal_dual_converger_tol",
    "init_W_fname", "init_Xbar_fname", "W_fname", "Xbar_fname",
    "scenarios_per_bundle", "pickle_bundles_dir", "unpickle_bundles_dir")


def run(main, args):
    with contextlib.redirect_stdout(io.StringIO()):
        return main(args)


def rows(ws):
    return [{k: v for k, v in r.items() if k != "t"}
            for r in ws.spcomm.trace]


def test_only_three_flags_stay_refused():
    """Since the rolling-horizon flags landed, only --pallas-pipeline of
    the three stays refused."""
    assert len(A8_FLAGS) == 21
    assert set(tgc.UNPORTED_FLAGS) == {"pallas_pipeline"}
    from mpisppy_tpu_torch.models import farmer
    cfg = tgc._parse_args(farmer, PORT)
    for name in A8_FLAGS:
        assert name in cfg, name
    with pytest.raises(SystemExit, match="no port"):
        tgc._parse_args(farmer, PORT + ["--pallas-pipeline"])


@pytest.mark.parametrize("flags", [
    ["--grad-rho", "--grad-rho-update-interval", "2"],
    ["--sensi-rho"],
    ["--mult-rho"],
    ["--use-primal-dual-converger", "--primal-dual-converger-tol", "50"]],
    ids=["grad_rho", "sensi_rho", "mult_rho", "primal_dual_converger"])
def test_dynamic_rho_and_converger_flags_give_the_jax_bounds(flags):
    args = ["--max-iterations", "8"] + flags
    t = run(tgc.main, PORT + args)
    j = run(jgc.main, JAX + args)
    assert t.spcomm._iter == j.spcomm._iter
    assert t.BestOuterBound == pytest.approx(j.BestOuterBound, rel=1e-3)
    assert t.BestInnerBound == pytest.approx(j.BestInnerBound, rel=1e-3)
    rho = t.opt.state.rho.numpy()
    if "--use-primal-dual-converger" in flags:
        assert t.spcomm._iter < 8      # the converger stopped the wheel
        assert np.array_equal(rho, np.ones(3, np.float32))
    else:
        assert not np.allclose(rho, 1.0) and (rho > 0).all()


def test_flag_values_reach_the_extensions():
    """The value flags of each group land on their extension objects."""
    from mpisppy_tpu_torch.models import farmer
    cfg = tgc._parse_args(farmer, PORT + [
        "--grad-rho", "--grad-order-stat", "0.3",
        "--grad-rho-update-interval", "3", "--grad-rho-relative-bound",
        "100", "--grad-rho-indep-denom", "--sensi-rho",
        "--sensi-rho-multiplier", "2.5", "--mult-rho",
        "--mult-rho-update-factor", "1.5", "--mult-rho-update-interval",
        "4", "--use-primal-dual-converger", "--primal-dual-converger-tol",
        "0.02"])
    hub, _, _, _, _ = tgc.build_wheel(cfg, farmer)
    kw = hub["opt_kwargs"]
    ph = hub["opt_class"](**kw)
    exts = {type(e).__name__: e for e in ph.extobject.extdict.values()}
    g = exts["Gradient_extension"]
    assert (g.interval, g.indep_denom) == (3, True)
    assert g._finder.cfg == {"grad_order_stat": 0.3,
                             "grad_rho_relative_bound": 100.0}
    assert exts["SensiRho"].multiplier == 2.5
    m = exts["MultRhoUpdater"]
    assert (m.factor, m.interval) == (1.5, 4)
    assert ph.converger_object.tol == 0.02
    # the APH hub takes the converger too, the L-shaped hub ignores it
    # (as in the JAX CLI)
    for hub_flag, has in (("--aph-hub", True), ("--lshaped-hub", False)):
        cfg = tgc._parse_args(farmer, PORT + [
            hub_flag, "--use-primal-dual-converger"])
        hub, _, _, _, _ = tgc.build_wheel(cfg, farmer)
        assert (hub["opt_kwargs"].get("converger") is not None) == has


def test_wxbar_and_rho_files_write_and_read_back(tmp_path):
    w, x, r = (str(tmp_path / f) for f in ("w.csv", "x.csv", "r.csv"))
    t = run(tgc.main, PORT + [
        "--max-iterations", "4", "--mult-rho", "--W-fname", w,
        "--Xbar-fname", x, "--rho-file-out", r])
    W = t.opt.state.W.numpy()
    np.testing.assert_array_equal(rho_utils.rhos_from_csv(r, 3),
                                  t.opt.state.rho.numpy())
    assert rho_utils.rhos_from_csv(r, 3)[0] == 4.0   # rho 1 doubled twice
    # a run that stops after Iter0 shows what it installed: the file's W,
    # x̄ and rho
    t2 = run(tgc.main, PORT + [
        "--max-iterations", "0", "--init-W-fname", w,
        "--init-Xbar-fname", x, "--rho-file-in", r])
    np.testing.assert_array_equal(t2.opt.state.W.numpy(), W)
    np.testing.assert_array_equal(t2.opt.state.xbar_nodes.numpy(),
                                  t.opt.state.xbar_nodes.numpy())
    np.testing.assert_array_equal(t2.opt.state.rho.numpy(), [4.0] * 3)
    # the JAX CLI reads the port's files and warm-starts to the same
    # bounds
    args = ["--max-iterations", "3", "--init-W-fname", w,
            "--init-Xbar-fname", x, "--rho-file-in", r]
    t3, j3 = run(tgc.main, PORT + args), run(jgc.main, JAX + args)
    assert t3.BestOuterBound == pytest.approx(j3.BestOuterBound, rel=1e-3)
    assert t3.BestInnerBound == pytest.approx(j3.BestInnerBound, rel=1e-3)


def test_bundle_flags_pickle_and_unpickle(tmp_path):
    from mpisppy_tpu_torch.ops.sparse import EllMatrix

    d = str(tmp_path / "bundles")
    bun = ["--module-name", "mpisppy_tpu_torch.models.farmer", "--device",
           "cpu", "--num-scens", "6", "--scenarios-per-bundle", "3",
           "--max-iterations", "3", "--lagrangian", "--xhatxbar"]
    a = run(tgc.main, bun + ["--pickle-bundles-dir", d])
    assert isinstance(a.opt.batch.qp.A, EllMatrix)
    assert a.opt.batch.num_scenarios == 2
    assert a.opt.scenario_names == ["Bundle_0_2", "Bundle_3_5"]
    b = run(tgc.main, bun + ["--unpickle-bundles-dir", d])
    assert len(rows(a)) >= 2
    assert rows(b) == rows(a)
    with pytest.raises(AssertionError, match="can't pickle and unpickle"):
        run(tgc.main, bun + ["--pickle-bundles-dir", d,
                             "--unpickle-bundles-dir", d])
