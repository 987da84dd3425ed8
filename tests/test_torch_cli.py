# The port's CLI, `python -m mpisppy_tpu_torch` (generic_cylinders.py):
# the `[]` and `["--fused-wheel", "--slammin"]` cases of
# tests/test_config_cli.py::test_cli_end_to_end run on the CPU
# (`--device cpu`) in a subprocess, with the same asserts on the last
# JSON line (rel_gap <= 0.01, the inner bound within 5e-3 of the farmer
# EF value -108390).  The flags of the L-shaped and APH hubs, the
# Lagranger/subgradient/PH-OB/reduced-costs bound spokes and the
# cross-scenario cuts build and run their cylinders; a fused multistage
# wheel's x̄ spoke is the root-fixed EF spoke.  --EF prints the JAX CLI's EF objective (to 1e-4);
# the --dispatch-* group configures the scheduler as the JAX CLI's does,
# and the final line's dispatch counters are the scheduler's.  The async
# wheel, telemetry, checkpoint and kernel-counter flags are accepted
# (their own tests are tests/test_torch_async_wheel.py,
# test_torch_telemetry.py, test_torch_faults.py and
# test_torch_cli_resilience.py).  A flag of the JAX package's CLI that
# the port does not implement exits non-zero naming its ROADMAP.md queue
# item, and the default device is CUDA, which raises without a card.
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpisppy_tpu_torch import generic_cylinders as gc
from mpisppy_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
FARMER = ["--module-name", "mpisppy_tpu_torch.models.farmer",
          "--num-scens", "3", "--max-iterations", "40", "--rel-gap", "0.01",
          "--convthresh", "0", "--lagrangian", "--xhatxbar"]


def _run_cli(args, timeout=600):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "mpisppy_tpu_torch"] + args,
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=timeout, env=env)


@pytest.mark.parametrize("extra", [[], ["--fused-wheel", "--slammin"]])
def test_cli_end_to_end(extra):
    out = _run_cli(FARMER + ["--device", "cpu"] + extra)
    assert out.returncode == 0, out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["rel_gap"] <= 0.01
    assert payload["inner_bound"] == pytest.approx(-108390.0, rel=5e-3)
    assert payload["outer_bound"] <= payload["inner_bound"]
    assert payload["iterations"] <= 40
    assert payload["dispatch_retries"] == payload["watchdog_trips"] == 0


@pytest.mark.parametrize("flag,item", [
    (["--uc-mpc-step", "1"], 13), (["--use-primal-dual-converger"], 8),
    (["--mult-rho"], 8), (["--sensi-rho"], 8), (["--rho-file-in=r.csv"], 8),
    (["--grad-rho"], 8), (["--scenarios-per-bundle", "2"], 8),
    (["--uc-mpc-stride", "2"], 13), (["--W-fname", "w.csv"], 8),
    (["--pickle-bundles-dir", "d"], 8), (["--rho-file-out=r.csv"], 8)])
def test_unported_flags_are_refused(flag, item):
    name = flag[0].split("=")[0]
    with pytest.raises(SystemExit) as exc:
        gc.main(FARMER + ["--device", "cpu"] + flag)
    msg = str(exc.value.code)
    assert name in msg and f"queue A, item {item}" in msg


def test_fwph_and_presolve_are_accepted():
    """--presolve (FBBT on the batch) and --fwph (a classic FWPH spoke
    beside the fused planes) run: farmer certifies 1% with both."""
    ws = gc.main(FARMER + ["--device", "cpu", "--fused-wheel", "--presolve",
                           "--fwph", "--fwph-iter-limit", "1"])
    names = [type(sp).__name__ for sp in ws.spcomm.spokes]
    assert "FWPHOuterBound" in names
    assert ws.spcomm.compute_gaps()[1] <= 0.01
    assert ws.BestInnerBound == pytest.approx(-108390.0, rel=5e-3)


def test_uc_module_runs_with_fwph():
    """`--module-name mpisppy_tpu_torch.models.uc` with the JAX CLI's uc
    flags: an ELL batch through the fused wheel and the FWPH spoke; the
    rolling-horizon flag stays refused with its item."""
    uc = ["--module-name", "mpisppy_tpu_torch.models.uc", "--num-scens", "3",
          "--uc-n-gens", "3", "--uc-n-hours", "6", "--device", "cpu",
          "--fused-wheel", "--lagrangian", "--xhatxbar", "--slammax",
          "--fwph", "--max-iterations", "3"]
    ws = gc.main(uc)
    assert type(ws.opt.batch.qp.A).__name__ == "EllMatrix"
    assert math.isfinite(ws.BestOuterBound)
    with pytest.raises(SystemExit, match="queue A, item 13"):
        gc.main(uc + ["--uc-mpc-step", "1"])


def test_unported_flag_exits_nonzero():
    out = _run_cli(FARMER + ["--device", "cpu", "--uc-mpc-step", "1"],
                   timeout=120)
    assert out.returncode != 0
    assert "--uc-mpc-step" in out.stderr
    assert "queue A, item 13 (serving" in out.stderr
    assert out.stdout.strip() == ""


def test_fused_xhatxbar_on_a_multistage_tree_runs_the_root_fixed_ef():
    """The x̄ spoke of a fused multistage wheel is no longer refused: as
    in the JAX package it maps to EFXhatInnerBound (the root-fixed EF),
    and ccopf (3,3) --soc certifies at the JAX CLI's bounds (outer
    71.77212524, inner 71.77219395, to 1e-5)."""
    ws = gc.main(["--module-name", "mpisppy_tpu_torch.models.ccopf",
                  "--branching-factors", "3", "3", "--soc", "--device",
                  "cpu", "--lagrangian", "--xhatxbar", "--fused-wheel",
                  "--max-iterations", "20"])
    names = [type(sp).__name__ for sp in ws.spcomm.spokes]
    assert names == ["FusedLagrangianOuterBound", "EFXhatInnerBound"]
    assert ws.spcomm.compute_gaps()[1] <= 0.01
    assert ws.BestOuterBound == pytest.approx(71.77212524, rel=1e-5)
    assert ws.BestInnerBound == pytest.approx(71.77219395, rel=1e-5)


NEW_FLAGS = {
    "lshaped": (["--lshaped-hub", "--xhatlshaped", "--lshaped-max-iter",
                 "30"], "LShapedHub", ["XhatLShapedInnerBound"]),
    "lshaped_multicut": (["--lshaped-hub", "--lshaped-multicut",
                          "--xhatlshaped"], "LShapedHub",
                         ["XhatLShapedInnerBound"]),
    "aph": (["--aph-hub", "--aph-gamma", "1.0", "--aph-nu", "1.0",
             "--aph-dispatch-frac", "0.67", "--aph-use-dynamic-gamma",
             "--aph-frac-needed", "1.0", "--lagrangian", "--xhatxbar"],
            "APHHub", ["LagrangianOuterBound", "XhatXbarInnerBound"]),
    "bound_spokes": (["--lagranger", "--subgradient", "--subgradient-rho",
                      "2.0", "--ph-ob", "--ph-ob-rho-rescale-factor",
                      "0.5", "--xhatxbar"], "PHHub",
                     ["PhOuterBound", "LagrangerOuterBound",
                      "SubgradientOuterBound", "XhatXbarInnerBound"]),
    "reduced_costs": (["--reduced-costs", "--rc-fix-fraction-iterk", "0.5",
                       "--rc-bound-tightening", "--rc-zero-rc-tol", "1e-4",
                       "--rc-bound-tol", "1e-6", "--xhatxbar"], "PHHub",
                      ["ReducedCostsSpoke", "XhatXbarInnerBound"]),
    "cross_scen": (["--cross-scenario-cuts", "--cross-scenario-iter-cnt",
                    "2", "--cross-scenario-max-rounds", "4", "--lagrangian",
                    "--xhatxbar"], "PHHub",
                   ["CrossScenarioCutSpoke", "LagrangianOuterBound",
                    "XhatXbarInnerBound"]),
}


@pytest.mark.parametrize("case", list(NEW_FLAGS))
def test_newly_ported_flags_run(case):
    """Each flag of the decomposition hubs and bound spokes builds its
    hub and spokes (in the JAX CLI's order) and runs farmer S=3 to
    certified bounds around the EF value -108390: a finite outer bound
    from the hub or its outer spokes and a finite inner bound from the
    x̂ spoke."""
    flags, hub, spokes = NEW_FLAGS[case]
    base = ["--module-name", "mpisppy_tpu_torch.models.farmer",
            "--num-scens", "3", "--max-iterations", "12", "--rel-gap",
            "0.01", "--convthresh", "0", "--device", "cpu"]
    ws = gc.main(base + flags)
    assert type(ws.spcomm).__name__ == hub
    assert [type(sp).__name__ for sp in ws.spcomm.spokes] == spokes
    assert ws.BestOuterBound <= -108390.0 * (1 - 1e-3)
    assert math.isfinite(ws.BestOuterBound)
    # every case has an x̂ spoke (x̂-x̄ or x̂-L-shaped): it must publish
    assert math.isfinite(ws.BestInnerBound)
    assert ws.BestInnerBound >= ws.BestOuterBound
    assert ws.BestInnerBound == pytest.approx(-108390.0, rel=1e-2)


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gc.main(FARMER)


def test_config_groups_and_device_flag():
    cfg = Config()
    cfg.ph_args()
    cfg.lagrangian_args()
    cfg.device_args()
    cfg.parse_command_line("t", ["--default-rho", "2.5", "--lagrangian",
                                 "--max-iterations", "7", "--device", "cpu"])
    assert cfg.default_rho == 2.5 and cfg.lagrangian is True
    assert cfg.max_iterations == 7 and cfg["device"] == "cpu"
    assert cfg.get("abs_gap") is None
    fresh = Config()
    fresh.device_args()
    fresh.parse_command_line("t", [])
    assert fresh.device == "cuda"


def test_bad_iter_precision_fails_at_config_time():
    with pytest.raises(ValueError, match="valid aliases"):
        gc.main(FARMER + ["--device", "cpu", "--iter-precision", "bf17"])


def test_solution_base_name_writes_the_first_stage(tmp_path):
    """--solution-base-name writes the incumbent's root values, one
    x<i>,<value> line per first-stage slot (farmer: 3 acreages that use
    the 500 acres)."""
    base = tmp_path / "farmer"
    gc.main(FARMER + ["--device", "cpu", "--fused-wheel",
                      "--solution-base-name", str(base)])
    lines = (tmp_path / "farmer.csv").read_text().splitlines()
    assert [ln.split(",")[0] for ln in lines] == ["x0", "x1", "x2"]
    acres = [float(ln.split(",")[1]) for ln in lines]
    assert sum(acres) == pytest.approx(500.0, rel=1e-3)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_ef_flag_matches_the_jax_cli(capsys):
    """--EF solves the extensive form as one LP and prints
    {"EF_objective", "converged"}, as the JAX CLI does."""
    from mpisppy_tpu import generic_cylinders as jgc
    ef_args = ["--num-scens", "3", "--EF"]
    jgc.main(["--module-name", "mpisppy_tpu.models.farmer"] + ef_args)
    jax_out = _last_json(capsys)
    gc.main(["--module-name", "mpisppy_tpu_torch.models.farmer",
             "--device", "cpu"] + ef_args)
    out = _last_json(capsys)
    assert set(out) == set(jax_out) == {"EF_objective", "converged"}
    assert out["converged"] and jax_out["converged"]
    assert out["EF_objective"] == pytest.approx(jax_out["EF_objective"],
                                                rel=1e-4)
    assert out["EF_objective"] == pytest.approx(-108390.0, rel=1e-4)


def test_dispatch_flags_configure_the_scheduler(capsys, monkeypatch):
    """The --dispatch-* group builds the scheduler the JAX CLI builds from
    the same flags, and the final line's counters come from it."""
    import dataclasses

    from mpisppy_tpu import dispatch as jdispatch
    from mpisppy_tpu.utils.config import Config as JConfig
    from mpisppy_tpu_torch import dispatch
    flags = ["--dispatch-max-batch", "64", "--dispatch-timeout-s", "30",
             "--dispatch-coalesce", "false", "--dispatch-retry-max", "3",
             "--dispatch-bucket-growth", "1.5"]
    jcfg = JConfig()
    jcfg.dispatch_args()
    jcfg.parse_command_line("t", flags)
    try:
        jopts = dataclasses.asdict(jdispatch.from_cfg(jcfg).options)
    finally:
        jdispatch.configure()
    monkeypatch.setattr(dispatch, "scheduler_stats", lambda: {
        "batches": 0, "retries_total": 5, "quarantined_lanes": 7})
    try:
        gc.main(FARMER + ["--device", "cpu", "--fused-wheel"] + flags)
        assert dataclasses.asdict(dispatch.get_scheduler().options) == jopts
    finally:
        dispatch.configure()
    out = _last_json(capsys)
    assert out["dispatch_retries"] == 5
    assert out["dispatch_quarantined_lanes"] == 7
    assert out["rel_gap"] <= 0.01
