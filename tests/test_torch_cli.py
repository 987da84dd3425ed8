# The port's CLI, `python -m mpisppy_tpu_torch` (generic_cylinders.py):
# the `[]` and `["--fused-wheel", "--slammin"]` cases of
# tests/test_config_cli.py::test_cli_end_to_end run on the CPU
# (`--device cpu`) in a subprocess, with the same asserts on the last
# JSON line (rel_gap <= 0.01, the inner bound within 5e-3 of the farmer
# EF value -108390).  A flag of the JAX package's CLI that the port does
# not implement exits non-zero naming its ROADMAP.md queue item, and the
# default device is CUDA, which raises without a card.
import json
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
    (["--EF"], 6), (["--async-staleness", "1"], 6), (["--aph-hub"], 6),
    (["--presolve"], 5), (["--dispatch-max-batch=8"], 5),
    (["--grad-rho"], 8), (["--scenarios-per-bundle", "2"], 8),
    (["--trace-jsonl", "t.jsonl"], 10), (["--kernel-counters"], 10),
    (["--checkpoint-path", "ck"], 11), (["--lane-guard"], 11)])
def test_unported_flags_are_refused(flag, item):
    name = flag[0].split("=")[0]
    with pytest.raises(SystemExit) as exc:
        gc.main(FARMER + ["--device", "cpu"] + flag)
    msg = str(exc.value.code)
    assert name in msg and f"queue A, item {item}" in msg


def test_unported_flag_exits_nonzero():
    out = _run_cli(FARMER + ["--device", "cpu", "--EF"], timeout=120)
    assert out.returncode != 0
    assert "--EF" in out.stderr and "queue A, item 6" in out.stderr
    assert out.stdout.strip() == ""


def test_fused_xhatxbar_on_a_multistage_tree_is_refused():
    """The reference maps the x̄ spoke of a fused multistage wheel to
    EFXhatInnerBound, which is not ported."""
    with pytest.raises(SystemExit, match="EFXhatInnerBound"):
        gc.main(["--module-name", "mpisppy_tpu_torch.models.ccopf",
                 "--branching-factors", "2", "2", "--soc", "--device", "cpu",
                 "--lagrangian", "--xhatxbar", "--fused-wheel"])


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
