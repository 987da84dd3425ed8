# Port parity: the MMW confidence-interval CLI
# (python -m mpisppy_tpu_torch.confidence_intervals.mmw_conf) against the
# JAX package's (mpisppy_tpu.confidence_intervals.mmw_conf) on the CPU:
# the JSON line on farmer (both run in this process with the same PDHG
# options, tol 1e-6 and a 20,000-iteration cap, in place of the drivers'
# default, whose x* evaluations run a 200,000-iteration cap), its values
# to 1e-4 of the farmer objective; the refusals without --module-name or
# --xhatpath (also from a subprocess, with the exit code), and the
# warning when no start scenario is known.
import contextlib
import functools
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import pytest
import torch

from mpisppy_tpu.confidence_intervals import ciutils as jci
from mpisppy_tpu.confidence_intervals import mmw_conf as jconf
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu_torch.confidence_intervals import ciutils as tci
from mpisppy_tpu_torch.confidence_intervals import mmw_conf as tconf

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XHAT_STAR = [170.0, 80.0, 250.0]
REL, SCALE = 1e-4, 108390.0


@pytest.fixture
def xhat_path(tmp_path, monkeypatch):
    # the JAX CLI at the port's CI default (the JAX default's tol 1e-7
    # runs every solve to its 200,000-iteration cap)
    monkeypatch.setattr(jci, "gap_estimators", functools.partial(
        jci.gap_estimators, opts=jpdhg.PDHGOptions(
            tol=tci.DEFAULT_OPTS.tol, max_iters=tci.DEFAULT_OPTS.max_iters)))
    p = str(tmp_path / "xhat.npy")
    tci.write_xhat(XHAT_STAR, p)
    return p


def _line(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(args)
    return res, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_mmw_conf_json_line_matches_jax(xhat_path):
    args = ["--xhatpath", xhat_path, "--num-scens", "10",
            "--MMW-num-batches", "2", "--MMW-batch-size", "6"]
    jres, jout = _line(jconf.main, ["--module-name",
                                    "mpisppy_tpu.models.farmer"] + args)
    tres, tout = _line(tconf.main, ["--module-name",
                                    "mpisppy_tpu_torch.models.farmer",
                                    "--device", "cpu"] + args)
    assert set(tout) == set(jout) == set(tres)
    assert tout["gap_outer_bound"] == 0.0 and len(tout["Glist"]) == 2
    for k in ("gap_inner_bound", "Gbar", "std"):
        assert abs(tout[k] - jout[k]) <= REL * SCALE, (k, tout, jout)
    for a, b in zip(tout["Glist"], jout["Glist"]):
        assert abs(a - b) <= REL * SCALE
    assert tres["Gbar"] >= 0.0


@pytest.mark.parametrize("drop,msg", [
    ("--module-name", "--module-name is required"),
    ("--xhatpath", "--xhatpath is required")])
def test_mmw_conf_refuses_without_required_flags(xhat_path, drop, msg):
    full = {"--module-name": "mpisppy_tpu_torch.models.farmer",
            "--xhatpath": xhat_path}
    args = ["--device", "cpu", "--num-scens", "4"]
    for k, v in full.items():
        if k != drop:
            args += [k, v]
    with pytest.raises(SystemExit, match=msg):
        tconf.main(args)
    jargs = [a.replace("mpisppy_tpu_torch", "mpisppy_tpu")
             for a in args[2:]]
    with pytest.raises(SystemExit, match=msg):
        jconf.main(jargs)
    out = subprocess.run(
        [sys.executable, "-m", "mpisppy_tpu_torch.confidence_intervals."
         "mmw_conf"] + args, capture_output=True, text=True, cwd=ROOT,
        timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode != 0 and msg in out.stderr
    assert out.stdout.strip() == ""


def test_mmw_conf_warns_without_a_start_scenario(xhat_path, capsys):
    """Neither --start-scen nor --num-scens: the warning that the
    estimate may reuse the candidate's scenarios, then (no batch size)
    the third refusal, in both packages."""
    for main, mod in ((tconf.main, "mpisppy_tpu_torch.models.farmer"),
                      (jconf.main, "mpisppy_tpu.models.farmer")):
        args = ["--module-name", mod, "--xhatpath", xhat_path]
        if main is tconf.main:
            args += ["--device", "cpu"]
        with pytest.raises(SystemExit, match="--MMW-batch-size"):
            main(args)
        err = capsys.readouterr().err
        assert "neither --start-scen nor --num-scens" in err
        assert "optimistically biased" in err
