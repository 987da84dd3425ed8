# The port's CLI (`python -m mpisppy_tpu_torch`, generic_cylinders.py)
# with the resilience and counter flags the JAX CLI takes, run in this
# process on farmer S=3 (the fused wheel with the Lagrangian and x̂-x̄
# spokes, --device cpu):
#   * --checkpoint-path: a SIGTERM sent from a hook after hub iteration 3
#     exits 75 (SystemExit) with the JAX CLI's last line {"preempted":
#     true, "checkpoint_path": ..., "iterations": 3};
#   * --checkpoint-restore resumes from that snapshot: the resumed trace's
#     first hub iteration is the snapshot's hub_iter + 1, the run
#     certifies 1%, and --checkpoint-keep / --checkpoint-every-s reach
#     the hub;
#   * a checkpoint directory holding only a corrupt file starts fresh
#     with a warning instead of crashing;
#   * --kernel-counters arms every PDHG option the run builds, and its
#     kernel-counters events read back through the JAX package's
#     `telemetry analyze`.
import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from mpisppy_tpu.telemetry import analyze as an
from mpisppy_tpu_torch import generic_cylinders as gc
from mpisppy_tpu_torch.cylinders.hub import PHHub

torch.set_num_threads(1)

FARMER = ["--module-name", "mpisppy_tpu_torch.models.farmer",
          "--num-scens", "3", "--max-iterations", "40", "--rel-gap", "0.01",
          "--convthresh", "0", "--lagrangian", "--xhatxbar",
          "--fused-wheel", "--device", "cpu"]
SIGNAL_AT = 3


def hub_rows(path):
    return [json.loads(line) for line in open(path)
            if '"hub-iteration"' in line]


def test_sigterm_exits_75_and_restore_resumes(tmp_path, monkeypatch,
                                              capsys):
    ckpt = str(tmp_path / "ck.npz")
    flags = ["--checkpoint-path", ckpt, "--checkpoint-every-s", "1e9",
             "--checkpoint-keep", "3", "--flight-dir", str(tmp_path)]
    real = PHHub._sync_epilogue

    def epilogue(self):
        real(self)
        if self._iter == SIGNAL_AT:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(5.0)   # the handler raises at this call

    monkeypatch.setattr(PHHub, "_sync_epilogue", epilogue)
    with pytest.raises(SystemExit) as exc:
        gc.main(FARMER + flags + ["--trace-jsonl",
                                  str(tmp_path / "t1.jsonl")])
    assert exc.value.code == 75
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == {
        "preempted": True, "checkpoint_path": ckpt,
        "iterations": SIGNAL_AT}
    assert "restart with --checkpoint-restore" in out.err
    assert len(list(tmp_path.glob("flight-*.jsonl"))) == 1   # black box
    with np.load(ckpt) as d:
        assert int(d["hub_iter"]) == SIGNAL_AT
    assert [r["data"]["iter"] for r in hub_rows(tmp_path / "t1.jsonl")] \
        == list(range(1, SIGNAL_AT + 1))
    monkeypatch.undo()

    t2 = str(tmp_path / "t2.jsonl")
    ws = gc.main(FARMER + flags + ["--checkpoint-restore",
                                   "--trace-jsonl", t2])
    out = capsys.readouterr()
    assert f"restored checkpoint {ckpt} at hub iter {SIGNAL_AT}" in out.err
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["rel_gap"] <= 0.01
    assert result["inner_bound"] == pytest.approx(-108390.0, rel=5e-3)
    rows = hub_rows(t2)
    assert rows[0]["data"]["iter"] == SIGNAL_AT + 1
    restores = [json.loads(line) for line in open(t2)
                if '"checkpoint-restore"' in line]
    assert len(restores) == 1 and restores[0]["data"]["path"] == ckpt
    opts = ws.spcomm.options
    assert (opts["checkpoint_keep"], opts["checkpoint_every_s"]) == (3, 1e9)


def test_corrupt_only_directory_starts_fresh(tmp_path, capsys):
    ckpt = str(tmp_path / "ck.npz")
    with open(ckpt, "wb") as f:
        f.write(b"not a checkpoint")
    ws = gc.main(FARMER + ["--checkpoint-path", ckpt,
                           "--checkpoint-restore"])
    out = capsys.readouterr()
    assert "WARNING: no valid checkpoint to restore" in out.err
    assert "starting fresh" in out.err
    assert ws.spcomm.trace[0]["iter"] == 1
    assert json.loads(out.out.strip().splitlines()[-1])["rel_gap"] <= 0.01


def test_kernel_counters_flag_reads_back_through_jax_analyze(tmp_path):
    path = str(tmp_path / "kc.jsonl")
    ws = gc.main(FARMER + ["--kernel-counters", "--trace-jsonl", path])
    assert ws.opt.options.pdhg.telemetry
    wopts = ws.opt.wheel_options
    assert wopts.lag_pdhg.telemetry and wopts.xhat_pdhg.telemetry
    assert ws.opt.state.solver.counters is not None
    rows = [json.loads(line) for line in open(path)
            if '"kernel-counters"' in line]
    assert rows and all(r["cyl"] == "hub" for r in rows)
    rep = an.analyze_path(path)
    k = rep["kernel"]["hub"]
    assert k["pdhg_iterations_total"] > 0
    assert k["pdhg_windows_total"] > 0
    assert rep["run"]["exit"]["reason"] == "converged"
