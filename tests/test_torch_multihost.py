# Port parity: the multi-process scenario mesh (tests/test_multihost.py's
# cases on mpisppy_tpu_torch/parallel/, gloo over a FileStore under
# tmp_path): two ranks print the same global conv; a rank dies in the
# middle of a sharded fused wheel, the survivor exits 75 holding the
# iteration-4 synchronized snapshot, and a relaunch at a world of one
# re-pads the scenario axis (14 -> 13 rows) and certifies the gap a
# fault-free run certifies.  A live process group cannot shrink, so the
# elastic loop across processes is this relaunch.
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    return env


def _popen(args):
    return subprocess.Popen([sys.executable, "-m"] + args, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_two_process_dryrun(tmp_path):
    coord = f"file://{tmp_path / 'store'}"
    procs = [_popen(["mpisppy_tpu_torch.parallel._multihost_dryrun",
                     coord, "2", str(pid), "cpu"]) for pid in (0, 1)]
    convs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
        m = re.search(r"CONV ([\d.e+-]+) TB ([\d.e+-]+) procs (\d+) "
                      r"devices (\d+)", out)
        assert m, out
        assert m.group(3) == "2" and m.group(4) == "2", out
        convs.append(float(m.group(1)))
    assert convs[0] == convs[1]


PAT = (r"inner=([\d.e+-]+) outer=([\d.e+-]+) gap=([\d.e+-]+) "
       r"start=(\d+) iter=(\d+) devices=(\d+)")


def test_elastic_kill_one_host_round_trip(tmp_path):
    """A rank dies mid-wheel; the survivor detects it (beacon staleness
    at its harvest, or the failed collective), cannot complete the
    emergency gather without the dead peer, and exits 75 with the
    iteration-4 snapshot; the relaunch at a world of one resumes from it
    and reaches the certified gap of the fault-free run (which runs
    beside the killed pair)."""
    wd = str(tmp_path)
    mod = "mpisppy_tpu_torch.parallel._elastic_dryrun"
    coord = f"file://{tmp_path / 'store'}"
    base = _popen([mod, "baseline", wd, "cpu"])
    procs = [_popen([mod, "kill", coord, "2", str(pid), "cpu", wd])
             for pid in (0, 1)]
    outs = []
    for pid, p in enumerate(procs):
        out, err = p.communicate(timeout=240)
        outs.append(out)
        want = 75 if pid == 0 else 0   # survivor EX_TEMPFAIL, victim dies
        assert p.returncode == want, \
            f"pid {pid} rc {p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
    m = re.search(r"HOSTLOST reason=(host-lost|collective-failed) "
                  r"iter=(-?\d+) dead=\[1\] ckpt=1", outs[0])
    assert m, outs[0]
    res = subprocess.run([sys.executable, "-m", mod, "resume", wd, "cpu"],
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr
    bout, berr = base.communicate(timeout=240)
    assert base.returncode == 0, berr
    mr = re.search(r"RESUME " + PAT, res.stdout)
    mb = re.search(r"BASE " + PAT, bout)
    assert mr and mb, (res.stdout, bout)
    assert int(mr.group(4)) == 4          # resumed, not restarted
    ir, orr, gr = (float(mr.group(i)) for i in (1, 2, 3))
    ib, ob, gb = (float(mb.group(i)) for i in (1, 2, 3))
    assert gr <= 5e-3 + 1e-6 and gb <= 5e-3 + 1e-6
    slack = 5e-3 * max(abs(ir), abs(ib))
    assert orr <= ib + slack and ob <= ir + slack


@pytest.mark.slow
def test_elastic_partition_heals_without_reshard(tmp_path):
    """A partition (suppressed beacon delivery, beats 1-2) only drives
    the victim to SUSPECT; the first beat after the window heals it and
    both ranks certify the same bracket with no reshard."""
    coord = f"file://{tmp_path / 'store'}"
    mod = "mpisppy_tpu_torch.parallel._elastic_dryrun"
    procs = [_popen([mod, "partition", coord, "2", str(pid), "cpu",
                     str(tmp_path)]) for pid in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"stdout:\n{out}\nstderr:\n{err}"
        outs.append(out)
    vals = []
    for out in outs:
        m = re.search(r"PARTITION_OK inner=([\d.e+-]+) "
                      r"outer=([\d.e+-]+) gap=([\d.e+-]+) iter=(\d+) "
                      r"moves=([\w:,-]+) dead=\[\] epoch=(\d+)", out)
        assert m, out
        assert "DEAD" not in m.group(5)
        vals.append((float(m.group(1)), float(m.group(2))))
    assert vals[0] == vals[1]
    moves0 = re.search(r"moves=([\w:,-]+)", outs[0]).group(1).split(",")
    assert "1:SUSPECT" in moves0, outs[0]
    assert "1:UP" in moves0[moves0.index("1:SUSPECT"):], outs[0]
