# The port's trace toolbox (mpisppy_tpu_torch/telemetry: analyze, spans,
# slo, watch, regress and `python -m mpisppy_tpu_torch.telemetry`)
# against the JAX package's on the same inputs:
#   * analyze and render_report on a port CLI trace, a JAX CLI trace (the
#     same farmer run as tests/test_torch_telemetry.py's) and the golden
#     farmer, dispatch and fleet traces: equal dicts (floats at 1e-12)
#     and equal text;
#   * spans.assemble / critical_path, slo.evaluate_observations and
#     watch's render_status / render_tenant_table on the same traces;
#   * regress.compare / gate on analyzer --json reports made here;
#   * every subcommand's exit code, in process against the JAX CLI's,
#     and once through a subprocess of the port's module.
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from mpisppy_tpu import generic_cylinders as jgc
from mpisppy_tpu.telemetry import __main__ as jmain
from mpisppy_tpu.telemetry import analyze as jan
from mpisppy_tpu.telemetry import regress as jregress
from mpisppy_tpu.telemetry import slo as jslo
from mpisppy_tpu.telemetry import spans as jspans
from mpisppy_tpu.telemetry import watch as jwatch
from mpisppy_tpu_torch import generic_cylinders as gc
from mpisppy_tpu_torch.telemetry import __main__ as tmain
from mpisppy_tpu_torch.telemetry import analyze as tan
from mpisppy_tpu_torch.telemetry import regress as tregress
from mpisppy_tpu_torch.telemetry import slo as tslo
from mpisppy_tpu_torch.telemetry import spans as tspans
from mpisppy_tpu_torch.telemetry import watch as twatch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIX = os.path.join(HERE, "fixtures")
GOLDEN = {name: os.path.join(FIX, f"golden_{name}_trace.jsonl")
          for name in ("farmer", "dispatch", "fleet")}
ARGS = ["--num-scens", "3", "--max-iterations", "40", "--rel-gap", "0.01",
        "--convthresh", "0", "--lagrangian", "--xhatxbar", "--fused-wheel",
        "--slammin", "--async-staleness", "1"]
TRACES = ("torch", "jax", "farmer", "dispatch", "fleet")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """The port's and the JAX package's CLI traces of the same farmer
    run (the async wheel at staleness 1), beside the golden traces."""
    d = tmp_path_factory.mktemp("tools")
    out = {"jax": str(d / "jax.jsonl"), "torch": str(d / "torch.jsonl")}
    jgc.main(["--module-name", "mpisppy_tpu.models.farmer", *ARGS,
              "--trace-jsonl", out["jax"]])
    gc.main(["--module-name", "mpisppy_tpu_torch.models.farmer", *ARGS,
             "--device", "cpu", "--trace-jsonl", out["torch"]])
    out.update(GOLDEN)
    out["dir"] = str(d)
    return out


def same(a, b, path="$"):
    """a == b, floats to 1e-12 relative (NaN equal to NaN)."""
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            path
        if math.isnan(a) or math.isnan(b):
            assert math.isnan(a) and math.isnan(b), path
        else:
            assert a == pytest.approx(b, rel=1e-12, abs=0.0), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", TRACES)
def test_analyze_and_report_equal_the_jax_package(paths, name):
    p = paths[name]
    j = jan.analyze_path(p)
    t = tan.analyze_path(p)
    same(t, j)
    assert tan.render_report(t) == jan.render_report(j)
    # one run of several: the run selection is the JAX package's too
    rows = jan.load_trace(p)
    assert tan.runs_in(tan.load_trace(p)) == jan.runs_in(rows)


def test_the_port_trace_reads_as_the_jax_trace_reads(paths):
    """The same farmer run: the port's analyzer gives its own trace the
    JAX trace's exit reason and iteration count."""
    t = tan.analyze_path(paths["torch"])
    j = tan.analyze_path(paths["jax"])
    assert t["run"]["exit"]["reason"] == j["run"]["exit"]["reason"] \
        == "converged"
    assert t["run"]["exit"]["iterations"] == j["run"]["exit"]["iterations"]
    assert t["iteration"]["count"] == j["iteration"]["count"]
    assert t["async_wheel"]["plane_writes"] > 0


def outcome(fn, *args):
    """("ok", fn(*args)) or ("raise", its error's type name and text)."""
    try:
        return ("ok", fn(*args))
    except (OSError, ValueError) as e:
        return ("raise", type(e).__name__, str(e))


@pytest.mark.parametrize("name", TRACES)
def test_spans_and_critical_path_equal_the_jax_package(paths, name):
    """A trace without trace ids (the golden farmer and dispatch traces)
    raises the same error in both packages."""
    p = paths[name]
    t, j = outcome(tspans.assemble_path, p), outcome(jspans.assemble_path, p)
    same(t, j)
    if t[0] == "ok":
        assert tspans.render_trace(t[1]) == jspans.render_trace(j[1])
    same(outcome(tspans.critical_path, tspans.load_rows(p)),
         outcome(jspans.critical_path, jspans.load_rows(p)))


@pytest.mark.parametrize("name", TRACES)
def test_slo_evaluation_equals_the_jax_package(paths, name):
    p = paths[name]
    rows = jspans.load_rows(p)
    t = tslo.evaluate_observations(tspans.load_rows(p))
    same(t, jslo.evaluate_observations(rows))
    assert tslo.render_slo(t) == jslo.render_slo(t)


@pytest.mark.parametrize("name", TRACES)
def test_watch_renders_as_the_jax_package(paths, name, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1.9e9)
    p = paths[name]
    states = {}
    for mod in (twatch, jwatch):
        st = mod.WatchState()
        with open(p) as f:
            for line in f:
                if line.strip():
                    st.feed(json.loads(line))
        states[mod] = st
    assert twatch.render_status(states[twatch]) \
        == jwatch.render_status(states[jwatch])
    assert twatch.render_tenant_table({p: states[twatch]}) \
        == jwatch.render_tenant_table({p: states[jwatch]})


def _reports(paths):
    """Analyzer --json reports of the two CLI runs, written here."""
    out = {}
    for name in ("torch", "jax"):
        f = os.path.join(paths["dir"], f"{name}.report.json")
        with open(f, "w") as fh:
            json.dump(tan.analyze_path(paths[name]), fh)
        out[name] = f
    return out


def test_compare_and_gate_equal_the_jax_package(paths):
    rep = _reports(paths)
    a, b = (jregress.load_artifact(rep[k]) for k in ("jax", "torch"))
    for old, new in ((a, b), (b, a), (a, a)):
        same(tregress.compare(old, new), jregress.compare(old, new))
        tg, jg = tregress.gate(old, new), jregress.gate(old, new)
        same(tg, jg)
        assert tregress.render_compare(tg) == jregress.render_compare(jg)
    # a synthetic regression fails both gates alike
    slow = json.loads(json.dumps(a))
    slow["iteration"]["sec_per_iter_median"] *= 2.0
    tg, jg = tregress.gate(a, slow), jregress.gate(a, slow)
    same(tg, jg)
    assert not tg["ok"]


def _argvs(paths):
    """One command line per subcommand and outcome (trace, gate and slo
    pass; a missing input, a bad threshold and a regression fail)."""
    rep = _reports(paths)
    slow = os.path.join(paths["dir"], "slow.report.json")
    with open(rep["jax"]) as f:
        r = json.load(f)
    r["iteration"]["sec_per_iter_median"] *= 2.0
    with open(slow, "w") as f:
        json.dump(r, f)
    return [
        ["analyze", "--trace-jsonl", paths["torch"]],
        ["analyze", "--trace-jsonl", paths["jax"], "--json"],
        ["analyze"],
        ["analyze", "--trace-jsonl", os.path.join(paths["dir"], "no")],
        ["watch", "--trace-jsonl", paths["farmer"], "--once"],
        ["watch", "--trace-jsonl", os.path.join(paths["dir"], "no"),
         "--once"],
        ["watch", "--once"],
        ["trace", "--trace-jsonl", paths["fleet"]],
        ["trace"],
        ["slo", "--trace-jsonl", paths["fleet"]],
        ["slo"],
        ["compare", rep["jax"], rep["torch"]],
        ["gate", rep["jax"], rep["jax"]],
        ["gate", rep["jax"], slow],
        ["gate", rep["jax"], rep["jax"], "--threshold", "nonsense"],
        ["gate", rep["jax"], os.path.join(paths["dir"], "no")],
    ]


def test_exit_codes_equal_the_jax_cli(paths, monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 1.9e9)
    seen = []
    for argv in _argvs(paths):
        t = tmain.main(list(argv))
        t_out = capsys.readouterr().out
        j = jmain.main(list(argv))
        j_out = capsys.readouterr().out
        assert t == j, argv
        assert t_out == j_out, argv
        seen.append(t)
    assert set(seen) == {0, 1, 2}


def test_module_runs_as_a_subprocess(paths, tmp_path):
    """`python -m mpisppy_tpu_torch.telemetry`, with no JAX imported:
    analyze (0), a gate regression (2), a missing input (1)."""
    rep = _reports(paths)
    code = "\n".join((
        "import runpy, sys",
        "sys.argv = ['telemetry'] + sys.argv[1:]",
        "try:",
        "    runpy.run_module('mpisppy_tpu_torch.telemetry',"
        " run_name='__main__')",
        "finally:",
        "    assert 'jax' not in sys.modules",
        "    assert 'mpisppy_tpu' not in sys.modules"))
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(*args):
        return subprocess.run([sys.executable, "-c", code, *args],
                              capture_output=True, text=True, cwd=tmp_path,
                              env=env, timeout=120)
    out = run("analyze", "--trace-jsonl", paths["torch"])
    assert out.returncode == 0, out.stderr
    assert "exit: converged" in out.stdout
    slow = tmp_path / "slow.json"
    r = json.load(open(rep["torch"]))
    r["iteration"]["sec_per_iter_median"] *= 2.0
    slow.write_text(json.dumps(r))
    assert run("gate", rep["torch"], str(slow)).returncode == 2
    assert run("analyze").returncode == 1


# ---------------------------------------------------------------------------
# the MIP plane's and scengen's telemetry
# ---------------------------------------------------------------------------
class _Events:
    def __init__(self):
        self.seen = []

    def handle(self, e):
        self.seen.append(e)

    def close(self):
        pass


@pytest.mark.parametrize("model,S", [("farmer", 32), ("sslp", 16)])
def test_scengen_event_equals_the_jax_package(model, S):
    """virtual_batch emits one `scengen` event with the JAX package's
    fields for the same program, and mirrors the build into the metrics
    (one more batch, the scenario count, the bytes it saves)."""
    import importlib

    from mpisppy_tpu import scengen as jscengen
    from mpisppy_tpu.telemetry.bus import EventBus as JBus
    from mpisppy_tpu_torch import scengen as tscengen
    from mpisppy_tpu_torch.telemetry import metrics as tmetrics
    from mpisppy_tpu_torch.telemetry.bus import EventBus as TBus
    got = {}
    for name, sg, bus_cls, kw in (
            ("jax", jscengen, JBus, {}),
            ("torch", tscengen, TBus, {"device": "cpu"})):
        mod = importlib.import_module(
            ("mpisppy_tpu" if name == "jax" else "mpisppy_tpu_torch")
            + f".models.{model}")
        sink, bus = _Events(), bus_cls()
        bus.subscribe(sink)
        before = tmetrics.REGISTRY.get("scengen_virtual_batches_total")
        vb = sg.virtual_batch(mod.scenario_program(S, seed=3), pad_to=8,
                              bus=bus, **kw)
        (ev,) = [e for e in sink.seen if e.kind == "scengen"]
        got[name] = dict(ev.data)
        if name == "torch":
            assert tmetrics.REGISTRY.get(
                "scengen_virtual_batches_total") == before + 1
            assert tmetrics.REGISTRY.get("scengen_scenarios") == S
            assert tmetrics.REGISTRY.get("scengen_data_bytes_saved") == max(
                vb.materialized_bytes() - vb.persistent_bytes(), 0)
            assert ev.data["persistent_bytes"] == vb.persistent_bytes()
    assert got["torch"].keys() == got["jax"].keys()
    # the port's index and key tensors are int64 (torch's index type)
    # where the JAX package's are 32-bit: only the resident bytes differ
    # (by tens of bytes here)
    assert 0 <= got["torch"]["persistent_bytes"] \
        - got["jax"]["persistent_bytes"] <= 64
    for k in got["jax"]:
        if k != "persistent_bytes":
            assert got["torch"][k] == got["jax"][k], k


def test_bnb_totals_equal_the_solve_and_the_jax_package():
    """solve_mip adds its nodes (BnBState.nodes_solved) and its closed
    lanes to the process totals; on random MIPs both packages close
    fully, the lanes closed equal the JAX package's."""
    import jax.numpy as jnp
    import numpy as np

    from mpisppy_tpu.ops import bnb as jbnb
    from mpisppy_tpu.telemetry import metrics as jmetrics
    from mpisppy_tpu_torch import convert
    from mpisppy_tpu_torch.ops import bnb as tbnb
    from mpisppy_tpu_torch.telemetry import metrics as tmetrics
    from test_mip_bnb import random_mips
    jqp, integer, _ = random_mips()
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), "cpu")
    ic = np.nonzero(integer)[0].astype(np.int32)
    kw = dict(pool_size=32, max_rounds=300)
    names = ("bnb_nodes_solved_total", "bnb_lanes_closed_total")
    j0 = [jmetrics.REGISTRY.get(k) for k in names]
    t0 = [tmetrics.REGISTRY.get(k) for k in names]
    j = jbnb.solve_mip(jqp, jnp.ones(jqp.c.shape[-1], jnp.float32), ic,
                       jbnb.BnBOptions(**kw))
    t = tbnb.solve_mip(tqp, torch.ones(tqp.n), ic, tbnb.BnBOptions(**kw))
    jd = [jmetrics.REGISTRY.get(k) - v for k, v in zip(names, j0)]
    td = [tmetrics.REGISTRY.get(k) - v for k, v in zip(names, t0)]
    assert td[0] == int(t.nodes_solved.sum()) > 0
    assert jd[0] == int(np.asarray(j.nodes_solved).sum())
    S = tqp.c.shape[0]
    assert td[1] == jd[1] == S
