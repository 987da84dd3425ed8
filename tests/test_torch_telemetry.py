# The port's telemetry spine (mpisppy_tpu_torch/telemetry) against the
# JAX package's:
#   * a port farmer CLI run with --trace-jsonl (the async wheel at
#     staleness 1) reads back through the JAX package's
#     `telemetry analyze` with the JAX CLI run's exit reason, iteration
#     count and async row (plane writes, staleness mean/max, a host
#     share on the stale side);
#   * both CLIs' traces of that run hold the same event kinds, each with
#     the same field names, in the same JSONL line layout, and the same
#     set of span names (the PH solve spans included); the event
#     taxonomy and the metric names are the JAX package's;
#   * the metrics snapshot is written atomically and parses; the flight
#     recorder dumps on an error; global_toc prints as before without
#     telemetry and joins the trace with it.
import json
import os
import re

import numpy as np
import pytest
import torch

from mpisppy_tpu import generic_cylinders as jgc
from mpisppy_tpu.telemetry import analyze as an
from mpisppy_tpu.telemetry import events as jevents
from mpisppy_tpu.telemetry import metrics as jmetrics
from mpisppy_tpu_torch import generic_cylinders as gc
from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch import telemetry as tel
from mpisppy_tpu_torch.algos import fused_wheel as fw
from mpisppy_tpu_torch.algos import ph as ph_mod
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.cylinders.hub import PHHub
from mpisppy_tpu_torch.cylinders.spoke import FusedLagrangianOuterBound
from mpisppy_tpu_torch.extensions.extension import Extension
from mpisppy_tpu_torch.models import farmer
from mpisppy_tpu_torch.spin_the_wheel import WheelSpinner
from mpisppy_tpu_torch.telemetry import events, flightrec, metrics

torch.set_num_threads(1)

ARGS = ["--num-scens", "3", "--max-iterations", "40", "--rel-gap", "0.01",
        "--convthresh", "0", "--lagrangian", "--xhatxbar", "--fused-wheel",
        "--slammin", "--async-staleness", "1"]


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """The same CLI run in both packages, each with --trace-jsonl (the
    port's also with --metrics-snapshot)."""
    d = tmp_path_factory.mktemp("traces")
    paths = {"jax": str(d / "jax.jsonl"), "torch": str(d / "torch.jsonl")}
    jgc.main(["--module-name", "mpisppy_tpu.models.farmer", *ARGS,
              "--trace-jsonl", paths["jax"]])
    ws = gc.main(["--module-name", "mpisppy_tpu_torch.models.farmer",
                  *ARGS, "--device", "cpu", "--trace-jsonl", paths["torch"],
                  "--metrics-snapshot", str(d / "metrics.prom"),
                  "--metrics-every-s", "0"])
    return paths, ws, d


def _report(path):
    return an.analyze(an.build_run_model(an.load_trace(path)))


def test_jax_analyzer_reads_the_port_trace(traces):
    paths, ws, _ = traces
    rep, jrep = _report(paths["torch"]), _report(paths["jax"])
    assert rep["run"]["exit"]["reason"] == jrep["run"]["exit"]["reason"] \
        == "converged"
    assert rep["run"]["exit"]["iterations"] \
        == jrep["run"]["exit"]["iterations"] == ws.spcomm._iter
    assert rep["iteration"]["count"] == jrep["iteration"]["count"]
    assert rep["run"]["hub_class"] == "AsyncPHHub"
    aw, jaw = rep["async_wheel"], jrep["async_wheel"]
    for key in ("plane_writes", "staleness_mean", "staleness_max",
                "syncs"):
        assert aw[key] == jaw[key], key
    assert aw["plane_writes"] == ws.spcomm._iter - 1
    assert aw["staleness_mean"] == 1.0 and aw["staleness_max"] == 1
    assert 0.0 < aw["overlapped_host_frac"] <= 1.0
    assert 0.0 <= aw["theta_min"] <= aw["theta_last"] <= 1.0
    assert "async wheel" in an.render_report(rep)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_event_kinds_and_fields_match_the_jax_cli(traces):
    paths, _, _ = traces

    def schema(path):
        out = {}
        for r in _rows(path):
            out.setdefault(r["kind"], set()).update(r["data"])
        return out

    def layouts(path):
        return {tuple(r) for r in _rows(path)}

    assert schema(paths["torch"]) == schema(paths["jax"])
    assert layouts(paths["torch"]) == layouts(paths["jax"])


def test_span_names_match_the_jax_cli(traces):
    """The set of SPAN names of the two CLI traces is the same, the PH
    solve phases (iter0_solve, subproblem_solve) included, and the JAX
    analyzer's per-phase breakdown of the port's trace carries them."""
    paths, _, _ = traces

    def names(path):
        return {r["data"]["name"] for r in _rows(path) if r["kind"] == "span"}

    assert names(paths["torch"]) == names(paths["jax"])
    assert {"iter0_solve", "subproblem_solve", "harvest",
            "checkpoint"} <= names(paths["torch"])
    rep = _report(paths["torch"])
    phases = json.dumps(rep)
    assert "subproblem_solve" in phases and "iter0_solve" in phases


def test_event_line_layout_and_taxonomy_equal_the_jax_package():
    kw = dict(kind="hub-iteration", seq=7, t_wall=1.5, t_mono=2.5,
              run="r1", cyl="hub", hub_iter=3, trace_id="a" * 32,
              span_id="b" * 16,
              data={"outer": float("-inf"), "conv": np.float32(0.5),
                    "iter": 3})
    port = events.Event(**kw).to_json()
    port_t = events.Event(**{**kw, "data": {**kw["data"],
                                            "conv": torch.tensor(0.5)}})
    assert port == jevents.Event(**kw).to_json()
    assert port_t.to_json() == port
    assert events.ALL_KINDS == jevents.ALL_KINDS
    assert metrics.ALL_METRICS == jmetrics.ALL_METRICS
    assert metrics.SNAPSHOT_SCHEMA == jmetrics.SNAPSHOT_SCHEMA


def test_metrics_snapshot_is_atomic_and_parses(traces, monkeypatch):
    _, ws, d = traces
    text = (d / "metrics.prom").read_text()
    samples = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        name, value = line.rsplit(" ", 1)
        samples[name] = float(value)
    assert samples["async_plane_writes_total"] >= ws.spcomm._iter - 1
    assert samples['events_total{kind="plane-write"}'] \
        == ws.spcomm._iter - 1
    assert not [p for p in os.listdir(d) if ".tmp." in p]
    # every write is tmp + os.replace: a reader never sees a torn file
    replaced = []
    orig = os.replace
    monkeypatch.setattr(os, "replace",
                        lambda a, b: (replaced.append((a, b)),
                                      orig(a, b))[1])
    sink = tel.MetricsSnapshotSink(str(d / "again.prom"), every_s=0.0)
    sink.close()
    assert replaced == [(str(d / "again.prom") + f".tmp.{os.getpid()}",
                         str(d / "again.prom"))]


class _Boom(Extension):
    def enditer(self):
        if self.opt._iter == 3:
            raise RuntimeError("injected failure")


def test_flight_recorder_dumps_on_an_error(tmp_path):
    batch = batch_mod.from_specs(
        [farmer.scenario_creator(nm, num_scens=3)
         for nm in farmer.scenario_names_creator(3)], device="cpu")
    bus = tel.EventBus()
    rec = tel.FlightRecorder(capacity=4, dump_dir=str(tmp_path))
    bus.subscribe(rec)
    hub = {"hub_class": PHHub,
           "hub_kwargs": {"options": {"telemetry_bus": bus}},
           "opt_class": fw.FusedPH,
           "opt_kwargs": {"options": ph_mod.PHOptions(iter0_windows=40),
                          "batch": batch, "extensions": _Boom}}
    ws = WheelSpinner(hub, [{"spoke_class": FusedLagrangianOuterBound,
                             "opt_kwargs": {"options": {}}}])
    with pytest.raises(RuntimeError, match="injected failure"):
        ws.spin()
    path = tmp_path / f"flight-{ws.spcomm.run_id}.jsonl"
    assert rec.dumped_to == str(path)
    rows = _rows(path)
    assert rows[0]["kind"] == flightrec.HEADER_KIND
    assert "injected failure" in rows[0]["reason"]
    assert rows[-1]["kind"] == "run-end"
    assert rows[-1]["data"]["reason"] == "exception"
    assert len(rows) == 5 and rows[0]["dropped"] > 0
    rep = _report(str(path))
    assert rep["run"]["exit"]["reason"] == "exception"


def test_global_toc_is_unchanged_without_telemetry(capsys):
    global_toc("plain line")
    global_toc("hidden", False)
    out = capsys.readouterr()
    assert out.out == ""
    assert re.fullmatch(r"\[ *\d+\.\d\d\] plain line\n", out.err)
    # with a configured bus the line also lands in the trace
    seen = []

    class Probe:
        def handle(self, e):
            seen.append(e)

        def close(self):
            pass

    bus = tel.EventBus()
    bus.subscribe(Probe())
    tel.console.attach(bus)
    try:
        global_toc("traced line")
    finally:
        tel.console.detach(bus)
    assert [(e.kind, e.data["msg"]) for e in seen] == [
        ("console", "traced line")]
    assert "traced line" in capsys.readouterr().err
