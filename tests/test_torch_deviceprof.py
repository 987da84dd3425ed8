# The port's device profile (mpisppy_tpu_torch/telemetry/{profiler,
# deviceprof,roofline}.py and the window work model of
# ops/pdhg_window.py), on the CPU:
#   * the reader on a kineto-shaped chrome trace built here (kernels, a
#     window launch with its work record, copies, a memset, the hub's
#     sync and phase ranges at known ts/dur): the timeline, the busy
#     share, overlap_frac, the median step and the per-kernel least
#     time against hand-computed values;
#   * _union, _intersect_len and _median against the JAX module's on
#     seeded random intervals;
#   * the work model against the least-time bounds PERF.md's kernel
#     table gives for K1, K2 and the SOC window (NVIDIA H100 80GB HBM3
#     peaks), at S=10,000, 100,000 and the 64-scenario, 160-iteration
#     tail;
#   * ProfilerSession on a real CPU capture of the farmer S=3 wheel
#     through the CLI (--profile-dir --profile-iters 1): the capture's
#     layout, `captured` only after the file lands, one window per
#     session, the report beside it, the analyzer's auto-discovery; an
#     unwritable dir degrades to a warning and the run ends as usual;
#   * the in-memory reading of a profile equals its exported file's.
import gzip
import json
import math
import os
import random

import pytest
import torch

from mpisppy_tpu.telemetry import roofline as jroofline
from mpisppy_tpu_torch import generic_cylinders as gc
from mpisppy_tpu_torch.telemetry import analyze as tan
from mpisppy_tpu_torch.telemetry import deviceprof as dp
from mpisppy_tpu_torch.telemetry import regress, roofline
from mpisppy_tpu_torch.telemetry.profiler import ProfilerSession

torch.set_num_threads(1)

H100 = roofline.H100_SXM
FARMER = ["--module-name", "mpisppy_tpu_torch.models.farmer",
          "--num-scens", "3", "--convthresh", "0", "--lagrangian",
          "--xhatxbar", "--fused-wheel", "--slammin", "--device", "cpu"]
WORK = ("pdhg_window/bf16x3/resident[S=8 m=4 n=6 it=40 bytes=1000 "
        "f32_flops=2000 bf16_flops=3000]")


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1 if tid > 50
            else 0, "tid": tid, "ts": ts, "dur": dur, "args": args}


def kineto_trace():
    """A chrome trace as kineto writes one: host thread 100, stream 7."""
    return {"schemaVersion": 1,
            "deviceProperties": [{"id": 0, "name": H100}],
            "traceEvents": [
                {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
                 "args": {"name": "python"}},
                _x("user_annotation", "wheel_sync#3", 1000, 50, 100),
                _x("user_annotation", "wheel/harvest", 1010, 20, 100),
                _x("user_annotation", WORK, 1100, 10, 100),
                _x("cuda_runtime", "cudaLaunchKernel", 1102, 5, 100,
                   correlation=7),
                _x("cuda_runtime", "cudaLaunchKernel", 1300, 5, 100,
                   correlation=8),
                _x("cpu_op", "aten::add", 1299, 8, 100),
                _x("user_annotation", "wheel_sync#4", 2000, 50, 100),
                _x("kernel", "void pdhg_window_resident<3, false>(...)",
                   1200, 100, 7, correlation=7),
                _x("kernel", "void at::native::vectorized_elementwise_"
                   "kernel<4, add>(...)", 1350, 50, 7, correlation=8),
                _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1380,
                   40, 7, bytes=4096),
                _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 2100,
                   10, 7, bytes=1_000_000),
                _x("gpu_memset", "Memset (Device)", 2200, 5, 7,
                   bytes=1000),
                _x("Trace", "PyTorch Profiler (0)", 0, 9999, 0),
            ]}


@pytest.fixture
def capture(tmp_path):
    d = tmp_path / "prof" / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump(kineto_trace(), f)
    (d / "host.card.json").write_text(json.dumps(
        {"name": H100, "power_limit": "700.00 W"}))
    return tmp_path / "prof"


def test_reader_maps_kineto_events(capture):
    (cap,) = dp.discover_captures(str(capture))
    assert cap["trace"].endswith("host.pt.trace.json.gz")
    assert cap["card"].endswith("host.card.json")
    tl = dp.build_timeline(str(capture))
    assert tl.device_name == H100 and tl.power_limit == "700.00 W"
    assert tl.window_us == (1000, 2205)
    assert [(o.category, o.start_us, o.dur_us) for o in tl.ops] == [
        ("pdhg_window/bf16x3/resident", 1200, 100),
        ("elementwise", 1350, 50), ("memset", 2200, 5)]
    win = tl.ops[0]
    assert (win.bytes_accessed, win.flops, win.stream) == (1000, 5000, 7)
    assert dict(win.flops_by_type) == {"f32": 2000, "bf16": 3000}
    assert tl.ops[1].bytes_accessed is None      # kineto counts none
    assert [(d.bytes, d.device_to_device) for d in tl.dma] == [
        (4096, False), (1_000_000, True)]
    assert [(s.step_num, s.start_us, s.dur_us) for s in tl.steps] == [
        (3, 1000, 1000), (4, 2000, 205)]
    assert [h.name for h in tl.host_spans] == ["wheel/harvest"]


def test_roofline_on_hand_computed_values(capture):
    rep = roofline.roofline_path(str(capture))
    assert rep["schema"] == "mpisppy-tpu-deviceprof/1"
    assert rep["device"] == H100 and rep["power_limit"] == "700.00 W"
    # device activity: [1200,1300] [1350,1420] [2100,2110] [2200,2205]
    busy = 100 + 70 + 10 + 5
    assert rep["window_s"] == pytest.approx(1205e-6)
    assert rep["busy_share"] == round(busy / 1205, 4)
    assert rep["modules"]["total_s"] == pytest.approx(busy * 1e-6)
    # copies [1380,1420] [2100,2110]; kernels over them: [1380,1400]
    assert rep["overlap_frac"] == pytest.approx(20 / 50)
    assert rep["dma"]["exposed_s"] == pytest.approx(30e-6)
    # steps of 1000 and 205 us: the median is the upper middle
    assert rep["device_sec_per_iter"] == pytest.approx(1000e-6)
    assert rep["iter_source"] == "steps"
    # stream sample: the device-to-device copy (2x) and the memset
    assert rep["measured_stream_gbps"] == round(
        (2e6 + 1000) / 1e9 / 15e-6, 1)
    moved = 1000 + 1000 + 4096 + 2e6
    assert rep["achieved_hbm_gbps"] == round(moved / 1e9 / (busy * 1e-6), 1)
    assert rep["hbm_roofline_frac"] == round(
        moved / 1e9 / (busy * 1e-6) / 3350.0, 4)
    t_ops = 2000 / 67e12 + 3000 / 989e12
    assert rep["mfu"] == round(t_ops / (busy * 1e-6), 5)
    assert rep["opaque_s"] == pytest.approx(50e-6)
    k = rep["kernels"]["pdhg_window/bf16x3/resident"]
    assert k["launches"] == 1 and k["ms_per_launch"] == pytest.approx(0.1)
    least = max(1000 / 3.35e12, t_ops)
    assert k["least_s"] == round(least, 6)
    assert k["roofline_frac"] == round(least / 100e-6, 4)
    assert "roofline_frac" not in rep["kernels"][
        "void at::native::vectorized_elementwise_kernel<4, add>(...)"]
    shares = roofline.peak_shares(rep)
    assert shares and all(v <= 1.0 for v in shares.values())
    text = roofline.render_device(rep)
    assert "busy_share" in text and "pdhg_window/bf16x3/resident" in text


def test_unknown_card_reads_no_peaks(capture, tmp_path):
    (next(capture.rglob("*.card.json"))).unlink()
    raw = kineto_trace()
    raw["deviceProperties"] = [{"name": "Some Other Card"}]
    path = next(capture.rglob("*.gz"))
    with gzip.open(path, "wt") as f:
        json.dump(raw, f)
    rep = roofline.roofline_path(str(capture))
    assert rep["device"] == "Some Other Card"
    assert rep["hbm_roofline_frac"] is None and rep["mfu"] is None
    assert roofline.peak_shares(rep) == {}
    assert any("no peak rates" in n for n in rep["notes"])


def test_gate_reads_the_port_device_report(capture, tmp_path):
    rep = roofline.roofline_path(str(capture))
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps(rep))
    worse = dict(rep, overlap_frac=rep["overlap_frac"] * 0.5)
    b.write_text(json.dumps(worse))
    assert regress.gate_paths(str(a), str(a))["ok"]
    g = regress.gate_paths(str(a), str(b))
    assert not g["ok"]
    assert "device.busy_share" in regress.extract_metrics(rep)


@pytest.mark.parametrize("seed", range(5))
def test_interval_helpers_equal_the_jax_module(seed):
    rng = random.Random(seed)

    def intervals(k):
        out = []
        for _ in range(k):
            a = rng.uniform(0, 100)
            out.append((a, a + rng.choice([0.0, -1.0, rng.expovariate(
                0.2)])))
        return out
    a, b = intervals(40), intervals(25)
    for iv in (a, b, []):
        assert roofline._union(iv) == jroofline._union(iv)
    _, ma = jroofline._union(a)
    _, mb = jroofline._union(b)
    assert roofline._intersect_len(ma, mb) == jroofline._intersect_len(
        ma, mb)
    xs = [rng.random() for _ in range(rng.randint(0, 9))]
    assert roofline._median(xs) == jroofline._median(xs)


# ---------------------------------------------------------------------------
# the work model against PERF.md's bound column
# ---------------------------------------------------------------------------
def _batch(model):
    from mpisppy_tpu_torch.core import batch as batch_mod
    from mpisppy_tpu_torch.models import ccopf, sslp
    if model == "sslp":
        inst = sslp.synthetic_instance(15, 45, seed=0)
        return batch_mod.from_specs(
            [sslp.scenario_creator(nm, instance=inst, num_scens=16,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(16)], device="cpu")
    inst = ccopf.feeder_instance(n_buses=4)
    specs = [ccopf.scenario_creator(nm, instance=inst,
                                    branching_factors=(3, 3), soc=True)
             for nm in ccopf.scenario_names_creator(9)]
    return batch_mod.from_specs(specs, tree=ccopf.make_tree((3, 3), inst),
                                device="cpu")


def _work_at(qp, S, n_iters, mode):
    """window_work at S scenarios: the per-scenario fields of a small
    batch grown to S rows (uninitialized: the model reads only shapes
    and layouts), the window state of chip_smoke.py's window_inputs."""
    import dataclasses

    from mpisppy_tpu_torch.ops import pdhg_window as pw
    grown = {f: torch.empty(S, getattr(qp, f).shape[1])
             for f in ("c", "q", "l", "u", "bl", "bu")
             if getattr(qp, f).ndim == 2}
    q = dataclasses.replace(qp, **grown)
    m, n = qp.A.shape
    return pw.window_work(
        q, torch.empty(S, n), torch.empty(S, m), torch.empty(S, n),
        torch.empty(S, m), torch.empty(S), torch.empty(S),
        torch.zeros(S, dtype=torch.bool), n_iters, mode)


# (model, S, iterations, mode, PERF.md's bound ms, its printed digits)
BOUNDS = [("sslp", 10_000, 40, "f32", 1.05, 2),
          ("sslp", 10_000, 40, "bf16x3", 0.245, 3),
          ("sslp", 100_000, 40, "f32", 10.50, 2),
          ("sslp", 100_000, 40, "bf16x3", 2.45, 2),
          ("sslp", 64, 160, "f32", 0.027, 3),
          ("sslp", 64, 160, "bf16x3", 0.0063, 4),
          ("ccopf", 10_000, 40, "f32", 0.142, 3),
          ("ccopf", 10_000, 40, "bf16x3", 0.0353, 4),
          ("ccopf", 100_000, 40, "f32", 1.42, 2),
          ("ccopf", 64, 160, "f32", 0.0036, 4)]


@pytest.mark.parametrize("model,S,n_iters,mode,bound,digits", BOUNDS)
def test_work_model_gives_the_kernel_table_bounds(model, S, n_iters, mode,
                                                  bound, digits):
    w = _work_at(_batch(model).qp, S, n_iters, mode)
    ms, by = w.bound_ms(roofline.CARD_PEAKS[H100])
    assert round(ms, digits) == pytest.approx(bound)
    assert by == "operations"


def test_work_model_counts_each_byte_once():
    """sslp 15x45 at S=10,000: A, the shared l/u, the per-scenario
    c/q/bl/bu, the state read once and x, y and their sums written."""
    w = _work_at(_batch("sslp").qp, 10_000, 40, "f32")
    S, m, n = 10_000, 60, 705
    reads = 4 * (m * n + 2 * n + S * (2 * n + 2 * m)
                 + S * (2 * n + 2 * m) + 2 * S) + S
    assert w.nbytes == reads + 2 * 4 * S * (n + m)
    label = dp.parse_work(w.label("pdhg_window/f32/resident"))
    assert label["key"] == "pdhg_window/f32/resident"
    assert label["bytes"] == w.nbytes and label["S"] == S
    assert label["f32_flops"] == pytest.approx(w.f32_flops, rel=1e-12)


# ---------------------------------------------------------------------------
# ProfilerSession on a real CPU capture
# ---------------------------------------------------------------------------
def _events(path, kind):
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    return [r for r in rows if r["kind"] == kind]


def test_cli_profile_capture_on_the_cpu(tmp_path, capsys):
    prof, trace = tmp_path / "prof", tmp_path / "t.jsonl"
    ws = gc.main(FARMER + ["--max-iterations", "8", "--rel-gap", "1e-9",
                           "--profile-dir", str(prof), "--profile-iters",
                           "1", "--trace-jsonl", str(trace)])
    assert ws.spcomm._iter >= 8            # the run went on past it
    caps = dp.discover_captures(str(prof))
    assert len(caps) == 1                  # one window: never re-armed
    cap = caps[0]
    assert os.path.dirname(cap["dir"]) == str(prof / "plugins" / "profile")
    assert cap["trace"].endswith(".pt.trace.json.gz")
    assert cap["card"] is None             # no card on the CPU
    events = _events(trace, "profile")
    assert [(e["data"]["action"], e["iter"]) for e in events] == [
        ("start", 3), ("captured", 4)]
    assert events[1]["data"]["trace_dir"] == cap["dir"]
    sess = ws.spcomm._profiler
    assert sess.done and not sess.active and sess._prof is None
    assert sess.trace_bytes == os.path.getsize(cap["trace"])
    assert sess.export_s > 0
    # the CLI's report beside the capture, and the analyzer finds the
    # capture through the trace's `captured` event
    rep = json.loads((prof / "device_profile.json").read_text())
    assert rep["schema"] == "mpisppy-tpu-deviceprof/1"
    assert [s for s, _ in rep["steps"]["by_iter_tail"]] == [3]
    assert rep["kernels"] == {} and rep["busy_share"] == 0.0
    full = tan.analyze_path(str(trace))
    assert full["profiled_window"]["capture_dir"] == cap["dir"]
    assert full["device"]["trace"] == cap["trace"]
    assert "device busy" in tan.render_report(full)
    # the hub's phases landed as host spans of the window
    tl = dp.build_timeline(cap)
    assert {h.name for h in tl.host_spans} >= {"wheel/harvest"}
    assert "device profile:" in capsys.readouterr().err


def test_cli_unwritable_profile_dir_warns_and_finishes(tmp_path, capsys):
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    trace = tmp_path / "t.jsonl"
    ws = gc.main(FARMER + ["--max-iterations", "6", "--rel-gap", "0.01",
                           "--profile-dir", str(blocker / "prof"),
                           "--trace-jsonl", str(trace)])
    out = capsys.readouterr()
    payload = json.loads(out.out.strip().splitlines()[-1])
    assert payload["iterations"] == ws.spcomm._iter
    assert math.isfinite(payload["outer_bound"])
    assert out.err.count("WARNING: profiler:") == 1
    sess = ws.spcomm._profiler
    assert sess.failed and not sess.active
    assert _events(trace, "profile") == []


class _RecBus:
    def __init__(self):
        self.events = []

    def emit(self, kind, **kw):
        self.events.append((kind, kw))


def test_profiler_never_rearms_after_window(tmp_path, monkeypatch):
    """One window per session: after its stop, later syncs never start
    another profiler."""
    starts = []
    ps = ProfilerSession(str(tmp_path / "prof"), num_iters=2,
                         start_iter=3, bus=_RecBus(), cuda=False)
    monkeypatch.setattr(ps, "_start", lambda: starts.append(1))

    def fake_stop(hub_iter):
        ps.done = True
        ps.active = False
    monkeypatch.setattr(ps, "_stop", fake_stop)
    for it in range(30):
        ps.on_sync(it)
    assert len(starts) == 1
    assert ps.done and not ps.active


def test_captured_only_after_the_file_lands(tmp_path, monkeypatch):
    """An export that writes nothing gives a warning, not a `captured`
    event pointing at nothing."""
    bus = _RecBus()
    ps = ProfilerSession(str(tmp_path / "prof"), num_iters=1,
                         start_iter=0, bus=bus, cuda=False)
    monkeypatch.setattr(ps, "_export", lambda prof: None)
    ps.on_sync(0)
    torch.ones(4).add_(1)
    ps.on_sync(1)
    assert [kw["action"] for _, kw in bus.events] == ["start"]
    assert ps.done and not ps.active


def test_kineto_categories_by_name():
    """The live reading's categories without kineto's activity type
    (torch releases without _KinetoEvent.activity_type): copies, fills,
    a host range's device copy and kernels on the card; runtime calls,
    the hub's ranges, work records and operators on the host."""
    host = {"wheel/harvest", "aten::add", "cudaLaunchKernel"}
    cases = [("Memcpy DtoD (Device -> Device)", True, "gpu_memcpy"),
             ("Memset (Device)", True, "gpu_memset"),
             ("wheel/harvest", True, "gpu_user_annotation"),
             ("void pdhg_window_resident<3, false>(...)", True, "kernel"),
             ("cudaLaunchKernel", False, "cuda_runtime"),
             ("cuLaunchKernel", False, "cuda_runtime"),
             ("wheel_sync#3", False, "user_annotation"),
             ("wheel/harvest", False, "user_annotation"),
             (WORK, False, "user_annotation"),
             ("aten::add", False, "cpu_op")]
    for name, on_device, cat in cases:
        assert dp.kineto_category(name, on_device, host) == cat, name


def test_memory_and_file_readings_agree(tmp_path):
    """timeline_from_profiler on a live profile equals build_timeline
    on its exported file (steps, host spans, the window)."""
    from mpisppy_tpu_torch.telemetry import profiler as tprof
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as p:
        for n in (1, 2, 3):
            with tprof.step("wheel_sync", n):
                with tprof.annotate("wheel/harvest"):
                    torch.ones(64).mul_(2)
            torch.ones(64).add_(1)
    path = str(tmp_path / "x.pt.trace.json")
    p.export_chrome_trace(path)
    mem, disk = dp.timeline_from_profiler(p), dp.build_timeline(path)
    assert [s.step_num for s in mem.steps] == [s.step_num
                                               for s in disk.steps] == [1, 2, 3]
    for a, b in zip(mem.steps, disk.steps):
        assert a.dur_us == pytest.approx(b.dur_us, abs=0.01)
    assert [h.name for h in mem.host_spans] == [h.name
                                                for h in disk.host_spans]
    assert (mem.window_us[1] - mem.window_us[0]) == pytest.approx(
        disk.window_us[1] - disk.window_us[0], abs=0.01)
