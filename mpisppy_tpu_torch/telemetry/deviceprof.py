###############################################################################
# Device-trace ingestion (port of mpisppy_tpu/telemetry/deviceprof.py).
#
# ProfilerSession (profiler.py) writes a torch.profiler capture in the
# TensorBoard layout the JAX package uses:
#
#   <profile_dir>/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/
#       <host>.pt.trace.json.gz   kineto's chrome trace (gzip + json)
#       <host>.card.json          the card's name and power limit
#                                 (nvidia-smi), when the run had a card
#
# This module turns a capture into the JAX module's typed DEVICE
# timeline.  Kineto's events map onto its types so:
#
#   * DeviceOp — every event of category "kernel" or "gpu_memset" (the
#     card's executed work), with its stream.  A kernel's bytes and
#     flops come from a work record when one exists: the window wrapper
#     (ops/pdhg_window.py::run_window) opens a record_function range
#     named by WORK_RE around each launch while a profiler runs, and the
#     kernel joins it through its launch's correlation id.  Kineto
#     itself counts neither for a kernel, so the other kernels (aten's)
#     carry none, and the roofline says so.
#   * DmaSpan — every "gpu_memcpy" (host-to-device, device-to-host and
#     device-to-device copies): the card's counterpart of the TPU's
#     async copies.  Kineto gives each copy as ONE interval with its
#     bytes, so the JAX module's start/done pairing (_pair_dma) has no
#     work to do here and is not ported.
#   * StepMarker — the hub's `wheel_sync#<n>` ranges (profiler.step,
#     "user_annotation"), keyed by hub iteration n.  A marker runs from
#     the start of wheel_sync#n to the start of the next sync (the
#     sync, then the hub's next step), the last one to the end of the
#     capture: one hub iteration per marker.
#   * HostSpan — the hub's `wheel/<phase>` ranges (profiler.annotate).
#
# Not ported: the XSpace protobuf walker of the JAX module (its
# .xplane.pb sidecar reader).  It recovers the TPU's per-memory-space
# byte split and the plane's own peak rates; kineto has no counterpart,
# so the roofline takes its peaks from a table keyed by the card's name
# (roofline.CARD_PEAKS).
#
# The same mapping reads a finished torch.profiler object in memory
# (timeline_from_profiler), so a script can hold the roofline of a live
# profile against the one read back from its exported file.
###############################################################################
from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import os
import re

#: kineto event categories of the card's executed work
KERNEL_CATEGORY = "kernel"
MEMSET_CATEGORY = "gpu_memset"
MEMCPY_CATEGORY = "gpu_memcpy"
#: host ranges opened by record_function, and the host side of a launch
ANNOTATION_CATEGORY = "user_annotation"
RUNTIME_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})

#: the hub's step ranges (profiler.step("wheel_sync", n)) and phases
STEP_RE = re.compile(r"^wheel_sync#(\d+)$")
HOST_SPAN_PREFIX = "wheel/"

#: a kernel launch's work record: `<key>[k=v ...]`, e.g.
#: `pdhg_window/bf16x3/resident[S=10000 m=60 n=705 it=40 bytes=...
#: f32_flops=... bf16_flops=...]` (ops/pdhg_window.py::work_label)
WORK_RE = re.compile(r"^(?P<key>[\w./]+)\[(?P<kv>[^\]]*)\]$")

#: a DmaSpan whose name says so moves bytes device to device: it reads
#: and writes device memory (2x its bytes); a host copy touches device
#: memory once
D2D_RE = re.compile(r"DtoD|Device -> Device")

CARD_SUFFIX = ".card.json"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    """One executed device activity (a kernel or a memset).  `category`
    is the op's class (kernel_category); `bytes_accessed`/`flops` come
    from its work record (None when it has none: kineto counts
    neither); `flops_by_type` splits the flops by the peak they run
    at."""

    name: str
    category: str
    start_us: float
    dur_us: float
    bytes_accessed: int | None = None
    flops: float | None = None
    flops_by_type: tuple = ()
    stream: int | None = None
    work_key: str | None = None

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


@dataclasses.dataclass(frozen=True)
class DmaSpan:
    """One copy in flight (kineto gives it as one interval)."""

    name: str
    start_us: float
    end_us: float
    bytes: int = 0

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us

    @property
    def device_to_device(self) -> bool:
        return bool(D2D_RE.search(self.name))


@dataclasses.dataclass(frozen=True)
class StepMarker:
    """One hub iteration of the capture, opened by the hub's
    wheel_sync#<n> range.  `step_num` is n, the join key back to the
    JSONL host trace."""

    name: str
    start_us: float
    dur_us: float
    step_num: int | None = None


@dataclasses.dataclass(frozen=True)
class HostSpan:
    """A named host range (the hub's wheel/<phase> ranges)."""

    name: str
    start_us: float
    dur_us: float


@dataclasses.dataclass
class DeviceTimeline:
    """Typed model of one capture.  `window_us` is the capture's wall
    span (first event start, last event end, host and device)."""

    trace_path: str
    device_name: str = ""
    power_limit: str | None = None
    ops: list = dataclasses.field(default_factory=list)
    dma: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    host_spans: list = dataclasses.field(default_factory=list)
    window_us: tuple | None = None

    @property
    def has_work(self) -> bool:
        return any(op.bytes_accessed is not None for op in self.ops)


# ---------------------------------------------------------------------------
# capture discovery (the JAX module's, on the .pt.trace.json[.gz] names)
# ---------------------------------------------------------------------------
def _is_trace(f: str) -> bool:
    return f.endswith(".trace.json.gz") or f.endswith(".trace.json")


def discover_captures(profile_dir: str) -> list[dict]:
    """All captures under a --profile-dir, oldest -> newest.  Each entry
    is {"dir", "trace", "card"(or None)}.  Accepts the profile root, a
    single capture dir, or a trace path directly."""
    if os.path.isfile(profile_dir):
        d = os.path.dirname(profile_dir)
        return [{"dir": d, "trace": profile_dir,
                 "card": _sibling_card(profile_dir)}]
    roots = [os.path.join(profile_dir, "plugins", "profile"), profile_dir]
    caps: list[dict] = []
    for root in roots:
        if not os.path.isdir(root):
            continue
        for sub in sorted(os.listdir(root)):
            d = os.path.join(root, sub)
            if not os.path.isdir(d):
                continue
            traces = sorted(f for f in os.listdir(d) if _is_trace(f))
            if traces:
                t = os.path.join(d, traces[0])
                caps.append({"dir": d, "trace": t,
                             "card": _sibling_card(t)})
        if caps:
            break
        # the profile root may itself hold a capture's files
        traces = sorted(f for f in os.listdir(root) if _is_trace(f))
        if traces:
            t = os.path.join(root, traces[0])
            caps.append({"dir": root, "trace": t,
                         "card": _sibling_card(t)})
            break
    # timestamped dir names (YYYY_MM_DD_HH_MM_SS) sort chronologically
    return caps


def newest_capture(profile_dir: str) -> dict | None:
    caps = discover_captures(profile_dir)
    return caps[-1] if caps else None


def _trace_base(trace_path: str) -> str:
    base = trace_path
    for suf in (".pt.trace.json.gz", ".pt.trace.json", ".trace.json.gz",
                ".trace.json"):
        if base.endswith(suf):
            return base[:-len(suf)]
    return base


def _sibling_card(trace_path: str) -> str | None:
    p = _trace_base(trace_path) + CARD_SUFFIX
    return p if os.path.isfile(p) else None


def _read_card(path: str | None) -> dict:
    if not path:
        return {}
    try:
        with open(path) as f:
            card = json.load(f)
        return card if isinstance(card, dict) else {}
    except (OSError, ValueError):
        return {}


# ---------------------------------------------------------------------------
# chrome trace reader
# ---------------------------------------------------------------------------
def load_chrome_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def build_timeline(capture) -> DeviceTimeline:
    """Capture -> DeviceTimeline.  `capture` is a discover_captures()
    entry, a capture dir / profile root, or a trace path."""
    if isinstance(capture, str):
        cap = newest_capture(capture)
        if cap is None:
            raise ValueError(f"no .pt.trace.json[.gz] capture under "
                             f"{capture!r}")
        capture = cap
    trace_path = capture["trace"]
    raw = load_chrome_trace(trace_path)
    events = raw.get("traceEvents", []) if isinstance(raw, dict) else raw
    rows = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") == "Trace":
            continue
        a = e.get("args") or {}
        rows.append((e.get("cat", ""), e.get("name", ""),
                     float(e.get("ts", 0.0)), float(e.get("dur", 0.0)),
                     e.get("tid"), a.get("correlation"),
                     a.get("bytes")))
    card = _read_card(capture.get("card"))
    name = card.get("name")
    if not name and isinstance(raw, dict):
        props = raw.get("deviceProperties") or []
        if props and isinstance(props[0], dict):
            name = props[0].get("name")
    return timeline_from_rows(rows, trace_path=trace_path,
                              device_name=name or "",
                              power_limit=card.get("power_limit"))


def timeline_from_profiler(prof, device_name: str = "",
                           power_limit: str | None = None,
                           trace_path: str = "<memory>") -> DeviceTimeline:
    """A finished torch.profiler.profile -> DeviceTimeline, read from
    its kineto result (never the FunctionEvent list, which costs tens
    of microseconds an event): the same mapping build_timeline applies
    to the exported file.  The kineto result numbers its host threads
    on two scales (the profiler's own for ranges, the system's for
    runtime calls), so here every host row is one thread: a launch
    joins the innermost work record open at its time."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    # times from the first event, in integer ns before the division: an
    # epoch in microseconds as a double keeps only ~0.25 us
    base = min((e.start_ns() for e in events), default=0)
    cuda = [e.device_type() == DeviceType.CUDA for e in events]
    host_names = {e.name() for e, dev in zip(events, cuda) if not dev}
    rows = []
    for e, on_device in zip(events, cuda):
        name = e.name()
        rows.append((kineto_category(name, on_device, host_names), name,
                     (e.start_ns() - base) / 1e3, e.duration_ns() / 1e3,
                     e.device_resource_id() if on_device else 0,
                     e.correlation_id(),
                     e.nbytes() if hasattr(e, "nbytes") else 0))
    return timeline_from_rows(rows, trace_path=trace_path,
                              device_name=device_name,
                              power_limit=power_limit)


def kineto_category(name: str, on_device: bool, host_names) -> str:
    """The chrome-trace category of a kineto event from its name and
    device, for the torch releases whose _KinetoEvent has no
    activity_type: on the card a copy or a fill by its name, a host
    range's device copy by carrying a host event's name
    (gpu_user_annotation), else a kernel; on the host a CUDA runtime or
    driver call by its name, one of the hub's ranges or a work record
    by theirs, else an operator."""
    if on_device:
        if name.startswith("Memcpy"):
            return MEMCPY_CATEGORY
        if name.startswith("Memset"):
            return MEMSET_CATEGORY
        return "gpu_user_annotation" if name in host_names \
            else KERNEL_CATEGORY
    if name.startswith("cuda") or name.startswith("cu") \
            and name[2:3].isupper():
        return "cuda_runtime"
    if STEP_RE.match(name) or name.startswith(HOST_SPAN_PREFIX) \
            or WORK_RE.match(name):
        return ANNOTATION_CATEGORY
    return "cpu_op"



def kernel_category(name: str) -> str:
    """A coarse class of an aten / library kernel by its name."""
    low = name.lower()
    for cat, keys in (("reduce", ("reduce_kernel", "reduction")),
                      ("gemm", ("gemm", "cutlass", "xmma", "cublas")),
                      ("index", ("index", "gather", "scatter")),
                      ("elementwise", ("elementwise",)),
                      ("sort", ("sort", "radix"))):
        if any(k in low for k in keys):
            return cat
    return "other"


def parse_work(label: str) -> dict | None:
    """A work record's range name -> {"key", numbers...}, else None."""
    m = WORK_RE.match(label)
    if m is None:
        return None
    out: dict = {"key": m["key"]}
    for kv in m["kv"].split():
        k, _, v = kv.partition("=")
        try:
            out[k] = float(v)
        except ValueError:
            return None
    return out if "bytes" in out else None


def _flop_types(work: dict) -> tuple:
    return tuple(sorted((k[:-len("_flops")], work[k]) for k in work
                        if k.endswith("_flops") and work[k]))


def timeline_from_rows(rows, trace_path: str, device_name: str = "",
                       power_limit: str | None = None) -> DeviceTimeline:
    """(category, name, start_us, dur_us, tid-or-stream, correlation,
    bytes) rows -> DeviceTimeline (the reader shared by the file and
    the in-memory path)."""
    tl = DeviceTimeline(trace_path=trace_path, device_name=device_name,
                        power_limit=power_limit)
    lo, hi = float("inf"), float("-inf")
    # host work records by thread, and launches by correlation id
    works: dict = {}
    launches: dict = {}
    syncs = []
    kernels = []
    for cat, name, ts, dur, tid, corr, nbytes in rows:
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if cat in (KERNEL_CATEGORY, MEMSET_CATEGORY):
            kernels.append((cat, name, ts, dur, tid, corr, nbytes))
        elif cat == MEMCPY_CATEGORY:
            tl.dma.append(DmaSpan(name=name, start_us=ts, end_us=ts + dur,
                                  bytes=int(nbytes or 0)))
        elif cat == ANNOTATION_CATEGORY:
            m = STEP_RE.match(name)
            if m:
                syncs.append((ts, int(m[1]), name))
            elif name.startswith(HOST_SPAN_PREFIX):
                tl.host_spans.append(HostSpan(name=name, start_us=ts,
                                              dur_us=dur))
            else:
                work = parse_work(name)
                if work is not None:
                    works.setdefault(tid, []).append((ts, ts + dur, work))
        elif cat in RUNTIME_CATEGORIES and corr is not None:
            launches[corr] = (tid, ts)
    starts = {}
    for tid, iv in works.items():
        iv.sort(key=lambda w: w[0])
        starts[tid] = [w[0] for w in iv]
    for cat, name, ts, dur, stream, corr, nbytes in kernels:
        work = None
        if corr in launches:
            tid, at = launches[corr]
            iv = works.get(tid)
            if iv:
                # the innermost record holding the launch: the latest
                # one that starts at or before it
                j = bisect.bisect_right(starts[tid], at) - 1
                while j >= 0 and iv[j][1] < at:
                    j -= 1
                if j >= 0:
                    work = iv[j][2]
        if cat == MEMSET_CATEGORY:
            op = DeviceOp(name=name, category="memset", start_us=ts,
                          dur_us=dur, bytes_accessed=int(nbytes or 0),
                          stream=stream)
        elif work is not None:
            ft = _flop_types(work)
            op = DeviceOp(name=name, category=work["key"], start_us=ts,
                          dur_us=dur, bytes_accessed=int(work["bytes"]),
                          flops=sum(v for _, v in ft), flops_by_type=ft,
                          stream=stream, work_key=work["key"])
        else:
            op = DeviceOp(name=name, category=kernel_category(name),
                          start_us=ts, dur_us=dur, stream=stream)
        tl.ops.append(op)
    tl.ops.sort(key=lambda o: o.start_us)
    tl.dma.sort(key=lambda d: d.start_us)
    tl.host_spans.sort(key=lambda s: s.start_us)
    if lo <= hi:
        tl.window_us = (lo, hi)
    syncs.sort()
    for i, (ts, n, name) in enumerate(syncs):
        end = syncs[i + 1][0] if i + 1 < len(syncs) else hi
        tl.steps.append(StepMarker(name=name, start_us=ts,
                                   dur_us=max(0.0, end - ts), step_num=n))
    return tl
