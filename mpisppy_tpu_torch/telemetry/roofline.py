###############################################################################
# Roofline attribution over a device timeline (port of
# mpisppy_tpu/telemetry/roofline.py: the report keys and the schema
# string are the JAX module's; the peaks and the definitions are the
# card's).
#
# Turns deviceprof.DeviceTimeline into the gateable device report:
#
#   device_sec_per_iter   the median step: one hub iteration, from the
#                         start of the hub's wheel_sync#n range to the
#                         next one's (deviceprof.StepMarker); without
#                         step markers, the capture's wall span.
#   busy_share            |union(device activity)| / the capture's wall
#                         span (kernels, memsets and copies; the span
#                         runs from the first to the last event, host
#                         or device).
#   measured_stream_gbps  bytes over busy time of the pure data-movement
#                         activities kineto gives bytes for: the
#                         device-to-device copies (read and written: 2x
#                         their bytes) and the memsets.  The card's
#                         counterpart of the JAX sample set (XLA's "data
#                         formatting" / "non-fusion elementwise" /
#                         "broadcast" ops).  aten's elementwise kernels
#                         belong to it too, but a kineto trace carries
#                         no byte count for a kernel, so they are left
#                         out (None when the sample is empty).
#   achieved_hbm_gbps     bytes of every activity with a byte count (the
#                         window kernels' work records, copies, memsets)
#                         over the device busy time: a lower bound, since
#                         the aten kernels count none (opaque_frac).
#   hbm_roofline_frac     achieved_hbm_gbps / the card's memory rate.
#   mfu                   modeled flops at the peak of their type, over
#                         the busy time: sum_t flops_t / peak_t / busy.
#                         Only kernels with a work record count flops.
#   overlap_frac          |union(copies in flight) ∩ union(kernels and
#                         memsets)| / |union(copies in flight)|: the copy
#                         time hidden behind kernels.
#   kernels               per kernel (a window kernel under its work
#                         record's mode/design key): launches, busy
#                         seconds, ms per launch and, with a work record,
#                         the modeled least time (bytes over the memory
#                         rate or operations over their peak, the larger)
#                         and roofline_frac = that least time / the
#                         measured time: the share of the card's peak the
#                         kernel reached.
#
# The bytes and flops of a window are the work model of
# ops/pdhg_window.py::window_work (each input read once, each output
# written once; A'y and Av multiply-adds, the prox and the sums), the
# same count chip_smoke.py's bound column reads.  Peaks are keyed by the
# card's name (CARD_PEAKS); a card not in the table gets none, and every
# share of a peak reads None.  No TPU figure is carried over.
###############################################################################
from __future__ import annotations

from mpisppy_tpu_torch.telemetry import deviceprof as dp

DEVPROF_SCHEMA = "mpisppy-tpu-deviceprof/1"

#: the H100 SXM's name as torch.cuda.get_device_name and nvidia-smi give it
H100_SXM = "NVIDIA H100 80GB HBM3"

#: Dense peak rates by card name (NVIDIA H100 SXM data sheet): device
#: memory 3.35 TB/s, f32 outside the tensor cores 67 TFLOP/s, bf16 on
#: the tensor cores 989 TFLOP/s.
CARD_PEAKS = {
    H100_SXM: {"hbm_gbps": 3350.0, "f32_tflops": 67.0,
               "bf16_tflops": 989.0},
}

#: the pure data-movement categories of the stream sample
STREAM_CATEGORIES = frozenset({"memset"})

#: how many kernels the report lists beside every modeled one
TOP_KERNELS = 12


def peaks_for(device_name: str | None) -> dict | None:
    """The card's peak rates, or None for a card not in CARD_PEAKS."""
    return CARD_PEAKS.get(device_name or "")


def least_time_s(nbytes: float, flops_by_type, peaks: dict):
    """Least time the card could take for `nbytes` moved and the flops
    (type -> count, types "f32" and "bf16"): the larger of the bytes
    over the memory rate and the flops over the peak of their type.
    Returns (seconds, "bytes" or "operations")."""
    t_bytes = nbytes / (peaks["hbm_gbps"] * 1e9)
    t_ops = sum(v / (peaks[f"{t}_tflops"] * 1e12)
                for t, v in dict(flops_by_type).items())
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _union(intervals):
    """Total length (and merged list) of a set of [a, b) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(b - a for a, b in merged), merged


def _intersect_len(mg1, mg2) -> float:
    i = j = 0
    tot = 0.0
    while i < len(mg1) and j < len(mg2):
        a = max(mg1[i][0], mg2[j][0])
        b = min(mg1[i][1], mg2[j][1])
        if b > a:
            tot += b - a
        if mg1[i][1] <= mg2[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def _copy_bytes(d: dp.DmaSpan) -> int:
    """Device-memory bytes a copy moves: read and written on the card
    for a device-to-device copy, once for a host copy."""
    return 2 * d.bytes if d.device_to_device else d.bytes


def busy_share(tl: dp.DeviceTimeline) -> float | None:
    """|union(device activity)| / the capture's wall span."""
    busy, _ = _union([(o.start_us, o.end_us) for o in tl.ops]
                     + [(d.start_us, d.end_us) for d in tl.dma])
    if not tl.window_us or tl.window_us[1] <= tl.window_us[0]:
        return None
    return busy / (tl.window_us[1] - tl.window_us[0])


def roofline(tl: dp.DeviceTimeline) -> dict:
    """DeviceTimeline -> the machine report (JSON-able dict)."""
    peaks = peaks_for(tl.device_name)
    ops = tl.ops
    dev_iv = [(o.start_us, o.end_us) for o in ops] \
        + [(d.start_us, d.end_us) for d in tl.dma]
    busy_us, _ = _union(dev_iv)
    busy_s = busy_us * 1e-6
    window_s = ((tl.window_us[1] - tl.window_us[0]) * 1e-6
                if tl.window_us else 0.0)

    # -- per-category attribution ---------------------------------------
    cats: dict[str, dict] = {}
    for op in ops:
        c = cats.setdefault(op.category, {
            "ops": 0, "busy_s": 0.0, "hbm_gb": 0.0, "flops": 0})
        c["ops"] += 1
        c["busy_s"] += op.dur_us * 1e-6
        c["hbm_gb"] += (op.bytes_accessed or 0) / 1e9
        c["flops"] += op.flops or 0
    if tl.dma:
        c = cats.setdefault("memcpy", {
            "ops": 0, "busy_s": 0.0, "hbm_gb": 0.0, "flops": 0})
        for d in tl.dma:
            c["ops"] += 1
            c["busy_s"] += d.dur_us * 1e-6
            c["hbm_gb"] += _copy_bytes(d) / 1e9
    for c in cats.values():
        c["gbps"] = (round(c["hbm_gb"] / c["busy_s"], 1)
                     if c["busy_s"] > 0 else None)
        c["busy_s"] = round(c["busy_s"], 6)
        c["hbm_gb"] = round(c["hbm_gb"], 3)
    cats = dict(sorted(cats.items(), key=lambda kv: -kv[1]["busy_s"]))

    # -- whole-capture achieved rate -------------------------------------
    total_gb = (sum(op.bytes_accessed or 0 for op in ops)
                + sum(_copy_bytes(d) for d in tl.dma)) / 1e9
    achieved = total_gb / busy_s if busy_s > 0 else None
    peak_hbm = peaks["hbm_gbps"] if peaks else None

    # -- stream (pure data movement) bandwidth ---------------------------
    stream_gb = stream_s = 0.0
    for op in ops:
        if op.category in STREAM_CATEGORIES and op.dur_us > 0:
            stream_gb += (op.bytes_accessed or 0) / 1e9
            stream_s += op.dur_us * 1e-6
    for d in tl.dma:
        if d.device_to_device and d.dur_us > 0:
            stream_gb += _copy_bytes(d) / 1e9
            stream_s += d.dur_us * 1e-6
    stream_gbps = stream_gb / stream_s if stream_s > 0 and stream_gb > 0 \
        else None

    # -- modeled flops at their peak ---------------------------------------
    flops_total = sum(op.flops or 0 for op in ops)
    ops_s = None
    if peaks:
        ops_s = sum(v / (peaks[f"{t}_tflops"] * 1e12)
                    for op in ops for t, v in op.flops_by_type)
    mfu = (ops_s / busy_s if ops_s and busy_s > 0 else None)
    # opaque time: kernels with no work record (aten's, a library's):
    # their bytes and flops are not counted
    opaque_s = sum(op.dur_us for op in ops
                   if op.bytes_accessed is None) * 1e-6

    # -- copy / kernel overlap ---------------------------------------------
    dma_len, dma_merged = _union([(d.start_us, d.end_us) for d in tl.dma])
    _, comp_merged = _union([(op.start_us, op.end_us) for op in ops])
    overlap_us = _intersect_len(dma_merged, comp_merged)
    overlap_frac = (overlap_us / dma_len) if dma_len > 0 else None
    dma_gb = sum(d.bytes for d in tl.dma) / 1e9

    # -- per-iteration time ------------------------------------------------
    step_durs = [s.dur_us * 1e-6 for s in tl.steps]
    by_iter = sorted((s.step_num, round(s.dur_us * 1e-6, 6))
                     for s in tl.steps if s.step_num is not None)
    if step_durs:
        dev_sec_per_iter, iter_source = _median(step_durs), "steps"
    elif window_s > 0:
        dev_sec_per_iter, iter_source = window_s, "window"
    else:
        dev_sec_per_iter, iter_source = None, "none"

    rep = {
        "schema": DEVPROF_SCHEMA,
        "trace": tl.trace_path,
        "device": tl.device_name,
        "power_limit": tl.power_limit,
        "byte_source": ("work-model" if tl.has_work
                        else "copies-and-memsets-only"),
        "device_sec_per_iter": _round(dev_sec_per_iter, 6),
        "iter_source": iter_source,
        "modules": {"count": 0, "total_s": round(busy_s, 6)},
        "window_s": round(window_s, 6),
        "busy_share": _round(busy_s / window_s if window_s > 0 else None,
                             4),
        "measured_stream_gbps": _round(stream_gbps, 1),
        "stream_sample": {"gb": round(stream_gb, 3),
                          "busy_s": round(stream_s, 6)},
        "achieved_hbm_gbps": _round(achieved, 1),
        "peak_hbm_gbps": peak_hbm,
        "hbm_roofline_frac": _round(
            achieved / peak_hbm if achieved is not None and peak_hbm
            else None, 4),
        "mfu": _round(mfu, 5),
        "flops_total": flops_total,
        "peak_tflops": dict(peaks) if peaks else None,
        "opaque_s": round(opaque_s, 6),
        "opaque_frac": _round(
            opaque_s / busy_s if busy_s > 0 else None, 4),
        "overlap_frac": _round(overlap_frac, 4),
        "dma": {
            "spans": len(tl.dma),
            "gb": round(dma_gb, 3),
            "inflight_s": round(dma_len * 1e-6, 6),
            "exposed_s": round((dma_len - overlap_us) * 1e-6, 6),
        },
        "steps": {"count": len(tl.steps),
                  "sec_per_iter_median": _round(_median(step_durs), 6),
                  "by_iter_tail": by_iter[-8:]},
        "categories": cats,
        "kernels": _kernels(ops, peaks),
    }
    notes = []
    if not ops:
        notes.append("capture has no device activity (host-only trace "
                     "— a CPU run?): device metrics are empty")
    if peaks is None:
        notes.append(f"no peak rates for card {tl.device_name!r} "
                     "(roofline.CARD_PEAKS): every share of a peak is "
                     "None")
    if busy_s > 0 and opaque_s > 0.05 * busy_s:
        notes.append(f"{100 * opaque_s / busy_s:.0f}% of device time is "
                     "in kernels without a work model (aten's): kineto "
                     "counts no bytes or flops for a kernel, so "
                     "achieved_hbm_gbps and mfu are lower bounds")
    rep["notes"] = notes
    return rep


def _kernels(ops, peaks) -> dict:
    """Per kernel: launches, busy seconds, ms per launch and, with a
    work record, the modeled least time and its share of the time
    measured.  Every modeled kernel is listed, and the TOP_KERNELS
    others by device time."""
    acc: dict[str, dict] = {}
    for op in ops:
        if op.category == "memset":
            continue
        k = acc.setdefault(op.work_key or op.name, {
            "launches": 0, "busy_s": 0.0, "modeled": op.work_key is not None,
            "gb": 0.0, "least_s": 0.0, "flops": 0.0, "by": {}})
        k["launches"] += 1
        k["busy_s"] += op.dur_us * 1e-6
        if op.work_key is not None:
            k["gb"] += op.bytes_accessed / 1e9
            k["flops"] += op.flops or 0
            if peaks:
                t, by = least_time_s(op.bytes_accessed, op.flops_by_type,
                                     peaks)
                k["least_s"] += t
                k["by"][by] = k["by"].get(by, 0) + 1
    ranked = sorted(acc.items(), key=lambda kv: -kv[1]["busy_s"])
    keep = [kv for kv in ranked if kv[1]["modeled"]] \
        + [kv for kv in ranked if not kv[1]["modeled"]][:TOP_KERNELS]
    out = {}
    for name, k in sorted(keep, key=lambda kv: -kv[1]["busy_s"]):
        row = {"launches": k["launches"], "busy_s": round(k["busy_s"], 6),
               "ms_per_launch": round(1e3 * k["busy_s"] / k["launches"],
                                      6)}
        if k["modeled"]:
            row["gb"] = round(k["gb"], 6)
            row["flops"] = k["flops"]
            if peaks:
                row["least_s"] = round(k["least_s"], 6)
                row["bound_by"] = max(k["by"], key=k["by"].get)
                row["roofline_frac"] = _round(
                    k["least_s"] / k["busy_s"] if k["busy_s"] > 0
                    else None, 4)
        out[name] = row
    return out


def _round(v, nd):
    return None if v is None else round(v, nd)


def roofline_path(profile_dir: str) -> dict:
    """Newest capture under `profile_dir` -> roofline report."""
    return roofline(dp.build_timeline(profile_dir))


def peak_shares(rep: dict) -> dict:
    """Every share of a peak in a report (name -> value): none may read
    above 1.0 when the work model counts no more than a kernel must
    move and compute."""
    out = {k: rep.get(k) for k in ("hbm_roofline_frac", "mfu")}
    for name, k in (rep.get("kernels") or {}).items():
        if "roofline_frac" in k:
            out[f"kernels.{name}.roofline_frac"] = k["roofline_frac"]
    return {k: v for k, v in out.items() if v is not None}


# ---------------------------------------------------------------------------
# the human rendering
# ---------------------------------------------------------------------------
def _fmt(v, spec=".6g"):
    return "-" if v is None else format(v, spec)


def render_device(rep: dict) -> str:
    L: list[str] = []
    L.append(f"device {rep.get('device') or '?'}  "
             f"power limit {rep.get('power_limit') or '?'}  "
             f"[{rep.get('byte_source')}]  trace {rep.get('trace')}")
    m = rep["modules"]
    L.append(f"device busy {m['total_s']:.6g}s of {rep['window_s']:.6g}s "
             f"(busy_share {_fmt(rep['busy_share'])})  "
             f"device_sec_per_iter {_fmt(rep['device_sec_per_iter'])} "
             f"({rep['iter_source']})")
    L.append(f"measured_stream_gbps {_fmt(rep['measured_stream_gbps'])} "
             f"  (device-to-device copies and memsets: "
             f"{rep['stream_sample']['gb']:.6g} GB over "
             f"{rep['stream_sample']['busy_s']:.6g}s)")
    L.append(f"achieved_hbm_gbps {_fmt(rep['achieved_hbm_gbps'])} of "
             f"peak {_fmt(rep['peak_hbm_gbps'])} "
             f"(roofline_frac {_fmt(rep['hbm_roofline_frac'])})")
    pk = rep.get("peak_tflops") or {}
    L.append(f"mfu {_fmt(rep['mfu'])}  (modeled flops "
             f"{rep['flops_total']:.6g} vs peak "
             f"{_fmt(pk.get('f32_tflops'))} f32 / "
             f"{_fmt(pk.get('bf16_tflops'))} bf16 TFLOP/s)")
    d = rep["dma"]
    L.append(f"overlap_frac {_fmt(rep['overlap_frac'])}  (copies "
             f"{d['spans']}, {d['gb']:.6g} GB, in flight "
             f"{d['inflight_s']:.6g}s, exposed {d['exposed_s']:.6g}s)")
    if rep["steps"]["count"]:
        s = rep["steps"]
        L.append(f"steps: {s['count']}  sec/iter median "
                 f"{_fmt(s['sec_per_iter_median'])}  tail "
                 f"{s['by_iter_tail']}")
    L.append("kernels (launches, device time, ms/launch, least time "
             "share):")
    for name, k in rep["kernels"].items():
        L.append(f"  {name[:60]:<60} x{k['launches']:<6d} "
                 f"{k['busy_s']:9.5f}s {k['ms_per_launch']:9.4f}ms"
                 f"  {_fmt(k.get('roofline_frac'), '.4f')}")
    L.append("categories (device busy, bytes counted):")
    for name, c in rep["categories"].items():
        L.append(f"  {name:<28} x{c['ops']:<6d} {c['busy_s']:9.5f}s"
                 f"  {c['hbm_gb']:9.3f} GB"
                 f"  {_fmt(c['gbps'], '8.1f') if c['gbps'] is not None else '       -'} GB/s")
    for n in rep.get("notes", []):
        L.append(f"  ! {n}")
    return "\n".join(L)
