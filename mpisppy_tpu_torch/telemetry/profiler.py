###############################################################################
# Profiler hooks (port of mpisppy_tpu/telemetry/profiler.py).
#
# Two layers:
#   * annotate(name) / step(name, n) — torch.profiler.record_function
#     ranges that never raise: the wheel brackets its phases (hub sync,
#     harvest, spoke update, the async exchange halves) as `wheel/<phase>`
#     and each sync as `wheel_sync#<hub_iter>`, so a capture shows named
#     host ranges beside the kernels, and telemetry/deviceprof.py reads
#     them as host spans and step markers.  Outside an active profiler a
#     range costs a few microseconds of host work.
#   * ProfilerSession — the --profile-dir CLI flag: brackets N wheel
#     iterations with a torch.profiler window, skipping the first
#     iterations so the capture shows steady state, and writes the
#     capture in the JAX package's layout:
#         <profile_dir>/plugins/profile/<YYYY_MM_DD_HH_MM_SS>/
#             <host>.pt.trace.json.gz   kineto's chrome trace
#             <host>.card.json          the card's name and power limit
#     It traces the host and the card when the wheel runs on the card,
#     the host alone on the CPU.  The trace is exported straight from
#     the kineto result (the profiler's FunctionEvent list is never
#     built: over a window's ~10^5 events that took minutes), and the
#     profiler is stopped and dropped at the end of its window.
#
# Hardening contract (the JAX package's): a missing or unwritable
# profile_dir degrades to one console warning, never an unhandled
# exception; and the `profile` event that advertises a capture (action
# "captured", carrying the capture dir for `telemetry analyze`
# auto-discovery) is emitted ONLY after the trace file is verified on
# disk.  One window per session: it never re-arms.
###############################################################################
from __future__ import annotations

import contextlib
import gzip
import json
import os
import shutil
import socket
import subprocess
import time


def annotate(name: str):
    """Named host range (shows in a torch.profiler trace)."""
    try:
        import torch
        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()


def step(name: str, step_num: int):
    """One wheel iteration as a named range `name#step_num`, keyed by
    hub iteration."""
    return annotate(f"{name}#{int(step_num)}")


def card_info() -> dict | None:
    """The card's name and power limit as nvidia-smi gives them
    (`--query-gpu=name,power.limit --format=csv,noheader`), or None
    without a readable nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    if not out or "," not in out[0]:
        return None
    name, limit = (v.strip() for v in out[0].split(",", 1))
    return {"name": name, "power_limit": limit, "nvidia_smi": out[0]}


class ProfilerSession:
    """Bracket wheel iterations [start_iter, start_iter + num_iters)
    with a torch.profiler window written under `profile_dir`.

    Driven by the hub: on_sync(hub_iter) every sync, close() at finalize
    (stops a still-open window when the wheel terminates first).
    `cuda`: trace the card too (None: when CUDA is initialized, i.e.
    the wheel has run on the card).  `start_s` is the seconds the
    profiler took to start; after the window, `trace_path`, `export_s`
    (seconds to export and compress the trace), `stop_s`
    (seconds from the window's end to the capture on disk, the export
    included) and `trace_bytes` (its size on disk) describe the
    capture."""

    def __init__(self, profile_dir: str, num_iters: int = 5,
                 start_iter: int = 3, bus=None, run: str = "",
                 cuda: bool | None = None):
        self.profile_dir = profile_dir
        self.num_iters = max(1, int(num_iters))
        self.start_iter = int(start_iter)
        self.active = False
        self.failed = False
        self.done = False      # window completed: never re-arm
        self.cuda = cuda
        self.trace_path = None
        self.start_s = None
        self.export_s = None
        self.stop_s = None
        self.trace_bytes = None
        self._bus = bus
        self._run = run
        self._prof = None
        self._known_captures: set = set()

    def _emit(self, action: str, hub_iter: int | None, **extra):
        if self._bus is not None:
            from mpisppy_tpu_torch.telemetry import events as ev
            self._bus.emit(ev.PROFILE, run=self._run, cyl="hub",
                           hub_iter=hub_iter, action=action,
                           profile_dir=self.profile_dir, **extra)

    def _warn(self, msg: str) -> None:
        from mpisppy_tpu_torch.telemetry import console
        console.log(f"WARNING: profiler: {msg}", cyl="hub")

    def _capture_dirs(self) -> set:
        try:
            from mpisppy_tpu_torch.telemetry import deviceprof
            return {c["dir"]
                    for c in deviceprof.discover_captures(
                        self.profile_dir)}
        except (OSError, ValueError):
            return set()

    def _fail(self, msg: str) -> None:
        # a broken profiler or filesystem must never kill the run: warn
        # once, then stand down for the rest of the wheel
        self._warn(f"{msg} — device profiling disabled for this run")
        self.failed = True
        self.active = False
        self._prof = None

    def _on_card(self) -> bool:
        if self.cuda is not None:
            return bool(self.cuda)
        import torch
        return torch.cuda.is_available() and torch.cuda.is_initialized()

    def on_sync(self, hub_iter: int) -> None:
        if self.failed or self.done:
            return
        if not self.active and hub_iter >= self.start_iter:
            try:
                os.makedirs(self.profile_dir, exist_ok=True)
            except OSError as e:
                return self._fail(
                    f"cannot create --profile-dir "
                    f"{self.profile_dir!r} ({e})")
            if not os.access(self.profile_dir, os.W_OK):
                return self._fail(f"--profile-dir {self.profile_dir!r} "
                                  "is not writable")
            self._known_captures = self._capture_dirs()
            t0 = time.perf_counter()
            try:
                self._start()
            except Exception as e:
                return self._fail(f"profiler start failed ({e})")
            self.start_s = time.perf_counter() - t0
            self.active = True
            self._emit("start", hub_iter)
        elif self.active \
                and hub_iter >= self.start_iter + self.num_iters:
            self._stop(hub_iter)

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.cuda = self._on_card()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.start()

    def _stop(self, hub_iter: int | None) -> None:
        self.done = True       # one window per session: never re-arm
        prof, self._prof = self._prof, None
        t0 = time.perf_counter()
        try:
            if self.cuda:
                import torch
                torch.cuda.synchronize()
            prof.stop()
            self._export(prof)
        except Exception as e:
            self.active = False
            return self._fail(f"profiler stop or export failed ({e})")
        finally:
            # release the profiler and its kineto result now: nothing of
            # it may outlive the window
            del prof
        self.stop_s = time.perf_counter() - t0
        self.active = False
        # the `profile` "captured" event is a claim that an analyzable
        # trace EXISTS — verify before advertising
        new = self._capture_dirs() - self._known_captures
        if new:
            self._emit("captured", hub_iter, trace_dir=sorted(new)[-1])
            from mpisppy_tpu_torch.telemetry import console
            console.log(f"profiler: capture {self.trace_path} "
                        f"({self.trace_bytes} bytes, exported in "
                        f"{self.export_s:.3f} s)", cyl="hub")
        else:
            self._warn(f"window stopped but no capture landed under "
                       f"{self.profile_dir!r}")

    def _capture_dir(self) -> str:
        root = os.path.join(self.profile_dir, "plugins", "profile")
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        d = os.path.join(root, stamp)
        k = 1
        while os.path.exists(d):   # two windows in one second
            d = os.path.join(root, f"{stamp}_{k}")
            k += 1
        os.makedirs(d)
        return d

    def _export(self, prof) -> None:
        """Kineto's chrome trace, gzip-compressed, and the card's
        sidecar, into a new capture dir."""
        t0 = time.perf_counter()
        d = self._capture_dir()
        base = os.path.join(d, socket.gethostname())
        raw = base + ".pt.trace.json"
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, \
                gzip.open(raw + ".gz", "wb", compresslevel=1) as dst:
            shutil.copyfileobj(src, dst, 1 << 22)
        os.remove(raw)
        self.trace_path = raw + ".gz"
        self.trace_bytes = os.path.getsize(self.trace_path)
        card = card_info() if self.cuda else None
        if card is not None:
            with open(base + ".card.json", "w") as f:
                json.dump(card, f)
        self.export_s = time.perf_counter() - t0

    def close(self) -> None:
        if self.active and not self.failed:
            self._stop(None)
