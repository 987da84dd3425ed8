###############################################################################
# WheelSpinner: top-level orchestration (port of the core of
# mpisppy_tpu/spin_the_wheel.py; ref:mpisppy/spin_the_wheel.py:18-242).
#
# All cylinders drive one device from one host process.  hub_dict /
# list_of_spoke_dicts keep the reference's shape:
#
#   hub_dict = {"hub_class": PHHub, "hub_kwargs": {"options": {...}},
#               "opt_class": FusedPH, "opt_kwargs": {...}}
#   spoke_dict = {"spoke_class": FusedLagrangianOuterBound,
#                 "opt_kwargs": {"options": {...}}}
#
# Preemption: with a checkpoint_path on the hub, SIGTERM/SIGINT become
# PreemptionError (raised between bytecodes of the host loop, so between
# launches; a second signal is latched off), which triggers one
# synchronous emergency checkpoint of the last completed state before the
# error propagates — a later run restores it with hub.load_checkpoint and
# resumes mid-loop.  A wheel that dies emits its run-end event (reason
# "preemption" or "exception", after the save) and dumps every flight
# recorder on the hub's bus to flight-<runid>.jsonl.
###############################################################################
from __future__ import annotations

import os
import signal
import threading

import numpy as np

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.resilience.faults import PreemptionError
from mpisppy_tpu_torch.telemetry import flightrec


class WheelSpinner:
    """ref:mpisppy/spin_the_wheel.py:18."""

    def __init__(self, hub_dict: dict, list_of_spoke_dict=None):
        self.hub_dict = hub_dict
        self.list_of_spoke_dict = list_of_spoke_dict or []
        self.spcomm = None
        self.opt = None
        self.preempted = False

    def build(self):
        """Construct opt + spokes + hub without running (split out so a
        checkpoint can be restored into the built objects before
        spin())."""
        if self.spcomm is not None:
            return self
        hd = self.hub_dict
        self.opt = hd["opt_class"](**hd.get("opt_kwargs", {}))
        spokes = []
        for sd in self.list_of_spoke_dict:
            kw = dict(sd.get("opt_kwargs", {}))
            spokes.append(sd["spoke_class"](self.opt, kw.get("options", kw)))
        hub_kwargs = dict(hd.get("hub_kwargs", {}))
        self.spcomm = hd["hub_class"](self.opt,
                                      hub_kwargs.get("options", {}),
                                      spokes=spokes)
        self.spcomm.make_windows()
        self.spcomm.setup_hub()
        return self

    def spin(self):
        """Build, run the hub algorithm to completion, terminate and
        finalize (ref:spin_the_wheel.py:43-149 run()).  With a
        checkpoint_path on the hub, a preemption (a signal, a fault
        plan's, a migration drain) writes one synchronous emergency
        checkpoint, then records the crash, then re-raises."""
        self.build()
        global_toc("Starting wheel spin", False)
        ckpt_path = self.spcomm.options.get("checkpoint_path")
        prev_handlers = self._install_preemption_handlers() \
            if ckpt_path else None
        try:
            self.spcomm.main()
        except PreemptionError as e:
            self.preempted = True
            if ckpt_path:
                saved = self.spcomm.emergency_checkpoint(ckpt_path)
                global_toc(
                    f"preempted: emergency checkpoint "
                    f"{'written to ' + ckpt_path if saved else 'SKIPPED'}"
                    f" at hub iter {self.spcomm._iter}", True)
            # the save first: it must win the eviction grace window
            self._record_crash(e, "preemption")
            raise
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            self._record_crash(e)
            raise
        finally:
            self._restore_preemption_handlers(prev_handlers)
            # the run is over: a later wheel (or bare scheduler use) on
            # this thread must not inherit its dispatch session token
            _dispatch.clear_session_context()
        self.spcomm.send_terminate()
        self.spcomm.finalize()
        self.spcomm.hub_finalize()
        self.spcomm.free_windows()
        return self

    def _record_crash(self, exc: BaseException,
                      reason: str = "exception") -> None:
        """Last words of a dying wheel: stop the watchdog (the wheel is
        dying on an exception, not a hang), emit the run-end event with
        its reason and dump the flight recorders.  Best effort: the
        original exception keeps propagating whatever happens here."""
        detail = f"{type(exc).__name__}: {exc}"
        if self.spcomm._watchdog is not None:
            self.spcomm._watchdog.stop()
        try:
            self.spcomm.emit_run_end(reason, error=detail)
        except Exception:
            pass
        for path in flightrec.dump_all(self.spcomm.telemetry, reason=detail):
            if path:
                global_toc(f"flight recorder: black box written to {path}",
                           True)

    # -- preemption signal plumbing ---------------------------------------
    @staticmethod
    def _install_preemption_handlers():
        """SIGTERM/SIGINT -> PreemptionError, raised at the next bytecode
        boundary of the host loop.  Returns the previous handlers, or
        None off the main thread (signal.signal would raise there)."""
        if threading.current_thread() is not threading.main_thread():
            return None
        fired = []

        def _handler(signum, frame):
            # latch: a second signal (an impatient scheduler, a double
            # Ctrl-C) must not unwind the emergency save the first one
            # started, or its tmp file would never be renamed
            if fired:
                return
            fired.append(signum)
            raise PreemptionError(f"received signal {signum}")

        return {sig: signal.signal(sig, _handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    @staticmethod
    def _restore_preemption_handlers(prev):
        for sig, h in (prev or {}).items():
            signal.signal(sig, h)

    # -- results (ref:spin_the_wheel.py:151-222) --------------------------
    @property
    def BestInnerBound(self):
        return self.spcomm.BestInnerBound

    @property
    def BestOuterBound(self):
        return self.spcomm.BestOuterBound

    def write_first_stage_solution(self, solution_file_name: str):
        """The incumbent's first-stage (ROOT) values: np.save into a
        `.npy` name, else one "x<i>,<value>" line each
        (ref:spin_the_wheel.py:171-195)."""
        root = self.spcomm.best_nonants()[0]
        stage1 = root[np.nonzero(self.opt.batch.tree.slot_stage == 1)[0]]
        if solution_file_name.endswith(".npy"):
            np.save(solution_file_name, stage1)
            return
        with open(solution_file_name, "w") as f:
            for i, v in enumerate(stage1):
                f.write(f"x{i},{v}\n")

    def write_tree_solution(self, directory_name: str):
        """Per-node nonant values, one "<node name>.csv" per tree node
        with a "slot<i>,<value>" line for each slot of the node's stage
        (ref:spin_the_wheel.py:197-222)."""
        os.makedirs(directory_name, exist_ok=True)
        nodes = self.spcomm.best_nonants()
        tree = self.opt.batch.tree
        for nid in range(tree.num_nodes):
            stage = int(np.searchsorted(
                np.cumsum(tree.nodes_per_stage), nid, side="right")) + 1
            slots = np.nonzero(tree.slot_stage == stage)[0]
            with open(os.path.join(directory_name,
                                   f"{tree.node_name(nid)}.csv"), "w") as f:
                for i in slots:
                    f.write(f"slot{i},{nodes[nid, i]}\n")
