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
# A wheel that dies on an exception emits its run-end event (reason
# "exception") and dumps every flight recorder on the hub's bus to
# flight-<runid>.jsonl.  Preemption handlers and emergency checkpoints
# are not ported yet (the JAX package installs them only with a
# checkpoint_path).
###############################################################################
from __future__ import annotations

import numpy as np

from mpisppy_tpu_torch import dispatch as _dispatch
from mpisppy_tpu_torch import global_toc
from mpisppy_tpu_torch.telemetry import flightrec


class WheelSpinner:
    """ref:mpisppy/spin_the_wheel.py:18."""

    def __init__(self, hub_dict: dict, list_of_spoke_dict=None):
        self.hub_dict = hub_dict
        self.list_of_spoke_dict = list_of_spoke_dict or []
        self.spcomm = None
        self.opt = None

    def build(self):
        """Construct opt + spokes + hub without running."""
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
        finalize (ref:spin_the_wheel.py:43-149 run())."""
        self.build()
        global_toc("Starting wheel spin", False)
        try:
            self.spcomm.main()
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised
            self._record_crash(e)
            raise
        finally:
            # the run is over: a later wheel (or bare scheduler use) on
            # this thread must not inherit its dispatch session token
            _dispatch.clear_session_context()
        self.spcomm.send_terminate()
        self.spcomm.finalize()
        self.spcomm.hub_finalize()
        self.spcomm.free_windows()
        return self

    def _record_crash(self, exc: BaseException) -> None:
        """Last words of a dying wheel: stop the watchdog (the wheel is
        dying on an exception, not a hang), emit the run-end event and
        dump the flight recorders.  Best effort: the original exception
        keeps propagating whatever happens here."""
        detail = f"{type(exc).__name__}: {exc}"
        if self.spcomm._watchdog is not None:
            self.spcomm._watchdog.stop()
        try:
            self.spcomm.emit_run_end("exception", error=detail)
        except Exception:
            pass
        for path in flightrec.dump_all(self.spcomm.telemetry, reason=detail):
            if path:
                global_toc(f"flight recorder: black box written to {path}",
                           True)

    # -- results (ref:spin_the_wheel.py:151-222) --------------------------
    @property
    def BestInnerBound(self):
        return self.spcomm.BestInnerBound

    @property
    def BestOuterBound(self):
        return self.spcomm.BestOuterBound

    def write_first_stage_solution(self, solution_file_name: str):
        """The incumbent's first-stage (ROOT) values, one "x<i>,<value>"
        line each (ref:spin_the_wheel.py:171-195)."""
        root = self.spcomm.best_nonants()[0]
        stage1 = root[np.nonzero(self.opt.batch.tree.slot_stage == 1)[0]]
        with open(solution_file_name, "w") as f:
            for i, v in enumerate(stage1):
                f.write(f"x{i},{v}\n")
