###############################################################################
# Extension ABC — the hub's callback plane (port of
# mpisppy_tpu/extensions/extension.py; ref:mpisppy/extensions/
# extension.py:18-151).  The PH driver calls the hook methods at fixed
# points (algos/ph.py _ext); extensions read and mutate the driver
# (`self.opt`): its options, its PHState (via dataclasses.replace), or
# its batch.  All 14 reference callout points exist;
# PH drives pre_iter0/iter0_post_solver_creation/post_iter0/
# post_iter0_after_sync/miditer/pre_solve_loop/post_solve_loop/enditer/
# enditer_after_sync/post_everything at the reference's callout points
# (ref:mpisppy/phbase.py:829-1061), and the cylinder layer drives
# setup_hub/sync_with_spokes.  pre_solve/post_solve (per-SUBPROBLEM
# hooks) have no per-scenario callout in the batched design.
# MultiExtension composes several extensions.
###############################################################################
from __future__ import annotations


class Extension:
    """ref:mpisppy/extensions/extension.py:18."""

    def __init__(self, ph):
        self.opt = ph

    def pre_iter0(self):
        pass

    def iter0_post_solver_creation(self):
        pass

    def post_iter0(self):
        pass

    def post_iter0_after_sync(self):
        pass

    def miditer(self):
        pass

    def enditer(self):
        pass

    def enditer_after_sync(self):
        pass

    def post_everything(self):
        pass

    def pre_solve_loop(self):
        pass

    def post_solve_loop(self):
        pass

    def pre_solve(self, subproblem=None):
        pass

    def post_solve(self, subproblem=None, results=None):
        pass

    def setup_hub(self):
        pass

    def initialize_spoke_indices(self):
        pass

    def sync_with_spokes(self):
        pass



class MultiExtension(Extension):
    """Compose several extensions; each hook fans out in order
    (ref:mpisppy/extensions/extension.py:154-226)."""

    def __init__(self, ph, ext_classes):
        super().__init__(ph)
        self.extdict = {}
        for cls in ext_classes:
            # classes, factories and functools.partial(s) all work
            name = getattr(cls, "__name__", None) \
                or getattr(getattr(cls, "func", None), "__name__", None) \
                or f"ext{len(self.extdict)}"
            self.extdict[name] = cls(ph)

    def _fan(self, hook, *args):
        for ext in self.extdict.values():
            getattr(ext, hook)(*args)


def _fan_out(hook):
    def f(self, *args):
        self._fan(hook, *args)
    f.__name__ = hook
    return f


for _hook in ("pre_iter0", "iter0_post_solver_creation", "post_iter0",
              "post_iter0_after_sync", "miditer", "enditer",
              "enditer_after_sync", "post_everything", "pre_solve_loop",
              "post_solve_loop", "pre_solve", "post_solve", "setup_hub",
              "initialize_spoke_indices", "sync_with_spokes"):
    setattr(MultiExtension, _hook, _fan_out(_hook))
del _hook
