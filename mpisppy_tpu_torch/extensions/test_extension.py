# Scaffolding extension that records every callout in order (port of
# mpisppy_tpu/extensions/test_extension.py; ref:mpisppy/extensions/
# test_extension.py:15), used by the tests to show that PH fires
# each hook at its documented point of the iteration sequence.
from mpisppy_tpu_torch.extensions.extension import Extension


class TestExtension(Extension):
    """Appends each hook name to self.opt._TestExtension_who_is_called
    (a list on the PH object, so MultiExtension composition and PH
    rebuilds both keep one shared trace)."""

    __test__ = False  # not a pytest class

    def __init__(self, ph):
        super().__init__(ph)
        if not hasattr(ph, "_TestExtension_who_is_called"):
            ph._TestExtension_who_is_called = []
        self.who_is_called = ph._TestExtension_who_is_called

    def _record(self, name):
        self.who_is_called.append(name)


def _make_hook(name):
    def hook(self, *args, **kwargs):
        self._record(name)
    hook.__name__ = name
    return hook


for _h in ("pre_iter0", "iter0_post_solver_creation", "post_iter0",
           "post_iter0_after_sync", "miditer", "enditer",
           "enditer_after_sync", "post_everything", "pre_solve_loop",
           "post_solve_loop", "pre_solve", "post_solve", "setup_hub",
           "initialize_spoke_indices", "sync_with_spokes"):
    setattr(TestExtension, _h, _make_hook(_h))
del _h
