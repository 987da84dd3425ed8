###############################################################################
# Scenario/bundle (de)serialization (port of mpisppy_tpu/utils/
# pickle_bundle.py; ref:mpisppy/utils/pickle_bundle.py:21-59).
#
# The reference dill-pickles Pyomo bundle models so that expensive
# scenario construction amortizes across runs; specs are numpy/scipy
# objects, so pickle suffices.  Reading goes through a restricted
# unpickler: it builds numpy arrays, scipy sparse matrices and the
# port's ScenarioSpec, and nothing else.  A bundle pickled by the JAX
# package names mpisppy_tpu.core.batch.ScenarioSpec; that class maps to
# the port's ScenarioSpec (the same fields), so the port reads such a
# pickle without importing the JAX package.
###############################################################################
from __future__ import annotations

import os
import pickle

from mpisppy_tpu_torch.core.batch import ScenarioSpec

# (module, name) -> class: the spec classes a bundle pickle may name
_SPEC_CLASSES = {
    ("mpisppy_tpu_torch.core.batch", "ScenarioSpec"): ScenarioSpec,
    ("mpisppy_tpu.core.batch", "ScenarioSpec"): ScenarioSpec,
}
# the module prefixes whose classes a spec's arrays need
_ARRAY_MODULES = ("numpy", "scipy.sparse")
_SAFE_BUILTINS = {("copyreg", "_reconstructor"), ("builtins", "object"),
                  ("builtins", "slice"), ("builtins", "complex"),
                  ("_codecs", "encode")}


class _SpecUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SPEC_CLASSES:
            return _SPEC_CLASSES[module, name]
        if (module, name) in _SAFE_BUILTINS or any(
                module == m or module.startswith(m + ".")
                for m in _ARRAY_MODULES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"a bundle pickle may hold a ScenarioSpec of numpy/scipy "
            f"arrays only; it names {module}.{name}")


def dill_pickle(obj, fname: str):
    """ref:pickle_bundle.py:21-27 (dill there; specs need only pickle)."""
    with open(fname, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def dill_unpickle(fname: str):
    """ref:pickle_bundle.py:29-35, through the restricted unpickler."""
    with open(fname, "rb") as f:
        return _SpecUnpickler(f).load()


def check_args(cfg):
    """ref:pickle_bundle.py:39-52 cross-option validation."""
    assert cfg.get("pickle_bundles_dir") is None \
        or cfg.get("unpickle_bundles_dir") is None, \
        "can't pickle and unpickle bundles in the same run"
    if cfg.get("pickle_bundles_dir") is not None \
            or cfg.get("unpickle_bundles_dir") is not None:
        assert cfg.get("scenarios_per_bundle") is not None, \
            "bundle pickling needs scenarios_per_bundle"


def have_proper_bundles(cfg) -> bool:
    """ref:pickle_bundle.py:54-59."""
    return (cfg.get("pickle_bundles_dir") is not None
            or cfg.get("unpickle_bundles_dir") is not None
            or cfg.get("scenarios_per_bundle") is not None)


def write_spec(spec, dirname: str):
    os.makedirs(dirname, exist_ok=True)
    dill_pickle(spec, os.path.join(dirname, f"{spec.name}.pkl"))


def read_spec(dirname: str, name: str):
    return dill_unpickle(os.path.join(dirname, f"{name}.pkl"))
