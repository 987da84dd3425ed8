###############################################################################
# Carrying state across from the JAX package, with numpy in and out.
#
# arrays_of() turns any dataclass of arrays — this package's BoxQP,
# ConeSpec, EllMatrix, PDHGState, FWPHState or ScenarioBatch, or their
# JAX counterparts — into nested dicts of numpy arrays without importing
# JAX (it only calls np.asarray).  The *_from_arrays() builders turn such
# dicts into this package's objects on a device.  Tests use the pair to
# feed both packages identical data.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import resolve_device
from mpisppy_tpu_torch.core.batch import ScenarioBatch
from mpisppy_tpu_torch.core.tree import ScenarioTree
from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.ops.cones import ConeSpec
from mpisppy_tpu_torch.ops.pdhg import PDHGState
from mpisppy_tpu_torch.ops.sparse import EllMatrix


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def arrays_of(obj):
    """Nested dict of numpy arrays from a dataclass of arrays (its
    constructor fields; caches are left behind); plain Python values
    (ints, tuples, None) pass through."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: arrays_of(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init}
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    return _to_numpy(obj)


def _tensor(v, device, dtype=None):
    t = torch.as_tensor(np.array(v), device=device)
    return t if dtype is None else t.to(dtype)


def cone_spec_from_arrays(d: dict | None, device=None) -> ConeSpec | None:
    """A ConeSpec from a dict of its fields (is_soc, is_head, seg,
    num_cones, max_dim, head_rows), or None for None."""
    if d is None:
        return None
    dev = resolve_device(device)
    return ConeSpec(is_soc=_tensor(d["is_soc"], dev, torch.bool),
                    is_head=_tensor(d["is_head"], dev, torch.bool),
                    seg=_tensor(d["seg"], dev, torch.int64),
                    num_cones=int(d["num_cones"]),
                    max_dim=int(d["max_dim"]),
                    head_rows=tuple(int(h) for h in d["head_rows"]))


def ell_from_arrays(d: dict, device=None) -> EllMatrix:
    """An EllMatrix from a dict with the fields vals, cols and n (its
    transposed pattern is derived from cols)."""
    dev = resolve_device(device)
    return EllMatrix(vals=_tensor(d["vals"], dev, torch.float32),
                     cols=_tensor(d["cols"], dev, torch.int64),
                     n=int(d["n"]))


def boxqp_from_arrays(d: dict, device=None) -> BoxQP:
    """A BoxQP from a dict with the fields c, q, A, bl, bu, l, u and,
    where present, cones (a ConeSpec's fields, or None); an A given as a
    dict is an EllMatrix's fields."""
    dev = resolve_device(device)
    A = d["A"]
    A = ell_from_arrays(A, dev) if isinstance(A, dict) \
        else _tensor(A, dev, torch.float32)
    return BoxQP(**{k: _tensor(d[k], dev, torch.float32)
                    for k in ("c", "q", "bl", "bu", "l", "u")},
                 A=A, cones=cone_spec_from_arrays(d.get("cones"), dev))


def pdhg_state_from_arrays(d: dict, device=None) -> PDHGState:
    """A PDHGState from a dict of its fields (k as a 0-d array or int;
    kernel counters are not carried)."""
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(PDHGState):
        if f.name == "counters":
            continue
        v = d[f.name]
        if f.name == "k":
            kw["k"] = int(np.asarray(v))
        else:
            kw[f.name] = _tensor(v, dev)
    return PDHGState(**kw)


def fwph_state_from_arrays(d: dict, device=None):
    """An FWPHState from a dict of its fields (the oracle as a
    PDHGState's dict; next_slot as a 0-d array or int)."""
    from mpisppy_tpu_torch.algos.fwph import FWPHState
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(FWPHState):
        v = d[f.name]
        if f.name == "next_slot":
            kw[f.name] = int(np.asarray(v))
        elif f.name == "oracle":
            kw[f.name] = pdhg_state_from_arrays(v, dev)
        else:
            kw[f.name] = _tensor(v, dev)
    return FWPHState(**kw)


def batch_from_arrays(d: dict, device=None) -> ScenarioBatch:
    """A ScenarioBatch from a dict of its fields (qp and tree as nested
    dicts, as arrays_of() makes them)."""
    dev = resolve_device(device)
    tree = d["tree"]
    if isinstance(tree, dict):
        tree = ScenarioTree(tuple(tree["branching_factors"]),
                            tuple(tree["nonants_per_stage"]))
    f32, i64 = torch.float32, torch.int64
    vp = d.get("var_prob")
    return ScenarioBatch(
        qp=boxqp_from_arrays(d["qp"], dev),
        d_col=_tensor(d["d_col"], dev, f32),
        d_row=_tensor(d["d_row"], dev, f32),
        d_non=_tensor(d["d_non"], dev, f32),
        p=_tensor(d["p"], dev, f32),
        nonant_idx=_tensor(d["nonant_idx"], dev, i64),
        node_of_slot=_tensor(d["node_of_slot"], dev, i64),
        integer_slot=_tensor(d["integer_slot"], dev, torch.bool),
        integer_full=_tensor(d["integer_full"], dev, torch.bool),
        tree=tree,
        num_real=int(d["num_real"]),
        var_prob=None if vp is None else _tensor(vp, dev, f32),
    )
