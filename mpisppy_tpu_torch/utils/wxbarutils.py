###############################################################################
# Solver-state leaves for checkpoints (port of the full-state part of
# mpisppy_tpu/utils/wxbarutils.py; its W/x̄ file readers and writers wait
# for ROADMAP.md queue A, item 8).
#
# A checkpoint stores a state as numbered leaves, leaf0, leaf1, ..., in
# the order jax.tree.flatten gives the JAX package's registered
# dataclasses: every field in declaration order (the JAX data_fields
# order, which the port's dataclasses keep), a None field giving no
# leaf, a nested dataclass flattening in place.  state_leaves walks the
# port's frozen dataclasses (PDHGState, KernelCounters, PHState, APHState,
# FusedWheelState) the same way, so a snapshot written by either package
# restores in the other.  Two leaves are host ints in the port and 0-d
# int32 arrays in the JAX package: PDHGState.k and
# KernelCounters.ring_pos; they are written as np.int32 and read back as
# int.
###############################################################################
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

class LeafSpec(NamedTuple):
    """The shape and numpy dtype a checkpoint leaf must have."""

    shape: tuple
    dtype: np.dtype


def state_leaves(st) -> list:
    """The leaves of a state dataclass in the JAX flatten order: tensors
    and host ints."""
    out = []

    def walk(v):
        if v is None:
            return
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        else:
            out.append(v)
    walk(st)
    return out


def leaf_tensor(x) -> torch.Tensor:
    """One leaf as a tensor: a host int becomes a 0-d int32 (the JAX
    package's dtype for it)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.int32)


def leaf_array(x) -> np.ndarray:
    """One leaf as the array a checkpoint stores."""
    return leaf_tensor(x).detach().cpu().numpy()


def leaf_specs(template) -> list[LeafSpec]:
    """The (shape, dtype) of every leaf of a state or state template (a
    template's tensors may live on the meta device)."""
    return [LeafSpec(tuple(t.shape),
                     torch.empty(0, dtype=t.dtype).numpy().dtype)
            for t in map(leaf_tensor, state_leaves(template))]


def state_from_leaves(template, arrays, device):
    """A state of the template's structure from its leaves (numpy
    arrays, in state_leaves order), its tensors on `device`; a host-int
    leaf of the template comes back as int."""
    it = iter(arrays)

    def build(v):
        if v is None:
            return None
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{
                f.name: build(getattr(v, f.name))
                for f in dataclasses.fields(v) if f.init})
        a = next(it)
        if isinstance(v, torch.Tensor):
            return torch.as_tensor(np.array(a)).to(device)
        return int(a)
    return build(template)


# ---- full-state checkpointing ----------------------------------------------
def validate_state_leaves(arrays: dict, leaves) -> None:
    """Checkpoint-compatibility gate shared by every state restore path
    (hub.load_checkpoint and load_ph_state): each flattened leaf{i} must
    be present with the exact expected shape AND dtype — a float64 leaf
    silently upcasting a float32 state would poison every downstream
    jit cache.  Raises ValueError on the first incompatibility."""
    n = len(leaves)
    missing = [i for i in range(n) if f"leaf{i}" not in arrays]
    if missing:
        raise ValueError(f"checkpoint missing leaves {missing} "
                         f"(different problem/options?)")
    for i in range(n):
        a, b = arrays[f"leaf{i}"], leaves[i]
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(
                f"checkpoint leaf {i} shape {tuple(a.shape)} != expected "
                f"{tuple(b.shape)} (different problem/options?)")
        if np.dtype(a.dtype) != np.dtype(b.dtype):
            raise ValueError(
                f"checkpoint leaf {i} dtype {a.dtype} != expected "
                f"{np.dtype(b.dtype)} (different problem/options?)")


def save_ph_state(fname: str, ph):
    """npz snapshot of every state leaf + the iteration counter; exact
    resume (same shapes) via load_ph_state."""
    np.savez(fname, _iter=ph._iter,
             **{f"leaf{i}": leaf_array(x)
                for i, x in enumerate(state_leaves(ph.state))})


def load_ph_state(fname: str, ph):
    with np.load(fname) as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    validate_state_leaves(arrays, leaf_specs(ph.state))
    n = len(state_leaves(ph.state))
    ph.state = state_from_leaves(
        ph.state, [arrays[f"leaf{i}"] for i in range(n)], ph.batch.device)
    ph._iter = int(arrays["_iter"])
