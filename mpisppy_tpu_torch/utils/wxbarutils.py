###############################################################################
# W / x̄ files and solver-state leaves for checkpoints (port of
# mpisppy_tpu/utils/wxbarutils.py; ref:mpisppy/utils/wxbarutils.py:
# 47-391).
#
# W and x̄ files are CSV text, row for row the JAX package's: W as
# "scenario_name,slot,value" per (scenario, slot), x̄ as "node,slot,value"
# per (tree node, slot), each value the repr of the float32 as a Python
# float.  So each package reads the files the other writes, bit for bit.
# Loading W checks the PH invariant (a zero p-weighted node mean) unless
# told not to.
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

from mpisppy_tpu_torch.core.batch import is_root


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


# ---- W ---------------------------------------------------------------------
def write_W_to_file(ph, fname: str, sep_files: bool = False):
    """ref:wxbarutils.py:47-90.  csv rows: scenario_name,slot,value.  On
    a sharded batch the whole axis's rows, written by rank 0."""
    W = ph.batch.scen_host(ph.state.W)
    if not is_root(ph.batch):
        return
    with open(fname, "w") as f:
        for s, nm in enumerate(ph.scenario_names):
            for i in range(W.shape[1]):
                f.write(f"{nm},{i},{float(W[s, i])!r}\n")


def set_W_from_file(fname: str, ph, disable_check: bool = False):
    """ref:wxbarutils.py:92-134.  Loads W and installs it into the PH
    state; checks that its p-weighted node mean is ~0 (the PH invariant,
    ref:wxbarutils.py:224-275 _check_W) unless disabled.  On a sharded
    batch each rank installs its rows of the file's whole axis."""
    W = ph.batch.scen_host(ph.state.W).copy()
    index = {nm: s for s, nm in enumerate(ph.scenario_names)}
    with open(fname) as f:
        for line in f:
            nm, i, v = line.rsplit(",", 2)
            if nm not in index:
                raise ValueError(f"unknown scenario {nm!r} in {fname}")
            W[index[nm], int(i)] = float(v)
    start = ph.batch.scen_start
    Wt = torch.as_tensor(W[start:start + ph.batch.num_scenarios],
                         dtype=ph.batch.qp.c.dtype, device=ph.batch.device)
    if not disable_check:
        wbar, _ = ph.batch.node_average(Wt)
        if float(wbar.abs().max()) > 1e-4 * (1.0 + np.abs(W).max()):
            raise ValueError(
                "loaded W has nonzero probability-weighted node mean "
                "(invalid PH duals; pass disable_check to force)")
    ph.state = dataclasses.replace(ph.state, W=Wt)


# ---- xbar ------------------------------------------------------------------
def write_xbar_to_file(ph, fname: str):
    """ref:wxbarutils.py:276-296.  csv rows: node,slot,value (rank 0
    writes on a sharded batch)."""
    if not is_root(ph.batch):
        return
    xb = ph.state.xbar_nodes.cpu().numpy()
    with open(fname, "w") as f:
        for nd in range(xb.shape[0]):
            for i in range(xb.shape[1]):
                f.write(f"{nd},{i},{float(xb[nd, i])!r}\n")


def set_xbar_from_file(fname: str, ph):
    """ref:wxbarutils.py:298-356: x̄ per node, and its per-scenario
    view."""
    xb = ph.state.xbar_nodes.cpu().numpy().copy()
    with open(fname) as f:
        for line in f:
            nd, i, v = line.split(",")
            xb[int(nd), int(i)] = float(v)
    batch = ph.batch
    xbt = torch.as_tensor(xb, dtype=batch.qp.c.dtype, device=batch.device)
    if batch.tree.num_nodes > 1:
        xbar_scen = torch.gather(xbt, 0, batch.node_of_slot)
    else:
        xbar_scen = xbt[0].expand_as(ph.state.xbar).clone()
    ph.state = dataclasses.replace(ph.state, xbar_nodes=xbt,
                                   xbar=xbar_scen)


def ROOT_xbar_npy_serializer(ph, fname: str):
    """ref:wxbarutils.py:378-388: flat npy of the root-node x̄ (rank 0
    writes on a sharded batch)."""
    if is_root(ph.batch):
        np.save(fname, ph.state.xbar_nodes[0].cpu().numpy())


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
