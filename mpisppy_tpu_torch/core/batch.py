###############################################################################
# Scenario batch: the data plane (port of mpisppy_tpu/core/batch.py:
# dense or ELL constraint matrices, box rows and second-order-cone
# blocks).
#
#   specs (host, numpy)  --from_specs-->  ScenarioBatch (device tensors)
#
# Ruiz equilibration is applied at build time; PH-layer math (prox
# terms, W vectors, xbar averaging) happens in ORIGINAL variable space
# and is mapped into the scaled space via the stored column scalings.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import resolve_device
from mpisppy_tpu_torch.core.tree import ScenarioTree, two_stage_tree
from mpisppy_tpu_torch.ops import cones as cones_mod
from mpisppy_tpu_torch.ops import sparse as sparse_mod
from mpisppy_tpu_torch.ops.boxqp import BoxQP, ruiz_scale

Tensor = torch.Tensor


@dataclasses.dataclass
class ScenarioSpec:
    """One scenario's subproblem in original (unscaled) space
    (ref:examples/farmer/farmer.py:31-89 scenario_creator output).

    nonant_idx: column indices of nonanticipative variables, ordered
    stage-major for multistage problems.  All scenarios of a batch must
    use the same column layout."""

    name: str
    c: np.ndarray
    A: np.ndarray
    bl: np.ndarray
    bu: np.ndarray
    l: np.ndarray  # noqa: E741
    u: np.ndarray
    nonant_idx: np.ndarray
    q: np.ndarray | None = None
    probability: float | None = None  # None -> uniform
    integer: np.ndarray | None = None  # bool over all n columns
    # per-slot nonant weights for variable-probability problems
    # (ref:mpisppy/spbase.py:398-441); None -> ordinary probabilities
    var_prob: np.ndarray | None = None
    # second-order-cone row blocks: a list of int row-index arrays, HEAD
    # FIRST; SOC rows carry bl == bu == b.  The pattern must be identical
    # across the batch.  None -> a pure box problem (ops/cones.py).
    soc_blocks: list | None = None


@dataclasses.dataclass(frozen=True)
class ScenarioBatch:
    """All scenarios of a problem as device tensors.

    qp:           scaled, batched BoxQP (leading axis S; A may be (m,n)
                  shared when the constraint matrix is deterministic).
    d_col/d_row:  Ruiz scalings; x_orig = d_col * x_scaled.
    d_non:        d_col gathered at nonant columns ((N,) or (S,N)).
    p:            (S,) scenario probabilities (padded scenarios get 0).
    nonant_idx:   (N,) int64 nonant column indices (shared layout).
    node_of_slot: (S, N) int64 owning tree-node id per scenario slot.
    integer_slot: (N,) bool integrality of each nonant slot.
    integer_full: (n,) bool integrality of every column.
    tree:         ScenarioTree metadata.
    num_real:     scenarios before padding.
    var_prob:     (S, N) per-(scenario, slot) weights or None."""

    qp: BoxQP
    d_col: Tensor
    d_row: Tensor
    d_non: Tensor
    p: Tensor
    nonant_idx: Tensor
    node_of_slot: Tensor
    integer_slot: Tensor
    integer_full: Tensor
    tree: ScenarioTree
    num_real: int
    var_prob: Tensor | None = None

    @property
    def num_scenarios(self) -> int:
        return self.qp.c.shape[0]

    @property
    def num_nonants(self) -> int:
        return int(self.nonant_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.qp.device

    # ---- original-space views -------------------------------------------
    def nonants(self, x_scaled: Tensor) -> Tensor:
        """(S, N) original-space nonant values from scaled iterates."""
        return self.d_non * x_scaled[..., self.nonant_idx]

    def objective(self, x_scaled: Tensor) -> Tensor:
        """Per-scenario ORIGINAL objective (scaled c,q absorb d_col)."""
        return torch.sum(self.qp.c * x_scaled
                         + 0.5 * self.qp.q * x_scaled ** 2, dim=-1)

    def node_average(self, vals: Tensor, weights: Tensor | None = None):
        """Probability-weighted mean of per-scenario slot values within
        each owning tree node — the nonanticipativity reduction
        (ref:mpisppy/phbase.py:32-112).  vals: (S, N).  Returns
        (avg_per_scen (S, N), avg_nodes (num_nodes, N))."""
        if weights is None:
            weights = self.var_prob  # may still be None
        w = self.p[:, None] if weights is None else weights
        tiny = 1e-30
        wb = torch.broadcast_to(w, vals.shape)
        if self.tree.num_nodes == 1:
            num = torch.sum(w * vals, dim=0)
            den = torch.sum(wb, dim=0)
            avg = num / torch.clamp(den, min=tiny)
            return torch.broadcast_to(avg, vals.shape), avg[None, :]
        N = self.num_nonants
        nseg = self.tree.num_nodes * N
        key = (self.node_of_slot * N
               + torch.arange(N, device=vals.device)[None, :]).reshape(-1)
        num = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
        num.index_add_(0, key, (w * vals).reshape(-1))
        den = torch.zeros(nseg, dtype=vals.dtype, device=vals.device)
        den.index_add_(0, key, wb.reshape(-1))
        avg_nodes = (num / torch.clamp(den, min=tiny)).reshape(
            self.tree.num_nodes, N)
        avg_scen = torch.gather(avg_nodes, 0, self.node_of_slot)
        return avg_scen, avg_nodes

    def nonant_box(self) -> "tuple[np.ndarray, np.ndarray]":
        """(lb, ub) of the nonant slots in ORIGINAL space: the tightest
        intersection across scenarios (host arrays; static per batch)."""
        idx = self.nonant_idx.cpu().numpy()
        S, n = self.num_scenarios, self.qp.n
        d = np.broadcast_to(self.d_non.cpu().numpy(), (S, len(idx)))
        l_s = np.broadcast_to(self.qp.l.cpu().numpy(), (S, n))[:, idx] * d
        u_s = np.broadcast_to(self.qp.u.cpu().numpy(), (S, n))[:, idx] * d
        return l_s.max(0), u_s.min(0)

    def expectation(self, vals: Tensor) -> Tensor:
        """E[vals] over scenarios (ref:mpisppy/spopt.py:344-436)."""
        return torch.sum(self.p * vals)

    def with_nonant_linear_quad(self, w: Tensor, rho_quad: Tensor) -> BoxQP:
        """A qp whose objective adds, in ORIGINAL space,
        w·x_non + 1/2 x_non' diag(rho_quad) x_non over the nonant slots
        (ref:mpisppy/phbase.py:670-760): c += d_non*w, q += d_non^2*rho."""
        idx = self.nonant_idx
        c_add = torch.zeros_like(self.qp.c)
        c_add[..., idx] = torch.broadcast_to(self.d_non * w,
                                             c_add[..., idx].shape)
        q_add = torch.zeros_like(self.qp.q)
        q_add[..., idx] = torch.broadcast_to(
            self.d_non * self.d_non * rho_quad, q_add[..., idx].shape)
        return dataclasses.replace(self.qp, c=self.qp.c + c_add,
                                   q=self.qp.q + q_add)

    def with_fixed_nonants(self, xhat_nodes: Tensor) -> BoxQP:
        """Fix each scenario's nonants to its tree nodes' values
        (original space) by collapsing the box to a point
        (ref:mpisppy/spopt.py:633-674).  xhat_nodes: (num_nodes, N) or
        (N,)."""
        if xhat_nodes.ndim == 2:
            xhat = torch.gather(xhat_nodes, 0, self.node_of_slot)
        else:
            xhat = torch.broadcast_to(xhat_nodes, self.node_of_slot.shape)
        xs = xhat / self.d_non  # to scaled space; (S, N)
        S, n = self.qp.c.shape
        l_full = torch.broadcast_to(self.qp.l, (S, n)).clone()
        u_full = torch.broadcast_to(self.qp.u, (S, n)).clone()
        l_full[:, self.nonant_idx] = xs
        u_full[:, self.nonant_idx] = xs
        return dataclasses.replace(self.qp, l=l_full, u=u_full)


def concretize(batch):
    """Realize a scengen VirtualBatch into a plain ScenarioBatch; a
    ScenarioBatch passes through untouched.  Every step of the solver
    stack that reads scenario data calls this at entry, so synthesized
    data exists only while that step runs and is never cached."""
    if getattr(batch, "is_virtual", False):
        return batch.realize()
    return batch


def scale_field(name: str, val: Tensor, d_row: Tensor,
                d_col: Tensor) -> Tensor:
    """Apply a SHARED Ruiz scaling to one f32 qp field — the one
    arithmetic that host materialization (from_specs with `scaling=`)
    and device synthesis (VirtualBatch.realize) share, so the two are
    bit-identical: the field is f32 first, then scaled elementwise in
    this order (A: val * d_row[:, None] * d_col, left to right)."""
    if name == "c":
        return val * d_col
    if name == "q":
        return val * d_col * d_col
    if name in ("l", "u"):
        return val / d_col
    if name in ("bl", "bu"):
        return val * d_row
    if name == "A":
        if isinstance(val, sparse_mod.EllMatrix):
            return val.with_vals(val.vals * d_row[..., :, None]
                                 * d_col[..., val.cols])
        return val * d_row[..., :, None] * d_col
    raise ValueError(f"unknown qp field: {name}")


def as_scaled_arrays(scaling, dtype=torch.float32, device=None):
    """(d_row, d_col) of a boxqp.Scaling as working-dtype tensors — the
    shared f64 -> f32 conversion point of the template-scaling path."""
    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(
            dtype).to(device)
    return t(scaling.d_row), t(scaling.d_col)


def _scaled_qp(stack, A, specs, n: int, scaling, cones, dev) -> BoxQP:
    """The template-scaling path of from_specs: every field f32 first,
    then scale_field; c and q broadcast to (S, n) as stride-0 views."""
    S = len(specs)
    raw_q = [sp.q for sp in specs]
    if all(r is None for r in raw_q):
        q_arr = np.zeros(n)
    else:
        q_arr = np.stack([np.zeros(n) if r is None
                          else np.asarray(r, np.float64) for r in raw_q])
    d_row, d_col = as_scaled_arrays(scaling, device=dev)

    def sf(name, arr):
        if isinstance(arr, sparse_mod.EllMatrix):
            return scale_field(name, arr.to(dev), d_row, d_col)
        v = torch.as_tensor(np.asarray(arr, np.float32)).to(dev)
        return scale_field(name, v, d_row, d_col)

    return BoxQP(c=sf("c", stack("c")).expand(S, n),
                 q=sf("q", q_arr).expand(S, n),
                 A=sf("A", A), bl=sf("bl", stack("bl")),
                 bu=sf("bu", stack("bu")), l=sf("l", stack("l")),
                 u=sf("u", stack("u")), cones=cones)


def from_specs(specs: list[ScenarioSpec],
               tree: ScenarioTree | None = None,
               scale: bool = True, device=None,
               scaling=None) -> ScenarioBatch:
    """Stack scenario specs into a device batch (the scenario compiler).
    Runs on CUDA unless device="cpu" is given.  The problem is made in
    f32 and Ruiz-scaled in numpy f64 before the cast back, exactly as
    the JAX package does, so the scaled arrays match it bit for bit.

    scaling: a precomputed SHARED boxqp.Scaling (the scengen template
    path): Ruiz equilibration is skipped and (d_row, d_col) are applied
    through scale_field's f32 arithmetic, bit-identical to what
    scengen.VirtualBatch.realize synthesizes from the same program."""
    dev = resolve_device(device)
    if not specs:
        raise ValueError("need at least one scenario")
    n = specs[0].c.shape[0]
    nonant_idx = np.asarray(specs[0].nonant_idx, np.int64)
    for sp in specs:
        if sp.c.shape[0] != n or not np.array_equal(
                np.asarray(sp.nonant_idx, np.int64), nonant_idx):
            raise ValueError(f"scenario {sp.name}: inconsistent layout")

    if tree is None:
        tree = two_stage_tree(len(specs), len(nonant_idx))
    if tree.num_nonant_slots != len(nonant_idx):
        raise ValueError("nonant_idx length does not match tree slots")
    if tree.num_scenarios != len(specs):
        raise ValueError("scenario count does not match tree")

    probs = np.array([1.0 / len(specs) if sp.probability is None
                      else sp.probability for sp in specs])
    if not np.isclose(probs.sum(), 1.0, atol=1e-6):
        raise ValueError(f"scenario probabilities sum to {probs.sum()}")

    def stack(field):
        raw = [getattr(sp, field) for sp in specs]
        if all(a is raw[0] for a in raw[1:]):
            # identity fast path: generators share deterministic arrays
            return np.asarray(raw[0], np.float64)
        arrs = [np.asarray(a, np.float64) for a in raw]
        first = arrs[0]
        if all(a.shape == first.shape and np.array_equal(a, first)
               for a in arrs[1:]):
            return first  # shared across the batch (broadcasts)
        return np.stack(arrs)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    def stack_A():
        """Dense specs stack like any field; scipy-sparse specs become
        one EllMatrix, shared when the matrices are one object or equal
        in value, with batched values otherwise."""
        import scipy.sparse as sps
        raw = [sp.A for sp in specs]
        if not any(sps.issparse(a) for a in raw):
            return f32(stack("A"))
        if all(a is raw[0] for a in raw[1:]):
            return sparse_mod.ell_from_scipy(raw[0])
        return sparse_mod.ell_from_scipy_batch(raw)

    A = stack_A()
    cones = None
    if any(sp.soc_blocks for sp in specs):
        blocks0 = [np.asarray(b, np.int64)
                   for b in (specs[0].soc_blocks or [])]
        for sp in specs[1:]:
            other = sp.soc_blocks or []
            if len(other) != len(blocks0) or not all(
                    np.array_equal(np.asarray(b, np.int64), b0)
                    for b, b0 in zip(other, blocks0)):
                raise ValueError(
                    f"scenario {sp.name}: SOC block pattern differs from "
                    "scenario 0's (the cone partition is shared across "
                    "the batch, like the nonant layout)")
        cones = cones_mod.cone_spec(specs[0].A.shape[0], blocks0)
        cones_mod.validate_against_bounds(cones, stack("bl"), stack("bu"))
    if scaling is not None:
        qp = _scaled_qp(stack, A, specs, n, scaling, cones, dev)
        d_col, d_row = scaling.d_col, scaling.d_row
    else:
        c = np.stack([np.asarray(sp.c, np.float64) for sp in specs])
        q = np.stack([np.zeros(n) if sp.q is None
                      else np.asarray(sp.q, np.float64) for sp in specs])
        qp = BoxQP(c=f32(c), q=f32(q), A=A,
                   bl=f32(stack("bl")), bu=f32(stack("bu")),
                   l=f32(stack("l")), u=f32(stack("u")), cones=cones)
        if scale:
            qp, scaling = ruiz_scale(qp)
            d_col, d_row = scaling.d_col, scaling.d_row
        else:
            d_col = np.ones(A.shape[:-2] + (n,))
            d_row = np.ones(A.shape[:-1])
    d_col_t = f32(d_col)

    integer = np.zeros(n, bool)
    if specs[0].integer is not None:
        integer = np.asarray(specs[0].integer, bool)

    var_prob = None
    if any(sp.var_prob is not None for sp in specs):
        # absolute per-(scenario, slot) probabilities; specs without one
        # default to their scenario probability (ref:spbase.py:398-441)
        var_prob = f32(np.stack([
            np.full(len(nonant_idx), probs[i]) if sp.var_prob is None
            else np.asarray(sp.var_prob, np.float64)
            for i, sp in enumerate(specs)])).to(dev)

    idx = torch.as_tensor(nonant_idx)
    if cones is not None:
        cones = cones.to(dev)
    qp = BoxQP(c=qp.c.to(dev), q=qp.q.to(dev), A=qp.A.to(dev),
               bl=qp.bl.to(dev), bu=qp.bu.to(dev), l=qp.l.to(dev),
               u=qp.u.to(dev), cones=cones)
    return ScenarioBatch(
        var_prob=var_prob,
        qp=qp,
        d_col=d_col_t.to(dev),
        d_row=f32(d_row).to(dev),
        d_non=d_col_t[..., idx].to(dev),
        p=f32(probs).to(dev),
        nonant_idx=idx.to(dev),
        node_of_slot=torch.as_tensor(
            tree.node_of_slot().astype(np.int64)).to(dev),
        integer_slot=torch.as_tensor(integer[nonant_idx]).to(dev),
        integer_full=torch.as_tensor(integer).to(dev),
        tree=tree,
        num_real=len(specs),
    )


def pad_to_multiple(batch: ScenarioBatch, multiple: int) -> ScenarioBatch:
    """Pad the scenario axis to a multiple.  Padded rows duplicate the
    last scenario with probability 0, so every p-weighted reduction
    (xbar, bounds, convergence) is unchanged.  The cone partition is
    shared across the batch and carries over as it is."""
    S = batch.num_scenarios
    pad = (-S) % multiple
    if pad == 0:
        return batch

    def pad_leading(x, batched_ndim):
        """Pad only fields that carry the scenario axis (identified by
        ndim, not shape[0], so m == S or n == S cannot misfire).  An ELL
        A pads its values; the pattern is shared."""
        if isinstance(x, sparse_mod.EllMatrix):
            return x.with_vals(pad_leading(x.vals, batched_ndim))
        if x.ndim != batched_ndim:
            return x
        return torch.cat([x, x[-1:].repeat_interleave(pad, dim=0)], dim=0)

    qp = batch.qp
    qp = dataclasses.replace(
        qp,
        c=pad_leading(qp.c, 2), q=pad_leading(qp.q, 2),
        A=pad_leading(qp.A, 3),
        bl=pad_leading(qp.bl, 2), bu=pad_leading(qp.bu, 2),
        l=pad_leading(qp.l, 2), u=pad_leading(qp.u, 2),
    )
    var_prob = batch.var_prob
    if var_prob is not None:
        # padded rows get ZERO weights (they would enter the denominators)
        var_prob = torch.cat([var_prob, var_prob.new_zeros(
            (pad,) + tuple(var_prob.shape[1:]))], dim=0)
    return dataclasses.replace(
        batch,
        qp=qp,
        d_col=pad_leading(batch.d_col, 2),
        d_row=pad_leading(batch.d_row, 2),
        d_non=pad_leading(batch.d_non, 2),
        p=torch.cat([batch.p, batch.p.new_zeros(pad)]),
        node_of_slot=pad_leading(batch.node_of_slot, 2),
        var_prob=var_prob,
    )
