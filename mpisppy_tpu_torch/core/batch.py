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
    num_real:     scenarios before padding (over the whole scenario axis
                  on a sharded batch).
    var_prob:     (S, N) per-(scenario, slot) weights or None.
    mesh:         the parallel.mesh.ScenarioMesh of a sharded batch, else
                  None.  A sharded batch holds its rank's contiguous
                  slice of every scenario-major field (rows scen_offset
                  onward); its scenario reductions finish with an
                  all-reduce over the mesh's process group."""

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
    mesh: object | None = None
    scen_offset: int = 0

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
        (avg_per_scen (S, N), avg_nodes (num_nodes, N)).  On a sharded
        batch the numerator and denominator are summed over the mesh."""
        if weights is None:
            weights = self.var_prob  # may still be None
        w = self.p[:, None] if weights is None else weights
        tiny = 1e-30
        wb = torch.broadcast_to(w, vals.shape)
        if self.tree.num_nodes == 1:
            num = torch.sum(w * vals, dim=0)
            den = torch.sum(wb, dim=0)
            num, den = _mesh_sum_pair(self, num, den)
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
        num, den = _mesh_sum_pair(self, num, den)
        avg_nodes = (num / torch.clamp(den, min=tiny)).reshape(
            self.tree.num_nodes, N)
        avg_scen = torch.gather(avg_nodes, 0, self.node_of_slot)
        return avg_scen, avg_nodes

    def nonant_box(self) -> "tuple[np.ndarray, np.ndarray]":
        """(lb, ub) of the nonant slots in ORIGINAL space: the tightest
        intersection across scenarios (host arrays; static per batch).
        On a sharded batch with per-scenario boxes or scalings the
        intersection finishes over the mesh."""
        idx = self.nonant_idx.cpu().numpy()
        S, n = self.num_scenarios, self.qp.n
        d = np.broadcast_to(self.d_non.cpu().numpy(), (S, len(idx)))
        l_s = np.broadcast_to(self.qp.l.cpu().numpy(), (S, n))[:, idx] * d
        u_s = np.broadcast_to(self.qp.u.cpu().numpy(), (S, n))[:, idx] * d
        lb, ub = l_s.max(0), u_s.min(0)
        if on_mesh(self) and max(self.d_non.ndim, self.qp.l.ndim,
                                  self.qp.u.ndim) == 2:
            lb = mesh_reduce(self, torch.as_tensor(lb, device=self.device),
                             "max").cpu().numpy()
            ub = mesh_reduce(self, torch.as_tensor(ub, device=self.device),
                             "min").cpu().numpy()
        return lb, ub

    def expectation(self, vals: Tensor) -> Tensor:
        """E[vals] over scenarios (ref:mpisppy/spopt.py:344-436)."""
        return mesh_reduce(self, torch.sum(self.p * vals), "sum")

    # ---- scenario reductions that see the whole (sharded) axis ----------
    def all_real(self, ok: Tensor, dim: int | None = None) -> Tensor:
        """True where `ok` holds on every real (p > 0) scenario; ok has
        the scenario axis first, or last with dim=-1."""
        real = self.p > 0.0
        if dim is None:
            t = torch.all(torch.where(real, ok, True))
        else:
            t = torch.all(torch.where(real, ok, True), dim=dim)
        return mesh_reduce(self, t, "min")

    def any_real(self, bad: Tensor) -> Tensor:
        """True where `bad` holds on some real scenario."""
        t = torch.any(torch.where(self.p > 0.0, bad, False))
        return mesh_reduce(self, t, "max")

    def scen_sum(self, vals: Tensor, dim: int = 0) -> Tensor:
        """Plain sum over the scenario axis (`dim`) of the whole batch."""
        return mesh_reduce(self, torch.sum(vals, dim=dim), "sum")

    def scen_extreme(self, vals: Tensor, sense_max: bool) -> Tensor:
        """Max (min) over the real scenarios of (S, N) values."""
        mask = (self.p > 0.0)[:, None]
        if sense_max:
            t = torch.where(mask, vals, float("-inf")).amax(dim=0)
            return mesh_reduce(self, t, "max")
        t = torch.where(mask, vals, float("inf")).amin(dim=0)
        return mesh_reduce(self, t, "min")

    def scen_row(self, vals: Tensor, sid: int) -> Tensor:
        """Row `sid` (a global scenario index) of scenario-major values;
        on a sharded batch its owner supplies it and the others add
        zeros."""
        if self.mesh is None or getattr(self.mesh, "group", None) is None:
            return vals[sid - self.scen_offset]
        local = sid - self.scen_offset
        if 0 <= local < vals.shape[0]:
            row = vals[local]
        else:
            row = torch.zeros_like(vals[0])
        return mesh_reduce(self, row, "sum")

    def scen_gather(self, vals: Tensor) -> Tensor:
        """Every rank's rows of scenario-major values, in global order."""
        mesh = self.mesh
        if mesh is None or getattr(mesh, "group", None) is None:
            return vals
        return mesh.all_gather_cat(vals)

    def scen_host(self, *vals: Tensor):
        """Host (numpy) copies of scenario-major tensors, their GLOBAL
        rows: the JAX package's np.asarray of a sharded array.  On a
        sharded batch the tensors are packed into one all-gather per
        dtype, so every rank gets the same arrays and runs the same host
        logic on them.  One tensor in, one array out; several, a tuple."""
        if not on_mesh(self):
            out = [v.detach().cpu().numpy() for v in vals]
            return out[0] if len(vals) == 1 else tuple(out)
        groups: dict = {}
        for i, v in enumerate(vals):
            groups.setdefault(torch.int32 if v.dtype == torch.bool
                              else v.dtype, []).append(i)
        out = [None] * len(vals)
        for dt, idx in groups.items():
            flat = [vals[i].detach().to(dt).reshape(vals[i].shape[0], -1)
                    for i in idx]
            every = self.mesh.all_gather_cat(torch.cat(flat, dim=1))
            col = 0
            for i, f in zip(idx, flat):
                a = every[:, col:col + f.shape[1]].reshape(
                    (every.shape[0],) + tuple(vals[i].shape[1:]))
                if vals[i].dtype == torch.bool:
                    a = a.to(torch.bool)
                out[i] = a.cpu().numpy()
                col += f.shape[1]
        return out[0] if len(vals) == 1 else tuple(out)

    @property
    def scen_start(self) -> int:
        """Global index of this rank's first row (0 unsharded)."""
        return self.scen_offset if on_mesh(self) else 0

    @property
    def scen_total(self) -> int:
        """Scenarios on the whole (padded) axis: every rank's rows."""
        return self.num_scenarios * (self.mesh.world if on_mesh(self)
                                     else 1)

    def scen_argmax(self, vals: Tensor) -> int:
        """GLOBAL index of the largest of (S,) values, the first one on
        ties (torch.argmax's rule over the whole axis): each rank's
        first maximum and its global index, gathered in rank order."""
        local = int(torch.argmax(vals))
        if not on_mesh(self):
            return local
        pair = torch.stack([vals[local].to(torch.float64),
                            torch.tensor(float(local + self.scen_start),
                                         dtype=torch.float64,
                                         device=vals.device)])
        every = self.mesh.all_gather_cat(pair[None]).cpu().numpy()
        return int(every[int(np.argmax(every[:, 0])), 1])

    def scen_topk_mask(self, keys: Tensor, k: int) -> Tensor:
        """(S,) bool: this rank's rows among the k largest of (S,) keys
        over the whole scenario axis, by a stable descending sort (the
        lower global index first on ties)."""
        every = self.scen_gather(keys)
        order = torch.sort(every, descending=True, stable=True)[1]
        mask = torch.zeros(every.shape[0], dtype=torch.bool,
                           device=keys.device)
        mask[order[:k]] = True
        return mask[self.scen_start:self.scen_start + keys.shape[0]]

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


def on_mesh(batch) -> bool:
    """Whether the batch is sharded over a process group (a layout
    without one runs no collective)."""
    mesh = getattr(batch, "mesh", None)
    return mesh is not None and getattr(mesh, "group", None) is not None


def mesh_broadcast(batch, t: Tensor, src: int = 0) -> Tensor:
    """Rank `src`'s `t` on every rank of the batch's mesh: a replicated
    host decision made once, so ranks cannot drift apart; the identity
    without a process group."""
    if not on_mesh(batch):
        return t
    return batch.mesh.broadcast(t, src)


def is_root(batch) -> bool:
    """Whether this rank makes the batch's replicated decisions (rank
    0, or the only rank)."""
    return not on_mesh(batch) or batch.mesh.rank == 0


def mesh_reduce(batch, t: Tensor, op: str) -> Tensor:
    """Finish a rank-local scenario reduction over the batch's mesh
    ("sum", "min" or "max"); the identity without a process group."""
    mesh = getattr(batch, "mesh", None)
    if mesh is None or getattr(mesh, "group", None) is None:
        return t
    return mesh.all_reduce(t, op)


def _mesh_sum_pair(batch, a: Tensor, b: Tensor):
    """Sum two same-dtype tensors over the mesh in ONE all-reduce."""
    mesh = getattr(batch, "mesh", None)
    if mesh is None or getattr(mesh, "group", None) is None:
        return a, b
    both = mesh.all_reduce(torch.cat([a.reshape(-1), b.reshape(-1)]),
                           "sum")
    return (both[:a.numel()].reshape(a.shape),
            both[a.numel():].reshape(b.shape))


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
