###############################################################################
# Extensive form: all scenarios as ONE BoxQP (port of
# mpisppy_tpu/algos/ef.py).
#
# The reference builds the EF as a Pyomo model with per-scenario blocks,
# a probability-weighted objective and reference-variable
# nonanticipativity equality rows (ref:mpisppy/utils/sputils.py:143-357),
# then hands it to a solver (ref:mpisppy/opt/ef.py:75-104).  Here it is
# one block-diagonal BoxQP — scenario blocks on the diagonal, link rows
# x_{s,i} == x_{ref(s),i} — solved by the same PDHG solver as a batch of
# one ((S*n)-wide).  It is the correctness oracle for the decomposition
# algorithms.
#
# Assembly is SPARSE (an ops.sparse.EllMatrix) whenever a scenario
# matrix is scipy-sparse or the dense (m, S*n) block would exceed ~2e7
# entries; tiny oracles stay dense.  SOC blocks shift by their scenario
# block's row offset (link rows stay box rows).
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sps
import torch

from mpisppy_tpu_torch import resolve_device
from mpisppy_tpu_torch.core.batch import ScenarioSpec
from mpisppy_tpu_torch.core.tree import ScenarioTree, two_stage_tree
from mpisppy_tpu_torch.ops import boxqp, cones as cones_mod, pdhg
from mpisppy_tpu_torch.ops import sparse as sparse_mod


@dataclasses.dataclass(frozen=True)
class EFProblem:
    """The assembled extensive form plus bookkeeping to read solutions."""

    qp: boxqp.BoxQP           # scaled
    scaling: boxqp.Scaling
    n_per_scen: int
    probs: np.ndarray         # (S,)
    nonant_idx: np.ndarray    # (N,) columns within one scenario block
    tree: ScenarioTree


def build_ef(specs: list[ScenarioSpec],
             tree: ScenarioTree | None = None,
             scale: bool = True,
             sparse: bool | None = None,
             device=None) -> EFProblem:
    """Assemble the extensive form (f32, on `device`: CUDA unless the
    caller asks for the CPU).  `sparse=None` auto-selects ELL whenever
    any scenario matrix is scipy-sparse or the dense (m, S*n) block
    would exceed ~2e7 entries."""
    dev = resolve_device(device)
    S = len(specs)
    n = specs[0].c.shape[0]
    nonant_idx = np.asarray(specs[0].nonant_idx, np.int64)
    N = len(nonant_idx)
    if tree is None:
        tree = two_stage_tree(S, N)

    probs = np.array([1.0 / S if sp.probability is None else sp.probability
                      for sp in specs])

    # objective: sum_s p_s f_s over the block-concatenated variables
    c = np.concatenate([probs[s] * np.asarray(specs[s].c, np.float64)
                        for s in range(S)])
    q = np.concatenate([
        probs[s] * (np.zeros(n) if specs[s].q is None
                    else np.asarray(specs[s].q, np.float64))
        for s in range(S)])
    l = np.concatenate([np.asarray(sp.l, np.float64) for sp in specs])  # noqa: E741
    u = np.concatenate([np.asarray(sp.u, np.float64) for sp in specs])

    # nonanticipativity: within each tree node every member scenario's
    # slot equals the first member's (ref:mpisppy/utils/sputils.py:300-357)
    node_of_slot = tree.node_of_slot()  # (S, N)
    link_rows = []
    for node in range(tree.num_nodes):
        for i in range(N):
            members = np.nonzero(node_of_slot[:, i] == node)[0]
            for s in members[1:]:
                link_rows.append((members[0], s, i))

    m_block = sum(sp.A.shape[0] for sp in specs)
    m = m_block + len(link_rows)
    bl = np.empty(m)
    bu = np.empty(m)

    if sparse is None:
        sparse = any(sps.issparse(sp.A) for sp in specs) \
            or m * S * n > 2e7

    if sparse:
        blocks = [sps.csr_matrix(sp.A if sps.issparse(sp.A)
                                 else np.asarray(sp.A)) for sp in specs]
        parts = [sps.block_diag(blocks, format="csr")]
        if link_rows:
            rows = np.repeat(np.arange(len(link_rows)), 2)
            cols = np.empty(2 * len(link_rows), np.int64)
            data = np.tile([1.0, -1.0], len(link_rows))
            for r_, (s0, s, i) in enumerate(link_rows):
                cols[2 * r_] = s0 * n + nonant_idx[i]
                cols[2 * r_ + 1] = s * n + nonant_idx[i]
            parts.append(sps.csr_matrix((data, (rows, cols)),
                                        shape=(len(link_rows), S * n)))
        A = sparse_mod.ell_from_scipy(sps.vstack(parts).tocsr()).to(dev)
    else:
        A = np.zeros((m, S * n))
    r = 0
    for s, sp in enumerate(specs):
        ms = sp.A.shape[0]
        if not sparse:
            A[r:r + ms, s * n:(s + 1) * n] = \
                sp.A.toarray() if hasattr(sp.A, "toarray") else sp.A
        bl[r:r + ms] = sp.bl
        bu[r:r + ms] = sp.bu
        r += ms
    for (s0, s, i) in link_rows:
        if not sparse:
            A[r, s0 * n + nonant_idx[i]] = 1.0
            A[r, s * n + nonant_idx[i]] = -1.0
        bl[r] = bu[r] = 0.0
        r += 1

    # SOC blocks shift by their scenario block's row offset
    cones = None
    if any(sp.soc_blocks for sp in specs):
        all_blocks = []
        off = 0
        for sp in specs:
            for blk in (sp.soc_blocks or []):
                all_blocks.append(np.asarray(blk, np.int64) + off)
            off += sp.A.shape[0]
        cones = cones_mod.cone_spec(m, all_blocks)
        cones_mod.validate_against_bounds(cones, bl, bu)
    if sparse:
        def t(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)
        qp = boxqp.BoxQP(c=t(c), q=t(q), A=A, bl=t(bl), bu=t(bu), l=t(l),
                         u=t(u), cones=None if cones is None
                         else cones.to(dev))
    else:
        qp = boxqp.make_boxqp(c, A, bl, bu, l, u, q=q, device=dev,
                              cones=cones)
    if scale:
        qp, scaling = boxqp.ruiz_scale(qp)
    else:
        scaling = boxqp.Scaling(d_row=np.ones(m), d_col=np.ones(S * n))
    return EFProblem(qp=qp, scaling=scaling, n_per_scen=n, probs=probs,
                     nonant_idx=nonant_idx, tree=tree)


def root_fix_columns(efp: EFProblem):
    """(root_slots, flat_cols, d_flat): the ROOT-stage nonant slots, the
    EF-wide flat column indices of every scenario block's root slots,
    and their column scaling — the one convention for 'fix the root
    nonants at x̂'."""
    root_slots = np.nonzero(efp.tree.slot_stage == 1)[0]
    cols_one = np.asarray(efp.nonant_idx)[root_slots]
    S = len(efp.probs)
    n = efp.n_per_scen
    flat = (np.arange(S)[:, None] * n + cols_one[None, :]).ravel()
    d_flat = np.asarray(efp.scaling.d_col)[flat]
    return root_slots, flat, d_flat


class ExtensiveForm:
    """Direct EF solve — API parity with ref:mpisppy/opt/ef.py:16-155.

    options: dict with optional 'tol', 'max_iters'."""

    def __init__(self, options, all_scenario_names, scenario_creator,
                 scenario_creator_kwargs=None, tree=None, device=None):
        kwargs = scenario_creator_kwargs or {}
        self.all_scenario_names = list(all_scenario_names)
        self.specs = [scenario_creator(name, **kwargs)
                      for name in self.all_scenario_names]
        self.options = dict(options or {})
        self.ef = build_ef(self.specs, tree=tree, device=device)
        self._state = None

    def solve_extensive_form(self) -> pdhg.PDHGState:
        opts = pdhg.PDHGOptions(
            tol=self.options.get("tol", 1e-6),
            max_iters=self.options.get("max_iters", 100_000),
        )
        self._state = pdhg.solve(self.ef.qp, opts)
        return self._state

    @property
    def x(self) -> np.ndarray:
        """(S, n) per-scenario solution in original space."""
        xs = self._state.x.detach().cpu().numpy() * self.ef.scaling.d_col
        return xs.reshape(len(self.specs), self.ef.n_per_scen)

    def fix_root_nonants(self, xhat_root: np.ndarray):
        """Collapse the ROOT-stage nonant boxes at xhat in every scenario
        block (ref:mpisppy/spopt.py:686-725).  Call before
        solve_extensive_form."""
        root_slots, flat, d_flat = root_fix_columns(self.ef)
        xhat_root = np.asarray(xhat_root, np.float64)
        if xhat_root.shape[-1] != len(root_slots):
            raise ValueError(
                f"xhat has {xhat_root.shape[-1]} values; the root "
                f"stage has {len(root_slots)} nonant slots")
        qp = self.ef.qp
        l = qp.l.detach().cpu().numpy().astype(np.float64)  # noqa: E741
        u = qp.u.detach().cpu().numpy().astype(np.float64)
        xs = np.tile(xhat_root, len(self.specs)) / d_flat
        l[flat] = xs
        u[flat] = xs

        def t(v):
            return torch.as_tensor(v, dtype=qp.l.dtype, device=qp.device)

        self.ef = dataclasses.replace(
            self.ef, qp=dataclasses.replace(qp, l=t(l), u=t(u)))

    def get_objective_value(self) -> float:
        """EF objective in original space (ref:opt/ef.py:106)."""
        x = self.x
        val = 0.0
        for s, sp in enumerate(self.specs):
            qs = np.zeros_like(sp.c) if sp.q is None else sp.q
            val += self.ef.probs[s] * float(
                sp.c @ x[s] + 0.5 * x[s] @ (qs * x[s]))
        return val

    def get_root_solution(self) -> dict[str, float]:
        """First-stage (ROOT) variable values (ref:opt/ef.py:121-135)."""
        x = self.x
        root_slots = np.nonzero(self.ef.tree.slot_stage == 1)[0]
        return {f"x{self.ef.nonant_idx[i]}":
                float(x[0, self.ef.nonant_idx[i]]) for i in root_slots}

    def nonants(self):
        """Iterate (scenario_name, slot, value) (ref:opt/ef.py:138-147)."""
        x = self.x
        for s, name in enumerate(self.all_scenario_names):
            for i, col in enumerate(self.ef.nonant_idx):
                yield name, i, float(x[s, col])
