###############################################################################
# VirtualBatch: a ScenarioBatch whose scenario data does not exist (port
# of mpisppy_tpu/scengen/virtual.py).
#
# The batch holds only O(n + m + S) state — the base key, the
# probabilities, the shared (pre-scaled) template fields and the shared
# Ruiz scalings — plus its ScenarioProgram.  realize() draws the full
# ScenarioBatch on the device.  Every step of the solver stack that reads
# scenario data (ph_iter0/ph_iterk, the fused wheel's steps and planes,
# the x̂ evaluations) calls core.batch.concretize at entry, so the
# (S, ...) data exists only while that step runs: it is drawn again at
# the next entry and never cached, as the JAX package draws it inside
# each jitted step.  The host-side loops (PH, the hub, the spokes) read
# only the surface below, which never draws.
#
# virtual_batch emits the JAX package's `scengen` event and metrics.  A
# VirtualBatch sharded by parallel.mesh.shard_batch keeps its rank's
# rows of the probabilities (and the multistage node map) and draws each
# row from its GLOBAL scenario index (scen_offset onward), so the draws
# do not depend on the layout.
###############################################################################
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpisppy_tpu_torch import resolve_device
from mpisppy_tpu_torch.core.batch import (
    ScenarioBatch, as_scaled_arrays, scale_field,
)
from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.ops.sparse import EllMatrix
from mpisppy_tpu_torch.scengen.program import (
    FIELDS, ScenarioProgram, as_ell_or_dense, estimate_materialized_bytes,
    sample_fields,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class _FieldShape:
    shape: tuple
    dtype: torch.dtype


class _VirtualQP:
    """Shape/dtype view of the qp a VirtualBatch would realize: enough
    for host-side code (PH reads batch.qp.c.dtype) without drawing."""

    def __init__(self, vb: "VirtualBatch"):
        prog = vb.program
        S = vb.num_scenarios
        dt = torch.float32
        n = int(np.asarray(prog.template["c"]).shape[-1])
        m = int(prog.template["A"].shape[0])
        self.c = _FieldShape((S, n), dt)
        self.q = _FieldShape((S, n), dt)
        for f, width in (("l", n), ("u", n), ("bl", m), ("bu", m)):
            shape = (S, width) if f in prog.varying else (width,)
            setattr(self, f, _FieldShape(shape, dt))
        self.A = vb.shared["A"] if "A" in vb.shared \
            else _FieldShape((S, m, n), dt)
        self.cones = None
        self.n = n
        self.m = m


@dataclasses.dataclass(frozen=True)
class VirtualBatch:
    """The ScenarioBatch interface over synthesized scenarios.

    shared: pre-scaled f32 template fields for every NON-varying qp field.
    node_of_slot is None for two-stage programs (zeros in realize()) and
    a stored (S, N) map for multistage trees."""

    base_key: Tensor
    p: Tensor
    d_col: Tensor
    d_row: Tensor
    d_non: Tensor
    nonant_idx: Tensor
    node_of_slot: Tensor | None
    integer_slot: Tensor
    integer_full: Tensor
    shared: dict
    program: ScenarioProgram
    num_real: int
    mesh: object | None = None
    scen_offset: int = 0

    is_virtual = True

    # -- ScenarioBatch surface (never draws) ------------------------------
    @property
    def num_scenarios(self) -> int:
        return int(self.p.shape[0])

    @property
    def num_nonants(self) -> int:
        return int(self.nonant_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.p.device

    @property
    def tree(self):
        return self.program.tree

    @property
    def qp(self) -> _VirtualQP:
        return _VirtualQP(self)

    @property
    def var_prob(self):
        return None

    expectation = ScenarioBatch.expectation
    all_real = ScenarioBatch.all_real
    any_real = ScenarioBatch.any_real
    scen_sum = ScenarioBatch.scen_sum
    scen_extreme = ScenarioBatch.scen_extreme
    scen_row = ScenarioBatch.scen_row
    scen_gather = ScenarioBatch.scen_gather
    scen_host = ScenarioBatch.scen_host
    scen_total = ScenarioBatch.scen_total
    scen_start = ScenarioBatch.scen_start
    scen_argmax = ScenarioBatch.scen_argmax
    scen_topk_mask = ScenarioBatch.scen_topk_mask

    def nonants(self, x_scaled: Tensor) -> Tensor:
        """Original-space nonants: d_non is SHARED by the template-
        scaling contract, so this never draws (the hub calls it)."""
        return self.d_non * x_scaled[..., self.nonant_idx]

    def nonant_box(self):
        """(lb, ub) of the nonants in original space, exact when the box
        is deterministic (every shipped program)."""
        prog = self.program
        if "l" in prog.varying or "u" in prog.varying:
            raise NotImplementedError(
                "nonant_box over a program with a varying box; no "
                "shipped program varies l/u")
        nonant = self.nonant_idx.cpu().numpy()
        d = self.d_non.cpu().numpy()
        lb = self.shared["l"].cpu().numpy()[nonant] * d
        ub = self.shared["u"].cpu().numpy()[nonant] * d
        return lb, ub

    # -- synthesis --------------------------------------------------------
    def scenario_indices(self) -> Tensor:
        """(S,) program index of each row: pad rows (p == 0) clone the
        last real scenario's index, mirroring pad_to_multiple.  A shard's
        rows start at its global offset."""
        i = torch.arange(self.num_scenarios, device=self.device) \
            + self.scen_offset
        return torch.clamp(i, max=self.num_real - 1) + self.program.start

    def realize(self) -> ScenarioBatch:
        """Draw the full ScenarioBatch on the batch's device.  c and q
        come out as stride-0 (S, n) views of the shared rows."""
        prog = self.program
        S = self.num_scenarios
        fields = sample_fields(prog, self.scenario_indices(),
                               base_key=self.base_key)
        vals = {}
        for name in FIELDS:
            if name in prog.varying:
                vals[name] = scale_field(name, fields[name],
                                         self.d_row, self.d_col)
            elif name in self.shared:
                vals[name] = self.shared[name]
        n = vals["c"].shape[-1]
        qp = BoxQP(c=vals["c"].expand(S, n), q=vals["q"].expand(S, n),
                   A=vals["A"], bl=vals["bl"], bu=vals["bu"],
                   l=vals["l"], u=vals["u"])
        if self.mesh is not None and self.mesh.world > 1:
            # a shard's lanes (boxqp.shard_rows)
            qp = dataclasses.replace(qp, rows=(
                self.scen_offset, S, S * self.mesh.world))
        nos = self.node_of_slot
        if nos is None:
            nos = torch.zeros((S, self.num_nonants), dtype=torch.int64,
                              device=self.device)
        return ScenarioBatch(
            qp=qp, d_col=self.d_col, d_row=self.d_row, d_non=self.d_non,
            p=self.p, nonant_idx=self.nonant_idx, node_of_slot=nos,
            integer_slot=self.integer_slot,
            integer_full=self.integer_full,
            tree=prog.tree, num_real=self.num_real, mesh=self.mesh,
            scen_offset=self.scen_offset)

    def persistent_bytes(self) -> int:
        """Resident bytes of this batch's tensors — what synthesis keeps
        on the device between steps."""
        leaves = [self.base_key, self.p, self.d_col, self.d_row,
                  self.d_non, self.nonant_idx, self.node_of_slot,
                  self.integer_slot, self.integer_full,
                  *self.shared.values()]
        tensors = []
        for t in leaves:
            if isinstance(t, EllMatrix):
                tensors += [t.vals, t.cols, t.t_slots, t.t_rows]
            elif t is not None:
                tensors.append(t)
        return sum(t.numel() * t.element_size() for t in tensors)

    def materialized_bytes(self) -> int:
        """What the host-materialized equivalent would keep resident."""
        return estimate_materialized_bytes(self.program)


def _pad_rows(S: int, pad_to: int | None) -> int:
    return S if pad_to is None else S + ((-S) % int(pad_to))


def virtual_batch(program: ScenarioProgram, pad_to: int | None = None,
                  device=None, bus=None) -> VirtualBatch:
    """Build the VirtualBatch for a program (O(n + m + S) work).  Runs on
    CUDA unless device="cpu" is given.

    pad_to: pad the scenario axis to a multiple — pad rows get
    probability 0 and clone the last real scenario (pad_to_multiple's
    contract).  Emits one `scengen` telemetry event on `bus` (when
    given) and mirrors the build into the metrics registry, as the JAX
    package does."""
    dev = resolve_device(device)
    prog = program
    S = prog.num_scenarios
    S_p = _pad_rows(S, pad_to)

    d_row, d_col = as_scaled_arrays(prog.scaling, device=dev)
    shared = {}
    for name in FIELDS:
        if name in prog.varying:
            continue
        tpl = prog.template.get(name)
        if name == "q" and tpl is None:
            tpl = np.zeros_like(np.asarray(prog.template["c"]))
        if name == "A":
            tpl = as_ell_or_dense(tpl).to(dev)
        else:
            tpl = torch.as_tensor(np.asarray(tpl, np.float32)).to(dev)
        shared[name] = scale_field(name, tpl, d_row, d_col)

    probs = np.zeros(S_p, np.float64)
    probs[:S] = 1.0 / S
    nonant_idx = torch.as_tensor(np.asarray(prog.nonant_idx, np.int64))
    n = int(np.asarray(prog.template["c"]).shape[-1])
    integer = prog.integer if prog.integer is not None \
        else np.zeros(n, bool)
    integer = np.asarray(integer, bool)

    node_of_slot = None
    if prog.tree.num_nodes > 1:
        nos = prog.tree.node_of_slot()
        if S_p > S:
            nos = np.concatenate(
                [nos, np.repeat(nos[-1:], S_p - S, axis=0)], axis=0)
        node_of_slot = torch.as_tensor(nos.astype(np.int64)).to(dev)

    vb = VirtualBatch(
        base_key=prog.base_key(dev),
        p=torch.as_tensor(probs.astype(np.float32)).to(dev),
        d_col=d_col, d_row=d_row,
        d_non=d_col[nonant_idx.to(dev)],
        nonant_idx=nonant_idx.to(dev),
        node_of_slot=node_of_slot,
        integer_slot=torch.as_tensor(integer[nonant_idx.numpy()]).to(dev),
        integer_full=torch.as_tensor(integer).to(dev),
        shared=shared,
        program=prog,
        num_real=S,
    )

    from mpisppy_tpu_torch.telemetry import metrics as _metrics
    saved = max(vb.materialized_bytes() - vb.persistent_bytes(), 0)
    _metrics.REGISTRY.inc("scengen_virtual_batches_total")
    _metrics.REGISTRY.set_gauge("scengen_scenarios", float(S))
    _metrics.REGISTRY.set_gauge("scengen_data_bytes_saved", float(saved))
    if bus is not None:
        bus.emit("scengen", program=prog.name, num_scenarios=S,
                 padded_to=S_p, base_seed=prog.base_seed,
                 start=prog.start,
                 persistent_bytes=vb.persistent_bytes(),
                 materialized_bytes_est=vb.materialized_bytes())
    return vb


def repartition(vb: VirtualBatch, pad_to: int) -> VirtualBatch:
    """Re-derive the scenario-axis layout for another multiple.  Scenario
    data never moves (it is drawn from the scenario index); only the
    probabilities and the multistage node map carry the padded axis.
    Real probabilities keep their values, pad rows get ZERO."""
    S = vb.num_real
    S_p = _pad_rows(S, pad_to)
    probs = torch.zeros(S_p, dtype=vb.p.dtype, device=vb.device)
    probs[:S] = vb.p[:S]
    nos = vb.node_of_slot
    if nos is not None:
        nos = nos[:S]
        if S_p > S:
            nos = torch.cat([nos, nos[-1:].expand(S_p - S, -1)], dim=0)
    return dataclasses.replace(vb, p=probs, node_of_slot=nos)


def materialize(program: ScenarioProgram, device=None) -> ScenarioBatch:
    """Draw the WHOLE batch at once — the bit-identity counterpart of
    from_specs(program.to_specs(), scaling=program.scaling)."""
    return virtual_batch(program, device=device).realize()
