###############################################################################
# Seeded scenario synthesis: the ScenarioProgram (port of
# mpisppy_tpu/scengen/program.py, dense constraint matrices).
#
# A ScenarioProgram maps a counter-based key to one scenario's data, so
# scenario data can be drawn where it is used instead of being stored:
#
#     key_s = fold_in(base_key, start + s),  base_key = PRNGKey(base_seed)
#                                            [then fold_in(., step)]
#
# threefry is counter-based and stateless, so draw s depends only on
# (base_seed, step, start + s): never on which batch, block or device
# draws it.  The same program gives bit-identical data through
#
#   * to_specs()              host ScenarioSpecs for core.batch.from_specs
#                             (with scaling=program.scaling);
#   * scengen.virtual_batch   a VirtualBatch whose realize() draws the
#                             whole batch on the device;
#   * scengen.window_inputs   the CUDA window kernel's in-kernel draws
#                             (programs that declare `row_draws`).
#
# The sampler is written batched over an index vector:
# (base_key, idx (k,)) -> {field: (k, width) f32}, the batch dimension
# standing in for the JAX package's vmap.  Draws come from
# scengen/random.py, the port's bit-exact copy of jax.random, so the
# port's programs draw exactly the JAX package's scenarios.
###############################################################################
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mpisppy_tpu_torch.core.tree import ScenarioTree, two_stage_tree
from mpisppy_tpu_torch.scengen import random as rnd

Tensor = torch.Tensor

#: qp fields a sampler may produce (ScenarioSpec field names).
FIELDS = ("c", "q", "A", "bl", "bu", "l", "u")


def scen_key(base_key: Tensor, idx) -> Tensor:
    """The one key derivation of the subsystem: scenario `idx`'s
    counter-based key (idx an int or an index tensor)."""
    return rnd.fold_in(base_key, idx)


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """A declarative description of a sampler whose randomness is a block
    of Bernoulli rows — what a CUDA kernel can evaluate, where it cannot
    run a Python sampler.  For scenario index i, with
    u = uniform(scen_key(base_key, i), (count,)):

        field[row0 + j] = below if u[j] < threshold else above

    for every field in `fields`; every other entry of those fields is
    the template's.  A program built on one takes its sampler from
    as_sampler, so the kernel and both plain paths evaluate one
    definition of the rule."""

    fields: tuple
    row0: int
    count: int
    threshold: float
    below: float
    above: float

    def draw(self, base_key: Tensor, idx: Tensor) -> Tensor:
        """(k, count) f32 drawn values for the index vector idx (k,)."""
        u = rnd.uniform(scen_key(base_key, idx), (self.count,))
        return torch.where(u < self.threshold,
                           torch.tensor(self.below, dtype=torch.float32,
                                        device=u.device),
                           torch.tensor(self.above, dtype=torch.float32,
                                        device=u.device))

    def as_sampler(self, template: dict) -> Callable:
        """The program sampler this rule defines: each field of `fields`
        is its f32 template row with the drawn block written over it."""
        rows = {f: torch.as_tensor(np.asarray(template[f], np.float32))
                for f in self.fields}
        cols = slice(self.row0, self.row0 + self.count)

        def sampler(base_key: Tensor, idx: Tensor) -> dict:
            vals = self.draw(base_key, idx)
            out = {}
            for f, row in rows.items():
                full = row.to(vals.device).expand(idx.shape[0], -1).clone()
                full[:, cols] = vals
                out[f] = full
            return out
        return sampler


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioProgram:
    """A declarative recipe: scenario index -> one scenario's data.

    template: f64 numpy DETERMINISTIC skeleton of every qp field (a dense
        A); varying fields hold the values the sampler overwrites.
    varying: which fields the sampler produces.
    sampler: (base_key, idx (k,) int64) -> {field: (k, ...) f32}, built
        from scengen.random only, on the device of its arguments.  It
        gets the BASE key, so a model may fold per scenario
        (scen_key(base_key, idx)) or otherwise.
    start: index offset — replication r of a confidence-interval run
        draws scenarios [start, start + num_scenarios) of one base key.
    step: rolling-horizon step: step k re-keys every draw through
        fold_in(PRNGKey(base_seed), k) before the per-scenario fold.
    row_draws: the RowDraws the sampler was built from, where it is one
        (sslp): what the window kernel's in-kernel synthesis evaluates.
    """

    name: str
    num_scenarios: int
    base_seed: int
    template: dict
    varying: tuple
    sampler: Callable
    nonant_idx: np.ndarray
    tree: ScenarioTree | None = None
    integer: np.ndarray | None = None
    start: int = 0
    step: int = 0
    row_draws: RowDraws | None = None

    def __post_init__(self):
        unknown = set(self.varying) - set(FIELDS)
        if unknown:
            raise ValueError(f"unknown varying fields: {sorted(unknown)}")
        if self.tree is None:
            object.__setattr__(self, "tree", two_stage_tree(
                self.num_scenarios, len(self.nonant_idx)))
        if self.tree.num_scenarios != self.num_scenarios:
            raise ValueError(
                f"tree has {self.tree.num_scenarios} scenarios, program "
                f"declares {self.num_scenarios}")

    # -- keys -------------------------------------------------------------
    def base_key(self, device=None) -> Tensor:
        key = rnd.prng_key(self.base_seed, device)
        if self.step:
            key = rnd.fold_in(key, self.step)
        return key

    def advance(self, step: int) -> "ScenarioProgram":
        """The same program with its base key folded to step `step`
        (absolute: advance(k).advance(j) samples step j)."""
        if step == self.step:
            return self
        return dataclasses.replace(self, step=int(step))

    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.start + self.num_scenarios)

    def provenance(self) -> dict:
        """Everything needed to regenerate the exact draws."""
        prov = {"scheme": "threefry2x32/fold_in",
                "program": self.name,
                "base_seed": int(self.base_seed),
                "start": int(self.start),
                "num_scenarios": int(self.num_scenarios)}
        if self.step:
            prov["step"] = int(self.step)
        return prov

    # -- scaling ----------------------------------------------------------
    @property
    def scaling(self):
        """Template Ruiz Scaling, computed once from scenario `start`'s
        f64 spec and shared by every scenario (a shared scaling is what
        keeps d_col/d_row (n,)/(m,) for any scenario count).  Cached on
        the instance."""
        sc = self.__dict__.get("_scaling")
        if sc is None:
            from mpisppy_tpu_torch.ops.boxqp import BoxQP, ruiz_scale
            sp = self.spec_at(self.start)

            def f64(v):
                return torch.as_tensor(np.asarray(v, np.float64))
            qp = BoxQP(c=f64(sp.c), q=f64(np.zeros_like(sp.c)),
                       A=as_ell_or_dense(sp.A, torch.float64),
                       bl=f64(sp.bl), bu=f64(sp.bu), l=f64(sp.l),
                       u=f64(sp.u))
            _, sc = ruiz_scale(qp)
            object.__setattr__(self, "_scaling", sc)
        return sc

    # -- host materialization ---------------------------------------------
    def _spec_from_fields(self, idx: int, fields: dict):
        """ScenarioSpec from one scenario's drawn fields: f32 values
        upcast to f64 (exact), deterministic fields the SHARED template
        objects, so from_specs' identity fast path fires."""
        from mpisppy_tpu_torch.core.batch import ScenarioSpec
        vals = dict(self.template)
        for k in self.varying:
            vals[k] = np.asarray(fields[k], np.float64)
        return ScenarioSpec(
            name=f"{self.name}_scengen{idx}",
            c=vals["c"], A=vals["A"], bl=vals["bl"], bu=vals["bu"],
            l=vals["l"], u=vals["u"], q=vals.get("q"),
            nonant_idx=np.asarray(self.nonant_idx, np.int32),
            probability=1.0 / self.num_scenarios,
            integer=self.integer)

    def _host_fields(self, idx) -> dict:
        fields = sample_fields(self, torch.as_tensor(
            np.asarray(idx, np.int64).reshape(-1)))
        return {k: fields[k].numpy() for k in self.varying}

    def spec_at(self, idx: int):
        """One scenario's ScenarioSpec, drawn on the CPU."""
        fields = self._host_fields([idx])
        return self._spec_from_fields(idx, {k: v[0]
                                            for k, v in fields.items()})

    def to_specs(self) -> list:
        """The whole sampled set as host ScenarioSpecs, drawn on the CPU
        in one batched call (O(S) host memory: the path synthesis exists
        to avoid, kept for EF builds and the bit-identity tests)."""
        idx = self.indices()
        fields = self._host_fields(idx)
        return [self._spec_from_fields(
            i, {k: fields[k][row] for k in self.varying})
            for row, i in enumerate(idx)]


def as_ell_or_dense(A, dense_dtype=torch.float32):
    """A template A as the batch holds it: a scipy-sparse matrix becomes
    an f32 EllMatrix (the JAX package's cast), a dense one a tensor of
    `dense_dtype`."""
    import scipy.sparse as sps
    if sps.issparse(A):
        from mpisppy_tpu_torch.ops import sparse as sparse_mod
        return sparse_mod.ell_from_scipy(A)
    return torch.as_tensor(np.asarray(A, np.float64)).to(dense_dtype)


def sample_fields(program: ScenarioProgram, idx: Tensor,
                  base_key: Tensor | None = None) -> dict:
    """The varying fields for an index vector (k,) — the synthesis
    primitive of every path.  `base_key` lets a caller pass a key that
    already lies on the device; by default it is built on idx's."""
    base = program.base_key(idx.device) if base_key is None else base_key
    return program.sampler(base, idx)


def program_for(module, num_scens: int, seed: int = 0, start: int = 0,
                **kw) -> ScenarioProgram | None:
    """The model-module bridge: modules with a scenario-synthesis branch
    expose `scenario_program(num_scens, seed=, start=, ...)`.  Returns
    None for a module without one."""
    factory = getattr(module, "scenario_program", None)
    if factory is None:
        return None
    return factory(num_scens, seed=seed, start=start, **kw)


def has_program(module) -> bool:
    return getattr(module, "scenario_program", None) is not None


def program_from_cfg(module, cfg, num: int, start: int = 0,
                     seed: int | None = None, drop: tuple = (),
                     **overrides) -> ScenarioProgram | None:
    """The cfg-gated resolver the confidence-interval layer shares
    (ciutils, sample_tree): honor the `use_scengen` opt-in, forward the
    cfg's model kwargs (kw_creator) so the program samples the instance
    the host path would build, and return None (with a console line,
    never silently) when the program cannot cover this sample.

    drop: kw_creator keys the caller supplies itself or that must not
    reach the factory; overrides: explicit factory kwargs."""
    if not bool(cfg.get("use_scengen", False)):
        return None
    if not has_program(module):
        return None
    kw = {}
    if hasattr(module, "kw_creator"):
        try:
            kw = dict(module.kw_creator(cfg))
        except Exception:
            kw = {}
    kw.pop("num_scens", None)
    for k in drop:
        kw.pop(k, None)
    kw.update(overrides)
    if seed is None:
        seed = int(cfg.get("scengen_seed", 0))
    try:
        return program_for(module, num, seed=int(seed), start=int(start),
                           **kw)
    except (TypeError, ValueError) as e:
        # an explicit opt-in that cannot be honored must be audible: the
        # caller draws from the host stream and its output carries no
        # seed_provenance
        from mpisppy_tpu_torch.telemetry import console
        console.log(
            f"scengen: use_scengen requested but "
            f"{getattr(module, '__name__', module)!s} has no program "
            f"covering this sample ({e}); drawing from the legacy "
            f"host stream instead", level=console.INFO)
        return None


def estimate_materialized_bytes(program: ScenarioProgram,
                                itemsize: int = 4) -> int:
    """What a host-materialized batch would keep resident for the qp
    DATA alone (c/q stacked per scenario; varying fields per scenario;
    shared fields once).  Analytic, never allocates."""
    S = program.num_scenarios
    n = int(np.asarray(program.template["c"]).shape[-1])
    A = program.template["A"]
    m = int(A.shape[0])
    total = 2 * S * n * itemsize                      # c, q per scenario
    for f, width in (("l", n), ("u", n), ("bl", m), ("bu", m)):
        total += (S if f in program.varying else 1) * width * itemsize
    if hasattr(A, "tocsr"):
        k = max(int(np.diff(A.tocsr().indptr).max()), 1)
        a_elems = m * k * 2                           # vals + cols
    else:
        a_elems = m * n
    total += (S if "A" in program.varying else 1) * a_elems * itemsize
    return total
