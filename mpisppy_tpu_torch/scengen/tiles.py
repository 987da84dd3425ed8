###############################################################################
# In-kernel synthesis inputs: VirtualBatch -> (qp_proxy, TileSynth) for
# ops.pdhg_window.run_window (port of mpisppy_tpu/scengen/tiles.py).
#
# The Pallas engine ran the program's Python sampler inside the kernel,
# one 128-scenario tile at a time.  A CUDA kernel cannot run a Python
# sampler, so the port's programs declare the sampler's rule as data
# (ScenarioProgram.row_draws) and the kernel evaluates that rule: each
# thread block draws its own scenarios' bound rows from their threefry
# keys while it loads them.  There is no tile size: a block owns one or
# four scenarios, and which scenarios is decided by the kernel's launch,
# not by the caller.
#
# qp_proxy carries the shared dense A and every data field as a SHARED
# row (stride 0 in the kernel): the scaled template where a field is
# deterministic, and, for the drawn fields, the scaled template whose
# drawn rows the kernel overwrites.  Nothing (S, ·)-shaped exists for
# the data plane.
###############################################################################
from __future__ import annotations

import numpy as np
import torch

from mpisppy_tpu_torch.core.batch import scale_field
from mpisppy_tpu_torch.ops.boxqp import BoxQP
from mpisppy_tpu_torch.ops.pdhg_window import TileSynth
from mpisppy_tpu_torch.scengen.virtual import VirtualBatch

#: the fields the kernel can draw in-kernel (its load phase's bound rows)
DRAWABLE = ("bl", "bu")


def window_inputs(vb: VirtualBatch):
    """(qp_proxy, TileSynth) for ops.pdhg_window.run_window(synth=).

    Raises ValueError where the kernel cannot draw the program: a
    per-scenario A (the kernel takes one shared dense A), or a program
    without `row_draws`, or one whose varying fields are not all drawn
    bound rows."""
    prog = vb.program
    A = vb.shared.get("A")
    if A is None or A.ndim != 2:
        raise ValueError(
            "window_inputs needs a shared dense constraint matrix (the "
            "window kernel's scope); programs varying A keep the "
            "realize() path")
    rd = prog.row_draws
    if rd is None:
        raise ValueError(
            f"program {prog.name!r} declares no row_draws: the window "
            "kernel can only draw a declared Bernoulli-row rule")
    if set(prog.varying) != set(rd.fields) or not set(rd.fields) <= set(
            DRAWABLE):
        raise ValueError(
            f"program {prog.name!r}: row_draws must describe every varying "
            f"field, and the kernel draws only {DRAWABLE}")
    S, n = vb.num_scenarios, A.shape[1]
    vals = dict(vb.shared)
    for name in rd.fields:
        tpl = torch.as_tensor(np.asarray(prog.template[name], np.float32))
        tpl = tpl.to(vb.device)
        vals[name] = scale_field(name, tpl, vb.d_row, vb.d_col)
    qp_proxy = BoxQP(c=vals["c"].expand(S, n), q=vals["q"].expand(S, n),
                     A=A, bl=vals["bl"], bu=vals["bu"], l=vals["l"],
                     u=vals["u"])
    key = tuple(int(v) for v in vb.base_key.tolist())
    synth = TileSynth(key=key, d_row=vb.d_row,
                      start=prog.start, num_real=vb.num_real, draws=rd)
    return qp_proxy, synth

