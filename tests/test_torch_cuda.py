# Tests of the port that need an NVIDIA GPU (marker `cuda`; each skips
# without one).  This file imports neither JAX nor the JAX package, so
# it also runs on a machine with only PyTorch for CUDA:
#
#     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
#
# (--noconftest: tests/conftest.py configures JAX, which such a machine
# does not have.)  The kernel is held to its plain version at a small
# sslp shape and, for its SOC instantiation, on the ccopf --soc batch
# and on ragged blocks in any row order; its SYNTH instantiation must
# equal the box instantiation on the realized batch bit for bit (the
# device threefry is jax.random's).  The resident design (A in shared
# memory, bf16 products on tensor cores) is held to the plain version in
# f32, bf16 and bf16x3 on an odd shape with per-scenario l/u, shared c/q,
# +-inf rows and done lanes, must repeat itself bit for bit, and must
# report the shared-memory layout the shape rule assumes.  So is its
# design for SOC batches (A in shared memory, tiles of 8-24 scenarios),
# on the ccopf --soc batch and on ragged blocks out of row order.
# A per-scenario A (farmer) runs the plain batched iteration on the card
# and must equal its CPU run to f32 noise without a kernel launch; the
# k shuffle candidates, one (k·S)-scenario batch over the shared sslp A,
# take one box-kernel launch per window.  uc's ELL A runs the plain
# iteration too (no launch, CPU-equal to f32 noise); the XLA-exact normal
# draws the same numbers on the card; the box kernel takes FBBT's
# per-scenario l/u.
# chip_smoke.py does the same at the main path's shapes.
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu_torch import scengen
from mpisppy_tpu_torch.algos import xhat
from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.models import ccopf, farmer, sslp
from mpisppy_tpu_torch.ops import boxqp, cones, pdhg, pdhg_window

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _window_args(device, S=40):
    inst = sslp.synthetic_instance(5, 15, seed=0)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=S,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(S)]
    return _solver_args(batch_mod.from_specs(specs, device=device).qp)


def _solver_args(qp):
    """Window inputs two cold windows into a solve, every 5th lane done."""
    opts = pdhg.PDHGOptions()
    st = pdhg.solve_fixed(qp, 2, opts, pdhg.init_state(qp, opts))
    tau = opts.step_margin * st.omega / st.Lnorm
    sigma = opts.step_margin / (st.omega * st.Lnorm)
    done = torch.zeros_like(st.done)
    done[::5] = True
    return (qp, st.x, st.y, st.x_sum, st.y_sum, tau, sigma, done, 40)


@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16x3", 1e-3)])
def test_kernel_matches_plain_version(cuda, precision, tol):
    """Same inputs through the kernel and its plain version on the card:
    f32 differs only in summation order; bf16x3 splits values whose last
    bits differ, so its products move by ~2^-16."""
    args = _window_args(cuda)
    before = dict(pdhg_window.run_window.launches)
    k = pdhg_window.run_window(*args, precision=precision)
    r = pdhg_window.run_window_reference(*args, precision=precision)
    assert dict(pdhg_window.run_window.launches) == {
        **before, "pdhg_window": before["pdhg_window"] + 1}
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    done = args[7]
    assert torch.equal(k[0][done], args[1][done])
    assert torch.equal(k[1][done], args[2][done])


def _ccopf_soc_qp(device, bfs=(10, 10)):
    specs = [ccopf.scenario_creator(nm, branching_factors=bfs, soc=True)
             for nm in ccopf.scenario_names_creator(bfs[0] * bfs[1])]
    return batch_mod.from_specs(specs, tree=ccopf.make_tree(bfs),
                                device=device).qp


def _ragged_soc_qp(device, S=300, seed=0):
    """A random conic LP whose SOC blocks are ragged and out of row
    order, with box rows between them."""
    rng = np.random.default_rng(seed)
    m, n = 14, 9
    blocks = [np.array([3, 0, 7]), np.array([5, 1, 2, 9, 13]),
              np.array([12, 4])]
    spec = cones.cone_spec(m, blocks)
    soc = spec.is_soc.numpy()
    b = rng.normal(size=(S, m))
    bl = np.where(soc, b, b - 1.0)
    bu = np.where(soc, b, b + 1.0)
    return boxqp.make_boxqp(rng.normal(size=(S, n)),
                            rng.normal(size=(m, n)), bl, bu,
                            np.full((S, n), -2.0), np.full((S, n), 2.0),
                            device=device, cones=spec)


@pytest.mark.parametrize("problem", ["ccopf", "ragged"])
@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16x3", 1e-3)])
def test_soc_kernel_matches_plain_version(cuda, problem, precision, tol):
    """The SOC instantiation against the plain version on the card, with
    done lanes bit-unchanged and live duals in the polar cone."""
    qp = _ccopf_soc_qp(cuda) if problem == "ccopf" else _ragged_soc_qp(cuda)
    args = _solver_args(qp)
    before = dict(pdhg_window.run_window.launches)
    k = pdhg_window.run_window(*args, precision=precision)
    r = pdhg_window.run_window_reference(*args, precision=precision)
    torch.cuda.synchronize()
    assert dict(pdhg_window.run_window.launches) == {
        **before, "pdhg_window_soc": before["pdhg_window_soc"] + 1}
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    done = args[7]
    assert torch.equal(k[0][done], args[1][done])
    assert torch.equal(k[1][done], args[2][done])
    # a reflected block lands on the polar cone's boundary up to f32
    # rounding of its own size
    live = k[1][~done]
    dcr = cones.dual_cone_residual_rows(qp.cones, live)
    assert float(dcr.max()) <= 1e-6 * max(1.0, float(live.abs().max()))


def test_wrapper_refuses_what_the_kernel_does_not_cover(cuda):
    """Per-scenario A and CPU-resident operands never take a plain-
    version detour on a CUDA tensor: the wrapper raises before any
    launch."""
    args = _window_args(cuda, S=4)
    qp = args[0]
    per_scen = dataclasses.replace(
        qp, A=qp.A.expand(4, -1, -1).contiguous())
    before = dict(pdhg_window.run_window.launches)
    with pytest.raises(NotImplementedError):
        pdhg_window.run_window(per_scen, *args[1:])
    with pytest.raises(ValueError):
        pdhg_window.run_window(*args[:7], args[7].cpu(), args[8])
    assert dict(pdhg_window.run_window.launches) == before


def test_entry_points_run_on_cuda_by_default(cuda):
    specs = [sslp.scenario_creator(nm, n_servers=3, n_clients=4,
                                   num_scens=2, lp_relax=True)
             for nm in sslp.scenario_names_creator(2)]
    assert batch_mod.from_specs(specs).device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32


def _synth_args(device, S, pad_to=None):
    """The sslp(5,15) program's VirtualBatch, window inputs on its
    realized batch, and the kernel's synth inputs."""
    prog = sslp.scenario_program(S, seed=3, n_servers=5, n_clients=15,
                                 lp_relax=True)
    vb = scengen.virtual_batch(prog, pad_to=pad_to, device=device)
    args = _solver_args(vb.realize().qp)
    qp_proxy, synth = scengen.window_inputs(vb)
    return args, qp_proxy, synth


# S=40 runs one scenario per block, S >= 8 x 132 SMs four; 1059 leaves a
# ragged last block, and pad_to=6 (1062 rows) adds pad rows that clone
# the last real scenario's draws
@pytest.mark.parametrize("S,pad_to", [(40, None), (2000, None),
                                      (1059, None), (1059, 6)])
@pytest.mark.parametrize("precision", [None, "bf16", "bf16x3"])
def test_synth_kernel_equals_box_kernel(cuda, S, pad_to, precision):
    args, qp_proxy, synth = _synth_args(cuda, S, pad_to)
    before = dict(pdhg_window.run_window.launches)
    by_design = dict(pdhg_window.run_window.launches_by_design)
    box = pdhg_window.run_window(*args, precision=precision)
    syn = pdhg_window.run_window(qp_proxy, *args[1:], precision=precision,
                                 synth=synth)
    torch.cuda.synchronize()
    assert dict(pdhg_window.run_window.launches) == {
        **before, "pdhg_window": before["pdhg_window"] + 1,
        "pdhg_window_synth": before["pdhg_window_synth"] + 1}
    # both on the resident design (sslp 5x15 fits it)
    mode = boxqp.as_precision(precision) or "f32"
    for kernel in ("pdhg_window", "pdhg_window_synth"):
        key = f"{kernel}/{mode}/resident"
        assert pdhg_window.run_window.launches_by_design[key] == \
            by_design.get(key, 0) + 1
    for a, b in zip(box, syn):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16x3", 1e-3)])
def test_synth_kernel_matches_plain_version(cuda, precision, tol):
    args, qp_proxy, synth = _synth_args(cuda, 40)
    k = pdhg_window.run_window(qp_proxy, *args[1:], precision=precision,
                               synth=synth)
    r = pdhg_window.run_window_reference(qp_proxy, *args[1:],
                                         precision=precision, synth=synth)
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    done = args[7]
    assert torch.equal(k[0][done], args[1][done])
    assert torch.equal(k[1][done], args[2][done])


def test_device_threefry_draws_match_the_cpu(cuda):
    prog = sslp.scenario_program(300, seed=9, lp_relax=True)
    idx = torch.as_tensor(prog.indices())
    cpu = scengen.sample_fields(prog, idx)
    gpu = scengen.sample_fields(prog, idx.to(cuda))
    for name in prog.varying:
        assert torch.equal(cpu[name], gpu[name].cpu())


def _random_window(device, S, n_iters, m=13, n=77, seed=0):
    """Window inputs of a random box LP of an odd shape: per-scenario l
    and u, shared (stride-0) c and q, one row with bl = -inf and one with
    bu = +inf, every third lane done."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = rng.uniform(0.2, 0.8, size=(S, n)) @ A.T
    bl = b - rng.uniform(0.5, 1.5, size=(S, m))
    bu = b + rng.uniform(0.5, 1.5, size=(S, m))
    bl[:, 0] = -np.inf
    bu[:, 1] = np.inf
    lo = rng.uniform(-1.0, 0.0, size=(S, n))
    hi = lo + rng.uniform(0.5, 2.0, size=(S, n))
    c = np.repeat(rng.normal(size=(1, n)), S, axis=0)
    q = np.repeat(rng.uniform(0.0, 1.0, size=(1, n)), S, axis=0)
    qp = boxqp.make_boxqp(c, A, bl, bu, lo, hi, q=q, device=device)
    qp = dataclasses.replace(qp, c=qp.c[0].expand(S, n),
                             q=qp.q[0].expand(S, n))

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    L = np.linalg.norm(A, 2)
    omega = rng.uniform(0.5, 2.0, S)
    done = torch.as_tensor(np.arange(S) % 3 == 1, device=device)
    return (qp, t(np.clip(rng.uniform(-1, 1, (S, n)), lo, hi)),
            t(rng.normal(scale=0.1, size=(S, m))),
            t(rng.normal(size=(S, n))), t(rng.normal(size=(S, m))),
            t(0.9 * omega / L), t(0.9 / (omega * L)), done, n_iters)


# kernel vs plain after one window: f32 differs in summation order,
# bf16x3 in splits of values whose last bits differ and in the tensor
# cores' accumulation, bf16 keeps 8 bits per operand; the window sums of
# k > 40 iterations carry up to k/40 times that
RESIDENT_TOLS = {"f32": 1e-4, "bf16": 2e-2, "bf16x3": 1e-3}


@pytest.mark.parametrize("S", [1, 7, 64, 1059])
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
def test_resident_kernel_matches_plain_version(cuda, S, mode):
    run = pdhg_window.run_window
    key = f"pdhg_window/{mode}/resident"
    for n_iters in (0, 1, 40, 160):
        args = _random_window(cuda, S, n_iters)
        before = run.launches_by_design.get(key, 0)
        k = run(*args, precision=mode)
        r = pdhg_window.run_window_reference(*args, precision=mode)
        torch.cuda.synchronize()
        assert run.launches_by_design[key] == before + 1
        done = args[7]
        assert torch.equal(k[0][done], args[1][done])
        assert torch.equal(k[1][done], args[2][done])
        if n_iters == 0:
            for a, b in zip(k, args[1:5]):
                assert torch.equal(a, b)
            continue
        tol = RESIDENT_TOLS[mode]
        for name, a, b in zip(("x", "y", "x_sum", "y_sum"), k, r):
            assert torch.isfinite(a).all(), name
            t = tol * max(1.0, n_iters / 40) if name.endswith("sum") else tol
            torch.testing.assert_close(a, b, atol=t, rtol=t, msg=name)


@pytest.mark.parametrize("mode", ["f32", "bf16x3"])
@pytest.mark.parametrize("m,n", [(60, 705), (64, 768)])
def test_resident_kernel_at_the_layout_edges(cuda, mode, m, n):
    """The sslp 15x45 shape and the largest the layout takes (every
    column tile and row pair in use)."""
    args = _random_window(cuda, 100, 40, m=m, n=n, seed=1)
    k = pdhg_window.run_window(*args, precision=mode)
    r = pdhg_window.run_window_reference(*args, precision=mode)
    tol = RESIDENT_TOLS[mode]
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
def test_resident_kernel_is_deterministic(cuda, mode):
    args = _random_window(cuda, 1059, 40)
    a = pdhg_window.run_window(*args, precision=mode)
    b = pdhg_window.run_window(*args, precision=mode)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("mode", ["f32", "bf16x3"])
def test_streamed_and_resident_designs_agree(cuda, mode):
    """The same window through both designs, named explicitly."""
    args = _window_args(cuda, S=200)
    r = pdhg_window.run_window(*args, precision=mode, design="resident")
    s = pdhg_window.run_window(*args, precision=mode, design="streamed")
    tol = RESIDENT_TOLS[mode]
    for a, b in zip(r, s):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)


def test_resident_layout_matches_the_kernel(cuda):
    """The shape rule's layout (ops/pdhg_window.py) and the kernel's own
    (csrc/pdhg_window_resident.cu) agree byte for byte."""
    lib = pdhg_window._library()
    codes = {"f32": 0, "bf16": 1, "bf16x3": 3}
    for mode, code in codes.items():
        for m, n in ((60, 705), (13, 77), (20, 85), (64, 768), (65, 10)):
            L = pdhg_window.resident_layout(mode, m, n)
            want = (0, 0) if L is None else (L.smem_bytes, L.image_bytes)
            got = (lib.pdhg_window_resident_bytes(code, m, n, 0),
                   lib.pdhg_window_resident_bytes(code, m, n, 1))
            assert got == want, (mode, m, n)
    smem, sms = pdhg_window.card_limits(torch.cuda.current_device())
    assert smem > 0 and sms > 0


def test_resident_refuses_what_it_cannot_take(cuda):
    """Naming the resident design for a SOC batch beyond its layout (the
    33-bus feeder's 2.1 MB A) raises before any launch; it never falls
    back to the streamed body."""
    inst = ccopf.feeder_instance(n_buses=33)
    specs = [ccopf.scenario_creator(nm, instance=inst,
                                    branching_factors=(2, 1), soc=True)
             for nm in ccopf.scenario_names_creator(2)]
    qp = batch_mod.from_specs(specs, tree=ccopf.make_tree((2, 1), inst),
                              device=cuda).qp
    args = _solver_args(qp)
    before = dict(pdhg_window.run_window.launches_by_design)
    with pytest.raises(ValueError):
        pdhg_window.run_window(*args, design="resident")
    assert dict(pdhg_window.run_window.launches_by_design) == before


def _soc_batch(problem, device, S):
    """The ccopf (10,10) or ragged SOC batch with its per-scenario rows
    cycled to S scenarios."""
    qp = _ccopf_soc_qp(device) if problem == "ccopf" else \
        _ragged_soc_qp(device)
    S0 = qp.c.shape[0]
    idx = torch.arange(S, device=device) % S0
    return dataclasses.replace(qp, **{
        f: getattr(qp, f)[idx].contiguous()
        for f in ("c", "q", "l", "u", "bl", "bu")
        if getattr(qp, f).ndim == 2 and getattr(qp, f).shape[0] == S0})


def _assert_soc_close(got, want, args, mode, n_iters):
    """got against the plain version's window `want` in `mode`.  f32 and
    bf16x3 at RESIDENT_TOLS (the window sums of k > 40 iterations at
    k/40 times that).  bf16 keeps 8 bits per operand: on the conic
    problems an operand on a bf16 rounding boundary rounds one way in
    one summation order and the other way in another, and the iteration
    carries that step on (the streamed design shows the same), so bf16
    is held to twice the mode's own error: the plain bf16 window against
    the plain f32 one, per output."""
    tol = RESIDENT_TOLS[mode]
    exact = pdhg_window.run_window_reference(*args, precision="f32") \
        if mode == "bf16" else want
    for name, a, b, e in zip(("x", "y", "x_sum", "y_sum"), got, want, exact):
        assert torch.isfinite(a).all(), name
        t = tol * max(1.0, n_iters / 40) if name.endswith("sum") else tol
        if mode == "bf16":
            budget = max(t, 2.0 * float((b - e).abs().max()))
            assert float((a - b).abs().max()) <= budget, name
        else:
            torch.testing.assert_close(a, b, atol=t, rtol=t, msg=name)


@pytest.mark.parametrize("S", [1, 7, 64, 1059])
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
@pytest.mark.parametrize("problem", ["ccopf", "ragged"])
def test_resident_soc_kernel_matches_plain_version(cuda, problem, mode, S):
    """The resident SOC design (the shape rule's at these shapes) against
    the plain version at n_iters 0, 1, 40 and 160: done lanes
    bit-unchanged, live duals in the polar cone up to f32 rounding of
    their size."""
    run = pdhg_window.run_window
    key = f"pdhg_window_soc/{mode}/resident"
    qp = _soc_batch(problem, cuda, S)
    base = _solver_args(qp)
    for n_iters in (0, 1, 40, 160):
        args = base[:8] + (n_iters,)
        before = run.launches_by_design.get(key, 0)
        k = run(*args, precision=mode)
        r = pdhg_window.run_window_reference(*args, precision=mode)
        torch.cuda.synchronize()
        assert run.launches_by_design[key] == before + 1
        done = args[7]
        assert torch.equal(k[0][done], args[1][done])
        assert torch.equal(k[1][done], args[2][done])
        if n_iters == 0:
            for a, b in zip(k, args[1:5]):
                assert torch.equal(a, b)
            continue
        _assert_soc_close(k, r, args, mode, n_iters)
        live = k[1][~done]
        if live.numel():
            dcr = cones.dual_cone_residual_rows(qp.cones, live)
            assert float(dcr.max()) <= 1e-6 * max(1.0,
                                                  float(live.abs().max()))


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
@pytest.mark.parametrize("problem", ["ccopf", "ragged"])
def test_resident_soc_kernel_is_deterministic(cuda, problem, mode):
    args = _solver_args(_soc_batch(problem, cuda, 1059))
    a = pdhg_window.run_window(*args, precision=mode)
    b = pdhg_window.run_window(*args, precision=mode)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16x3"])
@pytest.mark.parametrize("problem", ["ccopf", "ragged"])
def test_streamed_and_resident_soc_designs_agree(cuda, problem, mode):
    """The same SOC window through both designs, named explicitly, at
    S=5,000 (24-scenario tiles in f32 and bf16x3, 16 in bf16), held to
    each other as each is held to the plain version."""
    args = _solver_args(_soc_batch(problem, cuda, 5000))
    by_design = dict(pdhg_window.run_window.launches_by_design)
    r = pdhg_window.run_window(*args, precision=mode, design="resident")
    s = pdhg_window.run_window(*args, precision=mode, design="streamed")
    for d in ("resident", "streamed"):
        key = f"pdhg_window_soc/{mode}/{d}"
        assert pdhg_window.run_window.launches_by_design[key] == \
            by_design.get(key, 0) + 1
    _assert_soc_close(r, s, args, mode, args[8])


def test_cone_layout_matches_the_kernel(cuda):
    """The shape rule's cone layout (ops/pdhg_window.py) and the kernel's
    own (csrc/pdhg_window_cones.cu) agree byte for byte."""
    lib = pdhg_window._library()
    codes = {"f32": 0, "bf16": 1, "bf16x3": 3}
    for mode, code in codes.items():
        for m, n, ci in ((69, 81, 115), (14, 9, 30), (678, 777, 1159),
                         (1, 1, 3)):
            for tile in (8, 12, 16, 24):
                L = pdhg_window.cone_layout(mode, m, n, tile, ci)
                want = (0, 0) if L is None else (L.smem_bytes, L.image_bytes)
                got = (lib.pdhg_window_cones_bytes(code, m, n, tile, ci, 0),
                       lib.pdhg_window_cones_bytes(code, m, n, tile, ci, 1)
                       if L is not None else 0)
                assert got == want, (mode, m, n, tile)


def test_per_scenario_a_window_runs_plain_on_the_card(cuda):
    """farmer's (S, m, n) A: three windows on the card from the CPU's
    initial state equal the CPU's to 2e-6 of the iterate scale (f32
    summation order), and no window kernel launches."""
    specs = [farmer.scenario_creator(nm, num_scens=3)
             for nm in farmer.scenario_names_creator(3)]
    cpu = batch_mod.from_specs(specs, device="cpu")
    gpu = batch_mod.from_specs(specs, device=cuda)
    assert pdhg.window_engine(gpu.qp, "cuda") == "plain"
    opts = pdhg.PDHGOptions(tol=0.0)
    st0 = pdhg.init_state(cpu.qp, opts)
    st0_gpu = dataclasses.replace(st0, **{
        f.name: getattr(st0, f.name).to(cuda)
        for f in dataclasses.fields(st0)
        if isinstance(getattr(st0, f.name), torch.Tensor)})
    before = dict(pdhg_window.run_window.launches)
    want = pdhg.solve_fixed(cpu.qp, 3, opts, st0)
    got = pdhg.solve_fixed(gpu.qp, 3, opts, st0_gpu)
    torch.cuda.synchronize()
    assert dict(pdhg_window.run_window.launches) == before
    for w, g in ((want.x, got.x), (want.y, got.y)):
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 2e-6 * scale


def test_flattened_shuffle_takes_one_launch_per_window(cuda, monkeypatch):
    """xhat_shuffle's k candidates over the sslp(5,15) S=16 batch run as
    one 4x16-scenario solve on the shared A: one box-kernel launch per
    restart window, and the values equal the CPU's to 1e-4."""
    inst = sslp.synthetic_instance(5, 15, seed=0)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=16,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(16)]
    gpu = batch_mod.from_specs(specs, device=cuda)
    cpu = batch_mod.from_specs(specs, device="cpu")
    opts = pdhg.PDHGOptions()
    st = pdhg.solve(cpu.qp, opts, pdhg.init_state(cpu.qp, opts))
    x_non = cpu.nonants(st.x)
    windows = []
    real_window = pdhg._window

    def counting(p, s, o):
        windows.append(p.c.shape[0])
        return real_window(p, s, o)
    monkeypatch.setattr(pdhg, "_window", counting)
    for name in pdhg_window.run_window.launches:
        pdhg_window.run_window.launches[name] = 0
    vals, feas, _, _ = xhat.xhat_shuffle(gpu, x_non.to(cuda), [5, 11, 0, 7],
                                         4)
    torch.cuda.synchronize()
    assert windows and set(windows) == {64}
    assert pdhg_window.run_window.launches["pdhg_window"] == len(windows)
    monkeypatch.setattr(pdhg, "_window", real_window)
    cvals, cfeas, _, _ = xhat.xhat_shuffle(cpu, x_non, [5, 11, 0, 7], 4)
    assert torch.equal(feas.cpu(), cfeas)
    ok = cfeas.numpy()
    np.testing.assert_allclose(vals.cpu().numpy()[ok], cvals.numpy()[ok],
                               rtol=1e-4)


def _uc_batch(device, S=8):
    from mpisppy_tpu_torch.models import uc
    inst = uc.synthetic_instance(10, 24)
    specs = [uc.scenario_creator(nm, instance=inst, num_scens=S)
             for nm in uc.scenario_names_creator(S)]
    return batch_mod.from_specs(specs, device=device)


def test_ell_route_on_the_card_matches_the_cpu(cuda):
    """uc's shared ELL A (m=1708, n=1008, k=11): products equal the
    CPU's to f32 noise, and three plain windows (each device from its
    own norm estimate, the same start vector) equal the CPU's to 1e-5 of
    the iterate scale (chip_smoke.py [ell_parity]'s tolerance), with no
    window kernel launch."""
    from mpisppy_tpu_torch.ops.sparse import EllMatrix
    cpu, gpu = _uc_batch("cpu"), _uc_batch(cuda)
    assert isinstance(gpu.qp.A, EllMatrix) and not pdhg_window.supported(
        gpu.qp)
    assert pdhg.window_engine(gpu.qp, "cuda") == "plain"
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, gpu.qp.n, generator=g)
    y = torch.randn(8, gpu.qp.m, generator=g)
    for gf, cf, v in ((gpu.qp.matvec, cpu.qp.matvec, x),
                      (gpu.qp.rmatvec, cpu.qp.rmatvec, y)):
        want, got = cf(v), gf(v.to(cuda)).cpu()
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    opts = pdhg.PDHGOptions(tol=0.0)
    before = dict(pdhg_window.run_window.launches)
    want = pdhg.solve_fixed(cpu.qp, 3, opts, pdhg.init_state(cpu.qp, opts))
    got = pdhg.solve_fixed(gpu.qp, 3, opts, pdhg.init_state(gpu.qp, opts))
    torch.cuda.synchronize()
    assert dict(pdhg_window.run_window.launches) == before
    for w, k in ((want.x, got.x), (want.y, got.y)):
        assert float((k.cpu() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


def test_normal_on_the_card_equals_the_cpu(cuda):
    """The XLA-exact normal draws the same numbers on the card (IEEE f32
    and f64 elementwise ops on both sides)."""
    from mpisppy_tpu_torch.scengen import random as rnd
    want = rnd.normal(rnd.prng_key(7), (4096,))
    got = rnd.normal(rnd.prng_key(7, cuda), (4096,)).cpu()
    assert torch.equal(got, want)


@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16x3", 1e-3)])
def test_kernel_matches_plain_with_presolved_bounds(cuda, precision, tol):
    """FBBT gives each scenario its own l/u: the box kernel on the
    presolved sslp batch (per-scenario l/u rows) against its plain
    version."""
    from mpisppy_tpu_torch.ops import fbbt
    inst = sslp.synthetic_instance(5, 25, seed=0)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=24)
             for nm in sslp.scenario_names_creator(24)]
    batch, info = fbbt.presolve_batch(
        batch_mod.from_specs(specs, device=cuda))
    assert info["tightened_bounds"] > 0 and batch.qp.l.ndim == 2
    args = _solver_args(batch.qp)
    k = pdhg_window.run_window(*args, precision=precision)
    r = pdhg_window.run_window_reference(*args, precision=precision)
    torch.cuda.synchronize()
    for a, b in zip(k, r):
        assert bool(torch.all((a - b).abs() <= tol + tol * b.abs()))
