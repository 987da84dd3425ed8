# The split window design on the CPU: its shape rule, its partition of a
# problem's columns and rows over P blocks, and the one-problem window it
# computes held to the JAX package's Pallas kernel.  plan_window is a
# pure function of the mode, the shape and the card's limits (here an
# H100's: 232,448 bytes of shared memory per block, 132 SMs); the split
# kernel itself (csrc/pdhg_window_split.cu) runs only on the card
# (tests/test_torch_cuda.py, chip_smoke.py [split_windows]).
import dataclasses

import numpy as np
import pytest
import torch

from mpisppy_tpu.algos import ef as jef
from mpisppy_tpu.models import ccopf as jccopf
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.ops import pdhg_pallas
from mpisppy_tpu_torch import convert
from mpisppy_tpu_torch.algos.ef import build_ef
from mpisppy_tpu_torch.models import ccopf, sslp
from mpisppy_tpu_torch.ops import boxqp, pdhg_window as pw

torch.set_num_threads(1)

H100 = (232_448, 132)   # (opt-in shared memory per block, SMs)
MODES = ("f32", "bf16", "bf16x3")
N_ITERS = 40
TOL = 1e-4              # tests/test_torch_pdhg_window.py's


def _sslp_ef_shape(num_scens):
    inst = sslp.synthetic_instance(15, 45)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=num_scens,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(num_scens)]
    return tuple(build_ef(specs, device="cpu").qp.A.shape)


# the one-problem shapes the port launches, and the split design's P on
# an H100 (two blocks an SM; at least 8 columns a block)
ONE_PROBLEM = {(660, 6345): 264, (735, 7050): 264, (256, 1015): 126,
               (197, 240): 30, (256, 16): 2}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", sorted(ONE_PROBLEM))
def test_one_problem_shapes_take_the_split_design(mode, shape):
    plan = pw.plan_window(mode, *shape, 1, *H100)
    P = ONE_PROBLEM[shape]
    assert (plan.design, plan.tile, plan.blocks) == ("split", P, P)
    # A's column slab fits a block's shared memory at S=1
    assert plan.a_smem


def test_the_sampled_efs_have_these_shapes():
    """gap_estimators' dense sslp 15x45 EFs: [ci_mmw]'s batch of 9 and
    the MMW default batch of 10, which now has a design."""
    assert _sslp_ef_shape(9) == (660, 6345)
    assert _sslp_ef_shape(10) == (735, 7050)
    assert not pw.streamed_fits(735, 7050, H100[0])
    for mode in MODES:
        assert pw.design_fits(mode, 735, 7050, 1, *H100)


def test_the_root_fixed_ccopf_ef_takes_the_split_design():
    """EFXhatInnerBound's root-fixed ccopf --soc (3,3) EF: 663 x 729 with
    SOC rows, one problem."""
    specs = [ccopf.scenario_creator(nm, branching_factors=(3, 3), soc=True)
             for nm in ccopf.scenario_names_creator(9)]
    qp = boxqp.one_problem(build_ef(specs, tree=ccopf.make_tree((3, 3)),
                                    device="cpu").qp)
    assert (qp.m, qp.n) == (663, 729) and qp.cones is not None
    plan = pw.plan_window("f32", qp.m, qp.n, 1, *H100,
                          cone_ints=pw.cone_ints_of(qp, "cpu"))
    assert plan == pw.WindowPlan("split", 91, 91, True)


@pytest.mark.parametrize("S,P,a_smem", [(1, 264, True), (2, 132, False),
                                        (4, 66, False), (8, 33, False),
                                        (16, 16, False), (33, 8, False)])
def test_small_batches_split_the_card(S, P, a_smem):
    """P = 2 x SMs // S: every SM busy with two blocks; A's slab leaves
    shared memory once two blocks' slabs pass an SM's (from S=2 at the
    sampled EF's shape)."""
    plan = pw.plan_window("f32", 660, 6345, S, *H100)
    assert plan == pw.WindowPlan("split", P, S * P, a_smem)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S", [34, 66, 100, 264, 1000, 10_000])
def test_batches_past_33_stay_streamed(mode, S):
    """From S > SMs / 4 (S=66 and 100 timed at the sampled EF: the split
    window slower than the streamed one) the streamed design takes the
    batch as before, the cross-scenario PH view at S=100 among them."""
    for shape in ((660, 6345), (820, 85), (256, 16)):
        plan = pw.plan_window(mode, *shape, S, *H100)
        assert plan.design == "streamed", (shape, plan)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S", [1, 4, 64, 10_000])
def test_resident_shapes_keep_the_resident_design(mode, S):
    """sslp 15x45's and 5x15's box layouts and ccopf's cone layout are
    unchanged at every S, one problem included."""
    assert pw.plan_window(mode, 60, 705, S, *H100).design == "resident"
    assert pw.plan_window(mode, 20, 85, S, *H100).design == "resident"
    assert pw.plan_window(mode, 69, 81, S, *H100,
                          cone_ints=115).design == "resident"


def test_synthesis_never_takes_the_split_design():
    """TileSynth's in-kernel draws run in the resident or streamed
    designs only; naming split for them raises."""
    plan = pw.plan_window("f32", 660, 6345, 1, *H100, synth=True)
    assert plan.design == "streamed"
    with pytest.raises(ValueError, match="split design cannot take"):
        pw.plan_window("f32", 660, 6345, 1, *H100, design="split",
                       synth=True)


def test_split_design_past_the_cards_blocks_raises():
    """More problems than the card holds blocks at once: no split plan,
    and naming it raises before any launch."""
    assert pw._split_plan("f32", 660, 6345, 265, *H100, False) is None
    with pytest.raises(ValueError, match="split design cannot take"):
        pw.plan_window("f32", 660, 6345, 265, *H100, design="split")
    # past one block an SM: one block a problem where two blocks' shared
    # memory fits an SM (the cross-scenario view), none where it does not
    assert pw._split_plan("f32", 820, 85, 200, *H100, False) == \
        pw.WindowPlan("split", 1, 200, False)
    assert pw._split_plan("f32", 660, 6345, 200, *H100, False) is None


@pytest.mark.parametrize("mode", MODES)
def test_split_smem_bytes(mode):
    """The budget at the sampled EF's shape, one block an SM: a
    49-column slab, 660 x 49 f32 values (bf16: one plane of 2 bytes;
    bf16x3: two)."""
    elem = {"f32": 4, "bf16": 2, "bf16x3": 4}[mode]
    mvecs = 4 if mode == "f32" else 6
    want = pw._round_up(660 * 49 * elem, 16) + 4 * (8 * 49 + mvecs * 660
                                                    + 256)
    assert pw.split_smem_bytes(mode, 660, 6345, 132, False, True) == want
    assert pw.split_smem_bytes(mode, 660, 6345, 132, False, False) == \
        4 * (8 * 49 + mvecs * 660 + 256)
    assert pw.split_smem_bytes(mode, 660, 6345, 132, True, False) == \
        4 * (8 * 49 + (mvecs + 1) * 660 + 256)


# ---- the partition ---------------------------------------------------------

@pytest.mark.parametrize("n,P", [(6345, 132), (7050, 132), (16, 16),
                                 (5, 9), (1, 3), (240, 132)])
def test_column_slabs_cover_every_column_once(n, P):
    slabs = pw.split_columns(n, P)
    assert len(slabs) == P
    cols = [j for c0, c1 in slabs for j in range(c0, c1)]
    assert cols == list(range(n))
    widths = [c1 - c0 for c0, c1 in slabs]
    assert max(widths) - min(widths) <= 1
    assert max(widths) == -(-n // P)     # the kernel's slab row stride


def _parts(layout, m, P, C):
    row_ptr = layout[:P + 1]
    box_cnt = layout[P + 1:2 * P + 1]
    cone_ptr = layout[2 * P + 1:3 * P + 2]
    rows = layout[3 * P + 2:3 * P + 2 + m]
    cones = layout[3 * P + 2 + m:]
    assert len(cones) == C
    return row_ptr, box_cnt, cone_ptr, rows, cones


@pytest.mark.parametrize("m,P", [(660, 132), (197, 132), (7, 3), (3, 8),
                                 (256, 16), (1, 1)])
def test_box_rows_follow_the_kernels_formula(m, P):
    """Without cones, block b owns rows [b*m//P, (b+1)*m//P): the array
    split_rows gives is the formula the kernel computes itself (ragged;
    empty when P > m)."""
    layout = pw.split_rows(m, P)
    row_ptr, box_cnt, cone_ptr, rows, _ = _parts(layout, m, P, 0)
    assert layout.dtype == np.int32
    assert list(rows) == list(range(m))
    assert list(row_ptr) == [b * m // P for b in range(P + 1)]
    assert list(box_cnt) == list(np.diff(row_ptr))
    assert not cone_ptr.any()


def _check_cone_partition(m, P, blocks):
    spec_rows = [np.asarray(b) for b in blocks]
    ptr = np.concatenate([[0], np.cumsum([len(b) for b in spec_rows])])
    flat = np.concatenate(spec_rows) if spec_rows else np.zeros(0, int)
    layout = pw.split_rows(m, P, ptr, flat)
    row_ptr, box_cnt, cone_ptr, rows, cones = _parts(layout, m, P,
                                                     len(blocks))
    # every row in exactly one block's list, every cone in one block
    assert sorted(rows) == list(range(m))
    assert sorted(cones) == list(range(len(blocks)))
    soc = set(flat.tolist())
    for b in range(P):
        own = rows[row_ptr[b]:row_ptr[b + 1]]
        box, tail = own[:box_cnt[b]], own[box_cnt[b]:]
        assert not soc & set(box.tolist())
        mine = cones[cone_ptr[b]:cone_ptr[b + 1]]
        # the block's SOC rows are exactly its cones' rows, whole
        want = [r for k in mine for r in spec_rows[k]]
        assert list(tail) == want
    # balanced: no block past its share by more than the widest cone
    widest = max([len(b) for b in blocks], default=1)
    assert max(np.diff(row_ptr)) <= -(-m // P) + widest
    return layout


def test_cones_stay_whole_in_one_block():
    """Ragged cones out of row order (tests/test_torch_cuda.py's shape)
    at P below, at and above the row count."""
    blocks = [[3, 0, 7], [5, 1, 2, 9, 13], [12, 4]]
    for P in (1, 2, 5, 14, 20):
        _check_cone_partition(14, P, blocks)


def test_ccopf_ef_partition():
    """The root-fixed ccopf EF's 81 cones of 4 rows over 132 blocks."""
    specs = [ccopf.scenario_creator(nm, branching_factors=(3, 3), soc=True)
             for nm in ccopf.scenario_names_creator(9)]
    qp = build_ef(specs, tree=ccopf.make_tree((3, 3)), device="cpu").qp
    ptr, rows = qp.cones.csr("cpu")
    ptr, rows = ptr.numpy(), rows.numpy()
    blocks = [rows[ptr[k]:ptr[k + 1]] for k in range(len(ptr) - 1)]
    layout = _check_cone_partition(qp.m, 132, blocks)
    assert len(layout) == 3 * 132 + 2 + qp.m + len(blocks)


# ---- the one-problem window, held to the JAX package -----------------------

def _window_inputs(m, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (1, n)).astype(np.float32)
    y = rng.normal(scale=0.1, size=(1, m)).astype(np.float32)
    xs = rng.normal(size=(1, n)).astype(np.float32)
    ys = rng.normal(size=(1, m)).astype(np.float32)
    return x, y, xs, ys


@pytest.mark.parametrize("precision,pipeline", [(None, False),
                                                ("bf16x3", True)])
def test_plain_one_problem_window_matches_pallas_interpret(precision,
                                                           pipeline):
    """The plain window (the split kernel's plain version) on a batch of
    one sampled EF (sslp 5x15, 3 scenarios) against the Pallas kernel in
    interpret mode, 40 iterations, at tests/test_torch_pdhg_window.py's
    tolerance; then the same window with its problem done keeps x and y
    bit for bit."""
    inst = jsslp.synthetic_instance(5, 15, seed=0)
    specs = [jsslp.scenario_creator(nm, instance=inst, num_scens=3,
                                    lp_relax=True)
             for nm in jsslp.scenario_names_creator(3)]
    jqp = jef.build_ef(specs).qp
    jqp = dataclasses.replace(jqp, **{k: getattr(jqp, k)[None]
                                      for k in ("c", "q", "l", "u")})
    m, n = np.asarray(jqp.A).shape
    x, y, xs, ys = _window_inputs(m, n)
    x = np.clip(x, np.asarray(jqp.l), np.asarray(jqp.u))
    L = np.linalg.norm(np.asarray(jqp.A), 2)
    tau = np.array([0.9 / L], np.float32)
    sigma = np.array([0.9 / L], np.float32)
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), device="cpu")
    assert tqp.c.shape == (1, n)
    for done in (np.zeros(1, bool), np.ones(1, bool)):
        args = (x, y, xs, ys, tau, sigma, done)
        jout = pdhg_pallas.run_window(jqp, *args, N_ITERS, tile_s=4,
                                      precision=precision,
                                      pipeline=pipeline, interpret=True)
        tout = pw.run_window(tqp, *[torch.as_tensor(a) for a in args],
                             N_ITERS, precision=precision)
        for name, j, t in zip(("x", "y", "x_sum", "y_sum"), jout, tout):
            tol = TOL if name in ("x", "y") else N_ITERS * TOL
            assert np.all(np.isfinite(t.numpy())), name
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol,
                                       rtol=tol, err_msg=name)
        if done[0]:
            np.testing.assert_array_equal(tout[0].numpy(), x)
            np.testing.assert_array_equal(tout[1].numpy(), y)
        else:
            assert np.abs(tout[0].numpy() - x).max() > 0.0


def test_plain_one_problem_conic_window_matches_pallas_interpret():
    """The same for the ccopf --soc (2,1) EF as one problem: SOC rows of
    an EF, f32, 8 iterations from zero sums at tests/test_cones.py's
    tolerances."""
    from mpisppy_tpu.ops import cones as jcones
    specs = [jccopf.scenario_creator(nm, branching_factors=(2, 1), soc=True)
             for nm in jccopf.scenario_names_creator(2)]
    jqp = jef.build_ef(specs, tree=jccopf.make_tree((2, 1))).qp
    assert jqp.cones is not None
    jqp = dataclasses.replace(jqp, **{k: getattr(jqp, k)[None]
                                      for k in ("c", "q", "l", "u")})
    m, n = np.asarray(jqp.A).shape
    x, y, _, _ = _window_inputs(m, n, seed=3)
    x = np.clip(x, np.asarray(jqp.l), np.asarray(jqp.u))
    y = np.array(jcones.project_polar_rows(jqp.cones, y), np.float32)
    xs, ys = np.zeros_like(x), np.zeros_like(y)
    L = np.linalg.norm(np.asarray(jqp.A), 2)
    step = np.array([0.9 / L], np.float32)
    args = (x, y, xs, ys, step, step, np.zeros(1, bool))
    jout = pdhg_pallas.run_window(jqp, *args, 8, tile_s=4, interpret=True)
    tqp = convert.boxqp_from_arrays(convert.arrays_of(jqp), device="cpu")
    tout = pw.run_window(tqp, *[torch.as_tensor(a) for a in args], 8)
    for name, j, t in zip(("x", "y", "x_sum", "y_sum"), jout, tout):
        atol = 2e-6 if name in ("x", "y") else 5e-6
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol,
                                   rtol=0, err_msg=name)
