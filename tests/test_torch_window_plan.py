# The window kernels' shape rule and the resident designs' packed A, on
# the CPU.  plan_window is a pure function of the mode, the shape and the
# card's limits (here an H100's: 232,448 bytes of shared memory per
# block, 132 SMs); pack_resident and pack_cones lay A out as the resident
# kernels copy it into shared memory.  The kernels themselves run only on the card
# (tests/test_torch_cuda.py).
import numpy as np
import pytest
import torch

from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.models import ccopf, sslp
from mpisppy_tpu_torch.ops import pdhg_window as pw

torch.set_num_threads(1)

H100 = (232_448, 132)   # (opt-in shared memory per block, SMs)
MODES = ("f32", "bf16", "bf16x3")


def _sslp_shape(n_servers, n_clients):
    specs = [sslp.scenario_creator(nm, n_servers=n_servers,
                                   n_clients=n_clients, num_scens=2,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(2)]
    qp = batch_mod.from_specs(specs, device="cpu").qp
    return qp.m, qp.n


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("S", [10_000, 100_000, 64])
def test_sslp_15_45_takes_the_resident_design(mode, S):
    m, n = _sslp_shape(15, 45)
    assert (m, n) == (60, 705)
    plan = pw.plan_window(mode, m, n, S, *H100)
    assert plan.design == "resident" and plan.tile == pw.RESIDENT_TILE
    assert plan.blocks == min(-(-S // 8), 132)


@pytest.mark.parametrize("mode", MODES)
def test_sslp_5_15_takes_the_resident_design(mode):
    m, n = _sslp_shape(5, 15)
    plan = pw.plan_window(mode, m, n, 64, *H100)
    assert plan == pw.WindowPlan("resident", 8, 8)


def test_resident_layout_at_sslp_15_45():
    """The budget the kernel's note states: bf16x3 packs A to 2 planes
    of 64 x 728 bf16; f32 keeps it unpadded (odd stride 705)."""
    b3 = pw.resident_layout("bf16x3", 60, 705)
    assert (b3.m_pad, b3.n_pad, b3.a_stride, b3.planes) == (64, 720, 728, 2)
    assert b3.image_bytes == 2 * 64 * 728 * 2 == 186_368
    assert b3.smem_bytes == 216_320
    f32 = pw.resident_layout("f32", 60, 705)
    assert (f32.a_stride, f32.image_bytes) == (705, 169_200)
    assert f32.smem_bytes == 211_088
    assert pw.resident_layout("bf16", 60, 705).image_bytes == 93_184


def _ccopf_shape(n_buses=4):
    """(m, n, cone_ints) of the ccopf --soc batch on a feeder of n_buses:
    the cone layout's ints are the CSR offsets, the CSR rows and a flag
    per row."""
    inst = ccopf.feeder_instance(n_buses=n_buses)
    specs = [ccopf.scenario_creator(nm, instance=inst,
                                    branching_factors=(2, 1), soc=True)
             for nm in ccopf.scenario_names_creator(2)]
    qp = batch_mod.from_specs(specs, tree=ccopf.make_tree((2, 1), inst),
                              device="cpu").qp
    _, rows = qp.cones.csr("cpu")
    return qp.m, qp.n, qp.cones.num_cones + 1 + rows.numel() + qp.m


# the cone design's tile and blocks at ccopf's S=10,000: f32 fits two
# 24-scenario blocks an SM (417 tiles in 2 rounds over 264 slots); bf16
# fits one 24-scenario block an SM but two 16-scenario ones (3 rounds
# against 4); bf16x3 one 24-scenario block an SM
CCOPF_S10K = {"f32": (24, 264), "bf16": (16, 264), "bf16x3": (24, 132)}


@pytest.mark.parametrize("mode", MODES)
def test_ccopf_cones_take_the_resident_design(mode):
    m, n, cone_ints = _ccopf_shape()
    assert (m, n, cone_ints) == (69, 81, 115)
    tile, blocks = CCOPF_S10K[mode]
    for S, want in ((10_000, pw.WindowPlan("resident", tile, blocks)),
                    (64, pw.WindowPlan("resident", 8, 8))):
        plan = pw.plan_window(mode, m, n, S, *H100, cone_ints=cone_ints)
        assert plan == want, (S, plan)
    # naming the streamed design still runs it, four scenarios a block
    plan = pw.plan_window(mode, m, n, 10_000, *H100, cone_ints=cone_ints,
                          design="streamed")
    assert plan == pw.WindowPlan("streamed", 4, 2500)


@pytest.mark.parametrize("S,tile,blocks", [(1, 8, 1), (7, 8, 1),
                                           (1059, 8, 133), (2000, 8, 250),
                                           (5000, 24, 209),
                                           (100_000, 24, 264)])
def test_cone_tile_takes_the_fewest_rounds_then_the_smallest(S, tile,
                                                             blocks):
    """f32 at ccopf's shape: a batch that fits the card's 264 block slots
    in one round at every tile gets the smallest; S=5,000 is one round
    at 24 but two at 16 and three at 8."""
    plan = pw.plan_window("f32", 69, 81, S, *H100, cone_ints=115)
    assert plan == pw.WindowPlan("resident", tile, blocks)


@pytest.mark.parametrize("mode", MODES)
def test_33_bus_feeder_cones_stay_streamed(mode):
    """The 33-bus feeder's A (678 x 777, 2.1 MB in f32) fits no tile of
    the cone layout; naming the resident design for it raises."""
    m, n, cone_ints = _ccopf_shape(33)
    assert (m, n) == (678, 777)
    L = pw.cone_layout(mode, m, n, 8, cone_ints)
    assert L.smem_bytes > H100[0]
    for S, spb in ((256, 1), (10_000, 4)):
        plan = pw.plan_window(mode, m, n, S, *H100, cone_ints=cone_ints)
        assert plan.design == "streamed" and plan.tile == spb
    with pytest.raises(ValueError):
        pw.plan_window(mode, m, n, 256, *H100, cone_ints=cone_ints,
                       design="resident")


@pytest.mark.parametrize("mode", MODES)
def test_cone_layout_beyond_the_cards_shared_memory_is_streamed(mode):
    """A cone shape whose smallest tile's shared memory the card does not
    have goes to the streamed design; a little more takes it resident."""
    L = pw.cone_layout(mode, 69, 81, 8, 115)
    small_card = (L.smem_bytes, 132)
    assert pw.plan_window(mode, 69, 81, 10_000, *small_card,
                          cone_ints=115).design == "streamed"
    big_card = (L.smem_bytes + 4096, 132)
    assert pw.plan_window(mode, 69, 81, 10_000, *big_card,
                          cone_ints=115) == pw.WindowPlan("resident", 8, 132)


def test_cone_layout_at_ccopf():
    """The budget the kernel's note states: A unpadded with an odd row
    stride (81), one f32 plane (two in bf16x3), ~3.6 KB of state a
    scenario in f32, so two 24-scenario blocks share an SM."""
    f32 = pw.cone_layout("f32", 69, 81, 24, 115)
    assert (f32.a_stride, f32.planes, f32.n_vecs, f32.m_vecs) == (81, 1, 7, 5)
    assert f32.image_bytes == 4 * 5592 == 22_368
    assert f32.smem_bytes == 22_368 + 4 * 24 * (7 * 81 + 5 * 69) + 4 * 115
    assert f32.smem_bytes == 110_380
    assert 2 * (f32.smem_bytes + 2048) <= H100[0] + 1024
    # at tile 8 the dots are split in 3: partial sums for 3 x 8 x 81
    assert pw.cone_layout("f32", 69, 81, 8, 115).smem_bytes == \
        22_368 + 4 * 8 * 912 + 4 * 3 * 8 * 81 + 4 * 115 == 59_788
    b3 = pw.cone_layout("bf16x3", 69, 81, 24, 115)
    assert (b3.planes, b3.n_vecs, b3.m_vecs) == (2, 8, 7)
    assert (b3.image_bytes, b3.smem_bytes) == (44_720, 153_756)
    assert pw.cone_layout("bf16", 69, 81, 16, 115).smem_bytes == 85_612
    assert pw.cone_layout("f32", 69, 81, 12, 115) is None


@pytest.mark.parametrize("m,n", [(69, 81), (14, 9), (20, 85)])
@pytest.mark.parametrize("mode", MODES)
def test_packed_cones_a(mode, m, n):
    """Zero padding, the planes equal to A or its bf16 split, and the
    kernel's products over the packed rows equal to _matmul."""
    rng = np.random.default_rng(m * n)
    A = torch.as_tensor(rng.normal(size=(m, n)), dtype=torch.float32)
    L = pw.cone_layout(mode, m, n, 8, 1)
    img = pw.pack_cones(A, L)
    assert img.dtype == torch.float32
    assert img.numel() * 4 == L.image_bytes
    size = m * L.a_stride
    planes = [img[k * size:(k + 1) * size].view(m, L.a_stride)
              for k in range(L.planes)]
    assert not img[L.planes * size:].any()
    hi, lo = pw._split_bf16(A)
    want = {"f32": [A], "bf16": [hi], "bf16x3": [hi, lo]}[mode]
    for P, W in zip(planes, want):
        assert torch.equal(P[:, :n], W) and not P[:, n:].any()
    S = 8
    y = torch.as_tensor(rng.normal(size=(S, m)), dtype=torch.float32)
    P_hi = planes[0][:, :n]
    P_lo = planes[1][:, :n] if L.planes == 2 else None
    got = pw._matmul(mode, y, P_hi, P_hi, P_lo)
    ref_hi, ref_lo = (hi, lo) if mode != "f32" else (None, None)
    torch.testing.assert_close(got, pw._matmul(mode, y, A, ref_hi, ref_lo),
                               atol=0, rtol=0)


@pytest.mark.parametrize("m,n", [(65, 705), (60, 769), (200, 3000)])
@pytest.mark.parametrize("mode", MODES)
def test_a_too_large_takes_the_streamed_design(mode, m, n):
    assert pw.resident_layout(mode, m, n) is None
    plan = pw.plan_window(mode, m, n, 10_000, *H100)
    assert plan.design == "streamed"


@pytest.mark.parametrize("mode", MODES)
def test_layout_beyond_the_cards_shared_memory_is_streamed(mode):
    """A shape inside the layout's limits whose shared memory the card
    does not have goes to the streamed design."""
    L = pw.resident_layout(mode, 64, 768)
    small_card = (L.smem_bytes, 132)
    assert pw.plan_window(mode, 64, 768, 10_000, *small_card).design == \
        "streamed"
    big_card = (L.smem_bytes + 4096, 132)
    assert pw.plan_window(mode, 64, 768, 10_000, *big_card).design == \
        "resident"


@pytest.mark.parametrize("shape,S", [((820, 85), 100), ((256, 16), 1),
                                     ((256, 1015), 1)])
@pytest.mark.parametrize("mode", MODES)
def test_this_slices_batches_take_the_streamed_design(mode, shape, S):
    """The batches of the decomposition hubs past the resident rows: the
    cross-scenario PH view of sslp 5x15 at S=100 (8 rounds of 100 cut
    rows under its 20) fills the card and stays streamed, one scenario a
    block; the single-cut and the multi-cut L-shaped masters (a 256-row
    cut buffer, one problem; multi-cut at S=1,000) take the split
    design, two blocks an SM and at least 8 columns a block."""
    plan = pw.plan_window(mode, *shape, S, *H100)
    if S > 1:
        assert plan == pw.WindowPlan("streamed", 1, S)
    else:
        P = min(264, shape[1] // 8)
        assert plan == pw.WindowPlan("split", P, P, True)


@pytest.mark.parametrize("mode", MODES)
def test_a_shape_no_design_takes_raises(mode):
    """One streamed scenario's vectors past the block's shared memory,
    and a split block's m-vectors too: no design takes the shape, and
    the rule says so instead of handing the launch a block it cannot
    start.  (6,000 x 4,000, past the streamed design, now splits.)"""
    m, n = 20_000, 4_000
    assert pw.streamed_smem_bytes(m, n, 1) > H100[0]
    assert pw.split_smem_bytes(mode, m, n, 26, False, False) > H100[0]
    with pytest.raises(ValueError, match="no window design"):
        pw.plan_window(mode, m, n, 10, *H100)
    assert pw.plan_window(mode, 6_000, 4_000, 10, *H100).design == "split"


@pytest.mark.parametrize("m,n", [(60, 705), (13, 77), (20, 85)])
@pytest.mark.parametrize("mode", MODES)
def test_packed_a(mode, m, n):
    """Zero padding, hi + lo recovering A to the split's precision, and a
    plain matvec pair over the packed operands equal to _matmul on the
    unpadded ones."""
    rng = np.random.default_rng(m + n)
    A = torch.as_tensor(rng.normal(size=(m, n)), dtype=torch.float32)
    L = pw.resident_layout(mode, m, n)
    img = pw.pack_resident(A, L)
    assert img.numel() * img.element_size() == L.image_bytes
    if mode == "f32":
        rows = img[:m * L.a_stride].view(m, L.a_stride)
        assert torch.equal(rows[:, :n], A)
        assert not rows[:, n:].any() and not img[m * L.a_stride:].any()
        planes = [rows[:, :n]]
    else:
        planes = [img[k].float() for k in range(L.planes)]
        for P in planes:
            assert not P[m:].any() and not P[:, n:].any()
        hi, lo = pw._split_bf16(A)
        assert torch.equal(planes[0][:m, :n], hi)
        if mode == "bf16x3":
            assert torch.equal(planes[1][:m, :n], lo)
            rec = planes[0][:m, :n] + planes[1][:m, :n]
            torch.testing.assert_close(rec, A, atol=0, rtol=2.0 ** -16)
    # y (S, m) -> A'y and v (S, n) -> A v through the padded operands
    S = 8
    y = torch.as_tensor(rng.normal(size=(S, m)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(S, n)), dtype=torch.float32)
    hi, lo = pw._split_bf16(A) if mode != "f32" else (None, None)
    want_aty = pw._matmul(mode, y, A, hi, lo)
    want_av = pw._matmul(mode, v, A.T, None if hi is None else hi.T,
                         None if lo is None else lo.T)
    Mp = planes[0].shape[0]
    Np = planes[0].shape[1]
    yp = torch.zeros(S, Mp)
    yp[:, :m] = y
    vp = torch.zeros(S, Np)
    vp[:, :n] = v
    P_hi = planes[0]
    P_lo = planes[1] if len(planes) == 2 else None
    got_aty = pw._matmul(mode, yp, P_hi, P_hi, P_lo)[:, :n]
    got_av = pw._matmul(mode, vp, P_hi.T, P_hi.T,
                        None if P_lo is None else P_lo.T)[:, :m]
    torch.testing.assert_close(got_aty, want_aty, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(got_av, want_av, atol=1e-5, rtol=1e-6)


def test_build_inputs_cover_every_csrc_file():
    """The rebuild check compares the library against every source and
    header under csrc/, not one file."""
    names = {p.name for p in pw._build_inputs()}
    assert {"pdhg_window.cu", "pdhg_window_resident.cu",
            "pdhg_window_cones.cu", "pdhg_window_split.cu",
            "pdhg_window_common.cuh"} <= names
    assert {p.name for p in pw.SOURCES} <= names


def test_library_is_stale_when_any_build_input_is_newer(tmp_path,
                                                        monkeypatch):
    import os
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "common.cuh"):
        (csrc / name).write_text("")
        os.utime(csrc / name, (100, 100))
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(pw, "CSRC", csrc)
    monkeypatch.setattr(pw, "LIBRARY", lib)
    assert pw._stale()                      # missing
    lib.write_text("")
    os.utime(lib, (200, 200))
    assert not pw._stale()
    os.utime(csrc / "common.cuh", (300, 300))  # only the header changed
    assert pw._stale()


@pytest.mark.parametrize("shape,cone_ints", [
    ((60, 705), 0), ((64, 768), 0), ((660, 6345), 0), ((735, 7050), 0),
    ((6_000, 4_000), 0), ((20_000, 4_000), 0), ((69, 81), 115),
    ((678, 777), 1_500)])
@pytest.mark.parametrize("card", [H100, (100_000, 132)])
@pytest.mark.parametrize("mode", MODES)
def test_design_fits_is_the_condition_plan_window_plans_under(
        mode, card, shape, cone_ints):
    """design_fits (what takes() asks on the card) holds exactly where
    plan_window, with no design named, returns a plan; where it fails,
    plan_window raises its own "no window design" error."""
    m, n = shape
    fits = pw.design_fits(mode, m, n, 1, *card, cone_ints=cone_ints)
    if fits:
        plan = pw.plan_window(mode, m, n, 1, *card, cone_ints=cone_ints)
        assert plan.design in ("resident", "streamed", "split")
    else:
        assert not pw.streamed_fits(m, n, card[0], cone_ints)
        assert pw._split_plan(mode, m, n, 1, *card, cone_ints > 0) is None
        with pytest.raises(ValueError, match="no window design"):
            pw.plan_window(mode, m, n, 1, *card, cone_ints=cone_ints)
