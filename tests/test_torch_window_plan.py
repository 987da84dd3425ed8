# The window kernels' shape rule and the resident design's packed A, on
# the CPU.  plan_window is a pure function of the mode, the shape and the
# card's limits (here an H100's: 232,448 bytes of shared memory per
# block, 132 SMs); pack_resident lays A out as the resident kernel copies
# it into shared memory.  The kernels themselves run only on the card
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


@pytest.mark.parametrize("mode", MODES)
def test_ccopf_cones_take_the_streamed_design(mode):
    specs = [ccopf.scenario_creator(nm, branching_factors=(3, 3), soc=True)
             for nm in ccopf.scenario_names_creator(9)]
    qp = batch_mod.from_specs(specs, tree=ccopf.make_tree((3, 3)),
                              device="cpu").qp
    _, rows = qp.cones.csr("cpu")
    cone_ints = qp.cones.num_cones + 1 + rows.numel() + qp.m
    for S, spb in ((10_000, 4), (64, 1)):
        plan = pw.plan_window(mode, qp.m, qp.n, S, *H100, cone_ints=cone_ints)
        assert plan == pw.WindowPlan("streamed", spb, -(-S // spb))


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
