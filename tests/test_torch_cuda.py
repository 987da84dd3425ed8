# Tests of the port that need an NVIDIA GPU (marker `cuda`; each skips
# without one).  This file imports neither JAX nor the JAX package, so
# it also runs on a machine with only PyTorch for CUDA:
#
#     python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
#
# (--noconftest: tests/conftest.py configures JAX, which such a machine
# does not have.)  The kernel is held to its plain version at a small
# sslp shape; chip_smoke.py does the same at the main path's shapes.
import dataclasses

import pytest
import torch

from mpisppy_tpu_torch.core import batch as batch_mod
from mpisppy_tpu_torch.models import sslp
from mpisppy_tpu_torch.ops import pdhg, pdhg_window

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
    b = batch_mod.from_specs(specs, device=device)
    opts = pdhg.PDHGOptions()
    st = pdhg.solve_fixed(b.qp, 2, opts, pdhg.init_state(b.qp, opts))
    tau = opts.step_margin * st.omega / st.Lnorm
    sigma = opts.step_margin / (st.omega * st.Lnorm)
    done = torch.zeros_like(st.done)
    done[::5] = True
    return (b.qp, st.x, st.y, st.x_sum, st.y_sum, tau, sigma, done, 40)


@pytest.mark.parametrize("precision,tol", [(None, 1e-4), ("bf16x3", 1e-3)])
def test_kernel_matches_plain_version(cuda, precision, tol):
    """Same inputs through the kernel and its plain version on the card:
    f32 differs only in summation order; bf16x3 splits values whose last
    bits differ, so its products move by ~2^-16."""
    args = _window_args(cuda)
    before = pdhg_window.run_window.launches
    k = pdhg_window.run_window(*args, precision=precision)
    r = pdhg_window.run_window_reference(*args, precision=precision)
    assert pdhg_window.run_window.launches == before + 1
    for a, b in zip(k, r):
        torch.testing.assert_close(a, b, atol=tol, rtol=tol)
    done = args[7]
    assert torch.equal(k[0][done], args[1][done])
    assert torch.equal(k[1][done], args[2][done])


def test_wrapper_refuses_what_the_kernel_does_not_cover(cuda):
    """Per-scenario A and CPU-resident operands never take a plain-
    version detour on a CUDA tensor: the wrapper raises before any
    launch."""
    args = _window_args(cuda, S=4)
    qp = args[0]
    per_scen = dataclasses.replace(
        qp, A=qp.A.expand(4, -1, -1).contiguous())
    before = pdhg_window.run_window.launches
    with pytest.raises(NotImplementedError):
        pdhg_window.run_window(per_scen, *args[1:])
    with pytest.raises(ValueError):
        pdhg_window.run_window(*args[:7], args[7].cpu(), args[8])
    assert pdhg_window.run_window.launches == before


def test_entry_points_run_on_cuda_by_default(cuda):
    specs = [sslp.scenario_creator(nm, n_servers=3, n_clients=4,
                                   num_scens=2, lp_relax=True)
             for nm in sslp.scenario_names_creator(2)]
    assert batch_mod.from_specs(specs).device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32
