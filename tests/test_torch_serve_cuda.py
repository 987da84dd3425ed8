# Card test of the wheel server's threads (marker `cuda`; skips without an
# NVIDIA GPU).  Sessions run in worker threads of one process, so two of
# them can reach their first window together in a fresh checkout: the
# kernels' library must then be built once (ops/pdhg_window.py's
# _library under its lock, build() under names of its process and
# thread), and run_window's launch counters must count both sessions'
# windows exactly.  This file imports neither JAX nor the JAX package:
#
#     python -m pytest --noconftest -m cuda tests/test_torch_serve_cuda.py -q
import threading
import time

import pytest
import torch

from mpisppy_tpu_torch.ops import pdhg_window
from mpisppy_tpu_torch.serve import SubmitRequest
from mpisppy_tpu_torch.serve.engine import WheelEngine
from mpisppy_tpu_torch.serve.session import Session

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_two_sessions_build_the_library_once(cuda, tmp_path, monkeypatch):
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(pdhg_window, "BUILD_DIR", build_dir)
    monkeypatch.setattr(pdhg_window, "LIBRARY",
                        build_dir / "libpdhg_window.so")
    monkeypatch.setattr(pdhg_window, "BUILD_LOG",
                        build_dir / "pdhg_window.log")
    monkeypatch.setattr(pdhg_window, "_lib", None)
    builds, lock = [], threading.Lock()
    real_build = pdhg_window.build

    def slow_build():
        # hold the first build open so the other session arrives during it
        with lock:
            builds.append(threading.get_ident())
        time.sleep(1.0)
        return real_build()

    monkeypatch.setattr(pdhg_window, "build", slow_build)
    real = pdhg_window.run_window
    calls = [0]

    def counted(*a, **k):
        out = real(*a, **k)
        with lock:
            calls[0] += 1
        return out

    counted.launches = real.launches
    counted.launches_by_design = real.launches_by_design
    monkeypatch.setattr(pdhg_window, "run_window", counted)
    before = sum(real.launches.values())
    eng = WheelEngine(multiplexed=False, device="cuda")
    barrier = threading.Barrier(2)
    out = {}

    def session(i):
        spec = SubmitRequest(tenant=f"t{i}", model="sslp", num_scens=16 + i,
                             max_iterations=2)
        barrier.wait(timeout=60)
        out[i] = eng.run(Session(spec))

    threads = [threading.Thread(target=session, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads)
    assert [out[i][0] for i in range(2)] == ["done", "done"], out
    assert len(builds) == 1
    assert (build_dir / "libpdhg_window.so").exists()
    assert not list(build_dir.glob(".*.o")) + list(build_dir.glob(".*.so"))
    assert calls[0] > 0
    assert sum(real.launches.values()) - before == calls[0]
