#!/usr/bin/env python
"""The JAX package's Schur-complement interior point under x64 on the
CPU, against the port's and against scipy HiGHS, on the sslp 5x15 LP
relaxation (ROADMAP.md queue C, item 2).

    JAX_PLATFORMS=cpu python tools/sc_jax_reference.py [S [TOL]]

mpisppy_tpu/algos/sc.py imports jax.experimental.enable_x64, which
jax 0.9.0 lacks; this script enables x64 for the whole process instead
and makes that import a no-op (it changes nothing in the package), then
prints both packages' objectives, their difference, and each one's
relative distance from the HiGHS EF optimum.  S defaults to 100, TOL
(SCOptions.tol) to 1e-12.  Like the tests, it imports both packages; the
port never imports JAX.
"""
import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
import jax.experimental  # noqa: E402

jax.experimental.enable_x64 = lambda: contextlib.nullcontext()

from mpisppy_tpu.algos.sc import SchurComplement as JSC  # noqa: E402
from mpisppy_tpu.algos.sc import SCOptions as JOpts  # noqa: E402
from mpisppy_tpu.core import batch as jbatch  # noqa: E402
from mpisppy_tpu.models import sslp  # noqa: E402
from mpisppy_tpu_torch.algos.sc import SchurComplement as TSC  # noqa: E402
from mpisppy_tpu_torch.algos.sc import SCOptions as TOpts  # noqa: E402
from mpisppy_tpu_torch.core import batch as tbatch  # noqa: E402
from test_farmer_ef_ph import scipy_ef_solve  # noqa: E402


def main():
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    tol = float(sys.argv[2]) if len(sys.argv) > 2 else 1e-12
    inst = sslp.synthetic_instance(5, 15)
    specs = [sslp.scenario_creator(nm, instance=inst, num_scens=S,
                                   lp_relax=True)
             for nm in sslp.scenario_names_creator(S)]
    highs, _ = scipy_ef_solve(specs)
    j = JSC(JOpts(max_iter=250, tol=tol), jbatch.from_specs(specs)).solve()
    t = TSC(TOpts(max_iter=250, tol=tol),
            tbatch.from_specs(specs, device="cpu")).solve()
    print(f"S={S} tol={tol}: HiGHS {highs!r}")
    for name, r in (("jax", j), ("port", t)):
        print(f"  {name}: objective {r['objective']!r} converged "
              f"{r['converged']} rel vs HiGHS "
              f"{abs(r['objective'] - highs) / abs(highs):.3e}")
    print(f"  port vs jax: {abs(t['objective'] - j['objective']) / abs(j['objective']):.3e}")


if __name__ == "__main__":
    main()
