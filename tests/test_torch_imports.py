# Import guard for the PyTorch / CUDA port: no module under
# mpisppy_tpu_torch/, and not chip_smoke.py or the port's measuring tools
# (PORT_TOOLS), imports JAX or anything of the JAX package (mpisppy_tpu),
# not even its numpy-only modules.
# Checked with an AST scan of every import statement, relative imports
# resolved against the module's package.
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "mpisppy_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mpisppy_tpu")
PORT_TOOLS = ("chip_smoke.py", "tools/soc_tile_sweep.py")


def _port_files():
    files = sorted(PORT.rglob("*.py"))
    files += [ROOT / t for t in PORT_TOOLS if (ROOT / t).exists()]
    return files


def imported_modules(src: str, package: str):
    """Every module an import statement in `src` names."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                base = parts[:len(parts) - node.level + 1]
                yield ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.module


def forbidden(mod: str) -> bool:
    return any(mod == f or mod.startswith(f + ".") for f in FORBIDDEN)


def test_port_tree_is_scanned():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for must in ("mpisppy_tpu_torch/ops/pdhg_window.py",
                 "mpisppy_tpu_torch/ops/pdhg.py",
                 "mpisppy_tpu_torch/core/batch.py",
                 "mpisppy_tpu_torch/algos/fused_wheel.py",
                 "mpisppy_tpu_torch/cylinders/hub.py",
                 "mpisppy_tpu_torch/spin_the_wheel.py",
                 "mpisppy_tpu_torch/convert.py",
                 "mpisppy_tpu_torch/scengen/__init__.py",
                 "mpisppy_tpu_torch/scengen/random.py",
                 "mpisppy_tpu_torch/scengen/program.py",
                 "mpisppy_tpu_torch/scengen/virtual.py",
                 "mpisppy_tpu_torch/scengen/tiles.py",
                 "mpisppy_tpu_torch/generic_cylinders.py",
                 "mpisppy_tpu_torch/__main__.py",
                 "mpisppy_tpu_torch/utils/config.py",
                 "mpisppy_tpu_torch/utils/cfg_vanilla.py",
                 "mpisppy_tpu_torch/ops/sparse.py",
                 "mpisppy_tpu_torch/ops/simplex_qp.py",
                 "mpisppy_tpu_torch/ops/fbbt.py",
                 "mpisppy_tpu_torch/algos/fwph.py",
                 "mpisppy_tpu_torch/models/uc.py",
                 "mpisppy_tpu_torch/extensions/rho_setters.py",
                 "mpisppy_tpu_torch/ops/bnb.py",
                 "mpisppy_tpu_torch/algos/mip.py",
                 "mpisppy_tpu_torch/algos/ef.py",
                 "mpisppy_tpu_torch/dispatch/__init__.py",
                 "mpisppy_tpu_torch/dispatch/buckets.py",
                 "mpisppy_tpu_torch/dispatch/compilewatch.py",
                 "mpisppy_tpu_torch/dispatch/scheduler.py",
                 "mpisppy_tpu_torch/algos/lagrangian.py",
                 "mpisppy_tpu_torch/algos/lshaped.py",
                 "mpisppy_tpu_torch/algos/aph.py",
                 "mpisppy_tpu_torch/algos/cross_scen.py",
                 "mpisppy_tpu_torch/algos/sc.py",
                 "mpisppy_tpu_torch/cylinders/spoke.py",
                 "mpisppy_tpu_torch/extensions/extension.py",
                 "mpisppy_tpu_torch/extensions/cross_scen_extension.py",
                 "mpisppy_tpu_torch/extensions/reduced_costs_fixer.py",
                 "mpisppy_tpu_torch/utils/atomic_io.py",
                 "mpisppy_tpu_torch/telemetry/__init__.py",
                 "mpisppy_tpu_torch/telemetry/events.py",
                 "mpisppy_tpu_torch/telemetry/tracecontext.py",
                 "mpisppy_tpu_torch/telemetry/metrics.py",
                 "mpisppy_tpu_torch/telemetry/bus.py",
                 "mpisppy_tpu_torch/telemetry/sinks.py",
                 "mpisppy_tpu_torch/telemetry/console.py",
                 "mpisppy_tpu_torch/telemetry/views.py",
                 "mpisppy_tpu_torch/telemetry/flightrec.py",
                 "mpisppy_tpu_torch/telemetry/profiler.py",
                 "mpisppy_tpu_torch/resilience/__init__.py",
                 "mpisppy_tpu_torch/resilience/faults.py",
                 "mpisppy_tpu_torch/resilience/watchdog.py",
                 "mpisppy_tpu_torch/algos/async_wheel.py",
                 "mpisppy_tpu_torch/telemetry/counters.py",
                 "mpisppy_tpu_torch/utils/wxbarutils.py",
                 "mpisppy_tpu_torch/utils/host_copy.py",
                 "mpisppy_tpu_torch/telemetry/deviceprof.py",
                 "mpisppy_tpu_torch/telemetry/roofline.py",
                 "mpisppy_tpu_torch/telemetry/analyze.py",
                 "mpisppy_tpu_torch/telemetry/spans.py",
                 "mpisppy_tpu_torch/telemetry/slo.py",
                 "mpisppy_tpu_torch/telemetry/watch.py",
                 "mpisppy_tpu_torch/telemetry/regress.py",
                 "mpisppy_tpu_torch/telemetry/__main__.py",
                 "mpisppy_tpu_torch/models/hydro.py",
                 "mpisppy_tpu_torch/models/aircond.py",
                 "mpisppy_tpu_torch/models/gbd.py",
                 "mpisppy_tpu_torch/models/sizes.py",
                 "mpisppy_tpu_torch/models/usar.py",
                 "mpisppy_tpu_torch/models/apl1p.py",
                 "mpisppy_tpu_torch/models/netdes.py",
                 "mpisppy_tpu_torch/models/battery.py",
                 "mpisppy_tpu_torch/models/distr.py",
                 "mpisppy_tpu_torch/models/stoch_distr.py",
                 "mpisppy_tpu_torch/models/sslp.py",
                 "mpisppy_tpu_torch/utils/sputils.py",
                 "mpisppy_tpu_torch/utils/admmWrapper.py",
                 "mpisppy_tpu_torch/utils/stoch_admmWrapper.py",
                 "mpisppy_tpu_torch/extensions/__init__.py",
                 "mpisppy_tpu_torch/extensions/test_extension.py",
                 "mpisppy_tpu_torch/extensions/fixer.py",
                 "mpisppy_tpu_torch/extensions/phtracker.py",
                 "mpisppy_tpu_torch/extensions/wtracker_extension.py",
                 "mpisppy_tpu_torch/extensions/xhatclosest.py",
                 "mpisppy_tpu_torch/extensions/mipgapper.py",
                 "mpisppy_tpu_torch/extensions/diagnoser.py",
                 "mpisppy_tpu_torch/extensions/avgminmaxer.py",
                 "mpisppy_tpu_torch/extensions/wxbar_io.py",
                 "mpisppy_tpu_torch/convergers/__init__.py",
                 "mpisppy_tpu_torch/convergers/converger.py",
                 "mpisppy_tpu_torch/convergers/fracintsnotconv.py",
                 "mpisppy_tpu_torch/convergers/norm_rho_converger.py",
                 "mpisppy_tpu_torch/convergers/primal_dual_converger.py",
                 "mpisppy_tpu_torch/utils/amalgamator.py",
                 "mpisppy_tpu_torch/utils/gradient.py",
                 "mpisppy_tpu_torch/utils/rho_utils.py",
                 "mpisppy_tpu_torch/utils/nonant_sensitivities.py",
                 "mpisppy_tpu_torch/utils/prox_approx.py",
                 "mpisppy_tpu_torch/utils/proper_bundler.py",
                 "mpisppy_tpu_torch/utils/pickle_bundle.py",
                 "mpisppy_tpu_torch/utils/wtracker.py",
                 "mpisppy_tpu_torch/confidence_intervals/__init__.py",
                 "mpisppy_tpu_torch/confidence_intervals/ciutils.py",
                 "mpisppy_tpu_torch/confidence_intervals/"
                 "confidence_config.py",
                 "mpisppy_tpu_torch/confidence_intervals/mmw_ci.py",
                 "mpisppy_tpu_torch/confidence_intervals/mmw_conf.py",
                 "mpisppy_tpu_torch/confidence_intervals/sample_tree.py",
                 "mpisppy_tpu_torch/confidence_intervals/seqsampling.py",
                 "mpisppy_tpu_torch/confidence_intervals/zhat4xhat.py",
                 "mpisppy_tpu_torch/mpc/__init__.py",
                 "mpisppy_tpu_torch/mpc/shift.py",
                 "mpisppy_tpu_torch/mpc/horizon.py",
                 "mpisppy_tpu_torch/mpc/driver.py",
                 "mpisppy_tpu_torch/mpc/stream.py",
                 "mpisppy_tpu_torch/serve/__init__.py",
                 "mpisppy_tpu_torch/serve/__main__.py",
                 "mpisppy_tpu_torch/serve/protocol.py",
                 "mpisppy_tpu_torch/serve/session.py",
                 "mpisppy_tpu_torch/serve/admission.py",
                 "mpisppy_tpu_torch/serve/multiplex.py",
                 "mpisppy_tpu_torch/serve/engine.py",
                 "mpisppy_tpu_torch/serve/server.py",
                 "mpisppy_tpu_torch/serve/loadgen.py",
                 "mpisppy_tpu_torch/fleet/__init__.py",
                 "mpisppy_tpu_torch/fleet/health.py",
                 "mpisppy_tpu_torch/fleet/placement.py",
                 "mpisppy_tpu_torch/fleet/replica.py",
                 "mpisppy_tpu_torch/fleet/migration.py",
                 "mpisppy_tpu_torch/fleet/router.py",
                 "mpisppy_tpu_torch/parallel/__init__.py",
                 "mpisppy_tpu_torch/parallel/mesh.py",
                 "mpisppy_tpu_torch/parallel/elastic.py",
                 "mpisppy_tpu_torch/parallel/_multihost_dryrun.py",
                 "mpisppy_tpu_torch/parallel/_elastic_dryrun.py",
                 *PORT_TOOLS):
        assert must in names


def test_every_jax_module_has_a_counterpart():
    """A file-list comparison of the two packages: every module of the
    JAX package has one of the same relative name in the port, apart
    from ops/pdhg_pallas.py, whose counterparts are ops/pdhg_window.py
    and csrc/."""
    jax_pkg = ROOT / "mpisppy_tpu"
    missing = sorted(
        p.relative_to(jax_pkg).as_posix() for p in jax_pkg.rglob("*.py")
        if "__pycache__" not in p.parts
        and not (PORT / p.relative_to(jax_pkg)).exists())
    assert missing == ["ops/pdhg_pallas.py"]
    assert (PORT / "ops" / "pdhg_window.py").exists()
    assert sorted(p.name for p in (PORT / "csrc").glob("*.cu"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    rel = path.relative_to(ROOT)
    package = ".".join(rel.with_suffix("").parts[:-1])
    bad = [m for m in imported_modules(path.read_text(), package)
           if forbidden(m)]
    assert not bad, f"{rel} imports {bad}"


def test_guard_catches_forbidden_imports():
    """Plain, from-, aliased, dotted and relative imports of the JAX
    package are all found; the port's own name is not a false hit."""
    src = ("import jax.numpy as jnp\nfrom mpisppy_tpu.models import sslp\n"
           "import mpisppy_tpu_torch\nfrom mpisppy_tpu_torch.ops import pdhg\n"
           "from ..ops import boxqp\n")
    mods = list(imported_modules(src, "mpisppy_tpu.algos"))
    assert [m for m in mods if forbidden(m)] == [
        "jax.numpy", "mpisppy_tpu.models", "mpisppy_tpu.ops"]
