# Port parity: W and x̄ files (mpisppy_tpu_torch/utils/wxbarutils.py,
# extensions/wxbar_io.py) and proper bundles (utils/proper_bundler.py,
# pickle_bundle.py) against the JAX package's, the cases of
# tests/test_wxbar_bundles.py.  The W/x̄ CSVs of one state are the same
# text from either package and each package reads the other's files bit
# for bit; form_bundle_spec's arrays equal the JAX package's exactly; a
# bundle pickled by the JAX package is read by the port (its class maps
# to the port's ScenarioSpec) without importing the JAX package, and a
# pickle naming any other class is refused.
import functools
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from mpisppy_tpu.models import farmer as jfarmer
from mpisppy_tpu.models import sslp as jsslp
from mpisppy_tpu.utils import pickle_bundle as jpickle
from mpisppy_tpu.utils import wxbarutils as jwx
from mpisppy_tpu.utils.proper_bundler import ProperBundler as JPB
from mpisppy_tpu.utils.proper_bundler import form_bundle_spec as jform
from mpisppy_tpu_torch.algos import ph as tph
from mpisppy_tpu_torch.core import batch as tbatch
from mpisppy_tpu_torch.models import farmer as tfarmer
from mpisppy_tpu_torch.models import sslp as tsslp
from mpisppy_tpu_torch.ops import pdhg as tpdhg
from mpisppy_tpu_torch.utils import pickle_bundle as tpickle
from mpisppy_tpu_torch.utils import wxbarutils as twx
from mpisppy_tpu_torch.utils.proper_bundler import ProperBundler
from mpisppy_tpu_torch.utils.proper_bundler import form_bundle_spec

from test_torch_extensions import Twins, _opts, farmer_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def farmer_twins():
    jb, tb = farmer_pair()
    return Twins(jb, tb, 10)


def test_w_xbar_files_cross_packages(farmer_twins, tmp_path):
    j, t = farmer_twins.at(10)
    files = {}
    for side, mod, algo in (("j", jwx, j), ("t", twx, t)):
        files[side] = (str(tmp_path / f"{side}_w.csv"),
                       str(tmp_path / f"{side}_x.csv"))
        mod.write_W_to_file(algo, files[side][0])
        mod.write_xbar_to_file(algo, files[side][1])
    for a, b in zip(files["t"], files["j"]):
        assert open(a).read() == open(b).read()
    W, xb = np.asarray(j.state.W), np.asarray(j.state.xbar_nodes)
    # each package reads the other's files into a fresh Iter0 state
    j0, t0 = farmer_twins.at(0)
    twx.set_W_from_file(files["j"][0], t0)
    twx.set_xbar_from_file(files["j"][1], t0)
    np.testing.assert_array_equal(t0.state.W.numpy(), W)
    np.testing.assert_array_equal(t0.state.xbar_nodes.numpy(), xb)
    np.testing.assert_array_equal(t0.state.xbar.numpy(),
                                  np.broadcast_to(xb[0], W.shape))
    jwx.set_W_from_file(files["t"][0], j0)
    jwx.set_xbar_from_file(files["t"][1], j0)
    np.testing.assert_array_equal(np.asarray(j0.state.W), W)
    np.testing.assert_array_equal(np.asarray(j0.state.xbar_nodes), xb)
    twx.ROOT_xbar_npy_serializer(t, str(tmp_path / "root.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "root.npy"), xb[0])


def test_w_check_rejects_invalid_duals(farmer_twins, tmp_path):
    j, t = farmer_twins.at(0)
    wf = str(tmp_path / "w.csv")
    # an all-ones W has a nonzero node mean: not a valid PH dual
    with open(wf, "w") as f:
        for nm in t.scenario_names:
            for i in range(t.batch.num_nonants):
                f.write(f"{nm},{i},1.0\n")
    for mod, algo in ((twx, t), (jwx, j)):
        with pytest.raises(ValueError, match="node mean"):
            mod.set_W_from_file(wf, algo)
    twx.set_W_from_file(wf, t, disable_check=True)  # forced
    assert (t.state.W.numpy() == 1.0).all()
    with open(wf, "a") as f:
        f.write("scen9,0,1.0\n")
    with pytest.raises(ValueError, match="unknown scenario"):
        twx.set_W_from_file(wf, t, disable_check=True)


def test_warm_start_from_saved_w_converges_faster(tmp_path):
    from mpisppy_tpu_torch.extensions.wxbar_io import (
        WXBarReader, WXBarWriter,
    )

    _, tb = farmer_pair()
    wf, xf = str(tmp_path / "w.csv"), str(tmp_path / "x.csv")
    ref = tph.PH(_opts(tph, tpdhg, max_iterations=60, conv_thresh=5e-2),
                 tb, extensions=functools.partial(
                     WXBarWriter, W_fname=wf, Xbar_fname=xf))
    ref.ph_main()
    assert os.path.exists(wf) and os.path.exists(xf)
    warm = tph.PH(_opts(tph, tpdhg, max_iterations=60, conv_thresh=5e-2),
                  tb, extensions=functools.partial(WXBarReader,
                                                   init_W_fname=wf))
    warm.ph_main()
    # the JAX test's allowance: the saved W was taken at a loose stop
    assert warm._iter <= ref._iter + 2
    assert warm._iter < ref._iter


def _specs(mod, model, S):
    if model == "farmer":
        return [mod.scenario_creator(nm, num_scens=S)
                for nm in mod.scenario_names_creator(S)]
    inst = mod.synthetic_instance(5, 10, 0)
    return [mod.scenario_creator(nm, instance=inst, num_scens=S)
            for nm in mod.scenario_names_creator(S)]


@pytest.mark.parametrize("model", ["farmer", "sslp"])
def test_form_bundle_spec_equals_jax(model):
    jm, tm = (jfarmer, tfarmer) if model == "farmer" else (jsslp, tsslp)
    js, ts = _specs(jm, model, 6), _specs(tm, model, 6)
    for lo in (0, 3):
        jb = jform(js[lo:lo + 3], f"Bundle_{lo}")
        tb = form_bundle_spec(ts[lo:lo + 3], f"Bundle_{lo}")
        assert type(tb) is tbatch.ScenarioSpec and tb.name == jb.name
        assert sps.issparse(tb.A)
        assert (tb.A != jb.A).nnz == 0 and tb.A.shape == jb.A.shape
        for f in ("c", "q", "bl", "bu", "l", "u", "nonant_idx", "integer"):
            a, b = getattr(tb, f), getattr(jb, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
        assert tb.probability == jb.probability


def test_bundle_batch_matches_the_scenario_ef():
    """Three farmer bundles of two: the bundle batch is ELL with batched
    values (the plain iteration), and PH over it certifies the 6-scenario
    EF's first stage, as in the JAX package."""
    from mpisppy_tpu_torch.algos import ef as tef
    from mpisppy_tpu_torch.ops.sparse import EllMatrix

    specs = _specs(tfarmer, "farmer", 6)
    bundles = [form_bundle_spec(specs[2 * i:2 * i + 2], f"Bundle_{i}")
               for i in range(3)]
    names = [s.name for s in specs]
    ef_s = tef.ExtensiveForm({"tol": 1e-6}, names,
                             lambda nm, **kw: specs[names.index(nm)], {},
                             device="cpu")
    ef_s.solve_extensive_form()
    bb = tbatch.from_specs(bundles, device="cpu")
    assert isinstance(bb.qp.A, EllMatrix) and bb.qp.A.vals.ndim == 3
    algo = tph.PH(_opts(tph, tpdhg, max_iterations=120, conv_thresh=5e-2),
                  bb)
    conv, eobj, _ = algo.ph_main()
    assert conv <= 5e-2
    assert eobj == pytest.approx(ef_s.get_objective_value(), rel=5e-3)
    np.testing.assert_allclose(algo.first_stage_solution(),
                               [170.0, 80.0, 250.0], atol=5.0)


def test_proper_bundler_api_and_pickles(tmp_path):
    from mpisppy_tpu.utils.config import Config as JConfig
    from mpisppy_tpu_torch.utils.config import Config

    pb, jpb = ProperBundler(tfarmer), JPB(jfarmer)
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.quick_assign("num_scens", int, 6)
        c.quick_assign("scenarios_per_bundle", int, 3)
    names = pb.bundle_names_creator(2, cfg=cfg)
    assert names == jpb.bundle_names_creator(2, cfg=jcfg) \
        == ["Bundle_0_2", "Bundle_3_5"]
    kw, jkw = pb.kw_creator(cfg), jpb.kw_creator(jcfg)
    b0 = pb.scenario_creator(names[0], **kw)
    assert b0.name == "Bundle_0_2" and len(b0.nonant_idx) == 3
    assert pb.scenario_creator("scen0", **kw).name == "scen0"
    # the port's own pickle round trip
    tpickle.write_spec(b0, str(tmp_path / "t"))
    b0r = tpickle.read_spec(str(tmp_path / "t"), "Bundle_0_2")
    np.testing.assert_array_equal(b0r.c, b0.c)
    assert (b0r.A != b0.A).nnz == 0
    # a JAX pickle (its spec class is mpisppy_tpu.core.batch.ScenarioSpec)
    jcfg.quick_assign("pickle_bundles_dir", str, str(tmp_path / "j"))
    jb1 = jpb.scenario_creator(names[1], **jkw)   # jkw["cfg"] is jcfg
    raw = open(tmp_path / "j" / "Bundle_3_5.pkl", "rb").read()
    assert b"mpisppy_tpu.core.batch" in raw
    cfg.quick_assign("unpickle_bundles_dir", str, str(tmp_path / "j"))
    tb1 = pb.scenario_creator(names[1], **kw)
    assert type(tb1) is tbatch.ScenarioSpec
    for f in ("c", "bl", "bu", "l", "u", "nonant_idx"):
        np.testing.assert_array_equal(getattr(tb1, f), getattr(jb1, f))
    assert (tb1.A != jb1.A).nnz == 0
    np.testing.assert_array_equal(
        tb1.c, form_bundle_spec(_specs(tfarmer, "farmer", 6)[3:],
                                "Bundle_3_5").c)
    # the JAX package reads the port's pickle too
    jr = jpickle.read_spec(str(tmp_path / "t"), "Bundle_0_2")
    np.testing.assert_array_equal(jr.c, b0.c)
    # anything but a spec of arrays is refused
    with open(tmp_path / "t" / "evil.pkl", "wb") as f:
        pickle.dump(os.getcwd, f)
    with pytest.raises(pickle.UnpicklingError, match="ScenarioSpec"):
        tpickle.read_spec(str(tmp_path / "t"), "evil")
    with pytest.raises(AssertionError):
        tpickle.check_args({"pickle_bundles_dir": "a",
                            "unpickle_bundles_dir": "b"})
    assert tpickle.have_proper_bundles({"scenarios_per_bundle": 2})
