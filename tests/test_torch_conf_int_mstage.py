# Port parity: the multistage confidence intervals (sampled subtrees,
# mpisppy_tpu_torch/confidence_intervals/sample_tree.py, and their
# drivers) against the JAX package on the CPU, on aircond's (2, 2) tree
# (tests/test_conf_int.py's multistage cases): each package samples its
# own aircond through start_seed (the node-keyed RandomState) or, with
# use_scengen, through the scengen program.  EF objectives, per-node
# x̂s, G and s agree to REL = 1e-4 of max(|objective|, 1) (the EF is
# solved to tol 1e-6 in f32); seeds, tree counts and iteration counts
# exactly.
import jax.numpy as jnp  # noqa: F401  (the JAX package needs it loaded)
import numpy as np
import pytest
import torch

from mpisppy_tpu.confidence_intervals import ciutils as jci
from mpisppy_tpu.confidence_intervals import sample_tree as jst
from mpisppy_tpu.confidence_intervals import seqsampling as jseq
from mpisppy_tpu.confidence_intervals import zhat4xhat as jzhat
from mpisppy_tpu.models import aircond as jaircond
from mpisppy_tpu.ops import pdhg as jpdhg
from mpisppy_tpu.utils.config import Config as JConfig
from mpisppy_tpu_torch.confidence_intervals import ciutils as tci
from mpisppy_tpu_torch.confidence_intervals import sample_tree as tst
from mpisppy_tpu_torch.confidence_intervals import seqsampling as tseq
from mpisppy_tpu_torch.confidence_intervals import zhat4xhat as tzhat
from mpisppy_tpu_torch.models import aircond as taircond
from mpisppy_tpu_torch.utils.config import Config as TConfig

torch.set_num_threads(1)

BFS = (2, 2)
REL = 1e-4
TOPTS = tci.DEFAULT_OPTS          # tol 1e-6, cap 20,000
JOPTS = jpdhg.PDHGOptions(tol=TOPTS.tol, max_iters=TOPTS.max_iters)
XHAT_ROOT = np.array([200.0, 0.0])


def _cfgs(num_scens=None, **kw):
    out = []
    for Config in (JConfig, TConfig):
        cfg = Config()
        if num_scens is not None:
            cfg.quick_assign("num_scens", int, num_scens)
        cfg.quick_assign("branching_factors", list, list(BFS))
        for k, v in kw.items():
            cfg.quick_assign(k, type(v), v)
        out.append(cfg)
    return out


def _close(a, b, scale=None):
    scale = max(abs(a if scale is None else scale), 1.0)
    return abs(a - b) <= REL * scale


def _subtrees(xhat, seed, **kw):
    jcfg, tcfg = _cfgs(**kw)
    j = jst.SampleSubtree(jaircond, xhat, BFS, seed, jcfg, JOPTS)
    t = tst.SampleSubtree(taircond, xhat, BFS, seed, tcfg, TOPTS,
                          device="cpu")
    return j, j.run(), t, t.run()


@pytest.mark.parametrize("xhat", [None, XHAT_ROOT], ids=["free", "fixed"])
def test_subtree_ef_objective_matches_jax(xhat):
    _, jobj, t, tobj = _subtrees(xhat, 7)
    assert _close(jobj, tobj), (jobj, tobj)
    if xhat is not None:
        _, free = _subtrees(None, 7)[2:]
        # the pinned root costs at least as much as the free one
        assert tobj >= free - 1e-3 * abs(free)
        root = t.ef.x[:, np.asarray(t.ef.ef.nonant_idx)[:2]]
        np.testing.assert_allclose(root, np.broadcast_to(xhat, root.shape),
                                   rtol=1e-6)


def test_subtree_seed_varies_samples():
    """aircond takes start_seed through **kw: the seed must reach the
    creator, or every sampled subtree is the same."""
    assert tst._accepts_start_seed(taircond)
    assert tst._accepts_start_seed(taircond) \
        == jst._accepts_start_seed(jaircond)
    objs = [_subtrees(None, seed)[3] for seed in (100, 5000)]
    assert objs[0] != objs[1]
    assert tst._number_of_nodes(BFS) == jst._number_of_nodes(BFS) == 7
    assert tst._number_of_nodes((3, 3, 2)) == 31


def test_subtree_through_the_scengen_program():
    """use_scengen: the subtree draws from aircond's program keyed by the
    subtree's seed; provenance and objective equal to the JAX package's."""
    j, jobj, t, tobj = _subtrees(None, 11, use_scengen=True)
    assert t.seed_provenance == j.seed_provenance is not None
    assert t.seed_provenance["base_seed"] == 11
    assert _close(jobj, tobj), (jobj, tobj)


def test_walking_tree_xhats_match_jax():
    jcfg, tcfg = _cfgs()
    jx, jseed = jst.walking_tree_xhats(jaircond, XHAT_ROOT, BFS, 7, jcfg,
                                       JOPTS)
    tx, tseed = tst.walking_tree_xhats(taircond, XHAT_ROOT, BFS, 7, tcfg,
                                       TOPTS, device="cpu")
    assert tx.shape == jx.shape == (3, 4) and tseed == jseed == 14
    np.testing.assert_allclose(tx[0, :2], XHAT_ROOT, atol=1e-5)
    np.testing.assert_allclose(tx, jx, rtol=0,
                               atol=REL * max(np.abs(jx).max(), 1.0))


def test_zhat4xhat_multistage_matches_jax():
    jcfg, tcfg = _cfgs()
    jz, js = jzhat.evaluate_sample_trees(XHAT_ROOT, 3, jcfg, jaircond,
                                         InitSeed=11, opts=JOPTS)
    tz, ts = tzhat.evaluate_sample_trees(XHAT_ROOT, 3, tcfg, taircond,
                                         InitSeed=11, opts=TOPTS,
                                         device="cpu")
    assert ts == js == 11 + 3 * 7
    assert all(_close(a, b) for a, b in zip(jz, tz)), (jz, tz)
    assert np.std(tz) > 0.0


def test_gap_estimators_mstage_matches_jax():
    jcfg, tcfg = _cfgs(4)
    # the candidate: the root solution of one free sampled tree
    t = tst.SampleSubtree(taircond, None, BFS, 3, tcfg, TOPTS, device="cpu")
    t.run()
    tree = t.ef.ef.tree
    x_non = t.ef.x[:, np.asarray(t.ef.ef.nonant_idx)]
    xhat = x_non.mean(axis=0)[np.nonzero(tree.slot_stage == 1)[0]]
    j = jci.gap_estimators_mstage(xhat, jaircond, 3, jcfg, start_seed=50,
                                  branching_factors=list(BFS), opts=JOPTS)
    t = tci.gap_estimators_mstage(xhat, taircond, 3, tcfg, start_seed=50,
                                  branching_factors=list(BFS), opts=TOPTS,
                                  device="cpu")
    assert t["seed"] == j["seed"] == 50 + 3 * 7
    assert t["G"] >= 0.0 and t["s"] >= 0.0
    scale = 400.0   # the trees' objectives are ~390
    assert _close(j["G"], t["G"], scale) and _close(j["s"], t["s"], scale)


def test_multistage_seq_sampling_matches_jax(monkeypatch):
    """IndepScens_SeqSampling on aircond with its default x̂ generator
    (a free sampled tree scaled to ~mk leaves): the same T, tree count,
    candidate and CI as the JAX package (whose drivers get the test's
    options through gap_estimators_mstage)."""
    import functools
    monkeypatch.setattr(jci, "gap_estimators_mstage", functools.partial(
        jci.gap_estimators_mstage, opts=JOPTS))
    knobs = dict(BM_h=5.0, BM_hprime=0.2, BM_eps=150.0, BM_eps_prime=120.0,
                 confidence_level=0.9)
    jcfg, tcfg = _cfgs(4, **knobs)
    j = jseq.IndepScens_SeqSampling(jaircond, None, jcfg,
                                    stopping_criterion="BM").run(maxit=5)
    seq = tseq.IndepScens_SeqSampling(taircond, None, tcfg,
                                      stopping_criterion="BM",
                                      device="cpu")
    t = seq.run(maxit=5)
    assert (t["T"], t["nk"], t["converged"]) == (j["T"], j["nk"],
                                                 j["converged"])
    assert seq.ScenCount > 0 and seq.numstages == 3
    assert t["CI"][0] == 0.0 and _close(j["CI"][1], t["CI"][1], 400.0)
    assert len(t["Candidate_solution"]) == 2
    np.testing.assert_allclose(t["Candidate_solution"],
                               j["Candidate_solution"], rtol=0,
                               atol=REL * 400.0)
    assert seq._candidate_seed_span(10) == jseq.IndepScens_SeqSampling(
        jaircond, None, jcfg)._candidate_seed_span(10)
    with pytest.raises(RuntimeError, match="branching_factors"):
        tseq.IndepScens_SeqSampling(taircond, None, TConfig(),
                                    device="cpu")
