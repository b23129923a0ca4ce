"""The port's concurrency predictor (`repro_torch/core/predictor.py`) and
the controller that plans with it, against the JAX reference.

Pure logic is held bitwise: the GEMM pool, the feature vectors of GEMM,
attention and scan descriptors, the profiled dataset, and, with one
predictor carried across (the reference's `Predictor.save` JSON), its
probabilities, its CDs and every controller plan made with it.
Training is torch (autograd + the reference's Adam update) started from
the reference's own initial weights (``w0``): W within
1e-4·max(1, |W|) elementwise (a CPU run reads ~3e-6 at |W| ≤ 11.5: both
sum float32 products in their own order), probabilities within 1e-5,
and equal CDs at every availability class."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.core import predictor as jp
from repro.core.op_desc import AttentionDesc as JAttn
from repro.core.op_desc import ScanDesc as JScan
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro_torch.core import (
    CLASSES,
    CDS,
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    Predictor,
    ScanDesc,
    accuracy_by_available,
    gemm_features,
    generate_gemm_pool,
    op_features,
    profile_dataset,
    requests_from_numpy,
    train_predictor,
)
from repro_torch.core import scheduler as psched
from repro_torch.runtime import Runtime, RuntimeConfig

AVAILABLE = (1, 2, 4, 8, 16)


def _pd(d: JDesc) -> GemmDesc:
    return GemmDesc(d.M, d.N, d.K, d.ta, d.tb, d.dtype, d.batch)


def _w0(X, seed=0):
    """The reference's initial weights (`train_predictor`'s draw)."""
    return np.asarray(0.01 * jax.random.normal(
        jax.random.PRNGKey(seed), (X.shape[1] + 1, len(jp.CLASSES)),
        jnp.float32))


def _dataset(n=256, seed=5):
    lib = GOLibrary()
    X, y = profile_dataset(generate_gemm_pool(n, seed=seed), lib)
    return lib, X, y


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """The reference's scheduler-test predictor (pool 128, seed 11, 120
    epochs), saved by the reference and loaded by the port."""
    jlib = JLib()
    X, y = jp.profile_dataset(jp.generate_gemm_pool(128, seed=11), jlib)
    jpred = jp.train_predictor(X, y, epochs=120)
    path = tmp_path_factory.mktemp("pred") / "predictor.json"
    jpred.save(path)
    return jpred, Predictor.load(path), X


# ------------------------------------------------------------ pure logic
def test_classes_defined_once():
    assert CLASSES == jp.CLASSES == (1,) + CDS
    assert psched.CLASSES is CLASSES


@pytest.mark.parametrize("n,seed", [(16, 0), (64, 3), (200, 17), (300, 5)])
def test_gemm_pool_identical(n, seed):
    assert [d.key() for d in generate_gemm_pool(n, seed=seed)] == \
        [d.key() for d in jp.generate_gemm_pool(n, seed=seed)]


def test_gemm_features_bitwise_on_a_pool():
    jlib, plib = JLib(), GOLibrary()
    for d in jp.generate_gemm_pool(200, seed=3):
        x = op_features(_pd(d), plib)
        ref = jp.op_features(d, jlib)
        assert x.dtype == ref.dtype == np.float32
        assert np.array_equal(x, ref), d.key()
        assert np.array_equal(gemm_features(_pd(d), plib), x)


@pytest.mark.parametrize("args,cls,jcls", [
    ((8, 40, 8, 1, 4096, 128), AttentionDesc, JAttn),     # Qwen3-14B decode
    ((16, 40, 8, 1, 4096, 128), AttentionDesc, JAttn),
    ((8, 32, 32, 1, 2048, 64), AttentionDesc, JAttn),     # Zamba2 decode
    ((2, 4, 4, 64, 64, 32), AttentionDesc, JAttn),        # prefill
    ((8, 1, 64, 64, 64), ScanDesc, JScan),                # Zamba2 decode
    ((1, 4096, 64, 64, 64), ScanDesc, JScan),             # prefill
], ids=lambda v: str(v) if isinstance(v, tuple) else "")
def test_op_features_bitwise_on_attention_and_scan(args, cls, jcls):
    x = op_features(cls(*args), GOLibrary())
    ref = jp.op_features(jcls(*args), JLib())
    assert x.shape == (3 + 3 * len(CDS),)
    assert np.array_equal(x, ref)


def test_profile_dataset_bitwise():
    _, X, y = _dataset(128, seed=5)
    jX, jy = jp.profile_dataset(jp.generate_gemm_pool(128, seed=5), JLib())
    assert X.dtype == jX.dtype and np.array_equal(X, jX)
    assert y.dtype == jy.dtype and np.array_equal(y, jy)


# -------------------------------------------------------------- training
def test_training_from_reference_w0_matches_reference():
    _, X, y = _dataset()
    jpred = jp.train_predictor(X, y)
    pred = train_predictor(X, y, w0=_w0(X), device="cpu")
    assert pred.W.dtype == np.float32 and pred.W.shape == jpred.W.shape
    assert np.array_equal(pred.f_min, jpred.f_min)
    assert np.array_equal(pred.f_max, jpred.f_max)
    tol = 1e-4 * np.maximum(1.0, np.abs(jpred.W))
    assert (np.abs(pred.W - jpred.W) <= tol).all(), np.abs(pred.W - jpred.W).max()
    np.testing.assert_allclose(pred.probabilities(X), jpred.probabilities(X),
                               rtol=0, atol=1e-5)
    for avail in AVAILABLE:
        assert np.array_equal(pred.predict_cd(X, available=avail),
                              jpred.predict_cd(X, available=avail)), avail


def test_training_seeded_draw_is_deterministic_and_w0_checked():
    _, X, y = _dataset(64, seed=2)
    a = train_predictor(X, y, epochs=20, seed=3, device="cpu")
    b = train_predictor(X, y, epochs=20, seed=3, device="cpu")
    assert np.array_equal(a.W, b.W)
    assert not np.array_equal(a.W, train_predictor(X, y, epochs=20, seed=4,
                                                   device="cpu").W)
    with pytest.raises(ValueError, match="w0 has shape"):
        train_predictor(X, y, epochs=1, w0=np.zeros((3, 3)), device="cpu")


def test_training_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, X, y = _dataset(16, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_predictor(X, y, epochs=1)


# ------------------------------------------------- carried-across weights
def test_reference_json_loads_bitwise(carried):
    jpred, pred, X = carried
    assert np.array_equal(pred.W, jpred.W)
    assert np.array_equal(pred.probabilities(X), jpred.probabilities(X))
    for avail in AVAILABLE:
        assert np.array_equal(pred.predict_cd(X, available=avail),
                              jpred.predict_cd(X, available=avail))
    again = Predictor.from_numpy(jpred.W, jpred.f_min, jpred.f_max)
    assert np.array_equal(again.probabilities(X), jpred.probabilities(X))


def test_memoized_prediction_matches_batch_prediction(carried):
    _, pred, X = carried
    calls = []

    def feats():
        calls.append(1)
        return X[3]

    for avail in (8, 9, 16, 16):
        cd = pred.predict_cd_one("k", feats, available=avail)
        assert cd == int(pred.predict_cd(X[3:4], available=avail)[0])
    assert len(calls) == 2          # 8 and 9 share the class 8
    pred.invalidate_cache()
    pred.predict_cd_one("k", feats, available=16)
    assert len(calls) == 3


# ------------------------------------- the reference's predictor tests
def test_features_shape_and_finite():
    x = gemm_features(GemmDesc(4096, 512, 1024), GOLibrary())
    assert x.shape == (3 + 3 * len(CDS),) and np.isfinite(x).all()
    assert len(CLASSES) == 1 + len(CDS)


def test_training_beats_majority_class():
    _, X, y = _dataset()
    idx = np.random.default_rng(0).permutation(len(X))
    ntr = int(0.9 * len(X))
    pred = train_predictor(X[idx[:ntr]], y[idx[:ntr]], device="cpu")
    acc = accuracy_by_available(pred, X[idx[ntr:]], y[idx[ntr:]])
    majority = max(np.bincount(np.minimum(np.asarray(CLASSES)[y], 16))) / len(y)
    assert acc[16] > majority - 0.05
    assert acc[2] >= acc[16] - 0.05


def test_min_available_rule():
    """Paper Fig. 8: executed CD = min(predicted, available)."""
    _, X, y = _dataset(n=128, seed=9)
    pred = train_predictor(X, y, epochs=100, device="cpu")
    for avail in AVAILABLE:
        cds = pred.predict_cd(X, available=avail)
        assert (cds <= avail).all()
        assert set(np.unique(cds)).issubset(set(CLASSES))


def test_save_load_roundtrip(tmp_path):
    _, X, y = _dataset(n=64, seed=2)
    pred = train_predictor(X, y, epochs=50, device="cpu")
    p = tmp_path / "predictor.json"
    pred.save(p)
    pred2 = Predictor.load(p)
    assert np.array_equal(pred.probabilities(X), pred2.probabilities(X))
    # the reference reads the port's file too
    jpred = jp.Predictor.load(p)
    assert np.array_equal(jpred.probabilities(X), pred.probabilities(X))


# ------------------------------------------------------ controller plans
S512, M512, SM = JDesc(512, 512, 512), JDesc(1024, 512, 512), JDesc(128, 128, 2048)
QUEUES = {
    "mixed_m": [S512] * 7 + [M512] * 3,
    "three": [JDesc(256, 256, 256)] * 3,
    "compute_bound": [JDesc(8192, 8192, 8192)] * 4,
    "large_k_16": [JDesc(4096, 4096, 20480)] * 16,
    "incremental": [S512] * 5 + [M512] * 2 + [SM] * 3,
    "eight": [JDesc(256, 256, 256)] * 8,
    "disagree": [JDesc(128, 512, 4096)] * 4 + [JDesc(8192, 512, 4096)] * 2,
    "agree": [JDesc(m, 512, 512) for m in (64, 128, 256, 512)],
    "f32_ragged": [JDesc(128, 256, 128, dtype="f32"),
                   JDesc(384, 256, 128, dtype="f32"),
                   JDesc(256, 256, 128, dtype="f32")],
    "f32_homog": [JDesc(160, 192, 128, dtype="f32")] * 4,
    "decode": [JDesc(8, 7168, 5120)] * 16 + [JDesc(4, 7168, 5120)] * 4,
}


def _plan(s):
    return ([(g.indices, g.cd, g.mode, g.tile.key(), g.modeled_time_s)
             for g in s.groups], s.cp_overhead_s)


def _ctrls(carried, with_pred):
    jpred, pred, _ = carried
    return (JCtrl(JLib(), predictor=jpred if with_pred else None),
            ConcurrencyController(GOLibrary(), predictor=pred if with_pred else None))


@pytest.mark.parametrize("available", [None, 2, 4])
@pytest.mark.parametrize("with_pred", [False, True], ids=["oracle", "predictor"])
@pytest.mark.parametrize("queue", sorted(QUEUES))
def test_plans_match_reference(carried, queue, with_pred, available):
    jc, pc = _ctrls(carried, with_pred)
    descs = QUEUES[queue]
    pdescs = [_pd(d) for d in descs]
    assert _plan(pc.plan(pdescs, available=available)) == \
        _plan(jc.plan(descs, available=available))
    pending, jpending = list(range(len(descs))), list(range(len(descs)))
    while pending:
        gp, pending = pc.plan_group(pdescs, pending, available=available)
        jgp, jpending = jc.plan_group(descs, jpending, available=available)
        assert _plan(psched.Schedule([gp])) == _plan(psched.Schedule([jgp]))
        assert pending == jpending


def test_predictor_limits_concurrency_of_large_k_gemms(carried):
    _, pc = _ctrls(carried, True)
    sched = pc.plan([GemmDesc(4096, 4096, 20480)] * 16)
    assert max(g.cd for g in sched.groups) <= 8


def test_shared_input_policy_matches_reference(carried):
    jc, pc = _ctrls(carried, True)
    for descs in ([JDesc(8, 2560, 2560)] * 3, [JDesc(4096, 1024, 1024)] * 3,
                  [JDesc(512, 512, 4096)] * 2):
        assert pc.plan_shared_input([_pd(d) for d in descs]) == \
            jc.plan_shared_input(descs)


def test_oracle_plans_unchanged_by_the_predictor_option():
    descs = [_pd(d) for q in QUEUES.values() for d in q]
    lib = GOLibrary()
    assert _plan(ConcurrencyController(lib).plan(descs)) == \
        _plan(ConcurrencyController(lib, predictor=None).plan(descs))


def test_controller_memoizes_features_and_invalidates(carried):
    _, pc = _ctrls(carried, True)
    pc.predictor.invalidate_cache()     # the module's tests share it
    d = GemmDesc(256, 256, 256)
    cd = pc.preferred_cd(d, available=8)
    assert d.key() in pc._feat_cache and pc._cd_cache[(d.key(), 8)] == cd
    assert pc.predictor._cd_cache
    pc.invalidate_caches()
    assert not pc._feat_cache and not pc._cd_cache
    assert not pc.predictor._cd_cache
    assert pc.preferred_cd(d, available=8) == cd


# ------------------------------------------------------------- execution
QUEUE_RUN = ([JDesc(16, 128, 128, dtype="f32")] * 5
             + [JDesc(32, 256, 128, dtype="f32"),
                JDesc(64, 256, 128, dtype="f32")] * 2)


def _int_operands(rng, d):
    return [rng.integers(-3, 4, size=s).astype(np.float32)
            for s in ((d.M, d.K), (d.K, d.N))]


def test_runtime_with_predictor_matches_reference_runtime(carried):
    """A small per-class queue through both runtimes, each planning with
    the carried predictor: the same launches, and the same outputs within
    the reference tests' GEMM tolerance (exact here: integer operands)."""
    jpred, pred, _ = carried
    jrt = JRuntime(JCtrl(JLib(), predictor=jpred),
                   JConfig(window_s=0.0, execute=True, interpret=True))
    prt = Runtime(ConcurrencyController(GOLibrary(), predictor=pred),
                  RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    rng = np.random.default_rng(0)
    ops = [_int_operands(rng, d) for d in QUEUE_RUN]
    jt = [jrt.submit(JReq(desc=d, a=jnp.asarray(a), b=jnp.asarray(b)), now=0.0)
          for d, (a, b) in zip(QUEUE_RUN, ops)]
    preqs = requests_from_numpy([GemmRequest(desc=_pd(d)) for d in QUEUE_RUN],
                                ops, device="cpu")
    pt = [prt.submit(r, now=0.0) for r in preqs]
    jl, pl = jrt.drain(now=0.0), prt.drain(now=0.0)

    def launch(ln):
        return (ln.class_key, ln.plan.mode, ln.plan.cd, ln.plan.tile.key(),
                [t.seq for t in ln.tickets], ln.plan.modeled_time_s)

    assert [launch(x) for x in pl] == [launch(x) for x in jl]
    assert {"grouped", "ragged"} & {x.plan.mode for x in pl}
    for j, p in zip(jt, pt):
        np.testing.assert_allclose(p.result.numpy(), np.asarray(j.result),
                                   rtol=3e-4, atol=3e-4)


def test_controller_execute_matches_execute_plan(carried):
    _, pc = _ctrls(carried, True)
    rng = np.random.default_rng(1)
    ops = [_int_operands(rng, d) for d in QUEUE_RUN]
    reqs = requests_from_numpy([GemmRequest(desc=_pd(d)) for d in QUEUE_RUN],
                               ops, device="cpu")
    outs = pc.execute(reqs)
    again = pc.execute_plan(reqs, pc.plan([r.desc for r in reqs]))
    for (a, b), o, o2 in zip(ops, outs, again):
        assert torch.equal(o, o2)
        assert np.array_equal(o.numpy(), a @ b)
