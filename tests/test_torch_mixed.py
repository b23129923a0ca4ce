"""Heterogeneous bundles (§14) in the port vs the JAX package:
`ConcurrencyController.plan_mixed`, the ``mixed`` branch of
`execute_schedule`, and `Runtime.submit(sequence)` through flush.

Plans must be identical, modeled times bitwise.  Results come from the
JAX package's Pallas bodies (``interpret=True``) and the port's plain
versions on the CPU, fed the same numpy operands: bitwise on
integer-valued float32 operands (every f32 sum exact), within the
reference tests' 3e-2 on bf16."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.core.scheduler import execute_schedule as jexecute
from repro.runtime import MIXED_CLASS as JMIXED
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime import decode_step_descs as jdecode_descs
from repro_torch.configs import get_arch
from repro_torch.core import (
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    execute_schedule,
    requests_from_numpy,
)
from repro_torch.runtime import (
    MIXED_CLASS,
    Runtime,
    RuntimeConfig,
    decode_step_descs,
)

# Small-N, long-K GEMMs whose GO tiles split K or walk Stream-K spans.
LONG_K = [(1, 128, 8192), (8, 128, 8192), (4, 256, 8192), (16, 128, 8192)]


def _flat(cfg, batch, dtype="bf16", decode=decode_step_descs):
    """One layer's unfused decode GEMMs (q, k, v, o, gate, up, down)."""
    return [d for _, bundle in decode(cfg, batch, dtype) for d in bundle]


def _jd(d: GemmDesc) -> JDesc:
    return JDesc(d.M, d.N, d.K, d.ta, d.tb, d.dtype, d.batch)


def _sched(s):
    return ([(g.indices, g.cd, g.mode, g.tile.key(),
              None if g.tiles is None else [t.key() for t in g.tiles],
              g.modeled_time_s) for g in s.groups], s.cp_overhead_s)


def _operands(rng, d, dtype):
    shapes = ((d.K, d.M) if d.ta else (d.M, d.K),
              (d.N, d.K) if d.tb else (d.K, d.N))
    if dtype == "f32":
        return [rng.integers(-3, 4, size=s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _assert_match(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


# ------------------------------------------------------------------- plans
def test_qwen3_decode_descs_flatten_to_seven_gemms():
    cfg = get_arch("qwen3-14b")
    descs = _flat(cfg, 1)
    assert [(d.N, d.K) for d in descs] == [
        (5120, 5120), (1024, 5120), (1024, 5120), (5120, 5120),
        (17408, 5120), (17408, 5120), (5120, 17408)]
    assert [d.key() for d in descs] == \
        [d.key() for d in _flat(jget_arch("qwen3-14b"), 1, decode=jdecode_descs)]


@pytest.mark.parametrize("available", [None, 8, 4, 2])
@pytest.mark.parametrize("batch", [1, 4, 8, 16])
def test_plan_mixed_identical_on_qwen3_decode_bundles(batch, available):
    descs = _flat(get_arch("qwen3-14b"), batch)
    p = ConcurrencyController(GOLibrary()).plan_mixed(descs, available=available)
    j = JCtrl(JLib()).plan_mixed([_jd(d) for d in descs], available=available)
    assert _sched(p) == _sched(j)
    assert {g.mode for g in p.groups} <= {"mixed", "single"}


def _four_tenants():
    cfg = get_arch("qwen3-14b")
    return sorted([d for b in (4, 8, 8, 16) for d in _flat(cfg, b)],
                  key=lambda d: (-d.M, d.key()))


@pytest.mark.parametrize("available,n_groups,n_split", [(4, 7, 1), (2, 14, 3)])
def test_plan_mixed_identical_on_four_tenant_bundle(available, n_groups, n_split):
    """Tenants at batches [4, 8, 8, 16], one layer each: seven CD-4 or
    fourteen CD-2 mixed launches, with split-K ffn-down members."""
    descs = _four_tenants()
    p = ConcurrencyController(GOLibrary()).plan_mixed(descs, available=available)
    j = JCtrl(JLib()).plan_mixed([_jd(d) for d in descs], available=available)
    assert _sched(p) == _sched(j)
    assert [(g.mode, g.cd) for g in p.groups] == [("mixed", available)] * n_groups
    split = [t for g in p.groups for t in g.tiles if t.split_k > 1]
    assert len(split) == n_split


def test_plan_mixed_identical_with_ranks():
    """Rank-ordered chunking: urgent members land in the earliest chunks,
    same-rank members keep their order."""
    descs = _four_tenants()
    ranks = [0 if d.M == 4 else 1 if d.M == 16 else 2 for d in descs]
    p = ConcurrencyController(GOLibrary()).plan_mixed(descs, available=4,
                                                      ranks=ranks)
    j = JCtrl(JLib()).plan_mixed([_jd(d) for d in descs], available=4,
                                 ranks=ranks)
    assert _sched(p) == _sched(j)
    assert {descs[i].M for i in p.groups[0].indices} == {4}


def test_plan_mixed_empty_and_single():
    ctrl = ConcurrencyController(GOLibrary())
    assert ctrl.plan_mixed([]).groups == []
    (g,) = ctrl.plan_mixed([GemmDesc(8, 128, 4096)]).groups
    assert g.mode == "single" and g.tiles is None


# ------------------------------------------------------------------ execute
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_execute_mixed_group_matches_reference(dtype):
    """A mixed group whose members run split-K, Stream-K and un-split
    tiles: the same per-member tiles in both packages, the same results."""
    descs = [GemmDesc(M, N, K, dtype=dtype) for M, N, K in LONG_K] + \
        [GemmDesc(8, 96, 80, True, True, dtype)]
    psched = ConcurrencyController(GOLibrary()).plan_mixed(descs)
    jsched = JCtrl(JLib()).plan_mixed([_jd(d) for d in descs])
    assert _sched(psched) == _sched(jsched)
    tiles = [t for g in psched.groups for t in g.tiles]
    assert any(t.split_k > 1 for t in tiles) and any(t.stream_k for t in tiles)
    rng = np.random.default_rng(5)
    ops = [_operands(rng, d, dtype) for d in descs]
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jreqs = [JReq(desc=_jd(d), a=jnp.asarray(a).astype(jd),
                  b=jnp.asarray(b).astype(jd)) for d, (a, b) in zip(descs, ops)]
    preqs = requests_from_numpy([GemmRequest(desc=d) for d in descs], ops,
                                device="cpu")
    for p, j in zip(execute_schedule(preqs, psched),
                    jexecute(jreqs, jsched, interpret=True)):
        _assert_match(p, j, dtype)


# ------------------------------------------------------------------ runtime
# (tenant batches, available) per window; the last repeats the first.
WINDOWS = (([1], 16), ([4, 8, 8, 16], 4), ([4, 8, 8, 16], 2), ([1], 16))


def _serve_both(dtype: str, seed: int = 0):
    """Per window and layer, every tenant submits its layer's seven decode
    GEMMs as one bundle, and both runtimes drain; a last window submits a
    bundle of long-K GEMMs whose tiles split K or walk Stream-K spans."""
    jcfg = jget_arch("qwen3-14b").reduced()
    pcfg = get_arch("qwen3-14b").reduced()
    jrt = JRuntime(JCtrl(JLib()),
                   JConfig(window_s=0.0, execute=True, interpret=True))
    prt = Runtime(ConcurrencyController(GOLibrary()),
                  RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    rng = np.random.default_rng(seed)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    out = dict(jh=[], ph=[], jl=[], pl=[])

    def submit(descs, tenant, now):
        ops = [_operands(rng, d, dtype) for d in descs]
        out["jh"].append(jrt.submit(
            [JReq(desc=_jd(d), a=jnp.asarray(a).astype(jd),
                  b=jnp.asarray(b).astype(jd)) for d, (a, b) in zip(descs, ops)],
            tenant=tenant, now=now))
        out["ph"].append(prt.submit(
            requests_from_numpy([GemmRequest(desc=d) for d in descs], ops,
                                device="cpu"), tenant=tenant, now=now))

    for w, (batches, available) in enumerate(WINDOWS):
        jrt.set_available(available)
        prt.set_available(available)
        for layer in range(pcfg.n_layers):
            now = float(w) + layer * 0.01
            for ti, batch in enumerate(batches):
                descs = _flat(pcfg, batch, dtype)
                assert [d.key() for d in descs] == [
                    d.key() for d in _flat(jcfg, batch, dtype, jdecode_descs)]
                submit(descs, f"t{ti}", now)
            out["jl"] += jrt.drain(now=now)
            out["pl"] += prt.drain(now=now)
    jrt.set_available(16)
    prt.set_available(16)
    submit([GemmDesc(M, N, K, dtype=dtype) for M, N, K in LONG_K], "t0", 9.0)
    out["jl"] += jrt.drain(now=9.0)
    out["pl"] += prt.drain(now=9.0)
    return jrt, prt, out


def _launch(ln):
    return (ln.class_key, ln.plan.mode, ln.plan.cd,
            [t.key() for t in (ln.plan.tiles or [ln.plan.tile])],
            [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
            ln.end_t, ln.cache_hit)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def served(request):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return request.param, _serve_both(request.param)


def test_bundle_launch_sequence_identical(served):
    _, (jrt, prt, o) = served
    assert MIXED_CLASS == JMIXED
    assert [_launch(x) for x in o["pl"]] == [_launch(x) for x in o["jl"]]
    assert {x.class_key for x in o["pl"]} == {MIXED_CLASS}
    tiles = [t for x in o["pl"] for t in (x.plan.tiles or [x.plan.tile])]
    assert any(t.split_k > 1 for t in tiles) and any(t.stream_k for t in tiles)
    assert [(x.plan.mode, x.plan.cd) for x in o["pl"][:1]] == [("mixed", 7)]
    assert prt.device_free_t == jrt.device_free_t


def test_bundle_telemetry_summary_identical(served):
    _, (jrt, prt, _) = served
    js, ps = jrt.telemetry.summary(), prt.telemetry.summary()
    ps.pop("class_ratios")
    js.pop("class_ratios")
    assert ps == js
    assert ps["modes"]["mixed"] > 0
    # the last Qwen window repeats the first: a cache hit, no model call
    assert prt.telemetry.cache_hits > 0


def test_bundle_results_and_handles_match(served):
    dtype, (_, _, o) = served
    assert len(o["ph"]) == len(o["jh"])
    for ph, jh in zip(o["ph"], o["jh"]):
        assert ph.kind == jh.kind == "bundle"
        assert ph.done and (ph.seq, ph.done_t) == (jh.seq, jh.done_t)
        assert len(ph.members) == len(jh.members)
        for i, (p, j) in enumerate(zip(ph.members, jh.members)):
            assert ph[i] is p and p.agg is ph
            assert (p.seq, p.done_t, p.latency_s) == (j.seq, j.done_t, j.latency_s)
            assert p.result.dtype == p.request.a.dtype
            _assert_match(p.result, j.result, dtype)


def test_prewarm_bundle_seeds_the_mixed_plan():
    """`prewarm_bundle` tunes the bundle and seeds its mixed-queue plan as
    the reference does; the first flush of that bundle is then a hit that
    evaluates the cost model zero times."""
    descs = _flat(get_arch("qwen3-14b"), 8)
    prt = Runtime(ConcurrencyController(GOLibrary()), RuntimeConfig(window_s=0.0),
                  device="cpu")
    jrt = JRuntime(JCtrl(JLib()), JConfig(window_s=0.0))
    with pytest.warns(DeprecationWarning):
        jfresh = jrt.prewarm_bundle([_jd(d) for d in descs])
    assert prt.prewarm_bundle(descs) == jfresh == 4   # q=o, k=v, gate=up
    for attr in ("prewarmed_plans", "sig_resorts", "cp_overhead_paid_s"):
        assert getattr(prt.telemetry, attr) == getattr(jrt.telemetry, attr)
    assert prt.plan_cache_size == jrt.plan_cache_size == 1
    handle = prt.submit([GemmRequest(desc=d) for d in descs], now=0.0)
    (launch,) = prt.flush(now=0.0, force=True)
    assert launch.cache_hit and launch.plan.mode == "mixed"
    assert prt.telemetry.last_flush_evals == 0
    assert handle.done and handle.done_t == launch.end_t


def test_bundle_admission_checks_every_member_first():
    """An executing runtime refuses a bundle with an operand-free member
    before admitting any of it."""
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    d = GemmDesc(4, 64, 32, dtype="f32")
    (ok,) = requests_from_numpy([GemmRequest(desc=d)],
                                [(np.ones((4, 32), np.float32),
                                  np.ones((32, 64), np.float32))], device="cpu")
    with pytest.raises(ValueError, match="operands"):
        rt.submit([ok, GemmRequest(desc=d)])
    assert rt.pending() == 0 and rt.telemetry.submitted == 0
