"""The slice as a whole: decode-step traffic from several tenants through
the JAX `Runtime` (executing the Pallas bodies, ``interpret=True``) and
the port's `Runtime` on ``device="cpu"``, fed the same numpy operands.

Both must produce the same launch sequence (class, mode, CD, tile,
members, modeled timeline), the same telemetry, and results that are
bitwise equal on integer-valued float32 operands (every f32 sum exact)
and within the reference tests' 3e-2 on bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.core.scheduler import execute_schedule as jexecute
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime import decode_step_requests as jdecode
from repro.runtime import prewarm_decode as jprewarm
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
    Runtime,
    RuntimeConfig,
    decode_step_requests,
    prewarm_decode,
)

WINDOWS = ([8, 8, 8, 8], [4, 8, 8, 8, 16], [8, 8, 8, 8])


def _operands(rng, desc, dtype):
    shapes = ((desc.M, desc.K), (desc.K, desc.N))
    if dtype == "f32":
        return [rng.integers(-3, 4, size=s).astype(np.float32) for s in shapes]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _serve_both(dtype: str, seed: int = 0):
    jcfg = jget_arch("qwen3-14b").reduced()
    pcfg = get_arch("qwen3-14b").reduced()
    jctrl, pctrl = JCtrl(JLib()), ConcurrencyController(GOLibrary())
    jrt = JRuntime(jctrl, JConfig(window_s=0.0, execute=True, interpret=True))
    prt = Runtime(pctrl, RuntimeConfig(window_s=0.0, execute=True),
                  device="cpu")
    rng = np.random.default_rng(seed)
    jtickets, ptickets, jlaunches, plaunches = [], [], [], []
    for w, batches in enumerate(WINDOWS):
        now = float(w)
        for layer in range(pcfg.n_layers):
            for ti, batch in enumerate(batches):
                jreqs = jdecode(jctrl, jcfg, batch, dtype)
                preqs = decode_step_requests(pctrl, pcfg, batch, dtype)
                assert [r.desc.key() for r in preqs] == \
                    [r.desc.key() for r in jreqs]
                ops = [_operands(rng, r.desc, dtype) for r in preqs]
                for jr, (a, b) in zip(jreqs, ops):
                    jd = jr.desc.jnp_dtype()
                    jtickets.append(jrt.submit(
                        JReq(desc=jr.desc, a=jnp.asarray(a).astype(jd),
                             b=jnp.asarray(b).astype(jd), tag=jr.tag),
                        tenant=f"t{ti}", now=now))
                for pr in requests_from_numpy(preqs, ops, device="cpu"):
                    ptickets.append(prt.submit(pr, tenant=f"t{ti}", now=now))
        jlaunches += jrt.drain(now=now)
        plaunches += prt.drain(now=now)
    return jrt, prt, jtickets, ptickets, jlaunches, plaunches


def _launch(ln):
    return (ln.class_key, ln.plan.mode, ln.plan.cd, ln.plan.tile.key(),
            [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
            ln.end_t, ln.cache_hit)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def served(request):
    return request.param, _serve_both(request.param)


def test_launch_sequence_identical(served):
    _, (jrt, prt, _, _, jl, pl) = served
    assert [_launch(x) for x in pl] == [_launch(x) for x in jl]
    modes = prt.telemetry.mode_counts()
    assert {"grouped", "ragged"} <= set(modes), modes
    assert prt.device_free_t == jrt.device_free_t


def test_telemetry_summary_identical(served):
    _, (jrt, prt, *_rest) = served
    js, ps = jrt.telemetry.summary(), prt.telemetry.summary()
    # achieved times are each package's own wall or device clock
    ps.pop("class_ratios")
    js.pop("class_ratios")
    assert ps == js
    assert [(g.class_key, g.tenants, g.cd, g.mode, g.cache_hit)
            for g in prt.telemetry.groups] == \
        [(g.class_key, g.tenants, g.cd, g.mode, g.cache_hit)
         for g in jrt.telemetry.groups]
    # the third window repeats the first: every class plan is a cache hit
    # and the flush touches the cost model zero times
    assert prt.telemetry.cache_hits > 0
    assert prt.telemetry.last_flush_evals == 0


def test_results_match(served):
    dtype, (_, _, jt, pt, _, _) = served
    assert len(pt) == len(jt)
    for j, p in zip(jt, pt):
        assert p.result is not None and p.result.dtype == p.request.a.dtype
        want = np.asarray(j.result.astype(jnp.float32))
        got = p.result.float().numpy()
        if dtype == "f32":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
        assert (p.done_t, p.latency_s) == (j.done_t, j.latency_s)


@pytest.mark.parametrize("ms", [[8, 8, 8, 16, 4, 16], [8, 8, 8, 8]],
                         ids=["ragged", "grouped"])
@pytest.mark.parametrize("ta,tb", [(False, True), (True, False), (True, True)])
def test_execute_schedule_transposed_layouts_match(ta, tb, ms):
    """Grouped and ragged launches of transposed-storage GEMMs: the same
    plan and bitwise-equal results in both packages."""
    rng = np.random.default_rng([int(ta), int(tb), len(ms)])
    jdescs = [JDesc(m, 96, 80, ta, tb, "f32") for m in ms]
    pdescs = [GemmDesc(m, 96, 80, ta, tb, "f32") for m in ms]
    ops = [(rng.integers(-3, 4, size=(80, m) if ta else (m, 80)).astype(np.float32),
            rng.integers(-3, 4, size=(96, 80) if tb else (80, 96)).astype(np.float32))
           for m in ms]
    jsched = JCtrl(JLib()).plan(jdescs)
    psched = ConcurrencyController(GOLibrary()).plan(pdescs)
    assert [(g.mode, g.indices, g.tile.key()) for g in psched.groups] == \
        [(g.mode, g.indices, g.tile.key()) for g in jsched.groups]
    assert {g.mode for g in psched.groups} == {"ragged" if len(set(ms)) > 1
                                               else "grouped"}
    jreqs = [JReq(desc=d, a=jnp.asarray(a), b=jnp.asarray(b))
             for d, (a, b) in zip(jdescs, ops)]
    preqs = requests_from_numpy([GemmRequest(desc=d) for d in pdescs], ops,
                                device="cpu")
    jout = jexecute(jreqs, jsched, interpret=True)
    pout = execute_schedule(preqs, psched)
    for j, p in zip(jout, pout):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def test_prewarm_decode_identical():
    jrt = JRuntime(JCtrl(JLib()), JConfig(window_s=0.0))
    prt = Runtime(ConcurrencyController(GOLibrary()), RuntimeConfig(window_s=0.0),
                  device="cpu")
    batches = (1, 4, 8, 16)
    assert prewarm_decode(prt, get_arch("qwen3-14b"), batches) == \
        jprewarm(jrt, jget_arch("qwen3-14b"), batches)
    assert prt.plan_cache_size == jrt.plan_cache_size
    assert prt.telemetry.prewarmed_plans == jrt.telemetry.prewarmed_plans
    assert prt.telemetry.cp_overhead_paid_s == jrt.telemetry.cp_overhead_paid_s


def test_non_finite_output_walks_the_ladder_to_the_reference_rung():
    """NaN operands make every vetoed attempt fail — planned, retry,
    legacy — and the launch returns from the reference rung, which no
    finiteness check vetoes, as in the reference (held against it)."""
    ctrl = ConcurrencyController(GOLibrary())
    rt = Runtime(ctrl, RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    jrt = JRuntime(JCtrl(JLib()), JConfig(window_s=0.0, execute=True,
                                          interpret=False))
    req = decode_step_requests(ctrl, get_arch("qwen3-14b").reduced(), 4, "f32")[0]
    d = req.desc
    a = np.full((d.M, d.K), np.nan, np.float32)
    b = np.ones((d.K, d.N), np.float32)
    tk = rt.submit(requests_from_numpy([req], [(a, b)], device="cpu")[0], now=0.0)
    jtk = jrt.submit(JReq(desc=JDesc(d.M, d.N, d.K, dtype="f32"),
                          a=jnp.asarray(a), b=jnp.asarray(b)), now=0.0)
    (ln,), (jln,) = rt.drain(now=0.0), jrt.drain(now=0.0)
    for tele in (rt.telemetry, jrt.telemetry):
        assert dict(tele.faults) == {"nan": 3}
        assert dict(tele.fallbacks) == {"reference": 1}
    assert (ln.fallback, ln.penalty_s, ln.end_t) == \
        (jln.fallback, jln.penalty_s, jln.end_t) == \
        ("reference", 3 * ln.plan.modeled_time_s, ln.end_t)
    np.testing.assert_array_equal(tk.result.numpy(), np.asarray(jtk.result))
    assert np.isnan(tk.result.numpy()).all()


def test_executing_runtime_refuses_requests_it_cannot_run():
    """An executing runtime never leaves a ticket unexecuted: a request
    without operands, or a batched GEMM (no kernel yet), raises at submit."""
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    with pytest.raises(ValueError, match="operands"):
        rt.submit(GemmRequest(desc=GemmDesc(8, 64, 32)))
    x = torch.ones((8, 8))
    with pytest.raises(NotImplementedError, match="batched"):
        rt.submit(GemmRequest(desc=GemmDesc(8, 8, 8, dtype="f32", batch=2),
                              a=x, b=x))
    assert rt.pending() == 0


def test_operands_must_lie_on_the_runtime_device():
    rt = Runtime(ConcurrencyController(GOLibrary()), device="cpu")
    x = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="meta"):
        rt.submit(GemmRequest(desc=decode_step_requests(
            rt.ctrl, get_arch("qwen3-14b").reduced(), 8)[0].desc, a=x, b=x))
