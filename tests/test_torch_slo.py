"""Tenant SLOs, admission slicing, the EDF flush and budgeted flushes in
the port's `Runtime` vs the JAX package's (`tests/test_runtime.py`'s SLO
tests, each run on both runtimes with the same descriptors).

Both runtimes must make the same launches (class, mode, CD, tiles,
members, modeled times), put them at the same places on the modeled
timeline, give every ticket the same deadline, rank, pieces and
completion time, and keep the same telemetry — bitwise, in shadow mode
over random traces too.  Executed, on the CPU against the reference's
Pallas bodies in interpret mode: integer-valued float32 operands, so
GEMM results are bitwise equal; attention within the reference tests'
3e-4.  The admission estimate cache follows the library, held here
through `process_retunes` and a quarantine (and through `set_mesh` in
`tests/test_torch_dist.py`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.core.cost_model import EVAL_COUNTER as JEVALS
from repro.core.op_desc import op_from_key as jop_from_key
from repro.runtime import DEFAULT_SLO as JDEFAULT_SLO
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime import TenantSLO as JSLO
from repro.runtime.integration import decode_step_op_descs as jop_descs
from repro_torch.configs import get_arch
from repro_torch.core import (
    EVAL_COUNTER,
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    ScanDesc,
    compat_key,
    requests_from_numpy,
)
from repro_torch.kernels.gemm import gemm_ref
from repro_torch.runtime import (
    DEFAULT_SLO,
    Runtime,
    RuntimeConfig,
    TenantSLO,
    decode_step_op_descs,
)
from tests.hypothesis_compat import given, settings, st

SMALL = GemmDesc(256, 512, 512)
SMALL2 = GemmDesc(1024, 512, 512)      # same compatibility class as SMALL
OTHER = GemmDesc(128, 128, 2048)       # another class
BIG = GemmDesc(8192, 512, 512)         # SMALL's class, huge M
PREFILL_ATTN = AttentionDesc(1, 8, 2, 512, 512, 64)
EVERYTHING = dict(window_s=0.0, slicing=True, flush_budget_s=10.0,
                  slice_budget_frac=1e-9)   # every sliceable op slices


def _j(d):
    return jop_from_key(d.key())


class Pair:
    """The reference's runtime and the port's (on the CPU), same config,
    each with a fresh library."""

    def __init__(self, execute: bool = False, **cfg):
        self.j = JRuntime(JCtrl(JLib()), JConfig(
            execute=execute, interpret=True if execute else None, **cfg))
        self.p = Runtime(ConcurrencyController(GOLibrary()),
                         RuntimeConfig(execute=execute, **cfg), device="cpu")

    @property
    def both(self):
        return (self.j, self.p)

    def slo(self, tenant: str, *args, **kw) -> None:
        self.j.set_tenant_slo(tenant, JSLO(*args, **kw))
        self.p.set_tenant_slo(tenant, TenantSLO(*args, **kw))

    def submit(self, work, tenant="default", now=0.0, operands=None):
        """``work`` (a desc or a list of them) into both; ``operands``: the
        numpy operand tuple of each desc (executed runtimes)."""
        many = isinstance(work, list)
        descs = work if many else [work]
        ops = operands if many else (None if operands is None else [operands])
        jreqs, preqs = [], []
        for i, d in enumerate(descs):
            if ops is None:
                jreqs.append(_j(d))
                preqs.append(GemmRequest(desc=d))
                continue
            args = tuple(jnp.asarray(x) for x in ops[i])
            jreqs.append(JReq(desc=_j(d), a=args[0], b=args[1]) if d.family == "gemm"
                         else JReq(desc=_j(d), inputs=args))
            preqs.append(requests_from_numpy([GemmRequest(desc=d)], [ops[i]],
                                             device="cpu")[0])
        return (self.j.submit(jreqs if many else jreqs[0], tenant=tenant, now=now),
                self.p.submit(preqs if many else preqs[0], tenant=tenant, now=now))

    def flush(self, now, force=False):
        jl, pl = (rt.flush(now=now, force=force) for rt in self.both)
        assert _launches(pl) == _launches(jl)
        return jl, pl

    def drain(self, now):
        jl, pl = (rt.drain(now=now) for rt in self.both)
        assert _launches(pl) == _launches(jl)
        return jl, pl

    def check(self, jtickets=(), ptickets=()):
        """The same tickets, timeline, queues and telemetry in both."""
        assert [_ticket(t) for t in ptickets] == [_ticket(t) for t in jtickets]
        assert self.p.device_free_t == self.j.device_free_t
        assert self.p.queue_depths() == self.j.queue_depths()
        assert self.p.plan_cache_size == self.j.plan_cache_size
        js, ps = self.j.telemetry.summary(), self.p.telemetry.summary()
        for s in (js, ps):
            s.pop("class_ratios")       # each package's own clock
        assert ps == js


def _launches(launches):
    return [(ln.class_key, ln.plan.mode, ln.plan.cd, ln.plan.tile.key(),
             None if ln.plan.tiles is None else [t.key() for t in ln.plan.tiles],
             [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
             ln.end_t, ln.cache_hit) for ln in launches]


def _ticket(tk):
    return (tk.seq, tk.tenant, tk.kind, tk.submit_t, tk.deadline_t, tk.rank,
            tk.done_t, tk.sliced,
            None if tk.pieces is None else [_ticket(p) for p in tk.pieces],
            None if tk.members is None else [_ticket(m) for m in tk.members])


# ----------------------------------------------------------- admission
def test_admission_slices_oversized_ops():
    """An oversized op enters the queues only as pieces; the caller holds
    the parent, which completes with its last piece."""
    pair = Pair(**EVERYTHING)
    jtk, ptk = pair.submit(BIG)
    for rt, tk in ((pair.j, jtk), (pair.p, ptk)):
        assert tk.sliced and len(tk.pieces) == rt.config.max_slices
        assert rt.pending() == rt.config.max_slices
        assert sum(p.desc.M for p in tk.pieces) == BIG.M
        assert rt.telemetry.sliced_ops == 1
        assert rt.telemetry.slice_counts["default"] == rt.config.max_slices
    assert all(compat_key(p.desc) == compat_key(BIG) for p in ptk.pieces)
    pair.drain(now=1.0)
    assert ptk.done_t == max(p.done_t for p in ptk.pieces)
    assert pair.p.telemetry.completed == 1
    pair.check([jtk], [ptk])


def test_admission_leaves_small_ops_whole():
    pair = Pair(window_s=0.0, slicing=True, flush_budget_s=10.0)
    jtk, ptk = pair.submit(GemmDesc(8, 128, 128))
    assert not ptk.sliced and not jtk.sliced and pair.p.pending() == 1
    off = Pair(window_s=0.0)              # slicing off: even BIG stays whole
    jtk2, ptk2 = off.submit(BIG)
    assert not ptk2.sliced and not jtk2.sliced
    pair.check([jtk], [ptk])
    off.check([jtk2], [ptk2])


def _int_operands(d, seed):
    rng = np.random.default_rng(seed)
    shapes = (((d.K, d.M) if d.ta else (d.M, d.K)), (d.K, d.N))
    return tuple(rng.integers(-3, 4, size=s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("ta", [False, True], ids=["rows", "ta_columns"])
def test_sliced_execution_merges_parent_result(ta):
    """The parent's result is its pieces' merged: bitwise the reference's
    on integer-valued operands, of the parent's shape.  A ``ta`` parent's
    pieces get their own contiguous copies of their columns of ``a``
    (ROADMAP C10: the card's GEMM launchers refuse a column view)."""
    pair = Pair(execute=True, **EVERYTHING)
    d = GemmDesc(128, 192, 128, ta=ta, dtype="f32")
    a, b = _int_operands(d, 1)
    jtk, ptk = pair.submit(d, operands=(a, b))
    assert ptk.sliced and jtk.sliced
    for p, (lo, hi) in zip(ptk.pieces, ptk.merge_plan.spans):
        assert p.request.a.is_contiguous()
        want = torch.from_numpy(a[:, lo:hi] if ta else a[lo:hi])
        assert torch.equal(p.request.a, want)
        assert (p.request.a.data_ptr() == ptk.request.a.data_ptr()
                + lo * d.K * 4) != ta      # rows are views, columns copies
    pair.drain(now=1.0)
    assert ptk.result.shape == (d.M, d.N)
    np.testing.assert_array_equal(ptk.result.numpy(), np.asarray(jtk.result))
    ref = gemm_ref(torch.from_numpy(a), torch.from_numpy(b), ta=ta)
    assert torch.equal(ptk.result, ref)
    pair.check([jtk], [ptk])


# ------------------------------------------------------------------ EDF
def test_edf_flush_serves_earliest_deadline_first():
    pair = Pair(window_s=0.0, policy="edf")
    pair.slo("lat", "latency", weight=4.0, p99_target_s=1e-3)
    tickets = [pair.submit(OTHER, tenant="batch") for _ in range(6)]
    tickets.append(pair.submit(SMALL, tenant="lat"))
    jl, pl = pair.flush(now=1.0)
    assert tickets[-1][1] in pl[0].tickets     # earliest deadline first
    deadlines = [min(t.deadline_t for t in ln.tickets) for ln in pl]
    assert deadlines == sorted(deadlines)
    pair.check(*zip(*tickets))


def test_edf_weight_breaks_deadline_ties():
    """Equal deadlines: the heavier tenant's launch goes first, though it
    arrived later."""
    pair = Pair(window_s=0.0, policy="edf")
    pair.slo("heavy", "batch", weight=3.0)
    tickets = [pair.submit(OTHER, now=0.0), pair.submit(SMALL, tenant="heavy", now=0.0)]
    _, launches = pair.flush(now=1.0)
    assert tickets[0][1].deadline_t == tickets[1][1].deadline_t
    assert [ln.tickets[0].tenant for ln in launches] == ["heavy", "default"]
    pair.check(*zip(*tickets))


def test_edf_deadlines_are_absolute_no_starvation():
    pair = Pair(window_s=0.0, policy="edf", flush_budget_s=1e-7)
    old = pair.submit(SMALL, now=0.0)
    pair.flush(now=1.0)
    fresh = pair.submit(SMALL, now=2.0)
    assert old[1].deadline_t < fresh[1].deadline_t
    pair.drain(now=3.0)
    assert old[1].done_t is not None and fresh[1].done_t is not None
    assert old[1].done_t <= fresh[1].done_t
    pair.check(*zip(old, fresh))


def test_budgeted_flush_defers_and_drain_terminates():
    pair = Pair(window_s=0.0, policy="edf", flush_budget_s=1e-9)
    tickets = [pair.submit(d) for d in [SMALL] * 5 + [OTHER] * 5]
    jfirst, pfirst = pair.flush(now=1.0)
    assert len(pfirst) >= 1                # the horizon binds at least one
    assert pair.p.pending() > 0 or pair.p.telemetry.deferred_launches == 0
    pair.drain(now=1.0)
    for rt in pair.both:
        assert rt.pending() == 0
        assert rt.telemetry.deferred_launches > 0
        assert rt.telemetry.completed == 10
    pair.check(*zip(*tickets))


def test_sliced_plan_cache_signature_stable_steady_state():
    """Pieces are ordinary descs with canonical keys: a sliced workload
    reaches the same zero-evaluation steady state as a whole one."""
    pair = Pair(**EVERYTHING)
    tickets = [pair.submit(BIG, now=0.0)]
    pair.flush(now=1.0)
    for r in range(4):
        now = 10.0 + r
        tickets.append(pair.submit(BIG, now=now))
        e0, j0 = EVAL_COUNTER.evals, JEVALS.evals
        jl, pl = pair.flush(now=now + 0.5)
        assert pl and all(ln.cache_hit for ln in pl)
        assert EVAL_COUNTER.evals == e0 and JEVALS.evals == j0
        assert pair.p.telemetry.last_flush_evals == 0
    assert pair.p.telemetry.flush_sig_resorts == 0
    pair.check(*zip(*tickets))


def test_edf_mixed_bundle_ranks_join_signature():
    """Unequal ranks in the bundle queue change its plan (`plan_mixed`
    with ranks), so they join the signature; static ranks still hit."""
    pair = Pair(window_s=0.0, policy="edf")
    pair.slo("lat", "latency", weight=2.0, p99_target_s=1e-3)
    tickets = []

    def round_(now):
        tickets.append(pair.submit([SMALL, OTHER], tenant="batch", now=now))
        tickets.append(pair.submit([SMALL2], tenant="lat", now=now))
        return pair.flush(now=now + 0.5)[1]

    first = round_(0.0)
    assert all(not ln.cache_hit for ln in first)
    second = round_(10.0)
    assert second and all(ln.cache_hit for ln in second)
    assert [(ln.plan.cd, ln.plan.mode) for ln in first] == \
        [(ln.plan.cd, ln.plan.mode) for ln in second]
    assert min(t.rank for t in first[0].tickets) == 0
    assert any("ranks:" in k for sig in pair.p._plan_cache for k in sig[0])
    pair.check(*zip(*tickets))


# ------------------------------------------- the admission estimate cache
def test_iso_cache_cleared_by_process_retunes():
    pair = Pair(**EVERYTHING)
    pair.submit(BIG)
    ck = compat_key(BIG)
    for rt, d in ((pair.j, _j(BIG)), (pair.p, BIG)):
        assert rt._iso_cache
        rt._class_descs[ck] = {d.key(): d}
        rt._retune.append(("gemm", ck))
    assert pair.p.process_retunes(now=0.0) == pair.j.process_retunes(now=0.0) == 1
    assert pair.p._iso_cache == pair.j._iso_cache == {}


def test_iso_cache_cleared_by_quarantine_and_probe():
    pair = Pair(quarantine_strikes=1, **EVERYTHING)
    reqs = [_j(BIG), GemmRequest(desc=BIG)]
    for rt, req in zip(pair.both, reqs):
        rt.submit(req, now=0.0)
        assert rt._iso_cache
        desc = req if isinstance(req, type(_j(BIG))) else req.desc
        tile = rt.ctrl.lib.get(desc).isolated
        rt._strike([JReq(desc=req) if rt is pair.j else req], [tile], now=0.0)
        assert rt.telemetry.quarantines == 1 and rt._iso_cache == {}
        rt._isolated_estimate(desc)       # admission fills it again
        rt.process_retunes(now=rt.config.quarantine_cooldown_s)
        assert rt.telemetry.probes == 1 and rt._iso_cache == {}
    pair.check()


# -------------------------------------------------------- registry, stats
def test_tenant_slo_registry_and_defaults():
    pair = Pair()
    assert pair.p.tenant_slo("nobody") is DEFAULT_SLO
    assert DEFAULT_SLO == TenantSLO() and DEFAULT_SLO.rank == JDEFAULT_SLO.rank == 1
    assert (DEFAULT_SLO.latency_class, DEFAULT_SLO.weight, DEFAULT_SLO.p99_target_s) \
        == (JDEFAULT_SLO.latency_class, JDEFAULT_SLO.weight, JDEFAULT_SLO.p99_target_s)
    slo = TenantSLO("latency", weight=3.0, p99_target_s=2e-3)
    assert slo.rank == 0
    pair.slo("a", "latency", weight=3.0, p99_target_s=2e-3)
    assert pair.p.tenant_slo("a") == slo
    jtk, ptk = pair.submit(SMALL, tenant="a", now=5.0)
    assert ptk.deadline_t == jtk.deadline_t == pytest.approx(5.0 + 2e-3)
    assert ptk.rank == 0
    pair.check([jtk], [ptk])


def test_tenant_percentiles_nearest_rank():
    pair = Pair()
    for rt in pair.both:
        for i in range(1, 101):
            rt.telemetry.record_latency("t", i * 1e-3)
    pct = pair.p.telemetry.tenant_percentiles()["t"]
    assert pct == pair.j.telemetry.tenant_percentiles()["t"]
    assert (pct["n"], pct["p50_ms"], pct["p95_ms"], pct["p99_ms"]) == \
        (100, pytest.approx(50.0), pytest.approx(95.0), pytest.approx(99.0))
    summary = pair.p.telemetry.summary()
    assert summary["tenants"]["t"] == pct
    assert "slice_counts" in summary and "deferred_launches" in summary
    pair.check()


# ------------------------------------------------------- random traces
# Event kinds: a GEMM alone, or a bundle (a prefill attention beside a
# GEMM, or a decode attention with a batch-sliceable scan).
KINDS = ([SMALL], [OTHER], [BIG], [PREFILL_ATTN, SMALL],
         [AttentionDesc(4, 8, 2, 1, 256, 64), ScanDesc(4, 64, 4, 16, 16)])


@given(events=st.lists(st.tuples(st.sampled_from(["lat", "batch", "other", "heavy"]),
                                 st.integers(0, len(KINDS) - 1),
                                 st.sampled_from([0.0, 2e-4, 1e-3]) | st.floats(0.0, 1e-3)),
                       min_size=1, max_size=12),
       policy=st.sampled_from(["edf", "round-robin"]),
       budget=st.sampled_from([None, 1e-4, 1e-6]), slicing=st.booleans(),
       frac=st.sampled_from([0.5, 0.05]))
@settings(max_examples=25, deadline=None)
def test_random_traces_match_reference(events, policy, budget, slicing, frac):
    """Shadow traces through both runtimes (ties in deadline between
    tenants of unequal weight included): the same launches, timeline,
    deadlines, pieces and telemetry; under EDF with a budget, every
    submission (and every sliced parent) completes and the timeline is
    monotone across the deferrals."""
    pair = Pair(window_s=0.0, policy=policy, slicing=slicing, flush_budget_s=budget,
                slice_budget_frac=frac)
    pair.slo("lat", "latency", weight=4.0, p99_target_s=1e-3)
    pair.slo("other", "batch", weight=2.0, p99_target_s=5e-3)
    pair.slo("heavy", "batch", weight=3.0)     # "batch"'s deadlines, heavier
    tickets = []
    for i, (tenant, kind, t) in enumerate(sorted(events, key=lambda e: e[2])):
        work = KINDS[kind]
        tickets.append(pair.submit(work if len(work) > 1 else work[0], tenant=tenant,
                                   now=t))
        if i % 3 == 2:
            pair.flush(now=t)
    _, launches = pair.drain(now=1e-3)
    pair.check(*zip(*tickets))
    for _, tk in tickets:
        assert tk.done and tk.done_t is not None
        for m in tk.members or [tk]:
            assert all(p.done_t is not None for p in m.pieces or [])
    starts = [ln.start_t for ln in launches]
    assert starts == sorted(starts)


def test_qwen3_prefill_beside_decode_shadow_matches_reference():
    """The traffic `chip_smoke.py` serves in its SLO phase, four layers of
    full-width Qwen3-14B in shadow mode: a 4,096-token prompt (seven
    GEMMs alone, the causal attention as a one-member bundle) beside
    decode bundles at batch 8 over 4,096 cached tokens.  EDF with a 1 ms
    budget slices q and o into 3, gate, up and down into 8 and the
    attention into 2 query-row pieces, k and v whole: 34 queue entries a
    layer; the decode bundles complete sooner than under round-robin."""
    cfg, jcfg = get_arch("qwen3-14b"), jget_arch("qwen3-14b")
    prefill = [GemmDesc(4096, n, k) for n, k in (
        (5120, 5120), (1024, 5120), (1024, 5120), (5120, 5120), (17408, 5120),
        (17408, 5120), (5120, 17408))]
    attn = AttentionDesc(1, 40, 8, 4096, 4096, 128)
    decode = decode_step_op_descs(cfg, 8, 4096)
    assert [d.key() for d in decode] == [d.key() for d in jop_descs(jcfg, 8, 4096)]
    latency = {}
    for name, kw in (("A", {}), ("B", dict(policy="edf", slicing=True,
                                           flush_budget_s=1e-3, max_slices=8))):
        pair = Pair(window_s=0.0, **kw)
        pair.slo("prefill", "batch", weight=1.0, p99_target_s=1.0)
        pair.slo("decode", "latency", weight=4.0, p99_target_s=20e-3)
        tickets, bundles = [], []
        for layer in range(4):
            now = layer * 1e-3
            tickets += [pair.submit(d, tenant="prefill", now=now) for d in prefill]
            tickets.append(pair.submit([attn], tenant="prefill", now=now))
            bundles.append(pair.submit(decode, tenant="decode", now=now))
            pair.flush(now=now, force=True)
        pair.drain(now=4e-3)
        pair.check(*zip(*(tickets + bundles)))
        ops = [t for _, t in tickets]
        entries = [len(t.pieces) if t.sliced else 1 for t in ops[:7]]
        entries.append(len(ops[7].members[0].pieces or [None]))
        latency[name] = [b.done_t - b.submit_t for _, b in bundles]
        tele = pair.p.telemetry
        if name == "A":
            assert entries == [1] * 8 and tele.deferred_launches == 0
        else:
            assert entries == [3, 1, 1, 3, 8, 8, 8, 2] and sum(entries) == 34
            assert tele.slice_counts["prefill"] == 4 * 32 and tele.sliced_ops == 24
            assert tele.deferred_launches > 0
    assert all(b < a / 4 for a, b in zip(latency["A"], latency["B"]))


def _numpy_operands(d, rng):
    if d.family == "gemm":
        return tuple(rng.integers(-3, 4, size=s).astype(np.float32)
                     for s in ((d.M, d.K), (d.K, d.N)))
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (d.B, d.Hq, d.Sq, d.D), (d.B, d.Hkv, d.Skv, d.D), (d.B, d.Hkv, d.Skv, d.D)))


def test_decode_and_prefill_trace_executed_matches_reference():
    """Two layers of reduced Qwen3-14B, executed: a 64-token prompt beside
    decode bundles at batch 2 over 64 cached tokens, EDF with a budget
    that slices the prompt's ops.  Both runtimes make the same launches
    and pieces; GEMM results (merged parents included) are bitwise the
    reference's, attention within 3e-4."""
    cfg = get_arch("qwen3-14b").reduced()
    hd, d, ff = cfg.resolved_head_dim, cfg.d_model, cfg.d_ff
    qn, kvn = cfg.n_heads * hd, cfg.n_kv_heads * hd
    prefill = [GemmDesc(64, n, k, dtype="f32") for n, k in (
        (qn, d), (kvn, d), (kvn, d), (d, qn), (ff, d), (ff, d), (d, ff))]
    attn = AttentionDesc(1, cfg.n_heads, cfg.n_kv_heads, 64, 64, hd, True, "f32")
    decode = decode_step_op_descs(cfg, 2, 64, dtype="f32")
    pair = Pair(execute=True, window_s=0.0, policy="edf", slicing=True,
                flush_budget_s=4e-6, slice_budget_frac=0.5, max_slices=4)
    pair.slo("prefill", "batch", weight=1.0, p99_target_s=1.0)
    pair.slo("decode", "latency", weight=4.0, p99_target_s=20e-3)
    rng = np.random.default_rng(3)
    tickets = []
    for layer in range(2):
        now = layer * 1e-6
        for pd in prefill:
            tickets.append(pair.submit(pd, "prefill", now, _numpy_operands(pd, rng)))
        tickets.append(pair.submit([attn], "prefill", now, [_numpy_operands(attn, rng)]))
        tickets.append(pair.submit(decode, "decode", now,
                                   [_numpy_operands(x, rng) for x in decode]))
        pair.flush(now=now, force=True)
    pair.drain(now=2e-6)
    pair.check(*zip(*tickets))
    tele = pair.p.telemetry
    assert tele.sliced_ops > 0 and tele.deferred_launches > 0
    for jtk, ptk in tickets:
        for jm, pm in zip(jtk.members or [jtk], ptk.members or [ptk], strict=True):
            want = np.asarray(jm.result)
            if pm.desc.family == "gemm":
                np.testing.assert_array_equal(pm.result.numpy(), want)
            else:
                np.testing.assert_allclose(pm.result.numpy(), want, rtol=3e-4,
                                           atol=3e-4)
