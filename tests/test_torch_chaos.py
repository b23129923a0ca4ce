"""The port's fault injection, circuit breaker and fallback ladder
(DESIGN.md §18) held to the reference's on the same inputs.

Operands are integer-valued float32 (every sum exact), so every path —
each ladder rung, each grouping, either package — gives the same bits,
and the ladder's trace is compared whole: per-ticket results and
completion times, each launch's fallback rung, penalty and place on the
modeled timeline, faults and fallbacks by kind, quarantines with their
evicted plans, probes, and the library's and the breaker's quarantine
sets.  The cases are the reference tests' (`tests/test_chaos.py`), plus
bundles of mixed launches.

Port-only: the ladder handles faults, not refusals — a `ValueError` (as
a kernel that refuses a shape or split raises on the card) and a build
failure propagate at once, with no strike and no fault counted; a
`KernelLaunchError` is a fault of kind "error"; the reference rung gives
each member of a mixed group its own isolated tile.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.runtime import CircuitBreaker as JBreaker
from repro.runtime import FaultInjector as JInjector
from repro.runtime import FaultRule as JRule
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime.faults import _roll as jroll
from repro_torch.core import ConcurrencyController, GemmDesc, GemmRequest, GOLibrary
from repro_torch.core.scheduler import execute_schedule
from repro_torch.kernels.gemm.kernel import KernelLaunchError, raise_on_error
from repro_torch.runtime import (
    CircuitBreaker,
    FaultInjector,
    FaultRule,
    InjectedFault,
    LaunchStall,
    NonFiniteOutput,
    Runtime,
    RuntimeConfig,
)
from repro_torch.runtime import runtime as port_runtime
from repro_torch.runtime.faults import _roll, fault_kind
from tests.hypothesis_compat import given, settings, st

SHAPES = [(32, 128, 128), (64, 128, 128), (16, 96, 128)]


def _operands(d, i: int):
    rng = np.random.default_rng([7, i])
    return (rng.integers(-4, 5, (d[0], d[2])).astype(np.float32),
            rng.integers(-4, 5, (d[2], d[1])).astype(np.float32))


def _reqs(shape: int, i: int):
    """The port's and the reference's request for SHAPES[shape], operand
    set ``i``."""
    d = SHAPES[shape]
    a, b = _operands(d, i)
    return (GemmRequest(desc=GemmDesc(*d, dtype="f32"), a=torch.from_numpy(a),
                        b=torch.from_numpy(b)),
            JReq(desc=JDesc(*d, dtype="f32"), a=jnp.asarray(a), b=jnp.asarray(b)))


def _rules(specs, pkg):
    return tuple((FaultRule if pkg == "port" else JRule)(*args, **kw)
                 for args, kw in specs)


def _runtimes(specs=None, seed: int = 0, **cfg):
    """A port runtime on the CPU and a reference runtime (XLA path, no
    interpret mode, as its own chaos tests run), each with an injector of
    the same rules and seed when ``specs`` is given."""
    cfg.setdefault("window_s", 0.0)
    cfg.setdefault("execute", True)
    pinj = jinj = None
    if specs is not None:
        pinj = FaultInjector(_rules(specs, "port"), seed=seed)
        jinj = JInjector(_rules(specs, "reference"), seed=seed)
    prt = Runtime(ConcurrencyController(GOLibrary()), RuntimeConfig(**cfg),
                  device="cpu", fault_injector=pinj)
    jrt = JRuntime(JCtrl(library=JLib()), JConfig(interpret=False, **cfg),
                   fault_injector=jinj)
    return prt, jrt


def _serve(rt, pkg: str, waves):
    """``waves``: (now, [(shape, i), ...] singles, [[(shape, i), ...]]
    bundles).  Returns the member tickets and every launch."""
    k = 0 if pkg == "port" else 1
    tickets, launches = [], []
    for now, singles, bundles in waves:
        tickets += [rt.submit(_reqs(s, i)[k], now=now) for s, i in singles]
        for bundle in bundles:
            tickets += rt.submit([_reqs(s, i)[k] for s, i in bundle],
                                 now=now).members
        launches += rt.drain(now=now + 1.0)
    return tickets, launches


def _trace(rt, tickets, launches):
    tele = rt.telemetry
    return dict(
        done=[tk.done_t for tk in tickets],
        launches=[(ln.class_key, ln.plan.mode, ln.plan.tile.key(), ln.fallback,
                   ln.penalty_s, ln.start_t, ln.end_t, ln.cache_hit)
                  for ln in launches],
        records=[(g.mode, g.fallback) for g in tele.groups],
        faults=dict(tele.faults), fallbacks=dict(tele.fallbacks),
        quarantines=tele.quarantines, evictions=tele.quarantine_evictions,
        probes=tele.probes, completed=tele.completed,
        lib_quarantined=rt.ctrl.lib.quarantined(),
        breaker=rt.breaker.quarantined(), device_free_t=rt.device_free_t,
        plans=rt.plan_cache_size)


def _both(waves, specs=None, seed=0, **cfg):
    """Serve ``waves`` through both packages; assert equal traces, equal
    injection logs and bitwise-equal results; return both runtimes, the
    port's tickets and launches, the reference's, and the trace."""
    prt, jrt = _runtimes(specs, seed, **cfg)
    pt, pl = _serve(prt, "port", waves)
    jt, jl = _serve(jrt, "reference", waves)
    trace = _trace(prt, pt, pl)
    assert trace == _trace(jrt, jt, jl)
    for p, j in zip(pt, jt, strict=True):
        np.testing.assert_array_equal(p.result.numpy(), np.asarray(j.result))
    if prt.fault_injector is not None:
        assert [tuple(vars(x).values()) for x in prt.fault_injector.log] == \
            [tuple(vars(x).values()) for x in jrt.fault_injector.log]
    return prt, jrt, (pt, pl), (jt, jl), trace


SINGLES = [(0.0, [(0, 0), (0, 1), (0, 2)], [])]


def _fault_free(waves):
    prt, _ = _runtimes()
    tickets, _ = _serve(prt, "port", waves)
    return [tk.result.numpy() for tk in tickets]


# -------------------------------------------------------- injector units
@pytest.mark.parametrize("seed", [0, 3, 4])
def test_injection_decisions_and_logs_equal_the_reference(seed):
    specs = [(("raise", 0.3), {}), (("nan", 0.4), {"family": "gemm"}),
             (("stall", 0.5), {"class_key": "ck1", "max_faults": 3})]
    port = FaultInjector(_rules(specs, "port"), seed=seed)
    ref = JInjector(_rules(specs, "reference"), seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        scope = ("gemm" if rng.random() < 0.7 else "mamba_scan",
                 f"ck{rng.integers(3)}", f"tk{rng.integers(2)}")
        p, j = port.decide(*scope), ref.decide(*scope)
        assert (p and (p.kind, p.p)) == (j and (j.kind, j.p))
    assert [tuple(vars(x).values()) for x in port.log] == \
        [tuple(vars(x).values()) for x in ref.log]
    assert len(port.log) > 20
    for args in [(seed, "raise", "gemm|c|t", 5), (99, "nan", "x", 0)]:
        assert _roll(*args) == jroll(*args)


def test_rules_scope_by_family_class_and_tile_and_cap_deliveries():
    r = FaultRule("raise", 1.0, family="gemm", class_key="c1", tile_key="t1")
    assert r.matches("gemm", "c1", "t1")
    assert not r.matches("flash_attention", "c1", "t1")
    assert not r.matches("gemm", "c2", "t1") and not r.matches("gemm", "c1", "t2")
    inj = FaultInjector((FaultRule("raise", 1.0, max_faults=2),), seed=0)
    hits = [inj.decide("gemm", "c", "t") is not None for _ in range(5)]
    assert hits == [True, True, False, False, False]
    assert [i.ordinal for i in inj.log] == [0, 1]


def test_fault_kind_buckets():
    assert fault_kind(LaunchStall("x")) == "stall"
    assert fault_kind(NonFiniteOutput("x")) == "nan"
    assert fault_kind(InjectedFault("x")) == "raise"
    assert fault_kind(KernelLaunchError("x")) == "error"


def test_stall_advances_injectable_clock():
    seen = []
    inj = FaultInjector((FaultRule("stall", 1.0, stall_s=2.5e-3),), seed=0,
                        advance=seen.append)
    with pytest.raises(LaunchStall):
        inj._deliver(inj.decide("gemm", "c", "t"), [], [0])
    assert seen == [2.5e-3]


# --------------------------------------------------------- breaker units
@pytest.mark.parametrize("seed", range(4))
def test_breaker_sequences_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    strikes, cooldown = int(rng.integers(1, 4)), float(rng.uniform(0.5, 2.0))
    port, ref = CircuitBreaker(strikes, cooldown), JBreaker(strikes, cooldown)
    now = 0.0
    for _ in range(300):
        key = ("gemm", f"c{rng.integers(2)}", f"t{rng.integers(3)}")
        op = rng.integers(3)
        now += float(rng.uniform(0.0, 0.3))
        if op == 0:
            assert port.strike(*key, now=now) == ref.strike(*key, now=now)
        elif op == 1:
            port.succeed(*key)
            ref.succeed(*key)
        else:
            assert port.release_due(now) == ref.release_due(now)
        assert port.quarantined() == ref.quarantined()
        assert port.active == ref.active
        assert port.quarantine_count == ref.quarantine_count
        assert port.is_quarantined(*key) == ref.is_quarantined(*key)
    assert port.quarantine_count > 0


def test_breaker_half_open_release_and_requarantine():
    br = CircuitBreaker(strikes=3, cooldown_s=1.0)
    for _ in range(3):
        br.strike("gemm", "c", "t", now=0.0)
    assert br.release_due(now=0.5) == []
    assert br.release_due(now=1.0) == [("gemm", "c", "t")]
    assert br.strike("gemm", "c", "t", now=2.0)     # one more failure
    assert br.release_due(now=3.0) == [("gemm", "c", "t")]
    br.succeed("gemm", "c", "t")
    assert not br.active


# ------------------------------------------------------- fallback ladder
BUNDLES = [(0.0, [], [[(0, 0), (1, 1), (2, 2)]]), (2.0, [], [[(2, 3), (0, 4)]])]

LADDER = {
    "retry": (SINGLES, [(("raise", 1.0), {"max_faults": 1})],
              dict(quarantine_strikes=10), {"raise": 1}, {"retry": 1}),
    "legacy": (SINGLES, [(("raise", 1.0), {"max_faults": 2})],
               dict(max_retries=1, quarantine_strikes=10), {"raise": 2},
               {"legacy": 1}),
    "reference": (SINGLES, [(("raise", 1.0), {})],
                  dict(max_retries=1, quarantine_strikes=10), {"raise": 3},
                  {"reference": 1}),
    "nan": (SINGLES, [(("nan", 1.0), {"max_faults": 1})],
            dict(quarantine_strikes=10), {"nan": 1}, {"retry": 1}),
    "stall": (SINGLES, [(("stall", 1.0), {"max_faults": 1, "stall_s": 1e-3})],
              dict(quarantine_strikes=10), {"stall": 1}, {"retry": 1}),
    "bundle_reference": (BUNDLES, [(("raise", 1.0), {})],
                         dict(quarantine_strikes=10), {"raise": 6},
                         {"reference": 2}),
    # three "nan" members fail the first attempt once, a fourth the retry
    "bundle_nan": (BUNDLES, [(("nan", 1.0), {"max_faults": 4})],
                   dict(quarantine_strikes=10), {"nan": 2}, {"legacy": 1}),
}


@pytest.mark.parametrize("case", sorted(LADDER))
def test_ladder_trace_equals_the_reference(case):
    waves, specs, cfg, faults, fallbacks = LADDER[case]
    _, _, (tickets, launches), _, trace = _both(waves, specs, **cfg)
    assert trace["faults"] == faults and trace["fallbacks"] == fallbacks
    for tk, want in zip(tickets, _fault_free(waves), strict=True):
        np.testing.assert_array_equal(tk.result.numpy(), want)
    for ln in launches:
        k = {"retry": 1, "legacy": 2, "reference": 3, None: 0}[ln.fallback]
        assert ln.penalty_s == k * ln.plan.modeled_time_s


def test_quarantine_fires_with_cache_hygiene_and_probe():
    specs = [(("raise", 1.0), {"max_faults": 2})]
    prt, jrt, (pt, pl), (jt, jl), trace = _both(SINGLES, specs, max_retries=1,
                                                quarantine_strikes=2)
    assert trace["quarantines"] == 1 and trace["evictions"] >= 1
    assert trace["lib_quarantined"] and trace["breaker"]
    assert trace["fallbacks"] == {"legacy": 1}
    now = pl[0].start_t + prt.config.quarantine_cooldown_s
    assert prt.process_retunes(now=now) == jrt.process_retunes(now=now)
    after = _trace(prt, pt, pl)
    assert after == _trace(jrt, jt, jl)
    assert after["probes"] == 1 and after["lib_quarantined"] == {}
    assert after["breaker"] == [] and after["plans"] == 0


@pytest.mark.parametrize("rearm", [True, False], ids=["flaky_tile", "breaker_reset"])
def test_strikes_across_launches_equal_the_reference(rearm):
    """One failure per launch, each completed by a retry: `succeed` resets
    only on a planned-rung success, so a tile that is flaky in every
    launch reaches K strikes (``flaky_tile``); a planned success between
    the failures resets its count (``breaker_reset``)."""
    specs = [(("raise", 1.0), {"max_faults": 1})]
    prt, jrt = _runtimes(specs, max_retries=2, quarantine_strikes=2)
    for rt, pkg in ((prt, "port"), (jrt, "reference")):
        for w in range(3):
            _serve(rt, pkg, [(2.0 * w, [(0, w)], [])])
            if rearm:
                rt.fault_injector._fired.clear()
    assert _trace(prt, [], []) == _trace(jrt, [], [])
    assert prt.telemetry.quarantines == (1 if rearm else 0)
    assert dict(prt.telemetry.fallbacks) == {"retry": 3 if rearm else 1}
    assert prt.breaker.active == rearm


def test_disabled_injection_is_bitwise_identical():
    waves = SINGLES + BUNDLES
    plain, _ = _runtimes()
    armed, _ = _runtimes([(("raise", 0.0), {})])
    assert not armed.fault_injector.enabled
    tp, lp = _serve(plain, "port", waves)
    ta, la = _serve(armed, "port", waves)
    for a, b in zip(tp, ta, strict=True):
        assert torch.equal(a.result, b.result) and a.done_t == b.done_t
    assert plain.device_free_t == armed.device_free_t
    assert all(ln.fallback is None and ln.penalty_s == 0.0 for ln in la)
    sp, sa = plain.telemetry.summary(), armed.telemetry.summary()
    sp.pop("class_ratios"), sa.pop("class_ratios")
    assert sp == sa and armed.telemetry.fault_events == 0


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 10_000),
       p_raise=st.sampled_from([0.0, 0.3, 0.7]),
       p_nan=st.sampled_from([0.0, 0.4]),
       p_stall=st.sampled_from([0.0, 0.2]))
def test_random_fault_schedules_equal_the_reference(seed, p_raise, p_nan, p_stall):
    """Under any seeded schedule every request completes, bitwise equal to
    the fault-free run, the telemetry reconciles with the injector's log
    (one fault per failed attempt), and the whole trace is the
    reference's."""
    waves = [(0.0, [(0, 0), (0, 1)], []), (2.0, [(1, 2), (1, 3)], []),
             (4.0, [(0, 4), (1, 5)], [[(0, 6), (1, 7), (2, 8)]])]
    specs = [(("raise", p_raise), {}), (("nan", p_nan), {}),
             (("stall", p_stall), {"stall_s": 1e-4})]
    prt, _, (tickets, _), _, trace = _both(waves, specs, seed=seed,
                                           quarantine_strikes=3)
    assert trace["completed"] == prt.telemetry.submitted == len(tickets)
    for tk, want in zip(tickets, _fault_free(waves), strict=True):
        np.testing.assert_array_equal(tk.result.numpy(), want)
    # a failed attempt is one fault; a mixed attempt may draw several
    # member injections (two "nan" members, or a "nan" then a "raise")
    log = prt.fault_injector.log
    assert (prt.telemetry.fault_events > 0) == bool(log)
    assert prt.telemetry.fault_events <= len(log)
    assert "error" not in prt.telemetry.faults


# ------------------------------------------------------------ port only
@pytest.mark.parametrize("exc", [
    ValueError("splitk_matmul: split 17 exceeds the cluster limit of 16"),
    RuntimeError("CUDA kernel build failed:\ngemm.cu"),
    NotImplementedError("8_64_64_00_f32_b4: batched GEMMs have no kernel in the port yet"),
], ids=["refusal", "build", "unported"])
def test_refusals_propagate_at_once_with_no_strike(exc):
    prt, _ = _runtimes()
    calls = []

    def refuse(reqs, sched):
        calls.append(sched)
        raise exc

    prt._exec_fn = refuse
    prt.submit(_reqs(0, 0)[0], now=0.0)
    with pytest.raises(type(exc), match=str(exc).splitlines()[0][:20]):
        prt.drain(now=1.0)
    assert len(calls) == 1
    assert not prt.telemetry.faults and not prt.telemetry.fallbacks
    assert not prt.breaker.active


def test_kernel_launch_error_is_a_fault_of_kind_error():
    prt, _ = _runtimes()
    inner, calls = prt._exec_fn, []

    def flaky(reqs, sched):
        calls.append(sched)
        if len(calls) == 1:
            raise KernelLaunchError("matmul (tma feed) launch failed: CUDA error 700")
        return inner(reqs, sched)

    prt._exec_fn = flaky
    (tk,) = _serve(prt, "port", [(0.0, [(0, 0)], [])])[0]
    assert dict(prt.telemetry.faults) == {"error": 1}
    assert dict(prt.telemetry.fallbacks) == {"retry": 1}
    np.testing.assert_array_equal(tk.result.numpy(), _fault_free([(0.0, [(0, 0)], [])])[0])


def test_raise_on_error_raises_kernel_launch_error():
    class StubLib:
        @staticmethod
        def repro_error_string(code):
            return b"an illegal memory access was encountered"

    raise_on_error(StubLib, 0, "matmul")
    with pytest.raises(KernelLaunchError, match="matmul launch failed: CUDA "
                                                "error 700 .an illegal memory"):
        raise_on_error(StubLib, 700, "matmul")
    assert issubclass(KernelLaunchError, RuntimeError)


def test_reference_rung_gives_each_mixed_member_its_own_isolated_tile(monkeypatch):
    prt, _ = _runtimes([(("raise", 1.0), {})], quarantine_strikes=10)
    floor = []

    def record(reqs, sched):
        floor.append(([(g.mode, g.tile, g.tiles) for g in sched.groups],
                      [r.desc for r in reqs]))
        return execute_schedule(reqs, sched)

    # the injector wrapped the executor when the runtime was made, so only
    # the reference rung, which bypasses it, reaches the module's name
    monkeypatch.setattr(port_runtime, "execute_schedule", record)
    tickets, launches = _serve(prt, "port", [(0.0, [], [[(0, 0), (1, 1), (2, 2)]])])
    (ln,) = launches
    assert ln.plan.mode == "mixed" and ln.fallback == "reference"
    assert len(floor) == 1
    groups, descs = floor[0]
    iso = [prt.ctrl.lib.get(d).isolated for d in descs]
    assert [(m, t) for m, t, _ in groups] == [("single", t) for t in iso]
    assert len({t.key() for t in iso}) > 1          # not the plan's first tile
    for tk, want in zip(tickets, _fault_free(
            [(0.0, [], [[(0, 0), (1, 1), (2, 2)]])]), strict=True):
        np.testing.assert_array_equal(tk.result.numpy(), want)
