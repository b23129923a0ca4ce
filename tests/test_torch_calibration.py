"""The port's self-calibrating cost model (DESIGN.md §16) held to the
reference's on the same inputs, made from a numpy seed.

- `CostCalibrator`: the state after the same update streams (non-finite
  and non-positive times ignored) is bitwise equal, and so are
  `factor`, `correct`, `stale_classes` and `pop_stale`; the JSON either
  package writes loads into the other; the reference's statistical
  properties (`tests/test_calibration.py`) hold for the port.
- The controller: `_group_factor` is bitwise equal, and the calibrated
  `plan_mixed` and `plan_shared_input` make the reference's choices,
  a fuse-versus-group flip included; plans keep raw modeled times.
- The runtime: fed the same scripted achieved times, both feed the same
  calibrator states, queue the same re-tunes and run the same
  `process_retunes` (keys invalidated, entries re-tuned, plan cache
  cleared); a warm flush with a calibrator evaluates the model zero
  times.
"""
import json
import math

import numpy as np
import pytest
import torch

from repro.core import ConcurrencyController as JCtrl
from repro.core import CostCalibrator as JCal
from repro.core import GemmDesc as JDesc
from repro.core import GemmRequest as JReq
from repro.core import GOLibrary as JLib
from repro.core.op_desc import AttentionDesc as JAttn
from repro.core.op_desc import ScanDesc as JScan
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro_torch.configs import get_arch
from repro_torch.core import (
    AttentionDesc,
    ConcurrencyController,
    CostCalibrator,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    ScanDesc,
    compat_key,
    family_of,
    group_time,
    isolated_time,
)
from repro_torch.runtime import MIXED_CLASS, Runtime, RuntimeConfig
from repro_torch.runtime.integration import decode_step_descs
from tests.hypothesis_compat import given, settings, st

FAMILIES = ("gemm", "flash_attention", "mamba_scan")
BAD = (0.0, -1.0, float("nan"), float("inf"))


def _state(cal):
    return {k: (st.log_factor, st.drift, st.n) for k, st in cal._state.items()}


def _stream(seed: int, n: int = 80):
    """(family, class, modeled, achieved) updates: lognormal ratios around
    a per-class bias, every ~7th carrying a time the calibrator ignores."""
    rng = np.random.default_rng(seed)
    bias = np.exp(rng.normal(0.0, 0.8, size=(3, 4)))
    out = []
    for i in range(n):
        f, c = int(rng.integers(3)), int(rng.integers(4))
        modeled = float(rng.uniform(1e-6, 1e-3))
        achieved = float(modeled * bias[f, c] * np.exp(rng.normal(0.0, 0.2)))
        if i % 7 == 3:
            bad = BAD[int(rng.integers(len(BAD)))]
            modeled, achieved = (bad, achieved) if rng.integers(2) else (modeled, bad)
        out.append((FAMILIES[f], f"c{c}", modeled, achieved))
    return out


# ------------------------------------------------------------ calibrator
@pytest.mark.parametrize("alpha,threshold", [(0.2, 0.35), (0.5, 0.1), (0.05, 1.0)])
@pytest.mark.parametrize("seed", range(3))
def test_update_streams_give_bitwise_equal_state(seed, alpha, threshold):
    port, ref = CostCalibrator(alpha, threshold), JCal(alpha, threshold)
    for i, (fam, ck, m, a) in enumerate(_stream(seed)):
        port.update(fam, ck, m, a)
        ref.update(fam, ck, m, a)
        assert _state(port) == _state(ref)
        for f in FAMILIES:
            for c in ("c0", "c1", "c2", "c3", "unseen"):
                assert port.factor(f, c) == ref.factor(f, c)
                assert port.correct(f, c, 3.7e-5) == ref.correct(f, c, 3.7e-5)
        assert port.stale_classes() == ref.stale_classes()
        if i % 11 == 10:
            assert port.pop_stale() == ref.pop_stale()
    assert len(port) == len(ref) > 0


def test_ignored_times_leave_no_state():
    port, ref = CostCalibrator(), JCal()
    for bad in BAD:
        for cal in (port, ref):
            cal.update("gemm", "c", 1e-3, bad)
            cal.update("gemm", "c", bad, 1e-3)
    assert _state(port) == _state(ref) == {}
    assert port.factor("gemm", "c") == 1.0
    t = 3.7e-5
    assert port.correct("gemm", "c", t) is t


def test_pop_stale_queues_one_retune_per_excursion():
    port, ref = CostCalibrator(), JCal()
    for cal in (port, ref):
        cal.update("gemm", "c", 1.0, 3.0)          # |log 3| ≈ 1.10 > 0.35
    assert port.pop_stale() == ref.pop_stale() == [("gemm", "c")]
    assert port.pop_stale() == ref.pop_stale() == []
    assert port.factor("gemm", "c") == ref.factor("gemm", "c")
    assert math.isclose(port.factor("gemm", "c"), 3.0, rel_tol=1e-9)
    for cal in (port, ref):                      # drift restarts from zero
        cal.update("gemm", "c", 1.0, 3.0)
    assert port.stale_classes() == ref.stale_classes() == []
    assert _state(port) == _state(ref)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_json_written_by_either_package_loads_into_the_other(writer):
    port, ref = CostCalibrator(0.3, 0.5), JCal(0.3, 0.5)
    for fam, ck, m, a in _stream(7, n=40):
        port.update(fam, ck, m, a)
        ref.update(fam, ck, m, a)
    assert json.dumps(port.to_json()) == json.dumps(ref.to_json())
    blob = json.loads(json.dumps((port if writer == "port" else ref).to_json()))
    back_p, back_r = CostCalibrator.from_json(blob), JCal.from_json(blob)
    assert (back_p.alpha, back_p.drift_threshold) == (back_r.alpha,
                                                      back_r.drift_threshold)
    assert _state(back_p) == _state(back_r) == _state(ref)
    back_p.update("gemm", "c0", 1.0, 3.0)
    back_r.update("gemm", "c0", 1.0, 3.0)
    assert _state(back_p) == _state(back_r)


# ---------------------------- the reference's properties, held on the port
@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(0.25, 4.0), min_size=1, max_size=8),
       st.floats(1e-6, 1e3))
def test_factor_is_scale_invariant(ratios, scale):
    a, b, ref = CostCalibrator(), CostCalibrator(), JCal()
    for i, r in enumerate(ratios):
        t = 1e-5 * (i + 1)
        a.update("gemm", "c", t, r * t)
        ref.update("gemm", "c", t, r * t)
        b.update("gemm", "c", scale * t, scale * (r * t))
    assert _state(a) == _state(ref)
    assert math.isclose(a.factor("gemm", "c"), b.factor("gemm", "c"),
                        rel_tol=1e-6)


@settings(max_examples=20, deadline=None)
@given(st.floats(0.2, 5.0), st.integers(1, 40))
def test_constant_bias_converges_immediately_and_stays(bias, n):
    cal = CostCalibrator()
    for _ in range(n):
        cal.update("gemm", "c", 1.0, bias)
    assert math.isclose(cal.factor("gemm", "c"), bias, rel_tol=1e-9)
    assert math.isclose(cal.correct("gemm", "c", 2.0), 2.0 * bias, rel_tol=1e-9)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.floats(1e-6, 1.0), min_size=2, max_size=6),
       st.floats(0.25, 4.0))
def test_equal_ratios_never_flip_a_modeled_ordering(times, ratio):
    cal = CostCalibrator()
    classes = [f"c{i}" for i in range(len(times))]
    for ck in classes:
        cal.update("gemm", ck, 1.0, ratio)
    corrected = [cal.correct("gemm", ck, t) for ck, t in zip(classes, times)]
    for i in range(len(times)):
        for j in range(len(times)):
            if times[i] < times[j]:
                assert corrected[i] <= corrected[j]


@settings(max_examples=30, deadline=None)
@given(st.floats(0.2, 5.0))
def test_drift_fires_iff_bias_exceeds_threshold(bias):
    port, ref = CostCalibrator(), JCal()
    port.update("gemm", "c", 1.0, bias)
    ref.update("gemm", "c", 1.0, bias)
    fired = port.stale_classes() == [("gemm", "c")]
    assert fired == (abs(math.log(bias)) > port.drift_threshold)
    assert port.stale_classes() == ref.stale_classes()


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(FAMILIES),
                          st.sampled_from(["c0", "c1", "c2"]),
                          st.floats(0.25, 4.0)),
                min_size=1, max_size=12))
def test_roundtrip_preserves_factors_for_any_update_stream(updates):
    port, ref = CostCalibrator(), JCal()
    for fam, ck, r in updates:
        port.update(fam, ck, 1.0, r)
        ref.update(fam, ck, 1.0, r)
    back = CostCalibrator.from_json(ref.to_json())
    assert _state(back) == _state(port) == _state(ref)


# ------------------------------------------------------------ controller
GEMMS = [(64, 2048, 2048), (16, 1024, 4096), (8, 512, 2048), (8, 1536, 2048)]
ATTN = (8, 8, 2, 1, 512, 64)
SCAN = (8, 1, 8, 64, 32)


def _descs(spec):
    """Port and reference descriptors of ``spec`` (("gemm"|"attn"|"scan",
    args) pairs)."""
    kinds = {"gemm": (GemmDesc, JDesc), "attn": (AttentionDesc, JAttn),
             "scan": (ScanDesc, JScan)}
    port = [kinds[k][0](*a) for k, a in spec]
    ref = [kinds[k][1](*a) for k, a in spec]
    assert [d.key() for d in port] == [d.key() for d in ref]
    return port, ref


ALL = [("gemm", g) for g in GEMMS] + [("attn", ATTN), ("scan", SCAN)]


def _calibrators(seed: int):
    """A port and a reference calibrator fed the same seeded biases for
    the classes of `ALL`, a few classes left unobserved."""
    rng = np.random.default_rng(seed)
    port, ref = CostCalibrator(), JCal()
    pdescs, _ = _descs(ALL)
    for d in pdescs:
        if rng.random() < 0.25:
            continue
        bias = float(np.exp(rng.normal(0.0, 1.2)))
        for _ in range(int(rng.integers(1, 4))):
            r = bias * float(np.exp(rng.normal(0.0, 0.1)))
            port.update(family_of(d), compat_key(d), 1.0, r)
            ref.update(family_of(d), compat_key(d), 1.0, r)
    return port, ref


def _controllers(seed: int):
    port, ref = _calibrators(seed)
    return (ConcurrencyController(GOLibrary(), calibrator=port),
            JCtrl(library=JLib(), calibrator=ref))


def _plan(sched):
    return [(g.indices, g.cd, g.mode, g.tile.key(),
             [t.key() for t in g.tiles] if g.tiles else None, g.modeled_time_s)
            for g in sched.groups]


@pytest.mark.parametrize("seed", range(4))
def test_group_factor_is_bitwise_equal(seed):
    pctrl, jctrl = _controllers(seed)
    pdescs, jdescs = _descs(ALL)
    rng = np.random.default_rng(100 + seed)
    for _ in range(20):
        idx = sorted(rng.choice(len(ALL), size=int(rng.integers(1, len(ALL) + 1)),
                                replace=False))
        assert pctrl._group_factor([pdescs[i] for i in idx]) == \
            jctrl._group_factor([jdescs[i] for i in idx])


BUNDLES = [
    [0, 0, 5, 5], [0, 5, 4, 1], [0, 0, 0, 0, 5, 5, 4, 4], [5, 4], [0] * 6,
    [2, 2, 3, 1, 4, 5, 0],
]


@pytest.mark.parametrize("available", [None, 4, 2])
@pytest.mark.parametrize("seed", range(3))
def test_calibrated_plan_mixed_matches_reference(seed, available):
    pctrl, jctrl = _controllers(seed)
    for bundle in BUNDLES:
        pdescs, jdescs = _descs([ALL[i] for i in bundle])
        got = pctrl.plan_mixed(pdescs, available=available)
        assert _plan(got) == _plan(jctrl.plan_mixed(jdescs, available=available))
        gemms = [d for d in pdescs if isinstance(d, GemmDesc)]
        if gemms:
            jg = [d for d in jdescs if isinstance(d, JDesc)]
            assert _plan(pctrl.plan(gemms)) == _plan(jctrl.plan(jg))


def test_calibration_moves_a_chunking_and_keeps_raw_times():
    """A heavy bias on the scan's class changes which chunking wins in
    both packages alike; the chosen plan carries raw modeled times."""
    lib, jlib = GOLibrary(), JLib()
    pdescs, jdescs = _descs([ALL[i] for i in [0, 0, 0, 0, 5, 5, 4, 4]])
    base = ConcurrencyController(lib).plan_mixed(pdescs)
    moved = 0
    for bias in (0.05, 0.2, 5.0, 20.0):
        port, ref = CostCalibrator(), JCal()
        for cal in (port, ref):
            cal.update("mamba_scan", compat_key(pdescs[4]), 1.0, bias)
            cal.update("gemm", compat_key(pdescs[0]), 1.0, 1.0 / bias)
        got = ConcurrencyController(lib, calibrator=port).plan_mixed(pdescs)
        want = JCtrl(library=jlib, calibrator=ref).plan_mixed(jdescs)
        assert _plan(got) == _plan(want)
        moved += _plan(got) != _plan(base)
        for g in got.groups:        # raw modeled times, never corrected
            members = [pdescs[i] for i in g.indices]
            raw = (isolated_time(members[0], g.tile, lib.spec) if g.mode == "single"
                   else group_time(list(zip(members, g.tiles)), lib.spec))
            assert g.modeled_time_s == raw
    assert moved > 0


def test_fuse_vs_group_choice_flips_as_in_the_reference():
    lib, jlib = GOLibrary(), JLib()
    qkv, jqkv = _descs([("gemm", (8, 512, 2048))] * 3)
    fused = GemmDesc(8, 1536, 2048)
    base = ConcurrencyController(lib).plan_shared_input(qkv)
    assert base == JCtrl(library=jlib).plan_shared_input(jqkv)
    port, ref = CostCalibrator(), JCal()
    bias = 8.0 if base[0] == "fuse" else 0.125
    for cal in (port, ref):
        cal.update("gemm", compat_key(fused), 1.0, bias)
    got = ConcurrencyController(lib, calibrator=port).plan_shared_input(qkv)
    assert got == JCtrl(library=jlib, calibrator=ref).plan_shared_input(jqkv)
    assert got[0] != base[0] and got[1:] == base[1:]


def test_empty_calibrator_plans_as_none():
    lib = GOLibrary()
    pdescs, _ = _descs([ALL[i] for i in [0, 0, 5, 4, 1, 1]])
    a = ConcurrencyController(lib)
    b = ConcurrencyController(lib, calibrator=CostCalibrator())
    assert _plan(a.plan_mixed(pdescs)) == _plan(b.plan_mixed(pdescs))
    qkv = [GemmDesc(8, 512, 2048)] * 3
    assert a.plan_shared_input(qkv) == b.plan_shared_input(qkv)


# --------------------------------------------------------------- runtime
WINDOWS = ([8, 8, 8, 8], [4, 8, 8, 8, 16], [8, 8, 8, 8], [1, 2], [4, 8, 8, 8, 16])
BIAS = (3.0, 1.1, 0.4, 1.6, 2.5, 0.9)


def _scripted(modeled_time_s: float, k: int, class_key: str) -> float:
    """The achieved time of the k-th launch: a class's bias (from its
    key) with a deterministic jitter."""
    bias = BIAS[sum(map(ord, class_key)) % len(BIAS)]
    return modeled_time_s * bias * (1.0 + 0.05 * math.sin(k))


def _drive(rt, make_req, retunes):
    cfg = get_arch("qwen3-14b").reduced()
    counter = iter(range(10 ** 6))
    rt._execute = lambda ln: _scripted(ln.plan.modeled_time_s, next(counter),
                                       ln.class_key)
    calls = []
    invalidate = rt.ctrl.lib.invalidate
    rt.ctrl.lib.invalidate = lambda keys: calls.append(sorted(keys)) or invalidate(keys)
    trace = []
    for w, batches in enumerate(WINDOWS):
        for layer in range(2):
            for ti, batch in enumerate(batches):
                for _, bundle in decode_step_descs(cfg, batch, "f32"):
                    for d in bundle:
                        rt.submit(make_req(d), tenant=f"t{ti}", now=float(w))
        if w == 1:      # one bundle: the mixed queue never feeds the model
            rt.submit([make_req(d) for _, b in decode_step_descs(cfg, 2, "f32")
                       for d in b], now=float(w))
        launches = rt.drain(now=float(w) + 1.0)
        trace.append((len(launches), rt.pending_retunes(),
                      rt.telemetry.last_flush_evals))
        if w in retunes:
            trace.append(("retune", rt.process_retunes(now=float(w) + 1.0),
                          rt.plan_cache_size, len(rt.ctrl.lib)))
    return trace, calls


def test_feed_calibration_and_process_retunes_match_reference():
    pcal, jcal = CostCalibrator(), JCal()
    prt = Runtime(ConcurrencyController(GOLibrary(), calibrator=pcal),
                  RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    jrt = JRuntime(JCtrl(library=JLib(), calibrator=jcal),
                   JConfig(window_s=0.0, execute=True, interpret=False))
    x = torch.zeros((1, 1))

    def preq(d):
        return GemmRequest(desc=GemmDesc(d.M, d.N, d.K, dtype=d.dtype), a=x, b=x)

    def jreq(d):
        return JReq(desc=JDesc(d.M, d.N, d.K, dtype=d.dtype))

    ptrace, pcalls = _drive(prt, preq, retunes={1, 3})
    jtrace, jcalls = _drive(jrt, jreq, retunes={1, 3})
    assert ptrace == jtrace
    assert pcalls == jcalls and pcalls          # the same keys invalidated
    assert _state(pcal) == _state(jcal)
    assert ("gemm", MIXED_CLASS) not in pcal._state
    assert sorted(prt._class_descs) == sorted(jrt._class_descs)
    assert {k: sorted(v) for k, v in prt._class_descs.items()} == \
        {k: sorted(v) for k, v in jrt._class_descs.items()}
    assert prt.pending_retunes() == jrt.pending_retunes()
    retuned = [t for t in ptrace if t[0] == "retune"]
    assert any(t[1] > 0 and t[2] == 0 for t in retuned), retuned
    assert prt.process_retunes() == jrt.process_retunes()
    assert sorted(prt.ctrl.lib.entries()) == sorted(jrt.ctrl.lib.entries())


def test_warm_flush_with_a_calibrator_evaluates_the_model_zero_times():
    """Executed on the CPU: the first window plans (and may queue a
    re-tune), the second repeats it and is served from the plan cache
    with zero cost-model evaluations, the calibrator fed both times."""
    cal = CostCalibrator()
    rt = Runtime(ConcurrencyController(GOLibrary(), calibrator=cal),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    rng = np.random.default_rng(0)
    descs = [GemmDesc(m, 64, 32, dtype="f32") for m in (8, 8, 4, 16, 8)]

    def window(now):
        for d in descs:
            a = torch.from_numpy(rng.integers(-3, 4, (d.M, d.K)).astype(np.float32))
            b = torch.from_numpy(rng.integers(-3, 4, (d.K, d.N)).astype(np.float32))
            rt.submit(GemmRequest(desc=d, a=a, b=b), now=now)
        return rt.drain(now=now)

    window(0.0)
    n_obs = sum(st.n for st in cal._state.values())
    launches = window(1.0)
    assert launches and all(ln.cache_hit for ln in launches)
    assert rt.telemetry.last_flush_evals == 0
    assert sum(st.n for st in cal._state.values()) == n_obs + len(launches) > n_obs
