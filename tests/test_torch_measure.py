"""The port's measurement harness (`repro_torch/core/measure.py`) against
the reference's (`repro/core/measure.py`).

Outlier rejection and run ids are held bitwise; the timing discipline
(warmup exclusion, median-of-k, MAD rejection, the watchdog and its hang
counter) is checked with a scripted clock on the CPU backend, as the
reference's tests check it; the measured re-rank is held to the
reference's, call by call, with both harnesses' `measure_group` stubbed
to one table of times.  Real CPU measurements run the plain versions
through the scheduler's launch shapes; the card's timings are
`tests/test_torch_card.py`'s and `chip_smoke.py`'s."""
import hashlib
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import GemmDesc as JDesc
from repro.core import Measurer as JMeasurer
from repro.core import measure as jm
from repro.core.op_desc import AttentionDesc as JAttn
from repro.core.op_desc import ScanDesc as JScan
from repro.core.tuner import tune_gemm as jtune_gemm
from repro.core.tuner import tune_op as jtune_op
from repro.kernels.gemm import TileConfig as JTile
from repro_torch.core import (
    AttentionDesc,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    Measurer,
    ScanDesc,
    backend_tag,
    execute_schedule,
    tune_gemm,
    tune_op,
)
from repro_torch.core import measure as pm
from repro_torch.kernels.gemm import TileConfig

GEMM = GemmDesc(8, 128, 128, dtype="f32")


class ScriptedClock:
    """Timestamps that make iteration i appear to take durations[i]
    seconds: each CPU sample reads the clock twice around the launch."""

    def __init__(self, durations):
        self._times = []
        t = 0.0
        for d in durations:
            self._times += [t, t + d]
            t += d
        self._i = 0

    def __call__(self):
        v = self._times[self._i]
        self._i += 1
        return v


def _cpu(**kw):
    return Measurer(device="cpu", **kw)


def _iso(desc=GEMM):
    return tune_gemm(desc).isolated


# --------------------------------------------------------- bitwise logic
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [4.0, 2.0, 0.5])
def test_reject_outliers_bitwise(seed, k):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 12))
    vals = list(rng.lognormal(-7.0, 0.3, size=n))
    if n > 3:
        vals[int(rng.integers(n))] *= 50.0          # one wild sample
    if seed % 3 == 0:
        vals = [vals[0]] * n                        # MAD = 0
    assert pm.reject_outliers(vals, k) == jm.reject_outliers(vals, k)


def test_reject_outliers_edge_cases():
    assert pm.reject_outliers([1.0, 9.0]) == [1.0, 9.0]
    assert pm.reject_outliers([0.0, 0.0, 0.0]) == [0.0, 0.0, 0.0]
    assert pm.reject_outliers([2.0] * 5) == [2.0] * 5
    assert pm.reject_outliers([1.0, 1.0, 1.0, 1.0, 50.0]) == [1.0] * 4
    assert len(pm.reject_outliers([1.0, 1e6, -1e6])) == 3


@pytest.mark.parametrize("seed", range(4))
def test_run_key_bitwise(seed):
    rng = np.random.default_rng(seed)
    keys = [f"{int(rng.integers(1, 9999))}_128_256_00_bf16"
            for _ in range(int(rng.integers(1, 5)))]
    tiles = []
    for _ in range(int(rng.integers(1, 3))):
        split = int(rng.choice([1, 2, 4]))
        tiles.append(tuple(int(x) for x in rng.choice([8, 16, 128, 256], 3))
                     + (split, 0 if split > 1 else int(rng.integers(0, 4))))
    args = (int(rng.integers(0, 17)), "cpu", int(rng.integers(0, 3)),
            int(rng.integers(1, 6)), int(rng.integers(0, 9)))
    assert pm._run_key(keys, [TileConfig(*t) for t in tiles], *args) == \
        jm._run_key(keys, [JTile(*t) for t in tiles], *args)


# ------------------------------------------------------------ discipline
def test_warmup_iterations_are_excluded():
    clk = ScriptedClock([100.0, 1.0, 1.0, 1.0])
    m = _cpu(warmup=1, repeats=3, clock=clk).measure_group(GEMM, _iso(), cd=1)
    assert m.time_s == 1.0
    assert m.n == 3 and m.samples == (1.0, 1.0, 1.0)


def test_median_robust_to_one_injected_outlier():
    clk = ScriptedClock([1.0, 1.0, 1.0, 1.0, 50.0])
    m = _cpu(warmup=0, repeats=5, clock=clk).measure_group(GEMM, _iso(), cd=1)
    assert m.time_s == 1.0 and m.n == 4


def test_median_of_k_not_mean():
    clk = ScriptedClock([4.0, 1.0, 1.0])
    m = _cpu(warmup=0, repeats=3, clock=clk).measure_group(GEMM, _iso(), cd=1)
    assert m.time_s == 1.0


def test_watchdog_flags_hung_sample_and_median_survives():
    clk = ScriptedClock([1e-3, 1e-3, 1e-3, 10.0, 1e-3, 1e-3])
    mzr = _cpu(warmup=1, repeats=5, clock=clk, deadline_s=1.0)
    m = mzr.measure_group(GEMM, _iso(), cd=1)
    assert m.hangs == 1 and mzr.hangs == 1
    assert m.time_s == pytest.approx(1e-3) and m.finite
    assert not any(math.isinf(v) for v in m.samples)


def test_watchdog_all_hung_yields_nonfinite_measurement():
    clk = ScriptedClock([5.0, 5.0, 5.0, 5.0])
    mzr = _cpu(warmup=1, repeats=3, clock=clk, deadline_s=1.0)
    m = mzr.measure_group(GEMM, _iso(), cd=1)
    assert m.hangs == 3 and math.isinf(m.time_s) and not m.finite


def test_watchdog_hang_counter_accumulates_across_measurements():
    clk = ScriptedClock([1e-3, 10.0, 1e-3, 1e-3,
                         1e-3, 1e-3, 10.0, 10.0])
    mzr = _cpu(warmup=1, repeats=3, clock=clk, deadline_s=1.0)
    assert mzr.measure_group(GEMM, _iso()).hangs == 1
    assert mzr.measure_group(GEMM, _iso()).hangs == 2
    assert mzr.hangs == 3


def test_no_deadline_means_no_watchdog():
    clk = ScriptedClock([1e-3, 1e-3, 100.0, 1e-3, 1e-3])
    mzr = _cpu(warmup=1, repeats=4, clock=clk)
    m = mzr.measure_group(GEMM, _iso(), cd=1)
    assert m.hangs == 0 and mzr.hangs == 0 and m.finite


# -------------------------------------------------------------- adapters
@pytest.mark.parametrize("pdesc,jdesc", [
    (GemmDesc(8, 128, 64, False, False, "f32"), JDesc(8, 128, 64, False, False, "f32")),
    (GemmDesc(8, 128, 64, True, True, "bf16"), JDesc(8, 128, 64, True, True, "bf16")),
    (GemmDesc(16, 32, 64, True, False, "bf16"), JDesc(16, 32, 64, True, False, "bf16")),
    (AttentionDesc(2, 4, 2, 1, 128, 64), JAttn(2, 4, 2, 1, 128, 64)),
    (AttentionDesc(1, 4, 4, 8, 64, 32, dtype="f32"),
     JAttn(1, 4, 4, 8, 64, 32, dtype="f32")),
    (ScanDesc(2, 16, 2, 16, 8), JScan(2, 16, 2, 16, 8)),
], ids=lambda d: d.key() if hasattr(d, "key") else "")
def test_synth_request_shapes_and_dtypes_match_reference(pdesc, jdesc):
    p, j = pm.synth_request(pdesc, seed=3, device="cpu"), jm.synth_request(jdesc, seed=3)
    pops = p.operands
    jops = (j.a, j.b) if isinstance(jdesc, JDesc) else j.inputs
    assert [tuple(t.shape) for t in pops] == [tuple(x.shape) for x in jops]
    assert [str(t.dtype).split(".")[-1] for t in pops] == \
        [str(x.dtype) for x in jops]
    again = pm.synth_request(pdesc, seed=3, device="cpu").operands
    assert all(torch.equal(a, b) for a, b in zip(pops, again))
    if isinstance(pdesc, ScanDesc):
        assert bool((pops[1] <= 0).all())            # decay exponents


def test_gemm_measurement_executes_the_real_launch():
    req = pm.synth_request(GEMM, seed=0, device="cpu")
    (out,) = execute_schedule([req], pm.schedule_for(GEMM, _iso(), cd=1))
    torch.testing.assert_close(out, req.a @ req.b, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("desc", [
    AttentionDesc(2, 4, 4, 1, 128, 64, dtype="f32"),
    ScanDesc(2, 16, 2, 16, 16, "f32"),
], ids=lambda d: d.family)
def test_op_families_round_trip_through_scheduler_adapters(desc):
    entry = tune_op(desc)
    mzr = _cpu(warmup=0, repeats=1)
    solo = mzr.measure_group(desc, entry.isolated, cd=1)
    conc = mzr.measure_group(desc, entry.tile_for_cd(2), cd=2)
    assert solo.finite and conc.finite and solo.run_id != conc.run_id


def test_shadow_and_batched_requests_are_refused():
    sched = pm.schedule_for(GEMM, _iso(), cd=1)
    with pytest.raises(ValueError, match="shadow"):
        _cpu(warmup=0, repeats=1).measure_schedule([GemmRequest(desc=GEMM)], sched)
    with pytest.raises(ValueError, match="shadow-only"):
        pm.synth_request(GemmDesc(8, 64, 64, batch=2, dtype="f32"), device="cpu")


def test_operands_off_the_measurers_device_are_refused():
    """A CUDA Measurer timing CPU operands would time the plain version's
    absence on the card; the check refuses any operand off its device."""
    mzr = _cpu(warmup=0, repeats=1)
    mzr.device = torch.device("meta")
    req = pm.synth_request(GEMM, device="cpu")
    with pytest.raises(ValueError, match="Measurer on meta"):
        mzr.measure_schedule([req], pm.schedule_for(GEMM, _iso(), cd=1))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_measurer_defaults_to_cuda_and_raises_without_it(no_cuda):
    for make in (Measurer, backend_tag,
                 lambda: pm.synth_request(GEMM)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.main(["--cells", "1"])
    assert backend_tag("cpu") == "cpu"


# --------------------------------------------------------------- re-rank
def _time_table(tile_key: str, cd: int) -> float:
    """A fixed, tie-rich table of seconds per (tile, CD): four levels."""
    h = int(hashlib.sha1(f"{tile_key}|{cd}".encode()).hexdigest()[:8], 16)
    return 1e-4 * (1 + h % 4) * cd


def _stub(mzr, calls):
    def measure_group(desc, tile, cd=1):
        calls.append((tile.key(), cd))
        return SimpleNamespace(time_s=_time_table(tile.key(), cd))
    mzr.measure_group = measure_group
    return mzr


RERANK_DESCS = [
    (GemmDesc(8, 5120, 5120), JDesc(8, 5120, 5120)),
    (GemmDesc(8, 34816, 5120), JDesc(8, 34816, 5120)),
    (GemmDesc(1, 5120, 17408), JDesc(1, 5120, 17408)),
    (GemmDesc(2048, 512, 20480, True, False, "f32"),
     JDesc(2048, 512, 20480, True, False, "f32")),
    (GemmDesc(64, 256, 128, dtype="f32"), JDesc(64, 256, 128, dtype="f32")),
    (AttentionDesc(8, 40, 8, 1, 4096, 128), JAttn(8, 40, 8, 1, 4096, 128)),
    (ScanDesc(8, 1, 64, 64, 64), JScan(8, 1, 64, 64, 64)),
]


@pytest.mark.parametrize("cds", [None, (2, 4, 8, 16)], ids=["all", "pow2"])
@pytest.mark.parametrize("pdesc,jdesc", RERANK_DESCS,
                         ids=[p.key() for p, _ in RERANK_DESCS])
def test_rerank_matches_reference_call_by_call(pdesc, jdesc, cds):
    is_gemm = isinstance(pdesc, GemmDesc)
    pentry = tune_gemm(pdesc) if is_gemm else tune_op(pdesc)
    jentry = jtune_gemm(jdesc) if is_gemm else jtune_op(jdesc)
    pcalls, jcalls = [], []
    pnew = _stub(_cpu(warmup=0, repeats=3), pcalls).rerank(pdesc, pentry, cds=cds)
    jnew = _stub(JMeasurer(warmup=0, repeats=3), jcalls).rerank(jdesc, jentry, cds=cds)
    assert pcalls == jcalls
    assert {c: t.key() for c, t in pnew.go.items()} == \
        {c: t.key() for c, t in jnew.go.items()}
    assert pnew.rc_source == jnew.rc_source
    assert pnew.measured == jnew.measured
    assert pnew.speedup == jnew.speedup and pnew.isolated.key() == jnew.isolated.key()
    assert pnew.measure_samples == jnew.measure_samples == 3
    assert pnew.measure_backend == "cpu"
    assert pnew.measure_run_id == jm._run_key(
        [jdesc.key()], [jentry.isolated], 0, "cpu", 0, 3, 0)


# ---------------------------------------------------- real measurements
def test_real_cpu_measurement_is_finite_and_deterministic_id():
    mzr = _cpu(warmup=1, repeats=3)
    a = mzr.measure_group(GEMM, _iso(), cd=1)
    b = mzr.measure_group(GEMM, _iso(), cd=2)
    assert a.finite and b.finite and a.backend == b.backend == "cpu"
    assert a.run_id == mzr.measure_group(GEMM, _iso(), cd=1).run_id != b.run_id
    out = mzr.measure_entry(GEMM, tune_gemm(GEMM), cds=(2, 4))
    assert set(out) == {1, 2, 4} and all(m.finite for m in out.values())


@pytest.mark.parametrize("desc", [GEMM, AttentionDesc(1, 4, 2, 1, 64, 32, dtype="f32")],
                         ids=lambda d: d.family)
def test_tuning_with_measure_survives_library_save_load(desc, tmp_path):
    mzr = _cpu(warmup=0, repeats=1)
    tune = tune_gemm if isinstance(desc, GemmDesc) else tune_op
    entry = tune(desc, measure=mzr, cds=(2,))
    assert set(entry.measured) == {1, 2} and all(t > 0 for t in entry.measured.values())
    assert entry.measure_backend == "cpu" and entry.measure_run_id
    lib = GOLibrary()
    lib._entries[desc.key()] = entry
    lib.save(tmp_path / "golib.json")
    back = GOLibrary(tmp_path / "golib.json").entries()[desc.key()]
    assert back.measured == entry.measured
    assert (back.measure_backend, back.measure_samples, back.measure_run_id) == \
        ("cpu", 1, entry.measure_run_id)


def test_cli_smoke_on_cpu(capsys):
    assert pm.main(["--device", "cpu", "--cells", "2"]) == 0
    out = capsys.readouterr().out
    assert "backend=cpu" in out and "measure-smoke OK" in out


def test_smoke_grid_matches_reference():
    assert [d.key() for d in pm.smoke_grid(8)] == [d.key() for d in jm.smoke_grid(8)]
