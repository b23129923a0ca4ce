"""The port's planning core vs the JAX reference: descriptors, tile keys,
cost model, tuner, GO library, controller plans and configs.  Every
comparison is exact — the port runs the reference's float64 NumPy model,
so equal inputs must give bitwise-equal numbers."""
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro.core.cost_model as jcm
import repro_torch.core.cost_model as pcm
from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.core import ConcurrencyController as JCtrl
from repro.core import GemmDesc as JDesc
from repro.core import GOLibrary as JLib
from repro.core import compat_key as jcompat
from repro.core import split_spans as jsplit
from repro.core.predictor import generate_gemm_pool
from repro.core.tuner import tune_gemm as jtune
from repro.core.tuner import tune_gemm_batch as jtune_batch
from repro.kernels.gemm import TileConfig as JTile
from repro.runtime import decode_step_descs as jdecode_descs
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.core import ConcurrencyController as PCtrl
from repro_torch.core import GemmDesc as PDesc
from repro_torch.core import GOLibrary as PLib
from repro_torch.core import compat_key as pcompat
from repro_torch.core import split_spans as psplit
from repro_torch.core.tuner import tune_gemm as ptune
from repro_torch.core.tuner import tune_gemm_batch as ptune_batch
from repro_torch.kernels.gemm import TileConfig as PTile
from repro_torch.runtime import decode_step_descs as pdecode_descs

GOLIB = Path(__file__).resolve().parents[1] / "results" / "golib.json"
POOL = generate_gemm_pool(48, seed=5)
QWEN_DECODE = [(M, N, K) for M in (1, 4, 8, 16)
               for N, K in ((7168, 5120), (5120, 5120), (34816, 5120),
                            (5120, 17408))]
TILES = [(8, 128, 128, 1, 0), (16, 256, 512, 1, 0), (64, 128, 256, 4, 0),
         (128, 512, 128, 1, 6), (512, 256, 256, 8, 0), (32, 128, 128, 1, 3)]
CD_GRID = (1, 2, 3, 4, 5, 6, 7, 8, 16)


def _pd(d: JDesc) -> PDesc:
    return PDesc(d.M, d.N, d.K, d.ta, d.tb, d.dtype, d.batch)


def _jd(M, N, K, ta=False, tb=False, dtype="bf16"):
    return JDesc(M, N, K, ta, tb, dtype)


def _entry(e):
    """A GO entry as plain data (tiles as keys)."""
    return (e.desc_key, e.isolated.key(),
            {cd: t.key() for cd, t in e.go.items()}, dict(e.rc_source),
            dict(e.speedup), e.family, dict(e.measured), e.measure_backend,
            e.measure_samples, e.measure_run_id)


def _sched(s):
    return ([(g.indices, g.cd, g.tile.key(), g.mode, g.modeled_time_s)
             for g in s.groups], s.cp_overhead_s)


# ---------------------------------------------------------- descriptors
@pytest.mark.parametrize("d", POOL[:16] + [_jd(8, 34816, 5120),
                                           JDesc(4, 64, 32, True, False, "f32", 3)])
def test_desc_key_flops_identical(d):
    p = _pd(d)
    assert p.key() == d.key()
    assert p.flops == d.flops and p.in_bytes == d.in_bytes
    assert PDesc.from_key(d.key()) == p
    assert pcompat(p) == jcompat(d)


@pytest.mark.parametrize("t", TILES + [(256, 256, 256, 1, 0)])
def test_tile_key_and_working_set_identical(t):
    assert PTile(*t).key() == JTile(*t).key()
    assert PTile(*t).vmem_bytes(2) == JTile(*t).vmem_bytes(2)
    assert PTile(*t[:3]) == PTile(*t[:3], 1, 0)
    with pytest.raises(ValueError):
        PTile(8, 128, 128, split_k=2, stream_k=2)


@pytest.mark.parametrize("total,parts", [(1, 1), (7, 3), (16, 4), (5, 9), (40, 6)])
def test_split_spans_identical(total, parts):
    assert psplit(total, parts) == jsplit(total, parts)


# ----------------------------------------------------------- cost model
@pytest.mark.parametrize("shape", QWEN_DECODE[::3] + [(300, 200, 180), (2048, 4096, 1024)])
def test_cost_model_scalar_paths_bitwise(shape):
    jd = _jd(*shape)
    pd = _pd(jd)
    for t in TILES:
        jt, pt = JTile(*t), PTile(*t)
        assert pcm.isolated_time(pd, pt) == jcm.isolated_time(jd, jt)
        ps = pcm.kernel_stats_batch(pd, pt, vmem_budget=2**22)
        js = jcm.kernel_stats_batch(jd, jt, vmem_budget=2**22)
        for f in dataclasses.fields(js):
            np.testing.assert_array_equal(getattr(ps, f.name), getattr(js, f.name))
        for cd in CD_GRID:
            assert pcm.group_time([(pd, pt)] * cd) == jcm.group_time([(jd, jt)] * cd)
    mixed_j = [(_jd(8, 5120, 17408), JTile(*TILES[0])),
               (_jd(16, 5120, 17408), JTile(*TILES[1])),
               (_jd(4, 5120, 17408, dtype="f32"), JTile(*TILES[3]))]
    mixed_p = [(_pd(d), PTile(*dataclasses.astuple(t))) for d, t in mixed_j]
    assert pcm.group_time(mixed_p) == jcm.group_time(mixed_j)
    assert pcm.sequential_time(mixed_p) == jcm.sequential_time(mixed_j)


def test_cost_model_batch_paths_bitwise():
    descs = [_pd(d) for d in POOL[:24]]
    jdescs = POOL[:24]
    pdb, jdb = pcm.DescBatch.from_descs(descs), jcm.DescBatch.from_descs(jdescs)
    ptb = pcm.TileBatch.from_tiles([PTile(*t) for t in TILES])
    jtb = jcm.TileBatch.from_tiles([JTile(*t) for t in TILES])
    p2 = pcm.DescBatch(**{k: getattr(pdb, k)[:, None] for k in
                          ("M", "N", "K", "batch", "in_bytes", "ta", "tb", "f32")})
    j2 = jcm.DescBatch(**{k: getattr(jdb, k)[:, None] for k in
                          ("M", "N", "K", "batch", "in_bytes", "ta", "tb", "f32")})
    for budget in (None, 2**23, np.asarray([2**20, 2**24])[:, None, None]):
        np.testing.assert_array_equal(
            pcm.isolated_time_batch(p2, ptb, vmem_budget=budget, bw_frac=0.5),
            jcm.isolated_time_batch(j2, jtb, vmem_budget=budget, bw_frac=0.5))
    for d in descs[:6]:
        np.testing.assert_array_equal(
            pcm.group_time_batch(d, ptb, CD_GRID),
            jcm.group_time_batch(JDesc.from_key(d.key()), jtb, CD_GRID))


def test_eval_counter_counts_like_reference():
    d = _jd(8, 5120, 17408)
    jcm.EVAL_COUNTER.reset()
    pcm.EVAL_COUNTER.reset()
    jtune(d)
    ptune(_pd(d))
    assert pcm.EVAL_COUNTER.snapshot() == jcm.EVAL_COUNTER.snapshot()


# ---------------------------------------------------------------- tuner
@pytest.mark.parametrize("shape", QWEN_DECODE)
def test_tune_gemm_identical_on_decode_shapes(shape):
    jd = _jd(*shape)
    assert _entry(ptune(_pd(jd))) == _entry(jtune(jd))


def test_tune_gemm_batch_identical_on_pool_sample():
    got = ptune_batch([_pd(d) for d in POOL])
    want = jtune_batch(POOL)
    assert [_entry(e) for e in got] == [_entry(e) for e in want]


def test_tuner_infeasible_path_identical():
    """A spec too small for some RC fraction takes the FALLBACK_TILE path."""
    jspec = jcm.TPUSpec(vmem_bytes=2**17)
    pspec = pcm.TPUSpec(vmem_bytes=2**17)
    descs = [_jd(64, 4096, 4096), _jd(8, 128, 128)]
    assert [_entry(e) for e in ptune_batch([_pd(d) for d in descs], pspec)] == \
        [_entry(e) for e in jtune_batch(descs, jspec)]


def test_go_entry_cd_lookup_identical():
    jd = _jd(8, 5120, 17408)
    je, pe = jtune(jd), ptune(_pd(jd))
    for cd in range(0, 20):
        assert pe.tile_for_cd(cd).key() == je.tile_for_cd(cd).key()
    for th in (1.0, 1.05, 1.5):
        assert pe.preferred_cd(th) == je.preferred_cd(th)


# -------------------------------------------------------------- library
def _load(cls, path):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cls(path)


def test_both_libraries_load_committed_golib_identically():
    jl, pl = _load(JLib, GOLIB), _load(PLib, GOLIB)
    assert len(pl) == len(jl) > 0
    assert pl.loaded_schema == jl.loaded_schema
    assert {k: _entry(e) for k, e in pl.entries().items()} == \
        {k: _entry(e) for k, e in jl.entries().items()}


def test_library_files_cross_load(tmp_path):
    """Each package reads what the other writes, entry for entry, and the
    two writers produce the same bytes."""
    descs = [_jd(*s) for s in QWEN_DECODE[:6]]
    jl, pl = JLib(), PLib()
    jl.prewarm(descs)
    pl.prewarm([_pd(d) for d in descs])
    key = descs[0].key()
    for e in (pl.entries()[key], jl.entries()[key]):   # v5 measured fields
        e.measured = {4: 1.25e-4}
        e.measure_backend, e.measure_samples, e.measure_run_id = "gpu", 3, "r1"
    jl.save(tmp_path / "j.json")
    pl.save(tmp_path / "p.json")
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "p.json").read_bytes()
    back_p, back_j = _load(PLib, tmp_path / "j.json"), _load(JLib, tmp_path / "p.json")
    assert {k: _entry(e) for k, e in back_p.entries().items()} == \
        {k: _entry(e) for k, e in back_j.entries().items()}


@pytest.mark.parametrize("blob", ["{not json", '{"schema": "x", "entries": {}}',
                                  '{"schema": 5, "entries": []}'])
def test_library_unusable_file_leaves_it_empty(tmp_path, blob):
    p = tmp_path / "lib.json"
    p.write_text(blob)
    with pytest.warns(UserWarning, match="unusable"):
        lib = PLib(p)
    assert len(lib) == 0 and lib.loaded_schema is None


# ------------------------------------------------------------ controller
def _queue(batches, shapes):
    return [_jd(b, n, k) for b in batches for n, k in shapes]


@pytest.mark.parametrize("descs,available", [
    (_queue([8, 8, 8, 8], [(7168, 5120), (5120, 17408)]), None),
    (_queue([4, 8, 8, 8, 16], [(7168, 5120), (5120, 5120), (5120, 17408)]), None),
    (_queue([1, 4, 8, 16] * 3, [(5120, 17408)]), 5),
    (_queue([8] * 20, [(34816, 5120)]), None),
    (_queue([2, 3], [(256, 128)]) + POOL[:10], 3),
])
def test_plans_identical(descs, available):
    jc, pc = JCtrl(JLib()), PCtrl(PLib())
    pdescs = [_pd(d) for d in descs]
    assert _sched(pc.plan(pdescs, available=available)) == \
        _sched(jc.plan(descs, available=available))
    jg, jrest = jc.plan_group(descs, list(range(len(descs))), available)
    pg, prest = pc.plan_group(pdescs, list(range(len(descs))), available)
    assert prest == jrest
    assert (pg.indices, pg.cd, pg.tile.key(), pg.mode, pg.modeled_time_s) == \
        (jg.indices, jg.cd, jg.tile.key(), jg.mode, jg.modeled_time_s)


@pytest.mark.parametrize("bundle", [
    [(7168 - 2048, 5120), (1024, 5120), (1024, 5120)],
    [(17408, 5120), (17408, 5120)],
    [(64, 128), (32, 128), (32, 128)],
])
@pytest.mark.parametrize("batch", [1, 8, 16])
def test_plan_shared_input_identical(bundle, batch):
    descs = [_jd(batch, n, k) for n, k in bundle]
    assert PCtrl(PLib()).plan_shared_input([_pd(d) for d in descs]) == \
        JCtrl(JLib()).plan_shared_input(descs)


# ---------------------------------------------------------------- configs
def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def test_qwen3_14b_config_identical():
    assert dataclasses.asdict(get_arch("qwen3-14b")) == \
        dataclasses.asdict(jget_arch("qwen3-14b"))


@pytest.mark.parametrize("name", jlist_archs())
def test_reduced_and_decode_descs_identical(name):
    """`reduced()` and `decode_step_descs` follow the reference for every
    architecture the reference registers (the port registers Qwen3-14B)."""
    jcfg = jget_arch(name)
    pcfg = _port_cfg(jcfg)
    assert dataclasses.asdict(pcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    for cfg_j, cfg_p in ((jcfg, pcfg), (jcfg.reduced(), pcfg.reduced())):
        for batch in (1, 8):
            want = [(t, [d.key() for d in ds])
                    for t, ds in jdecode_descs(cfg_j, batch)]
            got = [(t, [d.key() for d in ds])
                   for t, ds in pdecode_descs(cfg_p, batch)]
            assert got == want
