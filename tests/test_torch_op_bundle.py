"""The whole decode-step op bundle (§14) in the port vs the JAX package:
attention and SSD-scan descriptors, their family cost models and tuner
entries, `plan_mixed` of `decode_step_op_descs` for full-width Qwen3-14B
and Zamba2-1.2B, and executed bundles through both runtimes.

Planning must agree bitwise (keys, tiles, modeled times).  Executed
results come from the JAX package's Pallas bodies (``interpret=True``)
and the port's plain versions on the CPU, fed the same numpy operands,
within the reference tests' tolerances (3e-2 for bf16 outputs)."""
import warnings
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jget_arch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GOLibrary as JLib
from repro.core.cost_model import TileBatch as JTB
from repro.core.cost_model import group_time as jgroup_time
from repro.core.cost_model import isolated_time as jisolated_time
from repro.core.cost_model import kernel_stats_batch as jkernel_stats_batch
from repro.core.cost_model import op_tile_ws as jop_tile_ws
from repro.core.cost_model import sequential_time as jsequential_time
from repro.core.op_desc import AttentionDesc as JAttn
from repro.core.op_desc import GroupedGemmDesc as JGrouped
from repro.core.op_desc import ScanDesc as JScan
from repro.core.op_desc import op_from_key as jop_from_key
from repro.core.scheduler import bind_operands as jbind
from repro.core.tuner import ATTENTION_TILES as JATTN_TILES
from repro.core.tuner import SCAN_TILES as JSCAN_TILES
from repro.core.tuner import tune_op as jtune_op
from repro.kernels.gemm.ops import TileConfig as JTile
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime.integration import decode_step_op_descs as jop_descs
from repro_torch.configs import get_arch
from repro_torch.core import (
    FAMILIES,
    FAMILY_TILES,
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    GroupedGemmDesc,
    ScanDesc,
    bind_operands,
    execute_schedule,
    op_from_key,
    requests_from_numpy,
    tune_op,
)
from repro_torch.core.cost_model import (
    TileBatch,
    group_time,
    isolated_time,
    kernel_stats_batch,
    op_tile_ws,
    sequential_time,
)
from repro_torch.kernels.gemm import TileConfig
from repro_torch.runtime import MIXED_CLASS, Runtime, RuntimeConfig, decode_step_op_descs

ATTN = [AttentionDesc(16, 40, 8, 1, 4096, 128), AttentionDesc(1, 32, 32, 1, 2048, 64),
        AttentionDesc(2, 4, 2, 130, 250, 32, True, "f32"),
        AttentionDesc(1, 8, 8, 512, 512, 64, False), AttentionDesc(3, 4, 4, 600, 200, 64)]
SCAN = [ScanDesc(16, 1, 64, 64, 64), ScanDesc(1, 4096, 64, 64, 64),
        ScanDesc(2, 70, 3, 16, 8, "f32")]
STATS = ("n_tiles", "waves", "occupancy", "vmem_bytes", "hbm_bytes", "flops",
         "mxu_util", "a_resident", "splits", "streams")
CONFIGS = {"qwen3-14b": 4096, "zamba2-1.2b": 2048}


def _j(d):
    return jop_from_key(d.key())


def _jt(t: TileConfig) -> JTile:
    return JTile(t.bm, t.bn, t.bk, t.split_k, t.stream_k)


def _sched(s):
    return ([(g.indices, g.cd, g.mode, g.tile.key(),
              None if g.tiles is None else [t.key() for t in g.tiles],
              g.modeled_time_s) for g in s.groups], s.cp_overhead_s)


# ------------------------------------------------------------ descriptors
@pytest.mark.parametrize("d", ATTN + SCAN, ids=lambda d: d.key())
def test_descriptor_protocol_matches_reference(d):
    j = _j(d)
    assert type(j).__name__ == type(d).__name__ and j.family == d.family
    for attr in ("flops", "in_bytes", "M", "mnk_like", "dtype"):
        assert getattr(d, attr) == getattr(j, attr), attr
    if isinstance(d, AttentionDesc):
        assert d.causal_credit == j.causal_credit
    else:
        assert d.compute_dtype == j.compute_dtype == "f32" and d.in_bytes == 4
    assert op_from_key(d.key()) == d and d.key() == j.key()


def test_op_from_key_gemm_and_unported_family():
    """Every family's keys invert, the grouped expert GEMM's (once refused
    naming ROADMAP A10) with and without explicit rows."""
    g = GemmDesc(8, 5120, 17408, True, False, "f32")
    assert op_from_key(g.key()) == g and jop_from_key(g.key()).key() == g.key()
    assert set(FAMILIES) == {"gemm", "grouped_gemm", "flash_attention", "mamba_scan"}
    for key in ("gg_4_32_128_256_bf16", "gg_3_5_128_256_f32_r2-0-3"):
        d = op_from_key(key)
        assert isinstance(d, GroupedGemmDesc) and d.key() == key
        assert jop_from_key(key) == JGrouped(d.G, d.M, d.N, d.K, d.dtype, d.rows)


# ------------------------------------------------------------- cost model
@pytest.mark.parametrize("d", ATTN + SCAN, ids=lambda d: d.key())
def test_family_stats_bitwise_over_tiles_and_budgets(d):
    """`kernel_stats_batch` dispatch over the family's tiles × RC and CD
    budgets, `op_tile_ws` and `isolated_time`."""
    tiles = FAMILY_TILES[d.family]
    jtiles = {"flash_attention": JATTN_TILES, "mamba_scan": JSCAN_TILES}[d.family]
    assert [t.key() for t in tiles] == [t.key() for t in jtiles]
    tb = TileBatch.from_tiles(tiles)
    jtb = JTB.from_tiles(jtiles)
    budgets = np.asarray([32 * 2**20, 16 * 2**20, 8 * 2**20, 2 * 2**20, 2**20,
                          2**17], np.int64)[:, None]
    p = kernel_stats_batch(d, tb, budgets)
    j = jkernel_stats_batch(_j(d), jtb, budgets)
    for f in STATS:
        np.testing.assert_array_equal(np.broadcast_to(getattr(p, f), p.waves.shape),
                                      np.broadcast_to(getattr(j, f), j.waves.shape), f)
    np.testing.assert_array_equal(op_tile_ws(d, tb), jop_tile_ws(_j(d), jtb))
    for t in tiles:
        assert isolated_time(d, t) == jisolated_time(_j(d), _jt(t))
        assert op_tile_ws(d, t) == jop_tile_ws(_j(d), _jt(t))


def test_gemm_op_tile_ws_is_the_tile_working_set():
    g, t = GemmDesc(8, 512, 4096), TileConfig(64, 256, 128)
    assert op_tile_ws(g, t) == t.vmem_bytes(2) == jop_tile_ws(_j(g), _jt(t))


@pytest.mark.parametrize("cd", [2, 3, 5, 8])
def test_mixed_group_time_bitwise(cd):
    """A decode bundle's GEMMs, attention and scan in one group, and
    homogeneous non-GEMM groups, through `_group_time_mixed`; GEMM-only
    groups keep the batched fold."""
    members = [(GemmDesc(16, 4096, 2048), TileConfig(16, 128, 128)),
               (ATTN[1], TileConfig(8, 128, 128)),
               (SCAN[0], TileConfig(32, 128, 128)),
               (GemmDesc(16, 2048, 8192), TileConfig(8, 128, 128, split_k=4)),
               (ATTN[0], TileConfig(64, 256, 128)),
               (SCAN[1], TileConfig(512, 128, 128)),
               (GemmDesc(1, 5120, 17408), TileConfig(32, 128, 128, stream_k=8)),
               (ATTN[3], TileConfig(256, 512, 128))][:cd]
    jm = [(_j(d), _jt(t)) for d, t in members]
    assert group_time(members) == jgroup_time(jm)
    assert sequential_time(members) == jsequential_time(jm)
    for d, t in members[1:3]:
        assert group_time([(d, t)] * cd) == jgroup_time([(_j(d), _jt(t))] * cd)
    gemms = [m for m in members if isinstance(m[0], GemmDesc)]
    assert group_time(gemms) == jgroup_time([(_j(d), _jt(t)) for d, t in gemms])


@pytest.mark.parametrize("d", ATTN + SCAN, ids=lambda d: d.key())
def test_tune_op_entries_bitwise(d):
    p, j = tune_op(d), jtune_op(_j(d))
    assert (p.desc_key, p.family, p.isolated.key()) == \
        (j.desc_key, j.family, j.isolated.key())
    assert {c: t.key() for c, t in p.go.items()} == {c: t.key() for c, t in j.go.items()}
    assert p.rc_source == j.rc_source and p.speedup == j.speedup


def test_library_dispatches_by_family():
    lib = GOLibrary()
    descs = [GemmDesc(16, 4096, 2048), ATTN[1], SCAN[0], ATTN[1]]
    assert lib.prewarm(descs) == 3
    assert lib.get(ATTN[1]).family == "flash_attention"
    assert lib.get(SCAN[0]).family == "mamba_scan"
    assert lib.get(descs[0]).family == "gemm"
    jlib = JLib()
    jlib.prewarm([_j(d) for d in descs])
    for d in descs:
        assert lib.get(d).speedup == jlib.get(_j(d)).speedup


# ---------------------------------------------------------------- planning
@pytest.mark.parametrize("name", CONFIGS)
def test_decode_step_op_descs_match_reference(name):
    cfg, jcfg = get_arch(name), jget_arch(name)
    for b in (1, 4, 16):
        p = decode_step_op_descs(cfg, b, CONFIGS[name])
        assert [d.key() for d in p] == [d.key() for d in jop_descs(jcfg, b, CONFIGS[name])]
    fams = [d.family for d in decode_step_op_descs(cfg, 16, CONFIGS[name])]
    if name == "qwen3-14b":
        assert fams == ["gemm"] * 7 + ["flash_attention"]
        assert decode_step_op_descs(cfg, 16, 4096)[-1] == AttentionDesc(
            16, 40, 8, 1, 4096, 128)
    else:
        assert fams == ["gemm"] * 5 + ["flash_attention", "mamba_scan"]
        assert decode_step_op_descs(cfg, 16, 2048)[-2:] == [
            AttentionDesc(16, 32, 32, 1, 2048, 64), ScanDesc(16, 1, 64, 64, 64)]


def test_decode_step_op_descs_refuses_routed_experts():
    """Routed experts, once refused naming ROADMAP A10: the reference's
    bundle, dense per-expert GEMMs and the two grouped pools."""
    moe = dict(n_routed_experts=8, moe_top_k=2, moe_d_ff=64)
    pcfg = replace(get_arch("qwen3-14b"), **moe)
    jcfg = replace(jget_arch("qwen3-14b"), **moe)
    for batch in (1, 4, 16):
        descs = decode_step_op_descs(pcfg, batch)
        assert [d.key() for d in descs] == [d.key() for d in jop_descs(jcfg, batch)]
        assert descs[-2:] == [GroupedGemmDesc(min(8, 2 * batch), 2 * batch, 64, 5120),
                              GroupedGemmDesc(min(8, 2 * batch), 2 * batch, 5120, 64)]


@pytest.mark.parametrize("available", [1, 2, 4, 16])
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_mixed_bitwise_on_full_width_bundles(name, available):
    cfg = get_arch(name)
    lib, jlib = GOLibrary(), JLib()
    for batch in (1, 4, 16):
        descs = decode_step_op_descs(cfg, batch, CONFIGS[name])
        p = ConcurrencyController(lib).plan_mixed(descs, available=available)
        j = JCtrl(jlib).plan_mixed([_j(d) for d in descs], available=available)
        assert _sched(p) == _sched(j)
        members = [descs[i] for g in p.groups for i in g.indices]
        assert sorted(d.key() for d in members) == sorted(d.key() for d in descs)
    four = sorted([d for b in (4, 8, 8, 16)
                   for d in decode_step_op_descs(cfg, b, CONFIGS[name])],
                  key=lambda d: (-d.M, d.key()))
    p = ConcurrencyController(lib).plan_mixed(four, available=available)
    j = JCtrl(jlib).plan_mixed([_j(d) for d in four], available=available)
    assert _sched(p) == _sched(j)


# ---------------------------------------------------------------- execute
def _operands(rng, d, context):
    """Numpy operands of one member: (a, b), (q, k, v) or (xd, da, Bm, Cm)."""
    if isinstance(d, GemmDesc):
        return (rng.standard_normal((d.M, d.K)).astype(np.float32),
                (rng.standard_normal((d.K, d.N)) * d.K ** -0.5).astype(np.float32))
    if isinstance(d, AttentionDesc):
        return (rng.standard_normal((d.B, d.Hq, d.Sq, d.D)).astype(np.float32),
                rng.standard_normal((d.B, d.Hkv, d.Skv, d.D)).astype(np.float32),
                rng.standard_normal((d.B, d.Hkv, d.Skv, d.D)).astype(np.float32))
    return (rng.standard_normal((d.B, d.T, d.H, d.P)).astype(np.float32),
            -np.abs(rng.standard_normal((d.B, d.T, d.H))).astype(np.float32) * 0.3,
            rng.standard_normal((d.B, d.T, d.H, d.N)).astype(np.float32) * 0.5,
            rng.standard_normal((d.B, d.T, d.H, d.N)).astype(np.float32) * 0.5)


def _serve_both(name: str, context: int = 136, seed: int = 0):
    """Per layer (two of the reduced configuration's), tenants at batches
    [1, 4] submit their layer's whole op bundle, and both runtimes drain;
    once with 16 slots, once with 2."""
    pcfg, jcfg = get_arch(name).reduced(), jget_arch(name).reduced()
    jrt = JRuntime(JCtrl(JLib()), JConfig(window_s=0.0, execute=True, interpret=True))
    prt = Runtime(ConcurrencyController(GOLibrary()),
                  RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    rng = np.random.default_rng(seed)
    out = dict(jh=[], ph=[], jl=[], pl=[])
    for w, available in enumerate((16, 2)):
        jrt.set_available(available)
        prt.set_available(available)
        for layer in range(min(pcfg.n_layers, 2)):
            now = float(w) + layer * 0.01
            for ti, batch in enumerate((1, 4)):
                descs = decode_step_op_descs(pcfg, batch, context)
                assert [d.key() for d in descs] == [
                    d.key() for d in jop_descs(jcfg, batch, context)]
                ops = [_operands(rng, d, context) for d in descs]
                out["jh"].append(jrt.submit(
                    [jbind(_j(d), tuple(jnp.asarray(x).astype(jnp.bfloat16) for x in o))
                     for d, o in zip(descs, ops)], tenant=f"t{ti}", now=now))
                out["ph"].append(prt.submit(requests_from_numpy(
                    [bind_operands(d) for d in descs], ops, device="cpu"),
                    tenant=f"t{ti}", now=now))
            out["jl"] += jrt.drain(now=now)
            out["pl"] += prt.drain(now=now)
    return jrt, prt, out


def _launch(ln):
    return (ln.class_key, ln.plan.mode, ln.plan.cd,
            [t.key() for t in (ln.plan.tiles or [ln.plan.tile])],
            [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
            ln.end_t, ln.cache_hit)


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return request.param, _serve_both(request.param)


def test_op_bundle_launches_identical(served):
    name, (jrt, prt, o) = served
    assert [_launch(x) for x in o["pl"]] == [_launch(x) for x in o["jl"]]
    assert {x.class_key for x in o["pl"]} == {MIXED_CLASS}
    fams = {tk.desc.family for x in o["pl"] for tk in x.tickets}
    want = {"gemm", "flash_attention"} | ({"mamba_scan"} if "zamba" in name else set())
    assert fams == want
    assert prt.device_free_t == jrt.device_free_t


def test_op_bundle_results_match(served):
    _, (_, _, o) = served
    assert len(o["ph"]) == len(o["jh"])
    for ph, jh in zip(o["ph"], o["jh"]):
        assert ph.done and (ph.seq, ph.done_t) == (jh.seq, jh.done_t)
        for p, j in zip(ph.members, jh.members):
            assert p.desc.key() == j.desc.key()
            np.testing.assert_allclose(
                p.result.float().numpy(),
                np.asarray(jnp.asarray(j.result).astype(jnp.float32)),
                rtol=3e-2, atol=3e-2)


def test_single_member_chunk_dispatches_by_family():
    """`plan_mixed` turns a chunk of one into a ``single`` launch; an
    attention or scan member there runs through its family op."""
    descs = [AttentionDesc(2, 4, 2, 1, 64, 32, True, "f32"), ScanDesc(2, 1, 3, 16, 8, "f32")]
    sched = ConcurrencyController(GOLibrary()).plan_mixed(descs, available=1)
    assert [g.mode for g in sched.groups] == ["single", "single"]
    rng = np.random.default_rng(1)
    ops = [_operands(rng, d, 64) for d in descs]
    reqs = requests_from_numpy([bind_operands(d) for d in descs], ops, device="cpu")
    outs = execute_schedule(reqs, sched)
    assert outs[0].shape == (2, 4, 1, 32) and outs[1].shape == (2, 1, 3, 16)


def test_bundle_admission_of_op_families():
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    attn = AttentionDesc(1, 2, 2, 1, 16, 8, True, "f32")
    with pytest.raises(ValueError, match="operands"):
        rt.submit([GemmRequest(desc=attn)])
    (r,) = requests_from_numpy([bind_operands(attn)],
                               [_operands(np.random.default_rng(0), attn, 16)],
                               device="cpu")
    assert r.inputs[0].shape == (1, 2, 1, 8) and r.a is None
    t = rt.submit(r)      # a lone op enters its own class queue
    assert rt.queue_depths() == {attn.key(): 1}
    (launch,) = rt.drain()
    assert launch.class_key == attn.key() and launch.plan.mode == "single"
    assert t.result.shape == (1, 2, 1, 8)
    rt.submit([r])
    (launch,) = rt.drain()
    assert launch.plan.mode == "single" and launch.tickets[0].result.shape == (1, 2, 1, 8)
