"""The MoE expert pool in the port (ROADMAP A10) held to the JAX package on
the same numpy inputs.

- `GroupedGemmDesc`: fields, keys (with and without explicit rows),
  `op_from_key` round trips, `slice` pieces and `slice_plan`'s
  ``"experts"`` spans equal the reference's over hypothesis-drawn G, M
  and row vectors.
- The family's cost model (`grouped_stats_batch`) bitwise over
  `GROUPED_TILES` × budgets, within a few ulp of the reference's scalar
  oracle (ROADMAP C3); `tune_op`'s `GOEntry`, `op_features` and per-class
  plans of identical non-GEMM pools (the ``mixed`` branch of
  `plan_group`) bitwise.
- `grouped_for_desc`'s plain version (the CPU path) against the
  reference's run in interpret mode, zero-row experts included (3e-4 in
  f32, 3e-2 in bf16: `tests/test_kernel_grouped.py`); a sliced pool
  merges bitwise to the unsliced one on integer operands.
- `decode_step_op_descs` and `decode_step_graph` for DeepSeek-V2-Lite-16B
  as the reference's at batches 1, 4, 8 and 16.
- An executing CPU runtime against the reference's, in interpret mode:
  a reduced DeepSeek op bundle, a reduced DeepSeek graph and per-class
  pools of identical attention, scan and grouped ops, with the same
  launches (class, mode, CD, tiles, members, times) and results within
  tolerance; a sliced pool with its weights passed by pointer.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GOLibrary as JLib
from repro.core.cost_model import TileBatch as JTB
from repro.core.cost_model import group_time as jgroup_time
from repro.core.cost_model import grouped_stats_batch as jgrouped_stats_batch
from repro.core.cost_model import isolated_time as jisolated_time
from repro.core.cost_model import op_kernel_stats_ref as jop_kernel_stats_ref
from repro.core.cost_model import op_tile_ws as jop_tile_ws
from repro.core.op_desc import GroupedGemmDesc as JGrouped
from repro.core.op_desc import op_from_key as jop_from_key
from repro.core.op_desc import slice_plan as jslice_plan
from repro.core.predictor import op_features as jop_features
from repro.core.scheduler import bind_operands as jbind
from repro.core.tuner import FAMILY_TILES as JFAMILY_TILES
from repro.core.tuner import GROUPED_TILES as JGROUPED_TILES
from repro.core.tuner import tune_op as jtune_op
from repro.kernels.gemm.ops import TileConfig as JTile
from repro.kernels.grouped_gemm.ops import grouped_for_desc as jgrouped_for_desc
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime import decode_step_graph as jdecode_graph
from repro.runtime.integration import decode_step_op_descs as jop_descs
from repro_torch.configs import get_arch
from repro_torch.core import (
    FAMILY_TILES,
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GOLibrary,
    GroupedGemmDesc,
    ScanDesc,
    bind_operands,
    execute_schedule,
    grouped_stats_batch,
    op_features,
    op_from_key,
    requests_from_numpy,
    slice_plan,
    tune_op,
)
from repro_torch.core.cost_model import (
    TileBatch,
    group_time,
    isolated_time,
    kernel_stats_batch,
    op_tile_ws,
)
from repro_torch.core.measure import synth_request
from repro_torch.core.scheduler import GroupPlan, Schedule
from repro_torch.core.tuner import GROUPED_TILES
from repro_torch.kernels.gemm import TileConfig
from repro_torch.kernels.grouped_gemm import grouped_for_desc, pool_launches
from repro_torch.kernels.grouped_gemm.kernel import ragged_chunks, row_ends
from repro_torch.kernels.grouped_gemm.ops import packing
from repro_torch.runtime import (
    FAMILY_SLOTS,
    MIXED_CLASS,
    OpGraph,
    Runtime,
    RuntimeConfig,
    decode_step_descs,
    decode_step_graph,
    decode_step_op_descs,
)
from repro_torch.runtime.graph import slot_shape
from tests.hypothesis_compat import given, settings, st

STATS = ("n_tiles", "waves", "occupancy", "vmem_bytes", "hbm_bytes", "flops",
         "mxu_util", "a_resident", "splits", "streams")
GROUPED = [
    GroupedGemmDesc(6, 6, 1408, 2048),          # DeepSeek-V2-Lite moe-up, batch 1
    GroupedGemmDesc(64, 96, 1408, 2048),        # batch 16: 32 experts of 2 rows, 32 of 1
    GroupedGemmDesc(64, 96, 2048, 1408),        # moe-down, batch 16
    GroupedGemmDesc(24, 24, 2048, 1408),        # batch 4
    GroupedGemmDesc(5, 40, 320, 96, "f32", rows=(0, 17, 3, 20, 0)),
    GroupedGemmDesc(8, 1000, 512, 256),
]
BUDGETS = np.asarray([32 * 2**20, 16 * 2**20, 8 * 2**20, 2 * 2**20, 2**20, 2**17],
                     np.int64)[:, None]
DEEPSEEK = "deepseek-v2-lite-16b"


def _j(d):
    return jop_from_key(d.key())


def _jt(t: TileConfig) -> JTile:
    return JTile(t.bm, t.bn, t.bk, t.split_k, t.stream_k)


def _sched(s):
    return ([(g.indices, g.cd, g.mode, g.tile.key(),
              None if g.tiles is None else [t.key() for t in g.tiles],
              g.modeled_time_s) for g in s.groups], s.cp_overhead_s)


def _launch(ln):
    return (ln.class_key, ln.plan.mode, ln.plan.cd,
            [t.key() for t in (ln.plan.tiles or [ln.plan.tile])],
            [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
            ln.end_t, ln.cache_hit)


def _tol(dtype: str) -> float:
    return 3e-4 if dtype == "f32" else 3e-2


def _close(p, j, tol: float) -> None:
    np.testing.assert_allclose(p.float().numpy(),
                               np.asarray(jnp.asarray(j).astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ descriptor
@settings(max_examples=40, deadline=None)
@given(g=st.integers(1, 70), m=st.integers(0, 300), explicit=st.booleans(),
       dtype=st.sampled_from(["bf16", "f32"]), data=st.data())
def test_grouped_desc_matches_reference(g, m, explicit, dtype, data):
    rows = ()
    if explicit:
        rows = tuple(data.draw(st.lists(st.integers(0, 9), min_size=g, max_size=g)))
        m = sum(rows)
    d, j = GroupedGemmDesc(g, m, 96, 64, dtype, rows), JGrouped(g, m, 96, 64, dtype, rows)
    assert d.key() == j.key() and d.family == j.family == "grouped_gemm"
    for attr in ("flops", "in_bytes", "M", "mnk_like", "dtype", "can_slice"):
        assert getattr(d, attr) == getattr(j, attr), attr
    assert d.row_vector() == j.row_vector() and sum(d.row_vector()) == m
    assert op_from_key(d.key()) == d and jop_from_key(d.key()) == j
    assert ("_r" in d.key()) == bool(rows)
    for parts in (1, 2, 3, 7, 100):
        assert [p.key() for p in d.slice(parts)] == [p.key() for p in j.slice(parts)]
        sp, sj = slice_plan(d, parts), jslice_plan(j, parts)
        assert (sp.kind, sp.spans, sp.merge_axis) == (sj.kind, sj.spans, sj.merge_axis)
        assert [p.key() for p in sp.pieces] == [p.key() for p in sj.pieces]
        assert sp.kind == "experts" and sum(p.M for p in sp.pieces) == m


def test_grouped_desc_rows_must_sum_to_m():
    with pytest.raises(AssertionError, match="rows"):
        GroupedGemmDesc(2, 5, 16, 16, rows=(1, 1))
    with pytest.raises(AssertionError, match="rows"):
        JGrouped(2, 5, 16, 16, rows=(1, 1))


# ------------------------------------------------------------ cost model
def test_grouped_tiles_are_the_references():
    assert [t.key() for t in GROUPED_TILES] == [t.key() for t in JGROUPED_TILES]
    assert FAMILY_TILES["grouped_gemm"] is GROUPED_TILES
    assert set(FAMILY_TILES) == set(JFAMILY_TILES)


@pytest.mark.parametrize("d", GROUPED, ids=lambda d: d.key())
def test_grouped_stats_bitwise_over_tiles_and_budgets(d):
    """`grouped_stats_batch` and the `kernel_stats_batch` dispatch over
    `GROUPED_TILES` × RC and CD budgets, `op_tile_ws` and
    `isolated_time`."""
    tb, jtb = TileBatch.from_tiles(GROUPED_TILES), JTB.from_tiles(JGROUPED_TILES)
    j = jgrouped_stats_batch(_j(d), jtb, BUDGETS)
    for p in (grouped_stats_batch(d, tb, BUDGETS), kernel_stats_batch(d, tb, BUDGETS)):
        for f in STATS:
            np.testing.assert_array_equal(
                np.broadcast_to(getattr(p, f), p.waves.shape),
                np.broadcast_to(getattr(j, f), j.waves.shape), f)
    np.testing.assert_array_equal(op_tile_ws(d, tb), jop_tile_ws(_j(d), jtb))
    for t in GROUPED_TILES:
        assert isolated_time(d, t) == jisolated_time(_j(d), _jt(t))
        assert op_tile_ws(d, t) == jop_tile_ws(_j(d), _jt(t))


@pytest.mark.parametrize("d", GROUPED, ids=lambda d: d.key())
def test_grouped_stats_within_ulp_of_scalar_reference(d):
    """The reference's pure-Python grouped branch (`op_kernel_stats_ref`)
    folds in another order: a few ulp (ROADMAP C3), integers exact."""
    for t in GROUPED_TILES[::4]:
        for budget in (32 * 2**20, 4 * 2**20, 2**18):
            p = kernel_stats_batch(d, t, budget)
            r = jop_kernel_stats_ref(_j(d), _jt(t), budget)
            for f in STATS:
                got, want = np.asarray(getattr(p, f)), np.asarray(getattr(r, f))
                if want.dtype.kind == "f":
                    np.testing.assert_array_max_ulp(got.astype(float), want, maxulp=4)
                else:
                    assert got == want, f


@pytest.mark.parametrize("d", GROUPED, ids=lambda d: d.key())
def test_tune_op_grouped_entry_bitwise(d):
    p, j = tune_op(d), jtune_op(_j(d))
    assert (p.desc_key, p.family, p.isolated.key()) == \
        (j.desc_key, j.family, j.isolated.key())
    assert {c: t.key() for c, t in p.go.items()} == {c: t.key() for c, t in j.go.items()}
    assert p.rc_source == j.rc_source and p.speedup == j.speedup
    assert p.preferred_cd() == j.preferred_cd()


@pytest.mark.parametrize("d", GROUPED, ids=lambda d: d.key())
def test_grouped_op_features_bitwise(d):
    np.testing.assert_array_equal(op_features(d, GOLibrary()), jop_features(_j(d), JLib()))


@pytest.mark.parametrize("cd", [2, 3, 6, 16])
def test_group_time_with_grouped_members_bitwise(cd):
    pool = [(GROUPED[1], TileConfig(8, 128, 256))] * cd
    assert group_time(pool) == jgroup_time([(_j(d), _jt(t)) for d, t in pool])
    mixed = [(GROUPED[0], TileConfig(16, 256, 128)), (GemmDesc(4, 2048, 2048),
             TileConfig(8, 128, 128)), (AttentionDesc(4, 16, 16, 1, 2048, 192),
             TileConfig(8, 128, 128)), (GROUPED[2], TileConfig(32, 512, 512))]
    mixed = (mixed * cd)[:cd]
    assert group_time(mixed) == jgroup_time([(_j(d), _jt(t)) for d, t in mixed])


# --------------------------------------------- planning identical pools
POOLS = [AttentionDesc(2, 4, 2, 1, 64, 32, True, "f32"), ScanDesc(2, 1, 3, 16, 8, "f32"),
         GroupedGemmDesc(4, 6, 96, 64, "f32"), GroupedGemmDesc(64, 96, 1408, 2048),
         AttentionDesc(16, 16, 16, 1, 2048, 192)]


@pytest.mark.parametrize("available", [None, 2, 16])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("d", POOLS, ids=lambda d: d.key())
def test_plan_pools_of_identical_ops_bitwise(d, n, available):
    """`plan_group`'s non-GEMM branch: a pool of identical attention, scan
    or grouped ops is one ``mixed`` group at the CD's tile."""
    p = ConcurrencyController(GOLibrary()).plan([d] * n, available=available)
    j = JCtrl(JLib()).plan([_j(d)] * n, available=available)
    assert _sched(p) == _sched(j)
    for g in p.groups:
        assert g.mode == ("single" if g.cd == 1 else "mixed")
        assert g.tiles == (None if g.cd == 1 else [g.tile] * g.cd)


# ---------------------------------------------------------- execution
def _grouped_numpy(rng, d, integer: bool = False):
    if integer:
        return (rng.integers(-3, 4, (d.M, d.K)).astype(np.float32),
                rng.integers(-3, 4, (d.G, d.K, d.N)).astype(np.float32))
    return (rng.standard_normal((d.M, d.K)).astype(np.float32),
            (rng.standard_normal((d.G, d.K, d.N)) * d.K ** -0.5).astype(np.float32))


def _torch(x, dtype: str):
    return torch.from_numpy(x).to(torch.float32 if dtype == "f32" else torch.bfloat16)


def _jax(x, dtype: str):
    return jnp.asarray(x).astype(jnp.float32 if dtype == "f32" else jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rows,N,K,bm", [
    ((3, 0, 5, 1), 160, 96, 8),
    ((1,) * 6, 128, 64, 16),
    ((2, 2, 1, 0, 0, 7), 64, 128, 32),
    ((9, 17), 96, 64, 64),
    ((0, 4, 0), 128, 128, 128),
], ids=["zero-row", "decode", "zeros-mid", "bm64", "bm128"])
def test_grouped_for_desc_matches_reference_interpret(rows, N, K, bm, dtype):
    """The CPU path (`ragged_gemm_ref` on the raw layout) against the
    reference's packed Pallas run in interpret mode; the stacked and the
    per-expert weight forms give the same bits."""
    d = GroupedGemmDesc(len(rows), sum(rows), N, K, dtype, rows)
    a, b = _grouped_numpy(np.random.default_rng(sum(rows) + N), d)
    ref = jgrouped_for_desc(_j(d), _jax(a, dtype), _jax(b, dtype),
                            tile=JTile(bm, 128, 128), interpret=True)
    ta, tb = _torch(a, dtype), _torch(b, dtype)
    out = grouped_for_desc(d, ta, tb, tile=TileConfig(bm, 128, 128))
    assert out.shape == (d.M, N) and out.dtype == ta.dtype
    _close(out, ref, _tol(dtype))
    assert torch.equal(grouped_for_desc(d, ta, list(tb)), out)


@settings(max_examples=12, deadline=None)
@given(g=st.integers(2, 7), parts=st.integers(2, 5), data=st.data())
def test_experts_slice_merges_bitwise(g, parts, data):
    """The ``"experts"`` `SlicePlan`: pieces' rows and weights (a slice of
    the stacked tensor, or of the list of weights) merge bitwise into the
    unsliced result, which is the reference's unsliced one
    (`tests/test_slicing.py:235`)."""
    rows = tuple(data.draw(st.integers(0, 6)) for _ in range(g))
    d = GroupedGemmDesc(g, sum(rows), 16, 16, "f32", rows=rows)
    a, b = _grouped_numpy(np.random.default_rng(g * 31 + parts), d, integer=True)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = grouped_for_desc(d, ta, tb)
    jwhole = jgrouped_for_desc(_j(d), jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(whole.numpy(), np.asarray(jwhole))
    plan = slice_plan(d, parts)
    for weights in (tb, list(tb)):
        outs = [grouped_for_desc(p, *ops)
                for p, ops in zip(plan.pieces, plan.split_operands((ta, weights)))]
        assert torch.equal(plan.merge(outs), whole)


@pytest.mark.parametrize("bm", sorted({t.bm for t in GROUPED_TILES}))
@pytest.mark.parametrize("rows", [(1,) * 6, (2, 1) * 32, (2, 1, 0, 3) * 16, (8, 16, 0)],
                         ids=["g6", "g64", "g64-empty", "aligned"])
def test_packing_round_trips_and_counts_launches(rows, bm):
    """The card path's row packing: every expert's rows padded to bm (a
    pad row repeats a row of its expert), gathered back exactly; the
    launches are `ragged_chunks` of the padded rows, one per 16 experts
    that own a block."""
    d = GroupedGemmDesc(len(rows), sum(rows), 32, 16, rows=rows)
    pk = packing(rows, bm, torch.device("cpu"))
    padded = [r + (-r) % bm for r in rows]
    if pk is None:
        assert padded == list(rows)
    else:
        assert list(pk.padded) == padded and len(pk.gather) == sum(padded)
        a = torch.arange(d.M * 2, dtype=torch.float32).view(d.M, 2)
        assert torch.equal(a[pk.gather][pk.scatter], a)
        lo = src = 0
        for r, p in zip(rows, padded):
            assert pk.gather[lo:lo + p].tolist() == list(range(src, src + r)) + [src] * (p - r)
            lo, src = lo + p, src + r
    owners = sum(1 for g0 in range(0, len(rows), 16) if any(rows[g0:g0 + 16]))
    assert pool_launches(d, bm) == len(ragged_chunks(row_ends(padded), sum(padded), bm)) \
        == owners


def test_synth_request_draws_the_pools_operands():
    d = GroupedGemmDesc(5, 12, 96, 64)
    r = synth_request(d, seed=3, device="cpu")
    a, b = r.inputs
    assert a.shape == (12, 64) and b.shape == (5, 64, 96) and a.dtype == torch.bfloat16
    assert torch.equal(synth_request(d, seed=3, device="cpu").inputs[1], b)
    assert grouped_for_desc(d, a, b).shape == (12, 96)


def test_mixed_group_with_grouped_member_on_the_cpu():
    """A ``mixed`` launch of two expert pools and an attention member runs
    each through its family op, in order, on the CPU."""
    descs = [GroupedGemmDesc(3, 5, 32, 16, "f32", rows=(2, 0, 3)),
             AttentionDesc(1, 2, 2, 1, 16, 8, True, "f32"),
             GroupedGemmDesc(2, 4, 16, 32, "f32")]
    rng = np.random.default_rng(7)
    ops = [_grouped_numpy(rng, descs[0]),
           tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((1, 2, 1, 8), (1, 2, 16, 8), (1, 2, 16, 8))),
           _grouped_numpy(rng, descs[2])]
    reqs = requests_from_numpy([bind_operands(d) for d in descs], ops, device="cpu")
    tile = TileConfig(8, 128, 128)
    sched = Schedule(groups=[GroupPlan(indices=[0, 1, 2], cd=3, tile=tile, mode="mixed",
                                       modeled_time_s=0.0, tiles=[tile] * 3)])
    outs = execute_schedule(reqs, sched)
    for i in (0, 2):
        assert torch.equal(outs[i], grouped_for_desc(descs[i], *reqs[i].inputs))
    assert outs[1].shape == (1, 2, 1, 8)


# -------------------------------------------------------- integration
@pytest.mark.parametrize("batch", [1, 4, 8, 16])
def test_decode_step_op_descs_deepseek_equal_reference(batch):
    cfg, jcfg = get_arch(DEEPSEEK), jget_arch(DEEPSEEK)
    p = decode_step_op_descs(cfg, batch, 2048)
    assert [d.key() for d in p] == [d.key() for d in jop_descs(jcfg, batch, 2048)]
    g = min(64, 6 * batch)
    assert p[-3:] == [AttentionDesc(batch, 16, 16, 1, 2048, 192),
                      GroupedGemmDesc(g, 6 * batch, 1408, 2048),
                      GroupedGemmDesc(g, 6 * batch, 2048, 1408)]
    # ROADMAP C11: six dense (gate, up, down) triples besides the pools,
    # the rows spread evenly over the pool
    assert sum(1 for tag, _ in decode_step_descs(cfg, batch)
               if tag.startswith("expert")) == 12
    assert sorted(set(p[-1].row_vector())) == ([1] if batch < 16 else [1, 2])


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("batch", [1, 4, 8, 16])
def test_decode_step_graph_deepseek_equal_reference(batch, layers):
    pg = decode_step_graph(get_arch(DEEPSEEK), batch, 2048, layers=layers)
    jg = jdecode_graph(jget_arch(DEEPSEEK), batch, 2048, layers=layers)
    assert [(n.name, n.desc.key(), n.tag) for n in pg.nodes.values()] == \
        [(n.name, n.desc.key(), n.tag) for n in jg.nodes.values()]
    assert [(e.src, e.dst, e.slot) for e in pg.edges] == \
        [(e.src, e.dst, e.slot) for e in jg.edges]
    assert pg.waves() == jg.waves() and pg.sinks() == jg.sinks()
    assert sum(1 for d in pg.descs() if d.family == "grouped_gemm") == 2 * layers


def _operands(rng, d):
    """Numpy operands of one member in its family's slot order."""
    if d.family == "gemm":
        return (rng.standard_normal((d.M, d.K)).astype(np.float32),
                (rng.standard_normal((d.K, d.N)) * d.K ** -0.5).astype(np.float32))
    if d.family == "grouped_gemm":
        return _grouped_numpy(rng, d)
    if d.family == "flash_attention":
        return (rng.standard_normal((d.B, d.Hq, d.Sq, d.D)).astype(np.float32),
                rng.standard_normal((d.B, d.Hkv, d.Skv, d.D)).astype(np.float32),
                rng.standard_normal((d.B, d.Hkv, d.Skv, d.D)).astype(np.float32))
    return (rng.standard_normal((d.B, d.T, d.H, d.P)).astype(np.float32),
            -np.abs(rng.standard_normal((d.B, d.T, d.H))).astype(np.float32) * 0.3,
            rng.standard_normal((d.B, d.T, d.H, d.N)).astype(np.float32) * 0.5,
            rng.standard_normal((d.B, d.T, d.H, d.N)).astype(np.float32) * 0.5)


def _pair(available: int = 16, **cfg):
    jrt = JRuntime(JCtrl(JLib()), JConfig(window_s=0.0, execute=True, interpret=True,
                                          **cfg))
    prt = Runtime(ConcurrencyController(GOLibrary()),
                  RuntimeConfig(window_s=0.0, execute=True, **cfg), device="cpu")
    for rt in (jrt, prt):
        rt.set_available(available)
    return jrt, prt


def _port_request(d, ops, by_pointer: bool):
    (r,) = requests_from_numpy([bind_operands(d)], [ops], device="cpu")
    if by_pointer and d.family == "grouped_gemm":
        r = bind_operands(d, (r.inputs[0], list(r.inputs[1])))
    return r


def _check_results(ptickets, jtickets) -> None:
    assert len(ptickets) == len(jtickets)
    for p, j in zip(ptickets, jtickets):
        assert p.done and p.desc.key() == j.desc.key() and p.seq == j.seq
        _close(p.result, j.result, _tol(p.desc.dtype))


@pytest.fixture(scope="module")
def served_bundle():
    """Two layers of the reduced DeepSeek configuration: tenants at
    batches [1, 4] submit their layer's whole op bundle (the port's
    expert weights by pointer), both runtimes drain; 16 slots, then 2."""
    pcfg, jcfg = get_arch(DEEPSEEK).reduced(), jget_arch(DEEPSEEK).reduced()
    jrt, prt = _pair()
    rng = np.random.default_rng(0)
    out = dict(jh=[], ph=[], jl=[], pl=[])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for w, available in enumerate((16, 2)):
            for rt in (jrt, prt):
                rt.set_available(available)
            for layer in range(2):
                now = float(w) + layer * 0.01
                for ti, batch in enumerate((1, 4)):
                    descs = decode_step_op_descs(pcfg, batch, 72)
                    assert [d.key() for d in descs] == [
                        d.key() for d in jop_descs(jcfg, batch, 72)]
                    ops = [_operands(rng, d) for d in descs]
                    out["jh"].append(jrt.submit(
                        [jbind(_j(d), tuple(_jax(x, d.dtype) for x in o))
                         for d, o in zip(descs, ops)], tenant=f"t{ti}", now=now))
                    out["ph"].append(prt.submit(
                        [_port_request(d, o, True) for d, o in zip(descs, ops)],
                        tenant=f"t{ti}", now=now))
                out["jl"] += jrt.drain(now=now)
                out["pl"] += prt.drain(now=now)
    return jrt, prt, out


def test_deepseek_bundle_launches_identical(served_bundle):
    jrt, prt, o = served_bundle
    assert [_launch(x) for x in o["pl"]] == [_launch(x) for x in o["jl"]]
    assert {x.class_key for x in o["pl"]} == {MIXED_CLASS}
    fams = {tk.desc.family for x in o["pl"] for tk in x.tickets}
    assert fams == {"gemm", "flash_attention", "grouped_gemm"}
    assert prt.device_free_t == jrt.device_free_t
    assert not prt.telemetry.faults and not prt.telemetry.fallbacks


def test_deepseek_bundle_results_match(served_bundle):
    _, _, o = served_bundle
    for ph, jh in zip(o["ph"], o["jh"], strict=True):
        assert ph.done and (ph.seq, ph.done_t) == (jh.seq, jh.done_t)
        _check_results(ph.members, jh.members)


def _bind_graphs(cfg, jcfg, batch: int, context: int, rng):
    """The reduced DeepSeek decode graph in both packages with the same
    static operands in every slot no data edge feeds (the port's expert
    weights as a list, read by pointer)."""
    pg = decode_step_graph(cfg, batch, context, layers=2)
    jg = jdecode_graph(jcfg, batch, context, layers=2)
    wired = {(e.dst, e.slot) for e in pg.edges if e.slot is not None}
    for name, node in pg.nodes.items():
        d = node.desc
        ops = _operands(rng, d)
        for slot, x in zip(FAMILY_SLOTS[d.family], ops):
            if (name, slot) in wired:
                continue
            assert x.shape == slot_shape(d, slot)
            t = _torch(x, d.dtype)
            node.operands[slot] = list(t) if (d.family, slot) == ("grouped_gemm", 1) else t
            jg.nodes[name].operands[slot] = _jax(x, d.dtype)
    return pg, jg


def test_deepseek_graph_executes_as_the_reference():
    """Two tenants' two-layer reduced DeepSeek graphs, executed: the same
    launches, every node within tolerance of the reference's, the
    moe-down's rows a view of moe-up's output."""
    pcfg, jcfg = get_arch(DEEPSEEK).reduced(), jget_arch(DEEPSEEK).reduced()
    jrt, prt = _pair(available=4)
    rng = np.random.default_rng(5)
    handles = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for ti, batch in enumerate((1, 4)):
            pg, jg = _bind_graphs(pcfg, jcfg, batch, 40, rng)
            handles.append((jrt.submit(jg, tenant=f"t{ti}", now=0.0),
                            prt.submit(pg, tenant=f"t{ti}", now=0.0)))
        jl, pl = jrt.drain(now=0.0), prt.drain(now=0.0)
    assert [_launch(x) for x in pl] == [_launch(x) for x in jl]
    assert any(len({tk.graph.seq for tk in x.tickets}) == 2 for x in pl)
    for jh, ph in handles:
        assert ph.done and ph.done_t == jh.done_t
        names = list(ph.nodes)
        _check_results([ph.nodes[n] for n in names], [jh.nodes[n] for n in names])
        for ell in (0, 1):
            down, up = ph.nodes[f"L{ell}.moe-down"], ph.nodes[f"L{ell}.moe-up"]
            assert down.request.inputs[0].data_ptr() == up.result.data_ptr()
            assert isinstance(down.request.inputs[1], list)
    assert not prt.telemetry.faults and not prt.telemetry.fallbacks


@pytest.mark.parametrize("d", POOLS[:3] + [GroupedGemmDesc(3, 7, 64, 32, "bf16",
                                                           rows=(4, 0, 3))],
                         ids=lambda d: d.key())
def test_per_class_pools_execute_as_the_reference(d):
    """Five identical attention, scan or grouped ops submitted one by one
    enter their class queue (the reference's `_submit_one`); both runtimes
    plan the same ``mixed``/``single`` launches and the results agree."""
    jrt, prt = _pair(available=3)
    rng = np.random.default_rng(11)
    jt, pt = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for i in range(5):
            ops = _operands(rng, d)
            jt.append(jrt.submit(jbind(_j(d), tuple(_jax(x, d.dtype) for x in ops)),
                                 now=0.0))
            pt.append(prt.submit(_port_request(d, ops, by_pointer=i % 2 == 1), now=0.0))
        assert prt.queue_depths() == {d.key(): 5}
        jl, pl = jrt.drain(now=0.0), prt.drain(now=0.0)
    assert [_launch(x) for x in pl] == [_launch(x) for x in jl]
    assert [x.plan.mode for x in pl] == ["mixed", "mixed"] and \
        [x.plan.cd for x in pl] == [3, 2]
    _check_results(pt, jt)


def test_sliced_pool_by_pointer_merges_through_the_parent():
    """Admission slicing cuts an expert pool into expert spans (its weights
    a list); the parent completes through the merge, bitwise the unsliced
    result on integer operands, with the reference's launches."""
    d = GroupedGemmDesc(6, 9, 48, 32, "f32", rows=(2, 0, 3, 1, 0, 3))
    cfg = dict(slicing=True, flush_budget_s=1e-9, max_slices=3)
    jrt, prt = _pair(**cfg)
    a, b = _grouped_numpy(np.random.default_rng(2), d, integer=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jtk = jrt.submit(jbind(_j(d), (jnp.asarray(a), jnp.asarray(b))), now=0.0)
        ptk = prt.submit(bind_operands(d, (torch.from_numpy(a),
                                           list(torch.from_numpy(b)))), now=0.0)
        jl, pl = jrt.drain(now=0.0), prt.drain(now=0.0)
    assert [_launch(x) for x in pl] == [_launch(x) for x in jl]
    assert len(ptk.pieces) == 3 and ptk.merge_plan.kind == "experts"
    assert [p.desc.key() for p in ptk.pieces] == [p.desc.key() for p in jtk.pieces]
    assert all(isinstance(p.request.inputs[1], list) for p in ptk.pieces)
    want = grouped_for_desc(d, torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(ptk.result, want)
    assert np.array_equal(ptk.result.numpy(), np.asarray(jtk.result))


def test_graph_checks_a_pools_weight_operand():
    """An executing runtime takes a grouped node's weights as one (G, K, N)
    tensor or G (K, N) ones, and refuses another shape at submit, naming
    the node and the slot."""
    d = GroupedGemmDesc(3, 6, 16, 8, "f32")
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    a, b = torch.ones(6, 8), torch.ones(3, 8, 16)
    for weights in (b, list(b)):
        g = OpGraph()
        g.add("experts", d, operands={0: a, 1: weights})
        assert rt.submit(g, now=0.0) is not None
    rt.drain(now=0.0)
    for bad in (list(b)[:2], [torch.ones(16, 8)] * 3, torch.ones(3, 16, 8)):
        g = OpGraph()
        g.add("experts", d, operands={0: a, 1: bad})
        with pytest.raises(ValueError, match="'experts' slot 1"):
            rt.submit(g, now=0.0)
    assert rt.pending() == 0
