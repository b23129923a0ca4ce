"""The port's split-K and Stream-K GEMM decompositions on the CPU vs the
JAX package: `stream_k_geometry` bitwise, and `gemm` at split and
Stream-K tiles — which runs the plain versions of the partial and reduce
(or walk and fixup) kernels — against JAX `gemm(..., interpret=True)`,
which runs the Pallas bodies, and against JAX `gemm_stream_k_ref`.  The
card runs the Stream-K walk in its own units (CTA tiles, the CTA's k step
and W workgroups from the SM count) and sums each cut tile in runs of
`fixup_runs`, in one launch (`stream_k_matmul`): its plain version
`stream_k_matmul_ref` at that geometry is held to the JAX Stream-K GEMM
(`matmul_stream_k` in interpret mode), the run-order fixup to the
slot-order one, and the W mapping, the run length and the workspace
size are pure functions checked here.

Inputs are made with numpy from a seed.  Integer-valued float32 operands
make every f32 sum exact whatever its order, so those cases are bitwise;
bf16 cases hold to the reference tests' 3e-2 (`tests/test_kernel_gemm.py`).
"""
import itertools
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tuner import DEFAULT_SPEC as JSPEC
from repro.core.tuner import stream_k_grid as jstream_k_grid
from repro.kernels.gemm import TileConfig as JTile
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.gemm import gemm_stream_k_ref as jstream_ref
from repro.kernels.gemm.kernel import stream_k_geometry as jgeometry
from repro_torch.kernels.gemm import (
    TileConfig,
    fixup_runs,
    gemm,
    gemm_buffers,
    gemm_stream_k_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_fixup_ref,
    stream_k_geometry,
    stream_k_matmul_ref,
    stream_k_partials_ref,
    stream_k_workspace,
)
from repro_torch.kernels.gemm.kernel import (
    LAUNCHERS,
    MAX_CLUSTER,
    planner_g_max,
    split_k_slices,
    splitk_matmul,
    stream_k_workgroups,
    walk_geometry,
    walk_rows,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def _operands(seed, M, N, K, ta, tb, dtype):
    rng = np.random.default_rng(seed)
    shapes = ((K, M) if ta else (M, K), (N, K) if tb else (K, N))
    if dtype == "f32":   # integer-valued: every f32 sum below 2^24 is exact
        arrs = [rng.integers(-4, 5, size=s).astype(np.float32) for s in shapes]
    else:
        arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd) for x in arrs],
            [torch.from_numpy(x).to(td) for x in arrs])


def _assert_match(port, ref, dtype):
    p = port.float().numpy()
    r = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert p.shape == r.shape
    if dtype == "f32":
        np.testing.assert_array_equal(p, r)
    else:
        np.testing.assert_allclose(p, r, rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("grid_g", [1, 2, 3, 5, 7, 8, 16, 1000])
def test_stream_k_geometry_bitwise(grid_g):
    for tm, tn, tk in itertools.product((1, 2, 3, 5), (1, 4), (1, 3, 7, 136)):
        p = stream_k_geometry(tm, tn, tk, grid_g)
        j = jgeometry(tm, tn, tk, grid_g)
        assert p[:3] == tuple(j[:3]) and p[4] == j[4]
        assert p[3].dtype == j[3].dtype == np.int32
        np.testing.assert_array_equal(p[3], j[3])


@pytest.mark.parametrize("K,bk,split_k,want", [
    (1100, 128, 4, (4, 384)), (600, 128, 4, (4, 256)), (100, 128, 8, (1, 128)),
    (17408, 128, 4, (4, 4352)), (17408, 128, 8, (8, 2176)), (0, 128, 4, (1, 0)),
])
def test_split_k_slices_follow_the_reference_padding(K, bk, split_k, want):
    """Effective split min(split_k, ⌈K/bk⌉) and the slice of K padded to a
    (bk·split) multiple (`repro/kernels/gemm/ops.py:106-108`)."""
    assert split_k_slices(K, bk, split_k) == want


# ----------------------------------------------------------------- split-K
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("split_k", [2, 4, 8])
@pytest.mark.parametrize("shape,layout", [((8, 128, 1100), 0), ((13, 70, 300), 1),
                                          ((33, 200, 520), 2), ((1, 256, 4096), 3)])
def test_gemm_split_k_matches_pallas_body(shape, layout, split_k, dtype):
    M, N, K = shape
    ta, tb = LAYOUTS[layout]
    (ja, jb), (pa, pb) = _operands([M, N, K, split_k], M, N, K, ta, tb, dtype)
    ref = jgemm(ja, jb, ta=ta, tb=tb, tile=JTile(8, 128, 128, split_k=split_k),
                interpret=True)
    out = gemm(pa, pb, ta=ta, tb=tb, tile=TileConfig(8, 128, 128, split_k=split_k))
    assert out.dtype == DTYPES[dtype][1]
    _assert_match(out, ref, dtype)


def test_split_k_partials_cover_k_once_and_leave_an_empty_slice_zero():
    """⌈K/bk⌉ = 5 k blocks at split 4: slices of 2 blocks, so the last
    slice lies wholly past K and must hold zeros; the slices partition K
    and the reduce sums them in slot order."""
    M, N, K, bk = 9, 70, 600, 128
    _, (a, b) = _operands(7, M, N, K, False, False, "f32")
    split, slice_k = split_k_slices(K, bk, 4)
    p = splitk_partials_ref(a, b, split=split, slice_k=slice_k, bk=bk)
    assert p.shape == (4, M, N) and p.dtype == torch.float32
    assert torch.equal(p[3], torch.zeros(M, N))
    for s in range(3):
        lo, hi = s * slice_k, min((s + 1) * slice_k, K)
        assert torch.equal(p[s], a[:, lo:hi] @ b[lo:hi])
    assert torch.equal(splitk_reduce_ref(p, torch.float32), a @ b)


@pytest.mark.parametrize("layout", range(4))
@pytest.mark.parametrize("split_k", range(2, 9))
def test_cpu_split_k_gemm_is_the_plain_partials_and_reduce_bitwise(split_k, layout):
    """On the CPU, `gemm` at a split-K tile is exactly the plain version
    of `splitk_matmul`: `splitk_reduce_ref(splitk_partials_ref(...))`,
    the slices' f32 sums added in slice order and cast once.  K is
    split + 1 k blocks, the last one ragged, so from split 3 up the last
    slices lie wholly past K; bf16 operands with bf16 and f32 output."""
    ta, tb = LAYOUTS[layout]
    M, N, bk = 5, 70, 128
    K = split_k * bk + 37
    split, slice_k = split_k_slices(K, bk, split_k)
    assert split == split_k
    assert split_k == 2 or (split - 1) * slice_k >= K    # the last slice is empty
    _, (a, b) = _operands([split_k, layout], M, N, K, ta, tb, "bf16")
    p = splitk_partials_ref(a, b, ta=ta, tb=tb, split=split, slice_k=slice_k, bk=bk)
    tile = TileConfig(8, 128, bk, split_k=split_k)
    for out_dtype in (torch.bfloat16, torch.float32):
        out = gemm(a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype)
        assert out.dtype == out_dtype
        assert torch.equal(out, splitk_reduce_ref(p, out_dtype))


@pytest.mark.parametrize("split", [0, 17, 64])
def test_splitk_matmul_refuses_a_split_past_the_largest_cluster(split):
    """The K slices of an output tile are one thread-block cluster, at
    most 16 CTAs on the H100: a split outside 1-16 raises, naming the
    limit, before anything else is checked, and launches nothing."""
    a = torch.ones((8, 64), dtype=torch.bfloat16)
    before = [fn.launches for fn in LAUNCHERS]
    with pytest.raises(ValueError, match=f"split={split} exceeds the largest "
                                         "thread-block cluster, 16 CTAs"):
        splitk_matmul(a, a.T, split=split, slice_k=32)
    assert [fn.launches for fn in LAUNCHERS] == before
    assert MAX_CLUSTER == 16


# ----------------------------------------------------------------- Stream-K
STREAM_CASES = [  # (M, N, K, tile bm/bn/bk, layout)
    ((16, 256, 1024), (8, 128, 256), 0),
    ((13, 70, 300), (8, 128, 128), 1),
    ((33, 200, 520), (16, 128, 128), 2),
    ((8, 128, 4096), (8, 128, 128), 3),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("grid_g", [1, 3, 8, 100])
@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
def test_gemm_stream_k_matches_pallas_body_and_span_walk(case, grid_g, dtype):
    """G from 1 up to more workgroups than MAC iterations (100)."""
    (M, N, K), (bm, bn, bk), layout = STREAM_CASES[case]
    ta, tb = LAYOUTS[layout]
    (ja, jb), (pa, pb) = _operands([M, N, K, grid_g], M, N, K, ta, tb, dtype)
    out = gemm(pa, pb, ta=ta, tb=tb,
               tile=TileConfig(bm, bn, bk, stream_k=grid_g))
    assert out.dtype == DTYPES[dtype][1]
    _assert_match(out, jgemm(ja, jb, ta=ta, tb=tb,
                             tile=JTile(bm, bn, bk, stream_k=grid_g),
                             interpret=True), dtype)
    walk = jstream_ref(ja, jb, bm=bm, bn=bn, bk=bk, grid_g=grid_g, ta=ta, tb=tb)
    _assert_match(out, walk, dtype)
    _assert_match(gemm_stream_k_ref(pa, pb, bm=bm, bn=bn, bk=bk, grid_g=grid_g,
                                    ta=ta, tb=tb), walk, dtype)


def test_stream_k_partials_fill_only_their_contributors_slots():
    """Each tile's slots below its contributor count hold its spans'
    partials, which sum to the tile; slots past the count stay zero in
    the plain version (the kernel never writes them)."""
    M, N, K, bm, bn, bk, G = 24, 200, 700, 8, 128, 128, 5
    _, (a, b) = _operands(11, M, N, K, False, False, "f32")
    tm, tn, tk = 3, 2, 6
    _, _, _, counts, slots = stream_k_geometry(tm, tn, tk, G)
    p = stream_k_partials_ref(a, b, bm=bm, bn=bn, bk=bk, grid_g=G)
    assert p.shape == (slots, M, N) and slots > 1
    full = a @ b
    for i, j in itertools.product(range(tm), range(tn)):
        r, c = slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn)
        n = int(counts[i, j])
        assert torch.equal(p[:n, r, c].sum(0), full[r, c])
        assert not p[n:, r, c].any()
    out = stream_k_fixup_ref(torch.from_numpy(counts), p, bm=bm, bn=bn,
                             dtype=torch.float32)
    assert torch.equal(out, full)


def test_gemm_buffers_match_the_decomposition():
    """Split-K sums its slices in the kernel (`splitk_matmul`'s cluster
    epilogue), so a split-K tile gets its output alone; a Stream-K tile
    gets the workspace of its walk (`stream_k_workspace`: two tile slots
    per live workgroup), O(W) rather than (slots, M, N); its counters are
    the launching stream's, zeroed once (`stream_counters`)."""
    a, b = torch.empty((8, 4096)), torch.empty((4096, 130))
    assert gemm_buffers(a, b, tile=TileConfig(8, 128, 128)).workspace is None
    buf = gemm_buffers(a, b, tile=TileConfig(8, 128, 128, split_k=4))
    assert buf.out.shape == (8, 130)
    assert buf.workspace is None and buf._fields == ("out", "workspace")
    buf = gemm_buffers(a, b, tile=TileConfig(8, 128, 128, stream_k=8))
    live = stream_k_geometry(1, 2, 32, 8)[2]
    floats, counters = stream_k_workspace(live, 8, 128)
    assert buf.workspace.shape == (floats,) == (2 * live * 8 * 128,)
    assert buf.workspace.dtype == torch.float32
    assert counters == 4 * live


@pytest.mark.parametrize("tile", [TileConfig(8, 128, 128, split_k=4),
                                  TileConfig(8, 128, 128, stream_k=3)],
                         ids=lambda t: t.key())
def test_cpu_decompositions_launch_no_kernel(tile):
    _, (a, b) = _operands(3, 8, 64, 1024, False, False, "f32")
    before = [fn.launches for fn in LAUNCHERS]
    assert torch.equal(gemm(a, b, tile=tile), a @ b)
    assert [fn.launches for fn in LAUNCHERS] == before


# ------------------------------------------------ the card's Stream-K walk
@pytest.mark.parametrize("G,g_max,sms,per_sm,want", [
    (8, 8, 132, 2, 264), (8, 8, 132, 3, 396), (4, 8, 132, 2, 132),
    (1, 8, 132, 3, 50), (3, 8, 132, 1, 50), (40, 8, 132, 3, 1980),
    (1, 8, 1, 1, 1), (7, 8, 1, 1, 1), (1, 4, 132, 2, 66),
])
def test_stream_k_workgroups_scale_the_card_by_the_planner_share(G, g_max, sms, per_sm,
                                                                  want):
    """W = ⌈G / G_max · SMs · CTAs_per_SM⌉, at least 1: G = G_max fills
    the card's resident CTAs, a smaller G takes its share of them."""
    assert stream_k_workgroups(G, g_max, sms, per_sm) == want


def test_planner_g_max_is_the_tuners_stream_k_cap():
    """G_max is the cap `stream_k_grid` puts on G (TPU pipeline slots)."""
    assert planner_g_max() == JSPEC.pipeline_fill_tiles * 4 == 8
    assert int(jstream_k_grid(1, 10 ** 12)) == planner_g_max()


def test_walk_geometry_of_the_timed_member():
    """32×512×17408 bf16 in the card's units: 32-row CTA tiles 64 wide,
    k step 64, so 8 tiles × 272 k steps; at W = 264, 9 iterations a
    workgroup, 242 live and at most 32 slots a tile."""
    geo = walk_geometry(32, 512, 17408, torch.bfloat16, 264)
    assert (geo.rows, geo.cols, geo.bk) == (32, 64, 64)
    assert (geo.tm, geo.tn, geo.tk, geo.total) == (1, 8, 272, 2176)
    assert (geo.ipw, geo.live, geo.slots) == (9, 242, 32)
    assert geo.counts.shape == (1, 8) and geo.counts.sum() >= geo.live
    assert [walk_rows(m) for m in (1, 16, 17, 32, 33, 200)] == [16, 16, 32, 32, 64, 64]
    assert walk_geometry(8, 64, 640, torch.bfloat16, 7).bk == 128
    assert walk_geometry(8, 64, 640, torch.float32, 7).bk == 64


CARD_CASES = [  # (M, N, K), layout
    ((20, 200, 700), 0),
    ((9, 130, 1100), 3),
]


@lru_cache(maxsize=None)
def _jax_stream_k(case: int, G: int, dtype: str) -> np.ndarray:
    (M, N, K), layout = CARD_CASES[case]
    ta, tb = LAYOUTS[layout]
    (ja, jb), _ = _operands([M, N, K, case], M, N, K, ta, tb, dtype)
    out = jgemm(ja, jb, ta=ta, tb=tb, tile=JTile(16, 128, 128, stream_k=G),
                interpret=True)
    return np.asarray(jnp.asarray(out).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("W", [1, 7, 132, 264])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_plain_walk_at_card_geometry_matches_jax_stream_k(case, W, G, dtype):
    """The walk the card runs for a tile of G planner workgroups — CTA
    tiles from M, the CTA's k step and W workgroups — computes the same
    GEMM as the JAX Stream-K kernel at G: bitwise on integer-valued f32,
    within 3e-2 in bf16."""
    (M, N, K), layout = CARD_CASES[case]
    ta, tb = LAYOUTS[layout]
    _, (pa, pb) = _operands([M, N, K, case], M, N, K, ta, tb, dtype)
    geo = walk_geometry(M, N, K, DTYPES[dtype][1], W)
    out = gemm_stream_k_ref(pa, pb, bm=geo.rows, bn=geo.cols, bk=geo.bk,
                            grid_g=geo.workgroups, ta=ta, tb=tb)
    assert out.dtype == DTYPES[dtype][1]
    _assert_match(out, _jax_stream_k(case, G, dtype), dtype)
    p = stream_k_partials_ref(pa, pb, ta=ta, tb=tb, bm=geo.rows, bn=geo.cols,
                              bk=geo.bk, grid_g=geo.workgroups)
    assert p.shape == (geo.slots, M, N)


# ---------------------------------------- the one-launch kernel's summation
@pytest.mark.parametrize("n,R", [(1, 1), (2, 2), (7, 3), (46, 7), (47, 7), (400, 20)])
def test_fixup_runs_cover_every_contributor_once(n, R):
    """R = ⌈√n⌉, and the runs of R in workgroup order hold each of the n
    contributors exactly once, ⌈n/R⌉ of them."""
    assert fixup_runs(n) == R
    runs = [range(lo, min(lo + R, n)) for lo in range(0, n, R)]
    assert sorted(m for r in runs for m in r) == list(range(n))
    assert len(runs) == -(-n // R) and all(0 < len(r) <= R for r in runs)


RUN_CASES = [  # (M, N, K), (bm, bn, bk), G: up to 47 contributors a tile
    ((20, 200, 700), (32, 64, 64), 11),
    ((9, 130, 5000), (16, 64, 128), 60),
    ((33, 64, 3000), (64, 64, 64), 47),
    ((5, 70, 600), (16, 64, 64), 3),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", range(len(RUN_CASES)))
def test_run_order_fixup_matches_slot_order(case, dtype):
    """Summing each tile's partials in runs of `fixup_runs` (each run in
    slot order, then the runs in run order) computes the slot-order
    fixup: bitwise on integer-valued f32, within 3e-2 in bf16."""
    (M, N, K), (bm, bn, bk), G = RUN_CASES[case]
    _, (a, b) = _operands([M, N, K, G], M, N, K, False, False, dtype)
    tm, tn, tk = -(-M // bm), -(-N // bn), -(-K // bk)
    counts = torch.from_numpy(stream_k_geometry(tm, tn, tk, G)[3])
    p = stream_k_partials_ref(a, b, bm=bm, bn=bn, bk=bk, grid_g=G)
    td = DTYPES[dtype][1]
    by_runs = stream_k_fixup_ref(counts, p, bm=bm, bn=bn, dtype=td, runs=fixup_runs)
    assert by_runs.dtype == td and by_runs.shape == (M, N)
    _assert_match(by_runs, stream_k_fixup_ref(counts, p, bm=bm, bn=bn, dtype=td)
                  .float().numpy(), dtype)
    if case < 3:
        assert int(counts.max()) > fixup_runs(int(counts.max()))   # two levels


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("W", [1, 7, 132, 396])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_stream_k_matmul_ref_at_card_geometry_matches_jax_stream_k(case, W, dtype):
    """`stream_k_matmul_ref`, the card's one-launch Stream-K in its
    summation order, at the card's geometry (CTA tiles from M, the CTA's
    k step and W workgroups) computes the JAX Stream-K GEMM at G = 8
    (`gemm`, which pads the operands for `matmul_stream_k` and runs it in
    interpret mode): bitwise on integer-valued f32, within 3e-2 in bf16;
    bf16 and f32 outputs."""
    (M, N, K), layout = CARD_CASES[case]
    ta, tb = LAYOUTS[layout]
    _, (pa, pb) = _operands([M, N, K, case], M, N, K, ta, tb, dtype)
    geo = walk_geometry(M, N, K, DTYPES[dtype][1], W)
    kw = dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups, ta=ta, tb=tb)
    out = stream_k_matmul_ref(pa, pb, **kw)
    assert out.dtype == DTYPES[dtype][1]
    _assert_match(out, _jax_stream_k(case, 8, dtype), dtype)
    out32 = stream_k_matmul_ref(pa, pb, out_dtype=torch.float32, **kw)
    assert out32.dtype == torch.float32
    assert torch.equal(out32.to(out.dtype), out)


@pytest.mark.parametrize("W", [1, 7, 132, 396])
@pytest.mark.parametrize("shape", [(32, 512, 17408), (20, 200, 700), (70, 130, 4000)])
def test_stream_k_workspace_holds_the_slots_the_walk_writes(shape, W):
    """Every partial of a cut tile that the plain walk writes has its own
    slot in the workspace: contributor g of tile q at slot 2g + (0 for the
    tile g's span starts in, 1 for the tile it ends in), each slot one
    rows×cols f32 tile, all below `stream_k_workspace`'s size; each run
    and each cut tile has its own counter below its counter count."""
    M, N, K = shape
    geo = walk_geometry(M, N, K, torch.bfloat16, W)
    floats, n_counters = stream_k_workspace(geo.live, geo.rows, geo.cols)
    assert floats == 2 * geo.live * geo.rows * geo.cols
    slots, run_counters, tile_counters = set(), set(), set()

    def slot(w, q):
        return 2 * w + (0 if w * geo.ipw >= q * geo.tk else 1)

    written = 0
    for q, n in enumerate(geo.counts.reshape(-1).tolist()):
        if n == 1:
            continue
        first = q * geo.tk // geo.ipw
        written += n
        slots.update(slot(first + m, q) for m in range(n))
        R = fixup_runs(n)
        run_counters.update(slot(first + lo, q) for lo in range(0, n, R))
        tile_counters.add(2 * geo.live + slot(first, q))
    assert len(slots) == written and (not slots or max(slots) < 2 * geo.live)
    assert written <= 2 * geo.live
    counters = run_counters | tile_counters
    assert len(counters) == len(run_counters) + len(tile_counters)
    assert not counters or max(counters) < n_counters == 4 * geo.live
    # the plain walk writes exactly these partials: one per contributor
    assert int(geo.counts.sum()) == written + int((geo.counts == 1).sum())
