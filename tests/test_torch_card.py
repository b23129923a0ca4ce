"""`matmul` on both of its feeds, the redesigned Stream-K walk, split-KV
flash-attention and ragged-walk kernels, the one-launch split-K kernel,
the ring-fed grouped kernel with its weights by pointer and the SSD
scan's decode kernel, held to their plain versions on the card, and the
measurement harness timing launches there.  Every test here needs an
NVIDIA GPU and skips without one; on the card (no JAX needed) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py

Stream-K (`stream_k_matmul`) is one launch: the walk runs in the card's
units (`card_geometry`) and sums each cut tile by its last contributors to
arrive, in runs of `fixup_runs`.  It must match `stream_k_matmul_ref` at
that geometry (bf16 and f32 operands, bf16 and f32 outputs, all four
layouts, tiles wholly inside one span and tiles of 1 to several hundred
contributors), give the same bits on a second run and through `gemm`,
write into ``out=`` and a given workspace, and, two full-width GEMMs on
two side streams queued behind a sleep of the card, be right on both and
finish.  Attention must match `flash_ref` on f32 copies of its inputs
within `attention_tol`; its split partials must match `flash_split_ref`,
its output (merged in the kernel by the last CTA of each row group) must
match `flash_combine_ref` on the kernel's own partials, and the row
groups' counters must be zero again after the launch.

`matmul` takes TMA boxes for bf16 operands with 16-byte-aligned bases
and rows (`matmul_feed`), and the `cp.async` ring otherwise: the TMA
feed must match `gemm_ref` in all four layouts, at 16- and 64-row tiles,
with bf16 and f32 output, M, N and K not multiples of the tile, and at
both ring depths; the ring feed with f32 operands, K = 5118 (a row
stride that is not a 16-byte multiple) and a view one element past an
aligned base; each launch counted on its feed (`matmul.feeds`).  Both
feeds must be exact on integer-valued operands and give the same bits
on a second run.

Split-K (`splitk_matmul`) is one launch: the K slices of an output tile
are one thread-block cluster, which sums their f32 tiles in slice order
through distributed shared memory.  It must match the plain partials and
reduce (`splitk_reduce_ref(splitk_partials_ref(...))`) at splits 2, 3, 4,
8 and 16 (a non-portable cluster), with slices wholly past K, in every
layout, bf16 and f32 operands and outputs, and M not a multiple of the
CTA rows; give the same bits on a second call and through `gemm`; be
exact on integer-valued operands; and refuse split 17.

The grouped and ragged kernels take each member's weight by pointer:
transposed members (the TB layout), members sharing one weight, more
members than the pointer table's 16 (consecutive launches), float32
output, and a weight neither row- nor column-contiguous, which must
raise and launch nothing.  The ragged walk must give the same bits on a
second call (its partials sum in a fixed order).

The scan's decode kernel (`scan_route`: every T = 1 call) must match
`ssd_chunk_ref` on f32 copies of its inputs within 3e-4 (the reference
tests' tolerance; half a bf16 unit more for a bf16 y): bf16 and f32, with
and without an initial state, head-broadcast and per-head B/C, (N, P) of
(8, 16), (64, 64), (128, 128) and (10, 30), batch 1 (column slices) and
16; a strided xd; ``out=`` buffers, one of them unaligned; the same bits
on a second run.  A T = 2 call still takes the chunk loop.

GEMM tolerance (as in `chip_smoke.py`): |kernel − plain| ≤ 2⁻⁷·|plain|
(bf16 outputs only: one rounding each) + 2⁻¹⁶·|A|·|B| (f32 summation
order over K).
"""
import pytest
import torch

from repro_torch.core import (
    AttentionDesc,
    GemmDesc,
    Measurer,
    backend_tag,
    tune_gemm,
    tune_op,
)
from repro_torch.kernels.flash_attention import (
    attention_buffers,
    attention_tol,
    flash_attention_fwd,
    flash_combine_ref,
    flash_ref,
    flash_split_ref,
    kv_splits,
)
from repro_torch.kernels.flash_attention.kernel import (
    resident_slots,
    split_geometry,
    tma_loads,
    width_for,
)
from repro_torch.kernels.gemm import (
    TileConfig,
    card_geometry,
    gemm,
    gemm_buffers,
    gemm_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_matmul_ref,
    stream_k_workgroups,
    stream_k_workspace,
)
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.grouped_gemm import grouped_gemm_ref, ragged_gemm_ref
from repro_torch.kernels.grouped_gemm import kernel as ggk
from repro_torch.kernels.mamba_scan import mamba_scan_fwd, ssd_chunk_ref
from repro_torch.kernels.mamba_scan.kernel import decode_residency

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_card.py on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref, scale, what):
    rel = 2.0 ** -7 if ref.dtype == torch.bfloat16 else 0.0
    err = (out.float() - ref.float()).abs()
    tol = rel * ref.float().abs() + 2.0 ** -16 * scale
    assert torch.isfinite(out.float()).all(), what
    assert bool((err <= tol).all()), f"{what}: max |err| {err.max().item():.3g}"


# ------------------------------------------------------------------ matmul
def _operands(g, M, N, K, ta, tb, dtype, card):
    a = torch.randn((K, M) if ta else (M, K), generator=g, device=card, dtype=dtype)
    b = torch.randn((N, K) if tb else (K, N), generator=g, device=card, dtype=dtype)
    return a, b


def _launch(a, b, feed, **kw):
    """`matmul` on (a, b), asserting it launched once, on ``feed``."""
    before = dict(gk.matmul.feeds)
    launches = gk.matmul.launches
    out = gk.matmul(a, b, **kw)
    assert gk.matmul.launches == launches + 1
    assert gk.matmul.feeds[feed] == before[feed] + 1, gk.matmul.feeds
    return out


def _check(out, a, b, ta, tb, what):
    A, B = (a.T if ta else a).float().abs(), (b.T if tb else b).float().abs()
    _close(out, gemm_ref(a, b, ta=ta, tb=tb, out_dtype=out.dtype), A @ B, what)


TMA_CASES = [  # M, N, K: multiples of 8 (16-byte rows), not of the tile
    (8, 136, 200),       # M < 16, N and K past a 64 edge
    (72, 328, 1000),     # two or more row tiles of 16 or 64, M ragged
    (8, 17408, 320),     # 272 CTAs: the shallow ring (the deep one above)
]


@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=str)
@pytest.mark.parametrize("bm", [8, 64])
@pytest.mark.parametrize("layout", [(False, False), (False, True), (True, False),
                                    (True, True)], ids=str)
@pytest.mark.parametrize("case", TMA_CASES, ids=str)
def test_matmul_tma_feed_matches_plain(card, case, layout, bm, out_dtype):
    """Aligned bf16 operands take the TMA feed in every layout, at 16- and
    64-row tiles, bf16 and f32 output, edges from TMA's zero fill."""
    (M, N, K), (ta, tb) = case, layout
    g = torch.Generator(device=card).manual_seed(M * N + K)
    a, b = _operands(g, M, N, K, ta, tb, torch.bfloat16, card)
    assert gk.matmul_feed(a, b, ta, tb) == "tma"
    out = _launch(a, b, "tma", ta=ta, tb=tb, bm=bm, out_dtype=out_dtype)
    assert out.dtype == (out_dtype or torch.bfloat16) and out.shape == (M, N)
    _check(out, a, b, ta, tb, f"tma {case} {layout} bm{bm}")


def _ring_case(name, card):
    """Operands that the ring feed takes, and their layout."""
    g = torch.Generator(device=card).manual_seed(len(name))
    if name.startswith("f32"):
        ta, tb = {"f32": (False, False), "f32 ta": (True, False),
                  "f32 tb": (False, True), "f32 ta tb": (True, True)}[name]
        return (*_operands(g, 13, 130, 300, ta, tb, torch.float32, card), ta, tb)
    if name == "K 5118":     # A's row stride 10,236 bytes
        return (*_operands(g, 8, 256, 5118, False, False, torch.bfloat16, card),
                False, False)
    # a view one element past an aligned base
    M, N, K = 8, 256, 512
    a = torch.randn(M * K + 1, generator=g, device=card, dtype=torch.bfloat16)
    b = torch.randn((K, N), generator=g, device=card, dtype=torch.bfloat16)
    return a[1:].view(M, K), b, False, False


RING_CASES = ["f32", "f32 ta", "f32 tb", "f32 ta tb", "K 5118", "odd offset"]


@pytest.mark.parametrize("bm", [8, 64])
@pytest.mark.parametrize("name", RING_CASES)
def test_matmul_ring_feed_matches_plain(card, name, bm):
    a, b, ta, tb = _ring_case(name, card)
    assert gk.matmul_feed(a, b, ta, tb) == "ring"
    out = _launch(a, b, "ring", ta=ta, tb=tb, bm=bm)
    _check(out, a, b, ta, tb, f"ring {name} bm{bm}")


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("feed,K", [("tma", 3000), ("ring", 2998)])
def test_matmul_is_exact_on_integer_operands(card, feed, K, out_dtype):
    """Integer-valued operands: every f32 sum is exact whatever its
    order, so either feed equals the plain GEMM bit for bit."""
    g = torch.Generator(device=card).manual_seed(K)
    a = torch.randint(-4, 5, (9, K), generator=g, device=card).to(torch.bfloat16)
    b = torch.randint(-4, 5, (K, 200), generator=g, device=card).to(torch.bfloat16)
    out = _launch(a, b, feed, bm=8, out_dtype=out_dtype)
    assert torch.equal(out, gemm_ref(a, b, out_dtype=out_dtype))


@pytest.mark.parametrize("feed,K", [("tma", 5120), ("ring", 5118)])
def test_matmul_second_run_is_bitwise_equal(card, feed, K):
    g = torch.Generator(device=card).manual_seed(K)
    a, b = _operands(g, 8, 1024, K, False, False, torch.bfloat16, card)
    assert torch.equal(_launch(a, b, feed, bm=8), _launch(a, b, feed, bm=8))


@pytest.mark.parametrize("feed,ring", [("tma", r) for r in gk.TMA_RINGS] +
                         [("ring", (0, 0))], ids=str)
def test_matmul_residency_holds_a_ring(card, feed, ring):
    r = gk.matmul_residency(card, torch.bfloat16, torch.bfloat16, False, False, 16,
                            feed, ring)
    assert r.ctas_per_sm >= 1 and r.clusters is None
    assert r.stages >= 2 and r.smem_bytes >= r.stages * r.slab_bytes


# ---------------------------------------------------------------- Stream-K
WALK_CASES = [  # M, N, K, G, ta, tb
    (32, 512, 17408, 8, False, False),   # the timed member: 46-47 contributors a tile
    (5, 70, 600, 1, False, True),
    (13, 200, 1000, 3, True, False),
    (33, 129, 300, 5, True, True),
    (70, 130, 4000, 8, False, False),
    (1, 64, 64, 8, False, False),        # one k step: most workgroups idle
    (3, 40, 50, 40, False, False),       # G above G_max
    (16, 12992, 300, 1, False, False),   # spans of whole tiles beside cut ones
    (16, 64, 65536, 8, True, True),      # one tile, every workgroup in it
]


def _stream_k_operands(card, case, dtype):
    M, N, K, G, ta, tb = case
    g = torch.Generator(device=card).manual_seed(M * N + K + G)
    return _operands(g, M, N, K, ta, tb, dtype, card)


@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_stream_k_walk_matches_plain_at_card_geometry(card, case, dtype, out_dtype):
    M, N, K, G, ta, tb = case
    a, b = _stream_k_operands(card, case, dtype)
    geo = card_geometry(M, N, K, dtype, ta, tb, G, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    occ, _ = gk.walk_resources(card, dtype, ta, tb, geo.rows)
    assert geo.workgroups == stream_k_workgroups(G, gk.planner_g_max(), sms, occ)
    assert geo.rows == (16 if M <= 16 else 32 if M <= 32 else 64)
    before = gk.stream_k_matmul.launches
    out = gk.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G, out_dtype=out_dtype)
    assert gk.stream_k_matmul.launches == before + 1
    assert out.dtype == (out_dtype or dtype) and out.shape == (M, N)
    kw = dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)
    A, B = (a.T if ta else a).float().abs(), (b.T if tb else b).float().abs()
    _close(out, stream_k_matmul_ref(a, b, ta=ta, tb=tb, out_dtype=out.dtype, **kw),
           A @ B, "stream_k_matmul")
    assert torch.equal(gk.stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=G,
                                          out_dtype=out_dtype), out)
    tile = TileConfig(16, 128, 128, stream_k=G)
    buf = gemm_buffers(a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype)
    assert buf.workspace.numel() == stream_k_workspace(geo.live, geo.rows, geo.cols)[0]
    res = gemm(a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype, buffers=buf)
    assert res.data_ptr() == buf.out.data_ptr() and torch.equal(res, out)
    assert gk.stream_k_matmul.launches == before + 3


def test_stream_k_cases_reach_whole_tiles_and_two_level_sums(card):
    """`WALK_CASES` hold, in each dtype, tiles wholly inside one span beside
    cut tiles, and tiles of at least 46 contributors, which sum in runs."""
    for dtype in (torch.bfloat16, torch.float32):
        counts = [card_geometry(M, N, K, dtype, ta, tb, G, card).counts
                  for M, N, K, G, ta, tb in WALK_CASES]
        assert any((c == 1).any() and (c > 1).any() for c in counts)
        top = max(int(c.max()) for c in counts)
        assert top >= 46 and gk.fixup_runs(top) < top


def test_stream_k_matmul_writes_out_and_a_given_workspace(card):
    """``out=`` and a workspace given by the caller (larger than needed)
    are used as they are; the stream's counters (`stream_counters`) are
    zero again after launches of every case, so the next launch counts
    right with no zeroing; a workspace too small or of another dtype
    raises and launches nothing."""
    case = WALK_CASES[0]
    M, N, K, G, _, _ = case
    a, b = _stream_k_operands(card, case, torch.bfloat16)
    geo = card_geometry(M, N, K, torch.bfloat16, False, False, G, card)
    floats, counters = stream_k_workspace(geo.live, geo.rows, geo.cols)
    ws = torch.empty(floats + 100, device=card)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=card)
    res = gk.stream_k_matmul(a, b, grid_g=G, out=out, workspace=ws)
    assert res is out
    assert torch.equal(out, gk.stream_k_matmul(a, b, grid_g=G))
    for M_, N_, K_, G_, ta, tb in WALK_CASES:
        x, y = _stream_k_operands(card, (M_, N_, K_, G_, ta, tb), torch.float32)
        gk.stream_k_matmul(x, y, ta=ta, tb=tb, grid_g=G_)
    cnt = gk.stream_counters(a.device, counters)
    assert cnt.dtype == torch.int32 and cnt.numel() >= counters and not cnt.any()
    before = gk.stream_k_matmul.launches
    with pytest.raises(ValueError, match="workspace"):
        gk.stream_k_matmul(a, b, grid_g=G, workspace=ws[:floats - 1])
    with pytest.raises(ValueError, match="workspace"):
        gk.stream_k_matmul(a, b, grid_g=G, workspace=ws.double())
    assert gk.stream_k_matmul.launches == before


def test_two_stream_k_gemms_on_side_streams_behind_a_sleep(card):
    """Two full-width Stream-K GEMMs (G = 8: W fills the card's resident
    CTAs alone) on two side streams, queued behind a sleep of the card so
    that both are ready at once, as a mixed launch runs its members: both
    right, and the card finishes (no CTA waits for another to be resident:
    a cut tile is summed by its last contributors to arrive)."""
    case = WALK_CASES[0]
    M, N, K, G, _, _ = case
    g = torch.Generator(device=card).manual_seed(2)
    sets = [_operands(g, M, N, K, False, False, torch.bfloat16, card) for _ in range(2)]
    tile = TileConfig(32, 128, 128, stream_k=G)
    bufs = [gemm_buffers(a, b, tile=tile) for a, b in sets]
    main = torch.cuda.current_stream(card)
    streams = [torch.cuda.Stream(card) for _ in sets]
    torch.cuda._sleep(500_000_000)
    fork = torch.cuda.Event()
    fork.record(main)
    outs = []
    for (a, b), s, buf in zip(sets, streams, bufs):
        s.wait_event(fork)
        with torch.cuda.stream(s):
            outs.append(gemm(a, b, tile=tile, buffers=buf))
    for s in streams:
        main.wait_stream(s)
    torch.cuda.synchronize(card)
    geo = card_geometry(M, N, K, torch.bfloat16, False, False, G, card)
    kw = dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)
    for out, (a, b) in zip(outs, sets):
        _close(out, stream_k_matmul_ref(a, b, **kw), a.float().abs() @ b.float().abs(),
               "stream_k_matmul on a side stream")


# ----------------------------------------------------------------- split-K
SPLITK_CASES = [  # M, N, K, bm, bk, split_k, ta, tb
    (8, 5120, 17408, 8, 128, 4, False, False),   # the timed shapes
    (1, 5120, 17408, 8, 128, 8, False, False),
    (5, 70, 600, 8, 128, 4, False, True),        # slice 3 wholly past K
    (17, 129, 1100, 8, 128, 8, True, False),     # two 16-row tiles; slices 5-7 empty
    (70, 200, 300, 64, 64, 3, True, True),       # 64-row tiles, M ragged
    (16, 64, 257, 16, 128, 2, False, False),
    (3, 100, 4096, 8, 128, 16, False, True),     # a non-portable cluster of 16
    (9, 64, 1000, 64, 64, 16, True, True),       # 16 k blocks, 16 slices
]


@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", SPLITK_CASES, ids=str)
def test_splitk_matmul_matches_plain_partials_and_reduce(card, case, dtype, out_dtype):
    M, N, K, bm, bk, split_k, ta, tb = case
    g = torch.Generator(device=card).manual_seed(M * N + K + split_k)
    a = torch.randn((K, M) if ta else (M, K), generator=g, device=card, dtype=dtype)
    b = torch.randn((N, K) if tb else (K, N), generator=g, device=card, dtype=dtype)
    split, slice_k = gk.split_k_slices(K, bk, split_k)
    kw = dict(ta=ta, tb=tb, split=split, slice_k=slice_k)
    before = gk.splitk_matmul.launches
    out = gk.splitk_matmul(a, b, bm=bm, out_dtype=out_dtype, **kw)
    assert gk.splitk_matmul.launches == before + 1
    assert out.dtype == (out_dtype or dtype) and out.shape == (M, N)
    plain = splitk_reduce_ref(splitk_partials_ref(a, b, bk=bk, **kw), out.dtype)
    A, B = (a.T if ta else a).float().abs(), (b.T if tb else b).float().abs()
    _close(out, plain, A @ B, "splitk_matmul")
    assert torch.equal(gk.splitk_matmul(a, b, bm=bm, out_dtype=out_dtype, **kw), out)
    tile = TileConfig(bm, 128, bk, split_k=split_k)
    buf = gemm_buffers(a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype)
    assert buf.workspace is None         # no f32 partials in device memory
    assert torch.equal(gemm(a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype,
                            buffers=buf), out)
    assert gk.splitk_matmul.launches == before + 3


@pytest.mark.parametrize("split", [2, 3, 4, 8, 16])
def test_splitk_matmul_is_exact_on_integer_operands(card, split):
    """Integer-valued operands: every f32 sum is exact whatever its
    order, so the kernel equals the plain GEMM bit for bit."""
    g = torch.Generator(device=card).manual_seed(split)
    M, N, K = 9, 200, 3000
    a = torch.randint(-4, 5, (M, K), generator=g, device=card).to(torch.bfloat16)
    b = torch.randint(-4, 5, (K, N), generator=g, device=card).to(torch.bfloat16)
    s, slice_k = gk.split_k_slices(K, 128, split)
    for out_dtype in (torch.float32, torch.bfloat16):
        out = gk.splitk_matmul(a, b, bm=8, split=s, slice_k=slice_k,
                               out_dtype=out_dtype)
        assert torch.equal(out, gemm_ref(a, b, out_dtype=out_dtype))


def test_splitk_matmul_refuses_split_17(card):
    a = torch.ones((8, 2048), device=card, dtype=torch.bfloat16)
    b = torch.ones((2048, 64), device=card, dtype=torch.bfloat16)
    before = gk.splitk_matmul.launches
    with pytest.raises(ValueError, match="split=17 exceeds the largest thread-block "
                                         "cluster, 16 CTAs"):
        gk.splitk_matmul(a, b, split=17, slice_k=128)
    assert gk.splitk_matmul.launches == before


@pytest.mark.parametrize("split", [2, 4, 8, 16])
def test_splitk_residency_holds_a_cluster(card, split):
    """The card holds at least one cluster of every split the kernel
    takes, and the ring keeps at least one slab in flight."""
    r = gk.splitk_residency(card, torch.bfloat16, torch.bfloat16, False, False, 16,
                            split)
    assert r.ctas_per_sm >= 1 and r.clusters >= 1
    assert 2 <= r.stages <= 4 and r.smem_bytes >= r.stages * r.slab_bytes


# --------------------------------------------------------------- attention
ATTN_CASES = [  # B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset, bq, bkv
    (16, 40, 8, 1, 4096, 128, 128, True, 0, 4095, 8, 128),   # tenant 16
    (1, 40, 8, 1, 4096, 128, 128, True, 0, 4095, 8, 128),    # batch 1
    (1, 32, 32, 1, 2048, 64, 64, True, 0, 2047, 8, 128),     # Zamba2, MHA
    (1, 4, 2, 300, 3000, 64, 64, True, 0, 0, 128, 256),      # prefill: splits past the frontier
    (1, 4, 4, 64, 2000, 32, 32, True, 100, 1936, 64, 128),   # window: early splits masked
    (1, 4, 2, 50, 1500, 128, 64, True, 0, -10, 64, 128),     # negative q_offset
    (2, 4, 4, 9, 1400, 192, 128, False, 0, 0, 8, 128),       # dv != dqk, 256 wide
    (1, 8, 2, 1, 1100, 36, 36, True, 0, 1099, 8, 128),       # 72-byte rows: no TMA
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_split_kv_attention_matches_plain(card, case, dtype):
    B, Hq, Hkv, T, S, D, Dv, causal, window, off, bq, bkv = case
    g = torch.Generator(device=card).manual_seed(B * S + T)
    q = torch.randn((B, Hq, T, D), generator=g, device=card).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=g, device=card).to(dtype)
    v = torch.randn((B, Hkv, S, Dv), generator=g, device=card).to(dtype)
    kw = dict(causal=causal, window=window, q_offset=off)
    splits, split_len = split_geometry(q, k, v)
    slots = resident_slots(card, dtype, width_for(D, Dv))
    assert (splits, split_len) == kv_splits(B, Hkv, Hq // Hkv, T, S, slots)
    if dtype == torch.bfloat16:
        assert tma_loads(k, v) == (D % 8 == 0)
    bufs = attention_buffers(q, k, v)
    before = flash_attention_fwd.launches
    out = flash_attention_fwd(q, k, v, bq=bq, bkv=bkv, out=bufs, **kw)
    assert flash_attention_fwd.launches == before + 1 and out is bufs.out
    seen = (torch.arange(T, device=card) + off) >= 0   # rows that see a key
    ref = flash_ref(q.float(), k.float(), v.float(), **kw)
    atol, rtol = attention_tol(dtype)
    err = (out.float() - ref).abs()[:, :, seen]
    assert bool((err <= atol + rtol * ref.abs()[:, :, seen]).all()), err.max().item()
    if splits == 1:
        assert bufs.part_acc is None
        return
    assert not bufs.counter.any()            # the last CTAs reset them
    first = out.clone()
    assert torch.equal(flash_attention_fwd(q, k, v, bq=bq, bkv=bkv, out=bufs, **kw),
                       first)                # split order: the same bits again
    pa, pm = flash_split_ref(q.float(), k.float(), v.float(), split_len=split_len, **kw)
    m_k, m_r = bufs.part_ml[..., 0][:, :, :, seen], pm[..., 0][:, :, :, seen]
    assert torch.allclose(m_k, m_r, atol=2e-4, rtol=2e-4)
    scale = pm[..., 1:][:, :, :, seen]
    assert torch.allclose(bufs.part_ml[..., 1:][:, :, :, seen], scale, atol=2e-4,
                          rtol=2e-4)
    assert torch.allclose(bufs.part_acc[:, :, :, seen], pa[:, :, :, seen],
                          atol=2e-4 * float(scale.max()), rtol=2e-4)
    plain = flash_combine_ref(bufs.part_acc, bufs.part_ml, dtype)
    assert torch.allclose(out.float()[:, :, seen], plain.float()[:, :, seen], atol=1e-6,
                          rtol=2.0 ** -7 if dtype == torch.bfloat16 else 1e-6)


def test_split_counts_fill_one_wave_of_the_card(card):
    slots = resident_slots(card, torch.bfloat16, 128)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert slots % sms == 0 and slots >= sms
    for B in (1, 4, 8, 16):
        n, _ = kv_splits(B, 8, 5, 1, 4096, slots)
        assert 1 <= n <= 16 and (n == 1 or B * 8 * n <= slots)


# ------------------------------------------------ grouped and ragged by pointer
def _members(card, G, K, N, dtype, tb, shared, seed):
    """G weights as (K, N) tensors: row-major, or transposed views of (N, K)
    storage when ``tb``; with ``shared``, members 1 and G - 1 reuse
    member 0's weight."""
    g = torch.Generator(device=card).manual_seed(seed)
    ws = [torch.randn((N, K) if tb else (K, N), generator=g, device=card,
                      dtype=dtype) for _ in range(G)]
    ws = [w.T for w in ws] if tb else ws
    if shared:
        ws[1] = ws[-1] = ws[0]
    return ws


def _abs(ws):
    return [w.float().abs() for w in ws]


GROUPED_CASES = [  # G, M, N, K, bm, tb, shared, out_dtype
    (4, 8, 5120, 2048, 8, False, False, None),    # path widths, K cut
    (3, 9, 130, 200, 8, True, False, None),       # transposed members
    (5, 16, 96, 300, 16, False, True, None),      # shared weights
    (20, 5, 64, 96, 8, False, False, None),       # G above the table's 16
    (20, 5, 64, 96, 8, True, True, torch.float32),
    (2, 70, 100, 96, 64, False, False, torch.float32),
    (1, 8, 5120, 4096, 8, True, False, None),     # one member, transposed
    (16, 8, 640, 1024, 8, False, True, torch.float32),   # a full table, shared
    (16, 3, 130, 200, 16, True, True, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", GROUPED_CASES, ids=str)
def test_grouped_weights_by_pointer_match_plain(card, case, dtype):
    G, M, N, K, bm, tb, shared, out_dtype = case
    g = torch.Generator(device=card).manual_seed(G * M + K)
    a = torch.randn((G, M, K), generator=g, device=card, dtype=dtype)
    ws = _members(card, G, K, N, dtype, tb, shared, G + N)
    before = ggk.grouped_matmul.launches
    out = ggk.grouped_matmul(a, ws, bm=bm, out_dtype=out_dtype)
    assert ggk.grouped_matmul.launches == before + -(-G // ggk.MAX_MEMBERS)
    assert out.dtype == (out_dtype or dtype)
    _close(out, grouped_gemm_ref(a, ws, out_dtype=out_dtype),
           grouped_gemm_ref(a.float().abs(), _abs(ws)), "grouped")
    r = ggk.grouped_residency(card, dtype, out.dtype, tb, gk.cta_rows(bm))
    assert r.ctas_per_sm >= 1 and 2 <= r.stages <= 4


RAGGED_CASES = [  # sizes (bm multiples), extra rows, N, K, bm, tb, shared, out_dtype
    ([16, 16, 16, 16, 16], 0, 5120, 2048, 16, False, False, None),  # path widths
    ([16, 0, 32], 16, 100, 130, 16, True, False, None),   # zero size, rows past the end
    ([8, 24, 8, 8], 0, 65, 257, 8, False, True, None),    # shared weights
    ([16] * 18 + [0, 32], 16, 96, 200, 16, True, True, None),  # 20 members
    ([128, 256], 64, 64, 80, 128, False, False, torch.float32),
    ([16, 8, 8, 8, 8], 0, 5120, 300, 8, True, False, torch.float32),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", RAGGED_CASES, ids=str)
def test_ragged_walk_by_pointer_matches_plain(card, case, dtype):
    sizes, extra, N, K, bm, tb, shared, out_dtype = case
    G, Mtotal = len(sizes), sum(sizes) + extra
    g = torch.Generator(device=card).manual_seed(Mtotal * N + K)
    a = torch.randn((Mtotal, K), generator=g, device=card, dtype=dtype)
    ws = _members(card, G, K, N, dtype, tb, shared, G + K)
    chunks = ggk.ragged_chunks(ggk.row_ends(sizes), Mtotal, bm)
    before = ggk.ragged_matmul.launches
    out = ggk.ragged_matmul(a, ws, sizes, bm=bm, out_dtype=out_dtype)
    assert ggk.ragged_matmul.launches == before + len(chunks)
    assert out.dtype == (out_dtype or dtype)
    _close(out, ragged_gemm_ref(a, ws, sizes, out_dtype=out_dtype),
           ragged_gemm_ref(a.float().abs(), _abs(ws), sizes), "ragged")
    again = ggk.ragged_matmul(a, ws, sizes, bm=bm, out_dtype=out_dtype)
    assert torch.equal(again, out)   # the partials sum in a fixed order


def test_ragged_walk_fills_the_card(card):
    """W = SMs × the walk's occupancy; the timed shape's 54,400
    iterations are dealt in equal spans to W CTAs."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    per_sm, smem = ggk.ragged_resources(card, torch.bfloat16, torch.bfloat16,
                                        False, 16)
    w = ggk.ragged_workgroups(card, torch.bfloat16, torch.bfloat16, False, 16)
    assert w == sms * per_sm and per_sm >= 1 and smem > 48 * 1024
    geo = ggk.ragged_walk(80, 5120, 17408, torch.bfloat16, 16, w)
    assert geo.total == 5 * 80 * 136 and geo.live <= w
    assert geo.ipw * (geo.live - 1) < geo.total <= geo.ipw * geo.live


def test_weight_neither_row_nor_column_contiguous_raises(card):
    a = torch.randn((3, 8, 64), device=card, dtype=torch.bfloat16)
    ws = [torch.randn((64, 32), device=card, dtype=torch.bfloat16) for _ in range(3)]
    strided = torch.randn((128, 64), device=card, dtype=torch.bfloat16)[::2, ::2]
    mixed = torch.randn((32, 64), device=card, dtype=torch.bfloat16).T
    before = (ggk.grouped_matmul.launches, ggk.ragged_matmul.launches)
    with pytest.raises(ValueError, match="member 1's weight .* neither row- nor "
                                         "column-contiguous"):
        ggk.grouped_matmul(a, [ws[0], strided, ws[2]])
    with pytest.raises(ValueError, match="member 1's weight"):
        ggk.ragged_matmul(a.view(24, 64), [ws[0], strided, ws[2]], [8, 8, 8], bm=8)
    with pytest.raises(ValueError, match="member 2's weight is stored .*one launch "
                                         "has one layout"):
        ggk.grouped_matmul(a, [ws[0], ws[1], mixed])
    assert (ggk.grouped_matmul.launches, ggk.ragged_matmul.launches) == before


# ------------------------------------------------------ the scan's decode step
SCAN_TOL = 3e-4   # tests/test_kernel_mamba.py's f32 tolerance


def _scan_close(y, state, xd, da, bm, cm, s0, what):
    """y and the state against `ssd_chunk_ref` on f32 copies of the same
    inputs (bf16 converts exactly), within SCAN_TOL + SCAN_TOL·|plain|,
    plus half a bf16 unit (2⁻⁸·|plain|) for a bf16 y's one rounding."""
    y_ref, s_ref = ssd_chunk_ref(xd.float(), da.float(), bm.float(), cm.float(),
                                 chunk=64, initial_state=s0)
    rtol = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    for out, ref, rt, name in ((y, y_ref, rtol, "y"), (state, s_ref, SCAN_TOL, "state")):
        assert out.shape == ref.shape, (what, name)
        assert torch.isfinite(out.float()).all(), (what, name)
        err = (out.float() - ref.float()).abs()
        assert bool((err <= SCAN_TOL + rt * ref.float().abs()).all()), \
            f"{what} {name}: max |err| {err.max().item():.3g}"


def _scan_inputs(card, B, T, H, P, N, dtype, bcast, seed):
    """xd, da (≤ 0) and B/C, as head-broadcast views of (B,T,N) when
    ``bcast`` (head stride 0, Mamba2's group-shared layout)."""
    g = torch.Generator(device=card).manual_seed(seed)
    xd = torch.randn((B, T, H, P), generator=g, device=card).to(dtype)
    da = (torch.rand((B, T, H), generator=g, device=card) * -0.5).to(dtype)
    if bcast:
        bm, cm = (torch.randn((B, T, 1, N), generator=g, device=card).mul_(0.5)
                  .to(dtype).expand(B, T, H, N) for _ in range(2))
    else:
        bm, cm = (torch.randn((B, T, H, N), generator=g, device=card).mul_(0.5)
                  .to(dtype) for _ in range(2))
    return xd, da, bm, cm


def _decode(xd, da, bm, cm, **kw):
    """`mamba_scan_fwd` on a T = 1 call, asserting one launch on the decode
    route."""
    before, routes = mamba_scan_fwd.launches, dict(mamba_scan_fwd.routes)
    out = mamba_scan_fwd(xd, da, bm, cm, chunk=32, **kw)
    assert mamba_scan_fwd.launches == before + 1
    assert mamba_scan_fwd.routes == {**routes, "decode": routes["decode"] + 1}
    return out


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("NP", [(8, 16), (64, 64), (128, 128), (10, 30)], ids=str)
@pytest.mark.parametrize("bcast", [True, False], ids=["bcast", "per_head"])
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero_state", "s0"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_scan_decode_matches_plain(card, dtype, with_s0, bcast, NP, B):
    """64 heads (Zamba2's), so B = 16 runs one pair per CTA and B = 1 the
    column slices; (10, 30): rows of 30 floats, not 16-byte groups."""
    N, P = NP
    xd, da, bm, cm = _scan_inputs(card, B, 1, 64, P, N, dtype, bcast, B * N + P)
    g = torch.Generator(device=card).manual_seed(N)
    s0 = (torch.randn((B, 64, N, P), generator=g, device=card) if with_s0 else None)
    y, state = _decode(xd, da, bm, cm, initial_state=s0)
    assert y.dtype == dtype and state.dtype == torch.float32
    _scan_close(y, state, xd, da, bm, cm, s0, f"decode B{B} N{N} P{P}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_scan_decode_reads_a_strided_xd(card, dtype):
    """xd a (B,1,H,P) view of wider (B,H,1,P+8) storage: batch and head
    strides that are not the packed ones, read as they are."""
    B, H, P, N = 4, 64, 64, 64
    _, da, bm, cm = _scan_inputs(card, B, 1, H, P, N, dtype, True, 3)
    g = torch.Generator(device=card).manual_seed(4)
    xd = torch.randn((B, H, 1, P + 8), generator=g, device=card).to(dtype)
    xd = xd[..., :P].transpose(1, 2)
    assert xd.shape == (B, 1, H, P) and not xd.is_contiguous()
    s0 = torch.randn((B, H, N, P), generator=g, device=card)
    y, state = _decode(xd, da, bm, cm, initial_state=s0)
    _scan_close(y, state, xd, da, bm, cm, s0, "decode strided xd")


def test_scan_decode_writes_out_buffers(card):
    """``out=``: the launch writes the given y and state and returns them;
    a state buffer one float past an aligned base takes 4-byte stores."""
    B, H, P, N = 16, 64, 64, 64
    xd, da, bm, cm = _scan_inputs(card, B, 1, H, P, N, torch.bfloat16, True, 5)
    s0 = torch.randn((B, H, N, P), device=card)
    for offset in (0, 1):
        y = torch.full((B, 1, H, P), float("nan"), device=card, dtype=torch.bfloat16)
        flat = torch.full((B * H * N * P + offset,), float("nan"), device=card)
        state = flat[offset:].view(B, H, N, P)
        got = _decode(xd, da, bm, cm, initial_state=s0, out=(y, state))
        assert got[0] is y and got[1] is state
        _scan_close(y, state, xd, da, bm, cm, s0, f"decode out= offset {offset}")


def test_scan_decode_second_run_is_bitwise_equal(card):
    for B in (1, 16):
        xd, da, bm, cm = _scan_inputs(card, B, 1, 64, 64, 64, torch.bfloat16, True, B)
        s0 = torch.randn((B, 64, 64, 64), device=card)
        y, state = _decode(xd, da, bm, cm, initial_state=s0)
        y2, state2 = _decode(xd, da, bm, cm, initial_state=s0)
        assert torch.equal(y, y2) and torch.equal(state, state2)


def test_scan_t2_still_takes_the_chunk_loop(card):
    """T = 2 is no decode step: it launches `mamba_kernel` (the chunks
    route) and agrees with the plain version."""
    xd, da, bm, cm = _scan_inputs(card, 2, 2, 64, 64, 64, torch.bfloat16, True, 6)
    before, routes = mamba_scan_fwd.launches, dict(mamba_scan_fwd.routes)
    y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=32)
    assert mamba_scan_fwd.launches == before + 1
    assert mamba_scan_fwd.routes == {**routes, "chunks": routes["chunks"] + 1}
    _scan_close(y, state, xd, da, bm, cm, None, "chunks T2")


def test_scan_decode_residency(card):
    """The decode kernel's grid fits the card: at least 4 CTAs per SM
    (1,024 CTAs at batch 16 take at most 2 waves on 132 SMs); shared
    memory only with an initial state (its C·S0 partial sums, 4 KB)."""
    for dtype in (torch.bfloat16, torch.float32):
        for vec in (True, False):
            for s0 in (False, True):
                per_sm, smem = decode_residency(card, dtype, vec, s0)
                assert per_sm >= 4
                assert smem == (256 * 16 if s0 else 0)


# ----------------------------------------------------------------- measure
@pytest.mark.parametrize("desc", [GemmDesc(8, 5120, 5120),
                                  AttentionDesc(8, 40, 8, 1, 4096, 128)],
                         ids=lambda d: d.family)
def test_measurer_times_launches_on_the_card(card, desc):
    """The harness on the card: CUDA events around the grouped launch of
    a GEMM pool and around a mixed group of attention members on side
    streams (joined before the end event); every time finite, no hang,
    and the backend tag names the card."""
    entry = tune_gemm(desc) if isinstance(desc, GemmDesc) else tune_op(desc)
    mzr = Measurer(warmup=1, repeats=5)
    assert mzr.backend == backend_tag() == f"cuda-{torch.cuda.get_device_name()}"
    for cd in (1, 2, 4):
        m = mzr.measure_group(desc, entry.tile_for_cd(cd), cd)
        assert m.finite and m.hangs == 0 and m.n >= 3, (cd, m)
        assert m.backend == mzr.backend
