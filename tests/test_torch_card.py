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
groups' counters must be zero again after the launch.  bf16 prefills
take the prefill route (`attention_route`; `csrc/flash_prefill.cu`): it
must match `flash_ref` within `attention_tol` at ragged T, S > T, a
q_offset either way, a window, rep 1, 2, 4, 5 and 8, D 64, 80, 128 and
192/128 and the models' strided views, with no split buffers, one launch
counted on its route, a row that sees no key 0 and the same bits on a
rerun; a misaligned view and a non-positive scale raise before launching.

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
on a second run.  A T = 2 call still takes the chunked form.

The scan's wide passes (N or P above 128: xLSTM's N = P = 512 and its
normaliser's P = 1, odd wide widths, both routes, bf16 and f32, with and
without an initial state, ragged T) must match `ssd_chunk_ref` within the
same tolerance plus 2⁻¹⁶ of the terms' magnitude (`_scan_close`), give
the same bits on a second run, fit a CTA's shared memory, and a run with
one 64-row N block of C zeroed must fail the check.  Attention's cases
include Gemma3's windowed and StableLM's D 80 prefills, and the reduced
models every family, xLSTM on the rescaled tree.

The scan's chunked form (every T > 1: three launches, the chunks in
parallel, the products on tensor cores) must match `ssd_chunk_ref` within
the same tolerance at every T > 1 shape of `chip_smoke.py`'s SCAN_CASES,
Zamba2's 4,096-token prompt and a phase-9 piece, bf16 and f32, its
workspace's carried states the plain passes'; read strided inputs and
write ``out=``; give the same bits on a second run; and fail the check
when chunk 16's incoming state is taken as zero (a planted lost carry).

GEMM tolerance (as in `chip_smoke.py`): |kernel − plain| ≤ 2⁻⁷·|plain|
(bf16 outputs only: one rounding each) + 2⁻¹⁶·|A|·|B| (f32 summation
order over K).

Admission slicing on the card, through a `Runtime` that slices every op
it can into three pieces: a row-sliced GEMM on integer-valued operands
(every sum exact) merges bitwise into the unsliced run, and so does a
``ta`` one, whose pieces run on contiguous copies of their columns of A
(the launchers refuse a column view; ROADMAP C10); a query-row-sliced
causal attention (each piece a strided view of q and of the first keys
of k and v) within `attention_tol` of `flash_ref`; a batch-sliced scan
on the chunk loop within the scan tolerance of `ssd_chunk_ref`.

The runtime's fallback ladder on the card: a mixed full-width Qwen3-14B
bundle under injected raise and nan faults completes bitwise equal to the
fault-free run (integer-valued operands, every sum exact), and its
reference rung runs each member through the hand-written kernels — the
launch counters rise, and every plain version, made to raise, is never
entered.

Graph submission on the card: a two-layer decode graph of Qwen3-14B and
of Zamba2-1.2B at full width, batch 4, executed through the runtime.
Every node is held to its plain version on the operands it was given
(GEMMs as above, attention within `attention_tol`, the scan within 3e-4
plus half a bf16 unit); every data edge's consumer operand is a view of
its producer's output, the same storage; the counters show one attention
launch per attention node and one decode-kernel launch per scan node.  A
user transform that hands a GEMM a strided view raises (ROADMAP C10) and
computes nothing.

The MoE expert pool on the card: `grouped_for_desc` packs each expert's
rows to the tile's bm and runs `ragged_matmul`, at every bm of
`GROUPED_TILES`, over a 64-expert pool with zero-row experts (four
launches of at most 16 members) and its weights as views into one
(64, K, N) tensor or stacked; held to `ragged_gemm_ref` on the raw rows,
with exactly the launches `ragged_chunks` gives.  A reduced-width
DeepSeek-V2-Lite op bundle through an executing runtime, every member
held to its plain version, every grouped member on the ragged kernel.
"""
import dataclasses

import pytest
import torch

import repro_torch.kernels.flash_attention.ops as fops
import repro_torch.kernels.gemm.ops as gops
import repro_torch.kernels.grouped_gemm.ops as ggops
import repro_torch.kernels.mamba_scan.ops as mops
from repro_torch.configs import get_arch
from repro_torch.core import (
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    Measurer,
    ScanDesc,
    backend_tag,
    bind_operands,
    family_of,
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
    PREFILL_WIDTHS,
    attention_route,
    prefill_resources,
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
from repro_torch.core.tuner import GROUPED_TILES
from repro_torch.core import GroupedGemmDesc
from repro_torch.kernels.grouped_gemm import (
    grouped_for_desc,
    grouped_gemm_ref,
    pool_launches,
    ragged_gemm_ref,
)
from repro_torch.kernels.grouped_gemm import kernel as ggk
from repro_torch.core.scheduler import OP_FAMILIES
from repro_torch.kernels.mamba_scan import (
    chunk_workspace,
    mamba_scan_fwd,
    scan_for_desc,
    ssd_carry_ref,
    ssd_chunk_ref,
    ssd_chunk_states_ref,
)
from repro_torch.kernels.mamba_scan.kernel import (
    NARROW_DIM,
    chunk_residency,
    decode_residency,
)
from repro_torch.kernels.mamba_scan.ref import ssd_lost_carry
from repro_torch.runtime import (
    FAMILY_SLOTS,
    FaultInjector,
    FaultRule,
    OpGraph,
    Runtime,
    RuntimeConfig,
    decode_step_descs,
    decode_step_graph,
    decode_step_op_descs,
)
from repro_torch.runtime.graph import slot_shape
from repro_torch.models import build_model
from repro_torch.models.spec import tree_params
from repro_torch.train.serve_loop import greedy_decode

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
    (4, 32, 16, 2048, 2057, 128, 128, True, 1024, 0, 128, 128),  # Gemma3's local prefill
    (4, 32, 32, 1000, 1009, 80, 80, True, 0, 0, 128, 128),   # StableLM's D 80 prefill
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
    route = attention_route(q, k, v)    # bf16 prefills: the prefill kernel, unsplit
    bufs = attention_buffers(q, k, v)
    before = (flash_attention_fwd.launches, flash_attention_fwd.routes[route])
    out = flash_attention_fwd(q, k, v, bq=bq, bkv=bkv, out=bufs, **kw)
    assert (flash_attention_fwd.launches, flash_attention_fwd.routes[route]) == \
        (before[0] + 1, before[1] + 1) and out is bufs.out
    seen = (torch.arange(T, device=card) + off) >= 0   # rows that see a key
    ref = flash_ref(q.float(), k.float(), v.float(), **kw)
    atol, rtol = attention_tol(dtype)
    err = (out.float() - ref).abs()[:, :, seen]
    assert bool((err <= atol + rtol * ref.abs()[:, :, seen]).all()), err.max().item()
    if splits == 1 or route == "prefill":
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


# ----------------------------------------------------- attention, prefill route
PREFILL_CARD_CASES = [  # B, Hq, Hkv, T, S, D, Dv, window, q_offset, the models' views
    (1, 2, 2, 200, 200, 64, 64, 0, 0, False),        # rep 1, D 64
    (2, 4, 2, 333, 400, 128, 128, 0, 67, True),      # rep 2, ragged T, S > T, q_offset
    (1, 5, 1, 130, 170, 128, 128, 0, 0, True),       # rep 5: the written cache, S > T
    (1, 8, 1, 257, 300, 128, 128, 100, 43, False),   # rep 8, a window, q_offset
    (2, 4, 4, 100, 109, 80, 80, 0, 0, True),         # D 80 on the 128-wide kernel
    (1, 4, 4, 300, 300, 192, 128, 0, 0, True),       # MLA's 192/128
    (1, 4, 4, 65, 1000, 192, 128, 64, 935, False),   # 192/128, a window, a suffix
    (1, 4, 2, 100, 160, 64, 32, 0, -30, False),      # rows that see no key: 0
    (4, 40, 8, 1000, 1033, 128, 128, 0, 0, True),    # Qwen3-14B's prefill
    (4, 32, 32, 1000, 1033, 64, 64, 0, 0, True),     # Zamba2-1.2B's
    (4, 32, 16, 2048, 2057, 128, 128, 1024, 0, True),  # Gemma3-27B's local layers
]


def _prefill_operands(card, B, Hq, Hkv, T, S, D, Dv, views, seed):
    """bf16 q, k, v: contiguous, or as the models hand them over (q a
    transposed (B, T, Hq, D) view, k and v transposed views of a (B, S,
    Hkv, D) cache)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=card).to(torch.bfloat16)

    if views:
        return (rnd(B, T, Hq, D).transpose(1, 2), rnd(B, S, Hkv, D).transpose(1, 2),
                rnd(B, S, Hkv, Dv).transpose(1, 2))
    return rnd(B, Hq, T, D), rnd(B, Hkv, S, D), rnd(B, Hkv, S, Dv)


@pytest.mark.parametrize("case", PREFILL_CARD_CASES, ids=str)
def test_prefill_route_matches_plain(card, case):
    """The prefill kernel against `flash_ref` on f32 copies within
    `attention_tol`: one launch counted on the "prefill" route, no split
    buffers, a row that sees no key 0, and the same bits on a rerun."""
    B, Hq, Hkv, T, S, D, Dv, window, off, views = case
    q, k, v = _prefill_operands(card, B, Hq, Hkv, T, S, D, Dv, views, B * S + T)
    kw = dict(causal=True, window=window, q_offset=off)
    assert attention_route(q, k, v) == "prefill"
    bufs = attention_buffers(q, k, v)
    assert bufs.part_acc is None and bufs.part_ml is None and bufs.counter is None
    before = (flash_attention_fwd.launches, dict(flash_attention_fwd.routes))
    out = flash_attention_fwd(q, k, v, out=bufs, **kw)
    assert out is bufs.out and flash_attention_fwd.launches == before[0] + 1
    assert flash_attention_fwd.routes == {**before[1],
                                          "prefill": before[1]["prefill"] + 1}
    ref = flash_ref(q.float(), k.float(), v.float(), **kw)
    seen = (torch.arange(T, device=card) + off) >= 0
    atol, rtol = attention_tol(torch.bfloat16)
    err = (out.float() - ref).abs()[:, :, seen]
    assert bool((err <= atol + rtol * ref.abs()[:, :, seen]).all()), err.max().item()
    assert not out[:, :, ~seen].any()
    first = out.clone()
    assert torch.equal(flash_attention_fwd(q, k, v, out=bufs, **kw), first)


def test_prefill_route_refuses_what_its_tma_boxes_cannot_read(card):
    """A view one element past an aligned base, and a non-positive scale,
    raise before launching: the prefill route never falls back."""
    g = torch.Generator(device=card).manual_seed(3)
    flat = torch.randn(1 + 2 * 4 * 128 * 64, generator=g, device=card).to(torch.bfloat16)
    q = flat[1:].view(2, 4, 128, 64)
    k = torch.randn((2, 4, 128, 64), generator=g, device=card).to(torch.bfloat16)
    assert attention_route(q, k, k) == "prefill"
    before = dict(flash_attention_fwd.routes)
    with pytest.raises(ValueError, match="TMA"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="positive scale"):
        flash_attention_fwd(k, k, k, scale=0.0)
    assert flash_attention_fwd.routes == before


@pytest.mark.parametrize("widths", PREFILL_WIDTHS, ids=str)
def test_prefill_residency(card, widths):
    """One CTA of 384 threads per SM, its ring within the SM's 227 KB."""
    per_sm, smem = prefill_resources(card, *widths)
    assert per_sm == 1 and 64 * 1024 < smem <= 232448


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
WIDE_SUM_TOL = 2.0 ** -16   # of the terms' magnitude, N or P > 128


def _scan_close(y, state, xd, da, bm, cm, s0, what):
    """y and the state against `ssd_chunk_ref` on f32 copies of the same
    inputs (bf16 converts exactly), within SCAN_TOL + SCAN_TOL·|plain|,
    plus half a bf16 unit (2⁻⁸·|plain|) for a bf16 y's one rounding; where
    N or P exceeds 128 (the wide passes) plus WIDE_SUM_TOL·Σ|terms|, the
    plain version on |xd|, |B|, |C| and |s0| (`chip_smoke.py:scan_excess`
    says why)."""
    f32 = [t.float() for t in (xd, da, bm, cm)]
    y_ref, s_ref = ssd_chunk_ref(*f32, chunk=64, initial_state=s0)
    atol = (SCAN_TOL, SCAN_TOL)
    if max(bm.shape[-1], xd.shape[-1]) > NARROW_DIM:
        mags = ssd_chunk_ref(f32[0].abs(), f32[1], f32[2].abs(), f32[3].abs(), chunk=64,
                             initial_state=None if s0 is None else s0.abs())
        atol = tuple(SCAN_TOL + WIDE_SUM_TOL * m for m in mags)
    rtol = SCAN_TOL + (2.0 ** -8 if y.dtype == torch.bfloat16 else 0.0)
    for out, ref, at, rt, name in ((y, y_ref, atol[0], rtol, "y"),
                                   (state, s_ref, atol[1], SCAN_TOL, "state")):
        assert out.shape == ref.shape, (what, name)
        assert torch.isfinite(out.float()).all(), (what, name)
        err = (out.float() - ref.float()).abs()
        assert bool((err <= at + rt * ref.float().abs()).all()), \
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
    """T = 2 is no decode step: it launches the chunked form (the chunks
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


# ------------------------------------------------ the scan's chunked form
# chip_smoke.py's SCAN_CASES with T > 1 (B, T, H, P, N, chunk, initial
# state, head-broadcast B/C), Zamba2's prompt scan and the phase-9 piece.
CHUNK_CASES = [(2, 70, 3, 16, 8, 32, False, False), (2, 2, 64, 64, 64, 32, True, True),
               (1, 600, 2, 64, 64, 512, True, False), (1, 300, 2, 32, 16, 8, True, True),
               (1, 200, 4, 64, 128, 64, False, False), (2, 97, 2, 128, 32, 128, True, True),
               (1, 4096, 64, 64, 64, 128, False, True), (2, 1024, 64, 64, 64, 128, True, True)]


def _chunks(xd, da, bm, cm, chunk, **kw):
    """`mamba_scan_fwd` on a T > 1 call, asserting one call on the chunks
    route; returns y, the state and the workspace after the launch."""
    B, T, H, P = xd.shape
    ws = chunk_workspace(B, T, H, P, bm.shape[-1], chunk, xd.device)
    before, routes = mamba_scan_fwd.launches, dict(mamba_scan_fwd.routes)
    y, state = mamba_scan_fwd(xd, da, bm, cm, chunk=chunk, workspace=ws, **kw)
    assert mamba_scan_fwd.launches == before + 1
    assert mamba_scan_fwd.routes == {**routes, "chunks": routes["chunks"] + 1}
    return y, state, ws


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda c: "x".join(map(str, c)))
def test_scan_chunks_match_plain(card, case, dtype):
    """The chunked form against `ssd_chunk_ref` (y and the final state), and
    its carried states (the workspace after the launch: each chunk's
    incoming state) against the plain passes' within the same tolerance."""
    B, T, H, P, N, L, with_s0, bcast = case
    xd, da, bm, cm = _scan_inputs(card, B, T, H, P, N, dtype, bcast, T + N + P)
    g = torch.Generator(device=card).manual_seed(L)
    s0 = torch.randn((B, H, N, P), generator=g, device=card) if with_s0 else None
    y, state, (incoming, decay) = _chunks(xd, da, bm, cm, L, initial_state=s0)
    assert y.dtype == dtype and state.dtype == torch.float32
    _scan_close(y, state, xd, da, bm, cm, s0, f"chunks {case}")
    f32 = [t.float() for t in (xd, da, bm, cm)]
    states, want_decay = ssd_chunk_states_ref(*f32, chunk=L)
    want_in, _ = ssd_carry_ref(states, want_decay, s0)
    for got, want, name in ((incoming, want_in, "incoming"), (decay, want_decay, "decay")):
        err = (got - want).abs()
        assert bool((err <= SCAN_TOL + SCAN_TOL * want.abs()).all()), \
            f"chunks {case} {name}: max |err| {err.max().item():.3g}"


def test_scan_chunks_second_run_is_bitwise_equal(card):
    for dtype in (torch.bfloat16, torch.float32):
        xd, da, bm, cm = _scan_inputs(card, 2, 1024, 64, 64, 64, dtype, True, 21)
        s0 = torch.randn((2, 64, 64, 64), device=card)
        y, state, _ = _chunks(xd, da, bm, cm, 128, initial_state=s0)
        y2, state2, _ = _chunks(xd, da, bm, cm, 128, initial_state=s0)
        assert torch.equal(y, y2) and torch.equal(state, state2)


def test_scan_chunks_read_strided_inputs_and_write_out_buffers(card):
    """xd a (B,T,H,P) view of wider (B,H,T,P+8) storage and B/C per head
    views of (B,T,N+8,H) storage: every stride but the last read as it
    is, rows not 16-byte aligned (element loads); ``out=`` written."""
    B, T, H, P, N, L = 2, 300, 4, 64, 64, 128
    g = torch.Generator(device=card).manual_seed(22)
    xd = torch.randn((B, H, T, P + 8), generator=g, device=card).bfloat16()[..., 1:P + 1]
    xd = xd.transpose(1, 2)
    bm, cm = (torch.randn((B, T, H, N + 8), generator=g, device=card).mul_(0.5)
              .bfloat16()[..., 3:N + 3] for _ in range(2))
    da = (torch.rand((B, T, H), generator=g, device=card) * -0.5).bfloat16()
    assert not xd.is_contiguous() and bm.stride(2) == N + 8
    y = torch.full((B, T, H, P), float("nan"), device=card, dtype=torch.bfloat16)
    state = torch.full((B, H, N, P), float("nan"), device=card)
    got = _chunks(xd, da, bm, cm, L, out=(y, state))
    assert got[0] is y and got[1] is state
    _scan_close(y, state, xd, da, bm, cm, None, "chunks strided")


def test_scan_chunks_planted_carry_fault_fails_the_check(card):
    """At Zamba2's prompt shape, the kernel's outputs with chunk 16's
    incoming state taken as zero (`ssd_lost_carry`) must fail the scan
    tolerance: the check sees a lost carry."""
    xd, da, bm, cm = _scan_inputs(card, 1, 4096, 64, 64, 64, torch.bfloat16, True, 23)
    y, state, (incoming, decay) = _chunks(xd, da, bm, cm, 128)
    _scan_close(y, state, xd, da, bm, cm, None, "prompt scan")
    fy, fs = ssd_lost_carry(y, state, incoming, decay, xd, da, bm, cm, chunk=128, lost=16)
    with pytest.raises(AssertionError):
        _scan_close(fy, fs, xd, da, bm, cm, None, "lost carry")


def test_scan_family_buffers_hold_the_chunks_workspace(card):
    """A scan member's family ``buffers`` hook (what a mixed launch takes on
    its launching stream) gives y, the state and the workspace at the
    tile's chunk: `scan_for_desc` into them allocates nothing, and the
    workspace after the launch holds each chunk's incoming state."""
    desc, L = ScanDesc(2, 1024, 64, 64, 64), 64
    xd, da, bm, cm = _scan_inputs(card, 2, 1024, 64, 64, 64, torch.bfloat16, True, 24)
    tile = TileConfig(L, 128, 128)
    bufs = OP_FAMILIES["mamba_scan"].buffers(desc, xd, da, bm, cm, tile=tile)
    incoming, decay = bufs[2]
    assert incoming.shape == (2, 64, 1024 // L, 64, 64)
    incoming.fill_(float("nan"))
    torch.cuda.synchronize(card)
    allocs = torch.cuda.memory_stats(card)["allocation.all.allocated"]
    y = scan_for_desc(desc, xd, da, bm, cm, tile=tile, out=bufs)
    torch.cuda.synchronize(card)
    assert torch.cuda.memory_stats(card)["allocation.all.allocated"] == allocs
    assert y is bufs[0]
    _scan_close(y, bufs[1], xd, da, bm, cm, None, "family buffers")
    f32 = [t.float() for t in (xd, da, bm, cm)]
    want_in, _ = ssd_carry_ref(*ssd_chunk_states_ref(*f32, chunk=L), None)
    err = (incoming - want_in).abs()
    assert bool((err <= SCAN_TOL + SCAN_TOL * want_in.abs()).all())


def test_scan_chunk_residency(card):
    """The chunked form's passes fit the card at Zamba2's prompt widths:
    two CTAs or more per SM for each pass in bf16, and shared memory within
    a CTA's 227 KB at the widest f32 instantiation."""
    blocks, smem = chunk_residency(card, torch.bfloat16, 2, 64, 64, 128)
    assert min(blocks) >= 2, blocks
    blocks, smem = chunk_residency(card, torch.float32, 1, 128, 128, 512)
    assert min(blocks) >= 1 and max(smem) <= 232448


# ------------------------------------------------ the scan's wide passes
# (B, T, H, P, N, chunk, initial state, head-broadcast B/C): xLSTM-350M's
# prompt scans at batch 4 (its memory, N = P = 512, and its normaliser,
# P = 1) and decode steps, odd wide widths, ragged T, a wide P under a
# narrow N, a wide N under a narrow P.
WIDE_CASES = [(4, 1000, 4, 512, 512, 128, True, False), (4, 1000, 4, 1, 512, 128, True, False),
              (1, 300, 2, 512, 512, 128, False, False), (2, 97, 2, 200, 300, 64, True, True),
              (1, 130, 1, 130, 8, 64, False, False), (1, 77, 3, 1, 512, 32, False, True),
              (4, 1, 4, 512, 512, 128, True, False), (4, 1, 4, 1, 512, 128, True, False),
              (2, 1, 3, 300, 200, 128, False, True), (1, 1, 2, 512, 512, 128, False, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", WIDE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_scan_wide_matches_plain(card, case, dtype):
    """N or P above 128 on both routes (the wide passes for T > 1, the
    decode kernel's wide instantiation for a wide N at T = 1) against
    `ssd_chunk_ref`, and on the chunks route its carried states, within
    the scan tolerance."""
    B, T, H, P, N, L, with_s0, bcast = case
    xd, da, bm, cm = _scan_inputs(card, B, T, H, P, N, dtype, bcast, T + N + P)
    g = torch.Generator(device=card).manual_seed(L + 1)
    s0 = torch.randn((B, H, N, P), generator=g, device=card) if with_s0 else None
    if T == 1:
        y, state = _decode(xd, da, bm, cm, initial_state=s0)
        _scan_close(y, state, xd, da, bm, cm, s0, f"wide decode {case}")
        return
    y, state, (incoming, decay) = _chunks(xd, da, bm, cm, L, initial_state=s0)
    _scan_close(y, state, xd, da, bm, cm, s0, f"wide chunks {case}")
    want_in, _ = ssd_carry_ref(*ssd_chunk_states_ref(*(t.float() for t in (xd, da, bm, cm)),
                                                     chunk=L), s0)
    err = (incoming - want_in).abs()
    assert bool((err <= SCAN_TOL + SCAN_TOL * want_in.abs()).all()), err.max().item()


def test_scan_wide_second_run_is_bitwise_equal(card):
    for dtype in (torch.bfloat16, torch.float32):
        for T in (300, 1):
            xd, da, bm, cm = _scan_inputs(card, 2, T, 2, 512, 512, dtype, False, 32)
            s0 = torch.randn((2, 2, 512, 512), device=card)
            first = mamba_scan_fwd(xd, da, bm, cm, chunk=128, initial_state=s0)
            again = mamba_scan_fwd(xd, da, bm, cm, chunk=128, initial_state=s0)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_scan_wide_planted_dropped_n_block_fails_the_check(card):
    """At xLSTM's prompt shape, the kernel run with C's third 64-row N block
    zeroed, which is what a wide output pass that dropped that block of
    C·S_prev and of G = C·Bᵀ would give, must fail the check against the
    true inputs, in bf16 and f32."""
    for dtype in (torch.bfloat16, torch.float32):
        xd, da, bm, cm = _scan_inputs(card, 4, 1000, 4, 512, 512, dtype, False, 33)
        s0 = torch.randn((4, 4, 512, 512), device=card)
        y, state, _ = _chunks(xd, da, bm, cm, 128, initial_state=s0)
        _scan_close(y, state, xd, da, bm, cm, s0, "wide prompt scan")
        dropped = cm.clone()
        dropped[..., 128:192] = 0
        fy, fs, _ = _chunks(xd, da, bm, dropped, 128, initial_state=s0)
        with pytest.raises(AssertionError):
            _scan_close(fy, fs, xd, da, bm, cm, s0, "dropped N block")


def test_scan_wide_residency(card):
    """The wide passes fit a CTA's 227 KB at the widest f32 instantiation
    (N = P = 512, L = 512), one CTA or more per SM each; the decode
    kernel's wide instantiation keeps two or more per SM with a state."""
    for dtype in (torch.bfloat16, torch.float32):
        blocks, smem = chunk_residency(card, dtype, 1, 512, 512, 512)
        assert min(blocks) >= 1 and max(smem) <= 232448, (blocks, smem)
        per_sm, _ = decode_residency(card, dtype, True, True, wide=True)
        assert per_sm >= 2


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


# ---------------------------------------------------------- fallback ladder
def _qwen_bundle(card, seed: int, batch: int = 4, context: int = 0):
    """One layer of Qwen3-14B's decode bundle at full width: its seven
    unfused GEMMs with integer-valued bf16 operands (every f32 sum exact,
    so every rung and tile gives the same bits), and with ``context`` the
    attention read over a random KV cache of that length."""
    cfg = get_arch("qwen3-14b")
    g = torch.Generator(device=card).manual_seed(seed)

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=g, device=card).to(torch.bfloat16)

    reqs = [GemmRequest(desc=d, a=ints(d.M, d.K), b=ints(d.K, d.N))
            for _, bundle in decode_step_descs(cfg, batch) for d in bundle]
    if context:
        (d,) = [d for d in decode_step_op_descs(cfg, batch, context)
                if d.family == "flash_attention"]
        reqs.append(bind_operands(d, tuple(
            torch.randn(s, generator=g, device=card).to(torch.bfloat16)
            for s in ((d.B, d.Hq, d.Sq, d.D), (d.B, d.Hkv, d.Skv, d.D),
                      (d.B, d.Hkv, d.Skv, d.D)))))
    return reqs


def _serve_bundle(card, reqs, injector=None, **cfg):
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True, **cfg), device=card,
                 fault_injector=injector)
    handle = rt.submit(reqs)
    launches = rt.drain()
    torch.cuda.synchronize()
    assert handle.done
    return rt, [m.result for m in handle.members], launches


@pytest.mark.parametrize("seed", [1, 2])
def test_ladder_on_a_mixed_qwen3_bundle_equals_the_fault_free_run(card, seed):
    """Injected raise and nan faults on a mixed full-width bundle: every
    member completes on some rung, bitwise equal to the fault-free run
    (exact integer sums), and the faults reconcile with the log."""
    reqs = _qwen_bundle(card, seed)
    _, want, launches = _serve_bundle(card, reqs)
    assert any(ln.plan.mode == "mixed" for ln in launches)
    inj = FaultInjector((FaultRule("raise", 0.2), FaultRule("nan", 0.2)), seed=seed)
    rt, got, _ = _serve_bundle(card, reqs, inj, quarantine_strikes=2)
    for g_, w in zip(got, want, strict=True):
        assert torch.equal(g_, w)
    assert inj.log and 0 < rt.telemetry.fault_events <= len(inj.log)
    assert rt.telemetry.fallback_events > 0
    assert set(rt.telemetry.faults) <= {"raise", "nan"}


def test_reference_rung_launches_kernels_only(card, monkeypatch):
    """Every launch fails until the reference rung, which runs each member
    alone through its family op: the launch counters rise and no plain
    version is entered (each is made to raise)."""
    reqs = _qwen_bundle(card, 3, batch=1, context=4096)
    want = [gemm_ref(r.a, r.b) for r in reqs[:-1]]
    q, k, v = reqs[-1].inputs
    ref = flash_ref(q.float(), k.float(), v.float(), q_offset=k.shape[2] - q.shape[2])

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    for mod, names in ((gops, ("gemm_ref", "gemm_stream_k_ref", "splitk_partials_ref",
                               "splitk_reduce_ref")),
                       (ggops, ("grouped_gemm_ref", "ragged_gemm_ref")),
                       (fops, ("flash_ref",))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    launchers = (*gk.LAUNCHERS, ggk.grouped_matmul, ggk.ragged_matmul,
                 flash_attention_fwd)
    before = [fn.launches for fn in launchers]
    inj = FaultInjector((FaultRule("raise", 1.0),), seed=0)
    rt, got, launches = _serve_bundle(card, reqs, inj)
    assert {ln.fallback for ln in launches} == {"reference"}
    launched = [fn.launches - b for fn, b in zip(launchers, before)]
    assert sum(launched) == len(reqs) and launched[-1] == 1, launched
    for g_, w in zip(got, want):
        assert torch.equal(g_, w)
    atol, rtol = attention_tol(torch.bfloat16)
    assert bool(((got[-1].float() - ref).abs() <= atol + rtol * ref.abs()).all())


# ------------------------------------------------ admission slicing
# Every op the runtime can slice, in three pieces.
SLICE_ALL = dict(slicing=True, flush_budget_s=10.0, slice_budget_frac=1e-9,
                 max_slices=3)


def _serve_one(card, work, **cfg):
    """``work`` (a request, or a sequence for a bundle) through a runtime
    on the card; returns its ticket (a bundle's one member)."""
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True, **cfg), device=card)
    tk = rt.submit(work)
    rt.drain()
    torch.cuda.synchronize()
    assert tk.done and not rt.telemetry.fault_events
    return tk.members[0] if tk.members else tk


@pytest.mark.parametrize("ta", [False, True], ids=["rows", "ta_columns"])
def test_row_sliced_gemm_merges_bitwise(card, ta):
    g = torch.Generator(device=card).manual_seed(11)
    d = GemmDesc(1000, 1024, 5120, ta=ta)
    a = torch.randint(-3, 4, (d.K, d.M) if ta else (d.M, d.K), generator=g,
                      device=card).to(torch.bfloat16)
    b = torch.randint(-3, 4, (d.K, d.N), generator=g, device=card).to(torch.bfloat16)
    whole = _serve_one(card, GemmRequest(desc=d, a=a, b=b))
    sliced = _serve_one(card, GemmRequest(desc=d, a=a, b=b), **SLICE_ALL)
    assert not whole.sliced and [p.desc.M for p in sliced.pieces] == [334, 333, 333]
    assert all(p.request.a.is_contiguous() for p in sliced.pieces)
    assert torch.equal(sliced.result, whole.result)
    assert torch.equal(whole.result, gemm_ref(a, b, ta=ta))


def test_sq_sliced_causal_attention_matches_plain(card):
    g = torch.Generator(device=card).manual_seed(12)
    d = AttentionDesc(1, 40, 8, 1024, 1536, 128)
    q, k, v = (torch.randn(s, generator=g, device=card).to(torch.bfloat16)
               for s in ((1, 40, 1024, 128), (1, 8, 1536, 128), (1, 8, 1536, 128)))
    before = flash_attention_fwd.launches
    tk = _serve_one(card, [bind_operands(d, (q, k, v))], **SLICE_ALL)
    assert [(p.desc.Sq, p.desc.Skv) for p in tk.pieces] == \
        [(342, 854), (341, 1195), (341, 1536)]
    assert flash_attention_fwd.launches == before + 3
    ref = flash_ref(q.float(), k.float(), v.float(), q_offset=512)
    atol, rtol = attention_tol(torch.bfloat16)
    assert tk.result.shape == ref.shape
    err = (tk.result.float() - ref).abs()
    assert bool((err <= atol + rtol * ref.abs()).all()), err.max().item()


def test_batch_sliced_scan_runs_the_chunk_loop_within_tolerance(card):
    d = ScanDesc(4, 256, 8, 64, 64)
    xd, da, bm, cm = _scan_inputs(card, 4, 256, 8, 64, 64, torch.bfloat16, True, 13)
    before = dict(mamba_scan_fwd.routes)
    tk = _serve_one(card, [bind_operands(d, (xd, da, bm, cm))], **SLICE_ALL)
    assert [p.desc.B for p in tk.pieces] == [2, 1, 1]
    assert mamba_scan_fwd.routes["chunks"] == before["chunks"] + 3
    y_ref, _ = ssd_chunk_ref(xd.float(), da.float(), bm.float(), cm.float(), chunk=64)
    assert tk.result.shape == y_ref.shape
    err = (tk.result.float() - y_ref).abs()
    rtol = SCAN_TOL + 2.0 ** -8
    assert bool((err <= SCAN_TOL + rtol * y_ref.abs()).all()), err.max().item()


# ----------------------------------------------------- graph submission
def _decode_graph(card, name: str, seed: int, batch: int = 4, layers: int = 2,
                  context: int = 2048) -> OpGraph:
    """A decode graph of ``name`` at full width with every slot no data
    edge feeds given a random bf16 operand (weights scaled by K^-1/2; the
    scan's da negative and its B/C head-broadcast views)."""
    g = decode_step_graph(get_arch(name), batch, context, layers=layers)
    gen = torch.Generator(device=card).manual_seed(seed)
    wired = {(e.dst, e.slot) for e in g.edges if e.slot is not None}
    for node in g.nodes.values():
        d, fam = node.desc, family_of(node.desc)
        for slot in FAMILY_SLOTS[fam]:
            if (node.name, slot) in wired:
                continue
            shape = slot_shape(d, slot)
            if fam == "mamba_scan" and slot in (2, 3):
                t = torch.randn((d.B, d.T, 1, d.N), generator=gen, device=card)
                t = t.to(torch.bfloat16).expand(shape)
            elif fam == "mamba_scan" and slot == 1:
                t = (torch.rand(shape, generator=gen, device=card) * -0.5).to(torch.bfloat16)
            else:
                scale = d.K ** -0.5 if slot == "b" else 1.0
                t = (torch.randn(shape, generator=gen, device=card) * scale).to(torch.bfloat16)
            node.operands[slot] = t
    return g


@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b"])
def test_decode_graph_executes_on_the_card(card, name):
    g = _decode_graph(card, name, 21)
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device=card)
    before = (flash_attention_fwd.launches, dict(mamba_scan_fwd.routes))
    h = rt.submit(g)
    rt.drain()
    torch.cuda.synchronize()
    assert h.done and rt.telemetry.graphs_completed == 1
    assert not rt.telemetry.fault_events and not rt.telemetry.fallback_events
    fams = [family_of(n.desc) for n in g.nodes.values()]
    assert flash_attention_fwd.launches - before[0] == fams.count("flash_attention")
    routes = {k: mamba_scan_fwd.routes[k] - before[1][k] for k in before[1]}
    assert routes == {"decode": fams.count("mamba_scan"), "chunks": 0}
    for name_, tk in h.nodes.items():
        r, fam = tk.request, family_of(tk.desc)
        if fam == "gemm":
            _check(tk.result, r.a, r.b, False, False, name_)
        elif fam == "flash_attention":
            q, k, v = (x.float() for x in r.inputs)
            ref = flash_ref(q, k, v, q_offset=k.shape[2] - q.shape[2])
            atol, rtol = attention_tol(torch.bfloat16)
            err = (tk.result.float() - ref).abs()
            assert bool((err <= atol + rtol * ref.abs()).all()), name_
        else:
            y_ref, _ = ssd_chunk_ref(*(x.float() for x in r.inputs))
            err = (tk.result.float() - y_ref).abs()
            rtol = SCAN_TOL + 2.0 ** -8
            assert bool((err <= SCAN_TOL + rtol * y_ref.abs()).all()), name_
    for e in g.edges:
        if e.slot is not None:
            dst = h[e.dst].request
            got = dst.a if e.slot == "a" else dst.inputs[e.slot]
            assert got.data_ptr() == h.result_of(e.src).data_ptr(), (e.src, e.dst)
            assert got.is_contiguous()


def test_graph_transform_to_a_strided_view_raises(card):
    """A transform that hands a GEMM a column view: the card's launcher
    refuses it (ROADMAP C10) rather than compute, and the graph stays
    unfinished."""
    gen = torch.Generator(device=card).manual_seed(22)
    d, wide = GemmDesc(8, 256, 256), GemmDesc(8, 512, 256)
    g = OpGraph()
    g.add("x", wide, operands={
        "a": torch.randn((8, 256), generator=gen, device=card).to(torch.bfloat16),
        "b": torch.randn((256, 512), generator=gen, device=card).to(torch.bfloat16)})
    g.add("y", d, deps={"a": ("x", lambda r: r[:, :256])}, operands={
        "b": torch.randn((256, 256), generator=gen, device=card).to(torch.bfloat16)})
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device=card)
    h = rt.submit(g)
    with pytest.raises(ValueError, match="contiguous"):
        rt.drain()
    torch.cuda.synchronize()
    assert not h["y"].request.a.is_contiguous()
    assert h["x"].done_t is not None and h["y"].done_t is None and not h.done
    assert rt.drain() == [] and not rt.telemetry.fault_events


# ------------------------------------------------------- the MoE expert pool
POOL_ROWS = tuple([2, 1, 0, 3] * 16)    # 64 experts, 16 of them with no row


@pytest.mark.parametrize("stacked", [False, True], ids=["views", "stacked"])
@pytest.mark.parametrize("bm", sorted({t.bm for t in GROUPED_TILES}))
def test_grouped_for_desc_at_every_bm_matches_plain(card, bm, stacked):
    d = GroupedGemmDesc(64, sum(POOL_ROWS), 1408, 2048, rows=POOL_ROWS)
    g = torch.Generator(device=card).manual_seed(bm)
    a = torch.randn((d.M, d.K), generator=g, device=card, dtype=torch.bfloat16)
    w = torch.randn((64, d.K, d.N), generator=g, device=card,
                    dtype=torch.bfloat16).mul_(d.K ** -0.5)
    b = w if stacked else list(w.unbind(0))
    before = ggk.ragged_matmul.launches
    out = grouped_for_desc(d, a, b, tile=TileConfig(bm, 128, 128))
    assert ggk.ragged_matmul.launches - before == pool_launches(d, bm) == 4
    assert out.shape == (d.M, d.N) and out.dtype == torch.bfloat16
    sizes = list(d.row_vector())
    _close(out, ragged_gemm_ref(a, w, sizes),
           ragged_gemm_ref(a.float().abs(), w.float().abs(), sizes), f"pool bm {bm}")
    again = grouped_for_desc(d, a, b, tile=TileConfig(bm, 128, 128))
    assert torch.equal(again, out)


def test_reduced_moe_bundle_through_the_runtime(card):
    """One layer of a reduced-width DeepSeek-V2-Lite bundle (MLA attention,
    dense per-expert GEMMs, both expert pools with their weights as views,
    the shared experts) at batches 1 and 4, executed: every member within
    its plain version's tolerance, one ragged launch per chunk of each
    grouped member, no fault and no fallback."""
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    g = torch.Generator(device=card).manual_seed(23)
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device=card)
    rt.set_available(4)
    handles = []
    for batch in (1, 4):
        reqs = []
        for d in decode_step_op_descs(cfg, batch, 256):
            if d.family == "gemm":
                ops = (torch.randn((d.M, d.K), generator=g, device=card),
                       torch.randn((d.K, d.N), generator=g, device=card) * d.K ** -0.5)
            elif d.family == "grouped_gemm":
                w = torch.randn((d.G, d.K, d.N), generator=g, device=card) * d.K ** -0.5
                ops = (torch.randn((d.M, d.K), generator=g, device=card),
                       list(w.to(torch.bfloat16).unbind(0)))
            else:
                ops = tuple(torch.randn(s, generator=g, device=card) for s in (
                    (d.B, d.Hq, d.Sq, d.D), (d.B, d.Hkv, d.Skv, d.D),
                    (d.B, d.Hkv, d.Skv, d.D)))
            ops = tuple(x if isinstance(x, list) else x.to(torch.bfloat16) for x in ops)
            reqs.append(bind_operands(d, ops))
        handles.append(rt.submit(reqs))
    before = (ggk.ragged_matmul.launches, flash_attention_fwd.launches)
    launches = rt.drain()
    torch.cuda.synchronize()
    assert all(h.done for h in handles)
    assert not rt.telemetry.fault_events and not rt.telemetry.fallback_events
    members = [m for h in handles for m in h.members]
    want_ragged = 0
    for ln in launches:
        for tk, tile in zip(ln.tickets, ln.plan.tiles or [ln.plan.tile]):
            if tk.desc.family == "grouped_gemm":
                want_ragged += pool_launches(tk.desc, tile.bm)
    assert ggk.ragged_matmul.launches - before[0] == want_ragged > 0
    assert flash_attention_fwd.launches - before[1] == 2
    for tk in members:
        r = tk.request
        if tk.desc.family == "gemm":
            _check(tk.result, r.a, r.b, False, False, tk.desc.key())
        elif tk.desc.family == "grouped_gemm":
            a, ws = r.inputs
            sizes = list(tk.desc.row_vector())
            _close(tk.result, ragged_gemm_ref(a, ws, sizes),
                   ragged_gemm_ref(a.float().abs(), _abs(ws), sizes), tk.desc.key())
        else:
            q, k, v = (x.float() for x in r.inputs)
            ref = flash_ref(q, k, v, q_offset=k.shape[2] - q.shape[2])
            atol, rtol = attention_tol(torch.bfloat16)
            err = (tk.result.float() - ref).abs()
            assert bool((err <= atol + rtol * ref.abs()).all()), tk.desc.key()


# ------------------------------------------------------------ the models
MODEL_TOL = 2e-3   # as chip_smoke.py's model check: ·max(1, max |CPU|)


def _model_launches():
    return (flash_attention_fwd.launches, dict(mamba_scan_fwd.routes),
            ggk.grouped_matmul.launches)


# depths that reach a reduced model's structure: two xLSTM groups (the
# reduced 2 layers hold none), Gemma3's global layer (layer 5 of 12)
REDUCED_DEPTH = {"xlstm-350m": 8, "gemma3-27b": 12}
# models held on the rescaled tree, as the CPU tests hold them
# (`tests/test_torch_models.py:fan_in_rescaled` says why): at the
# reference's σ (scale/√2 for xLSTM's twice-stacked leaves at 2 groups)
# the residual grows to ~10² and the f32 logits move with any order of
# summation
RESCALED_CARD = ("xlstm-350m",)


@torch.no_grad()
def _rescale(model):
    """Each normal matrix weight from σ = scale/√fan_in to scale/√(its
    input width)."""
    for path, spec, p in tree_params(model, model.specs()):
        if spec.init == "normal" and len(spec.shape) >= 2:
            p.mul_((spec.fan_in / spec.shape[-2]) ** 0.5)


@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b", "deepseek-v2-lite-16b",
                                  "stablelm-3b", "gemma3-27b", "xlstm-350m",
                                  "pixtral-12b"])
def test_reduced_model_greedy_on_the_card_matches_the_cpu(card, name, monkeypatch):
    """One reduced-width model per family: `greedy_decode` on the card
    with every plain version made to raise (the kernels alone run: one
    attention launch per attention layer in the prefill, the scan on the
    chunks route per Mamba layer (two per mLSTM layer) in the prefill and
    on the decode kernel per layer and step, three grouped launches per
    MoE layer and forward), then the same weights on the CPU fed the
    card's tokens: every call's logits within MODEL_TOL.  The 150-token
    prompt spans two of the scan's 128-row chunks and Gemma3's reduced
    64-token window; Pixtral's 256 patches go in front of it."""
    cfg = get_arch(name).reduced()
    cfg = dataclasses.replace(cfg, n_layers=REDUCED_DEPTH.get(name, cfg.n_layers))
    model = build_model(cfg, device=card, seed=11)
    if name in RESCALED_CARD:
        _rescale(model)
    cpu = build_model(cfg, device="cpu", seed=None)
    cpu.load_state_dict(model.state_dict())
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (2, 150),
                                      generator=torch.Generator().manual_seed(5))}
    if cfg.frontend == "vision_patches":
        prompt["patches"] = 0.1 * torch.randn((2, 256, cfg.d_model),
                                              generator=torch.Generator().manual_seed(6))
    T = 150 + (256 if "patches" in prompt else 0)
    steps, seen = 4, []

    def plain(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    with monkeypatch.context() as m:
        for mod, fn in ((fops, "flash_ref"), (mops, "ssd_chunk_ref"),
                        (ggops, "grouped_gemm_ref"), (ggops, "ragged_gemm_ref")):
            m.setattr(mod, fn, plain)
        attn0, routes0, grouped0 = _model_launches()
        toks = greedy_decode(model, prompt, s_max=T + steps + 2, steps=steps,
                             device=card, on_step=seen.append).cpu()
        attn1, routes1, grouped1 = _model_launches()
    hybrid, moe, ssm = cfg.family == "hybrid", cfg.family == "moe", cfg.family == "ssm"
    mamba = (cfg.n_layers if hybrid else
             2 * cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1) if ssm else 0)
    assert attn1 - attn0 == (cfg.n_layers // cfg.attn_every if hybrid else
                             0 if ssm else cfg.n_layers)
    assert {k: routes1[k] - routes0[k] for k in routes1} == {"decode": mamba * steps,
                                                             "chunks": mamba}
    moe_layers = cfg.n_layers - cfg.first_dense_layers if moe else 0
    assert grouped1 - grouped0 == (steps + 1) * 3 * moe_layers * -(
        -cfg.n_routed_experts // ggk.MAX_MEMBERS)
    with torch.inference_mode():
        cache = cpu.init_cache(2, T + steps + 2, torch.float32)
        logits, cache, n = cpu.prefill(prompt, cache)
        ref = [logits]
        for i in range(steps):
            logits, cache, n = cpu.decode_step(toks[:, i:i + 1], cache, n)
            ref.append(logits)
    for i, (got, want) in enumerate(zip(seen, ref)):
        got = got.cpu()
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= MODEL_TOL * max(1.0, float(want.abs().max())), (i, err)


# ---------------------------------------------------------------- training
def _grad_launchers(card):
    """Each launcher with one operand that requires grad."""
    f32 = dict(device=card, dtype=torch.float32)
    a = torch.randn((64, 128), **f32, requires_grad=True)
    b = torch.randn((128, 256), **f32)
    q = torch.randn((1, 2, 16, 64), **f32, requires_grad=True)
    kv = torch.randn((1, 2, 16, 64), **f32)
    xd = torch.randn((1, 16, 2, 8), **f32, requires_grad=True)
    da = -torch.rand((1, 16, 2), **f32)
    bc = torch.randn((1, 16, 2, 8), **f32)
    return {
        "matmul": lambda: gk.matmul(a, b),
        "splitk_matmul": lambda: gk.splitk_matmul(a, b, split=2, slice_k=64),
        "stream_k_matmul": lambda: gk.stream_k_matmul(a, b, grid_g=4),
        "grouped_matmul": lambda: ggk.grouped_matmul(a[None], b[None]),
        "ragged_matmul": lambda: ggk.ragged_matmul(a, b[None], [64], bm=16),
        "flash_attention_fwd": lambda: flash_attention_fwd(q, kv, kv),
        "mamba_scan_fwd": lambda: mamba_scan_fwd(xd, da, bc, bc),
    }


@pytest.mark.parametrize("name", ["matmul", "splitk_matmul", "stream_k_matmul",
                                  "grouped_matmul", "ragged_matmul",
                                  "flash_attention_fwd", "mamba_scan_fwd"])
def test_launcher_refuses_grad_outside_its_function(card, name):
    """A launch records no backward: under grad, with an operand that
    requires it, each launcher raises and launches nothing; with grad
    disabled it runs."""
    calls = _grad_launchers(card)
    counters = [gk.matmul, gk.splitk_matmul, gk.stream_k_matmul, ggk.grouped_matmul,
                ggk.ragged_matmul, flash_attention_fwd, mamba_scan_fwd]
    before = [fn.launches for fn in counters]
    with pytest.raises(RuntimeError, match="requires grad"):
        calls[name]()
    assert [fn.launches for fn in counters] == before
    with torch.no_grad():
        calls[name]()
    assert sum(fn.launches for fn in counters) == sum(before) + 1


GRAD_TILES = (TileConfig(8, 128, 128), TileConfig(8, 128, 128, split_k=4),
              TileConfig(8, 128, 128, stream_k=8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("tile", GRAD_TILES, ids=lambda t: t.key())
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False),
                                   (True, True)])
def test_gemm_gradients_on_the_card_match_plain(card, ta, tb, tile, dtype):
    """`gemm` under grad runs `Gemm`: dA and dB, two more `gemm` calls at
    the forward's tile, held to the f32 products g·op(B)ᵀ and op(A)ᵀ·g
    within the GEMM tolerance with each product's own K."""
    g0 = torch.Generator(device=card).manual_seed(31)
    M, N, K = 40, 300, 520
    a, b = _operands(g0, M, N, K, ta, tb, dtype, card)
    a.requires_grad_(True)
    b.requires_grad_(True)
    c = gemm(a, b, ta=ta, tb=tb, tile=tile)
    g = torch.randn(c.shape, generator=g0, device=card, dtype=dtype)
    da, db = torch.autograd.grad(c, (a, b), g)
    opa = (a.T if ta else a).detach().float()
    opb = (b.T if tb else b).detach().float()
    want_a, want_b = g.float() @ opb.T, opa.T @ g.float()
    abs_a, abs_b = g.float().abs() @ opb.T.abs(), opa.T.abs() @ g.float().abs()
    if ta:
        want_a, abs_a = want_a.T, abs_a.T
    if tb:
        want_b, abs_b = want_b.T, abs_b.T
    _close(da, want_a.to(dtype), abs_a, "dA")
    _close(db, want_b.to(dtype), abs_b, "dB")


ATTN_GRAD_CASES = (  # B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset
    (2, 4, 4, 64, 64, 64, 64, True, 0, 0),
    (1, 8, 2, 48, 80, 64, 64, True, 0, 32),
    (1, 4, 4, 96, 96, 64, 64, True, 24, 0),
    (2, 4, 4, 40, 40, 192, 128, True, 0, 0),
)


@pytest.mark.parametrize("case", ATTN_GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_gradients_on_the_card_match_plain(card, case):
    """`flash_attention` under grad runs `FlashAttention`: the kernel's
    output within `attention_tol` of `flash_ref`, and q, k and v's
    gradients those of `flash_ref`'s autograd on the same inputs (the
    backward is that VJP), within the f32 tolerance."""
    B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset = case
    g0 = torch.Generator(device=card).manual_seed(32)
    q = torch.randn((B, Hq, T, D), generator=g0, device=card).requires_grad_(True)
    k = torch.randn((B, Hkv, S, D), generator=g0, device=card).requires_grad_(True)
    v = torch.randn((B, Hkv, S, Dv), generator=g0, device=card).requires_grad_(True)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention_fwd.launches
    out = fops.flash_attention(q, k, v, **kw)
    assert flash_attention_fwd.launches == before + 1
    g = torch.randn(out.shape, generator=g0, device=card)
    got = torch.autograd.grad(out, (q, k, v), g)
    ref = flash_ref(q, k, v, **kw)
    want = torch.autograd.grad(ref, (q, k, v), g)
    atol, rtol = attention_tol(torch.float32)
    assert torch.allclose(out, ref, atol=atol, rtol=rtol)
    for x, y, what in zip(got, want, "qkv"):
        assert torch.allclose(x, y, atol=atol, rtol=rtol), what


@pytest.mark.parametrize("broadcast", [False, True], ids=["per_head", "broadcast"])
@pytest.mark.parametrize("T", [100, 300])
def test_scan_gradients_on_the_card_match_plain(card, T, broadcast):
    """`ssd_scan` under grad runs `SSDScan`: y and the final state within
    3e-4 of `ssd_chunk_ref`, and every input's gradient that of
    `ssd_chunk_ref`'s autograd at the same chunk (the backward is that
    VJP) within 3e-4."""
    g0 = torch.Generator(device=card).manual_seed(33)
    B, H, P, N = 2, 4, 16, 8
    xd = torch.randn((B, T, H, P), generator=g0, device=card).requires_grad_(True)
    da = (-torch.rand((B, T, H), generator=g0, device=card) * 0.5).requires_grad_(True)
    if broadcast:
        b0 = torch.randn((B, T, N), generator=g0, device=card).requires_grad_(True)
        c0 = torch.randn((B, T, N), generator=g0, device=card).requires_grad_(True)
        bm, cm = (t[:, :, None].expand(B, T, H, N) for t in (b0, c0))
    else:
        b0 = bm = torch.randn((B, T, H, N), generator=g0, device=card).requires_grad_(True)
        c0 = cm = torch.randn((B, T, H, N), generator=g0, device=card).requires_grad_(True)
    routes = dict(mamba_scan_fwd.routes)
    y, s = mops.ssd_scan(xd, da, bm, cm, chunk=64)
    assert mamba_scan_fwd.routes["chunks"] == routes["chunks"] + 1
    gy, gs = torch.randn_like(y), torch.randn_like(s)
    got = torch.autograd.grad((y, s), (xd, da, b0, c0), (gy, gs))
    ry, rs = ssd_chunk_ref(xd, da, bm, cm, chunk=64)
    want = torch.autograd.grad((ry, rs), (xd, da, b0, c0), (gy, gs))
    assert torch.allclose(y, ry, atol=3e-4, rtol=3e-4)
    assert torch.allclose(s, rs, atol=3e-4, rtol=3e-4)
    for x, w, what in zip(got, want, ("xd", "da", "B", "C")):
        assert torch.allclose(x, w, atol=3e-4, rtol=3e-4), what


@pytest.mark.parametrize("name", ["qwen3-14b", "zamba2-1.2b"])
def test_reduced_model_train_step_on_the_card_matches_the_cpu(card, name, monkeypatch):
    """One f32 `make_train_step` step of a reduced model on the card (every
    plain version raising outside its VJP) and on the CPU from the same
    masters: loss within MODEL_TOL, every leaf's gradient within
    MODEL_TOL·max(1, max |CPU leaf|)."""
    from repro_torch.dist.checkpoint import tree_map
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train.train_loop import make_train_step, train_init

    cfg = get_arch(name).reduced()
    model = build_model(cfg, device=card, seed=12)
    cpu = build_model(cfg, device="cpu", seed=None)
    opt = AdamW(AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1))
    state = train_init(model, opt)
    host = tree_map(lambda t: t.cpu(), state)
    toks = torch.randint(0, cfg.vocab_size, (2, 151),
                         generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads = {}

    def keep(where):
        def tf(g):
            grads[where] = g
            return g
        return tf

    real = {(fops, "flash_ref"): fops.flash_ref, (mops, "ssd_chunk_ref"): mops.ssd_chunk_ref}
    backward = {fops.FlashAttention.backward.__code__, mops.SSDScan.backward.__code__}

    def guarded(fn):
        def plain(*a, **kw):
            import sys
            assert sys._getframe(1).f_code in backward, "a plain version ran on the card"
            return fn(*a, **kw)
        return plain

    with monkeypatch.context() as m:
        for (mod, n), fn in real.items():
            m.setattr(mod, n, guarded(fn))
        _, mc = make_train_step(model, opt, compute_dtype=torch.float32,
                                grad_transform=keep("card"))(state, batch)
    _, mh = make_train_step(cpu, opt, compute_dtype=torch.float32,
                            grad_transform=keep("cpu"))(host, batch)
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= MODEL_TOL * max(
        1.0, abs(float(mh["loss"])))
    for k, want in grads["cpu"].items():
        err = float((grads["card"][k].cpu() - want).abs().max())
        assert err <= MODEL_TOL * max(1.0, float(want.abs().max())), (k, err)


@pytest.mark.parametrize("name,remat", [("zamba2-1.2b", "full"), ("qwen3-14b", "full"),
                                        ("qwen3-14b", "dots")])
def test_remat_gradients_on_the_card_equal_no_remat(card, name, remat):
    """A reduced model's f32 loss and gradients on the card under remat
    against the same model without: the recompute repeats the forward's
    kernels on the same values, so the loss is bitwise and each leaf
    within 2⁻²⁰·max(1, max |leaf|) (ulps, should a reduction's order
    not be fixed); the attention and scan kernels launch twice."""
    cfg = get_arch(name).reduced()
    toks = torch.randint(0, cfg.vocab_size, (2, 151),
                         generator=torch.Generator().manual_seed(8))
    batch = {"tokens": toks[:, :-1].to(card), "labels": toks[:, 1:].to(card)}
    got = {}
    for r in ("none", remat):
        model = build_model(cfg, device=card, seed=14, remat=r)
        params = [p.requires_grad_(True) for p in model.parameters()]
        before = _model_launches()
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        after = _model_launches()
        got[r] = (loss.detach(), grads, after[0] - before[0],
                  after[1]["chunks"] - before[1]["chunks"])
    loss, grads, attn, scans = got["none"]
    rloss, rgrads, rattn, rscans = got[remat]
    assert attn > 0 and (rattn, rscans) == (2 * attn, 2 * scans)
    assert torch.equal(rloss, loss)
    for g, rg in zip(grads, rgrads):
        assert float((rg - g).abs().max()) <= 2.0 ** -20 * max(1.0, float(g.abs().max()))


def test_moe_training_on_the_card_raises_naming_the_grouped_backward(card):
    """The grouped kernels have no backward (nor has the reference's Pallas
    grouped GEMM): a DeepSeek-V2-Lite training step on the card raises,
    naming the ROADMAP item, before any grouped launch."""
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train.train_loop import make_train_step, train_init

    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    model = build_model(cfg, device=card, seed=13)
    opt = AdamW(AdamWConfig())
    state = train_init(model, opt)
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(7))
    before = ggk.grouped_matmul.launches
    with pytest.raises(RuntimeError, match="A16"):
        make_train_step(model, opt, compute_dtype=torch.float32)(
            state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert ggk.grouped_matmul.launches == before
