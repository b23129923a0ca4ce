"""The redesigned Stream-K walk and split-KV flash-attention kernels held
to their plain versions on the card.  Every test here needs an NVIDIA GPU
and skips without one; on the card (no JAX needed) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py

The Stream-K walk runs in the card's units (`card_geometry`): its partials
must match `stream_k_partials_ref` at that geometry, the fixup must equal
its plain version on the kernel's own partials, and `gemm` must match the
plain GEMM.  Attention must match `flash_ref` on f32 copies of its inputs
within `attention_tol`; its split partials must match `flash_split_ref`,
its output (merged in the kernel by the last CTA of each row group) must
match `flash_combine_ref` on the kernel's own partials, and the row
groups' counters must be zero again after the launch.

GEMM tolerance (as in `chip_smoke.py`): |kernel − plain| ≤ 2⁻⁷·|plain|
(bf16 outputs only: one rounding each) + 2⁻¹⁶·|A|·|B| (f32 summation
order over K).
"""
import pytest
import torch

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
    stream_k_fixup_ref,
    stream_k_partials_ref,
    stream_k_workgroups,
)
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.gemm.ref import element_counts

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


# ---------------------------------------------------------------- Stream-K
WALK_CASES = [  # M, N, K, G, ta, tb
    (32, 512, 17408, 8, False, False),   # the timed member
    (5, 70, 600, 1, False, True),
    (13, 200, 1000, 3, True, False),
    (33, 129, 300, 5, True, True),
    (70, 130, 4000, 8, False, False),
    (1, 64, 64, 8, False, False),        # one k step: most workgroups idle
    (3, 40, 50, 40, False, False),       # G above G_max
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("case", WALK_CASES, ids=str)
def test_stream_k_walk_matches_plain_at_card_geometry(card, case, dtype):
    M, N, K, G, ta, tb = case
    g = torch.Generator(device=card).manual_seed(M * N + K + G)
    a = torch.randn((K, M) if ta else (M, K), generator=g, device=card, dtype=dtype)
    b = torch.randn((N, K) if tb else (K, N), generator=g, device=card, dtype=dtype)
    geo = card_geometry(M, N, K, dtype, ta, tb, G, card)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    occ, _ = gk.walk_resources(card, dtype, ta, tb, geo.rows)
    assert geo.workgroups == stream_k_workgroups(G, gk.planner_g_max(), sms, occ)
    assert geo.rows == (16 if M <= 16 else 32 if M <= 32 else 64)
    kw = dict(bm=geo.rows, bn=geo.cols, bk=geo.bk, grid_g=geo.workgroups)
    before = gk.stream_k_partials.launches
    p = gk.stream_k_partials(a, b, ta=ta, tb=tb, grid_g=G)
    assert gk.stream_k_partials.launches == before + 1
    counts = torch.from_numpy(geo.counts).to(card)
    written = (torch.arange(geo.slots, device=card)[:, None, None]
               < element_counts(counts, M, N, geo.rows, geo.cols)[None])
    A, B = (a.T if ta else a).float().abs(), (b.T if tb else b).float().abs()
    _close(torch.where(written, p, 0.0), stream_k_partials_ref(a, b, ta=ta, tb=tb, **kw),
           stream_k_partials_ref(A, B, **kw), "partials")
    fix = gk.stream_k_fixup(counts, p, bm=geo.rows, bn=geo.cols, dtype=dtype)
    assert torch.equal(fix, stream_k_fixup_ref(counts, p, bm=geo.rows, bn=geo.cols,
                                               dtype=dtype))
    tile = TileConfig(16, 128, 128, stream_k=G)
    buf = gemm_buffers(a, b, ta=ta, tb=tb, tile=tile)
    assert buf.partials.shape == (geo.slots, M, N)
    assert torch.equal(buf.counts, counts)
    assert buf.counts is gemm_buffers(a, b, ta=ta, tb=tb, tile=tile).counts
    _close(gemm(a, b, ta=ta, tb=tb, tile=tile, buffers=buf),
           gemm_ref(a, b, ta=ta, tb=tb), A @ B, "gemm")


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
