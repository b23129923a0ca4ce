"""`matmul`'s feed rule (`kernels/gemm/kernel.py:matmul_feed`) and the TMA
feed's ring (`matmul_ring`), on CPU tensors.

The rule is a choice by shape between two hand-written CUDA feeds: TMA
boxes when both operands are bf16 with bases and row strides in
multiples of 16 bytes (what the TMA unit reads), the `cp.async` ring
otherwise.  It reads only dtypes, shapes and data pointers, so it runs
here; the kernels themselves are held to `gemm_ref` on the card
(`tests/test_torch_card.py`).
"""
import pytest
import torch

from repro_torch.kernels.gemm import kernel as gk

LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def _operands(M, N, K, ta, tb, dtype=torch.bfloat16):
    a = torch.zeros((K, M) if ta else (M, K), dtype=dtype)
    b = torch.zeros((N, K) if tb else (K, N), dtype=dtype)
    return a, b


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("shape", [(8, 34816, 5120), (8, 1024, 5120), (8, 8, 8),
                                   (72, 200, 1000)], ids=str)
def test_aligned_bf16_takes_tma_in_every_layout(shape, layout):
    a, b = _operands(*shape, *layout)
    assert gk.matmul_feed(a, b, *layout) == "tma"


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_f32_operands_take_the_ring(layout):
    a, b = _operands(8, 1024, 5120, *layout, dtype=torch.float32)
    assert gk.matmul_feed(a, b, *layout) == "ring"


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_k_5118_takes_the_ring(layout):
    """K = 5118: A's rows (or, transposed, B's) are 10,236 bytes, not a
    16-byte multiple; under ta and not tb no stride holds K, and A's
    rows (M = 8) and B's (N = 1024) are aligned."""
    a, b = _operands(8, 1024, 5118, *layout)
    want = "tma" if layout == (True, False) else "ring"
    assert gk.matmul_feed(a, b, *layout) == want


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_n_1023_takes_the_ring(layout):
    """N = 1023 is a row stride of B only when B is stored (K, N)."""
    a, b = _operands(8, 1023, 5120, *layout)
    want = "ring" if not layout[1] else "tma"
    assert gk.matmul_feed(a, b, *layout) == want


def test_m_not_a_multiple_of_8_under_ta_takes_the_ring():
    a, b = _operands(5, 1024, 5120, True, False)
    assert gk.matmul_feed(a, b, True, False) == "ring"
    a, b = _operands(5, 1024, 5120, False, False)
    assert gk.matmul_feed(a, b, False, False) == "tma"


@pytest.mark.parametrize("which", ["a", "b"])
def test_a_view_at_an_odd_offset_takes_the_ring(which):
    M, N, K = 8, 1024, 512
    a, b = _operands(M, N, K, False, False)
    flat = torch.zeros((M if which == "a" else K) * (K if which == "a" else N) + 1,
                       dtype=torch.bfloat16)
    view = flat[1:].view(a.shape if which == "a" else b.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    a, b = (view, b) if which == "a" else (a, view)
    assert gk.matmul_feed(a, b, False, False) == "ring"


def test_an_aligned_offset_view_keeps_tma():
    flat = torch.zeros(8 * 512 + 8, dtype=torch.bfloat16)
    a = flat[8:].view(8, 512)                  # 16 bytes past the base
    b = torch.zeros((512, 1024), dtype=torch.bfloat16)
    assert gk.matmul_feed(a, b, False, False) == "tma"


def test_an_empty_k_takes_the_ring():
    a, b = _operands(8, 64, 0, False, False)
    assert gk.matmul_feed(a, b, False, False) == "ring"


@pytest.mark.parametrize("ctas,sms,deep", [
    (544, 132, False),    # Qwen3-14B gate+up at batch 8: 4.1 CTAs per SM
    (272, 132, False),    # gate or up: 2.1 per SM
    (263, 132, True),     # just under two per SM
    (80, 132, True),      # q or o: 80 SMs hold one CTA each
    (16, 132, True),      # k or v
])
def test_the_ring_is_deep_only_below_two_ctas_per_sm(ctas, sms, deep):
    ring = gk.matmul_ring(ctas, sms)
    assert ring == (gk.DEEP_RING if deep else gk.SHALLOW_RING)
    assert ring in gk.TMA_RINGS


def test_matmul_launcher_refuses_cpu_tensors_and_counts_nothing():
    a, b = _operands(8, 64, 64, False, False)
    before = (gk.matmul.launches, dict(gk.matmul.feeds))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gk.matmul(a, b)
    assert (gk.matmul.launches, gk.matmul.feeds) == before
    assert set(gk.matmul.feeds) == {"tma", "ring"}
