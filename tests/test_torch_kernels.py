"""Port kernels' CPU paths vs the JAX ops run through the Pallas bodies
(``interpret=True``): the single, grouped and ragged GEMM families.

Inputs are made with numpy from a seed and fed to both packages.
Integer-valued float32 operands make every f32 sum exact, so those cases
are bitwise; bf16 cases hold to the reference tests' 3e-2
(`tests/test_kernel_gemm.py:36`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm import TileConfig as JTile
from repro.kernels.gemm import gemm as jgemm
from repro.kernels.grouped_gemm import grouped_gemm as jgrouped
from repro.kernels.grouped_gemm import ragged_gemm as jragged
from repro_torch.kernels.gemm import TileConfig, gemm, gemm_ref
from repro_torch.kernels.gemm.kernel import (
    LAUNCHERS,
    cta_rows,
    instantiation,
    matmul,
    splitk_partials,
    splitk_reduce,
    stream_k_fixup,
    stream_k_partials,
)
from repro_torch.kernels.grouped_gemm import (
    block_groups,
    grouped_gemm,
    grouped_matmul,
    ragged_gemm,
    ragged_matmul,
)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _operand(rng, shape, dtype):
    if dtype == "f32":   # integer-valued: every f32 sum below 2^24 is exact
        return rng.integers(-4, 5, size=shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _both(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _assert_match(port, ref, dtype):
    p = port.float().numpy()
    r = np.asarray(ref.astype(jnp.float32))
    assert p.shape == r.shape
    if dtype == "f32":
        np.testing.assert_array_equal(p, r)
    else:
        np.testing.assert_allclose(p, r, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("shape", [(8, 128, 256), (13, 70, 45), (33, 200, 130)])
def test_gemm_matches_pallas_body(shape, ta, tb, dtype):
    M, N, K = shape
    rng = np.random.default_rng([M, N, K, int(ta), int(tb)])
    a = _operand(rng, (K, M) if ta else (M, K), dtype)
    b = _operand(rng, (N, K) if tb else (K, N), dtype)
    ja, ta_ = _both(a, dtype)
    jb, tb_ = _both(b, dtype)
    ref = jgemm(ja, jb, ta=ta, tb=tb, tile=JTile(8, 128, 128), interpret=True)
    out = gemm(ta_, tb_, ta=ta, tb=tb, tile=TileConfig(8, 128, 128))
    assert out.dtype == DTYPES[dtype][1]
    _assert_match(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G,M,N,K,bm", [(4, 8, 128, 256, 8), (3, 5, 70, 33, 8),
                                        (2, 16, 130, 128, 16)])
def test_grouped_matches_pallas_body(G, M, N, K, bm, dtype):
    rng = np.random.default_rng([G, M, N, K, bm])
    ja, ta_ = _both(_operand(rng, (G, M, K), dtype), dtype)
    jb, tb_ = _both(_operand(rng, (G, K, N), dtype), dtype)
    ref = jgrouped(ja, jb, tile=JTile(bm, 128, 128), interpret=True)
    _assert_match(grouped_gemm(ta_, tb_, tile=TileConfig(bm, 128, 128)), ref,
                  dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sizes,N,K,bm", [([16, 8, 8, 8, 16], 128, 128, 8),
                                          ([16, 32], 70, 200, 16),
                                          ([8, 0, 24], 130, 64, 8)])
def test_ragged_matches_pallas_body(sizes, N, K, bm, dtype):
    """The scheduler's layout: members' rows concatenated, each a multiple
    of bm; every group multiplies its own B."""
    rng = np.random.default_rng([sum(sizes), N, K, bm])
    G = len(sizes)
    ja, ta_ = _both(_operand(rng, (sum(sizes), K), dtype), dtype)
    jb, tb_ = _both(_operand(rng, (G, K, N), dtype), dtype)
    ref = jragged(ja, jb, jnp.asarray(sizes, jnp.int32),
                  tile=JTile(bm, 128, 128), interpret=True)
    out = ragged_gemm(ta_, tb_, torch.tensor(sizes, dtype=torch.int32),
                      tile=TileConfig(bm, 128, 128))
    _assert_match(out, ref, dtype)


def test_ragged_rows_past_groups_take_last_group():
    """Rows beyond the sizes' total belong to the last group, as the
    reference's clamped group id says."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(_operand(rng, (12, 16), "f32"))
    b = torch.from_numpy(_operand(rng, (2, 16, 8), "f32"))
    out = ragged_gemm(a, b, torch.tensor([4, 4], dtype=torch.int32))
    np.testing.assert_array_equal(out[4:].numpy(), (a[4:] @ b[1]).numpy())
    np.testing.assert_array_equal(out[:4].numpy(), (a[:4] @ b[0]).numpy())


@pytest.mark.parametrize("sizes,bm", [([16, 8, 8, 8, 16], 8), ([0, 32, 16], 16),
                                      ([128, 256], 128), ([8, 8], 8)])
def test_block_groups_match_reference_map(sizes, bm):
    """The block → group map of `repro/kernels/grouped_gemm/ops.py:70-78`."""
    n_blocks = sum(sizes) // bm
    want = np.minimum(np.searchsorted(np.cumsum(sizes), np.arange(n_blocks) * bm,
                                      side="right"), len(sizes) - 1)
    got = block_groups(torch.tensor(sizes, dtype=torch.int32), n_blocks, bm,
                       len(sizes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gemm_ref_accumulates_in_f32():
    """bf16 in, f32 accumulation, output cast once: the 256 products of
    1+2^-7 sum to exactly 258 in f32, which bf16 represents."""
    a = torch.full((1, 256), 1 + 2 ** -7, dtype=torch.bfloat16)
    b = torch.ones((256, 1), dtype=torch.bfloat16)
    out = gemm_ref(a, b)
    assert out.dtype == torch.bfloat16
    assert out.item() == torch.tensor(256 * (1 + 2 ** -7)).to(torch.bfloat16).item()


@pytest.mark.parametrize("bm,rows", [(1, 16), (8, 16), (16, 16), (32, 64),
                                     (256, 64)])
def test_cta_row_tile_rule(bm, rows):
    assert cta_rows(bm) == rows
    assert instantiation(torch.bfloat16, bm).startswith(f"bf16 {rows}x64x")


@pytest.mark.parametrize("launch", [
    lambda a: matmul(a, a),
    lambda a: grouped_matmul(a[None], a[None]),
    lambda a: ragged_matmul(a, a[None], torch.zeros(1, dtype=torch.int32), bm=8),
    lambda a: splitk_partials(a, a, split=2, slice_k=4),
    lambda a: splitk_reduce(a[None].float(), torch.bfloat16),
    lambda a: stream_k_partials(a, a, grid_g=2),
    lambda a: stream_k_fixup(torch.ones((1, 1), dtype=torch.int32), a[None].float(),
                             bm=8, bn=8, dtype=torch.bfloat16),
])
def test_kernel_launchers_take_only_cuda_tensors(launch):
    """A launcher never runs a plain version: CPU tensors raise, and the
    launch counters stay where they were."""
    counters = LAUNCHERS + (grouped_matmul, ragged_matmul)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.ones((8, 8), dtype=torch.bfloat16))
    assert [fn.launches for fn in counters] == before
