"""The kernels' backward (`repro_torch.kernels.*.ops`) on the CPU against
the JAX package's custom VJPs, on the same numpy inputs.

- `gemm`: every (ta, tb) at a plain, a split-K and a Stream-K tile, its
  gradients (the `Gemm` Function: dgrad and wgrad as two more `gemm`
  calls at the tile, the plain versions of the tile's decomposition
  here) against ``jax.grad`` of the reference's `gemm` (whose custom VJP
  is the same two calls); f32, within 1e-5·max(1, |ref|).
- `flash_attention` (causal, a sliding window, GQA, MLA's dv ≠ dqk, a
  q offset) and `ssd_scan` / `mamba_chunk_scan` (chunks of 32 and 64, T
  not a multiple of the chunk, B/C head-broadcast): q, k, v (xd, da, B,
  C; x, dt, A) gradients against ``jax.vjp`` of the reference's ops
  with its Pallas forward in interpret mode (the reference's backward is
  the VJP of its XLA plain version); f32, within the reference tests'
  2e-4 (attention) and 3e-4 (scan) of max(1, |ref|).  Each is checked on
  both of the port's routes: the CPU's plain version differentiated by
  autograd, and the card's autograd Function (`FlashAttention`,
  `SSDScan`) with its forward launcher replaced by the plain version, so
  that the Function's own backward (the plain version's VJP, recomputed)
  runs here.
- Every launcher refuses to launch under grad when an operand requires
  it (a launch records no backward), before anything else; the ops'
  Functions launch with grad disabled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels.flash_attention.ops as fops
import repro_torch.kernels.mamba_scan.ops as mops
from repro.kernels.flash_attention.ops import flash_attention as jflash_attention
from repro.kernels.gemm.ops import TileConfig as JTileConfig
from repro.kernels.gemm.ops import gemm as jgemm
from repro.kernels.mamba_scan.ops import mamba_chunk_scan as jmamba_chunk_scan
from repro.kernels.mamba_scan.ops import ssd_scan as jssd_scan
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_fwd
from repro_torch.kernels.gemm import TileConfig, gemm
from repro_torch.kernels.gemm import kernel as gk
from repro_torch.kernels.grouped_gemm import kernel as ggk
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.kernels.mamba_scan import mamba_chunk_scan, mamba_scan_fwd, ssd_chunk_ref, ssd_scan
from tests.test_torch_models import assert_close, rng_arrays

ROUTES = ("plain", "function")


# -------------------------------------------------------------------- gemm
TILES = (TileConfig(8, 16, 64), TileConfig(8, 16, 64, split_k=4),
         TileConfig(8, 16, 64, stream_k=5))


@pytest.mark.parametrize("tile", TILES, ids=lambda t: t.key())
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False),
                                   (True, True)])
def test_gemm_gradients_against_the_reference(ta, tb, tile):
    M, N, K = 24, 40, 300
    a, b, g = rng_arrays(7, (K, M) if ta else (M, K), (N, K) if tb else (K, N), (M, N))
    jtile = JTileConfig(tile.bm, tile.bn, tile.bk, tile.split_k, tile.stream_k)
    ja, jb = jax.grad(lambda x, y: jnp.sum(jgemm(x, y, ta=ta, tb=tb, tile=jtile) * g),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta_, tb_ = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    c = gemm(ta_, tb_, ta=ta, tb=tb, tile=tile)
    assert c.grad_fn is not None and type(c.grad_fn).__name__ == "GemmBackward"
    da, db = torch.autograd.grad(c, (ta_, tb_), torch.from_numpy(g))
    assert_close(da, ja, "dA", 1e-5)
    assert_close(db, jb, "dB", 1e-5)


def test_gemm_without_grad_records_nothing():
    a, b = (torch.from_numpy(x) for x in rng_arrays(8, (4, 8), (8, 6)))
    assert gemm(a, b).grad_fn is None
    with torch.no_grad():
        assert gemm(a.requires_grad_(True), b).grad_fn is None


# --------------------------------------------------------------- attention
# (B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset)
ATTN_CASES = [(2, 2, 2, 24, 24, 16, 16, True, 0, 0),
              (1, 4, 2, 20, 36, 16, 16, True, 0, 16),
              (1, 2, 2, 40, 40, 16, 16, True, 12, 0),
              (1, 2, 2, 24, 24, 24, 16, True, 0, 0),
              (2, 2, 1, 16, 16, 16, 16, False, 0, 0)]


def _plain_flash(q, k, v, *, bq, bkv, out, **kw):
    return fops.flash_ref(q, k, v, **kw)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_gradients_against_the_reference(case, route, monkeypatch):
    B, Hq, Hkv, T, S, D, Dv, causal, window, q_offset = case
    q, k, v, g = rng_arrays(9, (B, Hq, T, D), (B, Hkv, S, D), (B, Hkv, S, Dv),
                            (B, Hq, T, Dv))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jout, vjp = jax.vjp(lambda *x: jflash_attention(*x, interpret=True, **kw),
                        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    args = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    if route == "plain":
        out = flash_attention(*args, **kw)
    else:
        monkeypatch.setattr(fops, "flash_attention_fwd", _plain_flash)
        out = fops.FlashAttention.apply(*args, causal, window, None, q_offset, 128, 128,
                                        None)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert_close(out, jout, "out", 2e-4)
    for got, want, what in zip(torch.autograd.grad(out, args, torch.from_numpy(g)),
                               jgrads, "qkv"):
        assert_close(got, want, f"d{what}", 2e-4)


# -------------------------------------------------------------------- scan
def _plain_scan(xd, da, Bm, Cm, *, chunk, initial_state, out, workspace):
    return ssd_chunk_ref(xd, da, Bm, Cm, chunk=chunk, initial_state=initial_state)


def _ssd_inputs(seed, B, T, H, P, N):
    xd, bm, cm = rng_arrays(seed, (B, T, H, P), (B, T, H, N), (B, T, H, N), scale=0.5)
    da = -np.random.default_rng(seed + 1).random((B, T, H)).astype(np.float32) * 0.5
    return xd, da, bm, cm


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case", [(2, 70, 2, 8, 4, 32), (1, 100, 2, 8, 8, 64)],
                         ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_gradients_against_the_reference(case, route, monkeypatch):
    """(y, final state) with a cotangent on each."""
    B, T, H, P, N, chunk = case
    arrays = _ssd_inputs(T, B, T, H, P, N)
    gy, gs = rng_arrays(T + 2, (B, T, H, P), (B, H, N, P))
    (jy, js), vjp = jax.vjp(lambda *x: jssd_scan(*x, chunk=chunk, interpret=True),
                            *(jnp.asarray(a) for a in arrays))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    if route == "plain":
        y, s = ssd_scan(*args, chunk=chunk)
    else:
        monkeypatch.setattr(mops, "mamba_scan_fwd", _plain_scan)
        y, s = mops.SSDScan.apply(*args, chunk, None)
        assert type(y.grad_fn).__name__ == "SSDScanBackward"
    assert_close(y, jy, "y", 3e-4)
    assert_close(s, js, "state", 3e-4)
    grads = torch.autograd.grad((y, s), args, (torch.from_numpy(gy), torch.from_numpy(gs)))
    for got, want, what in zip(grads, jgrads, ("xd", "da", "B", "C")):
        assert_close(got, want, f"d{what}", 3e-4)


@pytest.mark.parametrize("route", ROUTES)
def test_mamba_chunk_scan_gradients_against_the_reference(route, monkeypatch):
    """The Mamba2 layout: B/C shared by the heads reach the scan as
    head-broadcast views; their gradients sum over the heads."""
    B, T, H, P, N, chunk = 2, 90, 3, 8, 4, 32
    rng = np.random.default_rng(11)
    x, bm, cm, gy = rng_arrays(12, (B, T, H, P), (B, T, N), (B, T, N), (B, T, H, P),
                               scale=0.5)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    arrays = (x, dt, A, bm, cm)
    jy, vjp = jax.vjp(lambda *a: jmamba_chunk_scan(*a, chunk=chunk, interpret=True)[0],
                      *(jnp.asarray(a) for a in arrays))
    jgrads = vjp(jnp.asarray(gy))
    args = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    if route == "function":
        monkeypatch.setattr(mops, "mamba_scan_fwd", _plain_scan)

        def on_the_card(*a, **kw):   # the CPU dispatch bypassed: the Function runs
            assert kw.get("initial_state") is None
            return mops.SSDScan.apply(*a, kw["chunk"], None)

        monkeypatch.setattr(mops, "ssd_scan", on_the_card)
    y, _ = mamba_chunk_scan(*args, chunk=chunk)
    if route == "function":
        assert type(y.grad_fn).__name__ == "SSDScanBackward"
    assert_close(y, jy, "y", 3e-4)
    for got, want, what in zip(torch.autograd.grad(y, args, torch.from_numpy(gy)),
                               jgrads, ("x", "dt", "A", "B", "C")):
        assert_close(got, want, f"d{what}", 3e-4)


# ----------------------------------------------------- launchers under grad
def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta").requires_grad_(grad)


LAUNCHES = {
    "matmul": lambda g: gk.matmul(_meta(8, 16, grad=g), _meta(16, 8)),
    "splitk_matmul": lambda g: gk.splitk_matmul(_meta(8, 16), _meta(16, 8, grad=g),
                                                split=2, slice_k=8),
    "stream_k_matmul": lambda g: gk.stream_k_matmul(_meta(8, 16, grad=g), _meta(16, 8),
                                                    grid_g=2),
    "grouped_matmul": lambda g: ggk.grouped_matmul(_meta(2, 8, 16),
                                                   [_meta(16, 8, grad=g), _meta(16, 8)]),
    "ragged_matmul": lambda g: ggk.ragged_matmul(_meta(16, 16, grad=g), _meta(2, 16, 8),
                                                 [8, 8], bm=8),
    "flash_attention_fwd": lambda g: flash_attention_fwd(
        _meta(1, 2, 8, 16, grad=g), _meta(1, 2, 8, 16), _meta(1, 2, 8, 16)),
    "mamba_scan_fwd": lambda g: mamba_scan_fwd(
        _meta(1, 8, 2, 4), _meta(1, 8, 2), _meta(1, 8, 2, 4), _meta(1, 8, 2, 4, grad=g)),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launcher_refuses_an_operand_that_requires_grad(name):
    """Under grad, an operand that requires it makes every launcher raise
    first (here before the device check: these are meta tensors); the
    same call with no such operand, or with grad disabled, gets as far as
    the device check.  Nothing is counted."""
    counters = [gk.matmul, gk.splitk_matmul, gk.stream_k_matmul, ggk.grouped_matmul,
                ggk.ragged_matmul, flash_attention_fwd, mamba_scan_fwd]
    before = [fn.launches for fn in counters]
    backward = "A16" if name in ("grouped_matmul", "ragged_matmul") else "Function"
    with pytest.raises(RuntimeError, match=f"requires grad.*{backward}"):
        LAUNCHES[name](True)
    with pytest.raises(ValueError, match="CUDA"):
        LAUNCHES[name](False)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        LAUNCHES[name](True)
    assert [fn.launches for fn in counters] == before


def test_ops_launch_through_their_functions_with_grad_disabled():
    """Off the CPU, an op whose operand requires grad runs its autograd
    Function, which calls the launcher with grad disabled: the launcher's
    device check, not its grad refusal, is what stops these meta tensors.
    The grouped op has no Function, so its launcher refuses."""
    q = _meta(1, 2, 8, 16, grad=True)
    with pytest.raises(ValueError, match="flash_attention_fwd: the CUDA kernel needs"):
        flash_attention(q, _meta(1, 2, 8, 16), _meta(1, 2, 8, 16))
    with pytest.raises(ValueError, match="mamba_scan_fwd: the CUDA kernel needs"):
        ssd_scan(_meta(1, 8, 2, 4, grad=True), _meta(1, 8, 2), _meta(1, 8, 2, 4),
                 _meta(1, 8, 2, 4))
    for tile, what in ((TileConfig(8, 16, 16), "matmul"),
                       (TileConfig(8, 16, 16, split_k=2), "splitk_matmul"),
                       (TileConfig(8, 16, 16, stream_k=2), "stream_k_matmul")):
        with pytest.raises(ValueError, match=f"{what}: the CUDA kernel needs"):
            gemm(_meta(8, 64, grad=True), _meta(64, 8), tile=tile)
    with pytest.raises(RuntimeError, match="A16"):
        grouped_gemm(_meta(2, 8, 16, grad=True), _meta(2, 16, 8))
    with pytest.raises(RuntimeError, match="requires grad"):
        mops.ssd_scan(_meta(1, 8, 2, 4, grad=True), _meta(1, 8, 2), _meta(1, 8, 2, 4),
                      _meta(1, 8, 2, 4), initial_state=_meta(1, 2, 4, 4))
