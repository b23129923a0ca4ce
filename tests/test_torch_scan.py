"""The port's SSD-scan ops (`repro_torch.kernels.mamba_scan`) on the CPU
against the JAX package's Pallas body in interpret mode, on the same
numpy inputs: y and the final state.

On CPU tensors `ssd_scan` runs its plain version (`ssd_chunk_ref`); the
CUDA kernel itself runs only on the card (`chip_smoke.py`).  The
tolerance is the reference tests' own, 3e-4
(`tests/test_kernel_mamba.py`); bf16 inputs are rounded once, the same
way in both packages, and the arithmetic is f32 in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.op_desc import ScanDesc as JScan
from repro.kernels.mamba_scan.ops import mamba_chunk_scan as jmamba_chunk_scan
from repro.kernels.mamba_scan.ops import scan_for_desc as jscan_for_desc
from repro.kernels.mamba_scan.ops import ssd_scan as jssd_scan
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jmamba_scan_ref
from repro.kernels.mamba_scan.ref import ssd_chunk_ref as jssd_chunk_ref
from repro.kernels.mamba_scan.ref import ssd_scan_seq_ref as jssd_scan_seq_ref
from repro_torch.core import ScanDesc
from repro_torch.kernels.gemm import TileConfig
from repro_torch.kernels.mamba_scan import (
    mamba_chunk_scan,
    mamba_scan_fwd,
    scan_for_desc,
    ssd_chunk_ref,
    ssd_scan,
    ssd_scan_seq_ref,
)
from repro_torch.kernels.mamba_scan.kernel import scan_shapes
from repro_torch.kernels.mamba_scan.ref import _mamba_args

TOL = 3e-4
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _ssd_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, P)).astype(np.float32),
            -np.abs(rng.standard_normal((B, T, H))).astype(np.float32) * 0.3,
            rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5,
            rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5)


def _both(arrays, dtype):
    return ([torch.from_numpy(a).to(TDT[dtype]) for a in arrays],
            [jnp.asarray(a).astype(JDT[dtype]) for a in arrays])


def _close(got, want):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32)),
        rtol=TOL, atol=TOL)


# (B, T, H, P, N, chunk): T not a multiple of the chunk, chunks 8..512,
# the decode step (T = 1).
CASES = [(2, 70, 3, 16, 8, 32), (1, 200, 2, 32, 16, 64), (1, 100, 2, 16, 8, 8),
         (1, 40, 2, 16, 16, 512), (4, 1, 3, 16, 16, 32)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_scan_matches_pallas_interpret(case, dtype):
    B, T, H, P, N, chunk = case
    (xd, da, bm, cm), jargs = _both(_ssd_inputs(T + chunk, B, T, H, P, N), dtype)
    y, s = ssd_scan(xd, da, bm, cm, chunk=chunk)
    jy, js = jssd_scan(*jargs, chunk=chunk, interpret=True)
    assert y.shape == (B, T, H, P) and y.dtype == TDT[dtype]
    assert s.shape == (B, H, N, P) and s.dtype == torch.float32
    _close(y, jy)
    _close(s, js)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_initial_state_matches_chunk_ref(dtype):
    """A nonzero initial state (the reference sends it to `ssd_chunk_ref`),
    and chaining two halves equals one pass."""
    B, T, H, P, N = 2, 96, 2, 16, 8
    arrays = _ssd_inputs(3, B, T, H, P, N)
    s0 = np.random.default_rng(4).standard_normal((B, H, N, P)).astype(np.float32)
    (xd, da, bm, cm), jargs = _both(arrays, dtype)
    y, s = ssd_scan(xd, da, bm, cm, chunk=32, initial_state=torch.from_numpy(s0))
    jy, js = jssd_scan(*jargs, chunk=32, initial_state=jnp.asarray(s0),
                       interpret=True)
    _close(y, jy)
    _close(s, js)
    jy2, js2 = jssd_chunk_ref(*jargs, chunk=32, initial_state=jnp.asarray(s0))
    _close(y, jy2)
    _close(s, js2)
    y1, s1 = ssd_scan(xd[:, :40], da[:, :40], bm[:, :40], cm[:, :40], chunk=32)
    y2, s2 = ssd_scan(xd[:, 40:], da[:, 40:], bm[:, 40:], cm[:, 40:], chunk=32,
                      initial_state=s1)
    whole, s_whole = ssd_scan(xd, da, bm, cm, chunk=32)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).float().numpy(),
                               whole.float().numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s2.numpy(), s_whole.numpy(), rtol=TOL, atol=TOL)


def test_sequential_oracle_matches_reference():
    arrays = _ssd_inputs(5, 2, 50, 2, 16, 8)
    (xd, da, bm, cm), jargs = _both(arrays, "f32")
    y, s = ssd_scan_seq_ref(xd, da, bm, cm)
    jy, js = jssd_scan_seq_ref(*jargs)
    _close(y, jy)
    _close(s, js)
    cy, cs = ssd_chunk_ref(xd, da, bm, cm, chunk=16)
    _close(cy, jy)
    _close(cs, js)


def _mamba_inputs(seed, B, T, H, P, N):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, H)))).astype(np.float32)
    return (rng.standard_normal((B, T, H, P)).astype(np.float32), dt,
            -np.exp(rng.standard_normal((H,))).astype(np.float32),
            (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32),
            (rng.standard_normal((B, T, N)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("chunk", [32, 128])
def test_mamba_chunk_scan_matches_reference(chunk):
    """The Mamba2 layout: group-shared B/C broadcast over the heads as a
    view (head stride 0), against the Pallas body and the sequential
    oracle."""
    arrays = _mamba_inputs(chunk, 2, 200, 3, 32, 16)
    args = [torch.from_numpy(a) for a in arrays]
    jargs = [jnp.asarray(a) for a in arrays]
    y, s = mamba_chunk_scan(*args, chunk=chunk)
    jy, js = jmamba_chunk_scan(*jargs, chunk=chunk, interpret=True)
    _close(y, jy)
    _close(s, js)
    oy, os_ = jmamba_scan_ref(*jargs)
    _close(y, oy)
    _close(s, os_)


def test_mamba_args_broadcast_b_and_c_without_a_copy():
    x, dt, A, bm, cm = (torch.from_numpy(a) for a in _mamba_inputs(0, 2, 9, 4, 8, 6))
    _, _, bh, ch = _mamba_args(x, dt, A, bm, cm)
    assert bh.shape == ch.shape == (2, 9, 4, 6)
    assert bh.stride(2) == ch.stride(2) == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tile", [None, TileConfig(32, 128, 128),
                                  TileConfig(4, 128, 128),
                                  TileConfig(1024, 128, 128)],
                         ids=lambda t: "none" if t is None else t.key())
def test_scan_for_desc_matches_reference(tile, dtype):
    """The descriptor adapter: chunk = max(8, min(tile.bm, 512)); the
    decode member (T = 1) and a short prefill."""
    for B, T, H, P, N in ((3, 1, 4, 16, 16), (1, 70, 2, 16, 8)):
        desc = ScanDesc(B, T, H, P, N, dtype)
        (xd, da, bm, cm), jargs = _both(_ssd_inputs(T, B, T, H, P, N), dtype)
        _close(scan_for_desc(desc, xd, da, bm, cm, tile=tile),
               jscan_for_desc(JScan(B, T, H, P, N, dtype), *jargs, tile=tile,
                              interpret=True))


def test_cuda_path_never_falls_back_to_the_plain_version():
    xd = torch.empty((1, 4, 2, 16), device="meta")
    da = torch.empty((1, 4, 2), device="meta")
    bm = torch.empty((1, 4, 2, 8), device="meta")
    before = mamba_scan_fwd.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_scan(xd, da, bm, bm)
    assert mamba_scan_fwd.launches == before
    with pytest.raises(ValueError, match="do not match"):
        scan_shapes(xd, da[:, :3], bm, bm)
