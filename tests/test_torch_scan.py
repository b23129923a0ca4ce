"""The port's SSD-scan ops (`repro_torch.kernels.mamba_scan`) on the CPU
against the JAX package's Pallas body in interpret mode, on the same
numpy inputs: y and the final state.

On CPU tensors `ssd_scan` runs its plain version (`ssd_chunk_ref`); the
CUDA kernels themselves (the decode step at T = 1, the chunked form
otherwise: `scan_route`; its passes' plain version is held here in
`tests/test_torch_scan_chunks.py`) run only on the card (`chip_smoke.py`,
`tests/test_torch_card.py`).  Here the route rule and the decode grid
are checked as plain functions.  The
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
from repro_torch.kernels.mamba_scan.kernel import (
    DECODE_THREADS,
    decode_grid,
    scan_route,
    scan_shapes,
)
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
    routes = dict(mamba_scan_fwd.routes)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ssd_scan(xd, da, bm, bm)
    with pytest.raises(ValueError, match="needs CUDA tensors"):   # the decode step
        ssd_scan(xd[:, :1], da[:, :1], bm[:, :1], bm[:, :1])
    assert mamba_scan_fwd.launches == before
    assert mamba_scan_fwd.routes == routes
    with pytest.raises(ValueError, match="do not match"):
        scan_shapes(xd, da[:, :3], bm, bm)


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("T", [1, 0, 2, 33, 4096])
def test_scan_route_is_decode_only_at_t1(T):
    assert scan_route(T, 64, 64, 32) == ("decode" if T == 1 else "chunks")


@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("P, N, chunk, match", [
    (64, 0, 32, "N=0 and P=64"), (64, 513, 32, "N=513 and P=64"),
    (0, 64, 32, "N=64 and P=0"), (514, 64, 32, "N=64 and P=514"),
    (64, 64, 0, "chunk=0"), (64, 64, 513, "chunk=513")])
def test_scan_route_raises_alike_on_both_routes(T, P, N, chunk, match):
    with pytest.raises(ValueError, match=match):
        scan_route(T, P, N, chunk)


# (pairs, P, N, SMs): Zamba2's decode member at batch 16 and 1, the widest
# state, widths not multiples of 4, tiny pairs, one pair.
GRID_CASES = [(1024, 64, 64, 132), (64, 64, 64, 132), (1024, 128, 128, 132),
              (64, 128, 128, 132), (48, 30, 10, 132), (3, 4, 1, 132),
              (8, 16, 8, 132), (1, 30, 10, 132), (256, 16, 8, 132),
              (64, 64, 64, 16), (5, 7, 3, 132),
              # xLSTM-350M's decode step at batch 4 (4 heads): its memory and
              # its normaliser
              (16, 512, 512, 132), (16, 1, 512, 132)]


@pytest.mark.parametrize("pairs, P, N, sms", GRID_CASES, ids=str)
def test_decode_grid_covers_every_state_element_once(pairs, P, N, sms):
    """The grid's threads, laid out as the kernel lays them out (thread
    (pair, row lane, group) of each CTA), write every (pair, row, column)
    of the state exactly once, the threads of row lane 0 every (pair,
    column) of y once, and the CTAs reach every SM when there are enough column groups
    to split."""
    g = decode_grid(pairs, P, N, sms)
    assert g.pairs_per_cta in (1, 2, 4, 8)
    assert g.slices == 1 or g.pairs_per_cta == 1
    gsp = 1 << max(0, g.groups - 1).bit_length()
    tp = DECODE_THREADS // g.pairs_per_cta
    assert g.row_lanes * gsp == tp
    assert g.ctas == -(-pairs // g.pairs_per_cta) * g.slices
    hits = np.zeros((pairs, N, P), dtype=np.int64)
    y_hits = np.zeros((pairs, P), dtype=np.int64)
    for cta in range(g.ctas):
        slice_, pair0 = cta % g.slices, cta // g.slices * g.pairs_per_cta
        for tid in range(DECODE_THREADS):
            pl, cg, rl = tid // tp, tid % tp % gsp, tid % tp // gsp
            c0 = (slice_ * g.groups + cg) * 4
            if pair0 + pl >= pairs or cg >= g.groups or c0 >= P:
                continue
            hits[pair0 + pl, rl::g.row_lanes, c0:c0 + 4] += 1
            if rl == 0:   # row lane 0 writes its columns of y
                y_hits[pair0 + pl, c0:c0 + 4] += 1
    assert (hits == 1).all()
    assert (y_hits == 1).all()
    groups = -(-P // 4)
    assert g.ctas >= sms or 2 * g.slices > groups


def test_decode_grid_of_xlstm_steps():
    """xLSTM-350M's decode step at batch 4 (16 pairs of N = 512): its
    memory (P = 512) in 16 column slices of 32 columns (256 CTAs on the
    H100's 132 SMs, 16 rows a thread); its normaliser (P = 1), one pair a
    CTA of 256 row lanes."""
    assert decode_grid(16, 512, 512, 132) == (256, 16, 1, 8, 32)
    assert decode_grid(16, 1, 512, 132) == (16, 1, 1, 1, 256)


def test_decode_grid_of_the_serving_member():
    """Zamba2's decode member, 64 heads of P = N = 64: one pair per CTA at
    batch 16 (1,024 CTAs, 4 rows per thread), four 16-column slices per
    pair at batch 1 (256 CTAs on the H100's 132 SMs)."""
    assert decode_grid(16 * 64, 64, 64, 132) == (1024, 1, 1, 16, 16)
    assert decode_grid(64, 64, 64, 132) == (256, 4, 1, 4, 64)


# ------------------------------------------------------- the decode step
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 8, 16, 8), (2, 4, 30, 10)],
                         ids=lambda c: "x".join(map(str, c)))
def test_decode_step_with_state_and_broadcast_bc_matches_reference(shape, dtype):
    """T = 1 with an initial state and head-broadcast B/C (Mamba2's group-
    shared layout; a view with head stride 0 here, a broadcast array in
    JAX), against the reference's `ssd_scan` (which takes its XLA version
    for an initial state) and, without the state, its Pallas body in
    interpret mode through `scan_for_desc`."""
    B, H, P, N = shape
    rng = np.random.default_rng(B * H + P)
    xd = rng.standard_normal((B, 1, H, P)).astype(np.float32)
    da = (-np.abs(rng.standard_normal((B, 1, H))) * 0.3).astype(np.float32)
    bc = [(rng.standard_normal((B, 1, 1, N)) * 0.5).astype(np.float32)
          for _ in range(2)]
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    (txd, tda, tb, tc), (jxd, jda, jb, jc) = _both([xd, da, *bc], dtype)
    tb, tc = (t.expand(B, 1, H, N) for t in (tb, tc))
    assert tb.stride(2) == 0
    jb, jc = (jnp.broadcast_to(t, (B, 1, H, N)) for t in (jb, jc))
    y, s = ssd_scan(txd, tda, tb, tc, chunk=32, initial_state=torch.from_numpy(s0))
    jy, js = jssd_scan(jxd, jda, jb, jc, chunk=32, initial_state=jnp.asarray(s0),
                       interpret=True)
    assert y.shape == (B, 1, H, P) and y.dtype == TDT[dtype]
    _close(y, jy)
    _close(s, js)
    desc = ScanDesc(B, 1, H, P, N, dtype)
    _close(scan_for_desc(desc, txd, tda, tb, tc, tile=TileConfig(32, 128, 128)),
           jscan_for_desc(JScan(B, 1, H, P, N, dtype), jxd, jda, jb, jc,
                          tile=TileConfig(32, 128, 128), interpret=True))


def test_decode_step_is_the_closed_form():
    """At T = 1 the chunk collapses: y = (C·B) xd + exp(da) C·S0 and S =
    exp(da) S0 + B xdᵀ — the formula the decode kernel computes — and the
    plain version agrees with it."""
    rng = np.random.default_rng(7)
    B, H, P, N = 2, 3, 12, 5
    xd, da, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(7, B, 1, H, P, N))
    s0 = torch.from_numpy(rng.standard_normal((B, H, N, P)).astype(np.float32))
    y, s = ssd_chunk_ref(xd, da, bm, cm, chunk=32, initial_state=s0)
    decay = torch.exp(da[:, 0])[..., None, None]
    want_s = decay * s0 + bm[:, 0, :, :, None] * xd[:, 0, :, None, :]
    cb = (cm[:, 0] * bm[:, 0]).sum(-1)[..., None]
    want_y = cb * xd[:, 0] + decay[..., 0] * torch.einsum("bhn,bhnp->bhp", cm[:, 0], s0)
    np.testing.assert_allclose(s.numpy(), want_s.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y[:, 0].numpy(), want_y.numpy(), rtol=1e-5, atol=1e-5)
