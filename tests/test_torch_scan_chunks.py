"""The SSD scan's chunked form — the three passes the card's kernels run
for every T > 1 (`csrc/mamba_scan.cu`: `ssd_state_kernel`,
`ssd_carry_kernel`, `ssd_output_kernel`) — on the CPU: its plain version
(`ref.ssd_decomposed_ref`) against the JAX package's Pallas body in
interpret mode and its `ssd_chunk_ref`, the tensor-core precision plan
(f32 operands split into bf16 hi and lo parts) against the same
reference, and the launch geometry (`kernel.chunk_grid`) as the kernels
read their block indices.

Tolerance: the reference tests' 3e-4 (`tests/test_kernel_mamba.py`),
atol and rtol; a bf16 y adds half a bf16 unit (2⁻⁸) to rtol for its one
rounding, as `chip_smoke.py:scan_excess` does."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import ssd_scan as jssd_scan
from repro.kernels.mamba_scan.ref import ssd_chunk_ref as jssd_chunk_ref
from repro_torch.core import ScanDesc
from repro_torch.kernels.gemm import TileConfig
from repro_torch.core.scheduler import OP_FAMILIES
from repro_torch.kernels.mamba_scan import (
    chunk_grid,
    chunk_workspace,
    scan_buffers,
    ssd_carry_ref,
    ssd_chunk_outputs_ref,
    ssd_chunk_ref,
    ssd_chunk_states_ref,
    ssd_decomposed_ref,
)
from repro_torch.kernels.mamba_scan.kernel import (
    _SIGNATURES,
    CARRY_THREADS,
    OUTPUT_ROWS,
    chunk_heads_per_cta,
)
from repro_torch.kernels.mamba_scan.ref import split_bf16, ssd_lost_carry

TOL = 3e-4
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc" / "mamba_scan.cu"

# (B, T, H, P, N, chunk): tests/test_torch_scan.py's cases — partial last
# chunks, chunks 8 to 512, the decode step — and a chunk of 512 that T
# fills past one 64-row block.
CASES = [(2, 70, 3, 16, 8, 32), (1, 200, 2, 32, 16, 64), (1, 100, 2, 16, 8, 8),
         (1, 40, 2, 16, 16, 512), (4, 1, 3, 16, 16, 32), (1, 600, 2, 16, 8, 512)]


def _inputs(seed, B, T, H, P, N, shared_bc=False):
    rng = np.random.default_rng(seed)
    bc = [(rng.standard_normal((B, T, 1 if shared_bc else H, N)) * 0.5).astype(np.float32)
          for _ in range(2)]
    return (rng.standard_normal((B, T, H, P)).astype(np.float32),
            (-np.abs(rng.standard_normal((B, T, H))) * 0.3).astype(np.float32),
            *(np.broadcast_to(t, (B, T, H, N)) for t in bc))


def _both(arrays, dtype):
    return ([torch.from_numpy(np.array(a)).to(TDT[dtype]) for a in arrays],
            [jnp.asarray(a).astype(JDT[dtype]) for a in arrays])


def _excess(got, want, rtol):
    """How far past the tolerance the worst element is (≤ 1 passes)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32)) if not isinstance(
        want, torch.Tensor) else want.float().numpy()
    return float((np.abs(g - w) / (TOL + rtol * np.abs(w))).max())


def _rtol(dtype):
    return TOL + (2.0 ** -8 if dtype == "bf16" else 0.0)


# ------------------------------------------------- the decomposition
@pytest.mark.parametrize("with_s0", [False, True], ids=["zero_state", "s0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_decomposition_matches_the_reference(case, dtype, with_s0):
    """The three passes, in f32, against the Pallas body in interpret mode
    (or, with an initial state, the reference's `ssd_chunk_ref`, where its
    `ssd_scan` sends such a call) and against the port's `ssd_chunk_ref`."""
    B, T, H, P, N, chunk = case
    (xd, da, bm, cm), jargs = _both(_inputs(T + chunk, B, T, H, P, N), dtype)
    s0 = (np.random.default_rng(N).standard_normal((B, H, N, P)).astype(np.float32)
          if with_s0 else None)
    ts0 = None if s0 is None else torch.from_numpy(s0)
    y, s = ssd_decomposed_ref(xd, da, bm, cm, chunk=chunk, initial_state=ts0)
    assert y.shape == (B, T, H, P) and y.dtype == TDT[dtype]
    assert s.shape == (B, H, N, P) and s.dtype == torch.float32
    if with_s0:
        jy, js = jssd_chunk_ref(*jargs, chunk=chunk, initial_state=jnp.asarray(s0))
    else:
        jy, js = jssd_scan(*jargs, chunk=chunk, interpret=True)
    assert _excess(y, jy, TOL) <= 1 and _excess(s, js, TOL) <= 1
    py, ps = ssd_chunk_ref(xd, da, bm, cm, chunk=chunk, initial_state=ts0)
    assert _excess(y, py, TOL) <= 1 and _excess(s, ps, TOL) <= 1


def test_passes_carry_each_chunks_incoming_state():
    """Pass 2 hands chunk c the state after chunks 0 .. c − 1 (the
    chunk-by-chunk reference run on a prefix), and its last state is the
    final one."""
    B, T, H, P, N, chunk = 2, 150, 2, 16, 8, 32
    xd, da, bm, cm = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in _inputs(9, B, T, H, P, N))
    s0 = torch.randn((B, H, N, P), generator=torch.Generator().manual_seed(1))
    states, decay = ssd_chunk_states_ref(xd, da, bm, cm, chunk=chunk)
    assert states.shape == (B, H, 5, N, P) and decay.shape == (B, H, 5)
    incoming, final = ssd_carry_ref(states, decay, s0)
    torch.testing.assert_close(incoming[:, :, 0], s0)
    for c in range(1, 5):
        _, want = ssd_chunk_ref(xd[:, :c * chunk], da[:, :c * chunk], bm[:, :c * chunk],
                                cm[:, :c * chunk], chunk=chunk, initial_state=s0)
        torch.testing.assert_close(incoming[:, :, c], want, rtol=TOL, atol=TOL)
    _, want = ssd_chunk_ref(xd, da, bm, cm, chunk=chunk, initial_state=s0)
    torch.testing.assert_close(final, want, rtol=TOL, atol=TOL)
    y = ssd_chunk_outputs_ref(xd, da, bm, cm, incoming, chunk=chunk)
    want_y, _ = ssd_chunk_ref(xd, da, bm, cm, chunk=chunk, initial_state=s0)
    torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)


def test_lost_carry_is_a_restart_from_zero():
    """`ssd_lost_carry` (the planted fault of the card's checks) gives what
    a scan restarted from a zero state at chunk ``lost`` gives."""
    B, T, H, P, N, chunk = 2, 300, 3, 16, 8, 64
    xd, da, bm, cm = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in _inputs(3, B, T, H, P, N))
    s0 = torch.randn((B, H, N, P), generator=torch.Generator().manual_seed(2))
    states, decay = ssd_chunk_states_ref(xd, da, bm, cm, chunk=chunk)
    incoming, _ = ssd_carry_ref(states, decay, s0)
    y, s = ssd_chunk_ref(xd, da, bm, cm, chunk=chunk, initial_state=s0)
    yf, sf = ssd_lost_carry(y, s, incoming, decay, xd, da, bm, cm, chunk=chunk, lost=2)
    y1, _ = ssd_chunk_ref(xd[:, :128], da[:, :128], bm[:, :128], cm[:, :128],
                          chunk=chunk, initial_state=s0)
    y2, s2 = ssd_chunk_ref(xd[:, 128:], da[:, 128:], bm[:, 128:], cm[:, 128:], chunk=chunk)
    torch.testing.assert_close(yf, torch.cat([y1, y2], 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sf, s2, rtol=1e-5, atol=1e-5)


# --------------------------------------------------- the precision plan
ZAMBA_CUT = (1, 512, 4, 64, 64, 128)   # Zamba2-1.2B's head widths, T cut to 512


@pytest.mark.parametrize("with_s0", [False, True], ids=["zero_state", "s0"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_products_stay_within_the_scan_tolerance(dtype, with_s0):
    """The tensor-core products as the kernels issue them (each f32
    operand split into bf16 hi + lo, f32 sums; f32 inputs split too), at
    Zamba2's widths with group-shared B/C, against the Pallas body in
    interpret mode (or the reference's `ssd_chunk_ref` with a state) run
    in f32 on the same (bf16-exact) inputs, as the card's checks hold the
    kernels: a bf16 y adds its one rounding to the tolerance."""
    B, T, H, P, N, chunk = ZAMBA_CUT
    xd, da, bm, cm = _both(_inputs(11, B, T, H, P, N, shared_bc=True), dtype)[0]
    jargs = [jnp.asarray(t.float().numpy()) for t in (xd, da, bm, cm)]
    bm, cm = (t[:, :, :1].expand(B, T, H, N) for t in (bm, cm))   # head stride 0
    s0 = (np.random.default_rng(5).standard_normal((B, H, N, P)).astype(np.float32)
          if with_s0 else None)
    y, s = ssd_decomposed_ref(xd, da, bm, cm, chunk=chunk, precision="bf16x2",
                              initial_state=None if s0 is None else torch.from_numpy(s0))
    if with_s0:
        jy, js = jssd_chunk_ref(*jargs, chunk=chunk, initial_state=jnp.asarray(s0))
    else:
        jy, js = jssd_scan(*jargs, chunk=chunk, interpret=True)
    assert _excess(y, jy, _rtol(dtype)) <= 1
    assert _excess(s, js, TOL) <= 1


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_one_bf16_rounding_would_spend_the_tolerance(dtype):
    """Why the kernels split: the same products with each f32 operand
    rounded to bf16 once fall outside the tolerance on both y and the
    state."""
    B, T, H, P, N, chunk = ZAMBA_CUT
    xd, da, bm, cm = _both(_inputs(11, B, T, H, P, N, shared_bc=True), dtype)[0]
    jargs = [jnp.asarray(t.float().numpy()) for t in (xd, da, bm, cm)]
    y, s = ssd_decomposed_ref(xd, da, bm, cm, chunk=chunk, precision="bf16")
    jy, js = jssd_chunk_ref(*jargs, chunk=chunk)
    assert _excess(y, jy, _rtol(dtype)) > 1
    assert _excess(s, js, TOL) > 1


def test_split_bf16_parts():
    x = torch.tensor([1.0 + 2.0 ** -12, -3.14159265, 1e-3, 0.0])
    hi, lo = split_bf16(x)
    assert torch.equal(hi, hi.bfloat16().float()) and torch.equal(lo, lo.bfloat16().float())
    assert ((x - hi - lo).abs() <= 2.0 ** -17 * x.abs()).all()
    hi1, lo1 = split_bf16(x, "bf16")
    assert torch.equal(hi1, hi) and not lo1.any()
    with pytest.raises(ValueError, match="precision"):
        ssd_decomposed_ref(*(torch.zeros(1, 2, 1, 4),) * 1, torch.zeros(1, 2, 1),
                           torch.zeros(1, 2, 1, 4), torch.zeros(1, 2, 1, 4),
                           precision="tf32")


# ------------------------------------------------------ launch geometry
# (B, T, H, P, N, chunk, shared B/C): Zamba2's prompt scan and the batch-
# sliced phase-9 scan (two heads a CTA), the widest state (two 64-row
# state blocks), odd widths, short and long chunks, partial last chunks.
GRID_CASES = [(1, 4096, 64, 64, 64, 128, True), (4, 1024, 64, 64, 64, 128, True),
              (1, 600, 2, 128, 128, 512, False), (2, 97, 2, 128, 32, 128, True),
              (2, 70, 3, 16, 8, 32, True), (1, 300, 2, 30, 10, 8, False),
              (3, 65, 4, 64, 80, 64, True), (2, 2, 64, 64, 64, 32, True),
              # the wide passes: xLSTM's memory and normaliser, odd widths
              (1, 300, 2, 512, 512, 128, False), (2, 200, 2, 1, 512, 128, True),
              (1, 90, 3, 300, 20, 64, False), (1, 70, 2, 8, 200, 32, True)]


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: "x".join(map(str, c)))
def test_chunk_grid_covers_every_batch_head_chunk_once(case):
    """Every (batch, head, chunk) is covered exactly once by each pass:
    the state pass once per 64-row state block and column (all of N's
    rows and P's columns), the output pass once per real row of the chunk
    and column (128-row blocks; those past a short last chunk return; the
    wide passes' 128-column blocks), the carry pass once per state
    element."""
    B, T, H, P, N, chunk, shared = case
    g = chunk_grid(B, T, H, P, N, chunk, shared)
    nc = -(-T // chunk)
    assert g.heads_per_cta == chunk_heads_per_cta(H, P, shared, N=N)
    assert H % g.heads_per_cta == 0
    assert g.col_blocks == (-(-P // 128) if max(N, P) > 128 else 1)
    state = np.zeros((B, H, nc, N, P), dtype=np.int64)
    for i in range(g.state_ctas):
        b, c, heads, rows = g.state_cta(i)
        cols = g.state_cols(i)
        for h in heads:
            state[b, h, c, rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (state == 1).all()
    out = np.zeros((B, H, nc, chunk, P), dtype=np.int64)
    for i in range(g.output_ctas):
        b, c, heads, i0 = g.output_cta(i)
        cols = g.output_cols(i)
        lr = min(chunk, T - c * chunk)
        if i0 >= lr:
            continue
        for h in heads:
            out[b, h, c, i0:min(i0 + OUTPUT_ROWS, lr), cols.start:cols.stop] += 1
    real = np.zeros((nc, chunk), dtype=bool)
    for c in range(nc):
        real[c, :min(chunk, T - c * chunk)] = True
    assert (out[:, :, real] == 1).all() and (out[:, :, ~real] == 0).all()
    elems = np.zeros((B, H, N * P), dtype=np.int64)
    for i in range(g.carry_ctas):
        b, h, e = g.carry_cta(i)
        elems[b, h, e.start:e.stop] += 1
    assert (elems == 1).all()
    assert g.carry_ctas == B * H * -(-(N * P) // (4 * CARRY_THREADS))


def test_zamba2_prompt_grid_and_workspace():
    """Zamba2-1.2B's prompt scan (B1 T4096 H64 P64 N64, L 128, group-shared
    B/C): two heads a CTA, 1,024 state CTAs, 256 carry CTAs, 1,024
    output CTAs on the H100's 132 SMs, and a workspace of 33.5 MB of
    states plus 8 KB of decays."""
    g = chunk_grid(1, 4096, 64, 64, 64, 128, True)
    assert (g.heads_per_cta, g.chunks, g.row_blocks, g.state_blocks) == (2, 32, 1, 1)
    assert (g.state_ctas, g.carry_ctas, g.output_ctas) == (1024, 256, 1024)
    assert g.workspace_floats * 4 == 64 * 32 * 64 * 64 * 4 + 64 * 32 * 4
    states, decay = chunk_workspace(1, 4096, 64, 64, 64, 128, "cpu")
    assert states.shape == (1, 64, 32, 64, 64) and decay.shape == (1, 64, 32)
    assert states.dtype == decay.dtype == torch.float32
    assert states.is_contiguous() and decay.is_contiguous()
    assert states.numel() * 4 == 33_554_432
    assert states.untyped_storage().nbytes() == g.workspace_floats * 4
    assert decay.data_ptr() == states.data_ptr() + states.numel() * 4


@pytest.mark.parametrize("B, T, H, P, N, chunk", CASES)
def test_scan_buffers_hold_the_chunks_workspace(B, T, H, P, N, chunk):
    """`scan_buffers` allocates what a launch writes: y, the state and, on
    the chunks route (T > 1), the `chunk_workspace` for ``chunk``; the
    decode route (T = 1) needs no workspace."""
    xd, da, bm, cm = (torch.from_numpy(np.ascontiguousarray(t))
                      for t in _inputs(0, B, T, H, P, N))
    y, state, workspace = scan_buffers(xd, da, bm, cm, chunk=chunk)
    assert y.shape == (B, T, H, P) and state.shape == (B, H, N, P)
    if T == 1:
        assert workspace is None
        return
    nc = -(-T // chunk)
    states, decay = workspace
    assert states.shape == (B, H, nc, N, P) and decay.shape == (B, H, nc)
    floats = chunk_grid(B, T, H, P, N, chunk).workspace_floats
    assert states.untyped_storage().nbytes() == floats * 4


@pytest.mark.parametrize("bm, chunk", [(None, 128), (64, 64), (4, 8), (1024, 512)])
def test_scan_family_buffers_take_the_tiles_chunk(bm, chunk):
    """The scheduler's ``buffers`` hook for a scan member (allocated on the
    launching stream before a mixed launch forks) sizes the workspace at
    the chunk `scan_for_desc` launches at that tile (bm, clamped to
    [8, 512]; 128 without a tile)."""
    B, T, H, P, N = 1, 1000, 2, 16, 8
    ins = (torch.from_numpy(np.ascontiguousarray(t)) for t in _inputs(1, B, T, H, P, N))
    tile = None if bm is None else TileConfig(bm, 128, 128)
    y, state, (states, decay) = OP_FAMILIES["mamba_scan"].buffers(
        ScanDesc(B, T, H, P, N, "f32"), *ins, tile=tile)
    assert states.shape == (B, H, -(-T // chunk), N, P)
    assert decay.shape == (B, H, -(-T // chunk))


@pytest.mark.parametrize("H, P, shared, dtype, want", [
    (64, 64, True, "bf16", 2), (64, 64, False, "bf16", 1), (3, 16, True, "bf16", 1),
    (2, 65, True, "bf16", 1), (2, 80, True, "bf16", 1), (4, 128, True, "bf16", 1),
    (2, 48, True, "bf16", 2), (64, 64, True, "f32", 1)])
def test_two_heads_a_cta_only_with_shared_b_and_c(H, P, shared, dtype, want):
    assert chunk_heads_per_cta(H, P, shared, TDT[dtype]) == want
    assert chunk_grid(1, 256, H, P, 16, 128, shared, TDT[dtype]).heads_per_cta == want
    # a wide N takes the wide passes, one head a CTA
    assert chunk_grid(1, 256, H, P, 512, 128, shared, TDT[dtype]).heads_per_cta == 1


def _c_params(name: str) -> int:
    src = CSRC.read_text()
    m = re.search(rf'extern "C" int {name}\((.*?)\)\s*\{{', src, re.S)
    assert m, name
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("name", ["repro_mamba_scan", "repro_mamba_chunk_occupancy",
                                  "repro_mamba_decode", "repro_mamba_decode_occupancy"])
def test_ctypes_signatures_match_the_c_entry_points(name):
    """The launcher's ctypes argument lists have as many entries as the C
    entry points have parameters (a missing one shifts every pointer)."""
    assert len(_SIGNATURES[name][1]) == _c_params(name)
