"""Launchers of the SSD-scan CUDA kernels (`csrc/mamba_scan.cu`), which
replace the TPU kernel `repro/kernels/mamba_scan/kernel.py:24
_mamba_kernel`.

Two hand-written routes compute the scan, chosen by shape alone
(`scan_route`): a decode step (T = 1) takes `mamba_decode_kernel`, a
stream of 16-byte state stores on the grid `decode_grid` gives it; every
other T takes the chunked form, three launches with the chunks in
parallel (`ssd_state_kernel`: each chunk's local end state;
`ssd_carry_kernel`: the states carried across chunks; `ssd_output_kernel`:
each chunk's y), on the grid `chunk_grid` gives, with the intra-chunk
products on tensor cores.  N or P above 128 (xLSTM's mLSTM, N = P = 512,
and its normaliser, P = 1) take the wide state and output passes, one
head a CTA with P in 128-column blocks and the output pass streaming C
and the carried state in 64-row N blocks; the decode kernel's wide
instantiation holds 16 values of C and B a lane.  Both read xd (B,T,H,P), da (B,T,H) and B/C
(B,T,H,N) through their strides, in bf16 or f32, so the launcher
transposes, pads and copies nothing: a Mamba2 group-shared B/C may be a
broadcast view, and then a CTA of the chunked form takes two heads.
`mamba_scan_fwd` takes CUDA tensors only (the CPU path is
`ref.ssd_chunk_ref`, chosen by `ops.ssd_scan` from the tensors' device),
writes into ``out`` when given, takes the chunked form's f32 workspace
from PyTorch's caching allocator on the launching stream (or ``workspace``),
and adds one to ``mamba_scan_fwd.launches`` and to
``mamba_scan_fwd.routes[route]`` per call (on the chunks route, one for
its three kernel launches).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import (
    DTYPE_CODES,
    output,
    raise_on_error,
    refuse_grad,
    sm_count,
)

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "repro_mamba_scan": (_I, (_P,) * 9 + (_I,) + (_LL,) * 18 + (_I, _P)),
    "repro_mamba_chunk_occupancy": (_I, (_I, _I, _LL, _LL, _LL, _IP, _IP)),
    "repro_mamba_decode": (_I, (_P,) * 7 + (_I,) + (_LL,) * 12 + (_I, _I, _P)),
    "repro_mamba_decode_occupancy": (_I, (_I, _I, _I, _I, _IP, _IP)),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
NARROW_DIM = 128   # N and P of the narrow instantiations (`csrc/mamba_scan.cu:kMaxDim`)
MAX_DIM = 512      # N and P capacity (`kMaxWide`)
MAX_CHUNK = 512
SCAN_ROUTES = ("decode", "chunks")
DECODE_THREADS = 256   # `csrc/mamba_scan.cu:kDecodeThreads`
MAX_PAIRS_PER_CTA = 8  # `kMaxPairsPerCta`
CHUNK_BLOCK = 64       # `kBlk`: rows of a j block and of a state block
OUTPUT_ROWS = 128      # `kOutRows`: rows of an output-pass CTA (8 warps of 16)
CARRY_THREADS = 256    # `kCarryThreads`
COL_BLOCK = 128        # `kColBlk`: columns of P a wide CTA takes


def scan_shapes(xd, da, Bm, Cm) -> tuple:
    """``(B, T, H, P, N)``; raises on inconsistent shapes."""
    if xd.dim() != 4 or da.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("the scan takes xd (B,T,H,P), da (B,T,H), Bm and Cm "
                         "(B,T,H,N)")
    B, T, H, P = xd.shape
    N = Bm.shape[-1]
    if (tuple(da.shape) != (B, T, H) or tuple(Bm.shape[:3]) != (B, T, H)
            or tuple(Cm.shape) != tuple(Bm.shape)):
        raise ValueError(f"xd {tuple(xd.shape)}, da {tuple(da.shape)}, Bm "
                         f"{tuple(Bm.shape)} and Cm {tuple(Cm.shape)} do not "
                         "match")
    return B, T, H, P, N


def scan_route(T: int, P: int, N: int, chunk: int) -> str:
    """Which kernel a scan launch of these shapes takes: ``"decode"``
    (`mamba_decode_kernel`) for a decode step, T = 1; ``"chunks"`` (the
    chunked form's three passes) for every other T.  Raises on an N or P
    outside [1, 512] or a chunk outside [1, 512], whichever the route: a
    call that one kernel refuses, the other refuses too.  A choice by shape between two
    kernels, each held to `ssd_chunk_ref` on the card; nothing overrides
    it."""
    if not (1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"N={N} and P={P} must lie in [1, {MAX_DIM}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} must lie in [1, {MAX_CHUNK}]")
    return "decode" if T == 1 else "chunks"


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


class DecodeGrid(NamedTuple):
    """The decode kernel's grid for ``pairs`` (batch, head) pairs: ``ctas``
    CTAs of 256 threads, each taking ``pairs_per_cta`` whole pairs or one
    of a pair's ``slices`` column slices of ``groups`` 4-column groups;
    ``row_lanes`` threads split each pair's (or slice's) rows."""

    ctas: int
    slices: int
    pairs_per_cta: int
    groups: int
    row_lanes: int


def decode_grid(pairs: int, P: int, N: int, sms: int) -> DecodeGrid:
    """The fewest column slices per pair (powers of two, at most one per
    4-column group) that give at least ``sms`` CTAs, so a small batch puts
    work on every SM; pairs per CTA so that a CTA's threads cover about
    one pair's (slice's) groups × rows (up to 8 small pairs per CTA,
    never with slices)."""
    total = -(-P // 4)
    slices = 1
    while True:
        groups = -(-total // slices)
        per_pair = min(DECODE_THREADS,
                       max(DECODE_THREADS // MAX_PAIRS_PER_CTA,
                           _pow2_ceil(groups) * _pow2_ceil(N)))
        ppc = DECODE_THREADS // per_pair if slices == 1 else 1
        ctas = -(-pairs // ppc) * slices
        if ctas >= sms or 2 * slices > total:
            return DecodeGrid(ctas, slices, ppc, groups,
                              DECODE_THREADS // ppc // _pow2_ceil(groups))
        slices *= 2


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


class ChunkGrid(NamedTuple):
    """The chunked form's launches for one call: ``heads_per_cta`` heads
    per CTA of the state and output passes; ``chunks`` chunks of L rows,
    ``row_blocks`` 128-row blocks of a chunk (one output CTA each),
    ``state_blocks`` 64-row blocks of the (N padded to 16) state,
    ``carry_blocks`` carry CTAs per (batch, head); the CTAs of the three
    passes; the f32 workspace (each chunk's state, then its decay);
    ``col_blocks`` 128-column blocks of P a CTA of the wide passes takes
    (1 on the narrow ones, whose CTAs take every column)."""

    B: int
    H: int
    N: int
    P: int
    heads_per_cta: int
    chunks: int
    row_blocks: int
    state_blocks: int
    carry_blocks: int
    state_ctas: int
    carry_ctas: int
    output_ctas: int
    workspace_floats: int
    col_blocks: int = 1

    def _cols(self, pb: int) -> range:
        if self.col_blocks == 1:
            return range(self.P)
        return range(pb * COL_BLOCK, min(self.P, (pb + 1) * COL_BLOCK))

    def state_cta(self, i: int) -> tuple:
        """(batch, chunk, heads, state rows) of state-pass CTA ``i``, as
        `ssd_state_kernel` (`ssd_state_wide_kernel`) reads its
        ``blockIdx.x``; `state_cols` its columns."""
        mb, i = i % self.state_blocks, i // self.state_blocks
        i //= self.col_blocks
        groups = self.H // self.heads_per_cta
        g, i = i % groups, i // groups
        c, b = i % self.chunks, i // self.chunks
        h0 = g * self.heads_per_cta
        return (b, c, range(h0, h0 + self.heads_per_cta),
                range(mb * CHUNK_BLOCK, min(self.N, (mb + 1) * CHUNK_BLOCK)))

    def state_cols(self, i: int) -> range:
        """The columns of P state-pass CTA ``i`` computes."""
        return self._cols(i // self.state_blocks % self.col_blocks)

    def carry_cta(self, i: int) -> tuple:
        """(batch, head, state elements) of carry-pass CTA ``i`` (4
        elements a thread)."""
        bh, eb = i // self.carry_blocks, i % self.carry_blocks
        per = 4 * CARRY_THREADS
        return (bh // self.H, bh % self.H,
                range(eb * per, min(self.N * self.P, (eb + 1) * per)))

    def output_cta(self, i: int) -> tuple:
        """(batch, chunk, heads, first row) of output-pass CTA ``i``, as
        `ssd_output_kernel` (`ssd_output_wide_kernel`) reads its
        ``blockIdx.x`` (a row block past a short last chunk returns at
        once); `output_cols` its columns."""
        i //= self.col_blocks
        groups = self.H // self.heads_per_cta
        g, i = i % groups, i // groups
        rb, i = i % self.row_blocks, i // self.row_blocks
        c, b = i % self.chunks, i // self.chunks
        h0 = g * self.heads_per_cta
        return b, c, range(h0, h0 + self.heads_per_cta), rb * OUTPUT_ROWS

    def output_cols(self, i: int) -> range:
        """The columns of P output-pass CTA ``i`` computes."""
        return self._cols(i % self.col_blocks)


def is_wide(P: int, N: int) -> bool:
    """Whether these widths take the wide passes (`csrc/mamba_scan.cu:is_wide`)."""
    return N > NARROW_DIM or P > NARROW_DIM


def chunk_heads_per_cta(H: int, P: int, shared_bc: bool,
                        dtype: torch.dtype = torch.bfloat16, N: int = 0) -> int:
    """2 when B and C are head-broadcast views (``shared_bc``: head stride
    0), H is even, P pads to at most 64 (two heads' accumulators fit a
    thread's registers), N is narrow and the inputs are bf16: C·Bᵀ is
    then computed once for both heads; else 1.  With f32 inputs (hi and lo
    planes) two heads take one output CTA per SM, and one head a CTA ran
    faster on the card (PERF.md section 6, probes/scan_chunks/ab.py
    --heads)."""
    return (2 if shared_bc and H % 2 == 0 and _pad16(P) <= 64 and dtype == torch.bfloat16
            and N <= NARROW_DIM else 1)


def chunk_grid(B: int, T: int, H: int, P: int, N: int, chunk: int,
               shared_bc: bool = False, dtype: torch.dtype = torch.bfloat16) -> ChunkGrid:
    """The chunked form's geometry (as `csrc/mamba_scan.cu:chunk_geometry`
    computes it): the state pass a CTA per (batch, chunk, head group,
    64 state rows), the carry pass one per (batch, head, 1,024 state
    elements), the output pass one per (batch, chunk, 128-row block, head
    group), the head groups fastest so that CTAs sharing B and C run
    together.  The wide passes (N or P > 128) take one head a CTA and one
    128-column block of P (next fastest after the state rows, fastest in
    the output pass)."""
    hpc = chunk_heads_per_cta(H, P, shared_bc, dtype, N)
    nc = -(-T // chunk)
    rblocks = -(-chunk // OUTPUT_ROWS)
    mblocks = -(-_pad16(N) // CHUNK_BLOCK)
    eblocks = -(-(N * P) // (4 * CARRY_THREADS))
    pblocks = -(-P // COL_BLOCK) if is_wide(P, N) else 1
    groups = H // hpc
    return ChunkGrid(B, H, N, P, hpc, nc, rblocks, mblocks, eblocks,
                     B * nc * groups * mblocks * pblocks, B * H * eblocks,
                     B * nc * groups * rblocks * pblocks, B * H * nc * (N * P + 1),
                     pblocks)


def chunk_workspace(B: int, T: int, H: int, P: int, N: int, chunk: int,
                    device) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked form's f32 workspace, from PyTorch's caching allocator
    on the current stream: each chunk's state (B, H, chunks, N, P) — the
    local end state, then the state entering the chunk — and each chunk's
    decay exp(s_L) (B, H, chunks)."""
    nc = -(-T // chunk)
    flat = torch.empty(B * H * nc * (N * P + 1), dtype=torch.float32, device=device)
    return (flat[:B * H * nc * N * P].view(B, H, nc, N, P),
            flat[B * H * nc * N * P:].view(B, H, nc))


@lru_cache(maxsize=None)
def chunk_residency(device: torch.device, dtype: torch.dtype, heads_per_cta: int,
                    N: int, P: int, chunk: int) -> tuple[tuple, tuple]:
    """((state, carry, output) CTAs per SM, (state, output) dynamic shared
    bytes per CTA) of the chunked form's instantiation."""
    lib = _build.load("mamba_scan", _SIGNATURES)
    blocks, smem = (ctypes.c_int * 3)(), (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        code = lib.repro_mamba_chunk_occupancy(DTYPE_CODES[dtype], heads_per_cta, N, P,
                                               chunk, blocks, smem)
    raise_on_error(lib, code, "mamba_scan chunk occupancy query")
    return tuple(blocks), tuple(smem)


@lru_cache(maxsize=None)
def decode_residency(device: torch.device, dtype: torch.dtype, vec: bool = True,
                     s0: bool = False, wide: bool = False) -> tuple[int, int]:
    """(CTAs per SM, static shared bytes per CTA) of the decode kernel's
    instantiation (``vec``: 16-byte rows; ``s0``: with an initial state;
    ``wide``: N > 128)."""
    lib = _build.load("mamba_scan", _SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_mamba_decode_occupancy(DTYPE_CODES[dtype], int(vec), int(s0),
                                                int(wide), ctypes.byref(blocks),
                                                ctypes.byref(smem))
    raise_on_error(lib, code, "mamba_scan decode occupancy query")
    return blocks.value, smem.value


def _decode_launch(lib, xd, da, Bm, Cm, s0, y, sf, grid: DecodeGrid) -> int:
    """One launch of ``lib``'s `repro_mamba_decode` on these tensors;
    returns its error code."""
    B, _, H, P = xd.shape
    return lib.repro_mamba_decode(
        xd.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
        DTYPE_CODES[xd.dtype], B, H, P, Bm.shape[-1],
        xd.stride(0), xd.stride(2), da.stride(0), da.stride(2),
        Bm.stride(0), Bm.stride(2), Cm.stride(0), Cm.stride(2),
        grid.slices, grid.pairs_per_cta,
        torch.cuda.current_stream(xd.device).cuda_stream)


def mamba_scan_fwd(xd: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int = 128,
                   initial_state: torch.Tensor | None = None,
                   out=None, workspace=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan on the card, on the kernel `scan_route` names.  Returns y
    (B,T,H,P) in xd's dtype and the final state (B,H,N,P) float32;
    ``initial_state`` (B,H,N,P) is read as f32 (zeros when None).  ``out``
    is a ``(y, state)`` pair, ``workspace`` a `chunk_workspace` pair for
    ``chunk``, as `ops.scan_buffers` gives them (the workspace is made on
    the current stream when None; after the call it holds each chunk's
    incoming state and decay).  ``chunk`` is the chunked form's L (a
    decode step is one row whatever it is).  The counts are per call: a
    decode-route call is one kernel launch, a chunks-route call three."""
    refuse_grad("mamba_scan_fwd", xd, da, Bm, Cm, initial_state,
                backward="call `ops.ssd_scan` with no initial state, whose "
                         "autograd Function runs the backward (a call with one "
                         "has none, as in the reference, which sends it to XLA)")
    for t in (xd, da, Bm, Cm):
        if t.device.type != "cuda":
            raise ValueError("mamba_scan_fwd: the CUDA kernel needs CUDA "
                             f"tensors, got {t.device}")
        if t.device != xd.device or t.dtype != xd.dtype:
            raise ValueError("mamba_scan_fwd: xd, da, Bm and Cm must share "
                             "one device and dtype")
    for t in (xd, Bm, Cm):
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError("mamba_scan_fwd: the last dim of xd, Bm and Cm "
                             "must be contiguous")
    if xd.dtype not in DTYPE_CODES:
        raise ValueError(f"mamba_scan_fwd: unsupported dtype {xd.dtype}")
    B, T, H, P, N = scan_shapes(xd, da, Bm, Cm)
    route = scan_route(T, P, N, chunk)
    s0 = None
    if initial_state is not None:
        s0 = initial_state.float().contiguous()
        if tuple(s0.shape) != (B, H, N, P) or s0.device != xd.device:
            raise ValueError(f"initial_state must be (B,H,N,P) = "
                             f"{(B, H, N, P)} on {xd.device}")
    y_out, s_out = out if out is not None else (None, None)
    y = output(y_out, (B, T, H, P), xd.dtype, xd.device, "mamba_scan_fwd")
    sf = output(s_out, (B, H, N, P), torch.float32, xd.device,
                "mamba_scan_fwd state")
    if B * H == 0:
        return y, sf
    lib = _build.load("mamba_scan", _SIGNATURES)
    with torch.cuda.device(xd.device):
        if route == "decode":
            code = _decode_launch(lib, xd, da, Bm, Cm, s0, y, sf,
                                  decode_grid(B * H, P, N, sm_count(xd.device)))
        else:
            states, decay = (workspace if workspace is not None else
                             chunk_workspace(B, T, H, P, N, int(chunk), xd.device))
            nc = -(-T // int(chunk))
            for t, shape in ((states, (B, H, nc, N, P)), (decay, (B, H, nc))):
                if (tuple(t.shape) != shape or t.dtype != torch.float32
                        or t.device != xd.device or not t.is_contiguous()):
                    raise ValueError(f"mamba_scan_fwd: the workspace must be contiguous "
                                     f"f32 {shape} on {xd.device}")
            shared = Bm.stride(2) == 0 and Cm.stride(2) == 0
            code = lib.repro_mamba_scan(
                xd.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                None if s0 is None else s0.data_ptr(), y.data_ptr(),
                sf.data_ptr(), states.data_ptr(), decay.data_ptr(),
                DTYPE_CODES[xd.dtype], B, T, H, P, N, int(chunk),
                xd.stride(0), xd.stride(1), xd.stride(2),
                da.stride(0), da.stride(1), da.stride(2),
                Bm.stride(0), Bm.stride(1), Bm.stride(2),
                Cm.stride(0), Cm.stride(1), Cm.stride(2),
                chunk_heads_per_cta(H, P, shared, xd.dtype, N),
                torch.cuda.current_stream(xd.device).cuda_stream)
    raise_on_error(lib, code, f"mamba_scan_fwd ({route} route)")
    mamba_scan_fwd.launches += 1
    mamba_scan_fwd.routes[route] += 1
    return y, sf


mamba_scan_fwd.launches = 0
mamba_scan_fwd.routes = dict.fromkeys(SCAN_ROUTES, 0)
