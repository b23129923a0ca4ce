"""Launchers of the SSD-scan CUDA kernels (`csrc/mamba_scan.cu`), which
replace the TPU kernel `repro/kernels/mamba_scan/kernel.py:24
_mamba_kernel`.

Two hand-written kernels compute the scan, chosen by shape alone
(`scan_route`): a decode step (T = 1) takes `mamba_decode_kernel`, a
stream of 16-byte state stores on the grid `decode_grid` gives it; every
other T takes the chunk loop `mamba_kernel`.  Both read xd (B,T,H,P), da
(B,T,H) and B/C (B,T,H,N) through their strides, in bf16 or f32, so the
launcher transposes, pads and copies nothing: a Mamba2 group-shared B/C
may be a broadcast view.  `mamba_scan_fwd` takes CUDA tensors only (the
CPU path is `ref.ssd_chunk_ref`, chosen by `ops.ssd_scan` from the
tensors' device), writes into ``out`` when given, and adds one to
``mamba_scan_fwd.launches`` and to ``mamba_scan_fwd.routes[route]`` per
launch.
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
    sm_count,
)

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "repro_mamba_scan": (_I, (_P,) * 7 + (_I,) + (_LL,) * 18 + (_P,)),
    "repro_mamba_decode": (_I, (_P,) * 7 + (_I,) + (_LL,) * 12 + (_I, _I, _P)),
    "repro_mamba_decode_occupancy": (_I, (_I, _I, _I, _IP, _IP)),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
MAX_DIM = 128      # N and P capacity (`csrc/mamba_scan.cu:kMaxDim`)
MAX_CHUNK = 512
SCAN_ROUTES = ("decode", "chunks")
DECODE_THREADS = 256   # `csrc/mamba_scan.cu:kDecodeThreads`
MAX_PAIRS_PER_CTA = 8  # `kMaxPairsPerCta`


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
    (`mamba_decode_kernel`) for a decode step, T = 1; ``"chunks"``
    (`mamba_kernel`) for every other T.  Raises on an N or P outside [1,
    128] or a chunk outside [1, 512], whichever the route: a call that one
    kernel refuses, the other refuses too.  A choice by shape between two
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


@lru_cache(maxsize=None)
def decode_residency(device: torch.device, dtype: torch.dtype, vec: bool = True,
                     s0: bool = False) -> tuple[int, int]:
    """(CTAs per SM, static shared bytes per CTA) of the decode kernel's
    instantiation (``vec``: 16-byte rows; ``s0``: with an initial state)."""
    lib = _build.load("mamba_scan", _SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_mamba_decode_occupancy(DTYPE_CODES[dtype], int(vec), int(s0),
                                                ctypes.byref(blocks),
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
                   out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan on the card, on the kernel `scan_route` names.  Returns y
    (B,T,H,P) in xd's dtype and the final state (B,H,N,P) float32;
    ``initial_state`` (B,H,N,P) is read as f32 (zeros when None).  ``out``
    is a ``(y, state)`` pair from `ops.scan_buffers`.  ``chunk`` is the
    chunk loop's L (a decode step is one row whatever it is)."""
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
            code = lib.repro_mamba_scan(
                xd.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                None if s0 is None else s0.data_ptr(), y.data_ptr(),
                sf.data_ptr(), DTYPE_CODES[xd.dtype], B, T, H, P, N, int(chunk),
                xd.stride(0), xd.stride(1), xd.stride(2),
                da.stride(0), da.stride(1), da.stride(2),
                Bm.stride(0), Bm.stride(1), Bm.stride(2),
                Cm.stride(0), Cm.stride(1), Cm.stride(2),
                torch.cuda.current_stream(xd.device).cuda_stream)
    raise_on_error(lib, code, f"mamba_scan_fwd ({route} route)")
    mamba_scan_fwd.launches += 1
    mamba_scan_fwd.routes[route] += 1
    return y, sf


mamba_scan_fwd.launches = 0
mamba_scan_fwd.routes = dict.fromkeys(SCAN_ROUTES, 0)
