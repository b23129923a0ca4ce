"""Launchers of the grouped and ragged GEMM CUDA kernels
(`csrc/grouped_gemm.cu`).

``grouped_matmul`` replaces `repro/kernels/grouped_gemm/kernel.py:41
_grouped_kernel` and ``ragged_matmul`` replaces `:93 _ragged_kernel`.
Both are bound by bytes on the serving path: a group of decode GEMMs
streams one weight matrix per member; `csrc/tile_gemm.cuh` says how the
CTA tile answers that.  CUDA tensors only: the CPU path is the plain
version in `ref.py`, chosen by `ops.py` from the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import (
    DTYPE_CODES,
    MAX_GRID_Y,
    check_operands,
    cta_rows,
    raise_on_error,
)

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_grouped_matmul": (_I, (_P, _P, _P, _I, _I, _LL, _LL, _LL, _LL, _P)),
    "repro_ragged_matmul": (_I, (_P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL,
                                 _LL, _P)),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
MAX_GRID_Z = 65535


def grouped_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 16
                   ) -> torch.Tensor:
    """(G,M,K) x (G,K,N) -> (G,M,N) on the card, f32 accumulation.
    Adds one to ``grouped_matmul.launches`` per kernel launch."""
    dtype = check_operands(a, b)
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"grouped_matmul takes (G,M,K) and (G,K,N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    G, M, K = a.shape
    N = b.shape[2]
    rows = cta_rows(bm)
    if G > MAX_GRID_Z or -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"G={G}, M={M} exceed the kernel's grid")
    c = torch.empty((G, M, N), dtype=dtype, device=a.device)
    if c.numel() == 0:
        return c
    lib = _build.load("grouped_gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.repro_grouped_matmul(a.data_ptr(), b.data_ptr(),
                                        c.data_ptr(), DTYPE_CODES[dtype],
                                        rows, G, M, N, K, stream)
    raise_on_error(lib, code, "grouped_matmul")
    grouped_matmul.launches += 1
    return c


grouped_matmul.launches = 0


def ragged_matmul(a: torch.Tensor, b: torch.Tensor, block_group: torch.Tensor,
                  *, bm: int) -> torch.Tensor:
    """Row block i = rows [i·bm, (i+1)·bm) of ``a`` (Mtotal, K) times
    ``b[block_group[i]]`` (K, N) on the card, f32 accumulation.
    ``block_group`` is int32 on the operands' device, one entry per bm
    block.  ``bm`` must be ≤ 16 or a multiple of the 64-row CTA tile.
    Adds one to ``ragged_matmul.launches`` per kernel launch."""
    dtype = check_operands(a, b)
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"ragged_matmul takes (Mtotal,K) and (G,K,N), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    Mtotal, K = a.shape
    N = b.shape[2]
    rows = cta_rows(bm)
    if bm < 1 or (bm > rows and bm % rows):
        raise ValueError(f"bm={bm}: the ragged kernel takes bm ≤ 16 or a "
                         "multiple of 64")
    n_blocks = -(-Mtotal // bm)
    if (block_group.device != a.device or block_group.dtype != torch.int32
            or block_group.shape != (n_blocks,)
            or not block_group.is_contiguous()):
        raise ValueError(f"block_group must be contiguous int32 of shape "
                         f"({n_blocks},) on {a.device}")
    if n_blocks * max(bm // rows, 1) > MAX_GRID_Y:
        raise ValueError(f"Mtotal={Mtotal} exceeds the kernel's grid")
    c = torch.empty((Mtotal, N), dtype=dtype, device=a.device)
    if c.numel() == 0:
        return c
    lib = _build.load("grouped_gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.repro_ragged_matmul(a.data_ptr(), b.data_ptr(),
                                       block_group.data_ptr(), c.data_ptr(),
                                       DTYPE_CODES[dtype], rows, bm, n_blocks,
                                       Mtotal, N, K, stream)
    raise_on_error(lib, code, "ragged_matmul")
    ragged_matmul.launches += 1
    return c


ragged_matmul.launches = 0
