"""Launcher of the single-GEMM CUDA kernel (`csrc/gemm.cu`).

Replaces the TPU kernel `repro/kernels/gemm/kernel.py:45 _matmul_kernel`
(split_k = 1).  The kernel is bound by bytes on the serving path (decode
GEMMs stream weights far larger than their activations); `csrc/
tile_gemm.cuh` says how its design answers that.  This module takes CUDA
tensors only: the CPU path is the plain version in `ref.py`, chosen by
`ops.gemm` from the tensors' device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
CTA_COLS = 64
MAX_GRID_Y = 65535

_SIGNATURES = {
    "repro_matmul": (ctypes.c_int, (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p)),
    "repro_error_string": (ctypes.c_char_p, (ctypes.c_int,)),
}


def cta_rows(bm: int) -> int:
    """The CTA row tile that runs a `TileConfig` row block ``bm``: 16 for
    bm ≤ 16 (the decode tiles, rows past M masked), else 64."""
    return 16 if bm <= 16 else 64


def cta_k(dtype: torch.dtype, rows: int) -> int:
    """The CTA's K step (`csrc/tile_gemm.cuh:TileCfg::BK`)."""
    return 128 if dtype == torch.bfloat16 and rows == 16 else 64


def instantiation(dtype: torch.dtype, bm: int) -> str:
    """The compiled CTA tile a launch at row block ``bm`` runs, e.g.
    ``bf16 16x64x128`` (rows x columns x K step)."""
    rows = cta_rows(bm)
    name = {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]
    return f"{name} {rows}x{CTA_COLS}x{cta_k(dtype, rows)}"


def check_operands(*tensors: torch.Tensor) -> torch.dtype:
    """Raise unless every tensor is a contiguous CUDA tensor of one
    supported dtype on one device; returns the dtype."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got {t.device}")
        if t.device != t0.device:
            raise ValueError(f"operands on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise ValueError(f"operand dtypes differ: {t.dtype} vs {t0.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel needs contiguous operands")
    if t0.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {t0.dtype}; the kernel takes "
                         "bfloat16 or float32")
    return t0.dtype


def raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def matmul(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
           tb: bool = False, bm: int = 16) -> torch.Tensor:
    """C[M,N] = op(a) @ op(b) on the card, f32 accumulation, output in the
    operands' dtype.  ``a`` is (M,K), or (K,M) when ``ta``; ``b`` is
    (K,N), or (N,K) when ``tb``.  ``bm`` is the `TileConfig` row block
    (`cta_rows` maps it to the CTA tile).  Adds one to
    ``matmul.launches`` per kernel launch."""
    dtype = check_operands(a, b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes 2-D operands, got {a.shape} and {b.shape}")
    K, M = a.shape if ta else a.shape[::-1]
    N, Kb = b.shape if tb else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"inner dims differ: {a.shape} (ta={ta}) and "
                         f"{b.shape} (tb={tb})")
    rows = cta_rows(bm)
    if -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid ({MAX_GRID_Y} row tiles)")
    c = torch.empty((M, N), dtype=dtype, device=a.device)
    if c.numel() == 0:
        return c
    lib = _build.load("gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                DTYPE_CODES[dtype], int(ta), int(tb), rows,
                                M, N, K, stream)
    raise_on_error(lib, code, "matmul")
    matmul.launches += 1
    return c


matmul.launches = 0
