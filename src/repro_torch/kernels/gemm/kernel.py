"""Launchers of the GEMM CUDA kernels, and the geometry they share with
the plain versions.

- ``matmul`` (`csrc/gemm.cu`) replaces the TPU kernel
  `repro/kernels/gemm/kernel.py:45 _matmul_kernel` (split_k = 1);
- ``splitk_partials`` and ``splitk_reduce`` (`csrc/gemm_split_k.cu`)
  replace `:65 _matmul_splitk_kernel` and `:86 _reduce_kernel`;
- ``stream_k_partials`` and ``stream_k_fixup`` (`csrc/gemm_stream_k.cu`)
  replace `:215 _stream_k_kernel` and `:247 _stream_k_fixup_kernel`.  The
  walk runs in the card's units (`card_geometry`): CTA tiles picked from
  M, and W workgroups from the planner's G, the SM count and the
  kernel's occupancy.

Every kernel is bound by bytes on the serving path (decode GEMMs stream
weights far larger than their activations); the sources say how their
design answers that.  This module takes CUDA tensors only: the CPU path
is the plain versions in `ref.py`, chosen by `ops.gemm` from the
tensors' device.  Each launcher writes into ``out`` when given (the
mixed launch allocates every buffer before it forks onto its streams),
else allocates it, and adds one to its ``launches`` count per launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
CTA_COLS = 64
MAX_GRID_Y = 65535

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_ERROR = {"repro_error_string": (ctypes.c_char_p, (_I,))}
_SIGNATURES = {
    "repro_matmul": (_I, (_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _P)),
    **_ERROR,
}
_SPLIT_K_SIGNATURES = {
    "repro_splitk_matmul": (_I, (_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL,
                                 _I, _LL, _P)),
    "repro_splitk_reduce": (_I, (_P, _P, _I, _I, _LL, _P)),
    **_ERROR,
}
_STREAM_K_SIGNATURES = {
    "repro_stream_k_matmul": (_I, (_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL,
                                   _LL, _LL, _LL, _LL, _LL, _P)),
    "repro_stream_k_fixup": (_I, (_P, _P, _P, _I, _LL, _LL, _LL, _LL, _LL,
                                  _P)),
    "repro_stream_k_occupancy": (_I, (_I, _I, _I, _I, ctypes.POINTER(_I),
                                      ctypes.POINTER(_I))),
    **_ERROR,
}


# ---------------------------------------------------------------- geometry
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


def split_k_slices(K: int, bk: int, split_k: int) -> tuple[int, int]:
    """``(split, slice_k)``: the effective split, never more slices than
    k blocks (`repro/kernels/gemm/ops.py:106`), and the K length of one
    slice, ⌈⌈K/bk⌉/split⌉·bk — the reference's slice of K padded to a
    (bk·split) multiple.  Slice s is K range [s·slice_k, (s+1)·slice_k)
    cut at K; the last slices may be short or empty."""
    kb = -(-K // bk)
    split = max(1, min(split_k, kb))
    return split, -(-kb // split) * bk


def stream_k_geometry(tm: int, tn: int, tk: int, grid_g: int):
    """Static Stream-K launch geometry (`repro/kernels/gemm/kernel.py:
    194-212`).  Returns ``(total, ipw, g_live, counts, slots)``: the MAC
    iteration count ``total = tm·tn·tk``, iterations per workgroup
    ``ipw = ⌈total / G⌉``, the live workgroup count ``⌈total / ipw⌉``,
    the per-output-tile contributor counts (tm, tn) int32 the fixup
    masks with, and the partial-slot depth ``slots = max(counts)``."""
    total = tm * tn * tk
    ipw = -(-total // max(1, min(grid_g, total)))
    g_live = -(-total // ipw)
    q = np.arange(tm * tn, dtype=np.int64)
    g_first = (q * tk) // ipw
    g_last = ((q + 1) * tk - 1) // ipw
    counts = (g_last - g_first + 1).astype(np.int32).reshape(tm, tn)
    return total, ipw, g_live, counts, int(counts.max())


def stream_k_tiles(M: int, N: int, K: int, bm: int, bn: int, bk: int
                   ) -> tuple[int, int, int]:
    """``(tm, tn, tk)``: the output tiles and k blocks of an M×N×K GEMM in
    units of bm×bn tiles and bk k blocks (the padded dims over the tile):
    the planner's `TileConfig` or the card's CTA tile."""
    return -(-M // bm), -(-N // bn), -(-K // bk)


def planner_g_max() -> int:
    """G_max, the planner's cap on a Stream-K tile's workgroups
    (`core/tuner.py:stream_k_grid`: pipeline_fill_tiles·4 = 8)."""
    from repro_torch.core.cost_model import DEFAULT_SPEC
    return DEFAULT_SPEC.pipeline_fill_tiles * 4


def stream_k_workgroups(grid_g: int, g_max: int, sms: int, ctas_per_sm: int
                        ) -> int:
    """W = ⌈G / G_max · SMs · CTAs_per_SM⌉ (at least 1): the card's
    workgroup count for a member the planner gave G of its G_max
    workgroups, so that G = G_max fills the card and a smaller G takes
    a proportional share of its SMs."""
    return max(1, -(-grid_g * sms * ctas_per_sm // g_max))


def walk_rows(M: int) -> int:
    """The Stream-K walk's CTA row tile, from M (not from the tile's bm):
    16 rows for M ≤ 16, 32 for M ≤ 32, else 64."""
    return 16 if M <= 16 else 32 if M <= 32 else 64


class StreamKGeometry(NamedTuple):
    """The Stream-K walk in the card's units: CTA tiles of ``rows`` ×
    ``cols`` with k step ``bk``, ``workgroups`` = W; and what
    `stream_k_geometry` gives for them (``counts`` is (tm, tn) int32
    numpy)."""

    rows: int
    cols: int
    bk: int
    workgroups: int
    tm: int
    tn: int
    tk: int
    total: int
    ipw: int
    live: int
    counts: np.ndarray
    slots: int


def walk_geometry(M: int, N: int, K: int, dtype: torch.dtype, workgroups: int
                  ) -> StreamKGeometry:
    """The walk of an M×N×K GEMM over CTA tiles (`walk_rows` × 64, the
    CTA's k step `cta_k`) by ``workgroups`` workgroups."""
    rows = walk_rows(M)
    bk = cta_k(dtype, rows)
    tm, tn, tk = stream_k_tiles(M, N, K, rows, CTA_COLS, bk)
    total, ipw, live, counts, slots = stream_k_geometry(tm, tn, tk, workgroups)
    return StreamKGeometry(rows, CTA_COLS, bk, workgroups, tm, tn, tk, total,
                           ipw, live, counts, slots)


@lru_cache(maxsize=None)
def walk_resources(device: torch.device, dtype: torch.dtype, ta: bool,
                   tb: bool, rows: int) -> tuple[int, int]:
    """``(ctas_per_sm, smem_bytes)`` of the walk kernel's instantiation:
    the CTAs that fit on one SM at once
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and one CTA's
    shared memory (its ring of k-slab stages and its epilogue staging)."""
    lib = _build.load("gemm_stream_k", _STREAM_K_SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_stream_k_occupancy(DTYPE_CODES[dtype], int(ta), int(tb),
                                            rows, ctypes.byref(blocks),
                                            ctypes.byref(smem))
    raise_on_error(lib, code, "stream_k occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the Stream-K walk ({dtype}, {rows} rows) fits no "
                           "CTA on an SM")
    return blocks.value, smem.value


@lru_cache(maxsize=1024)
def card_geometry(M: int, N: int, K: int, dtype: torch.dtype, ta: bool,
                  tb: bool, grid_g: int, device: torch.device
                  ) -> StreamKGeometry:
    """The walk a Stream-K tile of ``grid_g`` workgroups runs on this
    card: W from `stream_k_workgroups` with the device's SM count and
    the kernel's occupancy."""
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"stream_k_partials: empty GEMM {M}x{N}x{K}")
    if grid_g < 1:
        raise ValueError(f"grid_g={grid_g} must be ≥ 1")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = walk_rows(M)
    w = stream_k_workgroups(grid_g, planner_g_max(), sms,
                            walk_resources(device, dtype, ta, tb, rows)[0])
    return walk_geometry(M, N, K, dtype, w)


@lru_cache(maxsize=1024)
def card_counts(M: int, N: int, K: int, dtype: torch.dtype, ta: bool,
                tb: bool, grid_g: int, device: torch.device) -> torch.Tensor:
    """`card_geometry`'s contributor counts as an int32 tensor on the
    card, copied there once per (device, geometry)."""
    geo = card_geometry(M, N, K, dtype, ta, tb, grid_g, device)
    return torch.from_numpy(geo.counts).to(device)


def gemm_dims(a: torch.Tensor, b: torch.Tensor, ta: bool, tb: bool
              ) -> tuple[int, int, int]:
    """``(M, N, K)`` of op(a) @ op(b); raises unless both are 2-D with
    matching inner dims."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"GEMM takes 2-D operands, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    K, M = a.shape if ta else a.shape[::-1]
    N, Kb = b.shape if tb else b.shape[::-1]
    if K != Kb:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} (ta={ta}) and "
                         f"{tuple(b.shape)} (tb={tb})")
    return M, N, K


# ----------------------------------------------------------------- checks
def check_operands(*tensors: torch.Tensor, what: str = "kernel"
                   ) -> torch.dtype:
    """Raise unless every tensor is a contiguous CUDA tensor of one
    supported dtype on one device; returns the dtype."""
    t0 = tensors[0]
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: the CUDA kernel needs CUDA tensors, "
                             f"got {t.device}")
        if t.device != t0.device:
            raise ValueError(f"{what}: operands on {t.device} and {t0.device}")
        if t.dtype != t0.dtype:
            raise ValueError(f"{what}: operand dtypes differ: {t.dtype} vs "
                             f"{t0.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous operands")
    if t0.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: unsupported dtype {t0.dtype}; the kernel "
                         "takes bfloat16 or float32")
    return t0.dtype


def output(out, shape, dtype, device, what: str) -> torch.Tensor:
    """``out`` checked against the shape, dtype and device a launch
    writes, or a new tensor of them."""
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be contiguous {dtype} of shape "
                         f"{tuple(shape)} on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -------------------------------------------------------------- launchers
def matmul(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
           tb: bool = False, bm: int = 16, out=None) -> torch.Tensor:
    """C[M,N] = op(a) @ op(b) on the card, f32 accumulation, output in the
    operands' dtype.  ``a`` is (M,K), or (K,M) when ``ta``; ``b`` is
    (K,N), or (N,K) when ``tb``.  ``bm`` is the `TileConfig` row block
    (`cta_rows` maps it to the CTA tile)."""
    dtype = check_operands(a, b, what="matmul")
    M, N, K = gemm_dims(a, b, ta, tb)
    rows = cta_rows(bm)
    if -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid ({MAX_GRID_Y} row tiles)")
    c = output(out, (M, N), dtype, a.device, "matmul")
    if c.numel() == 0:
        return c
    lib = _build.load("gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                DTYPE_CODES[dtype], int(ta), int(tb), rows,
                                M, N, K, _stream(a.device))
    raise_on_error(lib, code, "matmul")
    matmul.launches += 1
    return c


def splitk_partials(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                    tb: bool = False, bm: int = 16, split: int, slice_k: int,
                    out=None) -> torch.Tensor:
    """P[s] = op(a)[:, Ks] @ op(b)[Ks, :] in f32 on the card, for the K
    slices Ks = [s·slice_k, (s+1)·slice_k) ∩ [0, K), s < split (a slice
    past K stores zeros).  Returns P, (split, M, N) float32."""
    dtype = check_operands(a, b, what="splitk_partials")
    M, N, K = gemm_dims(a, b, ta, tb)
    rows = cta_rows(bm)
    if split < 1 or slice_k < 1:
        raise ValueError(f"split={split} and slice_k={slice_k} must be ≥ 1")
    if -(-M // rows) > MAX_GRID_Y or split > MAX_GRID_Y:
        raise ValueError(f"M={M}, split={split} exceed the kernel's grid")
    p = output(out, (split, M, N), torch.float32, a.device, "splitk_partials")
    if p.numel() == 0:
        return p
    lib = _build.load("gemm_split_k", _SPLIT_K_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_splitk_matmul(a.data_ptr(), b.data_ptr(), p.data_ptr(),
                                       DTYPE_CODES[dtype], int(ta), int(tb), rows,
                                       M, N, K, split, slice_k, _stream(a.device))
    raise_on_error(lib, code, "splitk_partials")
    splitk_partials.launches += 1
    return p


def splitk_reduce(partials: torch.Tensor, dtype: torch.dtype, *, out=None
                  ) -> torch.Tensor:
    """C = Σ_s partials[s] in slot order, cast to ``dtype``: (split, M, N)
    float32 → (M, N)."""
    check_operands(partials, what="splitk_reduce")
    if partials.dim() != 3 or partials.dtype != torch.float32:
        raise ValueError(f"splitk_reduce takes (split, M, N) float32, got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"splitk_reduce: unsupported output dtype {dtype}")
    split, M, N = partials.shape
    c = output(out, (M, N), dtype, partials.device, "splitk_reduce")
    if c.numel() == 0:
        return c
    lib = _build.load("gemm_split_k", _SPLIT_K_SIGNATURES)
    with torch.cuda.device(partials.device):
        code = lib.repro_splitk_reduce(partials.data_ptr(), c.data_ptr(),
                                       DTYPE_CODES[dtype], split, M * N,
                                       _stream(partials.device))
    raise_on_error(lib, code, "splitk_reduce")
    splitk_reduce.launches += 1
    return c


def stream_k_partials(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                      tb: bool = False, grid_g: int, out=None) -> torch.Tensor:
    """The Stream-K walk on the card for a tile of ``grid_g`` planner
    workgroups: W = `card_geometry(...).workgroups` workgroups deal the
    tile-major MAC iterations of the card's CTA tiles into equal spans;
    each stores one f32 partial per tile it touches, at slot
    g − first_contributor(tile).  Returns P, (slots, M, N) float32; the
    slots of a tile past its contributor count are left unwritten."""
    dtype = check_operands(a, b, what="stream_k_partials")
    M, N, K = gemm_dims(a, b, ta, tb)
    geo = card_geometry(M, N, K, dtype, ta, tb, grid_g, a.device)
    if geo.total >= 2 ** 31:
        raise ValueError(f"stream_k_partials: {geo.total} MAC iterations exceed "
                         "the kernel's 32-bit walk")
    p = output(out, (geo.slots, M, N), torch.float32, a.device,
               "stream_k_partials")
    lib = _build.load("gemm_stream_k", _STREAM_K_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_stream_k_matmul(
            a.data_ptr(), b.data_ptr(), p.data_ptr(), DTYPE_CODES[dtype],
            int(ta), int(tb), geo.rows, M, N, K, geo.tn, geo.tk, geo.total,
            geo.ipw, geo.live, _stream(a.device))
    raise_on_error(lib, code, "stream_k_partials")
    stream_k_partials.launches += 1
    return p


def stream_k_fixup(counts: torch.Tensor, partials: torch.Tensor, *, bm: int,
                   bn: int, dtype: torch.dtype, out=None) -> torch.Tensor:
    """Per element of tile (i, j) of bm×bn, the sum of the first
    ``counts[i, j]`` slots of ``partials`` (slots, M, N) float32 in slot
    order, cast to ``dtype``.  ``counts`` is (tm, tn) int32 on the
    partials' device; on the kernels' path bm×bn is the walk's CTA tile
    (`card_geometry`)."""
    check_operands(partials, what="stream_k_fixup")
    if partials.dim() != 3 or partials.dtype != torch.float32:
        raise ValueError(f"stream_k_fixup takes (slots, M, N) float32, got "
                         f"{partials.dtype} {tuple(partials.shape)}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"stream_k_fixup: unsupported output dtype {dtype}")
    slots, M, N = partials.shape
    tm, tn = -(-M // bm), -(-N // bn)
    if (counts.device != partials.device or counts.dtype != torch.int32
            or tuple(counts.shape) != (tm, tn) or not counts.is_contiguous()):
        raise ValueError(f"stream_k_fixup: counts must be contiguous int32 of "
                         f"shape ({tm}, {tn}) on {partials.device}")
    c = output(out, (M, N), dtype, partials.device, "stream_k_fixup")
    if c.numel() == 0:
        return c
    lib = _build.load("gemm_stream_k", _STREAM_K_SIGNATURES)
    with torch.cuda.device(partials.device):
        code = lib.repro_stream_k_fixup(counts.data_ptr(), partials.data_ptr(),
                                        c.data_ptr(), DTYPE_CODES[dtype], M, N,
                                        bm, bn, tn, _stream(partials.device))
    raise_on_error(lib, code, "stream_k_fixup")
    stream_k_fixup.launches += 1
    return c


LAUNCHERS = (matmul, splitk_partials, splitk_reduce, stream_k_partials,
             stream_k_fixup)
for _fn in LAUNCHERS:
    _fn.launches = 0
