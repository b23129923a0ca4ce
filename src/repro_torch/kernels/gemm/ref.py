"""Plain PyTorch versions of the GEMM kernels (f32 accumulation, output
cast once to ``out_dtype``, by default the operands' dtype) —
`repro/kernels/gemm/ref.py`.

Beside `gemm_ref` (the un-split kernel) each kernel of the split-K and
Stream-K decompositions has its own plain version computing the same
function, so the CPU path runs the decomposition the card runs and
`chip_smoke.py` can hold each kernel to its own plain version:
`splitk_partials_ref`/`splitk_reduce_ref` for `splitk_matmul`, and
`stream_k_partials_ref`/`stream_k_fixup_ref` for the reference's
Stream-K pair, which `stream_k_matmul_ref` composes in the order the
card's one-launch `stream_k_matmul` sums (runs of `fixup_runs`).
Partials sum their k blocks of ``bk`` in K order, as the reference's
sequential k grid does.

The Stream-K versions take their geometry explicitly: tiles of bm×bn, k
blocks of bk and ``grid_g`` workgroups.  The CPU path of `ops.gemm`
passes the planner's `TileConfig` and G (what the JAX package computes);
`chip_smoke.py` passes the card's walk (`kernel.card_geometry`: CTA
tiles, the CTA's k step and W) to hold the kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.kernel import (
    fixup_runs,
    gemm_dims,
    stream_k_geometry,
    stream_k_tiles,
)


def gemm_ref(a, b, *, ta: bool = False, tb: bool = False, out_dtype=None):
    a_ = a.T if ta else a
    b_ = b.T if tb else b
    return torch.matmul(a_.float(), b_.float()).to(out_dtype or a.dtype)


def _k_blocks(A, B, lo: int, hi: int, bk: int) -> torch.Tensor:
    """Σ over the k blocks of [lo, hi), in K order, of A[:, blk] @ B[blk]
    in f32 (zeros for an empty range)."""
    acc = A.new_zeros((A.shape[0], B.shape[1]))
    for k in range(lo, hi, bk):
        e = min(k + bk, hi)
        acc += A[:, k:e] @ B[k:e]
    return acc


def splitk_partials_ref(a, b, *, ta: bool = False, tb: bool = False,
                        split: int, slice_k: int, bk: int) -> torch.Tensor:
    """(split, M, N) f32: slice s is op(a)[:, Ks] @ op(b)[Ks, :] over
    Ks = [s·slice_k, (s+1)·slice_k) ∩ [0, K) — zeros when Ks is empty."""
    M, N, K = gemm_dims(a, b, ta, tb)
    A = (a.T if ta else a).float()
    B = (b.T if tb else b).float()
    out = A.new_empty((split, M, N))
    for s in range(split):
        lo = min(s * slice_k, K)
        out[s] = _k_blocks(A, B, lo, min(lo + slice_k, K), bk)
    return out


def splitk_reduce_ref(partials, dtype) -> torch.Tensor:
    """Σ_s partials[s] in slot order, cast once to ``dtype``."""
    acc = torch.zeros_like(partials[0])
    for p in partials:
        acc += p
    return acc.to(dtype)


def stream_k_partials_ref(a, b, *, ta: bool = False, tb: bool = False,
                          bm: int, bn: int, bk: int, grid_g: int
                          ) -> torch.Tensor:
    """(slots, M, N) f32: per bm×bn output tile q and each of the
    ``grid_g`` workgroups g that walks part of it, the sum of its
    iterations' bk-block products at slot g − first_contributor(q).  Slots past a tile's count hold zeros (the
    kernel leaves them unwritten; the fixup never reads them)."""
    M, N, K = gemm_dims(a, b, ta, tb)
    if M == 0 or N == 0 or K == 0:
        raise ValueError(f"stream_k_partials: empty GEMM {M}x{N}x{K}")
    A = (a.T if ta else a).float()
    B = (b.T if tb else b).float()
    tm, tn, tk = stream_k_tiles(M, N, K, bm, bn, bk)
    total, ipw, _, _, slots = stream_k_geometry(tm, tn, tk, grid_g)
    out = A.new_zeros((slots, M, N))
    for q in range(tm * tn):
        i, j = divmod(q, tn)
        rows, cols = slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn)
        g_first, g_last = (q * tk) // ipw, ((q + 1) * tk - 1) // ipw
        for g in range(g_first, g_last + 1):
            lo = max(q * tk, g * ipw) - q * tk
            hi = min((q + 1) * tk, (g + 1) * ipw) - q * tk
            out[g - g_first, rows, cols] = _k_blocks(
                A[rows], B[:, cols], lo * bk, min(hi * bk, K), bk)
    return out


def element_counts(counts: torch.Tensor, M: int, N: int, bm: int, bn: int
                   ) -> torch.Tensor:
    """(M, N): each element's tile contributor count."""
    rows = torch.arange(M, device=counts.device) // bm
    cols = torch.arange(N, device=counts.device) // bn
    return counts[rows[:, None], cols[None, :]]


def stream_k_fixup_ref(counts, partials, *, bm: int, bn: int, dtype,
                       runs=None) -> torch.Tensor:
    """Per element of tile (i, j), the sum of the first n = ``counts[i,
    j]`` slots, cast once to ``dtype``: in slot order (``runs=None``, the
    reference's fixup), or in two levels (``runs``: n → R, e.g.
    `fixup_runs`): the slots in runs of R, each run summed in slot order,
    then the runs' sums in run order, each sum from 0."""
    _, M, N = partials.shape
    if runs is None:
        cnt = element_counts(counts.to(partials.device), M, N, bm, bn)
        acc = torch.zeros_like(partials[0])
        for s, p in enumerate(partials):
            acc += torch.where(cnt > s, p, 0.0)
        return acc.to(dtype)
    out = torch.zeros_like(partials[0])
    tm, tn = counts.shape
    for i in range(tm):
        for j in range(tn):
            rows, cols = slice(i * bm, (i + 1) * bm), slice(j * bn, (j + 1) * bn)
            n = int(counts[i, j])
            r_len = runs(n)
            for lo in range(0, n, r_len):
                run = torch.zeros_like(out[rows, cols])
                for s in range(lo, min(lo + r_len, n)):
                    run += partials[s, rows, cols]
                out[rows, cols] += run
    return out.to(dtype)


def _stream_k(a, b, *, bm: int, bn: int, bk: int, grid_g: int, ta: bool, tb: bool,
              out_dtype, runs) -> torch.Tensor:
    M, N, K = gemm_dims(a, b, ta, tb)
    tm, tn, tk = stream_k_tiles(M, N, K, bm, bn, bk)
    counts = torch.from_numpy(stream_k_geometry(tm, tn, tk, grid_g)[3])
    p = stream_k_partials_ref(a, b, ta=ta, tb=tb, bm=bm, bn=bn, bk=bk,
                              grid_g=grid_g)
    return stream_k_fixup_ref(counts, p, bm=bm, bn=bn, dtype=out_dtype or a.dtype,
                              runs=runs)


def gemm_stream_k_ref(a, b, *, bm: int, bn: int, bk: int, grid_g: int,
                      ta: bool = False, tb: bool = False, out_dtype=None
                      ) -> torch.Tensor:
    """The Stream-K decomposition end to end (`repro/kernels/gemm/ref.py:
    16-58`): per output tile, each contributing workgroup's span sums its
    block products in K order into an f32 partial, and the partials sum
    in slot order."""
    return _stream_k(a, b, bm=bm, bn=bn, bk=bk, grid_g=grid_g, ta=ta, tb=tb,
                     out_dtype=out_dtype, runs=None)


def stream_k_matmul_ref(a, b, *, bm: int, bn: int, bk: int, grid_g: int,
                        ta: bool = False, tb: bool = False, out_dtype=None
                        ) -> torch.Tensor:
    """What `stream_k_matmul` computes at the walk of bm×bn tiles, k blocks
    of bk and ``grid_g`` workgroups (on the card: `card_geometry`'s CTA
    tiles, k step and W): the plain walk's partials, summed per tile in
    runs of `fixup_runs` — each run in workgroup order, then the runs in
    run order — and cast once."""
    return _stream_k(a, b, bm=bm, bn=bn, bk=bk, grid_g=grid_g, ta=ta, tb=tb,
                     out_dtype=out_dtype, runs=fixup_runs)
