"""Plain PyTorch versions of the GEMM kernels (f32 accumulation, output
cast once to the operands' dtype) — `repro/kernels/gemm/ref.py`.

Beside `gemm_ref` (the un-split kernel) each kernel of the split-K and
Stream-K decompositions has its own plain version computing the same
function, so the CPU path runs the decomposition the card runs and
`chip_smoke.py` can hold each kernel to its own plain version:
`splitk_partials_ref`/`splitk_reduce_ref` and
`stream_k_partials_ref`/`stream_k_fixup_ref`.  Partials sum their k
blocks of ``bk`` in K order, as the reference's sequential k grid does.

The Stream-K versions take their geometry explicitly: tiles of bm×bn, k
blocks of bk and ``grid_g`` workgroups.  The CPU path of `ops.gemm`
passes the planner's `TileConfig` and G (what the JAX package computes);
`chip_smoke.py` passes the card's walk (`kernel.card_geometry`: CTA
tiles, the CTA's k step and W) to hold the kernel to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.kernel import (
    gemm_dims,
    stream_k_geometry,
    stream_k_tiles,
)


def gemm_ref(a, b, *, ta: bool = False, tb: bool = False):
    a_ = a.T if ta else a
    b_ = b.T if tb else b
    return torch.matmul(a_.float(), b_.float()).to(a.dtype)


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


def stream_k_fixup_ref(counts, partials, *, bm: int, bn: int, dtype
                       ) -> torch.Tensor:
    """Per element of tile (i, j), the sum of the first ``counts[i, j]``
    slots in slot order, cast once to ``dtype``."""
    _, M, N = partials.shape
    cnt = element_counts(counts.to(partials.device), M, N, bm, bn)
    acc = torch.zeros_like(partials[0])
    for s, p in enumerate(partials):
        acc += torch.where(cnt > s, p, 0.0)
    return acc.to(dtype)


def gemm_stream_k_ref(a, b, *, bm: int, bn: int, bk: int, grid_g: int,
                      ta: bool = False, tb: bool = False) -> torch.Tensor:
    """The Stream-K decomposition end to end (`repro/kernels/gemm/ref.py:
    16-58`): per output tile, each contributing workgroup's span sums its
    block products in K order into an f32 partial, and the partials sum
    in slot order."""
    M, N, K = gemm_dims(a, b, ta, tb)
    tm, tn, tk = stream_k_tiles(M, N, K, bm, bn, bk)
    counts = torch.from_numpy(stream_k_geometry(tm, tn, tk, grid_g)[3])
    p = stream_k_partials_ref(a, b, ta=ta, tb=tb, bm=bm, bn=bn, bk=bk,
                              grid_g=grid_g)
    return stream_k_fixup_ref(counts, p, bm=bm, bn=bn, dtype=a.dtype)
