"""Plain PyTorch versions of the grouped and ragged GEMM kernels (f32
accumulation, output cast once to the operands' dtype) —
`repro/kernels/grouped_gemm/ref.py`."""
from __future__ import annotations

import torch


def grouped_gemm_ref(a, b):
    """(G,M,K) x (G,K,N) -> (G,M,N)."""
    return torch.bmm(a.float(), b.float()).to(a.dtype)


def ragged_gemm_ref(a, b, group_sizes):
    """Rows of ``a`` (Mtotal, K) belong to groups of ``group_sizes`` (G,)
    in order; each group multiplies its own ``b[g]`` (K, N).  Rows past
    the last group's end belong to the last group (the reference clamps
    the group id to G-1).  One product per group: the reference's
    per-row gather of ``b`` would copy a (K, N) weight per row."""
    G = b.shape[0]
    sizes = torch.as_tensor(group_sizes).tolist()
    out = torch.empty((a.shape[0], b.shape[2]), dtype=a.dtype, device=a.device)
    lo = 0
    for g in range(G):
        hi = a.shape[0] if g == G - 1 else min(lo + sizes[g], a.shape[0])
        if hi > lo:
            out[lo:hi] = torch.matmul(a[lo:hi].float(), b[g].float()).to(a.dtype)
        lo = hi
    return out
