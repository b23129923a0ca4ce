"""Plain PyTorch versions of the grouped and ragged GEMM kernels (f32
accumulation, output cast once to ``out_dtype``, by default the
operands' dtype) — `repro/kernels/grouped_gemm/ref.py`.

``b`` is a stacked (G, K, N) tensor or a sequence of G (K, N) weights,
as for the kernels; both forms run the same per-member products, so
they give identical results."""
from __future__ import annotations

import torch

from repro_torch.kernels.grouped_gemm.kernel import member_weights


def grouped_gemm_ref(a, b, *, out_dtype=None):
    """(G,M,K) x G (K,N) -> (G,M,N)."""
    ws = member_weights(b)
    out = torch.empty((a.shape[0], a.shape[1], ws[0].shape[1] if ws else 0),
                      dtype=out_dtype or a.dtype, device=a.device)
    for g, w in enumerate(ws):
        out[g] = torch.matmul(a[g].float(), w.float())
    return out


def ragged_gemm_ref(a, b, group_sizes, *, out_dtype=None):
    """Rows of ``a`` (Mtotal, K) belong to groups of ``group_sizes`` (G,)
    in order; each group multiplies its own ``b[g]`` (K, N).  Rows past
    the last group's end belong to the last group (the reference clamps
    the group id to G-1).  One product per group: the reference's
    per-row gather of ``b`` would copy a (K, N) weight per row."""
    ws = member_weights(b)
    G = len(ws)
    sizes = torch.as_tensor(group_sizes).tolist()
    out = torch.empty((a.shape[0], ws[0].shape[1]), dtype=out_dtype or a.dtype,
                      device=a.device)
    lo = 0
    for g in range(G):
        hi = a.shape[0] if g == G - 1 else min(lo + sizes[g], a.shape[0])
        if hi > lo:
            out[lo:hi] = torch.matmul(a[lo:hi].float(), ws[g].float())
        lo = hi
    return out
