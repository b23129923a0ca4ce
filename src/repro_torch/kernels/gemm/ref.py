"""Plain PyTorch version of the GEMM kernel (f32 accumulation, output cast
once to the operands' dtype) — `repro/kernels/gemm/ref.py:gemm_ref`."""
from __future__ import annotations

import torch


def gemm_ref(a, b, *, ta: bool = False, tb: bool = False):
    a_ = a.T if ta else a
    b_ = b.T if tb else b
    return torch.matmul(a_.float(), b_.float()).to(a.dtype)
