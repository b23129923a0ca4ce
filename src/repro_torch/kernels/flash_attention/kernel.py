"""Launcher of the flash-attention CUDA kernel (`csrc/flash_attention.cu`),
which replaces the TPU kernel `repro/kernels/flash_attention/kernel.py:23
_flash_kernel`.

The kernel reads q, k and v through their strides (each tensor's last dim
contiguous), so the launcher pads and copies nothing; dv may differ from
dqk.  It takes CUDA tensors only (the CPU path is `ref.flash_ref`, chosen
by `ops.flash_attention` from the tensors' device), writes into ``out``
when given, and adds one to ``flash_attention_fwd.launches`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import DTYPE_CODES, output, raise_on_error

_LL, _P, _I, _F = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_flash_attention": (_I, (_P, _P, _P, _P, _I, _I) + (_LL,) * 16
                              + (_I, _LL, _LL, _F, _LL, _LL, _P)),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
WIDTHS = (64, 128, 256)        # compiled head-dim capacities
MAX_GRID_Y = 65535


def width_for(D: int, Dv: int) -> int:
    """The compiled head-dim capacity a launch runs: the smallest of
    `WIDTHS` holding both head dims."""
    need = max(D, Dv)
    for w in WIDTHS:
        if need <= w:
            return w
    raise ValueError(f"head dims {D}/{Dv} exceed the kernel's {WIDTHS[-1]}")


def attention_shapes(q, k, v) -> tuple:
    """``(B, Hq, Hkv, T, S, D, Dv)``; raises on inconsistent shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention takes 4-D q (B,Hq,T,D), k and v (B,Hkv,S,D)")
    B, Hq, T, D = q.shape
    Bk, Hkv, S, Dk = k.shape
    if (Bk, Hkv, S) != tuple(v.shape[:3]) or Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    return B, Hq, Hkv, T, S, D, v.shape[3]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0,
                        bq: int = 128, bkv: int = 128, out=None) -> torch.Tensor:
    """Attention on the card: q (B,Hq,T,D), k (B,Hkv,S,D), v (B,Hkv,S,Dv)
    in bf16 or f32; returns (B,Hq,T,Dv) in q's dtype.  ``bq`` is the q
    block and ``bkv`` the kv block whose fully masked blocks are skipped,
    as in the TPU kernel."""
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError("flash_attention_fwd: the CUDA kernel needs CUDA "
                             f"tensors, got {t.device}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash_attention_fwd: q, k and v must share one "
                             "device and dtype")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError("flash_attention_fwd: the last dim of q, k and v "
                             "must be contiguous")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention_fwd: unsupported dtype {q.dtype}")
    B, Hq, Hkv, T, S, D, Dv = attention_shapes(q, k, v)
    if bq < 1 or bkv < 1:
        raise ValueError(f"bq={bq} and bkv={bkv} must be ≥ 1")
    if -(-T // bq) > MAX_GRID_Y:
        raise ValueError(f"T={T} at bq={bq} exceeds the kernel's grid")
    dmax = width_for(D, Dv)
    o = output(out, (B, Hq, T, Dv), q.dtype, q.device, "flash_attention_fwd")
    if o.numel() == 0:
        return o
    scale = scale if scale is not None else D ** -0.5
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            DTYPE_CODES[q.dtype], dmax, B, Hq, Hkv, T, S, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            int(window), int(q_offset), float(scale), int(bq), int(bkv),
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
