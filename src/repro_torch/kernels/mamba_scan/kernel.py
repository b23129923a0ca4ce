"""Launcher of the chunked SSD-scan CUDA kernel (`csrc/mamba_scan.cu`),
which replaces the TPU kernel `repro/kernels/mamba_scan/kernel.py:24
_mamba_kernel`.

The kernel reads xd (B,T,H,P), da (B,T,H) and B/C (B,T,H,N) through
their strides, in bf16 or f32, so the launcher transposes, pads and
copies nothing: a Mamba2 group-shared B/C may be a broadcast view.  It
takes CUDA tensors only (the CPU path is `ref.ssd_chunk_ref`, chosen by
`ops.ssd_scan` from the tensors' device), writes into ``out`` when given,
and adds one to ``mamba_scan_fwd.launches`` per launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import DTYPE_CODES, output, raise_on_error

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_mamba_scan": (_I, (_P,) * 7 + (_I,) + (_LL,) * 18 + (_P,)),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
MAX_DIM = 128      # N and P capacity (`csrc/mamba_scan.cu:kMaxDim`)
MAX_CHUNK = 512


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


def mamba_scan_fwd(xd: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, *, chunk: int = 128,
                   initial_state: torch.Tensor | None = None,
                   out=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked scan on the card.  Returns y (B,T,H,P) in xd's dtype and
    the final state (B,H,N,P) float32; ``initial_state`` (B,H,N,P) is
    read as f32 (zeros when None).  ``out`` is a ``(y, state)`` pair from
    `ops.scan_buffers`."""
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
    if not (1 <= N <= MAX_DIM and 1 <= P <= MAX_DIM):
        raise ValueError(f"N={N} and P={P} must lie in [1, {MAX_DIM}]")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} must lie in [1, {MAX_CHUNK}]")
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
        code = lib.repro_mamba_scan(
            xd.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if s0 is None else s0.data_ptr(), y.data_ptr(), sf.data_ptr(),
            DTYPE_CODES[xd.dtype], B, T, H, P, N, int(chunk),
            xd.stride(0), xd.stride(1), xd.stride(2),
            da.stride(0), da.stride(1), da.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            Cm.stride(0), Cm.stride(1), Cm.stride(2),
            torch.cuda.current_stream(xd.device).cuda_stream)
    raise_on_error(lib, code, "mamba_scan_fwd")
    mamba_scan_fwd.launches += 1
    return y, sf


mamba_scan_fwd.launches = 0
