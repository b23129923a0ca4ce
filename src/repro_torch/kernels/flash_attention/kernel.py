"""Launchers of the flash-attention CUDA kernels (`csrc/flash_attention.cu`),
which replace the TPU kernel `repro/kernels/flash_attention/kernel.py:23
_flash_kernel`.

The kernel splits the kv range over CTAs (`kv_splits`, from the shape,
the card's SM count and the kernel's occupancy); each CTA writes its
rows' f32 softmax state (m, l, acc) for its split, and the last CTA of
each row group merges the splits in split order into the output.  With
one split the kernel writes the output itself.  It reads q, k and v
through their strides (each tensor's last dim contiguous), so the
launcher pads and copies nothing; dv may differ from dqk.  The launcher
takes CUDA tensors only (the CPU path is `ref.flash_ref`, chosen by
`ops.flash_attention` from the tensors' device), writes into ``out``
(`AttentionBuffers`) when given, and adds one to
``flash_attention_fwd.launches`` per launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import DTYPE_CODES, output, raise_on_error

_LL, _P, _I, _F = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_flash_attention": (_I, (_P,) * 7 + (_I, _I) + (_LL,) * 16
                              + (_I, _LL, _LL, _F, _LL, _LL, _LL, _LL, _P)),
    "repro_flash_occupancy": (_I, (_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I))),
    "repro_flash_tma": (_I, (_P,) + (_LL,) * 7),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
WIDTHS = (64, 128, 256)        # compiled head-dim capacities
MAX_GRID_Y = 65535
CTA_ROWS = 16                  # query rows of a CTA (GQA heads × positions)
KV_TILE = 64                   # keys of one pipeline stage
MIN_SPLIT_KEYS = 256           # a split fills the 4-stage ring
MAX_SPLITS = 64                # `csrc/flash_attention.cu:kMaxSplits`


class AttentionBuffers(NamedTuple):
    """Every tensor one attention launch writes: the output (B, Hq, T, Dv)
    in q's dtype and, when the kv range is split, the f32 partials
    (splits, B, Hq, T, Dv), their (m, l) (splits, B, Hq, T, 2) and the
    row groups' arrival counters (B, Hq, T) int32, zero between
    launches (the last CTA of a group resets its counter)."""

    out: torch.Tensor
    part_acc: Optional[torch.Tensor] = None
    part_ml: Optional[torch.Tensor] = None
    counter: Optional[torch.Tensor] = None


def kv_splits(B: int, Hkv: int, rep: int, T: int, S: int, slots: int
              ) -> tuple[int, int]:
    """``(splits, split_len)``: the kv range cut into splits of
    ``split_len`` keys (a multiple of `KV_TILE`) so that the grid fits in
    one wave of the card's ``slots`` resident CTAs (SMs × the kernel's
    occupancy): the CTAs before splitting, one per (batch, kv head) and
    16 of the rep·T query rows, times the splits, with no split under
    `MIN_SPLIT_KEYS` keys and at most `MAX_SPLITS`.  Qwen3-14B's decode
    member on 132 SMs at 1 CTA each: no split at batch 16 (128 CTAs),
    16 splits of 256 keys at batch 1."""
    base = B * Hkv * -(-(rep * T) // CTA_ROWS)
    n = max(1, min(slots // max(1, base), S // MIN_SPLIT_KEYS, MAX_SPLITS))
    per_split = -(-S // n)
    split_len = max(KV_TILE, -(-per_split // KV_TILE) * KV_TILE)
    return max(1, -(-S // split_len)), split_len


@lru_cache(maxsize=None)
def kernel_resources(device: torch.device, dtype: torch.dtype, dmax: int
                     ) -> tuple[int, int]:
    """``(ctas_per_sm, smem_bytes)`` of the kernel instantiation: the CTAs
    that fit on one SM at once (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)
    and one CTA's shared memory."""
    lib = _build.load("flash_attention", _SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_flash_occupancy(DTYPE_CODES[dtype], dmax,
                                         ctypes.byref(blocks), ctypes.byref(smem))
    raise_on_error(lib, code, "flash_attention occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the attention kernel ({dtype}, head dims ≤ {dmax}) "
                           "fits no CTA on an SM")
    return blocks.value, smem.value


def resident_slots(device: torch.device, dtype: torch.dtype, dmax: int) -> int:
    """SMs × CTAs of the kernel instantiation resident on each."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * kernel_resources(device, dtype, dmax)[0]


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


def split_geometry(q, k, v) -> tuple[int, int]:
    """`kv_splits` for these operands on their card."""
    B, Hq, Hkv, T, S, D, Dv = attention_shapes(q, k, v)
    slots = resident_slots(q.device, q.dtype, width_for(D, Dv))
    return kv_splits(B, Hkv, Hq // Hkv, T, S, slots)


def tma_loads(k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the bf16 kernel reads these K and V caches by TMA boxes (a
    16-byte aligned base and strides), not through its producer warp's
    registers."""
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(k.device):
        return all(lib.repro_flash_tma(t.data_ptr(), t.shape[3], t.shape[2],
                                       t.shape[1], t.shape[0], t.stride(2),
                                       t.stride(1), t.stride(0)) == 1
                   for t in (k, v))


def attention_buffers(q, k, v) -> AttentionBuffers:
    """Allocate, on the current stream, what an attention launch writes:
    the output and, on the card when the kv range is split, the split
    partials.  On the CPU (the plain version) only the output."""
    B, Hq, Hkv, T, S, D, Dv = attention_shapes(q, k, v)
    out = torch.empty((B, Hq, T, Dv), dtype=q.dtype, device=q.device)
    if q.device.type != "cuda":
        return AttentionBuffers(out)
    splits, _ = split_geometry(q, k, v)
    if splits == 1:
        return AttentionBuffers(out)
    f32 = dict(dtype=torch.float32, device=q.device)
    return AttentionBuffers(out, torch.empty((splits, B, Hq, T, Dv), **f32),
                            torch.empty((splits, B, Hq, T, 2), **f32),
                            torch.zeros((B, Hq, T), dtype=torch.int32,
                                        device=q.device))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0,
                        bq: int = 128, bkv: int = 128,
                        out: AttentionBuffers | None = None) -> torch.Tensor:
    """Attention on the card: q (B,Hq,T,D), k (B,Hkv,S,D), v (B,Hkv,S,Dv)
    in bf16 or f32; returns (B,Hq,T,Dv) in q's dtype.  ``bq`` is the q
    block and ``bkv`` the kv block whose fully masked blocks are skipped,
    as in the TPU kernel.  ``out`` (`attention_buffers`) receives the
    output and the split partials; its counter must be zero (as
    `attention_buffers` makes it and every launch leaves it)."""
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
    if max(B * Hkv, T, S, S + abs(q_offset), T + abs(q_offset)) >= 2 ** 31:
        raise ValueError("flash_attention_fwd: positions beyond the kernel's "
                         "32-bit range")
    splits, split_len = split_geometry(q, k, v)
    row_tiles = -(-(Hq // Hkv * min(bq, T)) // CTA_ROWS)
    if -(-T // bq) > MAX_GRID_Y or row_tiles * splits > MAX_GRID_Y:
        raise ValueError(f"T={T} at bq={bq} with {splits} kv splits exceeds the "
                         "kernel's grid")
    dmax = width_for(D, Dv)
    bufs = out if out is not None else attention_buffers(q, k, v)
    o = output(bufs.out, (B, Hq, T, Dv), q.dtype, q.device, "flash_attention_fwd")
    if o.numel() == 0:
        return o
    part_acc = part_ml = counter = None
    if splits > 1:
        part_acc = output(bufs.part_acc, (splits, B, Hq, T, Dv), torch.float32,
                          q.device, "flash_attention_fwd partials")
        part_ml = output(bufs.part_ml, (splits, B, Hq, T, 2), torch.float32,
                         q.device, "flash_attention_fwd partials")
        counter = bufs.counter
        if counter is None:
            counter = torch.zeros((B, Hq, T), dtype=torch.int32, device=q.device)
        output(counter, (B, Hq, T), torch.int32, q.device,
               "flash_attention_fwd counter")
    scale = scale if scale is not None else D ** -0.5
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            part_acc.data_ptr() if splits > 1 else None,
            part_ml.data_ptr() if splits > 1 else None,
            counter.data_ptr() if splits > 1 else None,
            DTYPE_CODES[q.dtype], dmax, B, Hq, Hkv, T, S, D, Dv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], int(causal),
            int(window), int(q_offset), float(scale), int(bq), int(bkv),
            splits, split_len, torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_error(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o


flash_attention_fwd.launches = 0
