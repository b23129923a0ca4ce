"""Launchers of the flash-attention CUDA kernels, which replace the TPU
kernel `repro/kernels/flash_attention/kernel.py:23 _flash_kernel`.

Two hand-written routes compute attention, chosen by shape alone
(`attention_route`, the one place that decides):

- ``"prefill"`` (`csrc/flash_prefill.cu`): bf16 operands, at least
  `PREFILL_MIN_T` query positions and head dims an instantiation of
  `PREFILL_WIDTHS` holds.  A CTA takes 128 query positions of one q head
  on two 64-row `wgmma` warpgroups, K and V come by TMA boxes over the
  operands' strides (16-byte aligned, or the launch raises), and nothing
  is split: no partials, no merge.  `prefill_tiles` mirrors its walk.
- ``"decode"`` (`csrc/flash_attention.cu`): everything else, f32 inputs
  included.  The kernel splits the kv range over CTAs (`kv_splits`, from
  the shape, the card's SM count and the kernel's occupancy); each CTA
  writes its rows' f32 softmax state (m, l, acc) for its split, and the
  last CTA of each row group merges the splits in split order into the
  output.  With one split the kernel writes the output itself.

Both read q, k and v through their strides (each tensor's last dim
contiguous), so the launcher pads and copies nothing; dv may differ from
dqk.  The launcher takes CUDA tensors only (the CPU path is
`ref.flash_ref`, chosen by `ops.flash_attention` from the tensors'
device), writes into ``out`` (`AttentionBuffers`) when given, and adds
one to ``flash_attention_fwd.launches`` and to
``flash_attention_fwd.routes[route]`` per launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import DTYPE_CODES, output, raise_on_error, refuse_grad

_LL, _P, _I, _F = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "repro_flash_attention": (_I, (_P,) * 7 + (_I, _I) + (_LL,) * 16
                              + (_I, _LL, _LL, _F, _LL, _LL, _LL, _LL, _P)),
    "repro_flash_occupancy": (_I, (_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I))),
    "repro_flash_tma": (_I, (_P,) + (_LL,) * 7),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
_PREFILL_SIGNATURES = {
    "repro_flash_prefill": (_I, (_P,) * 4 + (_I, _I) + (_LL,) * 16
                            + (_I, _LL, _LL, _F, _P)),
    "repro_flash_prefill_occupancy": (_I, (_I, _I, ctypes.POINTER(_I),
                                           ctypes.POINTER(_I))),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
ROUTES = ("decode", "prefill")
WIDTHS = (64, 128, 256)        # compiled head-dim capacities
MAX_GRID_Y = 65535
CTA_ROWS = 16                  # query rows of a CTA (GQA heads × positions)
KV_TILE = 64                   # keys of one pipeline stage
MIN_SPLIT_KEYS = 256           # a split fills the 4-stage ring
MAX_SPLITS = 64                # `csrc/flash_attention.cu:kMaxSplits`
# The prefill route (`csrc/flash_prefill.cu`).
PREFILL_MIN_T = 32             # query positions: PERF.md times both routes at T 16-128
PREFILL_WIDTHS = ((64, 64), (128, 128), (192, 128))   # instantiated (D, Dv) capacities
PREFILL_ROWS = 128             # query positions of a CTA: two warpgroups
PREFILL_WG_ROWS = 64           # rows of one warpgroup: wgmma's M
PREFILL_KV_TILE = 64           # keys of a K/V tile


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


def prefill_width(D: int, Dv: int) -> tuple[int, int] | None:
    """The smallest instantiation of `PREFILL_WIDTHS` holding head dims
    (D, Dv), or None when none does."""
    return next(((dq, dv) for dq, dv in PREFILL_WIDTHS if D <= dq and Dv <= dv), None)


def attention_route(q, k, v) -> str:
    """Which kernel an attention launch of these operands takes:
    ``"prefill"`` (`csrc/flash_prefill.cu`) for bf16 operands with at
    least `PREFILL_MIN_T` query positions and head dims, multiples of 8
    (16-byte rows), that an instantiation of `PREFILL_WIDTHS` holds;
    ``"decode"`` (`csrc/flash_attention.cu`) for everything else.  Decided
    from the shapes and the dtype before the launch; nothing overrides it,
    and a launch the prefill kernel refuses raises rather than taking the
    other route."""
    B, Hq, Hkv, T, S, D, Dv = attention_shapes(q, k, v)
    if (q.dtype == torch.bfloat16 and T >= PREFILL_MIN_T and D % 8 == 0
            and Dv % 8 == 0 and prefill_width(D, Dv) is not None):
        return "prefill"
    return "decode"


def attention_splits(q, k, v) -> tuple[int, int]:
    """``(splits, split_len)`` of a launch of these operands on their
    card: `split_geometry` on the decode route; one split of the whole kv
    range on the prefill route, which splits nothing."""
    if attention_route(q, k, v) == "prefill":
        return 1, k.shape[2]
    return split_geometry(q, k, v)


class PrefillTile(NamedTuple):
    """A K/V tile a prefill CTA loads: its first key and, for each of the
    CTA's two warpgroups, ``"skip"`` (no row of it sees a key of the
    tile), ``"mask"`` (the per-element test) or ``"open"`` (every key
    visible to every row)."""

    k0: int
    modes: tuple[str, str]


def _prefill_walk(S: int, qlo: int, qhi: int, causal: bool, window: int
                  ) -> tuple[int, int]:
    """``(lo, n)``: the tiles [lo, lo + n·PREFILL_KV_TILE) of rows at
    positions [qlo, qhi], from the first key the first row sees (window) to
    the last the last row sees (causal), S cut
    (`csrc/flash_prefill.cu:walk`)."""
    kt = PREFILL_KV_TILE
    lo, hi = 0, S
    if causal:
        hi = min(hi, max(qhi + 1, 0))
    if window:
        first = qlo - window + 1
        lo = first // kt * kt if first > 0 else 0
    return lo, -(-(hi - lo) // kt) if hi > lo else 0


def _prefill_mode(S: int, k0: int, rows: int, qlo: int, qhi: int, causal: bool,
                  window: int) -> str:
    """`csrc/flash_prefill.cu:tile_mode` for a warpgroup of ``rows`` real
    rows at positions [qlo, qhi]."""
    kt = PREFILL_KV_TILE
    if (rows <= 0 or (causal and k0 > qhi)
            or (window and k0 + kt - 1 <= qlo - window)):
        return "skip"
    if (k0 + kt <= S and (not causal or k0 + kt - 1 <= qlo)
            and (not window or qhi - k0 < window)):
        return "open"
    return "mask"


def prefill_tiles(T: int, S: int, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> list[tuple[int, list[PrefillTile]]]:
    """The prefill kernel's walk: for each block of `PREFILL_ROWS` query
    positions (q0, in q order; the card launches them last first), the
    `PREFILL_KV_TILE`-key tiles it loads, in order, each with what its two
    warpgroups of `PREFILL_WG_ROWS` rows do with it."""
    blocks = []
    for q0 in range(0, T, PREFILL_ROWS):
        nq = min(PREFILL_ROWS, T - q0)
        lo, n = _prefill_walk(S, q0 + q_offset, q0 + nq - 1 + q_offset, causal, window)
        wgs = []
        for wg in range(PREFILL_ROWS // PREFILL_WG_ROWS):
            rows = min(max(nq - wg * PREFILL_WG_ROWS, 0), PREFILL_WG_ROWS)
            qlo = q0 + wg * PREFILL_WG_ROWS + q_offset
            wgs.append((rows, qlo, qlo + rows - 1))
        blocks.append((q0, [PrefillTile(k0, tuple(_prefill_mode(S, k0, *wg, causal, window)
                                                  for wg in wgs))
                            for k0 in range(lo, lo + n * PREFILL_KV_TILE,
                                            PREFILL_KV_TILE)]))
    return blocks


def prefill_grid(B: int, Hq: int, T: int) -> tuple[int, int]:
    """The prefill kernel's grid: (B·Hq, q blocks of `PREFILL_ROWS`)."""
    return B * Hq, -(-T // PREFILL_ROWS)


@lru_cache(maxsize=None)
def prefill_resources(device: torch.device, dq: int, dv: int) -> tuple[int, int]:
    """``(ctas_per_sm, smem_bytes)`` of the prefill kernel's (dq, dv)
    instantiation, as `kernel_resources` for the decode kernel."""
    lib = _build.load("flash_prefill", _PREFILL_SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_flash_prefill_occupancy(dq, dv, ctypes.byref(blocks),
                                                 ctypes.byref(smem))
    raise_on_error(lib, code, "flash_prefill occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the prefill attention kernel ({dq}/{dv}) fits no CTA "
                           "on an SM")
    return blocks.value, smem.value


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, head, row) element strides of a 4-D operand as the prefill
    kernel's tensor maps take them: a dimension of size 1 is never stepped
    over, so it gets its row length rounded up to 16 bytes in place of
    whatever stride it carries."""
    row = -(-t.shape[3] // 8) * 8
    return tuple(st if n > 1 else row for n, st in zip(t.shape[:3], t.stride()[:3]))


def attention_buffers(q, k, v) -> AttentionBuffers:
    """Allocate, on the current stream, what an attention launch writes:
    the output and, on the card when the decode route splits the kv
    range, the split partials.  On the CPU (the plain version) and on the
    prefill route only the output."""
    B, Hq, Hkv, T, S, D, Dv = attention_shapes(q, k, v)
    out = torch.empty((B, Hq, T, Dv), dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return AttentionBuffers(out)
    splits, _ = attention_splits(q, k, v)
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
    in bf16 or f32; returns (B,Hq,T,Dv) in q's dtype, from the kernel
    `attention_route` names.  ``bq`` is the q block and ``bkv`` the kv
    block whose fully masked blocks the decode route skips, as in the TPU
    kernel; on the prefill route they change no result and do not size
    the CTA, which wgmma's 64-row minimum fixes at 128 positions and 64-key
    tiles.  ``out`` (`attention_buffers`) receives the output and the
    decode route's split partials; its counter must be zero (as
    `attention_buffers` makes it and every launch leaves it)."""
    refuse_grad("flash_attention_fwd", q, k, v,
                backward="call `ops.flash_attention`, whose autograd Function "
                         "runs the backward")
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
    if max(B * Hq, T, S, S + abs(q_offset), T + abs(q_offset)) >= 2 ** 31:
        raise ValueError("flash_attention_fwd: positions beyond the kernel's "
                         "32-bit range")
    route = attention_route(q, k, v)
    scale = scale if scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "prefill":
        if -(-T // PREFILL_ROWS) > MAX_GRID_Y:
            raise ValueError(f"T={T} exceeds the prefill kernel's grid")
        if not scale > 0:
            raise ValueError(f"flash_attention_fwd: the prefill kernel takes a "
                             f"positive scale, got {scale}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st <= 0 or st % 8 for st in _tma_strides(t)):
                raise ValueError(
                    f"flash_attention_fwd: the prefill kernel reads {name} by TMA "
                    "boxes, which need a 16-byte aligned base and strides; got "
                    f"strides {tuple(t.stride())} at offset {t.data_ptr() % 16}")
        bufs = out if out is not None else AttentionBuffers(None)
        o = output(bufs.out, (B, Hq, T, Dv), q.dtype, q.device, "flash_attention_fwd")
        if o.numel() == 0:
            return o
        dq, dv = prefill_width(D, Dv)
        lib = _build.load("flash_prefill", _PREFILL_SIGNATURES)
        with torch.cuda.device(q.device):
            code = lib.repro_flash_prefill(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dq, dv,
                B, Hq, Hkv, T, S, D, Dv, *_tma_strides(q), *_tma_strides(k),
                *_tma_strides(v), int(causal), int(window), int(q_offset),
                float(scale), stream)
        raise_on_error(lib, code, "flash_attention_fwd (prefill)")
        flash_attention_fwd.launches += 1
        flash_attention_fwd.routes[route] += 1
        return o
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
            splits, split_len, stream)
    raise_on_error(lib, code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.routes[route] += 1
    return o


flash_attention_fwd.launches = 0
flash_attention_fwd.routes = dict.fromkeys(ROUTES, 0)
