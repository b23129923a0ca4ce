"""Launchers of the GEMM CUDA kernels, and the geometry they share with
the plain versions.

- ``matmul`` (`csrc/gemm.cu`) replaces the TPU kernel
  `repro/kernels/gemm/kernel.py:45 _matmul_kernel` (split_k = 1).  Two
  hand-written feeds, chosen by shape (`matmul_feed`): TMA boxes into a
  swizzled ring (`matmul_ring`) for aligned bf16 operands, the
  `cp.async` ring of split-K and grouped for the rest;
- ``splitk_matmul`` (`csrc/gemm_split_k.cu`) replaces `:65
  _matmul_splitk_kernel` and, in its cluster epilogue, `:86
  _reduce_kernel`: one launch, the K slices of an output tile one
  thread-block cluster of ``split`` CTAs (at most `MAX_CLUSTER`);
- ``stream_k_matmul`` (`csrc/gemm_stream_k.cu`) replaces `:215
  _stream_k_kernel` and, in its epilogue, `:247 _stream_k_fixup_kernel`:
  one launch, whose cut tiles are summed by their last contributors to
  arrive, in runs of `fixup_runs` (no partials of (slots, M, N), no
  second launch).  The walk runs in the card's units (`card_geometry`):
  CTA tiles picked from M, and W workgroups from the planner's G, the SM
  count and the kernel's occupancy.

Every kernel is bound by bytes on the serving path (decode GEMMs stream
weights far larger than their activations); the sources say how their
design answers that.  This module takes CUDA tensors only: the CPU path
is the plain versions in `ref.py`, chosen by `ops.gemm` from the
tensors' device.  Each launcher writes into ``out`` when given (the
mixed launch allocates every buffer before it forks onto its streams),
else allocates it, and adds one to its ``launches`` count per launch.
A launch returns a tensor with no autograd history, so each launcher
refuses to run where autograd would record it (`refuse_grad`): the ops'
autograd Functions launch with grad disabled.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
CTA_COLS = 64
MAX_GRID_Y = 65535

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_ERROR = {"repro_error_string": (ctypes.c_char_p, (_I,))}
_SIGNATURES = {
    "repro_matmul": (_I, (_P, _P, _P) + (_I,) * 8 + (_LL, _LL, _LL, _P)),
    "repro_matmul_occupancy": (_I, (_I,) * 8 + (ctypes.POINTER(_I),) * 4),
    **_ERROR,
}
# `matmul`'s two feeds (`csrc/gemm.cu`), and the TMA feed's rings, one
# compiled instantiation each (`TmaRings`): (stages, consumer groups).
FEED_CODES = {"ring": 0, "tma": 1}
SHALLOW_RING, DEEP_RING = (3, 1), (8, 2)
TMA_RINGS = (SHALLOW_RING, DEEP_RING)
# The TMA unit's alignment: bases and row strides in multiples of 16 bytes.
TMA_ALIGN = 16
_SPLIT_K_SIGNATURES = {
    "repro_splitk_matmul": (_I, (_P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                                 _I, _LL, _P)),
    "repro_splitk_occupancy": (_I, (_I,) * 6 + (ctypes.POINTER(_I),) * 5),
    **_ERROR,
}
# The H100's largest thread-block cluster (non-portable above 8 CTAs):
# `splitk_matmul` runs one cluster of `split` CTAs per output tile.
MAX_CLUSTER = 16
_STREAM_K_SIGNATURES = {
    "repro_stream_k_matmul": (_I, (_P,) * 5 + (_I,) * 5 + (_LL,) * 8 + (_P,)),
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
        raise ValueError(f"stream_k_matmul: empty GEMM {M}x{N}x{K}")
    if grid_g < 1:
        raise ValueError(f"grid_g={grid_g} must be ≥ 1")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = walk_rows(M)
    w = stream_k_workgroups(grid_g, planner_g_max(), sms,
                            walk_resources(device, dtype, ta, tb, rows)[0])
    return walk_geometry(M, N, K, dtype, w)


def fixup_runs(n: int) -> int:
    """R, the run length of a cut tile's two-level sum in `stream_k_matmul`:
    ⌈√n⌉ for n contributors (1 for n ≤ 1).  The n contributors, in
    workgroup order, form runs of R; each run's last arriver sums the run,
    the last run to arrive sums the runs (`csrc/gemm_stream_k.cu:
    fixup_runs`)."""
    return math.isqrt(n - 1) + 1 if n > 1 else 1


def stream_k_workspace(live: int, rows: int, cols: int) -> tuple[int, int]:
    """``(floats, counters)``: the sizes of a Stream-K launch's f32 slots,
    two rows×cols tiles per live workgroup (the tile its span starts in
    and the tile it ends in), and of its int32 counters, a run and a tile
    counter per slot."""
    return 2 * live * rows * cols, 4 * live


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
def refuse_grad(what: str, *tensors, backward: str) -> None:
    """Raise when grad is enabled and an operand requires it: the launch's
    output would carry no ``grad_fn``, and the gradients would be lost
    without a sound.  ``backward`` names where the op's backward is (its
    autograd Function, which launches with grad disabled), or that it
    has none."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: an operand requires grad, and a launch "
                           f"records no backward; {backward}")


GEMM_BACKWARD = "call `ops.gemm`, whose autograd Function runs the backward"


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


class KernelLaunchError(RuntimeError):
    """A kernel launch (or a launcher's occupancy query) whose CUDA status
    is not 0: the one failure of the kernels themselves that the
    runtime's fallback ladder handles.  Refusals of a call (a shape, a
    split or a layout a kernel does not take) and build failures are
    other errors, which the ladder lets through."""


def raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    """The launch check of every kernel family: raise `KernelLaunchError`
    naming ``what`` unless ``code`` (a CUDA status) is 0."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise KernelLaunchError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -------------------------------------------------------------- launchers
def matmul_feed(a: torch.Tensor, b: torch.Tensor, ta: bool, tb: bool) -> str:
    """Which of `matmul`'s two feeds a launch on these dense operands
    takes: ``"tma"`` (TMA boxes) when both are bf16 and each one's base
    address and row stride (its last dim times 2 bytes) are multiples of
    16 bytes, as the TMA unit needs, and K is not empty; ``"ring"`` (the
    `cp.async` ring, which takes any dtype and alignment) otherwise —
    f32 operands, a row stride not a multiple of 8 elements (A's K, or M
    under ``ta``; B's N, or K under ``tb``), a view at an odd offset.  A
    choice by shape between two kernels, each held to `gemm_ref` on the
    card; nothing overrides it."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        return "ring"
    K = a.shape[0] if ta else a.shape[1]
    if K == 0:
        return "ring"
    for t in (a, b):
        if (t.data_ptr() % TMA_ALIGN or t.shape[1] * t.element_size() % TMA_ALIGN
                or max(t.shape) >= 2 ** 31):
            return "ring"
    return "tma"


def matmul_ring(ctas: int, sms: int) -> tuple[int, int]:
    """The TMA feed's ring, (stages, consumer groups), for a grid of
    ``ctas`` CTAs on ``sms`` SMs: shallow, 3 stages and one group, when
    the grid puts at least two CTAs on every SM, whose rings and math
    together keep the SM busy; deep, 8 stages and two groups taking the
    slabs in turn, when an SM holds one CTA or none, which has to keep
    its bytes in flight and its math up with them alone."""
    return SHALLOW_RING if ctas >= 2 * sms else DEEP_RING


@lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The device's SM count, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def matmul(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
           tb: bool = False, bm: int = 16, out_dtype=None, out=None
           ) -> torch.Tensor:
    """C[M,N] = op(a) @ op(b) on the card, f32 accumulation, output in
    ``out_dtype`` (default: the operands' dtype).  ``a`` is (M,K), or
    (K,M) when ``ta``; ``b`` is (K,N), or (N,K) when ``tb``.  ``bm`` is
    the `TileConfig` row block (`cta_rows` maps it to the CTA tile).
    The feed is `matmul_feed`'s; each launch adds one to
    ``matmul.launches`` and to ``matmul.feeds[feed]``."""
    refuse_grad("matmul", a, b, backward=GEMM_BACKWARD)
    dtype = check_operands(a, b, what="matmul")
    out_dtype = dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"matmul: unsupported output dtype {out_dtype}")
    M, N, K = gemm_dims(a, b, ta, tb)
    rows = cta_rows(bm)
    if -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid ({MAX_GRID_Y} row tiles)")
    c = output(out, (M, N), out_dtype, a.device, "matmul")
    if c.numel() == 0:
        return c
    feed = matmul_feed(a, b, ta, tb)
    ring = (matmul_ring(-(-N // CTA_COLS) * -(-M // rows), sm_count(a.device))
            if feed == "tma" else (0, 0))
    lib = _build.load("gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                int(ta), int(tb), rows, FEED_CODES[feed], *ring,
                                M, N, K, _stream(a.device))
    raise_on_error(lib, code, f"matmul ({feed} feed)")
    matmul.launches += 1
    matmul.feeds[feed] += 1
    return c


class RingResidency(NamedTuple):
    """What the card holds at once of a ring-fed kernel's instantiation:
    CTAs per SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), for
    split-K the clusters resident on the card at once
    (`cudaOccupancyMaxActiveClusters`, else None), one CTA's dynamic
    shared memory, its ring's stages and the operand bytes one stage
    brings in."""

    ctas_per_sm: int
    clusters: Optional[int]
    smem_bytes: int
    stages: int
    slab_bytes: int


@lru_cache(maxsize=None)
def matmul_residency(device: torch.device, dtype: torch.dtype,
                     out_dtype: torch.dtype, ta: bool, tb: bool, rows: int,
                     feed: str, ring: tuple = (0, 0)) -> RingResidency:
    """`RingResidency` of `matmul`'s instantiation at ``rows`` CTA rows on
    ``feed`` (``ring``: the TMA feed's, one of `TMA_RINGS`; the ring feed
    has its own)."""
    lib = _build.load("gemm", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = lib.repro_matmul_occupancy(DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                          int(ta), int(tb), rows, FEED_CODES[feed],
                                          *ring, *(ctypes.byref(x) for x in out))
    raise_on_error(lib, code, "matmul occupancy query")
    blocks, smem, ring_stages, slab = (x.value for x in out)
    return RingResidency(blocks, None, smem, ring_stages, slab)


@lru_cache(maxsize=None)
def splitk_residency(device: torch.device, dtype: torch.dtype,
                     out_dtype: torch.dtype, ta: bool, tb: bool, rows: int,
                     split: int) -> RingResidency:
    """`RingResidency` of the split-K kernel at ``rows`` CTA rows and
    clusters of ``split``."""
    lib = _build.load("gemm_split_k", _SPLIT_K_SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(5)]
    with torch.cuda.device(device):
        code = lib.repro_splitk_occupancy(DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                          int(ta), int(tb), rows, split,
                                          *(ctypes.byref(x) for x in out))
    raise_on_error(lib, code, "splitk_matmul occupancy query")
    blocks, clusters, smem, stages, slab = (x.value for x in out)
    return RingResidency(blocks, clusters, smem, stages, slab)


def splitk_matmul(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                  tb: bool = False, bm: int = 16, split: int, slice_k: int,
                  out_dtype=None, out=None) -> torch.Tensor:
    """C = Σ_s op(a)[:, Ks] @ op(b)[Ks, :] on the card, for the K slices
    Ks = [s·slice_k, (s+1)·slice_k) ∩ [0, K), s < ``split`` (a slice past
    K adds zeros), summed in f32 in slice order and stored once in
    ``out_dtype`` (default: the operands' dtype).  One launch: each K
    slice of an output tile is a CTA, and the ``split`` CTAs of the tile
    form one cluster that sums their tiles in its epilogue, so no f32
    partial is allocated.  A split outside 1-`MAX_CLUSTER` raises: the
    H100 has no larger cluster (the reference and the plain version take
    any split; ROADMAP queue C)."""
    refuse_grad("splitk_matmul", a, b, backward=GEMM_BACKWARD)
    if not 1 <= split <= MAX_CLUSTER:
        raise ValueError(f"splitk_matmul: split={split} exceeds the largest "
                         f"thread-block cluster, {MAX_CLUSTER} CTAs, that runs "
                         "the K slices of one output tile")
    dtype = check_operands(a, b, what="splitk_matmul")
    out_dtype = dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"splitk_matmul: unsupported output dtype {out_dtype}")
    M, N, K = gemm_dims(a, b, ta, tb)
    rows = cta_rows(bm)
    if slice_k < 1:
        raise ValueError(f"splitk_matmul: slice_k={slice_k} must be ≥ 1")
    if -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid ({MAX_GRID_Y} row tiles)")
    c = output(out, (M, N), out_dtype, a.device, "splitk_matmul")
    if c.numel() == 0:
        return c
    lib = _build.load("gemm_split_k", _SPLIT_K_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_splitk_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                       DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                       int(ta), int(tb), rows, M, N, K, split,
                                       slice_k, _stream(a.device))
    raise_on_error(lib, code, "splitk_matmul")
    splitk_matmul.launches += 1
    return c


def stream_k_matmul(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                    tb: bool = False, grid_g: int, out_dtype=None, out=None,
                    workspace=None) -> torch.Tensor:
    """C = op(a) @ op(b) on the card by the Stream-K walk of a tile of
    ``grid_g`` planner workgroups, in one launch, output in ``out_dtype``
    (default: the operands' dtype).  W = `card_geometry(...).workgroups`
    workgroups deal the tile-major MAC iterations of the card's CTA tiles
    into equal spans; a tile inside one span is stored by its workgroup,
    a cut tile is summed by its last contributors to arrive, in runs of
    `fixup_runs` (`stream_k_matmul_ref` computes the same bits).
    ``workspace`` (f32), of at least the size `stream_k_workspace` gives,
    is allocated when not given.  The launch counts on the current
    stream's counters (`stream_counters`), which it leaves zero, so no
    launch zeroes them."""
    refuse_grad("stream_k_matmul", a, b, backward=GEMM_BACKWARD)
    dtype = check_operands(a, b, what="stream_k_matmul")
    out_dtype = dtype if out_dtype is None else out_dtype
    if out_dtype not in DTYPE_CODES:
        raise ValueError(f"stream_k_matmul: unsupported output dtype {out_dtype}")
    M, N, K = gemm_dims(a, b, ta, tb)
    geo = card_geometry(M, N, K, dtype, ta, tb, grid_g, a.device)
    if geo.total >= 2 ** 31:
        raise ValueError(f"stream_k_matmul: {geo.total} MAC iterations exceed "
                         "the kernel's 32-bit walk")
    c = output(out, (M, N), out_dtype, a.device, "stream_k_matmul")
    floats, n_counters = stream_k_workspace(geo.live, geo.rows, geo.cols)
    if workspace is None:
        workspace = torch.empty(floats, device=a.device)
    elif (workspace.dtype != torch.float32 or workspace.device != a.device
          or not workspace.is_contiguous() or workspace.numel() < floats):
        raise ValueError(f"stream_k_matmul: workspace must be contiguous float32 of "
                         f"at least {floats} elements on {a.device}, got "
                         f"{workspace.dtype} {tuple(workspace.shape)} on "
                         f"{workspace.device}")
    cnt = stream_counters(a.device, n_counters)
    lib = _build.load("gemm_stream_k", _STREAM_K_SIGNATURES)
    with torch.cuda.device(a.device):
        code = lib.repro_stream_k_matmul(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), workspace.data_ptr(), cnt.data_ptr(),
            DTYPE_CODES[dtype], DTYPE_CODES[out_dtype], int(ta), int(tb), geo.rows,
            M, N, K, geo.tn, geo.tk, geo.total, geo.ipw, geo.live, _stream(a.device))
    raise_on_error(lib, code, "stream_k_matmul")
    stream_k_matmul.launches += 1
    return c


_COUNTERS: dict = {}


def stream_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zero int32 counters for the Stream-K launches on the
    current stream of ``device``: one buffer per (device, stream), zeroed
    when it is made or grown.  A launch leaves its counters zero again
    (the last arrival at each count resets it) and the launches of one
    stream run in order, so no launch zeroes them."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


LAUNCHERS = (matmul, splitk_matmul, stream_k_matmul)
for _fn in LAUNCHERS:
    _fn.launches = 0
matmul.feeds = dict.fromkeys(FEED_CODES, 0)
