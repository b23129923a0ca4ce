"""Launchers of the grouped and ragged GEMM CUDA kernels
(`csrc/grouped_gemm.cu`).

``grouped_matmul`` replaces `repro/kernels/grouped_gemm/kernel.py:41
_grouped_kernel` (one CTA per member, row tile and 64-column stripe, its
K loop fed by a cp.async ring) and ``ragged_matmul`` replaces `:93
_ragged_kernel` (a walk of SMs × occupancy CTAs).
Both are bound by bytes on the serving path: a group of decode GEMMs
streams one weight matrix per member; the source says how each kernel
answers that.

Both take the members' weights by pointer: ``b`` is a stacked (G, K, N)
tensor (G pointers at stride K·N) or a sequence of G (K, N) tensors,
each read where it lies.  A member stored (N, K) and handed over as its
transpose (column-contiguous) runs with the kernel's ``TB`` layout; a
member neither row- nor column-contiguous raises, naming it, and is
never copied.  The pointers travel by value in the launch's parameters
(at most `MAX_MEMBERS` per launch; a larger group runs as consecutive
launches over chunks of members), so nothing is copied to the card and
nothing waits for it: the caller keeps the weights alive until the work
queued on the current stream has run, as for any tensor a kernel reads.

CUDA tensors only: the CPU path is the plain versions in `ref.py`,
chosen by `ops.py` from the tensors' device.  Each launcher adds one to
its ``launches`` count per kernel launch.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from itertools import accumulate
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm.kernel import (
    CTA_COLS,
    DTYPE_CODES,
    MAX_GRID_Y,
    RingResidency,
    check_operands,
    cta_k,
    cta_rows,
    raise_on_error,
    refuse_grad,
)

_LL, _P, _I = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_grouped_matmul": (_I, (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL,
                                  _LL, _LL, _P)),
    "repro_ragged_matmul": (_I, (_P, _P, _P, _P, _LL, _P, _P, _P, _I, _I, _I,
                                 _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                                 _LL, _LL, _P)),
    "repro_ragged_occupancy": (_I, (_I, _I, _I, _I, ctypes.POINTER(_I),
                                    ctypes.POINTER(_I))),
    "repro_grouped_occupancy": (_I, (_I,) * 4 + (ctypes.POINTER(_I),) * 4),
    "repro_error_string": (ctypes.c_char_p, (_I,)),
}
MAX_MEMBERS = 16    # `kMaxMembers` of csrc/grouped_gemm.cu: max(CLASSES)
# The reference defines no backward of its grouped GEMMs: a Pallas call has
# no transpose, so MoE training through them has none on the TPU either.
GROUPED_BACKWARD = ("the grouped kernels have no backward (ROADMAP A16: MoE "
                    "training on the card needs a grouped-GEMM backward)")


# ----------------------------------------------------------------- members
def member_weights(b, G: int | None = None) -> List[torch.Tensor]:
    """The members' B as a list of (K, N) tensors: a stacked (G, K, N)
    tensor's slices (views), or the given sequence; ``G``, when given,
    must match."""
    ws = list(b.unbind(0)) if isinstance(b, torch.Tensor) else list(b)
    if isinstance(b, torch.Tensor) and b.dim() != 3:
        raise ValueError(f"stacked weights must be (G, K, N), got {tuple(b.shape)}")
    if G is not None and len(ws) != G:
        raise ValueError(f"{len(ws)} weights for {G} members")
    return ws


def _weight_tensors(b) -> List[torch.Tensor]:
    return [b] if isinstance(b, torch.Tensor) else list(b)


def weight_table(ws: Sequence[torch.Tensor], K: int, dtype: torch.dtype,
                 device: torch.device, what: str
                 ) -> Tuple[bool, List[int], List[int]]:
    """``(tb, pointers, leading dims)`` of the members' (K, N) weights,
    as stored: ``tb`` False when every member is row-contiguous ((K, N)
    rows of stride ld ≥ N), True when every member is column-contiguous
    (stored (N, K), handed over transposed).  Raises, naming the member,
    for one on another device or of another dtype or width, one neither
    row- nor column-contiguous, and for orientations that differ."""
    if not ws:
        raise ValueError(f"{what}: no members")
    N = ws[0].shape[-1] if ws[0].dim() == 2 else -1
    layouts = []
    for g, w in enumerate(ws):
        if w.device != device:
            raise ValueError(f"{what}: member {g}'s weight is on {w.device}, the "
                             f"activations on {device}; the CUDA kernel needs "
                             "CUDA tensors on one device")
        if w.dtype != dtype:
            raise ValueError(f"{what}: member {g}'s weight is {w.dtype}, the "
                             f"activations {dtype}")
        if w.dim() != 2 or tuple(w.shape) != (K, N):
            raise ValueError(f"{what}: member {g}'s weight is {tuple(w.shape)}, "
                             f"expected (K, N) = ({K}, {N})")
        s0, s1 = w.stride()
        row = (s1 == 1 or N == 1) and (s0 >= N or K == 1)
        col = (s0 == 1 or K == 1) and (s1 >= K or N == 1)
        if not (row or col):
            raise ValueError(f"{what}: member {g}'s weight (strides {w.stride()}) "
                             "is neither row- nor column-contiguous; pass it "
                             "contiguous (the kernel reads weights where they lie "
                             "and copies none)")
        layouts.append((row, col))
    if all(r for r, _ in layouts):
        tb = False
    elif all(c for _, c in layouts):
        tb = True
    else:
        g = next(i for i, lay in enumerate(layouts)
                 if lay != layouts[0] and lay != (True, True))
        raise ValueError(f"{what}: member {g}'s weight is stored "
                         f"{'(K, N)' if layouts[g][0] else '(N, K)'}, member "
                         "0's the other way; one launch has one layout")
    lds = [(w.stride(1) if N > 1 else K) if tb else (w.stride(0) if K > 1 else N)
           for w in ws]
    return tb, [w.data_ptr() for w in ws], lds


def _pointers(values: Sequence[int]):
    return (_P * len(values))(*values)


def _longs(values: Sequence[int]):
    return (_LL * len(values))(*values)


def _out_dtype(dtype: torch.dtype, out_dtype, what: str) -> torch.dtype:
    out = dtype if out_dtype is None else out_dtype
    if out not in DTYPE_CODES:
        raise ValueError(f"{what}: unsupported output dtype {out}; the kernel "
                         "stores bfloat16 or float32")
    return out


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------------- grouped
def grouped_matmul(a: torch.Tensor, b, *, bm: int = 16, out_dtype=None
                   ) -> torch.Tensor:
    """C[g] = a[g] @ b[g] on the card, f32 accumulation: ``a`` (G, M, K)
    contiguous, ``b`` a stacked (G, K, N) tensor or G (K, N) weights
    (module docstring); C (G, M, N) in ``out_dtype`` (default: the
    operands' dtype).  Adds one to ``grouped_matmul.launches`` per kernel
    launch: one per chunk of `MAX_MEMBERS` members."""
    refuse_grad("grouped_matmul", a, *_weight_tensors(b), backward=GROUPED_BACKWARD)
    dtype = check_operands(a, what="grouped_matmul")
    if a.dim() != 3:
        raise ValueError(f"grouped_matmul takes a (G, M, K), got {tuple(a.shape)}")
    G, M, K = a.shape
    ws = member_weights(b, G)
    tb, ptrs, lds = weight_table(ws, K, dtype, a.device, "grouped_matmul")
    N = ws[0].shape[1]
    out = _out_dtype(dtype, out_dtype, "grouped_matmul")
    rows = cta_rows(bm)
    if -(-M // rows) > MAX_GRID_Y:
        raise ValueError(f"M={M} exceeds the kernel's grid")
    c = torch.empty((G, M, N), dtype=out, device=a.device)
    if c.numel() == 0:
        return c
    lib = _build.load("grouped_gemm", _SIGNATURES)
    a_step, c_step = M * K * a.element_size(), M * N * c.element_size()
    with torch.cuda.device(a.device):
        for g0 in range(0, G, MAX_MEMBERS):
            g1 = min(G, g0 + MAX_MEMBERS)
            code = lib.repro_grouped_matmul(
                a.data_ptr() + g0 * a_step, _pointers(ptrs[g0:g1]),
                _longs(lds[g0:g1]), c.data_ptr() + g0 * c_step,
                DTYPE_CODES[dtype], DTYPE_CODES[out], int(tb), rows, g1 - g0,
                M, N, K, _stream(a.device))
            raise_on_error(lib, code, "grouped_matmul")
            grouped_matmul.launches += 1
    return c


grouped_matmul.launches = 0


@lru_cache(maxsize=None)
def grouped_residency(device: torch.device, dtype: torch.dtype,
                      out_dtype: torch.dtype, tb: bool, rows: int
                      ) -> RingResidency:
    """`RingResidency` of the grouped kernel's instantiation (its ring is
    `csrc/tile_gemm.cuh`'s `ring_tile`; ``clusters`` is None)."""
    lib = _build.load("grouped_gemm", _SIGNATURES)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        code = lib.repro_grouped_occupancy(DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                           int(tb), rows,
                                           *(ctypes.byref(x) for x in out))
    raise_on_error(lib, code, "grouped occupancy query")
    blocks, smem, stages, slab = (x.value for x in out)
    return RingResidency(blocks, None, smem, stages, slab)


# ------------------------------------------------------------------ ragged
def row_ends(group_sizes) -> List[int]:
    """The members' cumulative end rows, as host integers (a CUDA tensor
    of sizes is read back, which waits for the card)."""
    sizes = (group_sizes.tolist() if isinstance(group_sizes, torch.Tensor)
             else [int(s) for s in group_sizes])
    if any(s < 0 for s in sizes):
        raise ValueError(f"negative group size in {sizes}")
    return list(accumulate(sizes))


class RaggedChunk(NamedTuple):
    """One launch of a ragged group: members [g0, g1) and the rows
    [row_lo, row_hi) of the bm blocks whose member lies among them."""

    g0: int
    g1: int
    row_lo: int
    row_hi: int


def ragged_chunks(ends: Sequence[int], Mtotal: int, bm: int,
                  cap: int = MAX_MEMBERS) -> List[RaggedChunk]:
    """The launches of a ragged group of len(ends) members: chunks of at
    most ``cap`` members in order, each covering the bm blocks whose
    member (`ops.block_groups`' rule, which the kernel applies to the
    row ends it is given) is one of its own (a block's first row lies
    in [end of the chunk's predecessor, end of its last member), the last
    chunk running to Mtotal), so that the lookup within a chunk's own row
    ends picks the same member as over all of them.  Chunks without a
    block are dropped."""
    G, out = len(ends), []
    n_blocks = -(-Mtotal // bm)
    for g0 in range(0, G, cap):
        g1 = min(G, g0 + cap)
        lo = -(-(ends[g0 - 1] if g0 else 0) // bm)
        hi = n_blocks if g1 == G else min(n_blocks, -(-ends[g1 - 1] // bm))
        if hi > lo:
            out.append(RaggedChunk(g0, g1, lo * bm, min(hi * bm, Mtotal)))
    return out


class RaggedWalk(NamedTuple):
    """The ragged walk of one launch in the card's units: row tiles of
    ``rows`` (min(bm, CTA rows)) × 64 columns, k step ``bk``, tm × tn
    tiles of tk steps, ``total`` iterations dealt ``ipw`` per CTA to
    ``live`` CTAs."""

    rows: int
    bk: int
    tm: int
    tn: int
    tk: int
    total: int
    ipw: int
    live: int


def ragged_walk(n_rows: int, N: int, K: int, dtype: torch.dtype, bm: int,
                workgroups: int) -> RaggedWalk:
    """The walk over ``n_rows`` rows of bm blocks by ``workgroups`` CTAs."""
    cta = cta_rows(bm)
    rows, bk = min(bm, cta), cta_k(dtype, cta)
    tm, tn, tk = -(-n_rows // rows), -(-N // CTA_COLS), -(-K // bk)
    total = tm * tn * tk
    ipw = -(-total // max(1, min(workgroups, total)))
    return RaggedWalk(rows, bk, tm, tn, tk, total, ipw, -(-total // ipw))


@lru_cache(maxsize=None)
def ragged_resources(device: torch.device, dtype: torch.dtype,
                     out_dtype: torch.dtype, tb: bool, rows: int
                     ) -> Tuple[int, int]:
    """``(ctas_per_sm, smem_bytes)`` of the ragged walk's instantiation:
    its occupancy (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`) and
    one CTA's shared memory (its cp.async ring and its f32 tile)."""
    lib = _build.load("grouped_gemm", _SIGNATURES)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.repro_ragged_occupancy(DTYPE_CODES[dtype], DTYPE_CODES[out_dtype],
                                          int(tb), rows, ctypes.byref(blocks),
                                          ctypes.byref(smem))
    raise_on_error(lib, code, "ragged occupancy query")
    if blocks.value < 1:
        raise RuntimeError(f"the ragged walk ({dtype}, {rows} rows) fits no CTA "
                           "on an SM")
    return blocks.value, smem.value


@lru_cache(maxsize=None)
def ragged_workgroups(device: torch.device, dtype: torch.dtype,
                      out_dtype: torch.dtype, tb: bool, rows: int) -> int:
    """W = SMs × CTAs per SM: one wave of the walk fills the card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return sms * ragged_resources(device, dtype, out_dtype, tb, rows)[0]


class RaggedBuffers(NamedTuple):
    """What one `ragged_matmul` call writes: C (Mtotal, N) and, for each
    of its launches (`ragged_chunks`), the walk's f32 partials and its
    int32 counters, zeroed."""

    c: torch.Tensor
    partials: Tuple[torch.Tensor, ...]
    counters: Tuple[torch.Tensor, ...]


class _RaggedCall(NamedTuple):
    dtype: torch.dtype
    out: torch.dtype
    ends: List[int]
    tb: bool
    ptrs: List[int]
    lds: List[int]
    N: int
    K: int
    cta: int
    launches: List[Tuple[RaggedChunk, RaggedWalk]]


def _ragged_call(a: torch.Tensor, b, group_sizes, bm: int, out_dtype
                 ) -> _RaggedCall:
    """Check a ragged call's arguments and lay out its launches."""
    refuse_grad("ragged_matmul", a, *_weight_tensors(b), backward=GROUPED_BACKWARD)
    cta = cta_rows(bm)
    if bm < 1 or (bm > cta and bm % cta):
        raise ValueError(f"bm={bm}: the ragged kernel takes bm ≤ 64 or a "
                         "multiple of 64")
    ends = row_ends(group_sizes)
    sizes = [e - s for s, e in zip([0] + ends, ends)]
    if any(n % bm for n in sizes[:-1]):
        raise ValueError(f"ragged_matmul: group sizes {sizes} are not multiples "
                         f"of bm={bm} (but the last); pad each member's rows "
                         "to a multiple of bm")
    dtype = check_operands(a, what="ragged_matmul")
    if a.dim() != 2:
        raise ValueError(f"ragged_matmul takes a (Mtotal, K), got {tuple(a.shape)}")
    Mtotal, K = a.shape
    ws = member_weights(b, len(ends))
    tb, ptrs, lds = weight_table(ws, K, dtype, a.device, "ragged_matmul")
    N = ws[0].shape[1]
    out = _out_dtype(dtype, out_dtype, "ragged_matmul")
    launches = []
    if Mtotal and N and K:
        w = ragged_workgroups(a.device, dtype, out, tb, cta)
        for ch in ragged_chunks(ends, Mtotal, bm):
            geo = ragged_walk(ch.row_hi - ch.row_lo, N, K, dtype, bm, w)
            if geo.total + geo.ipw >= 2 ** 31:
                raise ValueError(f"ragged_matmul: {geo.total} MAC iterations "
                                 "exceed the kernel's 32-bit walk")
            launches.append((ch, geo))
    return _RaggedCall(dtype, out, ends, tb, ptrs, lds, N, K, cta, launches)


def _ragged_buffers(a: torch.Tensor, call: _RaggedCall) -> RaggedBuffers:
    c = torch.empty((a.shape[0], call.N), dtype=call.out, device=a.device)
    return RaggedBuffers(
        c,
        tuple(torch.empty((geo.live, 2, call.cta * CTA_COLS), dtype=torch.float32,
                          device=a.device) for _, geo in call.launches),
        tuple(torch.zeros(geo.live, dtype=torch.int32, device=a.device)
              for _, geo in call.launches))


def ragged_buffers(a: torch.Tensor, b, group_sizes, *, bm: int, out_dtype=None
                   ) -> RaggedBuffers:
    """Allocate, on the current stream, what `ragged_matmul` with the same
    arguments writes (so a caller can allocate it on the launching stream
    before a mixed launch forks)."""
    return _ragged_buffers(a, _ragged_call(a, b, group_sizes, bm, out_dtype))


def ragged_matmul(a: torch.Tensor, b, group_sizes, *, bm: int, out_dtype=None,
                  out: RaggedBuffers | None = None) -> torch.Tensor:
    """Row block i = rows [i·bm, (i+1)·bm) of ``a`` (Mtotal, K) times the
    weight of member ``ops.block_groups(sizes, ·, bm, G)[i]`` on the
    card, f32 accumulation; ``b`` is a stacked (G, K, N) tensor or G
    (K, N) weights (module docstring), ``group_sizes`` the G members' row
    counts (host integers, or a tensor).  Every size but the last must
    be a multiple of ``bm``, so that each row lies in its own member's
    block (the plain version's function); else this raises.  ``bm``
    must be ≤ 64 or a multiple of the 64-row CTA tile (a block smaller
    than the CTA's rows runs in its rows, the rest masked).  Returns
    (Mtotal, N) in ``out_dtype`` (default: the operands' dtype), written
    into ``out`` (`ragged_buffers` of the same arguments) when given.
    Adds one to ``ragged_matmul.launches`` per kernel launch: one per
    chunk of `MAX_MEMBERS` members that owns a block."""
    call = _ragged_call(a, b, group_sizes, bm, out_dtype)
    bufs = out if out is not None else _ragged_buffers(a, call)
    c = bufs.c
    if c.numel() == 0:
        return c
    if call.K == 0:
        return c.zero_()
    lib = _build.load("grouped_gemm", _SIGNATURES)
    with torch.cuda.device(a.device):
        for (ch, geo), partials, counters in zip(call.launches, bufs.partials,
                                                 bufs.counters, strict=True):
            code = lib.repro_ragged_matmul(
                a.data_ptr(), _pointers(call.ptrs[ch.g0:ch.g1]),
                _longs(call.lds[ch.g0:ch.g1]), _longs(call.ends[ch.g0:ch.g1]),
                ch.g1 - ch.g0, c.data_ptr(), partials.data_ptr(),
                counters.data_ptr(), DTYPE_CODES[call.dtype], DTYPE_CODES[call.out],
                int(call.tb), call.cta, bm, ch.row_lo, ch.row_hi, call.N, call.K,
                geo.tn, geo.tk, geo.total, geo.ipw, geo.live, _stream(a.device))
            raise_on_error(lib, code, "ragged_matmul")
            ragged_matmul.launches += 1
    return c


ragged_matmul.launches = 0
