"""Public grouped/ragged GEMM ops (`repro/kernels/grouped_gemm/ops.py`).

``grouped_gemm`` executes a concurrency group of G same-shape GEMMs at the
tile the GO library picked for CD=G; ``ragged_gemm`` is the
heterogeneous-M form (rows per member, shared N/K).  Both take the
members' weights as a stacked (G, K, N) tensor, as the reference does,
or as a sequence of G (K, N) weights read where they lie (`kernel.py`),
and an ``out_dtype`` (default: the operands' dtype).  Both read only the
tile's ``bm`` (the kernels map it to their CTA row tile); CPU tensors take
the plain versions, CUDA tensors the kernels or raise.

``grouped_for_desc`` runs the launch a `GroupedGemmDesc` describes (the
MoE expert pool, DESIGN.md §14) on ``ragged_gemm``'s kernel, and
``grouped_buffers`` allocates what it writes on the card.

No backward: the reference's grouped GEMM is a Pallas call with no VJP.
On the CPU the plain versions differentiate by autograd, as the
reference's einsum path does; on the card the launchers refuse an
operand that requires grad (ROADMAP A16).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.gemm.ops import TileConfig
from repro_torch.kernels.grouped_gemm.kernel import (
    RaggedBuffers,
    grouped_matmul,
    member_weights,
    ragged_buffers,
    ragged_chunks,
    ragged_matmul,
    row_ends,
)
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref, ragged_gemm_ref


def _on_cpu(a, b) -> bool:
    return all(t.device.type == "cpu" for t in [a, *member_weights(b)])


def grouped_gemm(a, b, *, tile: TileConfig = TileConfig(), out_dtype=None):
    """(G,M,K) x G (K,N) weights -> (G,M,N)."""
    if _on_cpu(a, b):
        return grouped_gemm_ref(a, b, out_dtype=out_dtype)
    return grouped_matmul(a, b, bm=tile.bm, out_dtype=out_dtype)


def block_groups(group_sizes: torch.Tensor, n_blocks: int, bm: int,
                 G: int) -> torch.Tensor:
    """Group of each bm row block (`repro/kernels/grouped_gemm/ops.py:
    70-78`): the first group whose cumulative row end lies past the
    block's first row, clamped to G-1.  Stays on the sizes' device.  The
    ragged kernel applies the same rule to the row ends it is given
    (`csrc/grouped_gemm.cu` `ragged_kernel`); this is its one mirror
    here."""
    offsets = torch.cumsum(group_sizes.to(torch.int32), 0, dtype=torch.int32)
    block_row = torch.arange(n_blocks, dtype=torch.int32,
                             device=group_sizes.device) * bm
    return torch.clamp(
        torch.searchsorted(offsets, block_row, right=True, out_int32=True),
        max=G - 1).contiguous()


def ragged_gemm(a, b, group_sizes, *, tile: TileConfig = TileConfig(),
                out_dtype=None):
    """Rows of ``a`` (Mtotal, K), grouped in order by ``group_sizes`` (G,)
    — each a multiple of ``tile.bm`` for the kernel path — times their
    group's weight (K, N).  On the card the sizes are read as host
    integers: pass a list (a CUDA tensor is read back first)."""
    if _on_cpu(a, b):
        return ragged_gemm_ref(a, b, group_sizes, out_dtype=out_dtype)
    return ragged_matmul(a, b, group_sizes, bm=tile.bm, out_dtype=out_dtype)


# ------------------------------------------------------------ expert pool
class Packing(NamedTuple):
    """How a pool's rows (in expert order, ``sizes`` rows each) are packed
    to bm blocks on the card: each expert's rows padded to a multiple of
    bm (``padded``), ``gather`` the source row of each packed row (a pad
    row repeats a row of its expert: rows are independent, and a pad
    row's result is dropped), ``scatter`` the packed row of each source
    row.  Both index tensors lie on the card."""

    padded: Tuple[int, ...]
    gather: torch.Tensor
    scatter: torch.Tensor


@lru_cache(maxsize=256)
def packing(sizes: Tuple[int, ...], bm: int, device: torch.device
            ) -> Optional[Packing]:
    """The `Packing` of a pool's row vector at row block ``bm``, or None
    when every expert's rows are already a multiple of bm.  Cached per
    (row vector, bm, device): a decode step's pools have a few shapes."""
    if all(r % bm == 0 for r in sizes):
        return None
    padded, gather, scatter, off = [], [], [], 0
    for r in sizes:
        p = r + (-r) % bm
        scatter += range(len(gather), len(gather) + r)
        gather += list(range(off, off + r)) + [off] * (p - r)
        padded.append(p)
        off += r
    return Packing(tuple(padded), torch.tensor(gather, device=device),
                   torch.tensor(scatter, device=device))


class GroupedBuffers(NamedTuple):
    """What `grouped_for_desc` writes on the card: the rows packed to bm
    blocks (None when already packed), the ragged launch's buffers, and
    the result in the descriptor's row order (``ragged.c`` itself when
    nothing was packed)."""

    packed: Optional[torch.Tensor]
    ragged: RaggedBuffers
    out: torch.Tensor


def pool_launches(desc, bm: int) -> int:
    """The `ragged_matmul` launches `grouped_for_desc` makes for ``desc`` at
    row block ``bm`` on the card: `ragged_chunks` of its experts' rows
    padded to bm."""
    sizes = [r + (-r) % bm for r in desc.row_vector()]
    return len(ragged_chunks(row_ends(sizes), sum(sizes), bm))


def grouped_buffers(desc, a, b, *, tile=None) -> GroupedBuffers:
    """Allocate, on the current stream, what `grouped_for_desc` writes for
    ``desc`` at ``tile`` on the card: the launching stream's allocations
    before a mixed launch forks (`core/scheduler.py:_run_mixed`)."""
    bm = (tile or TileConfig()).bm
    pk = packing(desc.row_vector(), bm, a.device)
    if pk is None:
        rb = ragged_buffers(a, b, list(desc.row_vector()), bm=bm)
        return GroupedBuffers(None, rb, rb.c)
    packed = torch.empty((len(pk.gather), a.shape[1]), dtype=a.dtype,
                         device=a.device)
    rb = ragged_buffers(packed, b, list(pk.padded), bm=bm)
    return GroupedBuffers(packed, rb,
                          torch.empty((a.shape[0], rb.c.shape[1]), dtype=a.dtype,
                                      device=a.device))


def grouped_for_desc(desc, a, b, *, tile=None, out: GroupedBuffers | None = None):
    """Run the ragged expert-pool launch a `GroupedGemmDesc` describes
    (`repro/kernels/grouped_gemm/ops.py:93-133`).

    ``a`` is (M, K): every expert's rows in expert order by
    ``desc.row_vector()`` (an expert may have none); ``b`` the G expert
    weights, a stacked (G, K, N) tensor or a sequence of G (K, N) weights
    read where they lie.  Returns (M, N) in ``a``'s dtype.  CPU tensors
    take `ragged_gemm_ref` on the raw ragged layout, as the reference's
    reference path does.  On the card each expert's rows are packed to
    the tile's bm (`packing`), ``ragged_matmul`` runs them (one launch
    per chunk of 16 experts that owns a block, `pool_launches`),
    and the rows return to the descriptor's order; ``out``
    (`grouped_buffers`) receives all three when given."""
    sizes = desc.row_vector()
    if _on_cpu(a, b):
        return ragged_gemm_ref(a, b, list(sizes), out_dtype=a.dtype)
    bm = (tile or TileConfig()).bm
    bufs = out if out is not None else grouped_buffers(desc, a, b, tile=tile)
    pk = packing(sizes, bm, a.device)
    if pk is None:
        return ragged_matmul(a, b, list(sizes), bm=bm, out=bufs.ragged)
    torch.index_select(a, 0, pk.gather, out=bufs.packed)
    c = ragged_matmul(bufs.packed, b, list(pk.padded), bm=bm, out=bufs.ragged)
    return torch.index_select(c, 0, pk.scatter, out=bufs.out)
