"""Public grouped/ragged GEMM ops (`repro/kernels/grouped_gemm/ops.py`).

``grouped_gemm`` executes a concurrency group of G same-shape GEMMs at the
tile the GO library picked for CD=G; ``ragged_gemm`` is the
heterogeneous-M form (rows per member, shared N/K).  Both take the
members' weights as a stacked (G, K, N) tensor, as the reference does,
or as a sequence of G (K, N) weights read where they lie (`kernel.py`),
and an ``out_dtype`` (default: the operands' dtype).  Both read only the
tile's ``bm`` (the kernels map it to their CTA row tile); CPU tensors take
the plain versions, CUDA tensors the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gemm.ops import TileConfig
from repro_torch.kernels.grouped_gemm.kernel import (
    grouped_matmul,
    member_weights,
    ragged_matmul,
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
