"""Public GEMM op: the tile config and the device dispatch
(`repro/kernels/gemm/ops.py`).

`gemm` runs the decomposition the tile names, as the reference does
(`repro/kernels/gemm/ops.py:83-125`): a Stream-K walk and its fixup for
``stream_k > 0``, split-K partials and their reduce for an effective
split above 1, else the single GEMM kernel.  CPU tensors take each
kernel's plain version (`ref.py`), CUDA tensors the hand-written kernels
or raise.  The Stream-K walk keeps the reference's geometry (the tile's
bm×bn×bk and G) on the CPU; on the card it runs in the card's units
(`kernel.card_geometry`), which regroups the f32 partials and so the
summation order, not the function.  The kernels mask ragged edges
themselves, so operands are never padded.  The backward pass (two
independent GEMMs) belongs to training and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.gemm.kernel import (
    card_counts,
    card_geometry,
    gemm_dims,
    matmul,
    split_k_slices,
    splitk_partials,
    splitk_reduce,
    stream_k_fixup,
    stream_k_geometry,
    stream_k_partials,
    stream_k_tiles,
)
from repro_torch.kernels.gemm.ref import (
    gemm_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_fixup_ref,
    stream_k_partials_ref,
)


@dataclass(frozen=True, order=True)
class TileConfig:
    """The tunable kernel 'implementation' of the paper: the (bm, bn, bk)
    tiling plus two mutually exclusive work decompositions, ``split_k``
    (K-slice partials + reduce) and ``stream_k`` (persistent Stream-K
    walk).  Same fields and `key()` as the reference, so one GO-library
    file serves both packages."""

    bm: int = 256
    bn: int = 256
    bk: int = 256
    split_k: int = 1
    stream_k: int = 0

    def __post_init__(self):
        if self.stream_k > 0 and self.split_k > 1:
            raise ValueError(
                f"split_k={self.split_k} and stream_k={self.stream_k} are "
                "mutually exclusive decompositions")

    def vmem_bytes(self, in_bytes: int = 2, acc_bytes: int = 4) -> int:
        """The reference's modeled working set (double-buffered A/B tiles
        + f32 accumulator + C out); the cost model ranks tiles by it."""
        ab = 2 * (self.bm * self.bk + self.bk * self.bn) * in_bytes
        acc = self.bm * self.bn * acc_bytes
        out = self.bm * self.bn * in_bytes
        return ab + acc + out

    def key(self) -> str:
        base = f"{self.bm}x{self.bn}x{self.bk}"
        if self.split_k != 1:
            base += f"s{self.split_k}"
        if self.stream_k:
            base += f"g{self.stream_k}"
        return base


class GemmBuffers(NamedTuple):
    """Every tensor one `gemm` launch writes on the card: the output, the
    f32 partials of a split-K or Stream-K tile, and a Stream-K tile's
    contributor counts (int32; on the card, kept per geometry by
    `card_counts`)."""

    out: torch.Tensor
    partials: Optional[torch.Tensor] = None
    counts: Optional[torch.Tensor] = None


def gemm_buffers(a, b, *, ta: bool = False, tb: bool = False,
                 tile: TileConfig = TileConfig()) -> GemmBuffers:
    """Allocate, on the current stream, the buffers `gemm` writes for
    these operands and tile.  A Stream-K tile's partials and counts
    follow the decomposition the device runs: on the card the walk's
    `card_geometry`, on the CPU the planner's tile and G."""
    M, N, K = gemm_dims(a, b, ta, tb)
    dev = a.device
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    if tile.stream_k > 0:
        if dev.type == "cuda":
            key = (M, N, K, a.dtype, ta, tb, tile.stream_k, dev)
            slots, counts = card_geometry(*key).slots, card_counts(*key)
        else:
            tm, tn, tk = stream_k_tiles(M, N, K, tile.bm, tile.bn, tile.bk)
            _, _, _, cnt, slots = stream_k_geometry(tm, tn, tk, tile.stream_k)
            counts = torch.from_numpy(cnt).to(dev)
        return GemmBuffers(
            out, torch.empty((slots, M, N), dtype=torch.float32, device=dev),
            counts)
    split, _ = split_k_slices(K, tile.bk, tile.split_k)
    if split > 1:
        return GemmBuffers(out, torch.empty((split, M, N), dtype=torch.float32,
                                            device=dev))
    return GemmBuffers(out)


def gemm(a, b, *, ta: bool = False, tb: bool = False,
         tile: TileConfig = TileConfig(), buffers: GemmBuffers | None = None):
    """C = op(a) @ op(b) in the operands' dtype, by the decomposition the
    tile names.  On CPU tensors: the plain versions of that
    decomposition's kernels.  On CUDA tensors: its kernels, writing into
    ``buffers`` when given (`gemm_buffers`), else into new ones."""
    M, N, K = gemm_dims(a, b, ta, tb)
    split, slice_k = split_k_slices(K, tile.bk, tile.split_k)
    if a.device.type == "cpu" and b.device.type == "cpu":
        if tile.stream_k > 0:
            tm, tn, tk = stream_k_tiles(M, N, K, tile.bm, tile.bn, tile.bk)
            counts = stream_k_geometry(tm, tn, tk, tile.stream_k)[3]
            p = stream_k_partials_ref(a, b, ta=ta, tb=tb, bm=tile.bm,
                                      bn=tile.bn, bk=tile.bk,
                                      grid_g=tile.stream_k)
            return stream_k_fixup_ref(torch.from_numpy(counts), p, bm=tile.bm,
                                      bn=tile.bn, dtype=a.dtype)
        if split > 1:
            p = splitk_partials_ref(a, b, ta=ta, tb=tb, split=split,
                                    slice_k=slice_k, bk=tile.bk)
            return splitk_reduce_ref(p, a.dtype)
        return gemm_ref(a, b, ta=ta, tb=tb)
    buf = buffers if buffers is not None else gemm_buffers(a, b, ta=ta, tb=tb,
                                                           tile=tile)
    if tile.stream_k > 0:
        stream_k_partials(a, b, ta=ta, tb=tb, grid_g=tile.stream_k,
                          out=buf.partials)
        geo = card_geometry(M, N, K, a.dtype, ta, tb, tile.stream_k, a.device)
        return stream_k_fixup(buf.counts, buf.partials, bm=geo.rows,
                              bn=geo.cols, dtype=a.dtype, out=buf.out)
    if split > 1:
        splitk_partials(a, b, ta=ta, tb=tb, bm=tile.bm, split=split,
                        slice_k=slice_k, out=buf.partials)
        return splitk_reduce(buf.partials, a.dtype, out=buf.out)
    return matmul(a, b, ta=ta, tb=tb, bm=tile.bm, out=buf.out)
