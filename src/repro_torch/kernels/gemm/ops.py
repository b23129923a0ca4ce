"""Public GEMM op: the tile config and the device dispatch
(`repro/kernels/gemm/ops.py`).

`gemm` runs the decomposition the tile names, as the reference does
(`repro/kernels/gemm/ops.py:83-125`): a Stream-K walk and its fixup for
``stream_k > 0``, split-K partials and their reduce for an effective
split above 1, else the single GEMM kernel.  CPU tensors take each
kernel's plain version (`ref.py`), CUDA tensors the hand-written kernels
or raise.  On the card split-K is one kernel, `splitk_matmul`, whose
cluster epilogue is the reduce: it computes what the plain partials and
reduce compute (the slices' f32 sums added in slice order, cast once),
with no partials in device memory.  Stream-K is one kernel too,
`stream_k_matmul`: the walk, whose cut tiles are summed by their last
contributors to arrive, in runs of `fixup_runs`.  On the CPU the plain
walk and fixup keep the reference's geometry (the tile's bm×bn×bk and
G) and slot order; the card runs the walk in its own units
(`kernel.card_geometry`) and sums in runs, which regroups the f32
partials and so the summation order, not the function
(`ref.stream_k_matmul_ref` is the card's order).  The kernels mask ragged edges themselves, so operands are
never padded.

The backward (`repro/kernels/gemm/ops.py:76-147`, a custom VJP on every
path): where grad is enabled and an operand requires it, `gemm` runs
`Gemm`, an autograd Function whose forward is the tile's decomposition
and whose backward is two more `gemm` calls at the same tile, dgrad and
wgrad, with the reference's operand flags for each (ta, tb) and the
output gradient cast to the operands' dtype.  The card's launchers take
contiguous operands only (ROADMAP C10), so the backward makes the
output gradient contiguous first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels.gemm.kernel import (
    card_geometry,
    gemm_dims,
    matmul,
    split_k_slices,
    splitk_matmul,
    stream_k_geometry,
    stream_k_matmul,
    stream_k_tiles,
    stream_k_workspace,
)
from repro_torch.kernels.gemm.ref import (
    gemm_ref,
    gemm_stream_k_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
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
    """Every tensor one `gemm` launch writes on the card: the output, and
    a Stream-K tile's f32 workspace (two tile slots per live workgroup,
    `kernel.stream_k_workspace`; its counters are the launching stream's,
    `kernel.stream_counters`).  A split-K tile writes the output alone:
    its slices are summed in the kernel."""

    out: torch.Tensor
    workspace: Optional[torch.Tensor] = None


def gemm_buffers(a, b, *, ta: bool = False, tb: bool = False,
                 tile: TileConfig = TileConfig(), out_dtype=None) -> GemmBuffers:
    """Allocate, on the current stream, the buffers `gemm` writes for
    these operands, tile and output dtype.  A Stream-K tile's workspace
    follows the walk the device runs: on the card `card_geometry`'s CTA
    tiles and live workgroups, on the CPU the planner's tile and G."""
    M, N, K = gemm_dims(a, b, ta, tb)
    dev = a.device
    out = torch.empty((M, N), dtype=out_dtype or a.dtype, device=dev)
    if tile.stream_k > 0:
        if dev.type == "cuda":
            geo = card_geometry(M, N, K, a.dtype, ta, tb, tile.stream_k, dev)
            live, rows, cols = geo.live, geo.rows, geo.cols
        else:
            tm, tn, tk = stream_k_tiles(M, N, K, tile.bm, tile.bn, tile.bk)
            live = stream_k_geometry(tm, tn, tk, tile.stream_k)[2]
            rows, cols = tile.bm, tile.bn
        floats = stream_k_workspace(live, rows, cols)[0]
        return GemmBuffers(out, torch.empty(floats, dtype=torch.float32, device=dev))
    return GemmBuffers(out)


class Gemm(torch.autograd.Function):
    """`gemm` forward; backward (`_gemm_bwd`, `:132-147`): dgrad and wgrad
    as two independent `gemm` calls at the forward's tile."""

    @staticmethod
    def forward(ctx, a, b, ta, tb, tile, out_dtype, buffers):
        ctx.save_for_backward(a, b)
        ctx.flags = (ta, tb, tile)
        return _gemm(a, b, ta, tb, tile, out_dtype, buffers)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ta, tb, tile = ctx.flags
        g = g.to(a.dtype).contiguous()
        if not ta:
            da = _gemm(g, b, False, not tb, tile, a.dtype, None)
        else:
            da = _gemm(b, g, tb, True, tile, a.dtype, None)
        if not tb:
            db = _gemm(a, g, not ta, False, tile, b.dtype, None)
        else:
            db = _gemm(g, a, True, ta, tile, b.dtype, None)
        return da, db, None, None, None, None, None


def gemm(a, b, *, ta: bool = False, tb: bool = False,
         tile: TileConfig = TileConfig(), out_dtype=None,
         buffers: GemmBuffers | None = None):
    """C = op(a) @ op(b) in ``out_dtype`` (default: the operands' dtype),
    by the decomposition the tile names.  On CPU tensors: the plain
    versions of that decomposition's kernels.  On CUDA tensors: its
    kernels, writing into ``buffers`` when given (`gemm_buffers`), else
    into new ones.  Where grad is enabled and an operand requires it, on
    either device, the call runs through `Gemm`."""
    out_dtype = out_dtype or a.dtype
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return Gemm.apply(a, b, ta, tb, tile, out_dtype, buffers)
    return _gemm(a, b, ta, tb, tile, out_dtype, buffers)


def _gemm(a, b, ta: bool, tb: bool, tile: TileConfig, out_dtype, buffers):
    """`gemm` with no autograd: the tile's decomposition on the operands'
    device."""
    K = gemm_dims(a, b, ta, tb)[2]
    split, slice_k = split_k_slices(K, tile.bk, tile.split_k)
    if a.device.type == "cpu" and b.device.type == "cpu":
        if tile.stream_k > 0:
            return gemm_stream_k_ref(a, b, ta=ta, tb=tb, bm=tile.bm, bn=tile.bn,
                                     bk=tile.bk, grid_g=tile.stream_k,
                                     out_dtype=out_dtype)
        if split > 1:
            p = splitk_partials_ref(a, b, ta=ta, tb=tb, split=split,
                                    slice_k=slice_k, bk=tile.bk)
            return splitk_reduce_ref(p, out_dtype)
        return gemm_ref(a, b, ta=ta, tb=tb, out_dtype=out_dtype)
    buf = buffers if buffers is not None else gemm_buffers(
        a, b, ta=ta, tb=tb, tile=tile, out_dtype=out_dtype)
    if tile.stream_k > 0:
        return stream_k_matmul(a, b, ta=ta, tb=tb, grid_g=tile.stream_k,
                               out_dtype=out_dtype, out=buf.out,
                               workspace=buf.workspace)
    if split > 1:
        return splitk_matmul(a, b, ta=ta, tb=tb, bm=tile.bm, split=split,
                             slice_k=slice_k, out_dtype=out_dtype, out=buf.out)
    return matmul(a, b, ta=ta, tb=tb, bm=tile.bm, out_dtype=out_dtype,
                  out=buf.out)
