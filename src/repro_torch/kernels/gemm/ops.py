"""Public GEMM op: the tile config and the device dispatch
(`repro/kernels/gemm/ops.py`).

CPU tensors take the plain version; CUDA tensors take the hand-written
kernel or raise.  The kernel masks ragged edges itself, so operands are
never padded.  The backward pass (two independent GEMMs) belongs to
training and is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.kernels.gemm.kernel import matmul
from repro_torch.kernels.gemm.ref import gemm_ref


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


def gemm(a, b, *, ta: bool = False, tb: bool = False,
         tile: TileConfig = TileConfig()):
    """C = op(a) @ op(b) in the operands' dtype.  On CPU tensors: the
    plain version.  On CUDA tensors: the CUDA kernel, which runs only the
    un-split decomposition — a tile with ``split_k > 1`` or
    ``stream_k > 0`` raises `NotImplementedError` (their kernels are later
    items of ROADMAP.md queue B)."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return gemm_ref(a, b, ta=ta, tb=tb)
    if tile.split_k > 1 or tile.stream_k > 0:
        raise NotImplementedError(
            f"tile {tile.key()}: the split-K and Stream-K GEMM kernels are "
            "not ported yet (ROADMAP.md queue B); the CUDA path runs "
            "split_k=1, stream_k=0 tiles only")
    return matmul(a, b, ta=ta, tb=tb, bm=tile.bm)
