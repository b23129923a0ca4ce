"""GEMM descriptors — the unit the port tunes and schedules
(`repro/core/gemm_desc.py`, with torch dtypes in place of jnp's)."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

DTYPE_BYTES = {"bf16": 2, "f32": 4, "f16": 2}
TORCH_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
                "f16": torch.float16}


def split_spans(total: int, parts: int) -> list:
    """Balanced contiguous [lo, hi) spans of ``range(total)`` — the one
    splitting rule every family's `slice()` uses, so `slice_plan` can
    re-derive the operand ranges; ``parts`` is clamped to [1, total] and
    earlier spans absorb the remainder."""
    parts = max(1, min(int(parts), int(total)))
    base, extra = divmod(int(total), parts)
    spans, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        spans.append((lo, hi))
        lo = hi
    return spans


@dataclass(frozen=True, order=True)
class GemmDesc:
    """A GEMM input in the paper's M_N_K_T1_T2 notation (+ dtype).

    C[M,N] = op(A) @ op(B); T1/T2 flag transposed *storage* of A/B.
    """

    M: int
    N: int
    K: int
    ta: bool = False
    tb: bool = False
    dtype: str = "bf16"
    batch: int = 1  # strided batched-GEMM count; 1 = plain

    family = "gemm"

    @property
    def mnk_like(self) -> tuple:
        return (self.M, self.N, self.K)

    @property
    def flops(self) -> int:
        return 2 * self.M * self.N * self.K * self.batch

    @property
    def in_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]

    def key(self) -> str:
        t = f"{int(self.ta)}{int(self.tb)}"
        b = f"_b{self.batch}" if self.batch != 1 else ""
        return f"{self.M}_{self.N}_{self.K}_{t}_{self.dtype}{b}"

    @staticmethod
    def from_key(key: str) -> "GemmDesc":
        parts = key.split("_")
        M, N, K = int(parts[0]), int(parts[1]), int(parts[2])
        ta, tb = parts[3][0] == "1", parts[3][1] == "1"
        dtype = parts[4]
        batch = int(parts[5][1:]) if len(parts) > 5 else 1
        return GemmDesc(M, N, K, ta, tb, dtype, batch)

    def torch_dtype(self) -> torch.dtype:
        return TORCH_DTYPES[self.dtype]

    def with_batch(self, b: int) -> "GemmDesc":
        return replace(self, batch=b)

    # ------------------------------------------------------------ slicing
    @property
    def can_slice(self) -> bool:
        """M-sliceable: plain GEMMs only (a batched GEMM's batch is its
        pooling axis, not a free row dim) with M ≥ 2."""
        return self.batch == 1 and self.M >= 2

    def slice(self, parts: int) -> list:
        """Split along M into ≤ ``parts`` contiguous pieces, each in the
        parent's compatibility class (the class key is M-free); outputs
        merge by row concatenation (`core.op_desc.slice_plan`).
        ``slice(1)`` is the identity."""
        if parts <= 1 or not self.can_slice:
            return [self]
        return [replace(self, M=hi - lo)
                for lo, hi in split_spans(self.M, parts)]
