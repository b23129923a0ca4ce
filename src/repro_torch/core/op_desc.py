"""Heterogeneous op descriptors (`repro/core/op_desc.py:40-135, 206-266,
363-381`): the unit the port tunes, predicts and schedules across the
kernel families a decode step launches.

- `GemmDesc` (in `core/gemm_desc.py`) — family ``"gemm"``;
- `AttentionDesc` — flash attention, O(Sq·Skv) with causal credit;
- `ScanDesc` — chunked SSD scan, bandwidth-bound with a sequential
  chunk sweep.

Every descriptor is a frozen dataclass with the same protocol: ``family``,
``key()`` (family-prefixed for non-GEMMs, so library keys and
compatibility classes never collide with GEMM keys), ``flops``,
``in_bytes``, ``dtype``, ``M`` (canonical queue ordering) and
``mnk_like``.  Slicing (`slice`, `SlicePlan`) is ROADMAP A9;
`GroupedGemmDesc`, the MoE expert pool, is ROADMAP A11.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.gemm_desc import DTYPE_BYTES, GemmDesc

FAMILIES = ("gemm", "grouped_gemm", "flash_attention", "mamba_scan")


def family_of(d) -> str:
    """Kernel family of a descriptor; plain `GemmDesc` is ``"gemm"``."""
    return getattr(d, "family", "gemm")


@dataclass(frozen=True, order=True)
class AttentionDesc:
    """One flash-attention launch: (B, Hq) × Sq query rows attending to
    Skv keys of head dim D.  ``causal`` assumes the decode-style suffix
    alignment (q_offset = Skv − Sq)."""

    B: int
    Hq: int
    Hkv: int
    Sq: int
    Skv: int
    D: int
    causal: bool = True
    dtype: str = "bf16"

    family = "flash_attention"

    @property
    def causal_credit(self) -> float:
        """Fraction of the Sq × Skv score matrix computed: row i sees
        max(Skv − Sq + i + 1, 0) keys under the suffix alignment, so a
        decode step (Sq = 1) pays everything and a full prefill ~half."""
        if not self.causal or self.Skv <= 1:
            return 1.0
        over = max(self.Skv - self.Sq, 0)
        valid = (self.Skv * (self.Skv + 1) - over * (over + 1)) / 2.0
        return max(valid / (self.Sq * self.Skv), 1.0 / (self.Sq * self.Skv))

    @property
    def flops(self) -> int:
        # QK^T + PV, causal-credited.
        return int(4 * self.B * self.Hq * self.Sq * self.Skv * self.D
                   * self.causal_credit)

    @property
    def in_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]

    @property
    def M(self) -> int:
        return self.B * self.Sq

    @property
    def mnk_like(self) -> Tuple[int, int, int]:
        return (self.B * self.Sq, self.Hq * self.D, self.Skv)

    def key(self) -> str:
        return (f"fa_{self.B}_{self.Hq}_{self.Hkv}_{self.Sq}_{self.Skv}_"
                f"{self.D}_{int(self.causal)}_{self.dtype}")


@dataclass(frozen=True, order=True)
class ScanDesc:
    """One chunked SSD scan launch: B × H sequences of length T with head
    dim P and state dim N.  The chunk sweep is sequential per (batch,
    head), and the cost model charges f32 staging, as the reference's
    kernel does."""

    B: int
    T: int
    H: int
    P: int
    N: int
    dtype: str = "bf16"

    family = "mamba_scan"

    @property
    def flops(self) -> int:
        # The L-free algorithmic core T·4·N·P per (batch, head); the cost
        # model charges the chunk-quantized figure.
        return int(self.B * self.H * self.T * 4 * self.N * self.P)

    @property
    def in_bytes(self) -> int:
        # The reference's kernel stages inputs and outputs in f32.
        return 4

    @property
    def compute_dtype(self) -> str:
        """Compute dtype the roofline charges (f32, for the staging)."""
        return "f32"

    @property
    def M(self) -> int:
        return self.B * self.T

    @property
    def mnk_like(self) -> Tuple[int, int, int]:
        return (self.B * self.T, self.H * self.P, self.N)

    def key(self) -> str:
        return f"ms_{self.B}_{self.T}_{self.H}_{self.P}_{self.N}_{self.dtype}"


def op_from_key(key: str):
    """Inverse of ``key()`` for every ported family (GEMM keys carry no
    family prefix).  A ``gg_`` key (grouped expert GEMM) raises: that
    family is ROADMAP A11."""
    if key.startswith("fa_"):
        p = key.split("_")
        return AttentionDesc(int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                             int(p[5]), int(p[6]), bool(int(p[7])), p[8])
    if key.startswith("gg_"):
        raise NotImplementedError(
            f"{key}: GroupedGemmDesc (the MoE expert pool) is not ported yet "
            "(ROADMAP A11)")
    if key.startswith("ms_"):
        p = key.split("_")
        return ScanDesc(int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                        int(p[5]), p[6])
    return GemmDesc.from_key(key)
