"""Heterogeneous op descriptors (`repro/core/op_desc.py`): the unit the
port tunes, predicts and schedules across the kernel families a decode
step launches.

- `GemmDesc` (in `core/gemm_desc.py`) — family ``"gemm"``;
- `AttentionDesc` — flash attention, O(Sq·Skv) with causal credit;
- `GroupedGemmDesc` — a ragged expert pool (MoE routed FFNs);
- `ScanDesc` — chunked SSD scan, bandwidth-bound with a sequential
  chunk sweep.

Every descriptor is a frozen dataclass with the same protocol: ``family``,
``key()`` (family-prefixed for non-GEMMs, so library keys and
compatibility classes never collide with GEMM keys), ``flops``,
``in_bytes``, ``dtype``, ``M`` (canonical queue ordering) and
``mnk_like``, and the slicing protocol the runtime's admission uses:
``can_slice`` and ``slice(parts)``, with `slice_plan` carrying a sliced
op's operand split and merge (`SlicePlan`).

`op_from_key` inverts ``key()`` for every family (ragged row vectors
round-trip exactly).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import torch

from repro_torch.core.gemm_desc import DTYPE_BYTES, GemmDesc, split_spans

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

    # ------------------------------------------------------------ slicing
    def _slice_axis(self) -> str:
        """``"sq"`` — chunks of query rows (a prefill); ``"batch"`` —
        independent sequences (a decode step, Sq = 1); ``""`` — neither.
        A causal Sq slice needs Skv ≥ Sq, so every piece keeps a
        non-negative q_offset."""
        if self.Sq >= 2 and (not self.causal or self.Skv >= self.Sq):
            return "sq"
        return "batch" if self.B >= 2 else ""

    @property
    def can_slice(self) -> bool:
        return bool(self._slice_axis())

    def slice(self, parts: int) -> list:
        """Split into ≤ ``parts`` pieces along query rows or batch.  A
        causal Sq piece [lo, hi) keeps Skv = (Skv − Sq) + hi keys, so its
        own suffix alignment (q_offset = Skv − Sq) gives its row j the
        parent's mask of row lo + j.  ``slice(1)`` is the identity."""
        axis = self._slice_axis()
        if parts <= 1 or not axis:
            return [self]
        if axis == "sq":
            off = self.Skv - self.Sq
            if self.causal:
                return [replace(self, Sq=hi - lo, Skv=off + hi)
                        for lo, hi in split_spans(self.Sq, parts)]
            return [replace(self, Sq=hi - lo)
                    for lo, hi in split_spans(self.Sq, parts)]
        return [replace(self, B=hi - lo)
                for lo, hi in split_spans(self.B, parts)]


@dataclass(frozen=True, order=True)
class GroupedGemmDesc:
    """A ragged expert pool: G independent GEMMs sharing (K, N) weight
    shapes with per-expert row counts — the MoE routed-FFN launch.

    ``rows`` is the per-expert row vector; omitted, the M total is spread
    evenly (the cost model's default routing assumption)."""

    G: int
    M: int                 # total rows across experts
    N: int
    K: int
    dtype: str = "bf16"
    rows: Tuple[int, ...] = ()

    family = "grouped_gemm"

    def __post_init__(self):
        if self.rows:
            assert len(self.rows) == self.G and sum(self.rows) == self.M, (
                "rows must have one entry per expert summing to M")

    def row_vector(self) -> Tuple[int, ...]:
        if self.rows:
            return self.rows
        base, extra = divmod(self.M, self.G)
        return tuple(base + (1 if g < extra else 0) for g in range(self.G))

    @property
    def flops(self) -> int:
        return 2 * self.M * self.N * self.K

    @property
    def in_bytes(self) -> int:
        return DTYPE_BYTES[self.dtype]

    @property
    def mnk_like(self) -> Tuple[int, int, int]:
        return (self.M, self.N, self.K)

    def key(self) -> str:
        r = ("_r" + "-".join(str(x) for x in self.rows)) if self.rows else ""
        return f"gg_{self.G}_{self.M}_{self.N}_{self.K}_{self.dtype}{r}"

    # ------------------------------------------------------------ slicing
    @property
    def can_slice(self) -> bool:
        return self.G >= 2

    def slice(self, parts: int) -> list:
        """Split along experts into ≤ ``parts`` contiguous expert spans,
        each an ordinary pool with its span's explicit row vector; ``a``'s
        rows are in expert order, so outputs merge by row concatenation.
        ``slice(1)`` is the identity."""
        if parts <= 1 or not self.can_slice:
            return [self]
        rows = self.row_vector()
        return [
            GroupedGemmDesc(hi - lo, sum(rows[lo:hi]), self.N, self.K,
                            self.dtype, rows=tuple(rows[lo:hi]))
            for lo, hi in split_spans(self.G, parts)
        ]


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

    # ------------------------------------------------------------ slicing
    @property
    def can_slice(self) -> bool:
        """Along batch only: chunk k of T needs chunk k−1's state, so T
        pieces are not independent ops; sequences are."""
        return self.B >= 2

    def slice(self, parts: int) -> list:
        if parts <= 1 or not self.can_slice:
            return [self]
        return [replace(self, B=hi - lo)
                for lo, hi in split_spans(self.B, parts)]


def can_slice(d) -> bool:
    """Descriptors without the slicing protocol never slice."""
    return bool(getattr(d, "can_slice", False))


@dataclass(frozen=True)
class SlicePlan:
    """A sliced op and its merge recipe: ``pieces`` are ordinary
    descriptors (admitted, planned and executed like any other op),
    ``spans`` the [lo, hi) ranges along the sliced axis (``kind``) in the
    parent's coordinates.  `split_operands` maps the parent's operand
    tuple to the pieces', as views; `merge` concatenates the pieces'
    outputs along ``merge_axis`` into the parent's output."""

    parent: object
    pieces: Tuple[object, ...]
    kind: str                           # "m" | "experts" | "sq" | "batch"
    spans: Tuple[Tuple[int, int], ...]
    merge_axis: int

    @property
    def parts(self) -> int:
        return len(self.pieces)

    def split_operands(self, operands: Tuple) -> List[Tuple]:
        """Per-piece operand tuples in the family op's order: GEMM
        ``(a, b)`` (rows of ``a``, or its columns when stored transposed;
        ``b`` shared), grouped ``(a, b)`` (the span's rows of ``a`` and
        its experts' weights: a slice of a stacked tensor or of a
        sequence of weights), attention ``(q, k, v)`` (a causal Sq piece also
        trims k and v to its Skv), scan ``(xd, da, Bm, Cm)`` (batch)."""
        if self.kind == "m":
            a, b = operands
            ta = self.parent.ta
            return [((a[:, lo:hi] if ta else a[lo:hi]), b)
                    for lo, hi in self.spans]
        if self.kind == "experts":
            rows = self.parent.row_vector()
            offs = [0]
            for r in rows:
                offs.append(offs[-1] + r)
            a, b = operands
            return [(a[offs[lo]:offs[hi]], b[lo:hi]) for lo, hi in self.spans]
        if self.kind == "sq":
            q, k, v = operands
            out = []
            for p, (lo, hi) in zip(self.pieces, self.spans):
                if self.parent.causal:
                    out.append((q[:, :, lo:hi], k[:, :, :p.Skv],
                                v[:, :, :p.Skv]))
                else:
                    out.append((q[:, :, lo:hi], k, v))
            return out
        # "batch": every operand carries the batch on axis 0.
        return [tuple(x[lo:hi] for x in operands) for lo, hi in self.spans]

    def merge(self, outputs: List[torch.Tensor]) -> torch.Tensor:
        """The pieces' outputs concatenated into the parent's output (a
        new tensor)."""
        return torch.cat(list(outputs), dim=self.merge_axis)


def slice_plan(d, parts: int) -> SlicePlan:
    """``d`` sliced into ≤ ``parts`` pieces by the family's `slice()`,
    with its operand and merge mapping; ``slice_plan(d, 1)`` wraps the
    identity."""
    pieces = d.slice(parts) if can_slice(d) else [d]
    fam = family_of(d)
    if fam == "gemm":
        kind, total, axis = "m", d.M, 0
    elif fam == "grouped_gemm":
        kind, total, axis = "experts", d.G, 0
    elif fam == "mamba_scan":
        kind, total, axis = "batch", d.B, 0
    else:
        ax = d._slice_axis() or "batch"
        kind = ax
        total = d.Sq if ax == "sq" else d.B
        axis = 2 if ax == "sq" else 0
    spans = tuple(split_spans(total, len(pieces)))
    return SlicePlan(parent=d, pieces=tuple(pieces), kind=kind,
                     spans=spans, merge_axis=axis)


def op_from_key(key: str):
    """Inverse of ``key()`` for every family (GEMM keys carry no family
    prefix)."""
    if key.startswith("fa_"):
        p = key.split("_")
        return AttentionDesc(int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                             int(p[5]), int(p[6]), bool(int(p[7])), p[8])
    if key.startswith("gg_"):
        p = key.split("_")
        rows: Tuple[int, ...] = ()
        if len(p) > 6 and p[6].startswith("r"):
            rows = tuple(int(x) for x in p[6][1:].split("-"))
        return GroupedGemmDesc(int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                               p[5], rows)
    if key.startswith("ms_"):
        p = key.split("_")
        return ScanDesc(int(p[1]), int(p[2]), int(p[3]), int(p[4]),
                        int(p[5]), p[6])
    return GemmDesc.from_key(key)
