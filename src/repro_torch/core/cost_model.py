"""Analytical cost model (`repro/core/cost_model.py`): the GEMM paths and
the flash-attention, grouped expert-GEMM and SSD-scan families
(`:363-376, 407-420, 558-660, 782-973`).

The port plans exactly as the reference does: the model is the same
float64 NumPy code over the same `TPUSpec`, so the tuner, the library
and the scheduler reach bitwise-identical decisions in both packages
(`tests/test_torch_core.py`).  Its constants describe the reference's
target chip, not the H100; a spec for Hopper is a later item of the
port.  Times are modeled seconds, used to rank candidates, never
reported as measurements.

Non-GEMM descriptors dispatch at the top of `kernel_stats_batch` and
`isolated_time_batch` to their family's struct-of-arrays model, and a
group with any non-GEMM member takes `_group_time_mixed`; both group
paths compose through `_compose_group_time`.  The float folds are the
reference's (Python ``sum()`` in the mixed path, `_fold` in the GEMM
path), so mixed plans match bitwise too.

Written once over struct-of-arrays (`DescBatch` × `TileBatch` ×
broadcast budgets); the scalar functions wrap the same code, so batch
and scalar results are bitwise equal.  `EVAL_COUNTER` counts every
(GEMM, tile, budget) evaluation so the runtime's zero-evaluation
cache-hit path is checkable.

`CostCalibrator` is the reference's online correction of this model
(`repro/core/cost_model.py:1088-1207`, DESIGN.md §16): per-(family,
compat-class) EWMAs of log(achieved / modeled), and a drift detector
that queues a class for re-tuning once per excursion.  Its arithmetic is
the reference's, float for float.
"""
from __future__ import annotations

import math
import threading
from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np

from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.op_desc import (
    AttentionDesc, GroupedGemmDesc, ScanDesc, family_of,
)
from repro_torch.kernels.gemm.ops import TileConfig


@dataclass(frozen=True)
class TPUSpec:
    """The reference's modeled chip, unchanged so plans match."""

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12
    peak_flops_fp32: float = 98.5e12
    hbm_bw: float = 819e9            # B/s
    vmem_bytes: int = 32 * 2**20
    launch_overhead_s: float = 3e-6
    pipeline_fill_tiles: int = 2
    ici_bw: float = 50e9
    mxu_dim: int = 128

    def peak(self, dtype: str) -> float:
        return self.peak_flops_fp32 if dtype == "f32" else self.peak_flops_bf16

    def scaled(self, frac: float) -> "TPUSpec":
        """The resource-constrained variant (the paper's GPU/2, GPU/4):
        VMEM and bandwidth times ``frac``, as the reference's
        (`repro/core/cost_model.py:83-90`)."""
        return replace(
            self,
            name=f"{self.name}/{round(1 / frac)}" if frac != 1.0 else self.name,
            vmem_bytes=int(self.vmem_bytes * frac),
            hbm_bw=self.hbm_bw * frac,
        )


DEFAULT_SPEC = TPUSpec()
RC_FRACTIONS = {"GPU": 1.0, "GPU/2": 0.5, "GPU/4": 0.25}

_STRIDED_DMA = 1 / 0.85  # strided operand loses ~15% (paper Fig. 5(b) ③)


class EvalCounter:
    """Per-thread counts of cost-model evaluations: ``evals`` is the
    number of (GEMM, tile, budget) tuples evaluated, ``calls`` the number
    of entries into the model."""

    __slots__ = ("_tls",)

    def __init__(self) -> None:
        self._tls = threading.local()

    def _counts(self) -> list:
        c = getattr(self._tls, "counts", None)
        if c is None:
            c = self._tls.counts = [0, 0]
        return c

    @property
    def evals(self) -> int:
        return self._counts()[0]

    @property
    def calls(self) -> int:
        return self._counts()[1]

    def add(self, n: int) -> None:
        c = self._counts()
        c[0] += int(n)
        c[1] += 1

    def reset(self) -> None:
        self._tls.counts = [0, 0]

    def snapshot(self) -> tuple[int, int]:
        return tuple(self._counts())


EVAL_COUNTER = EvalCounter()


# --------------------------------------------------------- struct-of-arrays
@dataclass(frozen=True)
class TileBatch:
    """Struct-of-arrays over candidate `TileConfig`s (int64 fields);
    ``stream_k=None`` means an all-tile/split-K batch."""

    bm: np.ndarray
    bn: np.ndarray
    bk: np.ndarray
    split_k: np.ndarray
    stream_k: np.ndarray | None = None

    @staticmethod
    def from_tiles(tiles: Sequence[TileConfig]) -> "TileBatch":
        return TileBatch(
            bm=np.asarray([t.bm for t in tiles], np.int64),
            bn=np.asarray([t.bn for t in tiles], np.int64),
            bk=np.asarray([t.bk for t in tiles], np.int64),
            split_k=np.asarray([t.split_k for t in tiles], np.int64),
            stream_k=np.asarray([t.stream_k for t in tiles], np.int64),
        )

    def vmem_bytes(self, in_bytes: int = 2, acc_bytes: int = 4) -> np.ndarray:
        """Mirrors `TileConfig.vmem_bytes` (raw, unclamped dims)."""
        ab = 2 * (self.bm * self.bk + self.bk * self.bn) * in_bytes
        acc = self.bm * self.bn * acc_bytes
        out = self.bm * self.bn * in_bytes
        return ab + acc + out

    def tile(self, i: int) -> TileConfig:
        sk = 0 if self.stream_k is None else int(self.stream_k[i])
        return TileConfig(int(self.bm[i]), int(self.bn[i]), int(self.bk[i]),
                          int(self.split_k[i]), stream_k=sk)

    def __len__(self) -> int:
        return int(np.broadcast(self.bm, self.bn, self.bk, self.split_k).size)


@dataclass(frozen=True)
class DescBatch:
    """Struct-of-arrays over `GemmDesc`s (heterogeneous group members)."""

    M: np.ndarray
    N: np.ndarray
    K: np.ndarray
    batch: np.ndarray
    in_bytes: np.ndarray
    ta: np.ndarray
    tb: np.ndarray
    f32: np.ndarray

    @staticmethod
    def from_descs(descs: Sequence[GemmDesc]) -> "DescBatch":
        return DescBatch(
            M=np.asarray([d.M for d in descs], np.int64),
            N=np.asarray([d.N for d in descs], np.int64),
            K=np.asarray([d.K for d in descs], np.int64),
            batch=np.asarray([d.batch for d in descs], np.int64),
            in_bytes=np.asarray([d.in_bytes for d in descs], np.int64),
            ta=np.asarray([d.ta for d in descs], bool),
            tb=np.asarray([d.tb for d in descs], bool),
            f32=np.asarray([d.dtype == "f32" for d in descs], bool),
        )

    def peak(self, spec: TPUSpec) -> np.ndarray:
        return np.where(self.f32, spec.peak_flops_fp32, spec.peak_flops_bf16)


def _desc_fields(d):
    # GemmDesc and DescBatch expose the same field names (scalar vs array).
    return (d.M, d.N, d.K, d.batch, d.in_bytes, d.ta, d.tb)


def _peak_of(d, spec: TPUSpec):
    if isinstance(d, GemmDesc):
        return spec.peak(d.dtype)
    return d.peak(spec)


@dataclass(frozen=True)
class KernelStats:
    """One evaluation slot of `KernelStatsBatch` as Python scalars."""

    n_tiles: int
    waves: float
    occupancy: float
    vmem_bytes: float
    hbm_bytes: float
    flops: float
    mxu_util: float
    a_resident: bool
    splits: int = 1
    streams: int = 0


@dataclass(frozen=True)
class KernelStatsBatch:
    """Per-(GEMM, tile) features — #WGs, waves, occupancy, traffic — as
    broadcast NumPy arrays, one slot per evaluation."""

    n_tiles: np.ndarray
    waves: np.ndarray
    occupancy: np.ndarray
    vmem_bytes: np.ndarray
    hbm_bytes: np.ndarray
    flops: np.ndarray
    mxu_util: np.ndarray
    a_resident: np.ndarray
    splits: np.ndarray
    streams: np.ndarray

    def item(self, i=()) -> KernelStats:
        return KernelStats(
            n_tiles=int(self.n_tiles[i]),
            waves=float(self.waves[i]),
            occupancy=float(self.occupancy[i]),
            vmem_bytes=float(self.vmem_bytes[i]),
            hbm_bytes=float(self.hbm_bytes[i]),
            flops=float(self.flops[i]),
            mxu_util=float(self.mxu_util[i]),
            a_resident=bool(self.a_resident[i]),
            splits=int(self.splits[i]),
            streams=int(self.streams[i]),
        )


# ------------------------------------------------------------- batched core
@dataclass(frozen=True)
class TilePrecomp:
    """Budget-independent tile math, paid once per (desc, tiles) pair."""

    tn: np.ndarray
    splits: np.ndarray
    streams: np.ndarray
    n_tiles: np.ndarray
    ws: np.ndarray
    a_panel: np.ndarray
    a_unit: np.ndarray
    bc_bytes: np.ndarray
    flops: np.ndarray
    util: np.ndarray
    peak: np.ndarray


def tile_precompute(d, t, spec: TPUSpec = DEFAULT_SPEC) -> TilePrecomp:
    M, N, K, batch, in_bytes, ta, tb = _desc_fields(d)
    mxu = spec.mxu_dim
    bm = np.minimum(t.bm, _round_up(M, mxu))
    bn = np.minimum(t.bn, _round_up(N, mxu))
    bk = np.minimum(t.bk, _round_up(K, mxu))
    tm, tn, tk = _cdiv(M, bm), _cdiv(N, bn), _cdiv(K, bk)
    s = np.minimum(t.split_k, tk)
    n_tiles = tm * tn * s * batch
    sk = np.asarray(t.stream_k if getattr(t, "stream_k", None) is not None
                    else 0, np.int64)
    total = tm * tn * tk * batch
    ipw = _cdiv(total, np.maximum(np.minimum(sk, total), 1))
    g_live = _cdiv(total, ipw)
    n_tiles = np.where(sk > 0, g_live, n_tiles)
    streams = np.where(sk > 0, g_live, np.zeros_like(g_live))

    ws = (2 * (bm * bk + bk * bn) * in_bytes
          + bm * bn * 4 + bm * bn * in_bytes)
    a_panel = bm * K * in_bytes / s
    if isinstance(d, GemmDesc):
        a_stream = _STRIDED_DMA if ta else 1.0
        b_stream = _STRIDED_DMA if tb else 1.0
    else:
        a_stream = np.where(ta, _STRIDED_DMA, 1.0)
        b_stream = np.where(tb, _STRIDED_DMA, 1.0)
    a_unit = M * K * in_bytes * batch * a_stream
    b_bytes = tm * (K * N * in_bytes * batch) * b_stream
    c_bytes = M * N * in_bytes * batch
    part_bytes = np.where(s > 1, s * (2 * (M * N * 4) * batch), 0.0)
    period = tk // np.gcd(ipw, tk)
    straddle = (g_live - 1) - (g_live - 1) // period
    part_bytes = np.where(sk > 0, straddle * (2.0 * (bm * bn * 4)),
                          part_bytes)
    bc_bytes = (b_bytes + c_bytes) + part_bytes

    flops = 2.0 * (tm * bm) * (tn * bn) * (tk * bk) * batch
    util = (
        _align_eff(bm, mxu)
        * _align_eff(bn, mxu)
        * _align_eff(bk, mxu)
    )
    return TilePrecomp(
        tn=tn, splits=s, streams=streams, n_tiles=n_tiles, ws=ws,
        a_panel=a_panel, a_unit=np.asarray(a_unit), bc_bytes=bc_bytes,
        flops=flops, util=util, peak=np.asarray(_peak_of(d, spec)),
    )


def kernel_stats_batch(
    d, t, vmem_budget=None, spec: TPUSpec = DEFAULT_SPEC,
    pre: TilePrecomp | None = None,
) -> KernelStatsBatch:
    """Per-(GEMM, tile, budget) features: ``d`` a `GemmDesc` or `DescBatch`, ``t``
    a `TileConfig` or `TileBatch`, ``vmem_budget`` a scalar or array; all
    broadcast together.  This is THE model — the scalar path wraps it.
    Non-GEMM descriptors dispatch to their family's model."""
    if not isinstance(d, (GemmDesc, DescBatch)):
        return _FAMILY_STATS[family_of(d)](d, t, vmem_budget, spec)
    p = pre if pre is not None else tile_precompute(d, t, spec)
    budget = spec.vmem_bytes if vmem_budget is None else vmem_budget

    resid_frac = np.minimum(np.maximum(
        (budget - p.ws) / p.a_panel, 0.0), 1.0)
    a_resident = resid_frac >= 1.0
    eff_reads = p.tn - resid_frac * (p.tn - 1)
    hbm = eff_reads * p.a_unit + p.bc_bytes

    slots = np.maximum(1, budget // p.ws)
    waves = p.n_tiles / np.minimum(slots, spec.pipeline_fill_tiles * 4)
    occ = np.minimum(1.0, (p.ws + resid_frac * p.a_panel) / budget)
    EVAL_COUNTER.add(np.size(waves))
    return KernelStatsBatch(
        n_tiles=p.n_tiles,
        waves=waves,
        occupancy=occ,
        vmem_bytes=p.ws + np.where(a_resident, p.a_panel, 0.0),
        hbm_bytes=hbm,
        flops=p.flops,
        mxu_util=p.util,
        a_resident=a_resident,
        splits=p.splits,
        streams=p.streams,
    )


def isolated_time_batch(
    d, t, spec: TPUSpec = DEFAULT_SPEC, vmem_budget=None, bw_frac=1.0,
    pre: TilePrecomp | None = None,
) -> np.ndarray:
    """Vectorized `isolated_time` (split-K and Stream-K kernels pay one
    extra launch for their epilogue).  Non-GEMM families share the same
    roofline composition over their own stats."""
    if not isinstance(d, (GemmDesc, DescBatch)):
        st = kernel_stats_batch(d, t, vmem_budget, spec)
        compute = st.flops / (spec.peak(_compute_dtype(d)) * st.mxu_util)
        bw = spec.hbm_bw * bw_frac
        memory = st.hbm_bytes / bw
        ramp = spec.pipeline_fill_tiles * (st.hbm_bytes / st.n_tiles / bw)
        return (np.maximum(compute, memory) + ramp
                + spec.launch_overhead_s)
    p = pre if pre is not None else tile_precompute(d, t, spec)
    st = kernel_stats_batch(d, t, vmem_budget, spec, pre=p)
    compute = st.flops / (p.peak * st.mxu_util)
    bw = spec.hbm_bw * bw_frac
    memory = st.hbm_bytes / bw
    ramp = spec.pipeline_fill_tiles * (st.hbm_bytes / st.n_tiles / bw)
    launches = np.where((st.splits > 1) | (st.streams > 0), 2.0, 1.0)
    return (np.maximum(compute, memory) + ramp
            + launches * spec.launch_overhead_s)


def group_time_batch(
    d: GemmDesc, t, cds, spec: TPUSpec = DEFAULT_SPEC,
    pre: TilePrecomp | None = None, tiles_per_cd: bool = False,
) -> np.ndarray:
    """Vectorized homogeneous `group_time`: ``cd`` identical members per
    group, one group per (cd, tile) pair; shape ``(len(cds), ...)``.
    Member sums fold left-to-right like the scalar loop, so results are
    bitwise equal to ``group_time([(d, tile)] * cd)``.
    ``tiles_per_cd=True`` says the tile batch already carries the CD axis
    as its leading dim (the tuner's per-CD Stream-K candidates)."""
    cds = [int(c) for c in np.atleast_1d(cds)]
    p = pre if pre is not None else tile_precompute(d, t, spec)
    rest = np.broadcast_shapes(np.shape(p.ws), np.shape(p.n_tiles),
                               np.shape(p.bc_bytes))
    if tiles_per_cd:
        if not rest or rest[0] != len(cds):
            raise ValueError(
                f"tiles_per_cd=True needs a leading CD axis of {len(cds)}, "
                f"got batch shape {rest}")
        shares = np.asarray([spec.vmem_bytes // c for c in cds],
                            np.int64).reshape((len(cds),)
                                              + (1,) * (len(rest) - 1))
    else:
        shares = np.asarray([spec.vmem_bytes // c for c in cds],
                            np.int64).reshape((len(cds),) + (1,) * len(rest))
    st = kernel_stats_batch(d, t, vmem_budget=shares, spec=spec, pre=p)
    comp = np.broadcast_to(st.flops / (p.peak * st.mxu_util),
                           st.hbm_bytes.shape)
    mem = st.hbm_bytes / spec.hbm_bw
    ramp = spec.pipeline_fill_tiles * (st.hbm_bytes / st.n_tiles
                                       / spec.hbm_bw)
    # Fold each row's cd copies left-to-right (NOT cd · x, which rounds
    # differently than the scalar member loop).
    quants = np.stack([comp, mem, np.maximum(comp, mem),
                       np.broadcast_to(st.vmem_bytes, mem.shape)])
    acc = quants.copy()
    for r, cd in enumerate(cds):
        row = quants[:, r]
        arow = acc[:, r]
        for _ in range(cd - 1):
            arow += row
    sum_c, sum_m, serial, total_ws = acc
    pressure = total_ws / spec.vmem_bytes
    overlap = np.minimum(1.0, 1.0 / pressure)
    ideal = np.maximum(sum_c, sum_m)
    t_exec = overlap * ideal + (1.0 - overlap) * (
        serial * (1.0 + 0.25 * np.maximum(0.0, pressure - 1.0))
    )
    launches = np.where((st.splits > 1) | (st.streams > 0), 2.0, 1.0)
    return t_exec + ramp + launches * spec.launch_overhead_s


# ------------------------------------------------------------ scalar façade
def isolated_time(
    d: GemmDesc, t: TileConfig, spec: TPUSpec = DEFAULT_SPEC,
) -> float:
    """Modeled latency of one GEMM kernel run alone (one launch)."""
    return float(isolated_time_batch(d, t, spec))


# Per-piece charge of admission slicing: each piece is one more launch and
# a share of the merge's concatenation.
SLICE_OVERHEAD_S = 2e-6


def sliced_time(d, t, parts: int, spec: TPUSpec = DEFAULT_SPEC) -> float:
    """Modeled latency of ``d`` run as ``parts`` pieces one after another:
    the pieces' isolated times plus `SLICE_OVERHEAD_S` a piece; one piece
    charges no overhead and is `isolated_time`."""
    pieces = d.slice(parts) if getattr(d, "can_slice", False) else [d]
    total = 0.0
    for p in pieces:
        total += float(isolated_time_batch(p, t, spec))
    if len(pieces) > 1:
        total += len(pieces) * SLICE_OVERHEAD_S
    return total


def sequential_time(
    members: Sequence[tuple[GemmDesc, TileConfig]],
    spec: TPUSpec = DEFAULT_SPEC,
) -> float:
    if not members:
        return 0.0
    if not _all_gemm(members):
        acc = 0.0
        for d, t in members:
            acc += float(isolated_time_batch(d, t, spec))
        return acc
    db = DescBatch.from_descs([d for d, _ in members])
    tb = TileBatch.from_tiles([t for _, t in members])
    return _fold(isolated_time_batch(db, tb, spec))


def group_time(
    members: Sequence[tuple[GemmDesc, TileConfig]],
    spec: TPUSpec = DEFAULT_SPEC,
) -> float:
    """Modeled latency of one grouped launch executing all members: the
    merged roofline ``max(Σ compute, Σ memory)`` degraded toward serial
    execution as the aggregate working set overflows the budget.  A group
    with a non-GEMM member takes the per-member loop of
    `_group_time_mixed` through the same composition."""
    G = len(members)
    if G == 0:
        return 0.0
    share = spec.vmem_bytes // G
    if not _all_gemm(members):
        return _group_time_mixed(members, share, spec)
    db = DescBatch.from_descs([d for d, _ in members])
    tb = TileBatch.from_tiles([t for _, t in members])
    st = kernel_stats_batch(db, tb, vmem_budget=share, spec=spec)
    comps = st.flops / (db.peak(spec) * st.mxu_util)
    mems = st.hbm_bytes / spec.hbm_bw
    ramps = spec.pipeline_fill_tiles * (st.hbm_bytes / st.n_tiles
                                        / spec.hbm_bw)
    sum_c = _fold(comps)
    sum_m = _fold(mems)
    serial = _fold(np.maximum(comps, mems))
    total_ws = _fold(st.vmem_bytes)
    return _compose_group_time(
        sum_c, sum_m, serial, total_ws, float(np.max(ramps)),
        bool(np.any((st.splits > 1) | (st.streams > 0))), spec,
    )


def _compose_group_time(
    sum_c: float, sum_m: float, serial: float, total_ws: float,
    max_ramp: float, any_epilogue: bool, spec: TPUSpec,
) -> float:
    """The overlap/pressure composition of one grouped launch, shared by
    the GEMM fold (`group_time`) and the mixed-family member loop
    (`_group_time_mixed`); `group_time_batch` carries the array form."""
    pressure = total_ws / spec.vmem_bytes
    overlap = min(1.0, 1.0 / pressure) if pressure > 0 else 1.0
    ideal = max(sum_c, sum_m)
    t_exec = overlap * ideal + (1.0 - overlap) * (
        serial * (1.0 + 0.25 * max(0.0, pressure - 1.0))
    )
    launches = 2.0 if any_epilogue else 1.0
    return t_exec + max_ramp + launches * spec.launch_overhead_s


def _all_gemm(members) -> bool:
    return all(isinstance(d, GemmDesc) for d, _ in members)


def _compute_dtype(d) -> str:
    """Dtype an op computes in: `ScanDesc` stages in f32 whatever the model
    dtype; every other family computes at its dtype."""
    return getattr(d, "compute_dtype", d.dtype)


def _group_time_mixed(members, share: int, spec: TPUSpec) -> float:
    """Heterogeneous-family grouped launch: per-member family stats fed
    through the same overlap/pressure composition as the GEMM fold, each
    member at a 1/G share of the budget."""
    comps, mems, sers, wss, ramps = [], [], [], [], []
    any_epilogue = False
    for d, t in members:
        st = kernel_stats_batch(d, t, vmem_budget=share, spec=spec).item()
        peak = spec.peak(_compute_dtype(d))
        comps.append(st.flops / (peak * st.mxu_util))
        mems.append(st.hbm_bytes / spec.hbm_bw)
        ramps.append(spec.pipeline_fill_tiles
                     * (st.hbm_bytes / st.n_tiles / spec.hbm_bw))
        sers.append(max(comps[-1], mems[-1]))
        wss.append(st.vmem_bytes)
        any_epilogue = any_epilogue or st.splits > 1 or st.streams > 0
    return _compose_group_time(
        sum(comps), sum(mems), sum(sers), sum(wss), max(ramps),
        any_epilogue, spec,
    )


def _fold(x: np.ndarray) -> float:
    acc = 0.0
    for v in x:
        acc += float(v)
    return acc


# ------------------------------------------------------- non-GEMM families
# Flash attention, the grouped expert GEMM and the SSD scan reuse the
# `TileConfig` container with family meanings (attention: bm = q block,
# bn = kv block; grouped: a GEMM tile over each expert's rows; scan: bm =
# chunk length) and compose through the same rooflines as the GEMMs.
def _tile_dims(t):
    return np.asarray(t.bm), np.asarray(t.bn), np.asarray(t.bk)


def _attn_geom(d: AttentionDesc, t, spec: TPUSpec):
    """(bq, bkv, tq, tkv, ws, kv_panel) of the flash kernel: kv is the
    sequential inner sweep, q blocks × (B·Hq) the parallel grid."""
    bm, bn, _ = _tile_dims(t)
    bq = np.minimum(bm, _round_up(d.Sq, 8))
    bkv = np.minimum(bn, _round_up(d.Skv, spec.mxu_dim))
    tq = _cdiv(d.Sq, bq)
    tkv = _cdiv(d.Skv, bkv)
    ib = d.in_bytes
    # double-buffered K/V tiles + Q tile + online-softmax scratch
    # (m, l replicated to 128 lanes; f32 acc) + output tile.
    ws = (2 * (2 * bkv * d.D * ib) + bq * d.D * ib
          + (2 * bq * 128 + bq * d.D) * 4 + bq * d.D * ib)
    kv_panel = 2.0 * d.Skv * d.D * ib      # one head's K+V, residency unit
    return bq, bkv, tq, tkv, ws, kv_panel


def attention_stats_batch(
    d: AttentionDesc, t, vmem_budget=None, spec: TPUSpec = DEFAULT_SPEC,
) -> KernelStatsBatch:
    """O(Sq·Skv) attention with causal credit: FLOPs and K/V traffic
    scale by `causal_credit`; K/V residency in the share plays the GEMM
    A-panel role, and losing it re-reads K/V once per q block."""
    budget = spec.vmem_bytes if vmem_budget is None else vmem_budget
    bq, bkv, tq, tkv, ws, kv_panel = _attn_geom(d, t, spec)
    credit = d.causal_credit
    n_tiles = d.B * d.Hq * tq
    resid_frac = np.minimum(np.maximum(
        (budget - ws) / kv_panel, 0.0), 1.0)
    kv_resident = resid_frac >= 1.0
    eff_reads = tq - resid_frac * (tq - 1)
    kv_unit = d.B * d.Hkv * d.Skv * d.D * d.in_bytes * 2.0 * credit
    qo_bytes = 2.0 * d.B * d.Hq * d.Sq * d.D * d.in_bytes
    hbm = eff_reads * kv_unit + qo_bytes
    flops = 4.0 * d.B * d.Hq * (tq * bq) * (tkv * bkv) * d.D * credit
    util = (_align_eff(bq, spec.mxu_dim) * _align_eff(bkv, spec.mxu_dim)
            * _align_eff(d.D, spec.mxu_dim))
    slots = np.maximum(1, budget // ws)
    waves = n_tiles / np.minimum(slots, spec.pipeline_fill_tiles * 4)
    occ = np.minimum(1.0, (ws + resid_frac * kv_panel) / budget)
    EVAL_COUNTER.add(np.size(waves))
    return KernelStatsBatch(
        n_tiles=np.asarray(n_tiles), waves=np.asarray(waves),
        occupancy=np.asarray(occ),
        vmem_bytes=np.asarray(ws + np.where(kv_resident, kv_panel, 0.0)),
        hbm_bytes=np.asarray(hbm), flops=np.asarray(flops),
        mxu_util=np.asarray(util), a_resident=np.asarray(kv_resident),
        splits=np.ones_like(np.asarray(n_tiles)),
        streams=np.zeros_like(np.asarray(n_tiles)),
    )


def _grouped_geom(d: GroupedGemmDesc, t, spec: TPUSpec):
    """(bm, bn, bk, ws, a_panel) of the ragged expert pool; the
    per-expert row counts add an expert axis that `grouped_stats_batch`
    reduces, so the result broadcasts like every other family's."""
    bm, bn, bk = _tile_dims(t)
    mxu = spec.mxu_dim
    bm_c = np.minimum(bm, _round_up(d.M, mxu))
    bn_c = np.minimum(bn, _round_up(d.N, mxu))
    bk_c = np.minimum(bk, _round_up(d.K, mxu))
    ib = d.in_bytes
    ws = (2 * (bm_c * bk_c + bk_c * bn_c) * ib
          + bm_c * bn_c * 4 + bm_c * bn_c * ib)
    a_panel = bm_c * d.K * ib
    return bm_c, bn_c, bk_c, ws, a_panel


def grouped_stats_batch(
    d: GroupedGemmDesc, t, vmem_budget=None, spec: TPUSpec = DEFAULT_SPEC,
) -> KernelStatsBatch:
    """Ragged grouped GEMM: G experts, each expert's rows padded up to the
    bm block (the ragged launch's tail waste), the expert weights
    streamed once per m-tile sweep."""
    budget = spec.vmem_bytes if vmem_budget is None else vmem_budget
    bm_c, bn_c, bk_c, ws, a_panel = _grouped_geom(d, t, spec)
    rows = np.asarray(d.row_vector(), np.int64)
    base = np.broadcast_shapes(np.shape(bm_c), np.shape(ws),
                               np.shape(np.asarray(budget)))
    r = rows.reshape((d.G,) + (1,) * len(base))
    bm_e = np.minimum(bm_c, _round_up(np.maximum(r, 1), 8))
    tm = np.where(r > 0, _cdiv(np.maximum(r, 1), bm_e), 0)
    tn = _cdiv(d.N, bn_c)
    tk = _cdiv(d.K, bk_c)
    ib = d.in_bytes
    n_tiles = np.maximum((tm * tn).sum(0), 1)
    resid_frac = np.minimum(np.maximum(
        (budget - ws) / a_panel, 0.0), 1.0)
    a_resident = resid_frac >= 1.0
    eff_reads = tn - resid_frac * (tn - 1)
    a_unit = d.M * d.K * ib
    b_bytes = tm.sum(0) * (d.K * d.N * ib)
    c_bytes = d.M * d.N * ib
    hbm = eff_reads * a_unit + b_bytes + c_bytes
    flops = 2.0 * (tm * bm_e).sum(0) * (tn * bn_c) * (tk * bk_c)
    util = (_align_eff(bm_c, spec.mxu_dim) * _align_eff(bn_c, spec.mxu_dim)
            * _align_eff(bk_c, spec.mxu_dim))
    slots = np.maximum(1, budget // ws)
    waves = n_tiles / np.minimum(slots, spec.pipeline_fill_tiles * 4)
    occ = np.minimum(1.0, (ws + resid_frac * a_panel) / budget)
    EVAL_COUNTER.add(np.size(waves))
    return KernelStatsBatch(
        n_tiles=np.asarray(n_tiles), waves=np.asarray(waves),
        occupancy=np.asarray(occ),
        vmem_bytes=np.asarray(ws + np.where(a_resident, a_panel, 0.0)),
        hbm_bytes=np.asarray(hbm), flops=np.asarray(flops),
        mxu_util=np.asarray(util), a_resident=np.asarray(a_resident),
        splits=np.ones_like(np.asarray(n_tiles)),
        streams=np.zeros_like(np.asarray(n_tiles)),
    )


def _scan_geom(d: ScanDesc, t, spec: TPUSpec):
    """(L, n_chunks, ws): the chunk length L is the tunable axis (bm);
    the chunk sweep is sequential per (batch, head)."""
    bm, _, _ = _tile_dims(t)
    L = np.maximum(np.minimum(bm, _round_up(d.T, 8)), 8)
    n_chunks = _cdiv(d.T, L)
    ib = d.in_bytes                       # f32 staging (4 B)
    # double-buffered chunk inputs (xd, da, B, C) + state scratch + y out
    ws = 2 * (L * d.P + L + 2 * L * d.N) * ib + d.N * d.P * 4 + L * d.P * ib
    return L, n_chunks, ws


def scan_stats_batch(
    d: ScanDesc, t, vmem_budget=None, spec: TPUSpec = DEFAULT_SPEC,
) -> KernelStatsBatch:
    """Chunked SSD scan: bandwidth-bound streaming of (xd, da, B, C, y)
    with a sequential chunk sweep per (b, h), so parallelism is capped at
    B·H and waves floor at n_chunks whatever the share."""
    budget = spec.vmem_bytes if vmem_budget is None else vmem_budget
    L, n_chunks, ws = _scan_geom(d, t, spec)
    BH = d.B * d.H
    ib = d.in_bytes
    n_tiles = BH * n_chunks
    hbm = (BH * ((2 * d.T * d.P + d.T + 2 * d.T * d.N) * ib
                 + 2 * d.N * d.P * 4)) * np.ones_like(np.asarray(ws, float))
    flops = BH * n_chunks * (2.0 * L * L * (d.N + d.P) + 4.0 * L * d.N * d.P)
    util = (_align_eff(L, spec.mxu_dim) * _align_eff(d.N, spec.mxu_dim)
            * _align_eff(d.P, spec.mxu_dim))
    slots = np.maximum(1, budget // ws)
    # sequential chunk dim: at least n_chunks waves even with free slots
    waves = n_chunks * np.maximum(
        1.0, BH / np.minimum(slots, spec.pipeline_fill_tiles * 4))
    occ = np.minimum(1.0, ws / budget)
    EVAL_COUNTER.add(np.size(waves))
    return KernelStatsBatch(
        n_tiles=np.asarray(n_tiles), waves=np.asarray(waves),
        occupancy=np.asarray(occ), vmem_bytes=np.asarray(ws, float),
        hbm_bytes=np.asarray(hbm), flops=np.asarray(flops),
        mxu_util=np.asarray(util),
        a_resident=np.zeros(np.shape(np.asarray(ws)), bool),
        splits=np.ones_like(np.asarray(n_tiles)),
        streams=np.zeros_like(np.asarray(n_tiles)),
    )


_FAMILY_STATS = {
    "flash_attention": attention_stats_batch,
    "grouped_gemm": grouped_stats_batch,
    "mamba_scan": scan_stats_batch,
}


def op_tile_ws(d, t, spec: TPUSpec = DEFAULT_SPEC):
    """Raw per-instance working set of a (desc, tile) pair for any
    family — the tuner's feasibility predicate (``ws ≤ RC budget``)."""
    fam = family_of(d)
    if fam == "flash_attention":
        return _attn_geom(d, t, spec)[4]
    if fam == "grouped_gemm":
        return _grouped_geom(d, t, spec)[3]
    if fam == "mamba_scan":
        return _scan_geom(d, t, spec)[2]
    return t.vmem_bytes(d.in_bytes)


# ------------------------------------------------------------------ helpers
def _cdiv(a, b):
    return -(-a // b)


def _round_up(a, b):
    return _cdiv(a, b) * b


def _align_eff(dim, mxu):
    return dim / (_cdiv(dim, mxu) * mxu)


# --------------------------------------------------- self-calibration (§16)
@dataclass
class ClassCalibration:
    """Per-(family, compat-class) correction state: ``log_factor`` is the
    EWMA of log(achieved/modeled) (the correction is its exp), ``drift``
    the EWMA of |log(achieved/modeled)| against the raw model."""

    log_factor: float = 0.0
    drift: float = 0.0
    n: int = 0


class CostCalibrator:
    """Online multiplicative correction of the cost model (DESIGN.md §16):
    per-(family, compat-class) factors fitted from the modeled-vs-achieved
    ratios the runtime records, so selection can rank candidates by
    ``factor · modeled_time``.

    Updates are EWMAs in log space; the first sample initialises the
    state, so a constant bias is recovered at once.  Ratios make every
    statistic scale-invariant, and one factor applied to a whole class
    never flips an ordering within it.  `pop_stale` returns the classes
    whose ``drift`` exceeds ``drift_threshold`` (|log ratio| units: 0.35
    is a 1.4× gap) and resets their drift, so the caller queues one
    re-tune per excursion."""

    def __init__(self, alpha: float = 0.2, drift_threshold: float = 0.35):
        self.alpha = float(alpha)
        self.drift_threshold = float(drift_threshold)
        self._state: dict[tuple[str, str], ClassCalibration] = {}

    def update(self, family: str, class_key: str, modeled_s: float,
               achieved_s: float) -> None:
        """Fold one observation into the class's state; non-positive and
        non-finite times carry no ratio and are ignored."""
        if (modeled_s <= 0 or achieved_s <= 0
                or not (math.isfinite(modeled_s)
                        and math.isfinite(achieved_s))):
            return
        r = math.log(achieved_s / modeled_s)
        st = self._state.get((family, class_key))
        if st is None or st.n == 0:
            self._state[(family, class_key)] = ClassCalibration(
                log_factor=r, drift=abs(r), n=1)
            return
        a = self.alpha
        st.log_factor = (1.0 - a) * st.log_factor + a * r
        st.drift = (1.0 - a) * st.drift + a * abs(r)
        st.n += 1

    def factor(self, family: str, class_key: str) -> float:
        """Multiplicative correction of a class; 1.0 until observed."""
        st = self._state.get((family, class_key))
        return 1.0 if st is None or st.n == 0 else math.exp(st.log_factor)

    def correct(self, family: str, class_key: str, modeled_s: float) -> float:
        """``factor · modeled``; ``modeled_s`` itself (the same object) for
        a class with no observations."""
        st = self._state.get((family, class_key))
        if st is None or st.n == 0:
            return modeled_s
        return modeled_s * math.exp(st.log_factor)

    def __len__(self) -> int:
        return len(self._state)

    def stale_classes(self) -> list[tuple[str, str]]:
        """Classes whose drift EWMA exceeds the threshold, sorted."""
        return [k for k, st in sorted(self._state.items())
                if st.drift > self.drift_threshold]

    def pop_stale(self) -> list[tuple[str, str]]:
        """`stale_classes`, each with its drift reset (its factor kept), so
        one excursion queues one re-tune."""
        stale = self.stale_classes()
        for k in stale:
            self._state[k].drift = 0.0
        return stale

    def to_json(self) -> dict:
        return {
            "alpha": self.alpha,
            "drift_threshold": self.drift_threshold,
            "classes": {
                f"{fam}|{ck}": {"log_factor": st.log_factor,
                                "drift": st.drift, "n": st.n}
                for (fam, ck), st in sorted(self._state.items())
            },
        }

    @classmethod
    def from_json(cls, blob: dict) -> "CostCalibrator":
        cal = cls(alpha=blob.get("alpha", 0.2),
                  drift_threshold=blob.get("drift_threshold", 0.35))
        for key, st in blob.get("classes", {}).items():
            fam, ck = key.split("|", 1)
            cal._state[(fam, ck)] = ClassCalibration(
                log_factor=float(st["log_factor"]),
                drift=float(st["drift"]), n=int(st["n"]))
        return cal
