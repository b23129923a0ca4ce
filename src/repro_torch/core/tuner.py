"""Resource-constrained (RC) tuning, paper §4.2 (`repro/core/tuner.py`).

Step ① tunes each GEMM under the GPU, GPU/2 and GPU/4 budgets; Step ②
evaluates the per-RC winners at each concurrency degree and keeps the
fastest per CD — the GO tile.  Both steps are batched NumPy sweeps over
the cost model, identical to the reference's so entries match bitwise.

The candidate space keeps the reference's two work decompositions:
split-K (`TileConfig.split_k`) and Stream-K (`TileConfig.stream_k`,
candidates sized per CD by `stream_k_grid`).  The port plans them like
the reference, but its GEMM kernel does not run them yet: the serving
path launches them nowhere (grouped and ragged launches read only
bm/bn/bk, single launches use the isolated tile, which is never split).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.cost_model import (
    DEFAULT_SPEC,
    RC_FRACTIONS,
    DescBatch,
    TileBatch,
    TPUSpec,
    group_time,
    group_time_batch,
    isolated_time,
    isolated_time_batch,
    op_tile_ws,
    tile_precompute,
)
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.op_desc import family_of
from repro_torch.kernels.gemm.ops import TileConfig

# Tuned concurrency degrees (dense 2-8 so odd groups plan at their CD).
CDS = (2, 3, 4, 5, 6, 7, 8, 16)

CANDIDATE_TILES: tuple[TileConfig, ...] = tuple(
    TileConfig(bm, bn, bk)
    for bm in (8, 16, 32, 64, 128, 256, 512)
    for bn in (128, 256, 512)
    for bk in (128, 256, 512)
)

# Flash attention: bm = q block, bn = kv block (bk unused).  Small q blocks
# are the decode shapes; the kv axis trades K/V re-reads against the
# working set under a CD's share.
ATTENTION_TILES: tuple[TileConfig, ...] = tuple(
    TileConfig(bq, bkv, 128)
    for bq in (8, 64, 128, 256)
    for bkv in (128, 256, 512)
)

# Grouped (ragged MoE) GEMM: the GEMM axes; bm rows 8-64 dominate because
# per-expert row counts are tiny at decode time and the ragged launch pads
# every expert up to bm.
GROUPED_TILES: tuple[TileConfig, ...] = tuple(
    TileConfig(bm, bn, bk)
    for bm in (8, 16, 32, 64, 128)
    for bn in (128, 256, 512)
    for bk in (128, 256, 512)
)

# SSD scan: bm = chunk length L (bn/bk unused).  Long chunks amortize the
# sequential sweep, short ones shrink the working set.
SCAN_TILES: tuple[TileConfig, ...] = tuple(
    TileConfig(c, 128, 128) for c in (32, 64, 128, 256, 512)
)

FAMILY_TILES = {
    "gemm": CANDIDATE_TILES,
    "grouped_gemm": GROUPED_TILES,
    "flash_attention": ATTENTION_TILES,
    "mamba_scan": SCAN_TILES,
}

# Split-K enters at Step ② only; 1 first so argmin ties keep the
# un-split kernel.
SPLIT_K_CANDIDATES: tuple[int, ...] = (1, 2, 4, 8)

FALLBACK_TILE = TileConfig(128, 128, 128)

# Descs per sweep in `tune_gemm_batch` (bounds the sweep's peak memory).
_CHUNK = 512

_SEARCH = TileBatch.from_tiles(CANDIDATE_TILES)


def stream_k_grid(ws, share, spec: TPUSpec = DEFAULT_SPEC):
    """Stream-K workgroup budget for a tile working set under a share:
    as many workgroups as the share holds, capped at the pipeline slot
    ceiling and floored at 1.  Broadcasts."""
    return np.clip(np.asarray(share) // np.asarray(ws), 1,
                   spec.pipeline_fill_tiles * 4).astype(np.int64)


@dataclass
class GOEntry:
    """Library record: isolated kernel + GO kernel per concurrency degree.

    The measured fields are schema-v5 provenance, filled by
    `Measurer.rerank` (``tune_gemm(..., measure=)``) and carried through a
    library's save and load; the planner never reads them."""

    desc_key: str
    isolated: TileConfig
    go: Dict[int, TileConfig] = field(default_factory=dict)
    rc_source: Dict[int, str] = field(default_factory=dict)  # CD -> RC name
    speedup: Dict[int, float] = field(default_factory=dict)  # CD -> modeled
    family: str = "gemm"
    measured: Dict[int, float] = field(default_factory=dict)  # CD -> seconds
    measure_backend: Optional[str] = None
    measure_samples: int = 0
    measure_run_id: Optional[str] = None

    def tile_for_cd(self, cd: int) -> TileConfig:
        """GO tile for the largest tuned CD ≤ ``cd``; below the smallest
        tuned CD it falls forward to the nearest tuned CD."""
        if cd <= 1 or not self.go:
            return self.isolated
        key = max((c for c in self.go if c <= cd), default=None)
        if key is None:
            key = min(self.go)
        return self.go[key]

    def preferred_cd(self, threshold: float = 1.05) -> int:
        """Paper Fig. 7b: CD with max speedup over serial; <5% ⇒ sequential."""
        best_cd, best = 1, threshold
        for cd, sp in sorted(self.speedup.items()):
            if sp >= best:
                best, best_cd = sp, cd
        return best_cd


def tune_rc(desc: GemmDesc, frac: float,
            spec: TPUSpec = DEFAULT_SPEC) -> TileConfig:
    """Step ①: best tile under a resource-constrained configuration."""
    budget = int(spec.vmem_bytes * frac)
    feasible = _SEARCH.vmem_bytes(desc.in_bytes) <= budget
    if not feasible.any():
        return FALLBACK_TILE
    times = isolated_time_batch(
        desc, _SEARCH, spec, vmem_budget=budget, bw_frac=frac)
    return _SEARCH.tile(int(np.where(feasible, times, np.inf).argmin()))


def tune_gemm_batch(
    descs: Sequence[GemmDesc], spec: TPUSpec = DEFAULT_SPEC,
    cds: Sequence[int] = CDS,
) -> list[GOEntry]:
    """Step ① + Step ② for a whole pool of GEMMs in two model
    evaluations: ``(RC × descs × tiles)`` and ``(CDs × descs ×
    candidates)``, the candidates being each RC winner × split-K factor
    followed by one Stream-K variant per RC winner (so Stream-K only wins
    strictly)."""
    descs = list(descs)
    if not descs:
        return []
    if len(descs) > _CHUNK:
        out: list[GOEntry] = []
        for i in range(0, len(descs), _CHUNK):
            out += tune_gemm_batch(descs[i:i + _CHUNK], spec, cds)
        return out
    search, split_ks = _SEARCH, SPLIT_K_CANDIDATES
    cds = tuple(int(c) for c in cds)
    names = list(RC_FRACTIONS)
    fracs = np.asarray([RC_FRACTIONS[n] for n in names], np.float64)
    budgets = (spec.vmem_bytes * fracs).astype(np.int64)     # int() truncation

    db = DescBatch.from_descs(descs)
    d2 = DescBatch(**{k: getattr(db, k)[:, None] for k in
                      ("M", "N", "K", "batch", "in_bytes", "ta", "tb", "f32")})
    S = len(split_ks)

    # Step ①: (RC, desc, tile) sweep in one evaluation.
    pre = tile_precompute(d2, search, spec)
    times = isolated_time_batch(
        d2, search, spec, vmem_budget=budgets[:, None, None],
        bw_frac=fracs[:, None, None], pre=pre,
    )
    ws_raw = search.vmem_bytes(d2.in_bytes)                  # (D, T)
    times = np.where(ws_raw <= budgets[:, None, None], times, np.inf)
    idx = times.argmin(-1)                                   # (RC, D)
    min_t = np.take_along_axis(times, idx[..., None], -1)[..., 0]
    if np.isinf(min_t).any():
        # A fraction with no feasible tile: those descs take the
        # FALLBACK_TILE path per GEMM.
        bad = np.isinf(min_t).any(0)
        good = [d for i, d in enumerate(descs) if not bad[i]]
        fixed = {d.key(): _tune_gemm_infeasible(d, spec, cds)
                 for i, d in enumerate(descs) if bad[i]}
        good_entries = iter(tune_gemm_batch(good, spec, cds))
        return [fixed.get(d.key()) or next(good_entries) for d in descs]
    seq_1 = min_t[0]                                         # (D,)
    wbm, wbn, wbk = search.bm[idx], search.bn[idx], search.bk[idx]  # (RC, D)

    # Step ②: (CD, desc, candidate) sweep in one evaluation.
    cand_bm = np.repeat(wbm.T, S, axis=1)                    # (D, RC·S)
    cand_bn = np.repeat(wbn.T, S, axis=1)
    cand_bk = np.repeat(wbk.T, S, axis=1)
    cand_split = np.tile(np.asarray(split_ks, np.int64), len(names))
    R, D, C = len(names), len(descs), len(names) * S
    shares = np.asarray([spec.vmem_bytes // cd for cd in cds], np.int64)
    ws_win = ws_raw[np.arange(D)[None, :], idx]              # (RC, D)
    grids = stream_k_grid(ws_win[None], shares[:, None, None],
                          spec)                              # (CD, RC, D)
    grids = np.swapaxes(grids, 1, 2)                         # (CD, D, RC)
    full = {}
    for name, legacy, stream in (
        ("bm", cand_bm, wbm.T), ("bn", cand_bn, wbn.T), ("bk", cand_bk, wbk.T),
    ):
        full[name] = np.concatenate([
            np.broadcast_to(legacy, (len(cds),) + legacy.shape),
            np.broadcast_to(stream, (len(cds),) + stream.shape),
        ], axis=-1)
    split_full = np.concatenate([
        np.broadcast_to(cand_split, (len(cds), D, C)),
        np.ones((len(cds), D, R), np.int64),
    ], axis=-1)
    stream_full = np.concatenate([
        np.zeros((len(cds), D, C), np.int64), grids], axis=-1)
    tb2 = TileBatch(bm=full["bm"], bn=full["bn"], bk=full["bk"],
                    split_k=split_full, stream_k=stream_full)
    gt = group_time_batch(d2, tb2, cds, spec,
                          tiles_per_cd=True)                 # (CD, D, C+R)
    jj = gt.argmin(-1)                                       # (CD, D)
    best = np.take_along_axis(gt, jj[..., None], -1)[..., 0]

    entries: list[GOEntry] = []
    for i, d in enumerate(descs):
        e = GOEntry(
            desc_key=d.key(),
            isolated=TileConfig(int(wbm[0, i]), int(wbn[0, i]),
                                int(wbk[0, i])),
        )
        for ci, cd in enumerate(cds):
            j = int(jj[ci, i])
            if j < len(names) * S:
                e.go[cd] = TileConfig(int(cand_bm[i, j]), int(cand_bn[i, j]),
                                      int(cand_bk[i, j]), int(cand_split[j]))
                e.rc_source[cd] = names[j // S]
            else:
                r = j - len(names) * S
                e.go[cd] = TileConfig(int(wbm[r, i]), int(wbn[r, i]),
                                      int(wbk[r, i]),
                                      stream_k=int(grids[ci, i, r]))
                e.rc_source[cd] = names[r]
            e.speedup[cd] = (float(seq_1[i]) * cd) / float(best[ci, i])
        entries.append(e)
    return entries


def _tune_gemm_infeasible(desc: GemmDesc, spec: TPUSpec,
                          cds: Sequence[int]) -> GOEntry:
    """Per-GEMM path for descs where some RC fraction has no feasible
    tile (`tune_rc` substitutes FALLBACK_TILE)."""
    winners = {name: tune_rc(desc, frac, spec)
               for name, frac in RC_FRACTIONS.items()}
    entry = GOEntry(desc_key=desc.key(), isolated=winners["GPU"])
    seq_1 = isolated_time(desc, entry.isolated, spec)
    cand = [(name, replace(t, split_k=s))
            for name, t in winners.items() for s in SPLIT_K_CANDIDATES]
    for cd in cds:
        share = spec.vmem_bytes // cd
        cand_cd = cand + [
            (name, replace(t, split_k=1, stream_k=int(stream_k_grid(
                t.vmem_bytes(desc.in_bytes), share, spec))))
            for name, t in winners.items()
        ]
        row = group_time_batch(
            desc, TileBatch.from_tiles([t for _, t in cand_cd]), [cd],
            spec)[0]
        j = int(row.argmin())
        entry.go[cd] = cand_cd[j][1]
        entry.rc_source[cd] = cand_cd[j][0]
        entry.speedup[cd] = (seq_1 * cd) / float(row[j])
    return entry


def tune_gemm(desc: GemmDesc, spec: TPUSpec = DEFAULT_SPEC,
              cds: Sequence[int] = CDS, measure=None) -> GOEntry:
    """Step ① + Step ② for one GEMM (the batched sweep on a pool of one).
    ``measure`` (a `core.measure.Measurer`) adds the measured pass: the
    Step-② candidates are re-ranked by the measured time of the launch
    the scheduler would emit, and the entry carries the measured times
    and their provenance (`Measurer.rerank`)."""
    entry = tune_gemm_batch([desc], spec, cds)[0]
    if measure is not None:
        entry = measure.rerank(desc, entry, cds=cds)
    return entry


def tune_op(desc, spec: TPUSpec = DEFAULT_SPEC,
            cds: Sequence[int] = CDS, measure=None) -> GOEntry:
    """Step ① + Step ② for any family: the best tile per RC
    fraction on the family's tile axes, then per CD the fastest RC winner
    in a group of ``cd`` copies.  GEMMs take `tune_gemm`.  ``measure``
    as for `tune_gemm`."""
    fam = family_of(desc)
    if fam == "gemm":
        return tune_gemm(desc, spec, cds, measure=measure)
    search = TileBatch.from_tiles(FAMILY_TILES[fam])
    ws_raw = np.asarray(op_tile_ws(desc, search, spec))
    winners: Dict[str, TileConfig] = {}
    for name, frac in RC_FRACTIONS.items():
        budget = int(spec.vmem_bytes * frac)
        feasible = ws_raw <= budget
        if not feasible.any():
            winners[name] = FALLBACK_TILE
            continue
        times = isolated_time_batch(
            desc, search, spec, vmem_budget=budget, bw_frac=frac)
        winners[name] = search.tile(
            int(np.where(feasible, times, np.inf).argmin()))
    entry = GOEntry(desc_key=desc.key(), isolated=winners["GPU"], family=fam)
    seq_1 = isolated_time(desc, entry.isolated, spec)
    cand = list(winners.items())
    for cd in cds:
        best_name, best_tile, best_t = None, None, float("inf")
        for name, tile in cand:
            t = group_time([(desc, tile)] * cd, spec)
            if t < best_t:
                best_name, best_tile, best_t = name, tile, t
        entry.go[cd] = best_tile
        entry.rc_source[cd] = best_name
        entry.speedup[cd] = (seq_1 * cd) / best_t
    if measure is not None:
        entry = measure.rerank(desc, entry, cds=cds)
    return entry
