"""Dynamic concurrency controller, paper §4.4 (`repro/core/scheduler.py`).

At dispatch time the controller inspects the pending-GEMM queue, pools
the head's compatible followers (§6.7 classes: same N, K, layouts and
dtype, any M), picks the concurrency degree from the GO library's
modeled speedups (``CD_exec = min(CD_preferred, available)``), and emits
one launch per group: ``grouped`` (identical members), ``ragged``
(members differing in M) or ``single``.  `plan_shared_input` is the §6.11
fuse-vs-group policy for GEMMs sharing their input.  Planning is the
reference's logic unchanged, so both packages produce identical
`Schedule`s; `execute_schedule` runs one through the port's kernels.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import group_time, isolated_time
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import GOLibrary, default_library
from repro_torch.core.op_desc import family_of
from repro_torch.core.tuner import CDS
from repro_torch.kernels.gemm.ops import TileConfig, gemm
from repro_torch.kernels.grouped_gemm.ops import grouped_gemm, ragged_gemm

# CP overhead (paper §5.4/§6.5): queue inspect + predict + packet rewrite.
CP_OVERHEAD_S = 8e-6

# Concurrency classes: 1 (sequential) and every tuned CD.
CLASSES = (1,) + tuple(CDS)


@dataclass
class GemmRequest:
    """One GEMM ticket: the descriptor and, when it executes, its operands
    (``a`` stored (M,K) or (K,M) when ``desc.ta``; ``b`` (K,N) or (N,K))."""

    desc: GemmDesc
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    tag: str = ""


def requests_from_numpy(requests: Sequence[GemmRequest], operands,
                        device="cuda") -> List[GemmRequest]:
    """Bind numpy operand pairs ``[(a, b), ...]`` to ``requests`` as
    tensors of each desc's dtype on ``device`` — how the tests feed the
    JAX package and the port the same numbers.  Float arrays round to
    bf16 by round-to-nearest-even, as JAX's ``astype`` does.  Raises when
    ``device`` is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    out = []
    for r, (a, b) in zip(requests, operands, strict=True):
        dt = r.desc.torch_dtype()
        out.append(replace(
            r, a=torch.from_numpy(np.ascontiguousarray(a)).to(device, dt),
            b=torch.from_numpy(np.ascontiguousarray(b)).to(device, dt)))
    return out


@dataclass
class GroupPlan:
    indices: List[int]            # queue positions executed in this launch
    cd: int                       # concurrency degree of the launch
    tile: TileConfig
    mode: str                     # "grouped" | "ragged" | "single"
    modeled_time_s: float


@dataclass
class Schedule:
    groups: List[GroupPlan] = field(default_factory=list)
    cp_overhead_s: float = 0.0

    @property
    def modeled_time_s(self) -> float:
        return sum(g.modeled_time_s for g in self.groups)


def _compatible(a: GemmDesc, b: GemmDesc) -> bool:
    """Groupable in one ragged launch: same K/N/transposes/dtype, any M."""
    return (
        a.N == b.N and a.K == b.K and a.ta == b.ta and a.tb == b.tb
        and a.dtype == b.dtype and a.batch == b.batch == 1
    )


@functools.lru_cache(maxsize=65536)
def compat_key(d) -> str:
    """Compatibility-class id: equal keys ⟺ plannable in one launch (§6.7).
    Batched GEMMs class by their full key (they pool with identical
    descriptors only).  Memoized: descriptors are frozen."""
    if family_of(d) != "gemm" or d.batch != 1:
        return d.key()
    return f"{d.N}_{d.K}_{int(d.ta)}{int(d.tb)}_{d.dtype}"


class ConcurrencyController:
    """Plans launches with the library-oracle CD: each desc's preferred CD
    is the one with the largest modeled speedup in its GO entry.  Modeled
    times use the library's spec."""

    def __init__(self, library: GOLibrary | None = None, max_cd: int = 16):
        # `library or default_library()` would discard an empty library
        # (its __len__ makes it falsy) — compare to None.
        self.lib = library if library is not None else default_library()
        self.spec = self.lib.spec
        self.max_cd = max_cd
        self._cd_cache: dict = {}

    def preferred_cd(self, desc: GemmDesc, available: int) -> int:
        if available <= 1:
            return 1
        floor = max(c for c in CLASSES if c <= available)
        ck = (desc.key(), floor)
        cached = self._cd_cache.get(ck)
        if cached is not None:
            return cached
        cd = min(self.lib.get(desc).preferred_cd(), floor)
        self._cd_cache[ck] = cd
        return cd

    # --------------------------------------------------------------- plan
    def plan_group(
        self,
        descs: Sequence[GemmDesc],
        pending: Sequence[int],
        available: int | None = None,
    ) -> tuple[GroupPlan, List[int]]:
        """Plan exactly ONE launch from the head of ``pending``: pool the
        head's identical or compatible followers, pick the CD, and return
        the plan with the remaining pending indices."""
        pending = list(pending)
        cap = self.max_cd if available is None else max(1, min(self.max_cd, available))
        head = descs[pending[0]]
        same = [i for i in pending if descs[i] == head]
        compat = [i for i in pending if _compatible(descs[i], head)]
        pool = same if len(same) >= len(compat) else compat
        hetero = pool is compat and len(compat) > len(same)

        cd = self.preferred_cd(head, available=min(len(pool), cap))
        if hetero:
            # §6.7: every unique member must prefer this CD, else split
            # into the homogeneous subset.
            uniq = {descs[i].key(): descs[i] for i in pool}
            if not all(
                self.preferred_cd(u, available=cd) >= cd
                for u in uniq.values()
            ):
                pool, hetero = same, False
                cd = self.preferred_cd(head, available=min(len(pool), cap))

        take = pool[: max(cd, 1)]
        cd_exec = len(take)
        entry = self.lib.get(head)
        tile = entry.tile_for_cd(cd_exec)
        if cd_exec == 1:
            mode = "single"
            tile = entry.isolated
            t = isolated_time(head, tile, self.spec)
        else:
            mode = "ragged" if hetero else "grouped"
            t = group_time([(descs[i], tile) for i in take], self.spec)
        gp = GroupPlan(indices=take, cd=cd_exec, tile=tile, mode=mode,
                       modeled_time_s=t)
        taken = set(take)
        return gp, [i for i in pending if i not in taken]

    def plan(
        self, descs: Sequence[GemmDesc], available: int | None = None
    ) -> Schedule:
        sched = Schedule(cp_overhead_s=CP_OVERHEAD_S)
        pending = list(range(len(descs)))
        while pending:
            gp, pending = self.plan_group(descs, pending, available=available)
            sched.groups.append(gp)
        return sched

    def plan_shared_input(
        self, descs: Sequence[GemmDesc]
    ) -> tuple[str, float, float]:
        """§6.11 policy for GEMMs sharing A and K: one wide fused GEMM or a
        concurrent group, whichever models faster.  Returns (choice,
        fused_time, grouped_time)."""
        head = descs[0]
        fused_desc = replace(head, N=sum(d.N for d in descs))
        fused_tile = self.lib.get(fused_desc).isolated
        t_fused = isolated_time(fused_desc, fused_tile, self.spec)
        t_group = self.plan(descs).modeled_time_s
        choice = "fuse" if t_fused <= t_group else "group"
        return (choice, t_fused, t_group)


def execute_schedule(
    requests: Sequence[GemmRequest],
    sched: Schedule,
) -> List[torch.Tensor]:
    """Run a `Schedule` through the kernels, one launch per group.

    ``grouped`` stacks the members' A and B and ``ragged`` stacks B and
    concatenates the members' A rows, each padded with zeros to the
    tile's bm — the reference's launch shapes (`repro/core/scheduler.py:
    481-507`).  Stacking B copies every member's weight once per launch;
    removing that copy is a later performance item."""
    outs: List[Optional[torch.Tensor]] = [None] * len(requests)
    for gp in sched.groups:
        reqs = [requests[i] for i in gp.indices]
        if gp.mode == "single" or len(reqs) == 1:
            r = reqs[0]
            outs[gp.indices[0]] = gemm(r.a, r.b, ta=r.desc.ta, tb=r.desc.tb,
                                       tile=gp.tile)
        elif gp.mode == "grouped":
            a = torch.stack([_as_mk(r) for r in reqs])
            b = torch.stack([_as_kn(r) for r in reqs])
            res = grouped_gemm(a, b, tile=gp.tile)
            for j, i in enumerate(gp.indices):
                outs[i] = res[j]
        elif gp.mode == "ragged":
            bm = gp.tile.bm
            rows, sizes = [], []
            for r in reqs:
                m = _as_mk(r)
                pad = (-m.shape[0]) % bm
                if pad:
                    m = torch.cat([m, m.new_zeros((pad, m.shape[1]))])
                rows.append(m)
                sizes.append(m.shape[0])
            a = torch.cat(rows)
            b = torch.stack([_as_kn(r) for r in reqs])
            res = ragged_gemm(
                a, b, torch.tensor(sizes, dtype=torch.int32, device=a.device),
                tile=gp.tile)
            off = 0
            for j, i in enumerate(gp.indices):
                outs[i] = res[off: off + requests[i].desc.M]
                off += sizes[j]
        else:
            raise ValueError(f"launch mode {gp.mode!r} is not ported")
    return outs  # type: ignore[return-value]


def _as_mk(r: GemmRequest) -> torch.Tensor:
    return r.a.T if r.desc.ta else r.a


def _as_kn(r: GemmRequest) -> torch.Tensor:
    return r.b.T if r.desc.tb else r.b
