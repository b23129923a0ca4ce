"""Dynamic concurrency controller, paper §4.4 (`repro/core/scheduler.py`).

At dispatch time the controller inspects the pending-GEMM queue, pools
the head's compatible followers (§6.7 classes: same N, K, layouts and
dtype, any M), picks the concurrency degree — the logistic predictor's
(`core/predictor.py`) when the controller has one, else the GO library's
modeled speedups (``CD_exec = min(CD_preferred, available)``) — and emits
one launch per group: ``grouped`` (identical members), ``ragged``
(members differing in M) or ``single``.  `plan_mixed` co-schedules a
heterogeneous bundle (§14): each ``mixed`` group's members are distinct
GEMMs, each at its own per-CD GO tile.  `plan_shared_input` is the §6.11
fuse-vs-group policy for GEMMs sharing their input.  With a
`CostCalibrator` (§16) the controller ranks `plan_mixed`'s chunkings and
`plan_shared_input`'s choice by calibrated times, while every plan keeps
its raw modeled times.  Planning is the reference's logic unchanged, so
both packages produce identical `Schedule`s; `execute_schedule` runs one
through the port's kernels, a ``mixed`` group's members at once on CUDA
streams.  A bundle's members may be of any family — GEMMs, flash
attention, the MoE expert pool (a grouped expert GEMM), SSD scans — and
each runs through its family op (`_run_op`).  A pool of identical
non-GEMM ops planned per class becomes one ``mixed`` group, as in the
reference: no single kernel fuses them.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import CostCalibrator, group_time, isolated_time
from repro_torch.core.gemm_desc import TORCH_DTYPES, GemmDesc
from repro_torch.core.library import GOLibrary, default_library
from repro_torch.core.op_desc import family_of
from repro_torch.core.predictor import CLASSES, Predictor, op_features
from repro_torch.kernels.flash_attention.ops import (
    attention_buffers,
    attention_for_desc,
)
from repro_torch.kernels.gemm.ops import TileConfig, gemm, gemm_buffers
from repro_torch.kernels.grouped_gemm.ops import (
    grouped_buffers,
    grouped_for_desc,
    grouped_gemm,
    ragged_gemm,
)
from repro_torch.kernels.mamba_scan.ops import scan_desc_buffers, scan_for_desc

# CP overhead (paper §5.4/§6.5): queue inspect + predict + packet rewrite.
CP_OVERHEAD_S = 8e-6


@dataclass
class GemmRequest:
    """One op ticket.  A GEMM carries its operands in ``a`` (stored (M,K),
    or (K,M) when ``desc.ta``) and ``b`` ((K,N) or (N,K)); any other
    family carries them in ``inputs``, in its family op's positional
    order: (q, k, v) for attention, (a, b) for the expert pool (``b`` a
    stacked (G, K, N) tensor or a sequence of G (K, N) weights), (xd, da,
    Bm, Cm) for the SSD scan."""

    desc: GemmDesc
    a: Optional[torch.Tensor] = None
    b: Optional[torch.Tensor] = None
    tag: str = ""
    inputs: Optional[tuple] = None

    @property
    def operands(self) -> Optional[tuple]:
        """The family op's positional operands: ``(a, b)`` for a GEMM,
        ``inputs`` for any other family."""
        return (self.a, self.b) if family_of(self.desc) == "gemm" else self.inputs


# Non-GEMM requests are the same record; the alias marks intent at call
# sites that submit heterogeneous ops.
OpRequest = GemmRequest


def bind_operands(desc, operands: Optional[tuple] = None,
                  tag: str = "") -> GemmRequest:
    """The family-correct request for ``desc`` from a positional operand
    tuple: a GEMM's unpacks into ``a``/``b``, every other family's stays
    in ``inputs``; ``operands=None`` is an operand-free request."""
    if family_of(desc) == "gemm":
        a, b = operands if operands is not None else (None, None)
        return GemmRequest(desc=desc, a=a, b=b, tag=tag)
    return GemmRequest(desc=desc, tag=tag, inputs=operands)


@dataclass(frozen=True)
class OpFamily:
    """How the executor runs a member of one non-GEMM family:
    ``run(desc, *inputs, tile=, out=)``, and ``buffers(desc, *inputs,
    tile=)``, what ``run`` writes, for the caller to allocate (on the
    launching stream, before a mixed launch forks)."""

    run: Callable
    buffers: Callable


def _by_inputs(buffers: Callable) -> Callable:
    """The ``buffers`` hook of a family whose outputs depend only on its
    inputs."""
    return lambda desc, *inputs, tile=None: buffers(*inputs)


# Every family besides "gemm", whose requests carry ``a``/``b`` and which
# has launch modes of its own (grouped, ragged): flash attention, the
# grouped expert GEMM (the MoE pool, on the ragged kernel) and the SSD
# scan.  A family is admitted and executed iff it is "gemm" or a key here;
# its cost model and tile space are the reference's tables
# (`cost_model._FAMILY_STATS`, `tuner.FAMILY_TILES`).
OP_FAMILIES: Dict[str, OpFamily] = {
    "flash_attention": OpFamily(attention_for_desc, _by_inputs(attention_buffers)),
    "grouped_gemm": OpFamily(grouped_for_desc, grouped_buffers),
    "mamba_scan": OpFamily(scan_for_desc, scan_desc_buffers),
}


def requests_from_numpy(requests: Sequence[GemmRequest], operands,
                        device="cuda") -> List[GemmRequest]:
    """Bind numpy operand tuples to ``requests`` as tensors of each desc's
    dtype on ``device`` — how the tests feed the JAX package and the port
    the same numbers: ``(a, b)`` for a GEMM, the family op's inputs (q, the
    KV cache, the scan inputs) for any other.  Float arrays round to bf16
    by round-to-nearest-even, as JAX's ``astype`` does.  Raises when
    ``device`` is CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    out = []
    for r, ops in zip(requests, operands, strict=True):
        dt = TORCH_DTYPES[r.desc.dtype]
        tensors = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device, dt)
                        for x in ops)
        out.append(bind_operands(r.desc, tensors, r.tag))
    return out


@dataclass
class GroupPlan:
    indices: List[int]            # queue positions executed in this launch
    cd: int                       # concurrency degree of the launch
    tile: TileConfig
    mode: str                     # "grouped" | "ragged" | "single" | "mixed"
    modeled_time_s: float
    # per-member tiles of a "mixed" launch, aligned with ``indices``;
    # None for the single-tile modes
    tiles: Optional[List[TileConfig]] = None


@dataclass
class Schedule:
    groups: List[GroupPlan] = field(default_factory=list)
    cp_overhead_s: float = 0.0

    @property
    def modeled_time_s(self) -> float:
        return sum(g.modeled_time_s for g in self.groups)


def _compatible(a, b) -> bool:
    """Groupable in one ragged launch: same K/N/transposes/dtype, any M.
    Only plain GEMMs qualify."""
    if not (isinstance(a, GemmDesc) and isinstance(b, GemmDesc)):
        return False
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
    """Plans launches at each desc's preferred CD: the predictor's when
    one is given, else the library oracle's (the CD with the largest
    modeled speedup in its GO entry).  Modeled times use the library's
    spec.  A ``calibrator`` corrects modeled times at selection only
    (`_group_factor`): plans keep raw modeled times, so the ratios the
    runtime feeds back stay raw; ``None`` plans exactly as without one."""

    def __init__(self, library: GOLibrary | None = None,
                 predictor: Predictor | None = None, max_cd: int = 16,
                 calibrator: CostCalibrator | None = None):
        # `library or default_library()` would discard an empty library
        # (its __len__ makes it falsy) — compare to None.
        self.lib = library if library is not None else default_library()
        self.predictor = predictor
        self.spec = self.lib.spec
        self.max_cd = max_cd
        self.calibrator = calibrator
        # Dispatch-path memos: CD decisions and feature vectors per desc
        # key; invalidated when the library, spec or predictor changes.
        self._cd_cache: dict = {}
        self._feat_cache: dict = {}

    def invalidate_caches(self) -> None:
        """Drop memoized CD decisions and features (after swapping the
        library, spec or predictor)."""
        self._cd_cache.clear()
        self._feat_cache.clear()
        if self.predictor is not None:
            self.predictor.invalidate_cache()

    def _features(self, desc):
        key = desc.key()
        x = self._feat_cache.get(key)
        if x is None:
            x = op_features(desc, self.lib, self.spec)
            self._feat_cache[key] = x
        return x

    def preferred_cd(self, desc: GemmDesc, available: int) -> int:
        if available <= 1:
            return 1
        floor = max(c for c in CLASSES if c <= available)
        ck = (desc.key(), floor)
        cached = self._cd_cache.get(ck)
        if cached is not None:
            return cached
        if self.predictor is not None:
            cd = self.predictor.predict_cd_one(
                desc.key(), lambda: self._features(desc), available)
        else:
            cd = min(self.lib.get(desc).preferred_cd(), floor)
        self._cd_cache[ck] = cd
        return cd

    # -------------------------------------------------------- calibration
    def _group_factor(self, descs) -> float:
        """FLOPs-weighted geometric mean of the members' per-(family,
        compat-class) correction factors: the multiplier calibrated
        selection applies to a candidate group's modeled time.  1.0 with
        no calibrator or no observations."""
        cal = self.calibrator
        if cal is None:
            return 1.0
        num = den = 0.0
        for d in descs:
            f = cal.factor(family_of(d), compat_key(d))
            w = float(d.flops)
            if f != 1.0:
                num += w * math.log(f)
            den += w
        if num == 0.0 or den == 0.0:
            return 1.0
        return math.exp(num / den)

    def _corrected_time(self, groups: Sequence["GroupPlan"], descs) -> float:
        """Calibrated total time of ``groups`` over ``descs``, a selection
        metric only; with no calibrator every factor is 1.0, and the sum is
        the raw total, bitwise."""
        return sum(
            g.modeled_time_s * self._group_factor([descs[i] for i in g.indices])
            for g in groups)

    # --------------------------------------------------------------- plan
    def plan_group(
        self,
        descs: Sequence[GemmDesc],
        pending: Sequence[int],
        available: int | None = None,
    ) -> tuple[GroupPlan, List[int]]:
        """Plan exactly ONE launch from the head of ``pending``: pool the
        head's identical or compatible followers, pick the CD, and return
        the plan with the remaining pending indices.  A pool of identical
        non-GEMM ops is one ``mixed`` group at the CD's tile."""
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
        elif family_of(head) != "gemm":
            # independent launches (no kernel fuses them), modeled as a
            # mixed group
            mode = "mixed"
            t = group_time([(descs[i], tile) for i in take], self.spec)
        else:
            mode = "ragged" if hetero else "grouped"
            t = group_time([(descs[i], tile) for i in take], self.spec)
        gp = GroupPlan(indices=take, cd=cd_exec, tile=tile, mode=mode,
                       modeled_time_s=t,
                       tiles=[tile] * cd_exec if mode == "mixed" else None)
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

    def plan_mixed(
        self, descs: Sequence[GemmDesc], available: int | None = None,
        ranks: Sequence[int] | None = None,
    ) -> Schedule:
        """Co-schedule a heterogeneous bundle (§14): the members are
        distinct GEMMs that run at the same time on resource shares.
        Every class-size chunking of the bundle (in order, or stable-sorted
        by ``ranks``, lower = more urgent) is modeled and the fastest wins;
        each chunk of two or more is one ``mixed`` group whose members run
        at their own GO tile for the chunk's CD, a chunk of one a
        ``single`` launch at its isolated tile.  With a calibrator the
        chunkings are ranked by calibrated time; the winner keeps its raw
        modeled times."""
        sched = Schedule(cp_overhead_s=CP_OVERHEAD_S)
        n = len(descs)
        if n == 0:
            return sched
        cap = self.max_cd if available is None else max(
            1, min(self.max_cd, available))
        entries = [self.lib.get(d) for d in descs]
        order = (list(range(n)) if ranks is None
                 else sorted(range(n), key=lambda i: ranks[i]))

        def chunk_groups(size: int) -> List[GroupPlan]:
            groups = []
            for lo in range(0, n, size):
                take = order[lo:min(lo + size, n)]
                cd_exec = len(take)
                if cd_exec == 1:
                    i = take[0]
                    groups.append(GroupPlan(
                        indices=take, cd=1, tile=entries[i].isolated,
                        mode="single",
                        modeled_time_s=isolated_time(
                            descs[i], entries[i].isolated, self.spec)))
                    continue
                tiles = [entries[i].tile_for_cd(cd_exec) for i in take]
                members = [(descs[i], t) for i, t in zip(take, tiles)]
                groups.append(GroupPlan(
                    indices=take, cd=cd_exec, tile=tiles[0], mode="mixed",
                    modeled_time_s=group_time(members, self.spec),
                    tiles=tiles))
            return groups

        top = min(n, cap)
        sizes = sorted({c for c in CLASSES if c <= top} | {1}
                       | ({top} if top > 1 else set()))
        sched.groups = min((chunk_groups(s) for s in sizes),
                           key=lambda gs: self._corrected_time(gs, descs))
        return sched

    def plan_shared_input(
        self, descs: Sequence[GemmDesc]
    ) -> tuple[str, float, float]:
        """§6.11 policy for GEMMs sharing A and K: one wide fused GEMM or a
        concurrent group, whichever models faster.  Returns (choice,
        fused_time, grouped_time), the times raw; with a calibrator the
        choice is made on the corrected pair (the fused GEMM is in another
        compat class than the members, so a correction can flip it)."""
        head = descs[0]
        fused_desc = replace(head, N=sum(d.N for d in descs))
        fused_tile = self.lib.get(fused_desc).isolated
        t_fused = isolated_time(fused_desc, fused_tile, self.spec)
        sched = self.plan(descs)
        fused_c = t_fused * self._group_factor([fused_desc])
        choice = ("fuse" if fused_c <= self._corrected_time(sched.groups, descs)
                  else "group")
        return (choice, t_fused, sched.modeled_time_s)

    # ------------------------------------------------------------ execute
    def execute(self, requests: Sequence[GemmRequest]) -> List[torch.Tensor]:
        """Plan ``requests`` and run the plan through the kernels."""
        return self.execute_plan(requests, self.plan([r.desc for r in requests]))

    def execute_plan(self, requests: Sequence[GemmRequest],
                     sched: Schedule) -> List[torch.Tensor]:
        """Run a precomputed `Schedule` through the kernels, so a caller
        can replay a cached plan without planning again."""
        return execute_schedule(requests, sched)


def execute_schedule(
    requests: Sequence[GemmRequest],
    sched: Schedule,
) -> List[torch.Tensor]:
    """Run a `Schedule` through the kernels, one launch per group.

    ``grouped`` stacks the members' A and ``ragged`` concatenates their A
    rows, each padded with zeros to the tile's bm — the reference's
    launch shapes (`repro/core/scheduler.py:481-507`), a few MB at decode
    M.  Both hand the kernels each member's B where it lies, as the
    (K, N) view `_as_kn` gives (a transposed weight stays in its stored
    orientation), and copy no weight: the kernels take the members'
    weights by pointer (`kernels/grouped_gemm/kernel.py`).  The requests
    own those weights, and every launch is queued on the current stream,
    so a caller keeps the requests alive until that stream's work has
    run, as it does for any operand.  A ``mixed`` group runs each member
    through its family op at its own tile (`_run_mixed`), and a
    ``single`` launch of a non-GEMM member through `_run_op`."""
    outs: List[Optional[torch.Tensor]] = [None] * len(requests)
    for gp in sched.groups:
        reqs = [requests[i] for i in gp.indices]
        if gp.mode == "mixed":
            tiles = gp.tiles or [gp.tile] * len(reqs)
            for i, out in zip(gp.indices, _run_mixed(reqs, tiles)):
                outs[i] = out
        elif gp.mode == "single" or len(reqs) == 1:
            outs[gp.indices[0]] = _run_op(reqs[0], gp.tile)
        elif gp.mode == "grouped":
            a = torch.stack([_as_mk(r) for r in reqs])
            res = grouped_gemm(a, [_as_kn(r) for r in reqs], tile=gp.tile)
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
            res = ragged_gemm(torch.cat(rows), [_as_kn(r) for r in reqs], sizes,
                              tile=gp.tile)
            off = 0
            for j, i in enumerate(gp.indices):
                outs[i] = res[off: off + requests[i].desc.M]
                off += sizes[j]
        else:
            raise ValueError(f"launch mode {gp.mode!r} is not ported")
    return outs  # type: ignore[return-value]


# Side streams of mixed launches, per CUDA device: one per member up to the
# largest concurrency class, made at first use and kept.
_STREAMS: Dict[torch.device, List[torch.cuda.Stream]] = {}


def _member_streams(device: torch.device, n: int) -> List[torch.cuda.Stream]:
    """The first ``n`` side streams of ``device``'s pool (a group larger
    than the pool shares its streams round-robin)."""
    pool = _STREAMS.get(device)
    if pool is None:
        pool = _STREAMS[device] = [torch.cuda.Stream(device)
                                   for _ in range(max(CLASSES))]
    return [pool[j % len(pool)] for j in range(n)]


def join_member_streams(device: torch.device) -> None:
    """Make ``device``'s current stream wait for everything queued on its
    member streams.  After a mixed launch that raised part-way, the
    members already launched may still write buffers that were freed on
    the launching stream, whose allocator may hand them out again; the
    fallback ladder calls this before its next attempt."""
    launching = torch.cuda.current_stream(device)
    for s in _STREAMS.get(device, ()):
        launching.wait_stream(s)


def _run_mixed(reqs: Sequence[GemmRequest],
               tiles: Sequence[TileConfig]) -> List[Optional[torch.Tensor]]:
    """The members of one ``mixed`` group, each through its family op at
    its own tile; None for an operand-free member, before any device,
    buffer or stream work, as in the reference (`_run_op`).  The device
    is the first member's with operands; a group with none runs nothing.
    On the CPU the members run in order, as in the reference.  On the
    card they run at once, one side stream each: every buffer a member
    writes (outputs, Stream-K partials, attention's split partials and
    counters, a scan's final state and its chunked form's workspace, an
    expert pool's packed rows and ragged partials) is allocated on the
    launching stream first, the side streams wait on an event recorded
    there, and the launching stream waits on each member's end event
    before this returns — so no buffer is freed while a side stream
    still uses it, and work queued after the launch sees every result.
    The attention and scan kernels read their inputs through strides, so
    no member stages a copy on its side stream."""
    outs: List[Optional[torch.Tensor]] = [None] * len(reqs)
    live = [j for j, r in enumerate(reqs) if _has_operands(r)]
    if not live:
        return outs
    dev = reqs[live[0]].operands[0].device
    if dev.type != "cuda":
        for j in live:
            outs[j] = _run_op(reqs[j], tiles[j])
        return outs
    bufs = {j: gemm_buffers(reqs[j].a, reqs[j].b, ta=reqs[j].desc.ta,
                            tb=reqs[j].desc.tb, tile=tiles[j])
            if family_of(reqs[j].desc) == "gemm"
            else OP_FAMILIES[family_of(reqs[j].desc)].buffers(
                reqs[j].desc, *reqs[j].inputs, tile=tiles[j])
            for j in live}
    launching = torch.cuda.current_stream(dev)
    fork = torch.cuda.Event()
    fork.record(launching)
    ends = []
    for j, s in zip(live, _member_streams(dev, len(live))):
        s.wait_event(fork)
        with torch.cuda.stream(s):
            outs[j] = _run_op(reqs[j], tiles[j], bufs[j])
            end = torch.cuda.Event()
            end.record(s)
        ends.append(end)
    for end in ends:
        launching.wait_event(end)
    return outs


def _has_operands(r: GemmRequest) -> bool:
    return r.operands is not None and all(t is not None for t in r.operands)


def _run_op(r: GemmRequest, tile: TileConfig, out=None):
    """One member through its family op at ``tile``, writing into ``out``
    (its `gemm_buffers` or its family's ``buffers``) when given; None for
    an operand-free request, as in the reference
    (`repro/core/scheduler.py:519-550`)."""
    if not _has_operands(r):
        return None
    if family_of(r.desc) == "gemm":
        return gemm(r.a, r.b, ta=r.desc.ta, tb=r.desc.tb, tile=tile,
                    buffers=out)
    return OP_FAMILIES[family_of(r.desc)].run(r.desc, *r.inputs, tile=tile,
                                              out=out)


def _as_mk(r: GemmRequest) -> torch.Tensor:
    return r.a.T if r.desc.ta else r.a


def _as_kn(r: GemmRequest) -> torch.Tensor:
    return r.b.T if r.desc.tb else r.b
