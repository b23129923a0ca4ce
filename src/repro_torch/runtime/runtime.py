"""Online concurrent-GEMM serving runtime (`repro/runtime/runtime.py`).

- `submit()` admits a GEMM `GemmRequest` from a tenant into its
  compatibility class's queue (`core.scheduler.compat_key`), or a
  sequence of requests — a heterogeneous bundle such as one layer's
  decode-step ops (GEMMs, the attention read over the KV cache, the SSD
  state update; §14) — into the shared ``MIXED_CLASS`` queue, returning
  one ``"bundle"`` ticket over per-member tickets.  Attention and scan
  ops run only in bundles.  Each queue is kept in canonical order at
  admission, so its plan-cache signature never needs a re-sort.
- `flush()` serves every class whose head waited ``window_s``: it plans
  each queue through a plan cache keyed by the queue signature and the
  available slots (a hit costs zero cost-model evaluations) — class
  queues with `ConcurrencyController.plan`, the bundle queue with
  `plan_mixed` — interleaves the classes' launches round-robin, and
  advances a modeled device timeline.  With ``RuntimeConfig.execute``
  each launch also runs through the kernels.
- `drain()` force-flushes until the queues are empty.

Two departures from the reference.  There is no fallback ladder: a
launch that raises, or whose output is not finite, raises to the caller
(the ladder, fault injection and quarantine are later items of the
port).  And an executed launch's achieved time is device time: on the
card it is read from CUDA events after a synchronise, since the host
clock after an asynchronous launch would time only the enqueue.  A
``mixed`` launch's time runs from its fork onto the member streams to
its join.  Slicing, EDF ranks and graph submission are not ported.
"""
from __future__ import annotations

import bisect
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import EVAL_COUNTER
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.op_desc import family_of
from repro_torch.core.scheduler import (
    CP_OVERHEAD_S,
    OP_FAMILIES,
    ConcurrencyController,
    GemmRequest,
    GroupPlan,
    Schedule,
    compat_key,
    execute_schedule,
)
from repro_torch.runtime.telemetry import GroupRecord, Telemetry

Signature = Tuple[Tuple[str, ...], int]

# Class key of the heterogeneous-bundle queue (§14).  "!" never occurs in
# a `compat_key`, so bundle tickets never share a class queue, and the
# marker leads the queue's plan-cache signatures, so a bundle of GEMMs
# never aliases a class queue's cached plan.
MIXED_CLASS = "mixed!"


class NonFiniteOutput(RuntimeError):
    """An executed launch produced a NaN or an infinity."""


def resolve_device(device) -> torch.device:
    """``device`` as a concrete `torch.device`; raises when it names CUDA
    and there is none (no entry point carries on on the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               "available; pass device='cpu' to run the "
                               "plain versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass
class RuntimeConfig:
    window_s: float = 2e-3          # batching window before a class is ripe
    plan_cache_capacity: int = 512  # LRU entries (queue signatures)
    execute: bool = False           # run launches through the kernels


@dataclass
class Ticket:
    """Handle of one submitted request, or (``kind="bundle"``) of a
    submitted sequence: its ``members`` are the per-request tickets, and
    it completes with its last member."""

    seq: int
    tenant: str
    request: Optional[GemmRequest]
    submit_t: float
    done_t: Optional[float] = None
    result: Optional[torch.Tensor] = None   # set when executed
    plan: Optional[GroupPlan] = None
    kind: str = "op"                        # "op" | "bundle"
    agg: Optional["Ticket"] = field(default=None, repr=False)
    members: Optional[List["Ticket"]] = field(default=None, repr=False)

    @property
    def desc(self) -> GemmDesc:
        return self.request.desc

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_t is None else self.done_t - self.submit_t

    @property
    def done(self) -> bool:
        if self.members is not None:
            return all(m.done_t is not None for m in self.members)
        return self.done_t is not None

    def __getitem__(self, i: int) -> "Ticket":
        """A bundle's member ticket by position."""
        if self.members is None:
            raise TypeError(f"{self.kind!r} ticket has no members")
        return self.members[i]


@dataclass
class Launch:
    """One bound group: a `GroupPlan` applied to live tickets."""

    plan: GroupPlan
    tickets: List[Ticket]
    class_key: str
    cache_hit: bool
    start_t: float = 0.0
    end_t: float = 0.0


class _ClassQueue:
    """One class's pending tickets in canonical order (bisect insertion at
    admission, ties by arrival), with the signature's key list kept as a
    parallel array so `flush()` never sorts."""

    __slots__ = ("tickets", "keys", "_orders", "oldest_t")

    def __init__(self) -> None:
        self.tickets: List[Ticket] = []
        self.keys: List[str] = []
        self._orders: List[tuple] = []
        self.oldest_t = float("inf")

    def add(self, ticket: Ticket) -> None:
        order = _canonical_order(ticket.desc)
        i = bisect.bisect_right(self._orders, order)
        self._orders.insert(i, order)
        self.tickets.insert(i, ticket)
        self.keys.insert(i, ticket.desc.key())
        if ticket.submit_t < self.oldest_t:
            self.oldest_t = ticket.submit_t

    def take_all(self) -> tuple[List[Ticket], tuple]:
        tickets, keys = self.tickets, tuple(self.keys)
        self.tickets, self.keys, self._orders = [], [], []
        self.oldest_t = float("inf")
        return tickets, keys

    def __len__(self) -> int:
        return len(self.tickets)


class Runtime:
    def __init__(
        self,
        controller: ConcurrencyController | None = None,
        config: RuntimeConfig | None = None,
        clock=time.monotonic,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.ctrl = controller or ConcurrencyController()
        self.config = config or RuntimeConfig()
        self.telemetry = Telemetry()
        self.clock = clock
        # available slots: CD_exec = min(CD_preferred, available); part of
        # the plan-cache key
        self.available = self.ctrl.max_cd
        self.device_free_t = 0.0
        self._queues: Dict[str, _ClassQueue] = {}
        self._rr = 0                    # round-robin cursor over class order
        self._order: List[str] = []     # class keys in first-seen order
        self._plan_cache: "OrderedDict[Signature, Schedule]" = OrderedDict()
        self._seq = 0
        self._flush_id = 0

    # ------------------------------------------------------------- admit
    def submit(
        self,
        work,
        tenant: str = "default",
        now: float | None = None,
    ) -> Ticket:
        """Admit one GEMM into its class queue, or a sequence of ops of any
        ported family — a heterogeneous bundle — into the shared
        ``MIXED_CLASS`` queue, which `flush` plans with
        `ConcurrencyController.plan_mixed`.  Returns one ticket: the op's,
        or a ``"bundle"`` handle over the members' tickets.  Operands,
        where given, lie on the runtime's device; with
        ``RuntimeConfig.execute`` every request carries its operands, and
        a GEMM is a plain (batch 1) one: batched GEMMs have no kernel
        yet."""
        now = self.clock() if now is None else now
        if isinstance(work, (list, tuple)):
            return self._submit_bundle(work, tenant, now)
        request = self._admissible(work)
        if family_of(request.desc) != "gemm":
            raise ValueError(f"{request.desc.key()}: a {request.desc.family} "
                             "op runs in a bundle; submit a sequence")
        key = compat_key(request.desc)
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = _ClassQueue()
            self._order.append(key)
        return self._admit(q, request, tenant, now)

    def _submit_bundle(self, work: Sequence, tenant: str, now: float) -> Ticket:
        """Every member is one logical request (its own latency); the
        returned handle completes with the last of them."""
        requests = [self._admissible(r) for r in work]
        q = self._queues.get(MIXED_CLASS)
        if q is None:
            q = self._queues[MIXED_CLASS] = _ClassQueue()
            self._order.append(MIXED_CLASS)
        members = [self._admit(q, r, tenant, now) for r in requests]
        self._seq += 1
        handle = Ticket(seq=self._seq, tenant=tenant, request=None,
                        submit_t=now, kind="bundle", members=members)
        for m in members:
            m.agg = handle
        return handle

    def _admissible(self, request: GemmRequest) -> GemmRequest:
        """Check a request before admission: a ported family; with
        ``execute``, its operands (a GEMM's ``a``/``b``, another family's
        ``inputs``); every operand on the runtime's device."""
        fam = family_of(request.desc)
        if fam != "gemm" and fam not in OP_FAMILIES:
            raise NotImplementedError(
                f"{request.desc.key()}: the {fam} family is not ported")
        operands = request.operands
        if self.config.execute:
            if operands is None or any(t is None for t in operands):
                raise ValueError(f"{request.desc.key()}: an executing "
                                 "runtime needs the request's operands")
            if fam == "gemm" and request.desc.batch != 1:
                raise NotImplementedError(
                    f"{request.desc.key()}: batched GEMMs have no kernel "
                    "in the port yet")
        for t in operands or ():
            if t is not None and t.device != self.device:
                raise ValueError(f"operand on {t.device}, runtime on "
                                 f"{self.device}")
        return request

    def _admit(self, q: "_ClassQueue", request: GemmRequest, tenant: str,
               now: float) -> Ticket:
        self._seq += 1
        ticket = Ticket(seq=self._seq, tenant=tenant, request=request,
                        submit_t=now)
        q.add(ticket)
        self.telemetry.record_submit()
        return ticket

    def set_available(self, n: int) -> None:
        """Set the live available parallelism (slots other work holds are
        not available).  Part of the plan-cache key, so a plan made for
        another count is never reused."""
        self.available = max(1, int(n))

    def queue_depths(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self._queues.items() if q}

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------ prewarm
    def prewarm(self, descs: Sequence[GemmDesc]) -> int:
        """Tune a catalog of GEMMs ahead of traffic and seed each class's
        all-at-once plan; returns the number of newly tuned entries.
        Planning here is billed as prewarm overhead, not as a miss."""
        descs = list(descs)
        fresh = self.ctrl.lib.prewarm(descs)
        for key in {compat_key(d) for d in descs}:
            members = self._canonical_sort(
                [d for d in descs if compat_key(d) == key])
            _, hit = self._plan_for_keys(
                tuple(d.key() for d in members), lambda: members)
            if not hit:
                self.telemetry.record_prewarm_plan(CP_OVERHEAD_S)
        return fresh

    def prewarm_bundle(self, descs: Sequence) -> int:
        """Tune a bundle's ops (any ported family) ahead of traffic and seed
        the plan cache
        with its ``MIXED_CLASS`` signature, so the first flush of the same
        co-submitted set is a cache hit; returns the newly tuned entries."""
        descs = list(descs)
        fresh = self.ctrl.lib.prewarm(descs)
        if descs:
            self._seed_mixed_plan(descs)
        return fresh

    def _seed_mixed_plan(self, descs: List[GemmDesc]) -> None:
        """Derive (and cache) the mixed-queue plan of one co-submitted
        desc set, billed as prewarm overhead."""
        members = self._canonical_sort(descs)
        _, hit = self._plan_for_keys(
            (MIXED_CLASS,) + tuple(d.key() for d in members),
            lambda: members, planner=self.ctrl.plan_mixed)
        if not hit:
            self.telemetry.record_prewarm_plan(CP_OVERHEAD_S)

    # -------------------------------------------------------------- flush
    def flush(self, now: float | None = None, force: bool = False) -> List[Launch]:
        """Serve every ripe class (head waited ≥ window_s), starting after
        the last serviced class, with the classes' launches interleaved."""
        now = self.clock() if now is None else now
        evals0 = EVAL_COUNTER.evals
        resorts0 = self.telemetry.sig_resorts
        ripe = [
            k for k in self._order
            if self._queues.get(k)
            and (force or now - self._queues[k].oldest_t >= self.config.window_s)
        ]
        if not ripe:
            return []
        self._flush_id += 1
        self.telemetry.record_flush(self.queue_depths())

        start = self._rr % max(len(self._order), 1)
        rotated = [k for k in self._order[start:] + self._order[:start]
                   if k in ripe]
        self._rr = (self._order.index(rotated[0]) + 1) % len(self._order)

        per_class: List[List[Launch]] = []
        planning_s = 0.0
        for key in rotated:
            tickets, sig_keys = self._queues[key].take_all()
            if key == MIXED_CLASS:
                sched, hit = self._plan_for_keys(
                    (MIXED_CLASS,) + sig_keys,
                    lambda: [t.desc for t in tickets],
                    planner=self.ctrl.plan_mixed)
            else:
                sched, hit = self._plan_for_keys(
                    sig_keys, lambda: [t.desc for t in tickets])
            self.telemetry.record_plan(hit, CP_OVERHEAD_S)
            if not hit:
                planning_s += CP_OVERHEAD_S
            per_class.append([
                Launch(plan=gp, tickets=[tickets[i] for i in gp.indices],
                       class_key=key, cache_hit=hit)
                for gp in sched.groups
            ])
        launches = _interleave(per_class)

        # Modeled single-device timeline: planning (cache misses) delays
        # dispatch on an idle device and hides behind prior kernels.
        t = max(self.device_free_t, now + planning_s)
        for launch in launches:
            launch.start_t = t
            achieved = self._execute(launch) if self.config.execute else None
            t += launch.plan.modeled_time_s
            launch.end_t = t
            for ticket in launch.tickets:
                ticket.done_t = launch.end_t
                ticket.plan = launch.plan
                self.telemetry.record_latency(ticket.tenant, ticket.latency_s)
                agg = ticket.agg
                if agg is not None and agg.done_t is None and agg.done:
                    agg.done_t = max(m.done_t for m in agg.members)
            # §6.11 fusion happens before admission (one wide request with
            # a "-fused" tag); surface it in telemetry instead of "single".
            mode = launch.plan.mode
            if mode == "single" and launch.tickets[0].request.tag.endswith("-fused"):
                mode = "fused"
            self.telemetry.record_group(GroupRecord(
                flush_id=self._flush_id,
                class_key=launch.class_key,
                tenants=[tk.tenant for tk in launch.tickets],
                cd=launch.plan.cd,
                mode=mode,
                modeled_time_s=launch.plan.modeled_time_s,
                achieved_time_s=achieved,
                cache_hit=launch.cache_hit,
            ))
        if launches:
            self.device_free_t = t
        self.telemetry.record_flush_fastpath(
            EVAL_COUNTER.evals - evals0,
            self.telemetry.sig_resorts - resorts0,
        )
        return launches

    def drain(self, now: float | None = None) -> List[Launch]:
        """Force-flush until every queue is empty."""
        out: List[Launch] = []
        cur = self.clock() if now is None else now
        while self.pending():
            out += self.flush(now=cur, force=True)
        return out

    # ---------------------------------------------------------- internals
    def _plan_for_keys(self, keys: tuple, descs_fn, planner=None
                       ) -> tuple[Schedule, bool]:
        """Plan-cache probe; ``descs_fn`` materializes the descriptors only
        on a miss, so a hit touches neither the planner nor the model.
        ``planner`` replaces the per-class `ConcurrencyController.plan`
        (the bundle queue plans with `plan_mixed`)."""
        sig: Signature = (keys, self.available)
        cached = self._plan_cache.get(sig)
        if cached is not None:
            self._plan_cache.move_to_end(sig)
            return cached, True
        plan = planner if planner is not None else self.ctrl.plan
        sched = plan(descs_fn(), available=self.available)
        self._plan_cache[sig] = sched
        while len(self._plan_cache) > self.config.plan_cache_capacity:
            self._plan_cache.popitem(last=False)
        return sched, False

    def _canonical_sort(self, descs: Sequence[GemmDesc]) -> List[GemmDesc]:
        """Canonical order of a desc list that did not come through an
        admission-sorted queue (prewarm); every call is counted."""
        self.telemetry.record_sig_resort()
        return sorted(descs, key=_canonical_order)

    def _execute(self, launch: Launch) -> float:
        """Run one launch through the kernels; returns its device time in
        seconds (host time on the CPU)."""
        reqs = [t.request for t in launch.tickets]
        mini = Schedule(groups=[replace(
            launch.plan, indices=list(range(len(reqs))))])
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = execute_schedule(reqs, mini)
            end.record()
            end.synchronize()
            achieved = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            outs = execute_schedule(reqs, mini)
            achieved = time.perf_counter() - t0
        for o in outs:
            if not bool(torch.isfinite(o).all()):
                raise NonFiniteOutput(
                    f"{launch.plan.mode} launch at tile {launch.plan.tile.key()} "
                    "produced non-finite output")
        for ticket, out in zip(launch.tickets, outs):
            ticket.result = out
        return achieved

    @property
    def plan_cache_size(self) -> int:
        return len(self._plan_cache)


def _canonical_order(d: GemmDesc) -> tuple:
    """Stable within-class ordering (largest M first) so equal queue
    contents produce equal signatures regardless of arrival order."""
    return (-d.M, d.key())


def _interleave(per_class: List[List[Launch]]) -> List[Launch]:
    """Round-robin merge: class A group 1, class B group 1, …, A2, B2, …"""
    out: List[Launch] = []
    i = 0
    while True:
        row = [groups[i] for groups in per_class if i < len(groups)]
        if not row:
            return out
        out += row
        i += 1
