"""Online concurrent-GEMM serving runtime (`repro/runtime/runtime.py`).

- `submit()` admits a GEMM `GemmRequest` from a tenant into its
  compatibility class's queue (`core.scheduler.compat_key`), or a
  sequence of requests — a heterogeneous bundle such as one layer's
  decode-step ops (GEMMs, the attention read over the KV cache, the MoE
  expert pool, the SSD state update; §14) — into the shared
  ``MIXED_CLASS`` queue, returning one ``"bundle"`` ticket over
  per-member tickets, or an `OpGraph` (`runtime/graph.py`): its ready
  frontier enters the ``MIXED_CLASS`` queue, each dependent follows
  when its producers complete, their outputs wired into its operand
  slots, and one ``"graph"`` ticket, one logical request, holds a ticket
  per node.  A lone attention, expert-pool or scan op enters its own
  class queue, as a GEMM does, and a pool of identical ones is planned
  as one ``mixed`` group.  A grouped request's expert weights may be one
  stacked (G, K, N) tensor or a sequence of G (K, N) tensors; every
  operand walk here takes both.  Each queue is kept in canonical order
  at admission, so its plan-cache signature never needs a re-sort.
- `flush()` serves every class whose head waited ``window_s``: it plans
  each queue through a plan cache keyed by the queue signature and the
  available slots (a hit costs zero cost-model evaluations) — class
  queues with `ConcurrencyController.plan`, the bundle queue with
  `plan_mixed`, which so fills each concurrency window with the ready
  nodes of every live graph — interleaves the classes' launches
  round-robin, and advances a modeled device timeline.  A released
  node's submit time is its producers' completion on that timeline, so
  with ``window_s > 0`` it waits for a later flush.  With
  ``RuntimeConfig.execute`` each launch also runs through the kernels.
- `drain()` force-flushes until the queues are empty.

Tenants have service objectives (`TenantSLO`, `set_tenant_slo`): each
submit gets an absolute deadline (``now + p99_target_s``) and a rank
(latency tenants 0, batch tenants 1).  With the defaults of
`RuntimeConfig` none of it changes a plan or the timeline:

- ``slicing`` with a ``flush_budget_s``: admission cuts an op whose
  modeled isolated time exceeds ``flush_budget_s · slice_budget_frac``
  into just enough pieces to fit (at most ``max_slices``; `slice_plan`):
  GEMM rows, attention query rows (prefill) or batch, an expert pool's
  experts (with their rows and weights), scan batch.  Only the pieces
  enter the queues; the caller holds the parent, which
  completes with its last piece and whose result is the pieces' outputs
  concatenated (`SlicePlan.merge`, a new tensor: the pieces keep
  theirs).  A piece of a GEMM stored transposed (``ta``) gets its own
  copy of its columns of ``a``, one allocation a piece, because the
  column view is not contiguous and the card's GEMM launchers refuse it
  (ROADMAP C10); every other piece's operands are views.
- ``policy="edf"``: ripe classes are served earliest deadline first
  (heavier tenant weight breaks ties); launches run by their members'
  earliest deadline, then weight, then arrival; the bundle queue is
  planned with its members' ranks (`plan_mixed(ranks=)`), which then
  join its plan-cache signature.
- ``flush_budget_s``: a commit horizon.  A flush binds launches only
  until the modeled device is committed through ``now + flush_budget_s``
  (at least one launch if the device is not committed past it already);
  the rest return to their queues with their deadlines (`_requeue`), to
  be ordered against later arrivals.  `drain` advances its clock to the
  commit edge when a flush binds nothing.  Each piece adds
  `SLICE_OVERHEAD_S` to its launch's modeled time (`_launch_cost`).

The runtime corrects itself online, as the reference does:

- with a `CostCalibrator` on the controller, every launch that completed
  on its planned rung feeds its class's modeled-vs-achieved ratio
  (`_feed_calibration`; bundle launches do not, a mixed group's time
  belonging to no one class), and classes that drift are queued for a
  re-tune, which `process_retunes` runs between traffic;
- every executed launch goes down the fallback ladder until it completes
  (`_execute_resilient`): the planned schedule, ``max_retries`` retries,
  the group at its members' isolated tiles (legacy), then the reference
  rung; a `FaultInjector` can make launches fail on purpose, and a tile
  that fails ``quarantine_strikes`` times in a row is quarantined in the
  library until a probe after ``quarantine_cooldown_s``.

Departures from the reference:

- An executed launch's achieved time is device time: on the card it is
  read from CUDA events around each attempt after a synchronise, since
  the host clock after an asynchronous launch would time only the
  enqueue.  A ``mixed`` launch's time runs from its fork onto the member
  streams to its join.  It is the time of the attempt that completed.
- The reference rung is a schedule of one ``single`` group per member,
  at its own entry's isolated tile, run in order on the launching stream
  by `execute_schedule` itself: the hand-written kernels on the card
  (the plain versions on the CPU, as everywhere in the port).  The
  reference's runs XLA's reference ops (``force_ref``), every member at
  the plan's first tile.  The injector never touches the rung and its
  output is not vetoed for non-finite values.
- The ladder handles faults, not refusals: it catches only `LaunchFault`
  (injected faults, stalls, non-finite outputs) and `KernelLaunchError`
  (a launch whose CUDA status is not 0), where the reference catches any
  exception.  A refused call (a shape, split or layout a kernel does not
  take), an unported family and a failed build raise at once, with no
  strike.  A sticky CUDA error fails every rung and raises from the
  reference rung.  As in the reference, an error raised out of a flush
  leaves that flush's later launches unrun: their tickets, and the
  dependents of the graph nodes among them, never complete, and a
  later `drain` serves only what is still queued.
- An executing runtime refuses a request without its operands at
  `submit`, where the reference runs it in shadow mode and gives None.
  For a graph the check covers every node: its static operands and the
  slots data edges feed must fill every slot of its family, and every
  static operand must lie on the runtime's device; else `submit` raises
  a ValueError naming the node and the slot, before anything is
  queued, so no check fires halfway through a flush.

`set_mesh` derates to a mesh's per-shard budget (`dist/resources.py`);
it reads only the mesh's axis names and sizes.
"""
from __future__ import annotations

import bisect
import math
import time
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.cost_model import (
    EVAL_COUNTER,
    SLICE_OVERHEAD_S,
    isolated_time,
)
from repro_torch.core.device import resolve_device
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import GOLibrary
from repro_torch.core.op_desc import SlicePlan, family_of, slice_plan
from repro_torch.core.scheduler import (
    CP_OVERHEAD_S,
    OP_FAMILIES,
    ConcurrencyController,
    GemmRequest,
    GroupPlan,
    Schedule,
    bind_operands,
    compat_key,
    execute_schedule,
    join_member_streams,
)
from repro_torch.kernels.gemm.kernel import KernelLaunchError
from repro_torch.runtime.faults import (
    CircuitBreaker,
    FaultInjector,
    LaunchFault,
    NonFiniteOutput,
    fault_kind,
)
from repro_torch.runtime.graph import (
    FAMILY_SLOTS,
    GraphState,
    OpGraph,
    operand_shape,
    slot_shape,
)
from repro_torch.runtime.telemetry import GroupRecord, Telemetry

Signature = Tuple[Tuple[str, ...], int]

# Class key of the heterogeneous-bundle queue (§14).  "!" never occurs in
# a `compat_key`, so bundle tickets never share a class queue, and the
# marker leads the queue's plan-cache signatures, so a bundle of GEMMs
# never aliases a class queue's cached plan.
MIXED_CLASS = "mixed!"


@dataclass
class RuntimeConfig:
    window_s: float = 2e-3          # batching window before a class is ripe
    plan_cache_capacity: int = 512  # LRU entries (queue signatures)
    execute: bool = False           # run launches through the kernels
    # Tenant objectives; the defaults are round-robin service, no
    # admission slicing and unbounded flushes.
    policy: str = "round-robin"     # "round-robin" | "edf"
    slicing: bool = False           # slice oversized ops at admission
    flush_budget_s: float | None = None  # modeled commit horizon of a flush
    slice_budget_frac: float = 0.5  # slice when iso time > budget * frac
    max_slices: int = 8             # admission never slices finer than this
    # The fallback ladder; the healthy path is the same whatever they are.
    max_retries: int = 1            # same-plan retries before re-planning
    quarantine_strikes: int = 3     # consecutive failures → quarantine
    quarantine_cooldown_s: float = 0.5   # then a half-open probe


@dataclass(frozen=True)
class TenantSLO:
    """A tenant's service objective.  ``latency_class`` "latency"
    (deadline-driven, rank 0) or "batch" (rank 1); ``weight`` breaks
    deadline ties, heavier first; ``p99_target_s`` makes each submit's
    absolute deadline ``submit_t + p99_target_s``, so a waiting ticket
    only gains on fresh arrivals."""

    latency_class: str = "batch"
    weight: float = 1.0
    p99_target_s: float = 50e-3

    @property
    def rank(self) -> int:
        return 0 if self.latency_class == "latency" else 1


DEFAULT_SLO = TenantSLO()


@dataclass
class Ticket:
    """The one handle type every submission returns; ``kind`` says what it
    stands for:

    - ``"op"``: one request (``request`` set);
    - ``"bundle"``: a submitted sequence; its ``members`` are the
      per-request tickets (each a logical request), and it completes
      with its last member;
    - ``"graph"``: a submitted `OpGraph`, one logical request; ``nodes``
      maps node names to node tickets, ``state`` is its `GraphState`,
      and it completes with its last node;
    - ``"node"``: one graph node (``node``, ``graph``), not a logical
      request of its own; its ``request`` is bound when it is released,
      its producers' outputs wired in.

    A request (or node) admission sliced is a parent: its ``pieces`` are
    the tickets in the queues (each links back by ``parent``), and it
    completes, with the merged result, when its last piece does.
    Constituents are reached through the handle: ``handle["o"]`` (a
    graph's node by name) or ``handle[0]`` (a bundle's member),
    `result_of`, `results`."""

    seq: int
    tenant: str
    request: Optional[GemmRequest]
    submit_t: float
    done_t: Optional[float] = None
    result: Optional[torch.Tensor] = None   # set when executed
    plan: Optional[GroupPlan] = None
    deadline_t: float = math.inf            # submit_t + the SLO's p99 target
    rank: int = 1                           # the tenant's SLO rank
    parent: Optional["Ticket"] = field(default=None, repr=False)
    pieces: Optional[List["Ticket"]] = field(default=None, repr=False)
    merge_plan: Optional[SlicePlan] = field(default=None, repr=False)
    kind: str = "op"                # "op" | "node" | "bundle" | "graph"
    logical: bool = True            # records a latency when it completes
    node: Optional[str] = None      # the node's name (kind "node")
    graph: Optional["Ticket"] = field(default=None, repr=False)
    agg: Optional["Ticket"] = field(default=None, repr=False)
    members: Optional[List["Ticket"]] = field(default=None, repr=False)
    nodes: Optional[Dict[str, "Ticket"]] = field(default=None, repr=False)
    state: Optional[GraphState] = field(default=None, repr=False)

    @property
    def desc(self) -> GemmDesc:
        return self.request.desc

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_t is None else self.done_t - self.submit_t

    @property
    def sliced(self) -> bool:
        return self.pieces is not None

    @property
    def done(self) -> bool:
        if self.state is not None:
            return self.state.done
        if self.members is not None:
            return all(m.done_t is not None for m in self.members)
        return self.done_t is not None

    def __getitem__(self, key) -> "Ticket":
        """A graph's node ticket by name, or a bundle's member by position."""
        if self.nodes is not None:
            return self.nodes[key]
        if self.members is not None:
            return self.members[key]
        raise TypeError(f"{self.kind!r} ticket has no constituents")

    def result_of(self, name: str) -> Optional[torch.Tensor]:
        """One graph node's result (None in shadow mode)."""
        return self[name].result

    def results(self) -> Dict[object, Optional[torch.Tensor]]:
        """Every constituent's result, by node name (graph) or position
        (bundle); a plain op's under its own seq."""
        if self.nodes is not None:
            return {n: t.result for n, t in self.nodes.items()}
        if self.members is not None:
            return {i: t.result for i, t in enumerate(self.members)}
        return {self.seq: self.result}


@dataclass
class Launch:
    """One bound group: a `GroupPlan` applied to live tickets."""

    plan: GroupPlan
    tickets: List[Ticket]
    class_key: str
    cache_hit: bool
    start_t: float = 0.0
    end_t: float = 0.0
    # the fallback rung that completed the launch (None: as planned) and
    # the modeled device time its failed attempts took
    fallback: Optional[str] = None
    penalty_s: float = 0.0


class _ClassQueue:
    """One class's pending tickets in canonical order (bisect insertion at
    admission, ties by arrival), with the signature's key list kept as a
    parallel array so `flush()` never sorts, and the earliest submit time,
    earliest deadline and heaviest tenant weight pending."""

    __slots__ = ("tickets", "keys", "_orders", "oldest_t", "min_deadline",
                 "max_weight")

    def __init__(self) -> None:
        self.tickets: List[Ticket] = []
        self.keys: List[str] = []
        self._orders: List[tuple] = []
        self.oldest_t = float("inf")
        self.min_deadline = float("inf")
        self.max_weight = 0.0

    def add(self, ticket: Ticket, weight: float = 1.0) -> None:
        order = _canonical_order(ticket.desc)
        i = bisect.bisect_right(self._orders, order)
        self._orders.insert(i, order)
        self.tickets.insert(i, ticket)
        self.keys.insert(i, ticket.desc.key())
        if ticket.submit_t < self.oldest_t:
            self.oldest_t = ticket.submit_t
        if ticket.deadline_t < self.min_deadline:
            self.min_deadline = ticket.deadline_t
        if weight > self.max_weight:
            self.max_weight = weight

    def take_all(self) -> tuple[List[Ticket], tuple]:
        tickets, keys = self.tickets, tuple(self.keys)
        self.tickets, self.keys, self._orders = [], [], []
        self.oldest_t = float("inf")
        self.min_deadline = float("inf")
        self.max_weight = 0.0
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
        fault_injector: FaultInjector | None = None,
    ):
        self.device = resolve_device(device)
        self.ctrl = controller or ConcurrencyController()
        self.config = config or RuntimeConfig()
        self.telemetry = Telemetry()
        self.clock = clock
        # The chaos layer (None: the executor is `execute_schedule`
        # itself) and the per-(family, class, tile) circuit breaker, whose
        # time is the modeled launch timeline.
        self.fault_injector = fault_injector
        self._exec_fn = (fault_injector.wrap(execute_schedule)
                         if fault_injector is not None else execute_schedule)
        self.breaker = CircuitBreaker(
            strikes=self.config.quarantine_strikes,
            cooldown_s=self.config.quarantine_cooldown_s)
        self._quarantined_descs: Dict[Tuple[str, str, str], List[str]] = {}
        # Calibration: up to four descs per compatibility class (to turn a
        # drifting class key back into descriptors to re-tune) and the
        # queued re-tunes `process_retunes` runs.
        self._class_descs: Dict[str, Dict[str, GemmDesc]] = {}
        self._retune: List[Tuple[str, str]] = []
        # available slots: CD_exec = min(CD_preferred, available); part of
        # the plan-cache key
        self.available = self.ctrl.max_cd
        # the device's spec and library, so that set_mesh re-derives from
        # them and never compounds
        self._chip_spec = self.ctrl.spec
        self._chip_lib = self.ctrl.lib
        self.mesh_resources = None
        self.device_free_t = 0.0
        self._queues: Dict[str, _ClassQueue] = {}
        self._rr = 0                    # round-robin cursor over class order
        self._order: List[str] = []     # class keys in first-seen order
        self._plan_cache: "OrderedDict[Signature, Schedule]" = OrderedDict()
        self._seq = 0
        self._flush_id = 0
        # Tenant objectives, and the modeled isolated time per desc key
        # that admission slicing reads (cleared wherever library entries
        # go stale), so steady-state admission evaluates no cost model.
        self._slos: Dict[str, TenantSLO] = {}
        self._iso_cache: Dict[str, float] = {}

    # --------------------------------------------------------------- SLOs
    def set_tenant_slo(self, tenant: str, slo: TenantSLO) -> None:
        self._slos[tenant] = slo

    def tenant_slo(self, tenant: str) -> TenantSLO:
        return self._slos.get(tenant, DEFAULT_SLO)

    def _isolated_estimate(self, desc) -> float:
        """Memoized modeled isolated time, for admission decisions."""
        key = desc.key()
        est = self._iso_cache.get(key)
        if est is None:
            est = isolated_time(desc, self.ctrl.lib.get(desc).isolated,
                                self.ctrl.spec)
            self._iso_cache[key] = est
        return est

    def _admission_parts(self, desc) -> int:
        """How many pieces admission slices ``desc`` into: 1 unless
        slicing is on with a budget, the op can slice, and its modeled
        isolated time exceeds ``flush_budget_s · slice_budget_frac``;
        then just enough pieces to bring each under that, at most
        ``max_slices``."""
        cfg = self.config
        if (not cfg.slicing or cfg.flush_budget_s is None
                or not getattr(desc, "can_slice", False)):
            return 1
        threshold = cfg.flush_budget_s * cfg.slice_budget_frac
        if threshold <= 0:
            return 1
        est = self._isolated_estimate(desc)
        if est <= threshold:
            return 1
        return min(math.ceil(est / threshold), cfg.max_slices)

    def _make_pieces(self, ticket: Ticket, plan: SlicePlan) -> List[Ticket]:
        """The piece tickets of a sliced parent: ordinary tickets of the
        piece descs, with the parent's operands split (views, but a
        ``ta`` GEMM's columns, which are copied: ROADMAP C10), its
        deadline and rank, and a link back for completion."""
        req = ticket.request
        operands = req.operands
        per_piece = (plan.split_operands(operands)
                     if operands is not None and all(t is not None for t in operands)
                     else [None] * plan.parts)
        pieces: List[Ticket] = []
        for pdesc, pops in zip(plan.pieces, per_piece):
            if pops is not None and plan.kind == "m" and pdesc.ta:
                pops = (pops[0].contiguous(), pops[1])
            preq = bind_operands(pdesc, pops, tag=req.tag)
            self._seq += 1
            pieces.append(Ticket(
                seq=self._seq, tenant=ticket.tenant, request=preq,
                submit_t=ticket.submit_t, deadline_t=ticket.deadline_t,
                rank=ticket.rank, parent=ticket))
        ticket.pieces = pieces
        ticket.merge_plan = plan
        self.telemetry.record_slices(ticket.tenant, plan.parts)
        return pieces

    # ------------------------------------------------------------- admit
    def submit(
        self,
        work,
        tenant: str = "default",
        now: float | None = None,
    ) -> Ticket:
        """Admit one op into its class queue, a sequence of ops of any
        family — a heterogeneous bundle — into the shared
        ``MIXED_CLASS`` queue, which `flush` plans with
        `ConcurrencyController.plan_mixed`, or an `OpGraph`, whose ready
        nodes enter that queue as they become ready.  Returns one
        ticket: the op's, a ``"bundle"`` handle over the members'
        tickets, or a ``"graph"`` handle over the nodes'.  Operands,
        where given, lie on the runtime's device; with
        ``RuntimeConfig.execute`` every request (every graph node, its
        wired slots counted) carries its operands, and a GEMM is a plain
        (batch 1) one: batched GEMMs have no kernel yet."""
        now = self.clock() if now is None else now
        if isinstance(work, OpGraph):
            return self._submit_graph(work, tenant, now)
        if isinstance(work, (list, tuple)):
            return self._submit_bundle(work, tenant, now)
        return self._admit(self._admissible(work), tenant, now)

    def _submit_bundle(self, work: Sequence, tenant: str, now: float) -> Ticket:
        """Every member is one logical request (its own latency); the
        returned handle completes with the last of them."""
        requests = [self._admissible(r) for r in work]
        self._queue(MIXED_CLASS)
        members = [self._admit(r, tenant, now, MIXED_CLASS) for r in requests]
        slo = self.tenant_slo(tenant)
        self._seq += 1
        handle = Ticket(seq=self._seq, tenant=tenant, request=None,
                        submit_t=now, deadline_t=now + slo.p99_target_s,
                        rank=slo.rank, kind="bundle", logical=False,
                        members=members)
        for m in members:
            m.agg = handle
        return handle

    def _admissible(self, request: GemmRequest) -> GemmRequest:
        """Check a request before admission: a ported family; with
        ``execute``, its operands (a GEMM's ``a``/``b``, another family's
        ``inputs``); every operand on the runtime's device."""
        self._check_family(request.desc)
        operands = request.operands
        if self.config.execute:
            if operands is None or any(t is None for t in operands):
                raise ValueError(f"{request.desc.key()}: an executing "
                                 "runtime needs the request's operands")
        for t in _tensors(operands or ()):
            self._check_device(t, request.desc.key())
        return request

    def _check_family(self, desc) -> None:
        """A known family; with ``execute``, a GEMM of batch 1."""
        fam = family_of(desc)
        if fam != "gemm" and fam not in OP_FAMILIES:
            raise NotImplementedError(
                f"{desc.key()}: the {fam} family is not ported")
        if self.config.execute and fam == "gemm" and desc.batch != 1:
            raise NotImplementedError(
                f"{desc.key()}: batched GEMMs have no kernel in the port yet")

    def _check_device(self, t: Optional[torch.Tensor], what: str) -> None:
        if t is not None and t.device != self.device:
            raise ValueError(f"{what}: operand on {t.device}, runtime on "
                             f"{self.device}")

    def _admit(self, request: GemmRequest, tenant: str, now: float,
               class_key: str | None = None) -> Ticket:
        """One logical request's ticket, with its tenant's deadline and
        rank, into its class queue (``class_key``, or the desc's
        compatibility class) — or, when admission slices it, its pieces."""
        slo = self.tenant_slo(tenant)
        self._seq += 1
        ticket = Ticket(seq=self._seq, tenant=tenant, request=request,
                        submit_t=now, deadline_t=now + slo.p99_target_s,
                        rank=slo.rank)
        parts = self._admission_parts(request.desc)
        if parts > 1:
            for piece in self._make_pieces(ticket, slice_plan(request.desc, parts)):
                self._enqueue(piece, slo.weight, class_key)
        else:
            self._enqueue(ticket, slo.weight, class_key)
        self.telemetry.record_submit()
        return ticket

    # ------------------------------------------------- graph admission
    def _submit_graph(self, graph: OpGraph, tenant: str, now: float) -> Ticket:
        """Validate the graph and check its operands (`_check_graph`),
        make one node ticket per op under the returned ``"graph"`` handle
        — one logical request, whose latency ends at its last node — and
        release the roots into the mixed queue; `_complete_node` releases
        the rest as their producers complete."""
        state = GraphState(graph)       # validates: cycles, slots, sizes
        self._check_graph(graph)
        slo = self.tenant_slo(tenant)
        self._seq += 1
        handle = Ticket(seq=self._seq, tenant=tenant, request=None,
                        submit_t=now, deadline_t=now + slo.p99_target_s,
                        rank=slo.rank, kind="graph", nodes={}, state=state)
        for name in state.order:
            self._seq += 1
            tk = Ticket(seq=self._seq, tenant=tenant, request=None,
                        submit_t=now, deadline_t=handle.deadline_t,
                        rank=slo.rank, kind="node", logical=False,
                        node=name, graph=handle)
            state.tickets[name] = tk
            handle.nodes[name] = tk
        self.telemetry.record_submit()
        self.telemetry.record_graph_submit(len(state.order))
        for name in state.ready():
            self._release_node(handle, name, now)
        return handle

    def _check_graph(self, graph: OpGraph) -> None:
        """`_admissible` for every node of a graph, before anything is
        queued: a known family, every static operand on the runtime's
        device and of its slot's shape (`operand_shape`: a grouped
        node's expert weights as one (G, K, N) tensor or G (K, N) ones)
        and, with ``execute``, every slot of the node's family filled by
        a static operand or a data edge."""
        wired = {(e.dst, e.slot) for e in graph.edges if e.slot is not None}
        for name, node in graph.nodes.items():
            self._check_family(node.desc)
            for slot, t in node.operands.items():
                what = f"node {name!r} slot {slot!r}"
                for x in _tensors((t,)):
                    self._check_device(x, what)
                if t is not None and operand_shape(t) != slot_shape(node.desc, slot):
                    raise ValueError(f"{what}: operand of shape {operand_shape(t)}, "
                                     f"the slot takes {slot_shape(node.desc, slot)}")
            if not self.config.execute:
                continue
            for slot in FAMILY_SLOTS[family_of(node.desc)]:
                if node.operands.get(slot) is None and (name, slot) not in wired:
                    raise ValueError(
                        f"node {name!r} slot {slot!r}: an executing runtime "
                        "needs an operand or a data edge for every slot")

    def _release_node(self, handle: Ticket, name: str, now: float) -> None:
        """Move one ready node into the mixed queue: bind its request from
        the slots filled so far, stamp its submit time with the release
        time (waiting and EDF order measure readiness, not admission),
        and slice it as a directly submitted op would be; a sliced node
        completes through the parent merge before its dependents see
        the merged result."""
        state = handle.state
        state.mark_released(name)
        gnode = state.graph.nodes[name]
        tk = state.tickets[name]
        tk.submit_t = max(tk.submit_t, now)
        tk.request = bind_operands(gnode.desc, state.operands_for(name),
                                   tag=gnode.tag or name)
        weight = self.tenant_slo(handle.tenant).weight
        parts = self._admission_parts(gnode.desc)
        if parts > 1:
            for piece in self._make_pieces(tk, slice_plan(gnode.desc, parts)):
                self._enqueue(piece, weight, MIXED_CLASS)
        else:
            self._enqueue(tk, weight, MIXED_CLASS)

    def _queue(self, key: str) -> "_ClassQueue":
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = _ClassQueue()
            self._order.append(key)
        return q

    def _enqueue(self, ticket: Ticket, weight: float = 1.0,
                 class_key: str | None = None) -> None:
        key = class_key if class_key is not None else compat_key(ticket.desc)
        self._queue(key).add(ticket, weight)

    def set_available(self, n: int) -> None:
        """Set the live available parallelism (slots other work holds are
        not available).  Part of the plan-cache key, so a plan made for
        another count is never reused."""
        self.available = max(1, int(n))

    def set_mesh(self, mesh):
        """Derate the runtime for a mesh (`repro/runtime/runtime.py:607-637`):
        tensor-parallel shards co-resident on each device shrink what a
        concurrent group can claim, so the controller's spec and its GO
        library switch to the per-shard `TPUSpec.scaled` variant (a fresh
        library when the fraction is below 1; tiles tuned for the whole
        device would be wrong under a shard's share) and ``available``
        drops to the per-shard slot budget.  Always derived from the spec
        and library captured at construction: a new mesh re-derives, never
        compounds.  Prewarm after set_mesh, not before.  Returns the
        `MeshResources`."""
        from repro_torch.dist.resources import mesh_resources

        res = mesh_resources(mesh, spec=self._chip_spec, max_cd=self.ctrl.max_cd)
        self.ctrl.spec = res.spec
        self.ctrl.lib = self._chip_lib if res.frac == 1.0 else GOLibrary(spec=res.spec)
        # memoized CD and feature decisions came from the previous spec
        self.ctrl.invalidate_caches()
        self.set_available(res.slot_budget)
        self.invalidate_plans()
        self._iso_cache.clear()   # admission estimates were per device spec
        self.mesh_resources = res
        return res

    def queue_depths(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self._queues.items() if q}

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------ prewarm
    def prewarm(self, work) -> int:
        """Tune ahead of traffic and seed the plan cache, as `submit`
        takes work: an `OpGraph` tunes every node and seeds the mixed
        signature of each of its waves (what the flushes of a lone graph
        plan); a sequence with a non-GEMM member is a bundle, seeded by
        `prewarm_bundle`; GEMMs alone are a catalog, which seeds each
        class's all-at-once plan.  Returns the number of newly tuned
        entries.  Planning here is billed as prewarm overhead, not as a
        miss."""
        if isinstance(work, OpGraph):
            fresh = self.ctrl.lib.prewarm(work.descs())
            for wave in work.waves():
                self._seed_mixed_plan([work.nodes[n].desc for n in wave])
            return fresh
        descs = list(work) if isinstance(work, (list, tuple)) else [work]
        if any(family_of(d) != "gemm" for d in descs):
            return self.prewarm_bundle(descs)
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
        """Tune a bundle's ops (any ported family) ahead of traffic and
        seed the plan cache with its ``MIXED_CLASS`` signature, so the
        first flush of the same co-submitted set is a cache hit; returns
        the newly tuned entries."""
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
        """Serve every ripe class (head waited ≥ window_s).  Round-robin:
        starting after the last serviced class, with the classes' launches
        interleaved.  EDF (``policy="edf"``): classes by earliest
        deadline (heavier weight first on ties), launches by their
        members' earliest deadline, then weight, then arrival.  A
        ``flush_budget_s`` binds only a prefix of that order; the rest
        requeue with their deadlines."""
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

        edf = self.config.policy == "edf"
        if edf:
            # deadlines are absolute, so a waiting class only rises
            rotated = sorted(ripe, key=lambda k: (
                self._queues[k].min_deadline, -self._queues[k].max_weight, k))
        else:
            start = self._rr % max(len(self._order), 1)
            rotated = [k for k in self._order[start:] + self._order[:start]
                       if k in ripe]
            self._rr = (self._order.index(rotated[0]) + 1) % len(self._order)

        per_class: List[List[Launch]] = []
        planning_s = 0.0
        for key in rotated:
            tickets, sig_keys = self._queues[key].take_all()
            if key == MIXED_CLASS:
                # the ready-set depth: graph nodes this window could draw from
                depth = sum(1 for t in tickets
                            if t.kind == "node" or
                            (t.parent is not None and t.parent.kind == "node"))
                if depth:
                    self.telemetry.record_ready_depth(depth)
                ranks = [t.rank for t in tickets] if edf else None
                if ranks is not None and len(set(ranks)) > 1:
                    # ranks change the chunking, so their pattern joins
                    # the signature; tenants' ranks are static, so
                    # steady-state traffic still hits
                    sched, hit = self._plan_for_keys(
                        (MIXED_CLASS,) + sig_keys
                        + ("ranks:" + "".join(map(str, ranks)),),
                        lambda: [t.desc for t in tickets],
                        planner=lambda descs, available: self.ctrl.plan_mixed(
                            descs, available=available, ranks=ranks))
                else:
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
        if edf:
            launches = [ln for groups in per_class for ln in groups]
            launches.sort(key=lambda ln: (
                min(tk.deadline_t for tk in ln.tickets),
                -max(self.tenant_slo(tk.tenant).weight for tk in ln.tickets),
                min(tk.seq for tk in ln.tickets)))
        else:
            launches = _interleave(per_class)

        # The budget is a commit horizon: bind launches only until the
        # modeled device is committed through ``now + flush_budget_s``;
        # the rest requeue, deadlines intact, so a later flush orders them
        # against what arrived meanwhile.  Nothing binds if committed work
        # already passes the horizon; else at least one launch does (its
        # planning may overshoot), so forced flushing makes progress.
        base = max(self.device_free_t, now + planning_s)
        budget = self.config.flush_budget_s
        if budget is not None:
            horizon = now + budget
            acc, cut = base, 0
            for launch in launches:
                if cut == 0:
                    if self.device_free_t > horizon:
                        break
                elif acc + _launch_cost(launch) > horizon:
                    break
                acc += _launch_cost(launch)
                cut += 1
            if cut < len(launches):
                for launch in launches[cut:]:
                    self._requeue(launch)
                self.telemetry.record_deferred(len(launches) - cut)
                launches = launches[:cut]

        # Modeled single-device timeline: planning (cache misses) delays
        # dispatch on an idle device and hides behind prior kernels.
        t = base
        for launch in launches:
            launch.start_t = t
            achieved = self._execute(launch) if self.config.execute else None
            # failed attempts take modeled device time too; ``penalty_s``
            # is 0.0 on the healthy path, so its timeline is unchanged
            t += _launch_cost(launch) + launch.penalty_s
            launch.end_t = t
            for ticket in launch.tickets:
                ticket.done_t = launch.end_t
                ticket.plan = launch.plan
                self._finish(ticket)
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
                fallback=launch.fallback,
                graph_ids=_graph_ids(launch.tickets),
            ))
            self._feed_calibration(launch, achieved)
        if launches:
            self.device_free_t = t
        self._queue_stale_retunes()
        self.telemetry.record_flush_fastpath(
            EVAL_COUNTER.evals - evals0,
            self.telemetry.sig_resorts - resorts0,
        )
        return launches

    def drain(self, now: float | None = None) -> List[Launch]:
        """Force-flush until every queue is empty.  A budgeted flush can
        bind nothing (the device committed past its horizon); then the
        clock advances to the commit edge."""
        out: List[Launch] = []
        cur = self.clock() if now is None else now
        while self.pending():
            got = self.flush(now=cur, force=True)
            out += got
            if not got:
                cur = max(cur, self.device_free_t)
        return out

    # --------------------------------------------------------- completion
    def _finish(self, ticket: Ticket) -> None:
        """A piece completes its parent when it is the last one, the
        parent's result being the merged pieces' when executed; then the
        whole op's logical completion."""
        parent = ticket.parent
        if parent is None:
            self._complete_logical(ticket)
            return
        if any(p.done_t is None for p in parent.pieces):
            return
        parent.done_t = max(p.done_t for p in parent.pieces)
        parent.plan = ticket.plan
        if all(p.result is not None for p in parent.pieces):
            parent.result = parent.merge_plan.merge(
                [p.result for p in parent.pieces])
        self._complete_logical(parent)

    def _complete_logical(self, ticket: Ticket) -> None:
        """One whole op finished: a ticket that is not a logical request
        of its own (a graph node) completes through its graph
        (`_complete_node`); a logical one records its latency, and
        completes its bundle when it is the last member."""
        if not ticket.logical:
            self._complete_node(ticket)
            return
        self.telemetry.record_latency(ticket.tenant, ticket.latency_s)
        agg = ticket.agg
        if (agg is not None and agg.done_t is None
                and all(m.done_t is not None for m in agg.members)):
            agg.done_t = max(m.done_t for m in agg.members)

    def _complete_node(self, tk: Ticket) -> None:
        """Wire the node's output — whichever rung of the fallback ladder
        produced it — into its dependents' slots, release the newly
        ready ones at its completion time (a later flush plans them),
        and complete the graph with its last node, as one logical
        request.

        A wired operand is a view of its producer's output, which was
        allocated on the launching stream; a dependent may read it on
        another member stream in a later flush.  That is safe while every
        attempt synchronises (`_attempt`) and every mixed launch joins its
        member streams (`scheduler._run_mixed`).  ROADMAP A2 must call
        `Tensor.record_stream` on wired operands for the streams that
        read them, or keep that join, before it drops the
        synchronisation."""
        handle = tk.graph
        state = handle.state
        for name in state.complete(tk.node, tk.result):
            self._release_node(handle, name, tk.done_t)
        if state.done:
            handle.done_t = max(t.done_t for t in handle.nodes.values())
            handle.plan = tk.plan
            self.telemetry.record_latency(handle.tenant, handle.latency_s)
            self.telemetry.record_graph_complete()

    def _requeue(self, launch: Launch) -> None:
        """A deferred launch's tickets back to their class queue, submit
        time and deadline intact, so deferral only makes them more urgent
        than fresh arrivals."""
        for tk in launch.tickets:
            self._enqueue(tk, self.tenant_slo(tk.tenant).weight,
                          class_key=launch.class_key)

    # -------------------------------------------------- calibration (§16)
    def _feed_calibration(self, launch: Launch,
                          achieved: Optional[float]) -> None:
        """Fold one launch's modeled-vs-achieved ratio into the
        controller's calibrator: class launches only (a mixed group's
        time belongs to no one class), and only a launch that completed
        on its planned rung (a fallback's time is not the planned
        kernel's).  No cost-model evaluation."""
        cal = self.ctrl.calibrator
        if cal is None or launch.class_key == MIXED_CLASS:
            return
        descs = self._class_descs.setdefault(launch.class_key, {})
        for tk in launch.tickets:
            if len(descs) >= 4 and tk.desc.key() not in descs:
                continue
            descs[tk.desc.key()] = tk.desc
        if achieved is None or launch.fallback is not None:
            return
        cal.update(family_of(launch.tickets[0].desc), launch.class_key,
                   launch.plan.modeled_time_s, achieved)

    def _queue_stale_retunes(self) -> None:
        """Queue, once per excursion, every class whose drift crossed the
        calibrator's threshold (`CostCalibrator.pop_stale`)."""
        cal = self.ctrl.calibrator
        if cal is None:
            return
        for fam_ck in cal.pop_stale():
            if fam_ck not in self._retune:
                self._retune.append(fam_ck)

    def pending_retunes(self) -> int:
        return len(self._retune)

    def process_retunes(self, now: float | None = None) -> int:
        """Run the queued drift re-tunes, between traffic, never inside a
        flush: invalidate the stale classes' library entries, re-tune
        them in one `GOLibrary.prewarm` sweep, and drop every plan and
        memo derived from them.  Returns the number of re-tuned entries.

        Also the half-open probe point: quarantines whose cooldown has
        elapsed by ``now`` (modeled-timeline seconds; default the clock)
        are released, and their tiles may be planned again."""
        fresh = 0
        if self._retune:
            descs: Dict[str, GemmDesc] = {}
            for _, ck in self._retune:
                descs.update(self._class_descs.get(ck, {}))
            self._retune.clear()
            if descs:
                self.ctrl.lib.invalidate(list(descs))
                fresh = self.ctrl.lib.prewarm(list(descs.values()))
                self.ctrl.invalidate_caches()
                self.invalidate_plans()
                self._iso_cache.clear()
        if self.breaker.active:
            now = self.clock() if now is None else now
            for key in self.breaker.release_due(now):
                keys = self._quarantined_descs.pop(key, [])
                self.ctrl.lib.release(keys, key[2])
                if keys:
                    self.ctrl.lib.invalidate(keys)
                self.ctrl.invalidate_caches()
                self.invalidate_plans()
                self._iso_cache.clear()
                self.telemetry.record_probe()
        return fresh

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
        """Run one launch down the fallback ladder; returns the device time
        in seconds (host time on the CPU) of the attempt that completed."""
        reqs = [t.request for t in launch.tickets]
        mini = Schedule(groups=[replace(
            launch.plan, indices=list(range(len(reqs))))])
        outs, achieved = self._execute_resilient(reqs, mini, launch)
        for ticket, out in zip(launch.tickets, outs):
            ticket.result = out
        return achieved

    # -------------------------------------------- fallback ladder (§18.2)
    def _execute_resilient(self, reqs, mini: Schedule, launch: Launch):
        """Run one launch down the ladder until it completes: the planned
        schedule, ``max_retries`` retries of it, the group at its members'
        isolated tiles (legacy), then the reference rung — each member
        alone at its isolated tile, in order, on the launching stream,
        never injected, with no finiteness veto.  Only `LaunchFault` and
        `KernelLaunchError` are caught; any other error propagates at
        once.  Every failed attempt records its fault, strikes the
        (family, class, tile) triples it used (the K-th consecutive
        strike quarantines the tile) and adds one ``modeled_time_s`` of
        penalty to the launch.  A failure of the reference rung raises.
        Returns the outputs and the completed attempt's time."""
        plan = launch.plan
        n = len(reqs)
        planned_tiles = (plan.tiles if plan.mode == "mixed" and plan.tiles
                         else [plan.tile] * n)
        iso = None
        rungs = (["planned"] + ["retry"] * max(0, int(self.config.max_retries))
                 + ["legacy", "reference"])
        failures = 0
        for rung in rungs:
            if rung in ("planned", "retry"):
                sched, tiles = mini, planned_tiles
            else:
                iso = iso or [self.ctrl.lib.get(r.desc).isolated for r in reqs]
                if rung == "legacy":
                    sched, tiles = Schedule(groups=[replace(
                        plan, indices=list(range(n)), tile=iso[0],
                        tiles=iso if plan.mode == "mixed" else None)]), iso
                else:
                    sched, tiles = Schedule(groups=[
                        GroupPlan(indices=[i], cd=1, tile=iso[i], mode="single",
                                  modeled_time_s=0.0) for i in range(n)]), None
            try:
                outs, achieved = self._attempt(reqs, sched, rung == "reference")
            except (LaunchFault, KernelLaunchError) as exc:
                self.telemetry.record_fault(fault_kind(exc))
                failures += 1
                if tiles is not None:
                    self._strike(reqs, tiles, now=launch.start_t)
                if rung == "reference":
                    raise
                if self.device.type == "cuda":
                    join_member_streams(self.device)
                continue
            if rung != "planned":
                launch.fallback = rung
                launch.penalty_s = failures * plan.modeled_time_s
                self.telemetry.record_fallback(rung)
            elif self.breaker.active:
                # a healthy launch on a watched tile resets its count
                for r, tile in zip(reqs, planned_tiles):
                    self.breaker.succeed(family_of(r.desc), compat_key(r.desc),
                                         tile.key())
            return outs, achieved
        raise AssertionError("unreachable: the reference rung returns or raises")

    def _attempt(self, reqs, sched: Schedule, reference: bool):
        """One attempt: execute (through the chaos layer when injecting,
        but on the reference rung), wait for it, and veto a non-finite
        output but on the reference rung.  Returns the outputs and the
        attempt's device time (host time on the CPU)."""
        run = execute_schedule if reference else self._exec_fn
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = run(reqs, sched)
            end.record()
            end.synchronize()
            achieved = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            outs = run(reqs, sched)
            achieved = time.perf_counter() - t0
        if not reference:
            for o in outs:
                if not bool(torch.isfinite(o).all()):
                    raise NonFiniteOutput(
                        f"{sched.groups[0].mode} launch at tile "
                        f"{sched.groups[0].tile.key()} produced non-finite output")
        return outs, achieved

    def _strike(self, reqs, tiles, now: float) -> None:
        """Charge one failed attempt to every distinct (family, class,
        tile) it used; quarantine those that reach K strikes."""
        targets: Dict[Tuple[str, str, str], set] = {}
        for r, tile in zip(reqs, tiles):
            key = (family_of(r.desc), compat_key(r.desc), tile.key())
            targets.setdefault(key, set()).add(r.desc.key())
        for (fam, ck, tk), desc_keys in targets.items():
            if self.breaker.strike(fam, ck, tk, now):
                self._quarantine_entry(fam, ck, tk, desc_keys)

    def _quarantine_entry(self, family: str, class_key: str, tile_key: str,
                          desc_keys) -> None:
        """The K-th strike's side effects, once per quarantine: ban the
        tile in the library, drop the tuned entries (their re-tune sees
        the ban), evict every cached plan that uses the tile, and clear
        the controller's memos."""
        keys = sorted(desc_keys)
        self._quarantined_descs[(family, class_key, tile_key)] = keys
        self.ctrl.lib.quarantine(keys, tile_key)
        self.ctrl.lib.invalidate(keys)
        evicted = self._evict_plans_using(tile_key)
        self.ctrl.invalidate_caches()
        self._iso_cache.clear()
        self.telemetry.record_quarantine(evicted_plans=evicted)

    def _evict_plans_using(self, tile_key: str) -> int:
        """Drop every cached schedule with a group (or a mixed member) at
        ``tile_key``: a poisoned plan must not be replayed from a hit."""
        doomed = [
            sig for sig, sched in self._plan_cache.items()
            if any(gp.tile.key() == tile_key
                   or (gp.tiles is not None
                       and any(t.key() == tile_key for t in gp.tiles))
                   for gp in sched.groups)
        ]
        for sig in doomed:
            del self._plan_cache[sig]
        return len(doomed)

    def invalidate_plans(self) -> None:
        self._plan_cache.clear()

    @property
    def plan_cache_size(self) -> int:
        return len(self._plan_cache)


def _tensors(operands) -> List[torch.Tensor]:
    """The tensors of an operand tuple, a grouped request's sequence of
    expert weights unpacked; None operands are skipped."""
    out: List[torch.Tensor] = []
    for t in operands:
        if isinstance(t, (list, tuple)):
            out += _tensors(t)
        elif t is not None:
            out.append(t)
    return out


def _graph_ids(tickets: List[Ticket]) -> Tuple[int, ...]:
    """The distinct graph handles' seqs a launch's members belong to (a
    piece through its sliced parent)."""
    ids = set()
    for tk in tickets:
        owner = tk.parent if tk.parent is not None else tk
        if owner.graph is not None:
            ids.add(owner.graph.seq)
    return tuple(sorted(ids))


def _canonical_order(d: GemmDesc) -> tuple:
    """Stable within-class ordering (largest M first) so equal queue
    contents produce equal signatures regardless of arrival order."""
    return (-d.M, d.key())


def _launch_cost(launch: Launch) -> float:
    """Modeled device time of one launch with `SLICE_OVERHEAD_S` for each
    piece in it (exactly the plan's time when nothing is sliced)."""
    sliced = sum(1 for tk in launch.tickets if tk.parent is not None)
    return launch.plan.modeled_time_s + sliced * SLICE_OVERHEAD_S


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
