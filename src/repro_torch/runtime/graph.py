"""Dependency-aware op graphs, the runtime's dataflow unit
(`repro/runtime/graph.py`).

An `OpGraph` holds named ops (any descriptor of a ported family) joined
by two kinds of edge: a data edge carries one node's output into an
operand slot of another, and a control edge only orders the two (the
KV-cache append an attention read must wait for).  The graph is a
reusable template: `Runtime.submit(graph)` builds a private `GraphState`
per submission (indegree counters and operand slots), releases the ready
frontier into the shared mixed queue, and releases each dependent when
its producers complete, their outputs wired in.  `plan_mixed` then fills
each concurrency window with ready nodes of every live graph.

`OpGraph.validate` checks the structure eagerly: unique node names,
known edge endpoints, slots legal for the destination's family, at most
one edge per slot, data edges without a ``transform`` size-consistent
(the default wiring is a reshape), and no cycle (Kahn; a cycle raises
`GraphError` naming its nodes).  `waves()` gives the topological level
sets: what a caller restricted to bundles must submit with a barrier
between each.

A grouped expert GEMM's weight slot (1) holds the experts' weights as
one stacked (G, K, N) tensor or as a sequence of G (K, N) tensors, read
where they lie by the kernel (`operand_shape` gives both the same
shape).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.op_desc import family_of


class GraphError(ValueError):
    """Structural problem in an `OpGraph` (cycle, bad slot, shape clash)."""


# Operand slots per family, in the positional order the family ops
# consume them: a GEMM's by name (the `GemmRequest` fields ``a``/``b``),
# every other family's by position into `GemmRequest.inputs`.
FAMILY_SLOTS: Dict[str, Tuple[object, ...]] = {
    "gemm": ("a", "b"),
    "flash_attention": (0, 1, 2),       # q, k, v
    "grouped_gemm": (0, 1),             # a (ragged rows), b (expert weights)
    "mamba_scan": (0, 1, 2, 3),         # xd, da, B, C
}


def out_shape(d) -> Tuple[int, ...]:
    """Output shape of the launch ``d`` describes."""
    fam = family_of(d)
    if fam == "gemm":
        return (d.M, d.N)
    if fam == "flash_attention":
        return (d.B, d.Hq, d.Sq, d.D)
    if fam == "grouped_gemm":
        return (d.M, d.N)
    if fam == "mamba_scan":
        return (d.B, d.T, d.H, d.P)
    raise GraphError(f"unknown op family: {fam}")


def slot_shape(d, slot) -> Tuple[int, ...]:
    """Expected shape of operand ``slot`` of ``d`` (the layout the family
    ops consume; see `FAMILY_SLOTS`)."""
    fam = family_of(d)
    if slot not in FAMILY_SLOTS.get(fam, ()):
        raise GraphError(f"slot {slot!r} invalid for family {fam!r} "
                         f"(valid: {FAMILY_SLOTS.get(fam)})")
    if fam == "gemm":
        if slot == "a":
            return (d.K, d.M) if d.ta else (d.M, d.K)
        return (d.N, d.K) if d.tb else (d.K, d.N)
    if fam == "flash_attention":
        return ((d.B, d.Hq, d.Sq, d.D) if slot == 0
                else (d.B, d.Hkv, d.Skv, d.D))
    if fam == "grouped_gemm":
        return (d.M, d.K) if slot == 0 else (d.G, d.K, d.N)
    # mamba_scan: xd (B,T,H,P), da (B,T,H), B/C (B,T,H,N)
    if slot == 0:
        return (d.B, d.T, d.H, d.P)
    if slot == 1:
        return (d.B, d.T, d.H)
    return (d.B, d.T, d.H, d.N)


def operand_shape(value) -> Tuple[int, ...]:
    """Shape of an operand as a slot sees it: a tensor's own, or for a
    sequence of G same-shape tensors (a grouped GEMM's expert weights
    passed by pointer) (G, *shape)."""
    if isinstance(value, (list, tuple)):
        inner = {tuple(v.shape) for v in value}
        if len(inner) != 1:
            raise GraphError(f"a sequence operand needs {len(value)} tensors "
                             f"of one shape, got shapes {sorted(inner)}")
        return (len(value),) + inner.pop()
    return tuple(value.shape)


@dataclass(frozen=True)
class GraphEdge:
    """``dst`` cannot start until ``src`` completes.  ``slot=None`` is a
    control edge (ordering only); a data edge feeds ``src``'s output into
    ``dst``'s operand ``slot`` through ``transform`` (a tensor to tensor
    callable; default: a reshape to the slot's shape)."""

    src: str
    dst: str
    slot: object = None                  # "a"/"b" (gemm) | int | None
    transform: Optional[Callable] = None


@dataclass
class GraphNode:
    """One op: a descriptor plus its statically known operands
    (``{slot: tensor}``); a graph that will be executed carries every
    slot no data edge feeds, a shadow graph none."""

    name: str
    desc: object
    operands: Dict[object, object] = field(default_factory=dict)
    tag: str = ""


class OpGraph:
    """A DAG of ops with named-slot data dependencies.  Reusable:
    `Runtime.submit(graph)` never mutates it.  Build with `add`::

        g = OpGraph()
        g.add("q",    q_desc)
        g.add("k",    k_desc)
        g.add("attn", attn_desc, deps={0: "q"}, after=["k"])
        g.add("o",    o_desc,    deps={"a": "attn"})

    ``deps`` maps destination slots to producer names (or ``(name,
    transform)`` pairs); ``after`` adds control edges.
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, GraphNode] = {}
        self.edges: List[GraphEdge] = []
        self._order: Optional[List[str]] = None   # memoized topo order

    def add(
        self,
        name: str,
        desc,
        deps: Optional[Dict[object, object]] = None,
        after: Sequence[str] = (),
        operands: Optional[Dict[object, object]] = None,
        tag: str = "",
    ) -> str:
        if name in self.nodes:
            raise GraphError(f"duplicate node name: {name!r}")
        self.nodes[name] = GraphNode(name=name, desc=desc,
                                     operands=dict(operands or {}), tag=tag)
        for slot, src in (deps or {}).items():
            transform = None
            if isinstance(src, tuple):
                src, transform = src
            self.edges.append(GraphEdge(src=src, dst=name, slot=slot,
                                        transform=transform))
        for src in after:
            self.edges.append(GraphEdge(src=src, dst=name, slot=None))
        self._order = None
        return name

    def add_edge(self, src: str, dst: str, slot=None, transform=None) -> None:
        self.edges.append(GraphEdge(src=src, dst=dst, slot=slot,
                                    transform=transform))
        self._order = None

    def __len__(self) -> int:
        return len(self.nodes)

    def descs(self) -> List[object]:
        return [n.desc for n in self.nodes.values()]

    def validate(self) -> List[str]:
        """The full structural check; returns (and memoizes) a
        topological order.  Raises `GraphError` on any violation."""
        if self._order is not None:
            return self._order
        seen_slots = set()
        indeg = {name: 0 for name in self.nodes}
        out: Dict[str, List[GraphEdge]] = {name: [] for name in self.nodes}
        for e in self.edges:
            for end in (e.src, e.dst):
                if end not in self.nodes:
                    raise GraphError(f"edge {e.src!r}->{e.dst!r} references "
                                     f"unknown node {end!r}")
            if e.src == e.dst:
                raise GraphError(f"self-edge on {e.src!r}")
            if e.slot is not None:
                dst = self.nodes[e.dst]
                if (e.dst, e.slot) in seen_slots:
                    raise GraphError(
                        f"slot {e.slot!r} of {e.dst!r} wired twice")
                seen_slots.add((e.dst, e.slot))
                tgt = slot_shape(dst.desc, e.slot)   # validates the slot
                if e.transform is None:
                    src_n = math.prod(out_shape(self.nodes[e.src].desc))
                    if src_n != math.prod(tgt):
                        raise GraphError(
                            f"size mismatch {e.src!r}->{e.dst!r} slot "
                            f"{e.slot!r}: producer has {src_n} elements, "
                            f"slot {e.slot!r} wants {tgt} — pass an "
                            f"explicit transform or a control edge")
            indeg[e.dst] += 1
            out[e.src].append(e)
        # Kahn in insertion order: a stable order, so stable signatures.
        order: List[str] = []
        ready = [n for n in self.nodes if indeg[n] == 0]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for e in out[n]:
                indeg[e.dst] -= 1
                if indeg[e.dst] == 0:
                    ready.append(e.dst)
        if len(order) != len(self.nodes):
            cyc = sorted(n for n, d in indeg.items() if d > 0)
            raise GraphError(f"cycle involving: {', '.join(cyc)}")
        self._order = order
        return order

    def waves(self) -> List[List[str]]:
        """Topological level sets: wave k holds every node whose longest
        dependency chain has length k — what a caller restricted to
        bundles must submit with a barrier between waves."""
        order = self.validate()
        level = {n: 0 for n in order}
        out = self._out_edges()
        for n in order:
            for e in out.get(n, ()):
                level[e.dst] = max(level[e.dst], level[n] + 1)
        waves: List[List[str]] = [[] for _ in range(max(level.values(), default=0) + 1)]
        for n in order:
            waves[level[n]].append(n)
        return waves

    def sinks(self) -> List[str]:
        """Nodes with no dependents: the graph completes with them."""
        srcs = {e.src for e in self.edges}
        return [n for n in self.nodes if n not in srcs]

    def _out_edges(self) -> Dict[str, List[GraphEdge]]:
        out: Dict[str, List[GraphEdge]] = {}
        for e in self.edges:
            out.setdefault(e.src, []).append(e)
        return out


class GraphState:
    """Per-submission readiness: the live indegree counters, the operand
    slots filled so far (static operands, then wired producer outputs)
    and the node → `Ticket` map the runtime fills at submission.  All
    mutation happens here, so the `OpGraph` stays reusable."""

    __slots__ = ("graph", "order", "indegree", "out", "slots", "tickets",
                 "remaining", "released")

    def __init__(self, graph: OpGraph):
        self.graph = graph
        self.order = graph.validate()
        self.out = graph._out_edges()
        self.indegree: Dict[str, int] = {n: 0 for n in self.order}
        for e in graph.edges:
            self.indegree[e.dst] += 1
        self.slots: Dict[str, Dict[object, object]] = {
            n: dict(graph.nodes[n].operands) for n in self.order}
        self.tickets: Dict[str, object] = {}
        self.released: set = set()
        self.remaining = len(self.order)

    def ready(self) -> List[str]:
        """The zero-indegree frontier not yet handed to the runtime
        (initially the roots)."""
        return [n for n in self.order
                if self.indegree[n] == 0 and n not in self.released]

    def mark_released(self, name: str) -> None:
        self.released.add(name)

    def complete(self, name: str, result) -> List[str]:
        """Record ``name``'s completion: wire its output into its
        dependents' slots (a data edge's ``transform``, or a reshape to
        the slot's shape, which of a contiguous output is a view of the
        same storage) and return the newly ready node names."""
        self.remaining -= 1
        newly: List[str] = []
        for e in self.out.get(name, ()):
            if e.slot is not None and result is not None:
                if e.transform is not None:
                    value = e.transform(result)
                else:
                    value = result.reshape(
                        slot_shape(self.graph.nodes[e.dst].desc, e.slot))
                self.slots[e.dst][e.slot] = value
            self.indegree[e.dst] -= 1
            if self.indegree[e.dst] == 0:
                newly.append(e.dst)
        return newly

    def operands_for(self, name: str) -> Optional[tuple]:
        """``name``'s operands in family order, or None while any slot is
        unknown (a shadow node)."""
        node = self.graph.nodes[name]
        want = FAMILY_SLOTS[family_of(node.desc)]
        have = self.slots[name]
        if any(s not in have for s in want):
            return None
        return tuple(have[s] for s in want)

    @property
    def done(self) -> bool:
        return self.remaining == 0
