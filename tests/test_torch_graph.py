"""Dependency-aware op graphs in the port (`repro_torch/runtime/graph.py`,
`Runtime.submit(OpGraph)`, `decode_step_graph`) held to the JAX package
(`tests/test_graph.py`'s cases, each run on both packages).

- Structure: the same validation errors, word for word, and the same
  waves, sinks and topological order; `decode_step_graph` gives the
  reference's nodes, descriptors, tags, edges (kind and slot) and waves
  for every configuration, DeepSeek-V2-Lite's routed experts included.
- Semantics, in shadow mode: both runtimes make the same launches
  (class, mode, CD, tiles, members, modeled times, place on the
  timeline, cache hits), give every ticket — graph, node, piece, bundle
  member — the same seq, times, deadline and rank, and keep the same
  telemetry summary, key for key; over random DAGs of every ported
  family and over decode graphs, under round-robin and EDF, slicing,
  flush budgets and a batching window.
- Execution, on the CPU against the reference in interpret mode:
  integer-valued float32 operands, so every GEMM result is bitwise equal
  to the reference's and to a node-by-node oracle, with the fault
  injector live too; a decode graph with attention and the scan within
  the reference tests' 3e-4.  A wired operand is a view of its
  producer's output.  An executing graph missing an operand is refused
  at submit, before anything is queued.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import ArchConfig as JArch
from repro.core import ConcurrencyController as JCtrl
from repro.core import GOLibrary as JLib
from repro.core.op_desc import GroupedGemmDesc as JGrouped
from repro.core.op_desc import op_from_key as jop_from_key
from repro.runtime import FAMILY_SLOTS as JSLOTS
from repro.runtime import FaultInjector as JInjector
from repro.runtime import FaultRule as JRule
from repro.runtime import GraphError as JGraphError
from repro.runtime import OpGraph as JGraph
from repro.runtime import Runtime as JRuntime
from repro.runtime import RuntimeConfig as JConfig
from repro.runtime import TenantSLO as JSLO
from repro.runtime import decode_step_graph as jdecode_graph
from repro.runtime import submit_decode_graph as jsubmit_graph
from repro.runtime import submit_decode_step as jsubmit_step
from repro.runtime.graph import out_shape as jout_shape
from repro.runtime.graph import slot_shape as jslot_shape
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.core import (
    AttentionDesc,
    ConcurrencyController,
    GemmDesc,
    GemmRequest,
    GOLibrary,
    GroupedGemmDesc,
    ScanDesc,
    family_of,
)
from repro_torch.core.scheduler import GroupPlan, Schedule, bind_operands, execute_schedule
from repro_torch.runtime import (
    FAMILY_SLOTS,
    MIXED_CLASS,
    FaultInjector,
    FaultRule,
    GraphError,
    OpGraph,
    Runtime,
    RuntimeConfig,
    TenantSLO,
    decode_step_descs,
    decode_step_graph,
    decode_step_op_descs,
    submit_decode_graph,
    submit_decode_step,
)
from repro_torch.runtime.graph import operand_shape, out_shape, slot_shape
from tests.hypothesis_compat import given, settings, st

D = GemmDesc(32, 32, 32, dtype="f32")          # square: any wiring is legal
D64 = GemmDesc(64, 64, 64, dtype="f32")
ATTN_TOL = 3e-4                                 # the reference tests' f32 tolerance


def _j(d):
    return jop_from_key(d.key())


def _cfgs(name: str):
    """The port's and the reference's `ArchConfig` of ``name``; a config
    the port lacks (A12) is built from the reference's fields, which
    match the port's one for one.  ``"mla"`` / ``"mla-q"``: the two
    DeepSeek-V2 configurations with their routed experts taken out, to
    reach the MLA branch (with and without the q up-projection)."""
    base = {"mla": "deepseek-v2-lite-16b", "mla-q": "deepseek-v2-236b"}.get(name, name)
    j = jget_arch(base)
    if base != name:
        j = dataclasses.replace(j, n_routed_experts=0)
    assert [f.name for f in dataclasses.fields(JArch)] == \
        [f.name for f in dataclasses.fields(ArchConfig)]
    p = ArchConfig(**{f.name: getattr(j, f.name) for f in dataclasses.fields(ArchConfig)})
    if name in ("qwen3-14b", "zamba2-1.2b"):
        assert get_arch(name) == p
    return p, j


def _ints(seed: int, shape) -> np.ndarray:
    # integer-valued f32: exact in any f32 summation order
    r = np.random.default_rng(seed)
    return r.integers(-3, 4, size=shape).astype(np.float32)


# ------------------------------------------------------ graphs in both
class Spec:
    """A graph described once and built in either package: nodes of port
    descriptors with numpy operands, ``deps`` (slot → producer, or
    (producer, transform): a transform indexes as torch and jax both
    do) and ``after``."""

    def __init__(self):
        self.nodes = []

    def add(self, name, desc, deps=None, after=(), operands=None, tag=""):
        self.nodes.append((name, desc, dict(deps or {}), list(after),
                           dict(operands or {}), tag))
        return name

    def build(self, pkg: str):
        port = pkg == "port"
        g = OpGraph() if port else JGraph()
        conv = torch.from_numpy if port else jnp.asarray
        for name, desc, deps, after, ops, tag in self.nodes:
            g.add(name, desc if port else _j(desc), deps=deps, after=after,
                  operands={s: conv(x) for s, x in ops.items()}, tag=tag)
        return g


def _chain(n: int) -> Spec:
    """n0 -> n1 -> ... feeding each successor's "a" slot."""
    s = Spec()
    s.add("n0", D, operands={"a": _ints(0, (D.M, D.K)), "b": _ints(1, (D.K, D.N))})
    for i in range(1, n):
        s.add(f"n{i}", D, deps={"a": f"n{i-1}"}, operands={"b": _ints(i + 1, (D.K, D.N))})
    return s


class Pair:
    """The reference's runtime (interpret mode when executing) and the
    port's on the CPU, same config, each with a fresh library and, given
    ``rules`` ((args, kwargs) of `FaultRule`), an injector of the same
    rules and seed."""

    def __init__(self, execute: bool = False, rules=None, seed: int = 1, **cfg):
        cfg.setdefault("window_s", 0.0)
        pinj = jinj = None
        if rules is not None:
            pinj = FaultInjector(tuple(FaultRule(*a, **k) for a, k in rules), seed=seed)
            jinj = JInjector(tuple(JRule(*a, **k) for a, k in rules), seed=seed)
        self.j = JRuntime(JCtrl(library=JLib()), JConfig(
            execute=execute, interpret=True if execute else None, **cfg),
            fault_injector=jinj)
        self.p = Runtime(ConcurrencyController(GOLibrary()),
                         RuntimeConfig(execute=execute, **cfg), device="cpu",
                         fault_injector=pinj)
        self.handles = []
        self.launches = ([], [])

    @property
    def both(self):
        return (self.j, self.p)

    def slo(self, tenant: str, *args, **kw) -> None:
        self.j.set_tenant_slo(tenant, JSLO(*args, **kw))
        self.p.set_tenant_slo(tenant, TenantSLO(*args, **kw))

    def submit(self, work, tenant="default", now=0.0):
        """A `Spec` (a graph), a desc or a list of descs (operand-free)."""
        if isinstance(work, Spec):
            jw, pw = work.build("reference"), work.build("port")
        elif isinstance(work, list):
            jw, pw = [_j(d) for d in work], [GemmRequest(desc=d) for d in work]
        else:
            jw, pw = _j(work), GemmRequest(desc=work)
        pair = (self.j.submit(jw, tenant=tenant, now=now),
                self.p.submit(pw, tenant=tenant, now=now))
        self.handles.append(pair)
        return pair

    def submit_graphs(self, jg, pg, tenant="default", now=0.0):
        pair = (self.j.submit(jg, tenant=tenant, now=now),
                self.p.submit(pg, tenant=tenant, now=now))
        self.handles.append(pair)
        return pair

    def flush(self, now, force=False):
        jl, pl = (rt.flush(now=now, force=force) for rt in self.both)
        assert _launches(pl) == _launches(jl)
        self.launches[0].extend(jl)
        self.launches[1].extend(pl)
        return jl, pl

    def drain(self, now=0.0):
        jl, pl = (rt.drain(now=now) for rt in self.both)
        assert _launches(pl) == _launches(jl)
        self.launches[0].extend(jl)
        self.launches[1].extend(pl)
        return jl, pl

    def check(self):
        """The same tickets, timeline, queues, plans and telemetry."""
        jh, ph = zip(*self.handles) if self.handles else ((), ())
        assert [_ticket(t) for t in ph] == [_ticket(t) for t in jh]
        assert self.p.device_free_t == self.j.device_free_t
        assert self.p.queue_depths() == self.j.queue_depths()
        assert self.p.plan_cache_size == self.j.plan_cache_size
        js, ps = self.j.telemetry.summary(), self.p.telemetry.summary()
        for s in (js, ps):
            s.pop("class_ratios")       # each package's own clock
        assert ps == js
        assert [_record(g) for g in self.p.telemetry.groups] == \
            [_record(g) for g in self.j.telemetry.groups]


def _launches(launches):
    return [(ln.class_key, ln.plan.mode, ln.plan.cd, ln.plan.tile.key(),
             None if ln.plan.tiles is None else [t.key() for t in ln.plan.tiles],
             [t.seq for t in ln.tickets], ln.plan.modeled_time_s, ln.start_t,
             ln.end_t, ln.cache_hit, ln.fallback, ln.penalty_s) for ln in launches]


def _ticket(tk):
    return (tk.seq, tk.tenant, tk.kind, tk.logical, tk.node, tk.submit_t,
            tk.deadline_t, tk.rank, tk.done_t, tk.done, tk.sliced,
            None if tk.request is None else tk.request.desc.key(),
            None if tk.request is None else tk.request.tag,
            None if tk.graph is None else tk.graph.seq,
            None if tk.pieces is None else [_ticket(p) for p in tk.pieces],
            None if tk.members is None else [_ticket(m) for m in tk.members],
            None if tk.nodes is None else {n: _ticket(t) for n, t in tk.nodes.items()})


def _record(g):
    return (g.flush_id, g.class_key, g.tenants, g.cd, g.mode, g.modeled_time_s,
            g.cache_hit, g.fallback, g.graph_ids)


def _structure(g):
    return ([(n.name, n.desc.key(), n.tag, sorted(map(str, n.operands)))
             for n in g.nodes.values()],
            [(e.src, e.dst, e.slot, e.transform) for e in g.edges],
            g.validate(), g.waves(), g.sinks(), len(g))


# ------------------------------------------------------------- structure
def _dup(G, d, big):
    g = G()
    g.add("x", d)
    g.add("x", d)


def _unknown(G, d, big):
    g = G()
    g.add("x", d, deps={"a": "ghost"})
    g.validate()


def _self_edge(G, d, big):
    g = G()
    g.add("x", d)
    g.add_edge("x", "x", slot="a")
    g.validate()


def _cycle(G, d, big):
    g = G()
    g.add("a", d)
    g.add("b", d, deps={"a": "a"})
    g.add_edge("b", "a", slot="b")
    g.validate()


def _bad_slot(G, d, big):
    g = G()
    g.add("x", d)
    g.add("y", d, deps={"q": "x"})       # gemm slots are "a"/"b"
    g.validate()


def _double_wired(G, d, big):
    g = G()
    g.add("x", d)
    g.add("y", d)
    g.add("z", d, deps={"a": "x"})
    g.add_edge("y", "z", slot="a")
    g.validate()


def _size_mismatch(G, d, big):
    g = G()
    g.add("big", big)
    g.add("small", d, deps={"a": "big"})   # 4096 elements into 1024
    g.validate()


@pytest.mark.parametrize("build, match", [
    (_dup, "duplicate"), (_unknown, "ghost"), (_self_edge, "self-edge"),
    (_cycle, "cycle involving: a, b"), (_bad_slot, "slot 'q' invalid"),
    (_double_wired, "wired twice"), (_size_mismatch, "size mismatch")],
    ids=["duplicate", "unknown", "self_edge", "cycle", "bad_slot", "double_wired",
         "size_mismatch"])
def test_validation_errors_match_reference(build, match):
    msgs = []
    for G, err, d, big in ((OpGraph, GraphError, D, D64),
                           (JGraph, JGraphError, _j(D), _j(D64))):
        with pytest.raises(err, match=match) as info:
            build(G, d, big)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    assert issubclass(GraphError, ValueError)


def test_transform_and_control_edges_skip_size_checks():
    """An explicit transform takes responsibility for the layout; a control
    edge carries no data, so neither is size-checked."""
    for G, d, big in ((OpGraph, D, D64), (JGraph, _j(D), _j(D64))):
        g = G()
        g.add("big", big)
        g.add("small", d, deps={"a": ("big", lambda r: r[:32, :32])})
        g.validate()
        g2 = G()
        g2.add("big", big)
        g2.add("small", d, after=["big"])
        assert g2.waves() == [["big"], ["small"]]


def test_waves_are_longest_chain_levels():
    # a diamond with a long arm: d's level is driven by the a->b->c chain
    s = Spec()
    s.add("a", D)
    s.add("b", D, deps={"a": "a"})
    s.add("c", D, deps={"a": "b"})
    s.add("d", D, deps={"a": "a"}, after=["c"])
    pg, jg = s.build("port"), s.build("reference")
    assert pg.waves() == jg.waves() == [["a"], ["b"], ["c"], ["d"]]
    assert pg.sinks() == jg.sinks() == ["d"]
    assert pg.validate() == jg.validate() == ["a", "b", "c", "d"]
    assert pg.descs() == [D] * 4 and len(pg) == 4


def test_family_slots_and_shapes_match_reference():
    assert FAMILY_SLOTS == JSLOTS
    descs = [D, GemmDesc(8, 64, 32, ta=True, tb=True), AttentionDesc(2, 8, 2, 1, 64, 16),
             ScanDesc(2, 3, 4, 8, 16)]
    for d in descs:
        assert out_shape(d) == jout_shape(_j(d))
        for slot in FAMILY_SLOTS[family_of(d)]:
            assert slot_shape(d, slot) == jslot_shape(_j(d), slot)


def test_grouped_expert_gemm_raises_naming_a10():
    """The grouped expert GEMM, once refused naming ROADMAP A10: its
    shapes are the reference's, its weight slot takes one (G, K, N) tensor
    or G (K, N) ones, and a graph holding two chained pools plans and
    completes as the reference's in shadow mode."""
    gd = GroupedGemmDesc(4, 32, 64, 128, "bf16")
    assert _j(gd) == JGrouped(4, 32, 64, 128, "bf16")
    assert out_shape(gd) == jout_shape(_j(gd)) == (32, 64)
    for slot in FAMILY_SLOTS["grouped_gemm"]:
        assert slot_shape(gd, slot) == jslot_shape(_j(gd), slot)
    stacked = torch.zeros(4, 128, 64)
    assert operand_shape(stacked) == operand_shape(list(stacked)) == slot_shape(gd, 1)
    with pytest.raises(GraphError, match="one shape"):
        operand_shape([torch.zeros(128, 64), torch.zeros(64, 128)])
    down = GroupedGemmDesc(4, 32, 128, 64, "bf16")
    pair = Pair()
    graphs = []
    for G in (JGraph, OpGraph):
        g = G()
        g.add("up", gd if G is OpGraph else _j(gd))
        g.add("down", down if G is OpGraph else _j(down), deps={0: "up"})
        graphs.append(g)
    pair.submit_graphs(*graphs)
    pair.drain()
    pair.check()
    assert [ln.plan.mode for ln in pair.launches[1]] == ["single", "single"]


# --------------------------------------------------------- decode graphs
@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b", "stablelm-3b",
                                  "xlstm-350m", "mla", "mla-q",
                                  "deepseek-v2-lite-16b"])
def test_decode_step_graph_equals_reference(arch, batch, layers):
    pcfg, jcfg = _cfgs(arch)
    pg = decode_step_graph(pcfg, batch, 2048, layers=layers)
    jg = jdecode_graph(jcfg, batch, 2048, layers=layers)
    assert _structure(pg) == _structure(jg)
    assert len(pg.waves()) >= 3 and pg.sinks()
    # the same op population as the flat bundle, layer after layer, but
    # the routed experts' dense per-expert GEMMs: the graph carries them
    # only as the grouped pools (ROADMAP C11)
    flat = decode_step_op_descs(pcfg, batch, 2048)
    for tag, bundle in decode_step_descs(pcfg, batch):
        if tag.startswith("expert"):
            for d in bundle:
                flat.remove(d)
    assert sorted(d.key() for d in pg.descs()) == sorted(d.key() for d in flat * layers)
    if layers > 1:
        assert all(n.startswith(("L0.", "L1.", "L2.")) for n in pg.nodes)


def test_decode_step_graph_refuses_routed_experts():
    """The routed-expert graph, once refused naming ROADMAP A10: the
    reference's MoE wiring (moe-up → moe-down a data edge, moe-up after
    the O-projection by a control edge, the shared experts' gate/up →
    down), and `submit_decode_graph` in shadow mode launching as the
    reference's."""
    pcfg, jcfg = _cfgs("deepseek-v2-lite-16b")
    assert get_arch("deepseek-v2-lite-16b") == pcfg
    g = decode_step_graph(pcfg, 4)
    edges = {(e.src, e.dst): e.slot for e in g.edges}
    assert edges[("moe-up", "moe-down")] == 0 and edges[("o", "moe-up")] is None
    assert edges[("shared-up", "shared-down")] == "a"
    assert edges[("shared-gate", "shared-down")] is None
    assert g.nodes["moe-up"].desc == GroupedGemmDesc(24, 24, 1408, 2048)
    assert sorted(g.sinks()) == ["moe-down", "shared-down"]
    pair = Pair()
    for ti, batch in enumerate((1, 16)):
        pair.handles.append((jsubmit_graph(pair.j, jcfg, batch, 2048, layers=2,
                                           tenant=f"t{ti}", now=0.0),
                             submit_decode_graph(pair.p, pcfg, batch, 2048, layers=2,
                                                 tenant=f"t{ti}", now=0.0)))
    pair.drain()
    pair.check()
    modes = {ln.plan.mode for ln in pair.launches[1]}
    assert pair.p.pending() == 0 and modes <= {"single", "mixed"}


# --------------------------------------------- the one submit() surface
def test_submit_is_polymorphic_and_handles_are_uniform():
    pair = Pair()
    op = pair.submit(D)
    bundle = pair.submit([D, GemmDesc(64, 128, 128)])
    graph = pair.submit(_chain(3))
    pair.drain()
    pair.check()
    _, op, bundle, graph = (None, op[1], bundle[1], graph[1])
    assert (op.kind, bundle.kind, graph.kind) == ("op", "bundle", "graph")
    assert op.done and bundle.done and graph.done
    assert (op.logical, bundle.logical, graph.logical) == (True, False, True)
    # uniform addressing: bundles by position, graphs by node name
    assert bundle[0].desc == D
    assert graph["n2"].done_t == graph.done_t
    assert set(graph.nodes) == {"n0", "n1", "n2"}
    assert graph["n1"].kind == "node" and not graph["n1"].logical
    assert graph["n1"].graph is graph and graph["n1"].node == "n1"
    assert graph.results() == {"n0": None, "n1": None, "n2": None}
    assert graph.result_of("n0") is None and op.results() == {op.seq: None}
    with pytest.raises(TypeError, match="no constituents"):
        op["n0"]


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b"])
def test_prewarm_is_polymorphic_and_seeds_every_wave_plan(arch):
    """A graph seeds each wave's mixed signature (so a lone graph's flushes
    all hit), a sequence with a non-GEMM member the bundle's, GEMMs alone
    each class's all-at-once plan — the same plans and counters as the
    reference's."""
    pcfg, jcfg = _cfgs(arch)
    pg = decode_step_graph(pcfg, 4, 1024, layers=2)
    jg = jdecode_graph(jcfg, 4, 1024, layers=2)
    pair = Pair()
    bundle = decode_step_op_descs(pcfg, 2, 1024)
    gemms = [d for d in bundle if family_of(d) == "gemm"]
    for work in (pg, bundle, gemms):
        jw = jg if work is pg else [_j(d) for d in work]
        assert pair.p.prewarm(work) == pair.j.prewarm(jw)
        pair.check()
    assert pair.p.telemetry.prewarmed_plans > len(pg.waves()) // 2
    pair.submit_graphs(jg, pg, now=0.0)
    _, launches = pair.drain()
    assert launches and all(ln.cache_hit for ln in launches)
    assert all(ln.class_key == MIXED_CLASS for ln in launches)
    pair.check()


# -------------------------------------------------- dataflow semantics
def test_nodes_complete_in_topological_order():
    pcfg, jcfg = _cfgs("stablelm-3b")
    pair = Pair()
    jh, ph = pair.submit_graphs(jdecode_graph(jcfg, 8), decode_step_graph(pcfg, 8))
    pair.drain()
    pair.check()
    g = ph.state.graph
    done = {n: ph.nodes[n].done_t for n in g.nodes}
    for e in g.edges:
        assert done[e.src] < done[e.dst], (e.src, e.dst)
    assert ph.done_t == max(done.values())


def test_graph_is_one_logical_request():
    pcfg, jcfg = _cfgs("stablelm-3b")
    pair = Pair()
    _, h = pair.submit_graphs(jdecode_graph(jcfg, 8), decode_step_graph(pcfg, 8),
                              tenant="t0")
    pair.drain()
    pair.check()
    tele = pair.p.telemetry
    assert tele.submitted == tele.completed == 1          # not len(g)
    assert tele.graphs_submitted == tele.graphs_completed == 1
    assert tele.graph_nodes == len(h.nodes)
    assert h.latency_s == h.done_t > 0
    pct = tele.tenant_percentiles()["t0"]
    assert pct["n"] == 1 and pct["p99_ms"] == pytest.approx(h.latency_s * 1e3, abs=1e-3)


def test_concurrent_graphs_share_mixed_groups():
    pair = Pair()
    for arch in ("qwen3-14b", "zamba2-1.2b"):
        pcfg, jcfg = _cfgs(arch)
        pair.submit_graphs(jdecode_graph(jcfg, 4, layers=2),
                           decode_step_graph(pcfg, 4, layers=2), tenant=arch)
    pair.drain()
    pair.check()
    assert all(h.done for _, h in pair.handles)
    tele = pair.p.telemetry
    assert tele.cross_graph_groups() >= 1 and tele.max_ready_depth >= 2
    assert tele.ready_depth_histogram() and tele.graphs_completed == 2


def test_submit_decode_graph_and_step_match_reference():
    pcfg, jcfg = _cfgs("zamba2-1.2b")
    pair = Pair()
    pair.handles.append((jsubmit_graph(pair.j, jcfg, 4, 512, layers=2, tenant="g",
                                       now=0.0),
                         submit_decode_graph(pair.p, pcfg, 4, 512, layers=2,
                                             tenant="g", now=0.0)))
    jt = jsubmit_step(pair.j, jcfg, 8, tenant="s", now=0.0)
    pt = submit_decode_step(pair.p, pcfg, 8, tenant="s", now=0.0)
    assert len(pt) == len(jt) >= 4
    pair.handles += list(zip(jt, pt))
    pair.drain(now=1.0)
    pair.check()
    assert pair.p.telemetry.completed == 1 + len(pt)


# traffic for the traces: the decode graphs of both ported configurations
TRACE_CONFIGS = {
    "round-robin": {},
    "window": dict(window_s=2e-5),
    "edf-sliced": dict(policy="edf", slicing=True, flush_budget_s=1e-4,
                       slice_budget_frac=0.5, max_slices=4),
    "edf-window": dict(policy="edf", window_s=1e-5, flush_budget_s=5e-5),
}


def _tick(pair: Pair, until: float, step: float) -> None:
    t = 0.0
    while t < until:
        pair.flush(now=t)
        t += step


@pytest.mark.parametrize("config", sorted(TRACE_CONFIGS))
@pytest.mark.parametrize("batch", [1, 4, 16])
def test_decode_graph_traces_match_reference(batch, config):
    """Tenants' decode graphs (full-width Qwen3-14B and Zamba2-1.2B, two
    layers) arriving apart, flushed on a clock, then drained: the same
    launches, tickets (pieces of sliced nodes included), deadlines and
    telemetry as the reference's."""
    pair = Pair(**TRACE_CONFIGS[config])
    pair.slo("lat", "latency", weight=4.0, p99_target_s=1e-3)
    pair.slo("bat", "batch", weight=1.0, p99_target_s=5e-3)
    for i, (arch, tenant) in enumerate((("qwen3-14b", "lat"), ("zamba2-1.2b", "bat"),
                                        ("qwen3-14b", "bat"))):
        pcfg, jcfg = _cfgs(arch)
        pair.submit_graphs(jdecode_graph(jcfg, batch, 2048, layers=2),
                           decode_step_graph(pcfg, batch, 2048, layers=2),
                           tenant=tenant, now=i * 1e-5)
        pair.flush(now=i * 1e-5)
    _tick(pair, until=2e-4, step=1e-5)
    pair.drain(now=2e-4)
    pair.check()
    tele = pair.p.telemetry
    assert tele.graphs_completed == 3 and all(h.done for _, h in pair.handles)
    if config == "edf-sliced" and batch > 1:
        assert tele.sliced_ops > 0
    if config.startswith("edf") and TRACE_CONFIGS[config].get("flush_budget_s"):
        assert tele.deferred_launches > 0


# a pool of every ported family: decode and prefill shapes, sliceable ones
POOL = [D, GemmDesc(8, 256, 512), GemmDesc(4096, 512, 512),
        AttentionDesc(2, 4, 2, 1, 256, 64), AttentionDesc(1, 8, 2, 512, 512, 64),
        ScanDesc(2, 1, 4, 16, 16), ScanDesc(4, 64, 4, 16, 16)]
FIRST_SLOT = {"gemm": "a", "flash_attention": 0, "mamba_scan": 0}


def _random_spec(picks, parents) -> Spec:
    """Node i runs POOL[picks[i]] after ``parents[i]`` (earlier nodes): a
    data edge into its first slot from the first parent whose output has
    as many elements, control edges from the rest."""
    s = Spec()
    for i, (k, ps) in enumerate(zip(picks, parents)):
        d = POOL[k]
        slot = FIRST_SLOT[family_of(d)]
        deps, after = {}, []
        for p in ps:
            src = POOL[picks[p]]
            if not deps and math.prod(out_shape(src)) == math.prod(slot_shape(d, slot)):
                deps[slot] = f"n{p}"
            else:
                after.append(f"n{p}")
        s.add(f"n{i}", d, deps=deps, after=after)
    return s


@st.composite
def _dags(draw):
    n = draw(st.integers(2, 7), label="nodes")
    picks = [draw(st.integers(0, len(POOL) - 1)) for _ in range(n)]
    parents = [sorted(set(draw(st.lists(st.integers(0, i - 1), max_size=2))))
               if i else [] for i in range(n)]
    return picks, parents


@given(dags=st.lists(_dags(), min_size=1, max_size=3),
       arrivals=st.lists(st.sampled_from([0.0, 1e-5, 4e-5]), min_size=3, max_size=3),
       tenants=st.lists(st.sampled_from(["lat", "bat", "heavy"]), min_size=3, max_size=3),
       policy=st.sampled_from(["edf", "round-robin"]),
       budget=st.sampled_from([None, 1e-4, 1e-6]), slicing=st.booleans(),
       window=st.sampled_from([0.0, 1e-5]))
@settings(max_examples=25, deadline=None)
def test_random_dag_traces_match_reference(dags, arrivals, tenants, policy, budget,
                                           slicing, window):
    """Random DAGs of every ported family, submitted by tenants of unequal
    rank and weight at different times, through both runtimes in shadow
    mode: the same launches, timeline, tickets and telemetry; every graph
    completes, each node after its producers, and the timeline never runs
    backwards across deferrals."""
    pair = Pair(window_s=window, policy=policy, slicing=slicing, flush_budget_s=budget,
                slice_budget_frac=0.05)
    pair.slo("lat", "latency", weight=4.0, p99_target_s=1e-3)
    pair.slo("heavy", "batch", weight=3.0)
    for i, (picks, parents) in enumerate(dags):
        pair.submit(_random_spec(picks, parents), tenant=tenants[i], now=arrivals[i])
        pair.flush(now=arrivals[i])
    _tick(pair, until=6e-5, step=1e-5)
    _, launches = pair.drain(now=6e-5)
    pair.check()
    for _, h in pair.handles:
        assert h.done and h.done_t is not None
        for e in h.state.graph.edges:
            assert h.nodes[e.src].done_t <= h.nodes[e.dst].done_t
    starts = [ln.start_t for ln in pair.launches[1]]
    assert starts == sorted(starts)
    assert pair.p.telemetry.graphs_completed == len(dags)


# ------------------------------------------------------------- execution
def _oracle(rt: Runtime, graph: OpGraph) -> dict:
    """The graph run node by node in topological order through
    `execute_schedule`, each alone at its isolated tile."""
    results = {}
    for name in graph.validate():
        node = graph.nodes[name]
        slots = dict(node.operands)
        for e in graph.edges:
            if e.dst == name and e.slot is not None:
                r = results[e.src]
                slots[e.slot] = (e.transform(r) if e.transform is not None
                                 else r.reshape(slot_shape(node.desc, e.slot)))
        req = bind_operands(node.desc, tuple(
            slots[s] for s in FAMILY_SLOTS[family_of(node.desc)]))
        tile = rt.ctrl.lib.get(node.desc).isolated
        sched = Schedule(groups=[GroupPlan(indices=[0], cd=1, tile=tile, mode="single",
                                           modeled_time_s=0.0)])
        (results[name],) = execute_schedule([req], sched)
    return results


def _bitwise(pair: Pair, jh, ph) -> None:
    """Every node's result bitwise the reference's and the oracle's."""
    expect = _oracle(Runtime(ConcurrencyController(GOLibrary()), device="cpu"),
                     ph.state.graph)
    assert set(ph.results()) == set(expect)
    for name, want in expect.items():
        got = ph.result_of(name)
        assert got is not None and torch.equal(got, want), name
        np.testing.assert_array_equal(got.numpy(), np.asarray(jh.result_of(name)))


def test_graph_executes_bitwise_vs_sequential():
    pair = Pair(execute=True)
    jh, ph = pair.submit(_chain(3))
    pair.drain()
    pair.check()
    _bitwise(pair, jh, ph)
    # the default wiring is a reshape of a contiguous output: a view of
    # the producer's storage, which the dependent's request carries
    for prod, cons in (("n0", "n1"), ("n1", "n2")):
        a = ph[cons].request.a
        assert a.data_ptr() == ph.result_of(prod).data_ptr() and a.is_contiguous()


def test_sliced_node_completes_through_the_merge_before_its_dependents():
    """With every sliceable op sliced, a chain's head runs as pieces; its
    dependent sees the merged result (the parent's), bitwise as unsliced."""
    pair = Pair(execute=True, slicing=True, flush_budget_s=10.0, slice_budget_frac=1e-9)
    jh, ph = pair.submit(_chain(3))
    pair.drain()
    pair.check()
    assert ph["n0"].sliced and ph["n0"].pieces
    assert pair.p.telemetry.sliced_ops == 3
    _bitwise(pair, jh, ph)
    assert ph["n1"].request.a.data_ptr() == ph["n0"].result.data_ptr()
    assert min(p.done_t for p in ph["n1"].pieces) > ph["n0"].done_t


def _random_dag(seed: int, n: int, edges: list) -> Spec:
    """A GEMM DAG over square 32^3 descs: node i may feed node j>i's "a"
    slot; "b" and unfed "a" slots carry integer operands."""
    s = Spec()
    fed = {j for _, j in edges}
    for i in range(n):
        ops = {"b": _ints(seed * 97 + 2 * i, (D.K, D.N))}
        if i not in fed:
            ops["a"] = _ints(seed * 97 + 2 * i + 1, (D.M, D.K))
        s.add(f"n{i}", D, deps={"a": f"n{src}" for src, j in edges if j == i},
              operands=ops)
    return s


@settings(max_examples=8, deadline=None)
@given(st.data())
def test_random_dags_match_sequential_execution(data):
    """`tests/test_graph.py:342` on both packages: executed random DAGs,
    with a fault injector that makes the first two attempts raise when
    drawn, are bitwise the reference's and the oracle's, with the same
    ladder trace (faults, fallback rungs, penalties)."""
    n = data.draw(st.integers(2, 4), label="nodes")
    edges = []
    for j in range(1, n):
        src = data.draw(st.one_of(st.none(), st.integers(0, j - 1)), label=f"parent[{j}]")
        if src is not None:
            edges.append((src, j))
    seed = data.draw(st.integers(0, 2 ** 16), label="seed")
    faulty = data.draw(st.booleans(), label="faulty")
    rules = [(("raise", 1.0), {"max_faults": 2})] if faulty else None
    pair = Pair(execute=True, rules=rules)
    jh, ph = pair.submit(_random_dag(seed, n, edges))
    pair.drain()
    pair.check()
    assert ph.done and pair.p.telemetry.graphs_completed == 1
    assert (pair.p.telemetry.fault_events == 2) == faulty
    for e in ph.state.graph.edges:
        assert ph.nodes[e.src].done_t <= ph.nodes[e.dst].done_t
    _bitwise(pair, jh, ph)


@pytest.mark.parametrize("arch", ["qwen3-14b", "zamba2-1.2b"])
def test_executed_decode_graph_matches_reference(arch):
    """Two layers of a reduced configuration's decode graph, executed in
    f32 on both runtimes, the roots' activations, the weights, the KV
    caches and (Zamba2) the scan inputs static, everything else wired:
    the same launches, and every node within 3e-4 of the reference's."""
    pcfg = get_arch(arch).reduced()
    pg = decode_step_graph(pcfg, 2, 64, dtype="f32", layers=2)
    rng = np.random.default_rng(5)
    wired = {(e.dst, e.slot) for e in pg.edges if e.slot is not None}
    s = Spec()
    for name, node in pg.nodes.items():
        ops = {}
        for slot in FAMILY_SLOTS[family_of(node.desc)]:
            if (name, slot) in wired:
                continue
            shape = slot_shape(node.desc, slot)
            ops[slot] = (rng.uniform(-0.5, 0.0, shape) if slot == 1 and
                         family_of(node.desc) == "mamba_scan"
                         else rng.standard_normal(shape) * 0.5).astype(np.float32)
        deps = {e.slot: e.src for e in pg.edges if e.dst == name and e.slot is not None}
        after = [e.src for e in pg.edges if e.dst == name and e.slot is None]
        s.add(name, node.desc, deps=deps, after=after, operands=ops, tag=node.tag)
    pair = Pair(execute=True)
    jh, ph = pair.submit(s)
    pair.drain()
    pair.check()
    fams = {family_of(d) for d in pg.descs()}
    assert {"gemm", "flash_attention"} <= fams
    for name in pg.nodes:
        np.testing.assert_allclose(ph.result_of(name).numpy(),
                                   np.asarray(jh.result_of(name)),
                                   rtol=ATTN_TOL, atol=ATTN_TOL, err_msg=name)
    # a wired operand is its producer's output reshaped: a view of the same
    # storage where that output is contiguous (every kernel's on the card;
    # on the CPU the scan's plain version returns a strided y, so its
    # reshape copies)
    for e in pg.edges:
        if e.slot is not None:
            got = ph[e.dst].request.operands[FAMILY_SLOTS[family_of(
                pg.nodes[e.dst].desc)].index(e.slot)]
            prod = ph.result_of(e.src)
            assert torch.equal(got, prod.reshape(got.shape)), (e.src, e.dst)
            assert (got.data_ptr() == prod.data_ptr()) == prod.is_contiguous()


def test_executing_graph_missing_operand_refused_at_submit():
    """Every slot of every node must be a static operand or a data edge's,
    each static operand on the runtime's device: else submit raises,
    naming the node and the slot, before anything is queued.  A shadow
    runtime takes the same graph."""
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    for drop, slot in ((("n1", "b"), "'b'"), (("n0", "a"), "'a'")):
        s = _chain(3)
        s.nodes = [(n, d, deps, after, {k: v for k, v in ops.items() if (n, k) != drop},
                    tag) for n, d, deps, after, ops, tag in s.nodes]
        with pytest.raises(ValueError, match=f"node '{drop[0]}' slot {slot}"):
            rt.submit(s.build("port"), now=0.0)
    g = _chain(2).build("port")
    g.nodes["n1"].operands["b"] = torch.empty((D.K, D.N), device="meta")
    with pytest.raises(ValueError, match="node 'n1' slot 'b': operand on meta"):
        rt.submit(g, now=0.0)
    assert rt.pending() == 0 and rt._seq == 0 and rt.telemetry.submitted == 0
    shadow = Runtime(ConcurrencyController(GOLibrary()), RuntimeConfig(window_s=0.0),
                     device="cpu")
    h = shadow.submit(decode_step_graph(get_arch("qwen3-14b"), 2, 128), now=0.0)
    shadow.drain(now=0.0)
    assert h.done and all(r is None for r in h.results().values())


def test_refusal_raises_out_of_drain_and_leaves_nothing_to_spin_on():
    """A node whose wired operand its kernel refuses (here a transform of
    the wrong shape: the GEMM's ValueError, which the ladder does not
    catch) raises out of `drain` with no fault struck; the graph stays
    unfinished, its dependent never released, and a second drain returns
    at once.  (The reference's interpret-mode kernel checks no shape.)"""
    s = _chain(2)
    name, desc, _, after, ops, tag = s.nodes[1]
    s.nodes[1] = (name, desc, {"a": ("n0", lambda r: r[:, :16])}, after, ops, tag)
    s.add("n2", D, deps={"a": "n1"}, operands={"b": _ints(9, (D.K, D.N))})
    rt = Runtime(ConcurrencyController(GOLibrary()),
                 RuntimeConfig(window_s=0.0, execute=True), device="cpu")
    h = rt.submit(s.build("port"), now=0.0)
    with pytest.raises(ValueError, match="inner dims differ"):
        rt.drain(now=0.0)
    assert rt.drain(now=0.0) == [] and rt.pending() == 0
    assert not h.done and h["n0"].done_t is not None and h["n1"].done_t is None
    assert h["n2"].request is None and rt.telemetry.graphs_completed == 0
    assert rt.telemetry.fault_events == 0 and rt.breaker.quarantined() == []
