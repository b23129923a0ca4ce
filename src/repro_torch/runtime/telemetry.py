"""Serving-runtime telemetry (`repro/runtime/telemetry.py`), for the
parts of the runtime the port carries: per-launch concurrency degree and
mode, modeled vs achieved time, plan-cache effectiveness, queue depths,
per-tenant latency, admission slicing and budget deferrals, the
fallback ladder's faults, fallbacks, quarantines and probes, and the
dataflow graphs' submissions, completions and ready-set depths.  Plain
Python, safe inside the dispatch path.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class GroupRecord:
    """One launched group (one `GroupPlan` bound to live requests)."""

    flush_id: int
    class_key: str
    tenants: List[str]
    cd: int
    mode: str       # "grouped" | "ragged" | "single" | "fused" | "mixed"
    modeled_time_s: float
    achieved_time_s: Optional[float] = None   # device time when executed
    cache_hit: bool = False
    # the fallback rung that completed the launch: None for the planned
    # schedule, else "retry" | "legacy" | "reference"
    fallback: Optional[str] = None
    # the distinct graph handles with a node in this launch; two or more
    # is one request's node sharing a window with another's
    graph_ids: tuple = ()

    @property
    def model_error(self) -> Optional[float]:
        """achieved / modeled — >1 means the model was optimistic."""
        if self.achieved_time_s is None or self.modeled_time_s <= 0:
            return None
        return self.achieved_time_s / self.modeled_time_s


@dataclass
class Telemetry:
    groups: List[GroupRecord] = field(default_factory=list)
    cache_hits: int = 0
    cache_misses: int = 0
    prewarmed_plans: int = 0
    flushes: int = 0
    submitted: int = 0
    completed: int = 0
    depth_hist: Counter = field(default_factory=Counter)
    cp_overhead_paid_s: float = 0.0
    cp_overhead_saved_s: float = 0.0
    # Dispatch fast-path counters: cost-model evaluations and full
    # signature sorts attributable to flush() must both stay zero.
    flush_evals: int = 0
    last_flush_evals: int = 0
    sig_resorts: int = 0
    flush_sig_resorts: int = 0
    # Per-tenant latencies of completed logical requests (a sliced parent
    # counts once, at its last piece), the pieces admission slicing made
    # per tenant, the ops it sliced, and the launches flush budgets
    # deferred to a later flush.
    tenant_lat: Dict[str, List[float]] = field(default_factory=dict)
    slice_counts: Counter = field(default_factory=Counter)
    sliced_ops: int = 0
    deferred_launches: int = 0
    # The fallback ladder: failed launch attempts by kind ("raise" |
    # "nan" | "stall" | "error"), completions by fallback rung,
    # quarantines with the cached plans they evicted, and half-open
    # probes.  They reconcile with the `FaultInjector`'s log.
    faults: Counter = field(default_factory=Counter)
    fallbacks: Counter = field(default_factory=Counter)
    quarantines: int = 0
    quarantine_evictions: int = 0
    probes: int = 0
    # Dataflow graphs: a graph is one logical request (``submitted`` and
    # ``completed`` count it once, at its last node); these count the
    # graphs and their nodes, and the ready-set depth each bundle-queue
    # flush drew from.
    graphs_submitted: int = 0
    graphs_completed: int = 0
    graph_nodes: int = 0
    ready_depth_hist: Counter = field(default_factory=Counter)
    max_ready_depth: int = 0

    # ------------------------------------------------------------- record
    def record_submit(self, n: int = 1) -> None:
        self.submitted += n

    def record_flush(self, queue_depths: Dict[str, int]) -> None:
        self.flushes += 1
        for depth in queue_depths.values():
            self.depth_hist[_bucket(depth)] += 1

    def record_plan(self, hit: bool, overhead_s: float) -> None:
        if hit:
            self.cache_hits += 1
            self.cp_overhead_saved_s += overhead_s
        else:
            self.cache_misses += 1
            self.cp_overhead_paid_s += overhead_s

    def record_sig_resort(self, n: int = 1) -> None:
        self.sig_resorts += n

    def record_flush_fastpath(self, evals: int, resorts: int) -> None:
        self.last_flush_evals = evals
        self.flush_evals += evals
        self.flush_sig_resorts += resorts

    def record_prewarm_plan(self, overhead_s: float) -> None:
        """Offline plan derivation: paid, but not an online cache miss."""
        self.prewarmed_plans += 1
        self.cp_overhead_paid_s += overhead_s

    def record_group(self, rec: GroupRecord) -> None:
        self.groups.append(rec)

    def record_latency(self, tenant: str, latency_s: float) -> None:
        """One logical request completed (a sliced op once, as its
        parent), so ``completed`` matches ``submitted`` under slicing."""
        self.completed += 1
        self.tenant_lat.setdefault(tenant, []).append(latency_s)

    def record_slices(self, tenant: str, parts: int) -> None:
        """Admission sliced one op into ``parts`` pieces."""
        self.sliced_ops += 1
        self.slice_counts[tenant] += parts

    def record_deferred(self, n: int = 1) -> None:
        """Launches a flush budget pushed to a later flush."""
        self.deferred_launches += n

    def record_fault(self, kind: str) -> None:
        """One failed launch attempt, before any fallback."""
        self.faults[kind] += 1

    def record_fallback(self, rung: str) -> None:
        """One launch completed by the fallback rung ``rung``."""
        self.fallbacks[rung] += 1

    def record_quarantine(self, evicted_plans: int = 0) -> None:
        """The breaker quarantined one (family, class, tile), evicting
        ``evicted_plans`` cached plans."""
        self.quarantines += 1
        self.quarantine_evictions += evicted_plans

    def record_probe(self, n: int = 1) -> None:
        """Half-open probes: quarantines released after their cooldown."""
        self.probes += n

    def record_graph_submit(self, nodes: int) -> None:
        """One `OpGraph` of ``nodes`` nodes admitted; its one logical
        submit is recorded apart."""
        self.graphs_submitted += 1
        self.graph_nodes += nodes

    def record_graph_complete(self) -> None:
        """One graph's last node completed (its latency recorded apart)."""
        self.graphs_completed += 1

    def record_ready_depth(self, depth: int) -> None:
        """Graph nodes one bundle-queue flush could draw from."""
        self.ready_depth_hist[_bucket(depth)] += 1
        if depth > self.max_ready_depth:
            self.max_ready_depth = depth

    @property
    def fault_events(self) -> int:
        return sum(self.faults.values())

    @property
    def fallback_events(self) -> int:
        return sum(self.fallbacks.values())

    # ------------------------------------------------------------ derive
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def queue_depth_histogram(self) -> Dict[str, int]:
        """Power-of-two depth buckets, e.g. {"1": 12, "2-3": 40}."""
        return {k: self.depth_hist[k] for k in sorted(self.depth_hist, key=_bucket_lo)}

    def mode_counts(self) -> Dict[str, int]:
        """Launches by mode (``mixed`` counts the bundle queue's groups)."""
        return dict(Counter(g.mode for g in self.groups))

    def mean_cd(self) -> float:
        return (
            sum(g.cd for g in self.groups) / len(self.groups)
            if self.groups else 0.0
        )

    def max_cd(self) -> int:
        return max((g.cd for g in self.groups), default=0)

    def modeled_busy_time_s(self) -> float:
        return sum(g.modeled_time_s for g in self.groups)

    def class_ratios(self) -> Dict[str, Dict[str, float]]:
        """Per-class achieved/modeled aggregates: ``n``, ``geomean_ratio``
        and ``mean_abs_log`` over executed groups."""
        acc: Dict[str, List[float]] = {}
        for g in self.groups:
            r = g.model_error
            if r is not None and r > 0 and math.isfinite(r):
                acc.setdefault(g.class_key, []).append(math.log(r))
        return {
            k: {
                "n": len(logs),
                "geomean_ratio": round(math.exp(sum(logs) / len(logs)), 4),
                "mean_abs_log": round(sum(abs(x) for x in logs) / len(logs), 4),
            }
            for k, logs in sorted(acc.items())
        }

    def cross_graph_groups(self) -> int:
        """Launches whose members came from two or more graphs."""
        return sum(1 for g in self.groups if len(g.graph_ids) >= 2)

    def ready_depth_histogram(self) -> Dict[str, int]:
        """Power-of-two buckets of the flushes' graph ready-set depth."""
        return {k: self.ready_depth_hist[k]
                for k in sorted(self.ready_depth_hist, key=_bucket_lo)}

    def tenant_percentiles(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant p50/p95/p99 latency (ms, nearest rank) plus count."""
        out: Dict[str, Dict[str, float]] = {}
        for tenant in sorted(self.tenant_lat):
            lat = sorted(self.tenant_lat[tenant])
            if not lat:
                continue
            out[tenant] = {
                "n": len(lat),
                "p50_ms": round(_nearest_rank(lat, 0.50) * 1e3, 4),
                "p95_ms": round(_nearest_rank(lat, 0.95) * 1e3, 4),
                "p99_ms": round(_nearest_rank(lat, 0.99) * 1e3, 4),
            }
        return out

    def summary(self) -> Dict[str, object]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "flushes": self.flushes,
            "groups": len(self.groups),
            "mean_cd": round(self.mean_cd(), 3),
            "max_cd": self.max_cd(),
            "modes": self.mode_counts(),
            "plan_cache_hit_rate": round(self.cache_hit_rate(), 4),
            "flush_evals": self.flush_evals,
            "sig_resorts": self.sig_resorts,
            "flush_sig_resorts": self.flush_sig_resorts,
            "prewarmed_plans": self.prewarmed_plans,
            "cp_overhead_paid_us": round(self.cp_overhead_paid_s * 1e6, 2),
            "cp_overhead_saved_us": round(self.cp_overhead_saved_s * 1e6, 2),
            "modeled_busy_time_us": round(self.modeled_busy_time_s() * 1e6, 2),
            "queue_depths": self.queue_depth_histogram(),
            "class_ratios": self.class_ratios(),
            "tenants": self.tenant_percentiles(),
            "slice_counts": dict(self.slice_counts),
            "sliced_ops": self.sliced_ops,
            "deferred_launches": self.deferred_launches,
            "faults": dict(self.faults),
            "fallbacks": dict(self.fallbacks),
            "quarantines": self.quarantines,
            "quarantine_evictions": self.quarantine_evictions,
            "probes": self.probes,
            "graphs_submitted": self.graphs_submitted,
            "graphs_completed": self.graphs_completed,
            "graph_nodes": self.graph_nodes,
            "cross_graph_groups": self.cross_graph_groups(),
            "ready_depths": self.ready_depth_histogram(),
            "max_ready_depth": self.max_ready_depth,
        }


def _nearest_rank(sorted_lat: List[float], q: float) -> float:
    i = max(0, math.ceil(q * len(sorted_lat)) - 1)
    return sorted_lat[i]


def _bucket(depth: int) -> str:
    if depth <= 0:
        return "0"
    lo = 1
    while lo * 2 <= depth:
        lo *= 2
    return str(lo) if lo == 1 else f"{lo}-{2 * lo - 1}"


def _bucket_lo(name: str) -> int:
    return int(name.split("-")[0])
