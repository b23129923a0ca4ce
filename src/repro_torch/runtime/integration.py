"""Route a model's decode-step ops through the serving runtime
(`repro/runtime/integration.py`).

Each decode step of each live request issues a bundle of small-M GEMMs
(QKV, attention-out, FFN, or per-expert FFNs); how many are pending at
once depends on traffic — the runtime-only-known parallelism of paper
§4.4.  `decode_step_requests` enumerates one layer's GEMMs for an
`ArchConfig` (M = live batch) after applying the §6.11 policy:
shared-input projections (QKV; FFN gate+up) become one wide fused GEMM
when the cost model prefers fusion, else separate concurrent GEMMs.
`decode_step_op_descs` is one layer's whole decode-step bundle: its GEMMs
plus the attention read over the KV cache, for SSM/hybrid layers the SSD
state update and, for MoE layers, the routed-expert pool as two ragged
grouped-GEMM launches (§14).  `decode_step_graph` is the same op
population as a dependency graph (`runtime/graph.py`), layer after layer,
with the chains the flat bundle erases.
"""
from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.op_desc import AttentionDesc, GroupedGemmDesc, ScanDesc
from repro_torch.core.scheduler import ConcurrencyController, GemmRequest
from repro_torch.runtime.graph import OpGraph, out_shape, slot_shape
from repro_torch.runtime.runtime import Runtime, Ticket

def _shared_input_requests(
    ctrl: ConcurrencyController,
    descs: Sequence[GemmDesc],
    tag: str,
) -> List[GemmRequest]:
    """Apply §6.11 to a shared-input bundle: one fused request or N grouped."""
    if len(descs) < 2:
        return [GemmRequest(desc=d, tag=tag) for d in descs]
    choice, _, _ = ctrl.plan_shared_input(list(descs))
    if choice == "fuse":
        fused = replace(descs[0], N=sum(d.N for d in descs))
        return [GemmRequest(desc=fused, tag=f"{tag}-fused")]
    return [GemmRequest(desc=d, tag=tag) for d in descs]


def decode_step_descs(cfg, batch: int, dtype: str = "bf16") -> List[Tuple[str, List[GemmDesc]]]:
    """(tag, shared-input bundle) pairs for one decode step of one layer.
    GEMMs listed together share their A operand (the hidden state)."""
    M, D = batch, cfg.d_model
    hd = cfg.resolved_head_dim
    out: List[Tuple[str, List[GemmDesc]]] = []

    if cfg.attn_type == "mla":
        # MLA: low-rank KV/Q down-projections + up-projection.
        q_n = cfg.n_heads * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
        kv_n = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            out.append(("mla-down", [GemmDesc(M, cfg.q_lora_rank, D, dtype=dtype),
                                     GemmDesc(M, kv_n, D, dtype=dtype)]))
            out.append(("mla-q-up", [GemmDesc(M, q_n, cfg.q_lora_rank, dtype=dtype)]))
        else:
            out.append(("mla-down", [GemmDesc(M, q_n, D, dtype=dtype),
                                     GemmDesc(M, kv_n, D, dtype=dtype)]))
        out.append(("attn-out", [GemmDesc(M, D, cfg.n_heads * cfg.v_head_dim,
                                          dtype=dtype)]))
    elif cfg.family in ("ssm",) or (cfg.family == "hybrid" and cfg.ssm_state):
        # Mamba2-style block: wide in-projection + out-projection.
        out.append(("ssm-in", [GemmDesc(M, 2 * cfg.ssm_d_inner, D, dtype=dtype)]))
        out.append(("ssm-out", [GemmDesc(M, D, cfg.ssm_d_inner, dtype=dtype)]))
    else:
        # GQA attention: Q + K + V share the hidden state (§6.11 QKV case).
        out.append(("qkv", [GemmDesc(M, cfg.n_heads * hd, D, dtype=dtype),
                            GemmDesc(M, cfg.n_kv_heads * hd, D, dtype=dtype),
                            GemmDesc(M, cfg.n_kv_heads * hd, D, dtype=dtype)]))
        out.append(("attn-out", [GemmDesc(M, D, cfg.n_heads * hd, dtype=dtype)]))

    if cfg.n_routed_experts:
        # Active routed experts are independent GEMMs (the §6.7 pool);
        # gate+up share the expert input (§6.11).
        ff = cfg.moe_d_ff
        for e in range(cfg.moe_top_k):
            out.append((f"expert{e}-up", [GemmDesc(M, ff, D, dtype=dtype),
                                          GemmDesc(M, ff, D, dtype=dtype)]))
            out.append((f"expert{e}-down", [GemmDesc(M, D, ff, dtype=dtype)]))
        if cfg.n_shared_experts:
            # shared experts run as ONE dense MLP of width n_shared · moe_d_ff
            sff = cfg.n_shared_experts * ff
            out.append(("shared-up", [GemmDesc(M, sff, D, dtype=dtype),
                                      GemmDesc(M, sff, D, dtype=dtype)]))
            out.append(("shared-down", [GemmDesc(M, D, sff, dtype=dtype)]))
    elif cfg.d_ff > 0:  # xLSTM-style blocks have no separate FFN
        ff = cfg.d_ff
        out.append(("ffn-up", [GemmDesc(M, ff, D, dtype=dtype),
                               GemmDesc(M, ff, D, dtype=dtype)]))
        out.append(("ffn-down", [GemmDesc(M, D, ff, dtype=dtype)]))
    return out


def decode_step_requests(
    ctrl: ConcurrencyController,
    cfg,
    batch: int,
    dtype: str = "bf16",
) -> List[GemmRequest]:
    """One decode step's GEMM requests (operand-free), with §6.11 applied
    to each shared-input bundle."""
    reqs: List[GemmRequest] = []
    for tag, bundle in decode_step_descs(cfg, batch, dtype):
        reqs += _shared_input_requests(ctrl, bundle, tag)
    return reqs


def decode_step_op_descs(cfg, batch: int, context: int = 1024,
                         dtype: str = "bf16") -> List[object]:
    """The whole decode-step op bundle of one layer
    (`repro/runtime/integration.py:126-175`): the GEMMs of
    `decode_step_descs` (unfused), the attention read over ``context``
    cached tokens (`AttentionDesc`, Sq = 1 per sequence), for SSM/hybrid
    blocks the SSD state update (`ScanDesc`, T = 1) and, for MoE blocks,
    the routed-expert pool as one ragged grouped-GEMM launch per up and
    down projection (`GroupedGemmDesc`: the §6.7 pool collapsed into the
    kernel that runs it).  As in the reference, the routed experts also
    stay among the GEMMs as `decode_step_descs`' dense per-expert
    triples (ROADMAP C11)."""
    descs: List[object] = [
        d for _, bundle in decode_step_descs(cfg, batch, dtype)
        for d in bundle
    ]
    if cfg.attn_type == "mla":
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        descs.append(AttentionDesc(batch, cfg.n_heads, cfg.n_heads, 1,
                                   context, hd, True, dtype))
    elif not (cfg.family == "ssm"):
        hd = cfg.resolved_head_dim
        descs.append(AttentionDesc(batch, cfg.n_heads, cfg.n_kv_heads, 1,
                                   context, hd, True, dtype))
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_state:
        descs.append(ScanDesc(batch, 1, cfg.ssm_n_heads, cfg.ssm_head_dim,
                              cfg.ssm_state, dtype))
    elif cfg.family == "ssm":
        # xLSTM-style blocks (ssm_state == 0): two SSD scans per step, the
        # (N = P = 2D/H) C-matrix recurrence and the P = 1 normalizer.
        hp = 2 * cfg.d_model // cfg.n_heads
        descs.append(ScanDesc(batch, 1, cfg.n_heads, hp, hp, dtype))
        descs.append(ScanDesc(batch, 1, cfg.n_heads, 1, hp, dtype))
    if cfg.n_routed_experts:
        # batch·top_k rows spread over the active experts
        g = min(cfg.n_routed_experts, max(batch * cfg.moe_top_k, 1))
        rows = batch * cfg.moe_top_k
        descs.append(GroupedGemmDesc(g, rows, cfg.moe_d_ff, cfg.d_model,
                                     dtype))
        descs.append(GroupedGemmDesc(g, rows, cfg.d_model, cfg.moe_d_ff,
                                     dtype))
    return descs


def prewarm_decode(
    runtime: Runtime, cfg, batches: Sequence[int], dtype: str = "bf16"
) -> int:
    """Tune every GEMM a decode workload can issue before traffic arrives."""
    descs: List[GemmDesc] = []
    for b in batches:
        for r in decode_step_requests(runtime.ctrl, cfg, b, dtype):
            descs.append(r.desc)
    return runtime.prewarm(descs)



def _wire(
    graph: OpGraph,
    name: str,
    desc,
    feeds: Optional[Dict[object, Optional[str]]] = None,
    after: Sequence[str] = (),
    tag: str = "",
) -> str:
    """Add a node whose candidate producers (``feeds``: slot → producer)
    become data edges where the producer's output has as many elements
    as the slot, and control edges where not: a decode step's dataflow
    also runs through state and glue that are no ops here (the KV cache,
    norms, residual adds), so attention's k and v slots read the cache,
    ordered after this step's k and v projections."""
    deps: Dict[object, str] = {}
    ctrl = list(after)
    for slot, src in (feeds or {}).items():
        if src is None:
            continue
        if (math.prod(out_shape(graph.nodes[src].desc))
                == math.prod(slot_shape(desc, slot))):
            deps[slot] = src
        else:
            ctrl.append(src)
    return graph.add(name, desc, deps=deps, after=ctrl, tag=tag)


def decode_step_graph(
    cfg,
    batch: int,
    context: int = 1024,
    dtype: str = "bf16",
    layers: int = 1,
) -> OpGraph:
    """The dependency graph of ``layers`` decode-step layers: the op
    population of `decode_step_op_descs`, with its chains —

    - GQA: q/k/v projections → attention (q feeds the query slot; k and
      v are control edges, the cache carries the data) → O-projection →
      gate/up → down (up feeds down; gate is a control edge);
    - MLA: q/kv down-projections → q up-projection → attention →
      O-projection (a control edge where v_head_dim ≠ the qk head dim);
    - MoE: the routed pool as its two ragged grouped-GEMM launches (the
      routing scatter a control edge in, up → down a data edge) and the
      shared experts' gate/up → down, all after the O-projection;
    - SSM/hybrid: in-projection → SSD scan → out-projection, with the
      attention (hybrid) off the layer input beside it.

    Each layer's roots follow the previous layer's sinks by control
    edges.  Node names carry the prefix ``L<i>.`` when ``layers > 1``
    (``"L0.attn"``).  `waves()` of this graph, one
    barriered bundle a wave, is what a caller limited to bundles
    submits."""
    g = OpGraph()
    sinks: List[str] = []
    for ell in range(layers):
        sinks = _add_decode_layer(g, cfg, batch, context, dtype,
                                  prefix=f"L{ell}." if layers > 1 else "",
                                  roots_after=sinks)
    g.validate()
    return g


def _add_decode_layer(
    g: OpGraph, cfg, batch: int, context: int, dtype: str,
    prefix: str, roots_after: List[str],
) -> List[str]:
    """Wire one layer; returns its sinks (the next layer's control-edge
    sources)."""
    bundles = dict(decode_step_descs(cfg, batch, dtype))
    P = prefix
    sinks: List[str] = []

    if cfg.attn_type == "mla":
        down = bundles["mla-down"]
        q_src = _wire(g, P + "q-down", down[0], after=roots_after,
                      tag="mla-down")
        kv = _wire(g, P + "kv-down", down[1], after=roots_after,
                   tag="mla-down")
        if "mla-q-up" in bundles:
            q_src = _wire(g, P + "q-up", bundles["mla-q-up"][0],
                          feeds={"a": q_src}, tag="mla-q-up")
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        attn = _wire(g, P + "attn",
                     AttentionDesc(batch, cfg.n_heads, cfg.n_heads, 1,
                                   context, hd, True, dtype),
                     feeds={0: q_src}, after=[kv], tag="attn")
        block_out = _wire(g, P + "o", bundles["attn-out"][0],
                          feeds={"a": attn}, tag="attn-out")
    elif "ssm-in" in bundles:
        ssm_in = _wire(g, P + "ssm-in", bundles["ssm-in"][0],
                       after=roots_after, tag="ssm-in")
        if cfg.family == "ssm" and not cfg.ssm_state:
            # xLSTM's mLSTM step: the C-matrix recurrence and the
            # normalizer scan
            hp = 2 * cfg.d_model // cfg.n_heads
            scan = _wire(g, P + "scan",
                         ScanDesc(batch, 1, cfg.n_heads, hp, hp, dtype),
                         feeds={0: ssm_in}, tag="scan")
            norm = _wire(g, P + "scan-norm",
                         ScanDesc(batch, 1, cfg.n_heads, 1, hp, dtype),
                         feeds={0: ssm_in}, tag="scan")
            block_out = _wire(g, P + "ssm-out", bundles["ssm-out"][0],
                              feeds={"a": scan}, after=[norm],
                              tag="ssm-out")
        else:
            scan = _wire(g, P + "scan",
                         ScanDesc(batch, 1, cfg.ssm_n_heads,
                                  cfg.ssm_head_dim, cfg.ssm_state, dtype),
                         feeds={0: ssm_in}, tag="scan")
            block_out = _wire(g, P + "ssm-out", bundles["ssm-out"][0],
                              feeds={"a": scan}, tag="ssm-out")
        if cfg.family == "hybrid":
            # the shared attention block runs off the same layer input,
            # beside the Mamba branch
            hd = cfg.resolved_head_dim
            sinks.append(_wire(
                g, P + "attn",
                AttentionDesc(batch, cfg.n_heads, cfg.n_kv_heads, 1,
                              context, hd, True, dtype),
                after=roots_after, tag="attn"))
    else:
        qkv = bundles["qkv"]
        hd = cfg.resolved_head_dim
        q = _wire(g, P + "q", qkv[0], after=roots_after, tag="qkv")
        k = _wire(g, P + "k", qkv[1], after=roots_after, tag="qkv")
        v = _wire(g, P + "v", qkv[2], after=roots_after, tag="qkv")
        attn = _wire(g, P + "attn",
                     AttentionDesc(batch, cfg.n_heads, cfg.n_kv_heads, 1,
                                   context, hd, True, dtype),
                     feeds={0: q}, after=[k, v], tag="attn")
        block_out = _wire(g, P + "o", bundles["attn-out"][0],
                          feeds={"a": attn}, tag="attn-out")

    if cfg.n_routed_experts:
        # The routed pool as the ragged launches that run it; the dense
        # per-expert GEMMs are the same work before the collapse, so the
        # graph carries only the grouped form (ROADMAP C11).
        ga = min(cfg.n_routed_experts, max(batch * cfg.moe_top_k, 1))
        rows = batch * cfg.moe_top_k
        up = _wire(g, P + "moe-up",
                   GroupedGemmDesc(ga, rows, cfg.moe_d_ff, cfg.d_model,
                                   dtype),
                   feeds={0: block_out}, tag="moe-up")
        sinks.append(_wire(g, P + "moe-down",
                           GroupedGemmDesc(ga, rows, cfg.d_model,
                                           cfg.moe_d_ff, dtype),
                           feeds={0: up}, tag="moe-down"))
        if cfg.n_shared_experts:
            sg = _wire(g, P + "shared-gate", bundles["shared-up"][0],
                       feeds={"a": block_out}, tag="shared-up")
            su = _wire(g, P + "shared-up", bundles["shared-up"][1],
                       feeds={"a": block_out}, tag="shared-up")
            sinks.append(_wire(g, P + "shared-down",
                               bundles["shared-down"][0],
                               feeds={"a": su}, after=[sg],
                               tag="shared-down"))
    elif cfg.d_ff > 0:
        gate = _wire(g, P + "gate", bundles["ffn-up"][0],
                     feeds={"a": block_out}, tag="ffn-up")
        up = _wire(g, P + "up", bundles["ffn-up"][1],
                   feeds={"a": block_out}, tag="ffn-up")
        sinks.append(_wire(g, P + "down", bundles["ffn-down"][0],
                           feeds={"a": up}, after=[gate], tag="ffn-down"))
    else:
        sinks.append(block_out)
    return sinks


def submit_decode_graph(
    runtime: Runtime,
    cfg,
    batch: int,
    context: int = 1024,
    layers: int = 1,
    tenant: str = "default",
    now: float | None = None,
    dtype: str = "bf16",
) -> Ticket:
    """Admit one request's decode step as a dependency graph; returns the
    graph handle, whose node tickets carry `decode_step_graph`'s names.
    Operand-free: for a runtime in shadow mode."""
    return runtime.submit(
        decode_step_graph(cfg, batch, context, dtype, layers),
        tenant=tenant, now=now)


def submit_decode_step(
    runtime: Runtime,
    cfg,
    batch: int,
    tenant: str = "default",
    now: float | None = None,
    dtype: str = "bf16",
) -> List[Ticket]:
    """Admit one decode step's GEMMs (operand-free, §6.11 applied) into the
    runtime's class queues, each alone."""
    return [
        runtime.submit(r, tenant=tenant, now=now)
        for r in decode_step_requests(runtime.ctrl, cfg, batch, dtype)
    ]
