"""DeepSeek-V2-style MoE (`repro/models/moe.py`): shared experts (a dense
SwiGLU MLP) plus E routed experts with top-k softmax gating.  The expert
FFNs run as grouped GEMMs through the port's `grouped_gemm` (on the card
the hand-written grouped kernel, at the GO tile the library picks for
CD = min(16, E)).  Two routed paths:

- `moe_capacity_apply`: copies sorted into an (E, C, D) buffer; copies
  past an expert's capacity are dropped.  On a model axis with the
  experts cut (``p.tp``) every rank routes every token alike, runs its
  E/M experts' rows of the same buffer, and one `all_reduce_sum` adds
  the ranks' combines.
- `moe_ep_apply` (expert parallelism, `repro/models/moe.py:154-251`):
  each rank routes its T/M slice of the sequence, sends each copy to the
  rank owning its expert over `all_to_all` in bf16 (at most
  ``cap = max(⌈n·k/ep·cf⌉, 8)`` per destination, the rest dropped, an
  empty slot carrying the sentinel expert id ``e_loc``), runs its
  ``e_loc`` experts on ``C2 = max(⌈ep·cap/e_loc·1.5⌉, 8)`` rows each,
  returns the results the same way and combines them at the source; the
  slices are gathered and the shared experts (a tensor-parallel MLP)
  added.  It drops copies per destination rank, not per expert, so it
  differs from the capacity path exactly where copies are dropped.

`paths` counts the calls of each (``"capacity"``, ``"sharded_capacity"``,
``"ep"``).  The expert FFN's SiLU is the reference's ``x·sigmoid(x)``
with the sigmoid as 1/(1 + e⁻ˣ), one op at a time, as XLA lowers it:
in bf16 (the EP path's wire dtype) each op rounds, and so does each add
of the EP path's combine, a sum over a token's k copies in order (XLA's
scatter-add).

The reference's ``mode="drop"`` scatters become scatters into a buffer
one row longer than the capacity buffer, whose last row (the sentinel
slot E·C) is cut off; its ``segment_sum`` is an ``index_add_``.
Nothing here reads a device value back to the host.  Training: on the
CPU the plain grouped GEMMs differentiate; on the card the grouped
kernels have no backward (nor has the reference's Pallas call), so a
training forward raises there (ROADMAP A16).
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import default_library
from repro_torch.dist.tp import ModelAxis, all_gather, all_reduce_sum, all_to_all
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.models.common import mlp_apply, mlp_specs
from repro_torch.models.spec import Spec

GEMM_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
paths: Counter = Counter()


def moe_specs(cfg: ArchConfig) -> dict:
    E, d, ff = cfg.n_routed_experts, cfg.d_model, cfg.moe_d_ff
    s = {
        "router": Spec((d, E), ("embed", None)),
        "wg": Spec((E, d, ff), ("experts", "embed", None)),
        "wu": Spec((E, d, ff), ("experts", "embed", None)),
        "wd": Spec((E, ff, d), ("experts", None, "embed"), scale=0.5),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(d, cfg.n_shared_experts * cfg.moe_d_ff)
    return s


def _route(p, xt, cfg: ArchConfig):
    """Softmax gating + top-k (renormalised) and the Switch-style
    load-balance aux loss.  Ties in the top-k may order either way."""
    logits = (xt @ p.router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, cfg.moe_top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    E, n = cfg.n_routed_experts, xt.shape[0]
    me = probs.mean(0)
    ce = torch.zeros(E, device=xt.device).index_add_(
        0, ids[:, 0], torch.ones(n, device=xt.device)) / n
    return w, ids, E * torch.sum(me * ce)


def _expert_ffn(p, xbuf):
    """(E, C, D) → (E, C, D) SwiGLU through three grouped GEMMs.  A weight
    already in the activations' dtype is used as it is."""
    E, C, D = xbuf.shape
    ff = p.wg.shape[-1]
    dt = GEMM_DTYPES[xbuf.dtype]
    lib, cd = default_library(), min(16, E)
    t_up = lib.tile(GemmDesc(C, ff, D, dtype=dt), cd)
    t_dn = lib.tile(GemmDesc(C, D, ff, dtype=dt), cd)
    g = grouped_gemm(xbuf, p.wg.to(xbuf.dtype), tile=t_up)
    u = grouped_gemm(xbuf, p.wu.to(xbuf.dtype), tile=t_up)
    return grouped_gemm(g * (1.0 / (1.0 + torch.exp(-g))) * u, p.wd.to(xbuf.dtype),
                        tile=t_dn)


def _capacity_dispatch(ids_f, n_groups: int, cap: int):
    """Sort copies by group; return (slot per copy, validity).  A copy past
    its group's capacity gets the sentinel slot ``n_groups·cap``."""
    n = ids_f.shape[0]
    order = torch.argsort(ids_f, stable=True)
    ids_s = ids_f[order]
    counts = torch.zeros(n_groups, dtype=torch.int64, device=ids_f.device
                         ).index_add_(0, ids_f, torch.ones_like(ids_f))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=ids_f.device) - offsets[ids_s]
    valid = pos < cap
    slot_s = torch.where(valid, ids_s * cap + pos, n_groups * cap)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=ids_f.device))
    return slot_s[inv], valid[inv]


def _table(slot, values, groups: int, cap: int, rows: int):
    """``values`` scattered to the slots a `_capacity_dispatch` over
    ``groups`` groups of ``cap`` gave (sentinel ``groups·cap`` included),
    the first ``rows`` kept: the slots past them are dropped."""
    return torch.zeros(groups * cap + 1, dtype=values.dtype, device=values.device
                       ).scatter_(0, slot, values)[:rows]


def moe_capacity_apply(p, x, cfg: ArchConfig, *, capacity_factor: float = 2.0):
    """The capacity path: x (B, T, D) → (y, aux loss).  With the experts
    cut over the model axis (``p.tp``) this rank runs its own experts'
    rows of the (E, C) buffer and the ranks' combines are summed."""
    B, T, D = x.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    n = B * T
    xt = x.reshape(n, D)
    w, ids, aux = _route(p, xt, cfg)

    C = max(int(math.ceil(n * k / E * capacity_factor)), 1)
    ids_f = ids.reshape(-1)
    tok_f = torch.arange(n, device=x.device).repeat_interleave(k)
    slot, valid = _capacity_dispatch(ids_f, E, C)

    # the sentinel slot E·C lies past the buffers and is dropped
    tp, e_loc = getattr(p, "tp", None), p.wg.shape[0]
    lo = 0 if tp is None else tp.rank * e_loc * C      # this rank's first row
    paths["capacity" if tp is None else "sharded_capacity"] += 1
    table = _table(slot, tok_f, E, C, E * C)[lo:lo + e_loc * C]
    filled = _table(slot, valid, E, C, E * C)[lo:lo + e_loc * C]
    xbuf = torch.where(filled[:, None], xt[table], 0.0).reshape(e_loc, C, D)

    out = _expert_ffn(p, xbuf).reshape(e_loc * C, D)
    mine = valid & (slot >= lo) & (slot < lo + e_loc * C)
    copy_out = torch.where(mine[:, None],
                           out[torch.clamp(slot - lo, 0, e_loc * C - 1)], 0.0)
    y = torch.zeros((n, D), dtype=copy_out.dtype, device=x.device).index_add_(
        0, tok_f, copy_out * w.reshape(-1)[:, None].to(copy_out.dtype))
    if tp is not None:
        y = all_reduce_sum(y, tp)
    y = y.reshape(B, T, D).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p.shared, x)
    return y, aux


def moe_ep_apply(p, x, cfg: ArchConfig, axis: ModelAxis, *,
                 capacity_factor: float = 1.25):
    """Expert parallelism over ``axis`` (`repro/models/moe.py:154-191`):
    x (B, T, D), whole on every rank, T divisible by the axis; this rank
    routes its T/M slice (the reference's x_spec ``P(data, model,
    None)``), the slices' outputs are gathered, the shared experts added.
    Returns (y, aux loss: the mean of the ranks')."""
    ep, E = axis.size, cfg.n_routed_experts
    B, T, D = x.shape
    if p.wg.shape[0] * ep != E:
        raise ValueError(f"expert parallelism over {ep} ranks needs {E} experts cut into "
                         f"{ep}, this rank holds {p.wg.shape[0]}")
    if T % ep:
        raise ValueError(f"expert parallelism over {ep} ranks needs a length it divides, "
                         f"got T = {T}")
    paths["ep"] += 1
    Tl = T // ep
    y, aux = _moe_ep_local(p, x[:, axis.rank * Tl:(axis.rank + 1) * Tl], cfg, axis,
                           capacity_factor)
    y = all_gather(y, 1, axis)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p.shared, x)
    return y, aux


def _moe_ep_local(p, x_loc, cfg: ArchConfig, axis: ModelAxis, capacity_factor: float):
    """One rank's body (`repro/models/moe.py:194-251`): route, send copies
    to the experts' ranks, run the local experts, send back, combine."""
    Bl, Tl, D = x_loc.shape
    n = Bl * Tl
    E, k, ep = cfg.n_routed_experts, cfg.moe_top_k, axis.size
    e_loc = E // ep
    dev = x_loc.device
    xt = x_loc.reshape(n, D)
    w, ids, aux = _route(p, xt, cfg)
    aux = all_reduce_sum(aux, axis) / ep

    # send side: copies to their destination ranks, at most cap each
    cap = max(int(math.ceil(n * k / ep * capacity_factor)), 8)
    ids_f = ids.reshape(-1)
    tok_f = torch.arange(n, device=dev).repeat_interleave(k)
    slot, valid = _capacity_dispatch(ids_f // e_loc, ep, cap)
    wire = torch.bfloat16 if xt.dtype != torch.float64 else xt.dtype
    xw = xt.to(wire)
    table = _table(slot, tok_f, ep, cap, ep * cap)
    filled = _table(slot, valid, ep, cap, ep * cap)
    send_x = torch.where(filled[:, None], xw[table], 0.0)
    send_eid = torch.where(filled, _table(slot, ids_f % e_loc, ep, cap, ep * cap), e_loc)
    recv_x = all_to_all(send_x, axis)
    recv_eid = all_to_all(send_eid, axis)

    # local experts: the sentinel id e_loc dispatched as a group of its own
    # past the buffer, so its copies are dropped
    C2 = max(int(math.ceil(ep * cap / e_loc * 1.5)), 8)
    slot2, valid2 = _capacity_dispatch(recv_eid, e_loc + 1, C2)
    valid2 = valid2 & (recv_eid < e_loc)
    rows = torch.arange(ep * cap, device=dev)
    table2 = _table(slot2, rows, e_loc + 1, C2, e_loc * C2)
    filled2 = _table(slot2, valid2, e_loc + 1, C2, e_loc * C2)
    xbuf = torch.where(filled2[:, None], recv_x[table2], 0.0).reshape(e_loc, C2, D)
    out = _expert_ffn(p, xbuf).reshape(e_loc * C2, D)
    back = torch.where(valid2[:, None], out[torch.clamp(slot2, max=e_loc * C2 - 1)], 0.0)

    # return side, and the combine at the source: each token's k copies
    # added in order in the wire dtype
    ret = all_to_all(back, axis)
    copy_out = torch.where(valid[:, None], ret[torch.clamp(slot, max=ep * cap - 1)], 0.0)
    parts = (copy_out * w.reshape(-1)[:, None].to(wire)).reshape(n, k, D)
    y = parts[:, 0]
    for i in range(1, k):
        y = y + parts[:, i]
    return y.reshape(Bl, Tl, D).to(x_loc.dtype), aux
