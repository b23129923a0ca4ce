"""DeepSeek-V2-style MoE (`repro/models/moe.py`): shared experts (a dense
SwiGLU MLP) plus E routed experts with top-k softmax gating, on the
mesh-free capacity path: copies sorted into an (E, C, D) buffer and the
expert FFNs run as grouped GEMMs, through the port's `grouped_gemm` (on
the card the hand-written grouped kernel, at the GO tile the library
picks for CD = min(16, E)).  Copies past an expert's capacity are
dropped.  The expert-parallel path is the model axis, ROADMAP A13b.

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

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.gemm_desc import GemmDesc
from repro_torch.core.library import default_library
from repro_torch.kernels.grouped_gemm import grouped_gemm
from repro_torch.models.common import mlp_apply, mlp_specs
from repro_torch.models.spec import Spec

GEMM_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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
    return grouped_gemm(F.silu(g) * u, p.wd.to(xbuf.dtype), tile=t_dn)


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


def moe_capacity_apply(p, x, cfg: ArchConfig, *, capacity_factor: float = 2.0):
    """Mesh-free routed path: x (B, T, D) → (y, aux loss)."""
    B, T, D = x.shape
    E, k = cfg.n_routed_experts, cfg.moe_top_k
    n = B * T
    xt = x.reshape(n, D)
    w, ids, aux = _route(p, xt, cfg)

    C = max(int(math.ceil(n * k / E * capacity_factor)), 1)
    ids_f = ids.reshape(-1)
    tok_f = torch.arange(n, device=x.device).repeat_interleave(k)
    slot, valid = _capacity_dispatch(ids_f, E, C)

    # scatters into E·C + 1 rows: the sentinel's row is dropped
    table = torch.zeros(E * C + 1, dtype=torch.int64, device=x.device
                        ).scatter_(0, slot, tok_f)[:E * C]
    filled = torch.zeros(E * C + 1, dtype=torch.bool, device=x.device
                         ).scatter_(0, slot, valid)[:E * C]
    xbuf = torch.where(filled[:, None], xt[table], 0.0).reshape(E, C, D)

    out = _expert_ffn(p, xbuf).reshape(E * C, D)
    copy_out = torch.where(valid[:, None], out[torch.clamp(slot, max=E * C - 1)],
                           0.0)
    y = torch.zeros((n, D), dtype=copy_out.dtype, device=x.device).index_add_(
        0, tok_f, copy_out * w.reshape(-1)[:, None].to(copy_out.dtype))
    y = y.reshape(B, T, D).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p.shared, x)
    return y, aux
