"""Block assembly (`repro/models/blocks.py`): the dense and MoE
transformer blocks and the zamba2 hybrid layer with its shared
attention block.  MoE blocks take the capacity path; the
expert-parallel path and the xLSTM groups wait for later slices."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import gqa_apply, gqa_specs, mla_apply, mla_specs
from repro_torch.models.common import mlp_apply, mlp_specs, rms_norm, rms_norm_spec
from repro_torch.models.moe import moe_capacity_apply, moe_specs
from repro_torch.models.ssm import mamba_apply, mamba_specs


# ==================================================== dense / moe blocks
def attn_block_specs(cfg: ArchConfig, d_ff: int, moe: bool) -> dict:
    s = {
        "attn_norm": rms_norm_spec(cfg.d_model),
        "mlp_norm": rms_norm_spec(cfg.d_model),
        "attn": mla_specs(cfg) if cfg.attn_type == "mla" else gqa_specs(cfg),
    }
    if moe:
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, d_ff)
    return s


def attn_block_apply(p, x, cfg: ArchConfig, positions, *, moe: bool,
                     cache=None, cache_len: int = 0,
                     moe_capacity_factor: float = 1.25):
    """One pre-norm block; returns (x, cache, MoE aux loss)."""
    h = rms_norm(p.attn_norm, x, cfg.norm_eps)
    attend = mla_apply if cfg.attn_type == "mla" else gqa_apply
    a, cache = attend(p.attn, h, cfg, positions, cache=cache, cache_len=cache_len)
    x = x + a
    h = rms_norm(p.mlp_norm, x, cfg.norm_eps)
    if moe:
        m, aux = moe_capacity_apply(p.moe, h, cfg,
                                    capacity_factor=moe_capacity_factor)
    else:
        m, aux = mlp_apply(p.mlp, h), torch.zeros((), device=x.device)
    return x + m, cache, aux


# ======================================================== zamba2 hybrid
def zamba_layer_specs(cfg: ArchConfig) -> dict:
    return {"mamba": mamba_specs(cfg), "norm": rms_norm_spec(cfg.d_model)}


def zamba_shared_specs(cfg: ArchConfig) -> dict:
    """Single weight-tied transformer block applied every ``attn_every``."""
    return attn_block_specs(cfg, cfg.d_ff, moe=False)


def zamba_layer_apply(p, shared_p, x, cfg: ArchConfig, positions, layer_idx: int,
                      cache: Optional[dict] = None, cache_len: int = 0):
    """One mamba layer; where ``layer_idx % attn_every == attn_every - 1``
    also the shared attention block, on this layer's KV cache.  ``cache``
    is this layer's ``{"mamba": MambaCache, "kv": KVCache}`` (updated in
    place) or None."""
    h = rms_norm(p.norm, x, cfg.norm_eps)
    y, _ = mamba_apply(p.mamba, h, cfg,
                       cache=cache["mamba"] if cache is not None else None)
    x = x + y
    if layer_idx % cfg.attn_every == cfg.attn_every - 1:
        x, _, _ = attn_block_apply(
            shared_p, x, cfg, positions, moe=False,
            cache=cache["kv"] if cache is not None else None, cache_len=cache_len)
    return x, cache
