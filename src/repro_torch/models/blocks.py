"""Block assembly (`repro/models/blocks.py`): the dense and MoE
transformer blocks (a GQA block may attend through a sliding window),
the zamba2 hybrid layer with its shared attention block, and the xLSTM
group (k−1 mLSTM layers, then one sLSTM layer).  MoE blocks take the
capacity path; the expert-parallel path is the model axis, ROADMAP A13b."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import gqa_apply, gqa_specs, mla_apply, mla_specs
from repro_torch.models.common import mlp_apply, mlp_specs, rms_norm, rms_norm_spec
from repro_torch.models.moe import moe_capacity_apply, moe_specs
from repro_torch.models.spec import stack_specs
from repro_torch.models.ssm import mamba_apply, mamba_specs
from repro_torch.models.xlstm import mlstm_apply, mlstm_specs, slstm_apply, slstm_specs


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
                     window: int = 0, cache=None, cache_len: int = 0,
                     moe_capacity_factor: float = 1.25):
    """One pre-norm block; returns (x, cache, MoE aux loss).  ``window``
    > 0: GQA attends to the last ``window`` positions only (MLA, as in the
    reference, takes no window)."""
    h = rms_norm(p.attn_norm, x, cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, cache = mla_apply(p.attn, h, cfg, positions, cache=cache,
                             cache_len=cache_len)
    else:
        a, cache = gqa_apply(p.attn, h, cfg, positions, window=window,
                             cache=cache, cache_len=cache_len)
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


# ========================================================== xLSTM groups
def xlstm_group_specs(cfg: ArchConfig) -> dict:
    """k−1 mLSTM layers (a stack within the group) and one sLSTM layer."""
    return {"mlstm": stack_specs(mlstm_specs(cfg), cfg.slstm_every - 1,
                                 "sublayers"),
            "slstm": slstm_specs(cfg)}


def xlstm_group_apply(p, x, cfg: ArchConfig, cache: Optional[dict] = None):
    """The group's mLSTM layers in order, then its sLSTM layer.  ``cache``
    is this group's ``{"mlstm": MLSTMCache stacked over the group's
    mLSTM layers, "slstm": SLSTMCache}`` (updated in place) or None."""
    for i, pi in enumerate(p.mlstm):
        x, _ = mlstm_apply(pi, x, cfg, cache=None if cache is None else
                           type(cache["mlstm"])(*(t[i] for t in cache["mlstm"])))
    x, _ = slstm_apply(p.slstm, x, cfg,
                       cache=None if cache is None else cache["slstm"])
    return x, cache
