"""Attention (`repro/models/attention.py`): GQA with optional QKV bias and
qk-norm, and DeepSeek-V2 MLA (latent-compressed KV, absorbed decode).

Caches are fixed-capacity buffers of S_max slots, written in place at
``cache_len`` (a host integer: a decode step makes no host
synchronisation for it).  Prefill runs the port's `flash_attention`
(on the card the hand-written kernel) against the written cache; a
decode step (T = 1) reads the whole cache through einsums with float32
scores.  GQA takes a sliding ``window`` (Gemma3's local layers): the
kernel masks keys ``window`` or more positions behind each query, and so
does the decode step's mask.  MLA prefill expands the latents and runs
`flash_attention` with dv ≠ dqk; MLA decode stays in latent space.  The
sharding pins are the model axis, ROADMAP A13b.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import apply_rope, rms_norm
from repro_torch.models.spec import Spec

NEG_INF = -1e30


def _heads_first(t):
    """(B, T, H, D) → a (B, H, T, D) view (the kernel reads strides)."""
    return t.transpose(1, 2)


# =========================================================== GQA attention
def gqa_specs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    s = {
        "wq": Spec((d, hq * hd), ("embed", "heads")),
        "wk": Spec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": Spec((d, hkv * hd), ("embed", "kv_heads")),
        "wo": Spec((hq * hd, d), ("heads", "embed"), scale=0.5),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((hq * hd,), ("heads",), init="zeros")
        s["bk"] = Spec((hkv * hd,), ("kv_heads",), init="zeros")
        s["bv"] = Spec((hkv * hd,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = Spec((hd,), (None,), init="ones")
        s["k_norm"] = Spec((hd,), (None,), init="ones")
    return s


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, hd); a stack has a leading layer axis
    v: torch.Tensor


def init_kv_cache(cfg: ArchConfig, batch: int, s_max: int, dtype,
                  device, layers: int = 0) -> KVCache:
    """Zeroed K/V buffers; ``layers`` > 0 stacks that many."""
    lead = (layers,) if layers else ()
    shape = (*lead, batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def gqa_apply(p, x, cfg: ArchConfig, positions, window: int = 0,
              cache: Optional[KVCache] = None, cache_len: int = 0):
    """x (B, T, D), positions (B, T); returns (y, cache), the cache (when
    given) written in place at ``cache_len``.  ``window`` > 0: each query
    sees the keys less than ``window`` positions behind it."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, T, hq, hd)
    k = k.reshape(B, T, hkv, hd)
    v = v.reshape(B, T, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(p.q_norm, q, cfg.norm_eps)
        k = rms_norm(p.k_norm, k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = _heads_first(flash_attention(
            _heads_first(q), _heads_first(k), _heads_first(v), causal=True,
            window=window))
    else:
        kc, vc = cache
        kc[:, cache_len:cache_len + T] = k
        vc[:, cache_len:cache_len + T] = v
        if T > 1:
            # Prefill: flash attention against the written cache (the
            # einsum path would materialise O(T·S) scores).  A cache kept
            # in a wider dtype than x takes q in its dtype (exact), and
            # the output comes back in x's.
            out = _heads_first(flash_attention(
                _heads_first(q.to(kc.dtype)), _heads_first(kc), _heads_first(vc),
                causal=True, window=window, q_offset=0)).to(x.dtype)
        else:
            out = _attend_cache(q, kc, vc, q_pos=positions,
                                length=cache_len + T, window=window)
    y = out.reshape(B, T, hq * hd) @ p.wo
    return y, cache


def _attend_cache(q, kc, vc, *, q_pos, length: int, window: int = 0):
    """Decode attention against a fixed-size cache: q (B,T,Hq,hd), kc/vc
    (B,S,Hkv,hd), q_pos (B,T), ``length`` valid tokens, keys ``window``
    or more positions behind a query masked when ``window`` > 0.  q is rounded to
    the cache's dtype once, the products are summed in float32 (the
    reference's ``preferred_element_type``), the probabilities are
    rounded to the cache's dtype before the value product."""
    B, T, Hq, hd = q.shape
    S, Hkv = kc.shape[1], kc.shape[2]
    qf = (q * hd ** -0.5).to(kc.dtype).reshape(B, T, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bthrd,bshd->bthrs", qf.float(), kc.float())
    kpos = torch.arange(S, device=q.device)
    mask = (kpos < length)[None, None, :] & (q_pos[..., None] >= kpos)
    if window:
        mask &= q_pos[..., None] - kpos < window
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1).to(vc.dtype)
    out = torch.einsum("bthrs,bshd->bthrd", pattn.float(), vc.float())
    return out.reshape(B, T, Hq, hd).to(q.dtype)


# =========================================================== MLA attention
def mla_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    r = cfg.kv_lora_rank
    dr, dn, dv = cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    s: dict = {
        "wdkv": Spec((d, r + dr), ("embed", None)),
        "kv_norm": Spec((r,), (None,), init="ones"),
        "wuk": Spec((r, h * dn), (None, "heads")),
        "wuv": Spec((r, h * dv), (None, "heads")),
        "wo": Spec((h * dv, d), ("heads", "embed"), scale=0.5),
    }
    if cfg.q_lora_rank:
        s["wdq"] = Spec((d, cfg.q_lora_rank), ("embed", None))
        s["q_norm"] = Spec((cfg.q_lora_rank,), (None,), init="ones")
        s["wuq"] = Spec((cfg.q_lora_rank, h * (dn + dr)), (None, "heads"))
    else:
        s["wq"] = Spec((d, h * (dn + dr)), ("embed", "heads"))
    return s


class MLACache(NamedTuple):
    ckv: torch.Tensor    # (B, S_max, r); a stack has a leading layer axis
    krope: torch.Tensor  # (B, S_max, dr)


def init_mla_cache(cfg: ArchConfig, batch: int, s_max: int, dtype, device,
                   layers: int = 0) -> MLACache:
    lead = (layers,) if layers else ()
    return MLACache(
        torch.zeros((*lead, batch, s_max, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((*lead, batch, s_max, cfg.qk_rope_head_dim), dtype=dtype,
                    device=device))


def _mla_q(p, x, cfg: ArchConfig, positions):
    B, T, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q = rms_norm(p.q_norm, x @ p.wdq, cfg.norm_eps) @ p.wuq
    else:
        q = x @ p.wq
    q = q.reshape(B, T, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_apply(p, x, cfg: ArchConfig, positions,
              cache: Optional[MLACache] = None, cache_len: int = 0):
    B, T, _ = x.shape
    h = cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    scale = (dn + dr) ** -0.5

    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv_full = x @ p.wdkv
    ckv = rms_norm(p.kv_norm, ckv_full[..., :r], cfg.norm_eps)
    # one rope head shared by all heads: (B, T, dr)
    krope = apply_rope(ckv_full[..., r:][:, :, None, :], positions,
                       cfg.rope_theta)[:, :, 0, :]
    if cache is not None:
        cache.ckv[:, cache_len:cache_len + T] = ckv
        cache.krope[:, cache_len:cache_len + T] = krope

    if cache is None or T > 1:
        # Training / prefill: the latents expanded to per-head K/V, flash
        # attention with dv ≠ dqk (the kernel reads V at its own width).
        k_nope = (ckv @ p.wuk).reshape(B, T, h, dn)
        v = (ckv @ p.wuv).reshape(B, T, h, dv)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(B, T, h, dr)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        out = _heads_first(flash_attention(
            _heads_first(q), _heads_first(k), _heads_first(v), causal=True,
            scale=scale))
    else:
        # Absorbed decode: scores and values in latent space, float32.
        ckv_c, krope_c = cache.ckv.float(), cache.krope.float()
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(),
                             p.wuk.reshape(r, h, dn).float())
        s = torch.einsum("bthr,bsr->bths", q_lat, ckv_c)
        s = s + torch.einsum("bthd,bsd->bths", q_rope.float(), krope_c)
        s = s * scale
        kpos = torch.arange(ckv_c.shape[1], device=x.device)
        mask = (kpos < cache_len + T)[None, None, :] & (positions[..., None] >= kpos)
        s = torch.where(mask[:, :, None, :], s, NEG_INF)
        o_lat = torch.einsum("bths,bsr->bthr", torch.softmax(s, dim=-1), ckv_c)
        out = torch.einsum("bthr,rhd->bthd", o_lat,
                           p.wuv.reshape(r, h, dv).float()).to(x.dtype)
    y = out.reshape(B, T, h * dv) @ p.wo
    return y, cache
