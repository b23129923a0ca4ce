"""Architecture configurations of the port (its own copy of
`repro/configs/base.py`, which the port never imports).

Every architecture is a frozen ``ArchConfig`` registered under its
public id.  A config fully determines the model `models.build_model`
builds and the decode-step ops the runtime plans
(`runtime/integration.py:decode_step_descs`); ``reduced()`` derives the
tiny same-family config the CPU parity tests use, with exactly the
reference's rules so both packages build and plan the same shapes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- attention ---------------------------------------------------------
    attn_type: str = "gqa"           # gqa | mla
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0          # 0 -> full attention
    local_global_ratio: int = 0
    rope_theta: float = 10_000.0

    # --- MLA ----------------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- MoE ----------------------------------------------------------------
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0

    # --- SSM ----------------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0

    # --- xLSTM ----------------------------------------------------------------
    slstm_every: int = 0

    # --- modality frontend stubs ---------------------------------------------
    frontend: str = ""

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def is_recurrent(self) -> bool:
        """Archs with O(1)/bounded decode state (run long_500k)."""
        return self.family in ("ssm", "hybrid")

    def supports_shape(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.is_recurrent
        return True

    def param_count(self) -> int:
        """Parameters by the reference's closed forms
        (`repro/configs/base.py:94-181`; embedding counted once per table,
        used for MODEL_FLOPS = 6ND)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            return self._moe_count(self.n_routed_experts + self.n_shared_experts)
        if self.family in ("dense", "audio", "vlm"):
            per_layer = self._attn_params() + 3 * d * self.d_ff + 2 * d
        elif self.family == "ssm":
            # xLSTM: mLSTM block params approx (qkv + out + gates + up/down)
            di = 2 * d
            per_layer = 4 * d * di + 3 * di + 2 * d
        elif self.family == "hybrid":
            di, nh = self.ssm_d_inner, self.ssm_n_heads
            mamba = (d * (2 * di + nh)                # in_proj (x, z) + dt
                     + di * (2 * self.ssm_state)      # B, C proj (grouped)
                     + di * d                         # out_proj
                     + self.ssm_conv * di
                     + 2 * nh)
            # the shared block is counted once (its weights are tied)
            shared = self._attn_params() + 3 * d * self.d_ff + 2 * d
            return emb + self.n_layers * (mamba + 2 * d) + shared + d
        else:
            per_layer = 0
        return emb + self.n_layers * per_layer + d

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.attn_type == "mla":
            r = self.kv_lora_rank
            qd = self.qk_rope_head_dim + self.qk_nope_head_dim
            q = (d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qd
                 if self.q_lora_rank else d * self.n_heads * qd)
            kv = d * (r + self.qk_rope_head_dim) + r * self.n_heads * (
                self.qk_nope_head_dim + self.v_head_dim)
            return q + kv + self.n_heads * self.v_head_dim * d
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _moe_count(self, experts: int) -> int:
        """An MoE model's count with ``experts`` FFNs per MoE layer."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        dense_ff = self.dense_d_ff or self.d_ff
        total = self.first_dense_layers * (
            self._attn_params() + 3 * d * dense_ff + 2 * d)
        total += (self.n_layers - self.first_dense_layers) * (
            self._attn_params() + experts * 3 * d * self.moe_d_ff
            + d * self.n_routed_experts + 2 * d)
        return emb + total + d

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        return self._moe_count(self.moe_top_k + self.n_shared_experts)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's rules,
        `repro/configs/base.py:183-219`)."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads
            else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=256,
            head_dim=32 if self.head_dim else 0,
        )
        if self.attn_type == "mla":
            kw.update(
                kv_lora_rank=32,
                q_lora_rank=32 if self.q_lora_rank else 0,
                qk_rope_head_dim=16,
                qk_nope_head_dim=32,
                v_head_dim=32,
            )
        if self.family == "moe":
            kw.update(
                n_routed_experts=8,
                moe_top_k=2,
                n_shared_experts=min(self.n_shared_experts, 1),
                moe_d_ff=64,
                dense_d_ff=256 if self.dense_d_ff else 0,
            )
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            kw.update(attn_every=2)
        if self.sliding_window:
            kw.update(sliding_window=64)
        return replace(self, **kw)


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401  (register)
        deepseek_v2_236b,
        deepseek_v2_lite_16b,
        gemma3_27b,
        musicgen_medium,
        pixtral_12b,
        qwen2_72b,
        qwen3_14b,
        stablelm_3b,
        xlstm_350m,
        zamba2_1p2b,
    )
