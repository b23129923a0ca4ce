"""Shared layers (`repro/models/common.py`): RMSNorm, RoPE, SwiGLU MLP,
embeddings and the LM head, as plain functions on tensors.  ``p`` is a
`ParamTree` whose parameters carry the reference's dict keys; weights
are (in, out), applied as ``x @ W``.  `cross_entropy` is the training
loss."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.spec import Spec


# ------------------------------------------------------------------ norms
def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), init="ones")


def rms_norm(w, x, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


# ------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: (..., T, H, D) rotated pairwise; positions: (..., T) or (T,)."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)                   # (D/2,)
    ang = positions[..., None].float() * freqs               # (..., T, D/2)
    cos = torch.cos(ang)[..., None, :]                       # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : D // 2].float(), x[..., D // 2:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- mlp
def mlp_specs(d: int, ff: int) -> dict:
    return {
        "gate": Spec((d, ff), ("embed", "mlp")),
        "up": Spec((d, ff), ("embed", "mlp")),
        "down": Spec((ff, d), ("mlp", "embed"), scale=0.5),
    }


def mlp_apply(p, x):
    return (F.silu(x @ p.gate) * (x @ p.up)) @ p.down


# ------------------------------------------------------------- embeddings
def embed_specs(vocab: int, d: int, tie: bool) -> dict:
    if tie:
        return {"tok": Spec((vocab, d), ("vocab", "embed"), scale=1.0)}
    return {
        "tok": Spec((vocab, d), (None, "mlp"), scale=1.0),
        "head": Spec((d, vocab), ("embed", "vocab")),
    }


def embed_apply(p, tokens):
    return F.embedding(tokens, p.tok)


def lm_head_apply(p, x):
    w = getattr(p, "head", None)
    return x @ (p.tok.T if w is None else w)


# ----------------------------------------------------------------- losses
def cross_entropy(logits, labels, mask=None):
    """Mean token NLL in f32 (`repro/models/common.py:87`); labels < 0 are
    ignored, and so are tokens where ``mask`` is False."""
    logits = logits.float()
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    lbl = torch.clamp(labels, min=0).long()
    lp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(lp, -1, lbl[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / torch.clamp(valid.sum(), min=1)
