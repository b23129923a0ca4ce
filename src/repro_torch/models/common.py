"""Shared layers (`repro/models/common.py`): RMSNorm, RoPE, SwiGLU MLP,
embeddings and the LM head, as plain functions on tensors.  ``p`` is a
`ParamTree` whose parameters carry the reference's dict keys; weights
are (in, out), applied as ``x @ W``.  `cross_entropy` is the training
loss.

On a model axis (``p.tp`` set: `ParamTree`) the MLP holds its rank's
hidden units (``gate`` and ``up`` by columns, ``down`` by rows) and sums
the ranks' products with one `all_reduce_sum`.  The untied table
(vocab, d) is cut over d (the reference's ``mlp`` axis there): each rank
looks up its columns and `all_gather` joins them; the untied head is cut
over the vocabulary, and its logits are gathered.  The tied table is cut
over the vocabulary: a lookup masked to the rank's rows, summed over the
ranks, and logits over the local rows, gathered.  Every rank returns the
whole activations and the whole logits, so greedy's argmax breaks ties
on the first index, as the reference's."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.tp import all_gather, all_reduce_sum
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
    y = (F.silu(x @ p.gate) * (x @ p.up)) @ p.down
    tp = getattr(p, "tp", None)
    return y if tp is None else all_reduce_sum(y, tp)


# ------------------------------------------------------------- embeddings
def embed_specs(vocab: int, d: int, tie: bool) -> dict:
    if tie:
        return {"tok": Spec((vocab, d), ("vocab", "embed"), scale=1.0)}
    return {
        "tok": Spec((vocab, d), (None, "mlp"), scale=1.0),
        "head": Spec((d, vocab), ("embed", "vocab")),
    }


def embed_apply(p, tokens):
    tp, w, head = getattr(p, "tp", None), p.tok, getattr(p, "head", None)
    if tp is None:
        return F.embedding(tokens, w)
    if head is None:           # tied: this rank's rows of the vocabulary
        local = tokens - tp.rank * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        x = F.embedding(torch.where(mine, local, 0), w)
        return all_reduce_sum(torch.where(mine[..., None], x, 0.0), tp)
    if w.shape[1] < head.shape[0]:   # untied, cut over d
        return all_gather(F.embedding(tokens, w), -1, tp)
    return F.embedding(tokens, w)


def lm_head_apply(p, x):
    tp, w = getattr(p, "tp", None), getattr(p, "head", None)
    if w is None:              # tied: logits of this rank's rows
        logits = x @ p.tok.T
        return logits if tp is None else all_gather(logits, -1, tp)
    logits = x @ w
    if tp is not None and w.shape[1] < p.tok.shape[0]:   # cut over the vocabulary
        return all_gather(logits, -1, tp)
    return logits


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
