"""xLSTM blocks (`repro/models/xlstm.py`): mLSTM (matrix memory) on the
port's SSD scan and sLSTM (scalar memory) as a loop over tokens.

mLSTM is the SSD recurrence: decay = the sigmoid forget gate, input
scale = the exponential input gate, B = keys, C = queries; its
normaliser n_t is the same recurrence with P = 1.  Both scans go
through `ssd_scan` (on the card the hand-written kernel: the chunked
form for a prompt, the decode kernel for a step), with the cache's C
and n as the initial state.  The heads are wide (N = P = 2·d/H, 512 for
xLSTM-350M), and the operands are f32 as the reference makes them
(`i_g·v` is f32, and its scan casts q and k to f32), so on the card the
scan takes its f32 instantiation for N, P ≤ 512.

sLSTM is a `jax.lax.scan` over tokens in the reference, not a Pallas
kernel: here a plain PyTorch loop over tokens, a few elementwise
kernels and one batched product a token.  Caches are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan import ssd_scan
from repro_torch.models.common import rms_norm
from repro_torch.models.spec import Spec

CONV = 4               # mLSTM's causal conv width
M_INIT = -10.0         # sLSTM's initial stabiliser


# ================================================================== mLSTM
def mlstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = 2 * d                      # up-projection factor 2
    H = cfg.n_heads
    return {
        "norm": Spec((d,), ("embed",), init="ones"),
        "up": Spec((d, 2 * di), ("embed", "mlp")),       # [x_in, z-gate]
        "conv_w": Spec((CONV, di), (None, "mlp")),
        "conv_b": Spec((di,), ("mlp",), init="zeros"),
        "wq": Spec((di, di), (None, "heads")),
        "wk": Spec((di, di), (None, "heads")),
        "wv": Spec((di, di), (None, "heads")),
        "wif": Spec((di, 2 * H), ("mlp", None), scale=0.3),
        "b_if": Spec((2 * H,), (None,), init="zeros"),
        "out_norm": Spec((di,), ("mlp",), init="ones"),
        "down": Spec((di, d), ("mlp", "embed"), scale=0.5),
    }


class MLSTMCache(NamedTuple):
    conv: torch.Tensor   # (B, 3, di): trailing conv inputs
    C: torch.Tensor      # (B, H, N, P) f32 matrix memory
    n: torch.Tensor      # (B, H, N, 1) f32 normaliser


def init_mlstm_cache(cfg: ArchConfig, batch: int, dtype, device,
                     lead: tuple = ()) -> MLSTMCache:
    """Zeroed conv tail (``dtype``) and f32 memories under the leading
    stack dims ``lead`` (xLSTM's model stacks them twice)."""
    di, H = 2 * cfg.d_model, cfg.n_heads
    N = P = di // H
    return MLSTMCache(
        torch.zeros((*lead, batch, CONV - 1, di), dtype=dtype, device=device),
        torch.zeros((*lead, batch, H, N, P), dtype=torch.float32, device=device),
        torch.zeros((*lead, batch, H, N, 1), dtype=torch.float32, device=device))


def _causal_conv(x, w, b, prefix):
    """Depthwise causal conv then SiLU: x (B,T,C), w (k,C), prefix
    (B,k-1,C).  Returns the output and the last k-1 inputs."""
    k, T = w.shape[0], x.shape[1]
    xp = torch.cat([prefix, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(k))
    return F.silu(out + b), xp[:, -(k - 1):]


def mlstm_apply(p, x, cfg: ArchConfig, cache: Optional[MLSTMCache] = None):
    """x (B, T, D) → (x + mLSTM(x), cache); the cache (when given) is
    updated in place."""
    B, T, D = x.shape
    di, H = 2 * D, cfg.n_heads
    N = P = di // H
    h = rms_norm(p.norm, x, cfg.norm_eps)
    xin, z = (h @ p.up).chunk(2, dim=-1)
    prefix = (cache.conv if cache is not None
              else xin.new_zeros((B, CONV - 1, di)))
    conv_x, conv_tail = _causal_conv(xin, p.conv_w, p.conv_b, prefix)

    q = (conv_x @ p.wq).reshape(B, T, H, N)
    k = (conv_x @ p.wk).reshape(B, T, H, N) * N ** -0.5
    v = (xin @ p.wv).reshape(B, T, H, P)
    gates = xin @ p.wif + p.b_if
    i_g = torch.exp(torch.clamp(gates[..., :H].float(), -10.0, 8.0))
    log_f = F.logsigmoid(gates[..., H:].float() + 3.0)
    # the reference's scan computes in f32 whatever its operands' dtype
    k, q = k.float(), q.float()
    num, C_new = ssd_scan(i_g[..., None] * v.float(), log_f, k, q,
                          initial_state=cache.C if cache is not None else None)
    den, n_new = ssd_scan(i_g[..., None], log_f, k, q,
                          initial_state=cache.n if cache is not None else None)
    y = (num / torch.clamp(den.abs(), min=1.0)).reshape(B, T, di).to(x.dtype)
    y = rms_norm(p.out_norm, y, cfg.norm_eps) * F.silu(z)
    if cache is not None:
        cache.conv.copy_(conv_tail)
        cache.C.copy_(C_new)
        cache.n.copy_(n_new)
    return x + y @ p.down, cache


# ================================================================== sLSTM
def slstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    ff = int(4 * d / 3 / 64) * 64 or 64
    return {
        "norm": Spec((d,), ("embed",), init="ones"),
        "wx": Spec((d, 4 * d), ("embed", "mlp")),          # z,i,f,o pre-acts
        "wr": Spec((H, P, 4 * P), (None, None, None), scale=0.5),
        "bias": Spec((4 * d,), (None,), init="zeros"),
        "out_norm": Spec((d,), ("embed",), init="ones"),
        "ff_norm": Spec((d,), ("embed",), init="ones"),
        "ff_up": Spec((d, 2 * ff), ("embed", "mlp")),
        "ff_down": Spec((ff, d), ("mlp", "embed"), scale=0.5),
    }


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, P) f32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor  # stabiliser


def init_slstm_cache(cfg: ArchConfig, batch: int, dtype, device,
                     lead: tuple = ()) -> SLSTMCache:
    """f32 zeros, the stabiliser m at −10, under the leading stack dims
    ``lead`` (``dtype`` unused: the state is f32, as in the reference)."""
    shape = (*lead, batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    z = [torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3)]
    return SLSTMCache(*z, torch.full(shape, M_INIT, dtype=torch.float32, device=device))


def _slstm_cell(carry, pre):
    """pre (B, H, P, 4): pre-activations [z, i, f, o], recurrent term
    added."""
    c, n, h, m = carry
    z_t = torch.tanh(pre[..., 0])
    i_t = pre[..., 1]
    o_t = torch.sigmoid(pre[..., 3])
    logf = F.logsigmoid(pre[..., 2])
    m_new = torch.maximum(logf + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(logf + m - m_new)
    c = f_p * c + i_p * z_t
    n = torch.maximum(f_p * n + i_p, torch.exp(-m_new))
    return c, n, o_t * c / n, m_new


def slstm_apply(p, x, cfg: ArchConfig, cache: Optional[SLSTMCache] = None):
    """x (B, T, D) → (x after the sLSTM and its gated FFN, cache); the
    recurrence runs token by token in f32, the cache (when given) updated
    in place."""
    B, T, D = x.shape
    H = cfg.n_heads
    P = D // H
    hin = rms_norm(p.norm, x, cfg.norm_eps)
    pre_x = (hin @ p.wx + p.bias).reshape(B, T, H, P, 4).float()
    carry = tuple(cache if cache is not None
                  else init_slstm_cache(cfg, B, x.dtype, x.device))
    wr = p.wr.float()
    hs = []
    for t in range(T):
        rec = torch.einsum("bhp,hpq->bhq", carry[2], wr).reshape(B, H, P, 4)
        carry = _slstm_cell(carry, pre_x[:, t] + rec)
        hs.append(carry[2])
    y = torch.stack(hs, dim=1).reshape(B, T, D).to(x.dtype)
    x = x + rms_norm(p.out_norm, y, cfg.norm_eps)
    # the gated FFN sublayer (the reference's jax.nn.gelu: the tanh form)
    u, g = (rms_norm(p.ff_norm, x, cfg.norm_eps) @ p.ff_up).chunk(2, dim=-1)
    x = x + (F.gelu(u, approximate="tanh") * g) @ p.ff_down
    if cache is not None:
        for buf, val in zip(cache, carry):
            buf.copy_(val)
    return x, cache
