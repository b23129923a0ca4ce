"""Mamba2 block (`repro/models/ssm.py`): the zamba2 backbone, its prompt
on the scan's chunked form and its decode step (T = 1) on the scan's
decode kernel, both through the port's `mamba_chunk_scan`, with an O(1)
decode state."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan import mamba_chunk_scan
from repro_torch.models.common import rms_norm
from repro_torch.models.spec import Spec


def _a_init(gen, shape, device):
    return torch.empty(shape, device=device).uniform_(1.0, 16.0, generator=gen).log_()


def _dt_init(gen, shape, device):
    u = torch.empty(shape, device=device).uniform_(1e-3, 1e-1, generator=gen)
    return torch.log(torch.expm1(u))  # softplus inverse


def mamba_specs(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.ssm_d_inner
    N, H = cfg.ssm_state, cfg.ssm_n_heads
    conv_ch = di + 2 * N
    return {
        "in_proj": Spec((d, 2 * di + 2 * N + H), ("embed", "mlp")),
        "conv_w": Spec((cfg.ssm_conv, conv_ch), (None, "mlp"), scale=1.0),
        "conv_b": Spec((conv_ch,), ("mlp",), init="zeros"),
        "dt_bias": Spec((H,), (None,), init="custom", custom=_dt_init),
        "A_log": Spec((H,), (None,), init="custom", custom=_a_init),
        "D": Spec((H,), (None,), init="ones"),
        "norm": Spec((di,), ("mlp",), init="ones"),
        "out_proj": Spec((di, d), ("mlp", "embed"), scale=0.5),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, conv_width-1, conv_ch): trailing conv inputs
    state: torch.Tensor  # (B, H, N, P) float32 SSM state


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device,
                     layers: int = 0) -> MambaCache:
    """Zeroed conv tail (``dtype``) and f32 state; ``layers`` > 0 stacks."""
    lead = (layers,) if layers else ()
    conv_ch = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return MambaCache(
        torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((*lead, batch, cfg.ssm_n_heads, cfg.ssm_state,
                     cfg.ssm_head_dim), dtype=torch.float32, device=device))


def _causal_conv(x, w, b, prefix=None):
    """Depthwise causal conv.  x (B,T,C); w (k,C); prefix (B,k-1,C)|None.
    Returns the output and the last k-1 inputs (the next call's prefix)."""
    k, T = w.shape[0], x.shape[1]
    if prefix is None:
        prefix = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prefix, x], dim=1)
    out = sum(xp[:, i:i + T] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):]


def mamba_apply(p, x, cfg: ArchConfig, cache: Optional[MambaCache] = None):
    """x (B, T, D) → (y, cache); the cache (when given) is updated in
    place.  B and C are last-dim views of the conv output and x a
    reshaped view of it: the scan's launchers read them through their
    strides, so nothing is copied for them."""
    B, T, _ = x.shape
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads, cfg.ssm_head_dim
    proj = x @ p.in_proj
    z, dt = proj[..., :di], proj[..., 2 * di + 2 * N:]
    conv_out, conv_tail = _causal_conv(
        proj[..., di:2 * di + 2 * N], p.conv_w, p.conv_b,
        prefix=cache.conv if cache is not None else None)
    conv_out = F.silu(conv_out)
    xc, Bm, Cm = conv_out[..., :di], conv_out[..., di:di + N], conv_out[..., di + N:]

    dt = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log.float())
    xh = xc.reshape(B, T, H, P)
    y, state = mamba_chunk_scan(
        xh, dt, A, Bm, Cm,
        initial_state=cache.state if cache is not None else None)
    y = y + p.D.to(y.dtype)[None, None, :, None] * xh
    y = rms_norm(p.norm, y.reshape(B, T, di) * F.silu(z), cfg.norm_eps)
    if cache is not None:
        cache.conv.copy_(conv_tail)
        cache.state.copy_(state)
    return y @ p.out_proj, cache
