"""Plain PyTorch versions of the SSD (chunked linear-recurrence) kernel
(`repro/kernels/mamba_scan/ref.py:20-124`).

General recurrence, per (batch, head) with an (N, P) state:
    S_t = exp(da_t) · S_{t-1} + B_t xd_tᵀ ;   y_t = C_tᵀ S_t
with xd (B,T,H,P) the pre-scaled input, da (B,T,H) the log decay and
B/C (B,T,H,N) per head.  Mamba2 (da = dt·A, xd = dt·x, group-shared
B/C) is one instance.

``ssd_scan_seq_ref`` — token by token; the numerical oracle.
``ssd_chunk_ref``    — chunked, the kernel's algorithm; the CPU path of
                       `ops.ssd_scan` and the version `chip_smoke.py`
                       holds the CUDA kernel against.
Both return (y (B,T,H,P), final state (B,H,N,P) f32).
"""
from __future__ import annotations

import torch


def ssd_scan_seq_ref(xd, da, Bm, Cm, *, initial_state=None):
    Bsz, T, H, P = xd.shape
    N = Bm.shape[-1]
    xd, da, Bm, Cm = (t.float() for t in (xd, da, Bm, Cm))
    S = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xd.device)
         if initial_state is None else initial_state.float())
    ys = []
    for t in range(T):
        a = torch.exp(da[:, t])
        S = S * a[..., None, None] + Bm[:, t, :, :, None] * xd[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", Cm[:, t], S))
    y = torch.stack(ys, 1) if ys else xd.new_zeros((Bsz, 0, H, P))
    return y, S


def _chunk_body(S_prev, xd, da, Bm, Cm):
    """One chunk for every (batch, head): xd (B,H,L,P); da (B,H,L);
    Bm/Cm (B,H,L,N); S_prev (B,H,N,P)."""
    L = xd.shape[-2]
    s = torch.cumsum(da, -1)                             # inclusive
    stot = s[..., -1]
    G = Cm @ Bm.transpose(-1, -2)                        # (B,H,L,L)
    ii = torch.arange(L, device=xd.device)
    lower = ii[:, None] >= ii[None, :]
    logdec = torch.where(lower, s[..., :, None] - s[..., None, :],
                         torch.tensor(float("-inf"), device=xd.device))
    Y = (G * torch.exp(logdec)) @ xd                     # intra-chunk
    Y = Y + torch.exp(s)[..., None] * (Cm @ S_prev)      # inter-chunk
    S_new = torch.exp(stot)[..., None, None] * S_prev + Bm.transpose(-1, -2) @ (
        torch.exp(stot[..., None] - s)[..., None] * xd)
    return Y, S_new


def ssd_chunk_ref(xd, da, Bm, Cm, *, chunk=128, initial_state=None):
    Bsz, T, H, P = xd.shape
    N = Bm.shape[-1]
    Tp = -(-T // chunk) * chunk
    pad = Tp - T

    def heads_first(t):  # (B,T,H,*) -> f32 (B,H,Tp,*), zero rows past T
        pad_t = (0, 0) * (t.dim() - 2) + (0, pad)
        return torch.nn.functional.pad(t.float(), pad_t).transpose(1, 2)

    xf, daf, Bf, Cf = (heads_first(t) for t in (xd, da, Bm, Cm))
    S = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xd.device)
         if initial_state is None else initial_state.float())
    ys = []
    for lo in range(0, Tp, chunk):
        sl = slice(lo, lo + chunk)
        Y, S = _chunk_body(S, xf[:, :, sl], daf[:, :, sl], Bf[:, :, sl],
                           Cf[:, :, sl])
        ys.append(Y)
    y = torch.cat(ys, 2) if ys else xf.new_zeros((Bsz, H, 0, P))
    return y.transpose(1, 2)[:, :T].to(xd.dtype), S


# ----------------------------------------------------- mamba2 conveniences
def _mamba_args(x, dt, A, Bm, Cm):
    """Mamba2 layout → the general one: xd = dt·x and da = dt·A in f32, and
    the group-shared Bm/Cm (B,T,N) as f32 views broadcast over the heads
    (head stride 0, never a copy per head)."""
    xd = x.float() * dt.float()[..., None]
    da = dt.float() * A.float()[None, None, :]
    shape = (*dt.shape, Bm.shape[-1])
    Bh = Bm.float()[:, :, None, :].expand(shape)
    Ch = Cm.float()[:, :, None, :].expand(shape)
    return xd, da, Bh, Ch


def mamba_chunk_ref(x, dt, A, Bm, Cm, *, chunk=128, initial_state=None):
    y, S = ssd_chunk_ref(*_mamba_args(x, dt, A, Bm, Cm), chunk=chunk,
                         initial_state=initial_state)
    return y.to(x.dtype), S
