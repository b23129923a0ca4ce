"""Plain PyTorch versions of the SSD (chunked linear-recurrence) kernel
(`repro/kernels/mamba_scan/ref.py:20-124`).

General recurrence, per (batch, head) with an (N, P) state:
    S_t = exp(da_t) · S_{t-1} + B_t xd_tᵀ ;   y_t = C_tᵀ S_t
with xd (B,T,H,P) the pre-scaled input, da (B,T,H) the log decay and
B/C (B,T,H,N) per head.  Mamba2 (da = dt·A, xd = dt·x, group-shared
B/C) is one instance.

``ssd_scan_seq_ref`` — token by token; the numerical oracle.
``ssd_chunk_ref``    — chunked, chunk after chunk as the TPU kernel walks
                       them; the CPU path of `ops.ssd_scan` and the version
                       `chip_smoke.py` holds the CUDA kernels against.
``ssd_decomposed_ref`` — the chunked form the card's kernels compute, in
                       its three passes (`ssd_chunk_states_ref`: each
                       chunk's local end state; `ssd_carry_ref`: the
                       states carried across chunks; `ssd_chunk_outputs_ref`:
                       each chunk's y), at ``precision`` "f32", or
                       emulating the tensor-core products: "bf16x2" (each
                       f32 operand split into bf16 hi and lo parts, as the
                       kernels split it), "bf16" (one bf16 rounding, what
                       they avoid).
All return (y (B,T,H,P), final state (B,H,N,P) f32).
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


# ------------------------------------------- the chunked form, by passes
PRECISIONS = ("f32", "bf16x2", "bf16")


def split_bf16(x, precision: str = "bf16x2"):
    """``x`` as the bf16 parts a product on the tensor cores takes, in f32:
    hi = bf16(x) and lo = bf16(x − hi) ("bf16x2"; lo = 0 for "bf16");
    ``(x, 0)`` for "f32"."""
    if precision == "f32":
        return x, torch.zeros_like(x)
    hi = x.to(torch.bfloat16).float()
    lo = ((x - hi).to(torch.bfloat16).float() if precision == "bf16x2"
          else torch.zeros_like(x))
    return hi, lo


def _split_matmul(a, b, precision: str, split_a: bool, split_b: bool):
    """a @ b as the kernels issue it: an operand held in f32 is split in
    two (hi·hi + hi·lo + lo·hi; the lo·lo term is dropped), f32 sums."""
    ah, al = split_bf16(a, precision) if split_a else (a, torch.zeros_like(a))
    bh, bl = split_bf16(b, precision) if split_b else (b, torch.zeros_like(b))
    return ah @ (bh + bl) + al @ bh


def _by_chunks(t, chunk: int):
    """(B,T,H,*) → f32 (B,H,chunks,chunk,*), zero rows past T."""
    T = t.shape[1]
    pad = -(-T // chunk) * chunk - T
    t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
    t = t.transpose(1, 2)
    return t.reshape(t.shape[0], t.shape[1], -1, chunk, *t.shape[3:])


def _inputs(xd, Bm, Cm, precision: str):
    """xd, B and C as the kernels stage them: bf16 exactly, f32 split into
    hi + lo (each sum exact in f32)."""
    if precision == "f32":
        return xd, Bm, Cm
    return tuple(sum(split_bf16(t, precision)) for t in (xd, Bm, Cm))


def ssd_chunk_states_ref(xd, da, Bm, Cm, *, chunk: int = 128, precision: str = "f32"):
    """Pass 1: per chunk, s = cumsum(da), the local end state
    S_loc = Bᵀ·(exp(s_L − s) ∘ xd) (B,H,chunks,N,P) and the decay exp(s_L)
    (B,H,chunks).  Rows past T are zero (da too), so a short last chunk's
    s_L is its last real row's.  The kernel splits Bᵀ ∘ exp(s_L − s) (and
    an f32 xd)."""
    x, b, _ = (_by_chunks(t, chunk) for t in _inputs(xd, Bm, Cm, precision))
    s = torch.cumsum(_by_chunks(da, chunk), -1)
    last = s[..., -1:]
    a = (b * torch.exp(last - s)[..., None]).transpose(-1, -2)
    states = _split_matmul(a, x, precision, True, xd.dtype == torch.float32)
    return states, torch.exp(last[..., 0])


def ssd_carry_ref(states, decay, initial_state=None):
    """Pass 2: S_c = exp(s_L,c)·S_{c−1} + S_loc,c from ``initial_state``
    (zeros when None).  Returns the state entering each chunk
    (B,H,chunks,N,P) and the final state."""
    S = (torch.zeros_like(states[:, :, 0]) if initial_state is None
         else initial_state.float())
    incoming = torch.empty_like(states)
    for c in range(states.shape[2]):
        incoming[:, :, c] = S
        S = decay[:, :, c, None, None] * S + states[:, :, c]
    return incoming, S


def ssd_chunk_outputs_ref(xd, da, Bm, Cm, incoming, *, chunk: int = 128,
                          precision: str = "f32"):
    """Pass 3: per chunk, Y = (C·Bᵀ ∘ exp(s_i − s_j)[i ≥ j])·xd +
    exp(s) ∘ (C·S_{c−1}); the i < j half is masked before the exponential.
    The kernel splits W = C·Bᵀ ∘ exp(s_i − s_j) and S_{c−1} (and f32
    inputs).  Returns y (B,T,H,P) in xd's dtype."""
    T = xd.shape[1]
    f32_in = xd.dtype == torch.float32
    x, b, c = (_by_chunks(t, chunk) for t in (xd, Bm, Cm))
    s = torch.cumsum(_by_chunks(da, chunk), -1)
    ii = torch.arange(chunk, device=xd.device)
    lower = ii[:, None] >= ii[None, :]
    zero = torch.zeros((), device=xd.device)
    logdec = torch.where(lower, s[..., :, None] - s[..., None, :], zero)
    decay = torch.where(lower, torch.exp(logdec), zero)
    G = _split_matmul(c, b.transpose(-1, -2), precision, f32_in, f32_in)
    Y = _split_matmul(G * decay, x, precision, True, f32_in)
    Y = Y + torch.exp(s)[..., None] * _split_matmul(c, incoming, precision, f32_in, True)
    Bsz, H = Y.shape[:2]
    return Y.reshape(Bsz, H, -1, Y.shape[-1]).transpose(1, 2)[:, :T].to(xd.dtype)


def ssd_decomposed_ref(xd, da, Bm, Cm, *, chunk: int = 128, initial_state=None,
                       precision: str = "f32"):
    """The three passes in order: (y, final state)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    states, decay = ssd_chunk_states_ref(xd, da, Bm, Cm, chunk=chunk, precision=precision)
    incoming, final = ssd_carry_ref(states, decay, initial_state)
    y = ssd_chunk_outputs_ref(xd, da, Bm, Cm, incoming, chunk=chunk, precision=precision)
    return y, final


def ssd_lost_carry(y, state, incoming, decay, xd, da, Bm, Cm, *, chunk: int,
                   lost: int):
    """A planted fault for the scan's check: the y and final state a scan
    would give if the state entering chunk ``lost`` were taken as zero,
    from a run's y, final state and workspace (``incoming`` states and
    ``decay``s after the launch).  The lost state Δ leaves chunk k ≥ lost
    as exp(s) ∘ (C·Δ) and decays by exp(s_L,k) into the next chunk."""
    T = xd.shape[1]
    c = _by_chunks(Cm, chunk)
    s = torch.cumsum(_by_chunks(da, chunk), -1)
    delta = incoming[:, :, lost].clone()
    y = y.float().clone()
    for k in range(lost, incoming.shape[2]):
        lo, n = k * chunk, min(chunk, T - k * chunk)
        lose = torch.exp(s[:, :, k])[..., None] * (c[:, :, k] @ delta)
        y[:, lo:lo + n] -= lose.transpose(1, 2)[:, :n]
        delta = decay[:, :, k, None, None] * delta
    return y.to(xd.dtype), state - delta


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
