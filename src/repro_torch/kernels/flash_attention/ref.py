"""Plain PyTorch versions of the attention kernel
(`repro/kernels/flash_attention/ref.py:21-100`).

``mha_ref``   — dense O(T·S) attention; the numerical oracle.
``flash_ref`` — online-softmax attention over kv blocks of ``block_kv``;
                the CPU path of `ops.flash_attention` and the version
                `chip_smoke.py` holds the CUDA kernel against, within
                ``attention_tol``.

Layouts: q (B, Hq, T, D); k, v (B, Hkv, S, D); GQA via Hq % Hkv == 0 (q
head h reads kv head h // (Hq/Hkv)).  ``window > 0`` is sliding-window
causal attention.  Masked scores are -1e30 as in the reference, so a
query row that sees no key differs between the two (ROADMAP queue C).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(qpos, kpos, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def mha_ref(q, k, v, *, causal=True, window=0, scale=None, q_offset=0):
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    scale = scale if scale is not None else D ** -0.5
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    s = s * scale
    qpos = torch.arange(T, device=q.device) + q_offset
    kpos = torch.arange(S, device=q.device)
    m = _mask(qpos, kpos, causal, window)
    s = torch.where(m[None, None], s, torch.tensor(NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)


def flash_ref(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
              block_kv=512):
    """Online-softmax attention, one kv block of ``block_kv`` at a time."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    Dv = v.shape[-1]  # MLA-style dv may differ from dqk
    scale = scale if scale is not None else D ** -0.5
    rep = Hq // Hkv
    qpos = torch.arange(T, device=q.device) + q_offset
    qf = (q * scale).float()
    m = torch.full((B, Hq, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, T, Dv), dtype=torch.float32, device=q.device)
    for lo in range(0, S, block_kv):
        hi = min(lo + block_kv, S)
        kpos = torch.arange(lo, lo + block_kv, device=q.device)
        krep = k[:, :, lo:hi].float().repeat_interleave(rep, dim=1)
        s = torch.einsum("bhtd,bhsd->bhts", qf, krep)
        if hi - lo < block_kv:   # the reference's zero padding past S
            s = torch.nn.functional.pad(s, (0, block_kv - (hi - lo)))
        msk = (kpos < S)[None, :].expand(T, block_kv).clone()
        if causal:
            msk &= qpos[:, None] >= kpos[None, :]
        if window:
            msk &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(msk[None, None], s,
                        torch.tensor(NEG_INF, device=s.device))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        vrep = v[:, :, lo:hi].float().repeat_interleave(rep, dim=1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhts,bhsd->bhtd", p[..., :hi - lo], vrep)
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l[..., None]).to(q.dtype)


def attention_tol(dtype: torch.dtype) -> tuple[float, float]:
    """(atol, rtol) of the check |kernel − flash_ref(q, k, v in f32)| ≤
    atol + rtol·|ref| for a kernel output of ``dtype``.

    The kernel computes in f32 from the exactly converted inputs, as the
    plain version does on f32 copies, so the two differ only by f32
    summation order (~1e-6 at 4,096 keys), far inside the reference tests'
    f32 tolerance of 2e-4 (`tests/test_kernel_attention.py`), plus, for a
    bf16 output, the kernel's one rounding of its f32 result: at most half
    a bf16 unit in the last place, 2⁻⁸·|ref|.  With N(0, 1) inputs a decode
    row's output has a spread of ~√(e/S), 0.026 at S = 4,096; a kernel that
    skipped one 64-key sub-tile there moves outputs by ~(64/S)·√(e/64) ≈
    3e-3 and fails (`tests/test_torch_attention.py`, and `chip_smoke.py`
    on the card)."""
    return 2e-4, 2e-4 + (2.0 ** -8 if dtype == torch.bfloat16 else 0.0)
