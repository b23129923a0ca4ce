"""Plain PyTorch versions of the attention kernel
(`repro/kernels/flash_attention/ref.py:21-100`).

``mha_ref``   — dense O(T·S) attention; the numerical oracle.
``flash_ref`` — online-softmax attention over kv blocks of ``block_kv``;
                the CPU path of `ops.flash_attention` and the version
                `chip_smoke.py` holds the CUDA kernel against, within
                ``attention_tol``.
``flash_split_ref`` / ``flash_combine_ref`` — the decode kernel's
                split-KV arithmetic: per split of the kv range, each
                row's f32 (m, l, acc) in the kernel's partial layout, and
                their merge in split order.
``flash_prefill_ref`` — the prefill kernel's arithmetic: its tile walk
                (`kernel.prefill_tiles`) in order, P split into bf16 high
                and low parts.

Layouts: q (B, Hq, T, D); k, v (B, Hkv, S, D); GQA via Hq % Hkv == 0 (q
head h reads kv head h // (Hq/Hkv)).  ``window > 0`` is sliding-window
causal attention.  Masked scores are -1e30 as in the reference, so a
query row that sees no key differs between the two (ROADMAP queue C).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    PREFILL_KV_TILE,
    PREFILL_ROWS,
    PREFILL_WG_ROWS,
    prefill_tiles,
)

NEG_INF = -1e30
LOG2E = 1.4426950408889634


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


def flash_split_ref(q, k, v, *, split_len: int, causal=True, window=0,
                    scale=None, q_offset=0):
    """Per split [s·split_len, (s+1)·split_len) ∩ [0, S) of the keys, each
    row's softmax state over the keys of the split it sees, in f32 and in
    the CUDA kernel's partial layout: ``(part_acc, part_ml)``, (splits, B,
    Hq, T, Dv) and (splits, B, Hq, T, 2).  m is the max of the row's
    visible scores (-1e30 when it sees none), l = Σ e^(s − m) over them and
    acc = Σ e^(s − m)·v; masked keys weigh 0, so a split a row cannot see
    has l = 0 and acc = 0."""
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    Dv = v.shape[-1]
    scale = scale if scale is not None else D ** -0.5
    rep = Hq // Hkv
    splits = max(1, -(-S // split_len))
    qpos = torch.arange(T, device=q.device) + q_offset
    qf = q.float() * scale
    part_acc = q.new_zeros((splits, B, Hq, T, Dv), dtype=torch.float32)
    part_ml = q.new_zeros((splits, B, Hq, T, 2), dtype=torch.float32)
    for sp in range(splits):
        lo, hi = sp * split_len, min((sp + 1) * split_len, S)
        kpos = torch.arange(lo, hi, device=q.device)
        krep = k[:, :, lo:hi].float().repeat_interleave(rep, dim=1)
        vrep = v[:, :, lo:hi].float().repeat_interleave(rep, dim=1)
        sc = torch.einsum("bhtd,bhsd->bhts", qf, krep)
        msk = _mask(qpos, kpos, causal, window)[None, None]
        m = torch.where(msk, sc, torch.tensor(NEG_INF, device=q.device))
        m = m.amax(-1) if hi > lo else torch.full((B, Hq, T), NEG_INF,
                                                   device=q.device)
        p = torch.where(msk, torch.exp(sc - m[..., None]), 0.0)
        part_ml[sp, ..., 0] = m
        part_ml[sp, ..., 1] = p.sum(-1)
        part_acc[sp] = torch.einsum("bhts,bhsd->bhtd", p, vrep)
    return part_acc, part_ml


def flash_combine_ref(part_acc, part_ml, dtype):
    """The splits merged in split order: out = Σ_s e^(m_s − M)·acc_s /
    Σ_s e^(m_s − M)·l_s with M = max_s m_s, cast once to ``dtype``; a
    row whose l sums to 0 (it sees no key) gets 0, as the kernel writes."""
    m = part_ml[..., 0]
    big = m.amax(0)
    l_sum = torch.zeros_like(big)
    acc = torch.zeros_like(part_acc[0])
    for sp in range(part_acc.shape[0]):
        f = torch.exp(m[sp] - big)
        l_sum = l_sum + part_ml[sp, ..., 1] * f
        acc = acc + part_acc[sp] * f[..., None]
    out = torch.where(l_sum[..., None] == 0, 0.0,
                      acc / torch.where(l_sum == 0, 1.0, l_sum)[..., None])
    return out.to(dtype)


def flash_prefill_ref(q, k, v, *, causal=True, window=0, scale=None, q_offset=0,
                      precision="bf16x2"):
    """The prefill kernel's arithmetic in plain PyTorch, in f32: per block
    of `PREFILL_ROWS` query positions and per warpgroup of its
    `PREFILL_WG_ROWS` rows, the tiles of `prefill_tiles` in order —
    nothing on a "skip" tile, the per-element mask on a "mask" tile —
    with the running max in base 2 (the raw scores' max times scale·log₂e),
    each weight 2^(s·scale·log₂e − m), the rescale by 2^(m_old − m), and
    P·V with P split into a bf16 high part
    and the bf16 of what it leaves out (``precision="bf16x2"``, the
    kernel's; ``"bf16"`` rounds P once).  A row that sees no key gives 0.
    Returns q's dtype."""
    if precision not in ("bf16x2", "bf16"):
        raise ValueError(f"precision {precision!r}: 'bf16x2' or 'bf16'")
    B, Hq, T, D = q.shape
    _, Hkv, S, _ = k.shape
    Dv = v.shape[-1]
    scale2 = (scale if scale is not None else D ** -0.5) * LOG2E
    rep = Hq // Hkv
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    out = torch.zeros((B, Hq, T, Dv), dtype=torch.float32, device=q.device)
    for q0, tiles in prefill_tiles(T, S, causal=causal, window=window,
                                   q_offset=q_offset):
        for wg in range(PREFILL_ROWS // PREFILL_WG_ROWS):
            r0 = q0 + wg * PREFILL_WG_ROWS
            r1 = min(r0 + PREFILL_WG_ROWS, T)
            if r1 <= r0:
                continue
            qf = q[:, :, r0:r1].float()
            qpos = torch.arange(r0, r1, device=q.device) + q_offset
            m = torch.full((B, Hq, r1 - r0), NEG_INF, device=q.device)
            l = torch.zeros((B, Hq, r1 - r0), device=q.device)
            acc = torch.zeros((B, Hq, r1 - r0, Dv), device=q.device)
            for tile in tiles:
                if tile.modes[wg] == "skip":
                    continue
                k0, k1 = tile.k0, min(tile.k0 + PREFILL_KV_TILE, S)
                s = torch.einsum("bhtd,bhsd->bhts", qf, kf[:, :, k0:k1])
                if tile.modes[wg] == "mask":
                    msk = _mask(qpos, torch.arange(k0, k1, device=q.device), causal,
                                window)
                    s = torch.where(msk[None, None], s, -torch.inf)
                m_new = torch.maximum(m, s.amax(-1) * scale2)
                alpha = torch.exp2(m - m_new)
                w = torch.exp2(s * scale2 - m_new[..., None])   # a masked key: 0
                l = l * alpha + w.sum(-1)
                hi = w.to(torch.bfloat16).float()
                pv = torch.einsum("bhts,bhsd->bhtd", hi, vf[:, :, k0:k1])
                if precision == "bf16x2":
                    lo = (w - hi).to(torch.bfloat16).float()
                    pv = pv + torch.einsum("bhts,bhsd->bhtd", lo, vf[:, :, k0:k1])
                acc = acc * alpha[..., None] + pv
                m = m_new
            out[:, :, r0:r1] = torch.where(
                l[..., None] == 0, 0.0, acc / torch.where(l == 0, 1.0, l)[..., None])
    return out.to(q.dtype)


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
