"""Public flash-attention op and its descriptor adapter
(`repro/kernels/flash_attention/ops.py:53-98`).

CPU tensors take the plain version (`ref.flash_ref`), as the reference
does off the TPU; CUDA tensors take one of the two hand-written kernels
(`kernel.attention_route`: the prefill kernel for bf16 prefills, the
split-KV kernel for the rest) or raise.  `attention_buffers` (the
family's ``buffers`` hook) allocates the output and, on the card's
decode route, the kernel's split partials, so a mixed launch allocates
them before it forks.  The q/kv block sizes are the family's tile axes:
`attention_for_desc` maps a GO-library `TileConfig` onto them (bm → bq,
bn → bkv), so the scheduler runs an `AttentionDesc` member at its tuned
tile; on the prefill route they change no result and do not size the
CTA, which wgmma's 64-row minimum fixes (128 positions, 64-key tiles).

The backward (`repro/kernels/flash_attention/ops.py:25-50`): on the card,
where an operand requires grad, `flash_attention` runs `FlashAttention`,
an autograd Function whose forward is the hand-written kernel and whose
backward is the VJP of the plain `flash_ref`, recomputed from the saved
q, k and v, as the reference's backward is the VJP of its XLA
`flash_ref`.  On the CPU `flash_ref` runs both ways, as in the reference
off the TPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    AttentionBuffers,
    attention_buffers,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import flash_ref


class FlashAttention(torch.autograd.Function):
    """The kernel forward, and the VJP of `flash_ref` for backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset, bq, bkv, out):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, scale=scale, q_offset=q_offset)
        return flash_attention_fwd(q, k, v, bq=bq, bkv=bkv, out=out, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_ref(q, k, v, **ctx.kw)
        return (*torch.autograd.grad(out, (q, k, v), g), *(None,) * 7)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, q_offset: int = 0,
                    bq: int = 128, bkv: int = 128,
                    out: AttentionBuffers | None = None):
    """Attention of q (B,Hq,T,D) over k (B,Hkv,S,D) and v (B,Hkv,S,Dv).
    For an MLA-style dv ≠ dqk the reference zero-pads V to dqk and slices
    the output (`:71-77`); the kernel reads V at its own width, which is
    the same function with no padding copy.  ``out`` (CUDA only, an
    `AttentionBuffers` from `attention_buffers`) receives the result and
    the kernel's split partials.  On the card, where grad is enabled and
    an operand requires it, the call runs through `FlashAttention`."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_ref(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, scale, q_offset,
                                    bq, bkv, out)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset, bq=bq, bkv=bkv,
                               out=out)


def attention_tiles(tile) -> dict:
    """A GO `TileConfig` as the kernel's blocks: bm → bq, bn → bkv."""
    if tile is None:
        return {}
    return {"bq": max(8, min(tile.bm, 512)), "bkv": max(128, min(tile.bn, 512))}


def attention_for_desc(desc, q, k, v, *, tile=None, out=None):
    """Run the launch an `AttentionDesc` describes, at the group's GO
    ``tile``, with the decode-style suffix alignment q_offset = Skv − Sq."""
    return flash_attention(q, k, v, causal=desc.causal,
                           q_offset=desc.Skv - desc.Sq, out=out,
                           **attention_tiles(tile))
