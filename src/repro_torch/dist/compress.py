"""Error-feedback gradient compression (`repro/dist/compress.py`).

Per leaf, symmetric int8: ``scale = max|g + e| / 127``, round half to
even (`torch.round`, as `jnp.round`), clip to ±127; the dequantized
gradient goes on, the residual ``(g + e) − q·scale`` is carried to the
next step.  Over T steps Σ q_t + e_{T+1} = Σ g_t (telescoping, exact in
real arithmetic), so the compressed stream keeps the gradient's sum.

As in the reference the transform runs on the mean gradient, after the
data-parallel reduction (`make_train_step(grad_transform=...)`): no wire
carries int8 here, and `compressed_bytes` says what one would.  Over the
port's dict of gradients, in its order.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

QMAX = 127.0   # symmetric int8 range


def ef_init(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero f32 error-feedback buffers beside each gradient (or parameter)."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def _compress_leaf(g: torch.Tensor, e: torch.Tensor):
    x = g.float() + e
    scale = torch.clamp(torch.max(torch.abs(x)) / QMAX, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -QMAX, QMAX)
    deq = q * scale
    return deq.to(g.dtype), x - deq


def compress_grads(grads: Dict[str, torch.Tensor], ef: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantize ``grads + ef`` to int8 buckets; returns (the dequantized
    gradients, the new error buffers), which the caller feeds back on the
    next step (`launch/train.py --compress-grads`)."""
    if grads.keys() != ef.keys():
        raise ValueError(f"grads have {len(grads)} leaves, ef has {len(ef)}, or "
                         "their names differ")
    pairs = {k: _compress_leaf(g, ef[k]) for k, g in grads.items()}
    return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}


def compressed_bytes(grads: Dict[str, torch.Tensor]) -> int:
    """Wire bytes of one int8-compressed gradient sync (1 B an element and
    a 4-byte scale a leaf)."""
    return sum(g.numel() + 4 for g in grads.values())
