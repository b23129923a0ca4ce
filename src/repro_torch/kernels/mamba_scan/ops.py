"""Public SSD ops (`repro/kernels/mamba_scan/ops.py:67-115`).

``ssd_scan``         — general gated linear recurrence.
``mamba_chunk_scan`` — Mamba2 layout (dt/A, group-shared B/C).
``scan_for_desc``    — the launch a `ScanDesc` describes, with the
                       GO-tuned chunk length (`TileConfig.bm`).

CPU tensors take the plain version (`ref.ssd_chunk_ref`); CUDA tensors
take one of the two hand-written routes (`kernel.scan_route`: the decode
kernel at T = 1, the chunked form's three passes otherwise) or raise.
The reference sends a call with
an ``initial_state`` to its XLA version; here a CUDA call with one goes
to the kernel's ``s0`` (the same function), since no plain path runs on
the card.

The backward (`repro/kernels/mamba_scan/ops.py:25-64`): on the card, a
call with no initial state whose operands require grad runs `SSDScan`,
an autograd Function whose forward is the hand-written kernel (the
chunks route for T > 1) and whose backward is the VJP of the plain
`ssd_chunk_ref` at the same ``chunk``, recomputed from the saved
operands, as the reference's `_ssd` does.  A call with an initial state
has no backward on the card (the reference's goes to XLA, with no
custom VJP): its launcher refuses to run under grad.  On the CPU
`ssd_chunk_ref` runs both ways.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan.kernel import (
    chunk_workspace,
    mamba_scan_fwd,
    scan_route,
    scan_shapes,
)
from repro_torch.kernels.mamba_scan.ref import _mamba_args, ssd_chunk_ref


class SSDScan(torch.autograd.Function):
    """The kernel forward, (y, final state), and the VJP of `ssd_chunk_ref`
    at the same chunk for backward."""

    @staticmethod
    def forward(ctx, xd, da, Bm, Cm, chunk, out):
        ctx.save_for_backward(xd, da, Bm, Cm)
        ctx.chunk = chunk
        return _launch(xd, da, Bm, Cm, chunk, None, out)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = tuple(t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            y, state = ssd_chunk_ref(*inputs, chunk=ctx.chunk)
        return (*torch.autograd.grad((y, state), inputs, (gy, gstate)), None, None)


def _launch(xd, da, Bm, Cm, chunk, initial_state, out):
    y, state, workspace = out if out is not None else (None, None, None)
    return mamba_scan_fwd(xd, da, Bm, Cm, chunk=chunk, initial_state=initial_state,
                          out=None if out is None else (y, state),
                          workspace=workspace)


def ssd_scan(xd, da, Bm, Cm, *, chunk: int = 128, initial_state=None,
             out=None):
    """General SSD: xd (B,T,H,P); da (B,T,H); Bm/Cm (B,T,H,N).  Returns
    (y, final_state); ``out`` (CUDA only) is a `scan_buffers` triple for
    this ``chunk``.  On the card, with no initial state, where grad is
    enabled and an operand requires it, the call runs through `SSDScan`."""
    if all(t.device.type == "cpu" for t in (xd, da, Bm, Cm)):
        return ssd_chunk_ref(xd, da, Bm, Cm, chunk=chunk,
                             initial_state=initial_state)
    if (initial_state is None and torch.is_grad_enabled()
            and any(t.requires_grad for t in (xd, da, Bm, Cm))):
        return SSDScan.apply(xd, da, Bm, Cm, chunk, out)
    return _launch(xd, da, Bm, Cm, chunk, initial_state, out)


def scan_buffers(xd, da, Bm, Cm, *, chunk: int = 128) -> tuple:
    """Allocate, on the current stream, what a scan launch writes: y
    (B,T,H,P) in xd's dtype, the final state (B,H,N,P) float32 and, on
    the chunks route, the `chunk_workspace` for ``chunk`` (None on the
    decode route, which needs none)."""
    B, T, H, P, N = scan_shapes(xd, da, Bm, Cm)
    workspace = (chunk_workspace(B, T, H, P, N, chunk, xd.device)
                 if scan_route(T, P, N, chunk) == "chunks" else None)
    return (torch.empty((B, T, H, P), dtype=xd.dtype, device=xd.device),
            torch.empty((B, H, N, P), dtype=torch.float32, device=xd.device),
            workspace)


def scan_chunk(tile) -> int:
    """The chunk length a GO `TileConfig` names (bm, clamped to [8, 512])."""
    return 128 if tile is None else max(8, min(int(tile.bm), 512))


def scan_desc_buffers(desc, xd, da, Bm, Cm, *, tile=None) -> tuple:
    """`scan_buffers` for the launch `scan_for_desc` makes at ``tile``:
    the family's ``buffers`` hook, so that a mixed launch takes a scan
    member's y, state and workspace on the launching stream
    (`core/scheduler.py:_run_mixed`)."""
    return scan_buffers(xd, da, Bm, Cm, chunk=scan_chunk(tile))


def scan_for_desc(desc, xd, da, Bm, Cm, *, tile=None, out=None):
    """Run the SSD-scan launch a `ScanDesc` describes at the group's GO
    ``tile``, into ``out`` (its `scan_desc_buffers`) when given; returns
    y."""
    y, _ = ssd_scan(xd, da, Bm, Cm, chunk=scan_chunk(tile), out=out)
    return y


def mamba_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int = 128,
                     initial_state=None):
    """Mamba2 SSD.  x (B,T,H,P); dt (B,T,H); A (H,); Bm/Cm (B,T,N)."""
    y, S = ssd_scan(*_mamba_args(x, dt, A, Bm, Cm), chunk=chunk,
                    initial_state=initial_state)
    return y.to(x.dtype), S
