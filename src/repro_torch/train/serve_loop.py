"""Serving (`repro/train/serve_loop.py`): batched prefill and greedy decode
with fixed-capacity caches, under `torch.inference_mode`.

When a `repro_torch.runtime.Runtime` is passed, each decode step also
routes its ops through the online runtime in shadow dispatch
(``RuntimeConfig.execute=False``, the runtime's default): the dynamic
logic plans and meters the step's GEMM bundle (``mixed_ops``: the whole
op bundle; ``graph``: the step as a dependency graph) while the model
does the math.  Telemetry then reports CD, modes and plan-cache
behaviour for the run.

A model sharded on a model axis (`Model(mesh=...)`) runs here unchanged:
each rank calls `greedy_decode` on its shard, every call ends with the
whole logits on every rank, and every rank returns the same tokens.  The
runtime's requests stay those of the whole model (`decode_step_requests`
of its config, global shapes), as in the reference; `Runtime.set_mesh`
derates its budget to the mesh.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import GemmRequest
from repro_torch.core.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.runtime import (
    decode_step_graph,
    decode_step_op_descs,
    decode_step_requests,
    prewarm_decode,
)


def make_serve_fns(model: Model) -> Tuple[Callable, Callable]:
    def prefill(batch, cache):
        return model.prefill(batch, cache)

    def decode_step(tokens, cache, cache_len):
        return model.decode_step(tokens, cache, cache_len)

    return prefill, decode_step


@torch.inference_mode()
def greedy_decode(
    model: Model, prompt_batch, *, s_max: int, steps: int,
    cache_dtype=torch.float32, runtime: Optional[Any] = None,
    tenant: str = "default", mixed_ops: bool = False, graph: bool = False,
    device="cuda", on_step: Optional[Callable] = None,
):
    """Greedy generation: (B, steps) int64 tokens on ``device``.

    ``device`` must be the model's (CUDA unless asked for the CPU; raises
    without it); the prompt's tensors are moved there.  An audio-stub
    model raises `ValueError`: its step takes frames, not tokens.  ``runtime``, as
    in the reference: each decode step's GEMM requests (``mixed_ops``:
    its whole op bundle; ``graph``: its `decode_step_graph`, drained per
    step) are submitted in shadow and flushed.  ``on_step(logits)``, when
    given, sees the prefill's and every decode step's logits (B, 1, V).
    Nothing waits for the card before the final `torch.cat`."""
    if model.cfg.frontend == "audio_frames":
        raise ValueError(
            f"greedy_decode: {model.cfg.name}'s decode step takes a frame "
            "embedding (B, 1, D), and a greedy loop has only the argmax codes "
            "to feed back (the reference's loop feeds them as tokens and cannot "
            "run it either); drive Model.prefill and Model.decode_step with frames")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"greedy_decode on {device}: the model is on {model.device}")
    batch = {k: v.to(device) for k, v in prompt_batch.items()}
    B = next(iter(batch.values())).shape[0]
    cache = model.init_cache(batch=B, s_max=s_max, dtype=cache_dtype)
    logits, cache, cache_len = model.prefill(batch, cache)
    if on_step is not None:
        on_step(logits)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    step_requests = step_bundle = step_graph = None
    if runtime is not None and graph:
        # the same dependency structure every step: built once, submitted
        # per step; prewarm seeds GO entries and one plan per wave
        step_graph = decode_step_graph(model.cfg, B, context=s_max)
        runtime.prewarm(step_graph)
    elif runtime is not None and mixed_ops:
        descs = decode_step_op_descs(model.cfg, B, context=s_max)
        runtime.prewarm(descs)
        step_bundle = [GemmRequest(desc=d) for d in descs]
    elif runtime is not None:
        prewarm_decode(runtime, model.cfg, batches=[B])
        step_requests = decode_step_requests(runtime.ctrl, model.cfg, B)
    out = []
    for _ in range(steps):
        out.append(tok)
        if step_graph is not None:
            runtime.submit(step_graph, tenant=tenant)
        elif step_bundle is not None:
            runtime.submit(step_bundle, tenant=tenant)
        elif step_requests is not None:
            for req in step_requests:
                runtime.submit(req, tenant=tenant)
        logits, cache, cache_len = model.decode_step(tok, cache, cache_len)
        if on_step is not None:
            on_step(logits)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        if runtime is not None:
            if step_graph is not None:
                # a graph spans several flushes (each completion wave
                # releases the next), so the whole step drains
                runtime.drain()
            else:
                runtime.flush(force=True)
    return torch.cat(out, dim=1)
