"""AdamW with a cosine schedule and global-norm clipping
(`repro/optim/adamw.py`), in plain tensor code over a dict of parameters.

The update is the reference's, op for op: the gradients' global norm in
f32, every gradient scaled by min(1, clip / norm), f32 first and second
moments with bias correction, and decoupled weight decay on tensors of
two or more dims only (by the dims the caller declares for each leaf,
``ndims``: the training step gives the reference's, where a stacked
layer's vector is a matrix).  `torch.optim.AdamW` is not this update (it
decays before the step and clips nothing), so it is not used.

The state (`AdamWState`: step, ``mu``, ``nu``) mirrors the parameter
dict, ``mu`` and ``nu`` in f32.  `AdamW.update` writes the new moments
and parameters into the tensors it is given and returns them: the
reference's jitted step donates its state the same way, and a
full-depth model's state is too large to hold twice on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor; f32): linear
    warm-up over ``warmup_steps``, then a cosine down to ``min_lr_frac``
    of ``lr`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32, 0-dim
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        """Zero moments in f32 beside each parameter, step 0."""
        dev = next(iter(params.values())).device
        return AdamWState(
            torch.zeros((), dtype=torch.int32, device=dev),
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()},
            {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamWState,
               params: Dict[str, torch.Tensor],
               ndims: Optional[Dict[str, int]] = None,
               view: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
        """One step: returns (params, state, {"gnorm", "lr"}), the new values
        written into ``params``, ``state.mu`` and ``state.nu`` (module
        docstring).  ``ndims``: each leaf's dims for the decay rule, by
        default its tensor's.  ``view(name, tensor)``: update only that
        slice of each parameter (ZeRO-1, `dist/zero1.py`), whose moments
        are ``state.mu`` and ``state.nu``; the clipping norm is the whole
        gradient's, and every update is elementwise, so the slices get
        exactly the elements of the whole update.  Every scalar stays on
        the device: nothing here waits for the card."""
        cfg = self.cfg
        step = state.step + 1
        gsq = sum(torch.sum(g.float() ** 2) for g in grads.values())
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
        lr = cosine_schedule(cfg, step)
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        for k, p in params.items():
            ndim = p.dim() if ndims is None else ndims[k]
            g = grads[k]
            if view is not None:
                p, g = view(k, p), view(k, g)
            m, v = state.mu[k], state.nu[k]
            if not p.numel():
                continue
            # The reference's expression, one rounding per operation in its
            # order; written in place to spare the allocations.
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))           # b1·m + (1−b1)·g
            t = torch.mul(g, 1 - cfg.b2).mul_(g)             # (1−b2)·g·g
            v.mul_(cfg.b2).add_(t)
            torch.div(v, b2c, out=t).sqrt_().add_(cfg.eps)   # √(v/b2c) + ε
            delta = torch.div(m, b1c, out=g).div_(t)         # (m/b1c) / (…)
            if ndim >= 2:  # decoupled weight decay on matrices only
                delta.add_(torch.mul(p, cfg.weight_decay, out=t))
            p.sub_(delta.mul_(lr))                           # p − lr·δ
        return params, AdamWState(step, state.mu, state.nu), {"gnorm": gnorm, "lr": lr}
