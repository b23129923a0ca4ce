"""Training step (`repro/train/train_loop.py`): mixed precision,
microbatched gradient accumulation, an optional gradient transform, and
AdamW.

Master parameters live in f32 (`TrainState.params`, a dict keyed by the
model's parameter names).  The forward runs on a cast of them (`_cast`:
f32 leaves of two or more dims to ``compute_dtype``; vectors stay f32),
and the step differentiates with respect to that cast, as the reference
does.  A leaf's dims are those the reference declares (`Spec.ndim`): it
stacks a layer's weights on a leading axis, so a stacked layer's vector
(a norm scale, ``conv_b``, ``A_log``) is a matrix there, cast and
weight-decayed; only unstacked vectors (the final norm, Zamba2's shared
block's norms) stay f32 and undecayed.  In the step,
`torch.func.functional_call` runs the model's loss with the cast leaves
in place of its parameters, and `torch.autograd.grad` takes the gradient
with respect to them.  With ``n_microbatches > 1`` the step sums the
microbatches' f32 gradients and divides once (the loss likewise); the
metrics are the last microbatch's.

`train_state_from_reference` carries a reference ``TrainState`` across.

With a `dist.zero1.Zero1` plan (``zero1=``) the step is data parallel:
each rank takes its rows of the batch, the gradients' mean over ranks
is all-reduced before the transform and the optimizer, which updates
this rank's slice of the masters and moments, and the masters are
all-gathered; the loss and the loss's metrics are the ranks' mean (a
mean of per-rank means: the global mean where every rank has as many
labelled tokens; the MoE aux loss is per rank's rows).  `train_init`
then makes the moments of this rank's slices only.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.dist.zero1 import Zero1
from repro_torch.models.convert import unstacked
from repro_torch.models.model import Model
from repro_torch.models.spec import declared_ndims
from repro_torch.optim.adamw import AdamW, AdamWState


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]    # f32 masters
    opt: AdamWState
    step: torch.Tensor                 # int32, 0-dim


def train_init(model: Model, optimizer: AdamW, zero1: Optional[Zero1] = None) -> TrainState:
    """f32 masters copied from the model's weights (its init from a seed,
    `build_model`), the optimizer's zero state (of this rank's ZeRO-1
    slices, with ``zero1``), and step 0."""
    params = {k: p.detach().float().clone() for k, p in model.named_parameters()}
    owned = params if zero1 is None else {k: zero1.view(k, p) for k, p in params.items()}
    return TrainState(params, optimizer.init(owned),
                      torch.zeros((), dtype=torch.int32, device=model.device))


def train_state_from_reference(model: Model, state) -> TrainState:
    """The port's `TrainState` from a reference ``TrainState`` handed over
    as numpy: ``state.params``, ``state.opt.mu`` and ``state.opt.nu``
    nested dicts of stacked arrays (each unstacked as `unstacked` does),
    ``state.opt.step`` and ``state.step`` scalars.  Every tensor lands on
    the model's device, the masters and moments in f32."""
    dev = model.device

    def tensors(tree):
        return {k: torch.tensor(v, dtype=torch.float32, device=dev)
                for k, v in unstacked(model, tree).items()}

    def scalar(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(tensors(state.params),
                      AdamWState(scalar(state.opt.step), tensors(state.opt.mu),
                                 tensors(state.opt.nu)),
                      scalar(state.step))


def _cast(params: Dict[str, torch.Tensor], dtype,
          ndims: Dict[str, int]) -> Dict[str, torch.Tensor]:
    """f32 leaves of two or more declared dims (``ndims``) to ``dtype``."""
    return {k: p.to(dtype) if p.dtype == torch.float32 and ndims[k] >= 2 else p
            for k, p in params.items()}


class _Loss(nn.Module):
    """The model's `loss` as a module call, for `functional_call`."""

    def __init__(self, model: Model):
        super().__init__()
        self.model = model

    def forward(self, batch):
        return self.model.loss(batch)


def _value_and_grad(loss_call: _Loss, cparams: Dict[str, torch.Tensor], batch):
    leaves = {f"model.{k}": p.detach().requires_grad_(True) for k, p in cparams.items()}
    with torch.enable_grad():
        loss, metrics = functional_call(loss_call, leaves, (batch,))
    grads = torch.autograd.grad(loss, list(leaves.values()), materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), dict(zip(cparams, grads))


def make_train_step(model: Model, optimizer: AdamW, *,
                    compute_dtype=torch.bfloat16, n_microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    zero1: Optional[Zero1] = None):
    """``train_step(state, batch) -> (state, metrics)``: metrics are the
    loss's (``ce``, ``aux``), ``loss`` and the optimizer's (``gnorm``,
    ``lr``), all 0-dim tensors on the model's device.  The batch's
    tensors are moved to that device; the state is updated in place
    (`AdamW.update`).  A batch that ``n_microbatches`` does not divide
    raises, as the reference's reshape does.  ``zero1``: the data-parallel
    step over its ranks (module docstring); ``batch`` is the global one."""
    loss_call = _Loss(model)
    ndims = declared_ndims(model.specs())

    def train_step(state: TrainState, batch):
        dev = next(iter(state.params.values())).device
        if zero1 is not None:
            batch = zero1.local_batch(batch)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows % n_microbatches:
            raise ValueError(f"make_train_step: a batch of {rows} rows does not "
                             f"split into {n_microbatches} microbatches")
        cparams = _cast(state.params, compute_dtype, ndims)
        if n_microbatches == 1:
            (loss, metrics), grads = _value_and_grad(loss_call, cparams, batch)
        else:
            size = rows // n_microbatches
            grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in state.params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_microbatches):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                (l, metrics), g = _value_and_grad(loss_call, cparams, mb)
                for k, x in g.items():
                    grads[k].add_(x.float())
                loss = loss + l
                del g
            # Sum in f32 and normalise once, as the reference does.
            grads = {k: x / n_microbatches for k, x in grads.items()}
            loss = loss / n_microbatches
        del cparams
        if zero1 is not None:
            grads = zero1.allreduce_mean(grads)
            loss = zero1.mean(loss)
            metrics = {k: zero1.mean(v) for k, v in metrics.items()}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt, opt_metrics = optimizer.update(
            grads, state.opt, state.params, ndims,
            view=None if zero1 is None else zero1.view)
        if zero1 is not None:
            zero1.gather_into(params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step
