"""Declarative parameter specs (`repro/models/spec.py`).

Every layer declares a nested dict of ``Spec`` (shape + logical axes +
init).  From one declaration the port derives its modules
(`ParamTree`: each Spec a parameter named by its key, each dict a
submodule, each list a `ModuleList`), their initialisation from a
`torch.Generator`, and parameter counts without allocating anything.

A stack of layers is a list of per-layer spec dicts (`stack_specs`), not
a leading axis: the port runs its layers in a Python loop, one module
each.  `models/convert.py` unstacks the reference's scanned axis into
that list.  Each per-layer `Spec` of a stack carries the outermost
stack's size (``stack``) and its count of stacked axes (``stacked``: 2
for xLSTM's mLSTM layers, a stack within each group of a stack), so
that its random init keeps the reference's rule, which reads shape[0]
of the stacked leaf (`Spec.fan_in`), and its dims are the declared
leaf's (`Spec.ndim`).  Logical axes are
kept for the sharding rules to come; the port does not read them yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones | custom
    scale: float = 1.0
    # custom(generator, shape, device) -> float32 tensor
    custom: Optional[Callable[..., torch.Tensor]] = None
    # layers of the outermost `stack_specs` stack this spec is in, if any
    stack: Optional[int] = None
    # stacked axes the reference declares in front of ``shape``
    stacked: int = 0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def fan_in(self) -> int:
        """The reference's fan of this leaf (`repro/models/spec.py:55`):
        shape[0] of the leaf as the reference declares it, or its size
        for a vector.  A layer of a stack is declared there with the
        stack's axis in front (the outer stack's, for a stack within a
        stack), so its fan is that stack's size; an unstacked expert
        tensor's is E; an unstacked matrix's its first dim (a weight's
        input width, the token table's vocabulary)."""
        if self.stack is not None:
            return self.stack
        return self.shape[0] if len(self.shape) > 1 else self.size

    @property
    def ndim(self) -> int:
        """Dims of this leaf as the reference declares it: a layer of a
        stack has each stack's axis in front.  The reference's training
        step casts and weight-decays a leaf by this count
        (`repro/train/train_loop.py:34`, `repro/optim/adamw.py:78`), so a
        per-layer vector of a stack is a matrix there."""
        return len(self.shape) + self.stacked


def _in_stack(specs, n: int):
    if isinstance(specs, Spec):
        return replace(specs, stack=n, stacked=specs.stacked + 1)
    if isinstance(specs, dict):
        return {k: _in_stack(v, n) for k, v in specs.items()}
    return [_in_stack(v, n) for v in specs]


def stack_specs(specs: dict, n: int) -> list:
    """``n`` layers of ``specs``: one entry per layer of the stack, each
    spec marked as one layer of ``n`` (`Spec.stack`) under one more
    stacked axis (`Spec.stacked`)."""
    return [_in_stack(specs, n)] * n


def iter_specs(specs, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Spec]]:
    """``(path, Spec)`` of every leaf, a stack's layers by index."""
    items = (specs.items() if isinstance(specs, dict) else enumerate(specs))
    for k, s in items:
        if isinstance(s, Spec):
            yield prefix + (k,), s
        else:
            yield from iter_specs(s, prefix + (k,))


def declared_ndims(specs) -> Dict[str, int]:
    """`Spec.ndim` of every leaf by its parameter name (path joined by
    dots, as `nn.Module.named_parameters` names it)."""
    return {".".join(map(str, path)): s.ndim for path, s in iter_specs(specs)}


def param_count(specs) -> int:
    return sum(s.size for _, s in iter_specs(specs))


def init_tensor(t: torch.Tensor, spec: Spec, gen: torch.Generator) -> None:
    """Fill ``t`` in place from ``gen`` as ``spec`` says: zeros, ones, its
    custom init, or (normal) a normal truncated at ±2σ with
    σ = scale / √max(fan_in, 1), the reference's rule (`Spec.fan_in`).
    Random values are drawn in float32 on ``t``'s device and cast once."""
    if spec.init == "zeros":
        t.zero_()
    elif spec.init == "ones":
        t.fill_(1.0)
    elif spec.init == "custom":
        t.copy_(spec.custom(gen, spec.shape, t.device))
    elif spec.init == "normal":
        std = spec.scale / math.sqrt(max(spec.fan_in, 1))
        src = t if t.dtype == torch.float32 else torch.empty(
            spec.shape, dtype=torch.float32, device=t.device)
        nn.init.trunc_normal_(src, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=gen)
        if src is not t:
            t.copy_(src)
    else:
        raise ValueError(spec.init)


class ParamTree(nn.Module):
    """A dict of specs as a module: each `Spec` a parameter named by its
    key (shape and layout as declared: weights are (in, out), applied as
    ``x @ W``), each dict a `ParamTree`, each list a `ModuleList` of
    them.  Parameters are allocated empty (`init_params` fills them) and
    require grad only when asked: serving leaves them frozen, and the
    training step differentiates with respect to its own cast of the
    masters (`train/train_loop.py`)."""

    def __init__(self, specs: dict, device, dtype: torch.dtype,
                 requires_grad: bool = False):
        super().__init__()
        build_params(self, specs, device, dtype, requires_grad)


def build_params(module: nn.Module, specs: dict, device, dtype,
                 requires_grad: bool = False) -> None:
    """Register ``specs`` on ``module`` (see `ParamTree`)."""
    for k, s in specs.items():
        if isinstance(s, Spec):
            module.register_parameter(k, nn.Parameter(
                torch.empty(s.shape, device=device, dtype=dtype),
                requires_grad=requires_grad))
        elif isinstance(s, dict):
            module.add_module(k, ParamTree(s, device, dtype, requires_grad))
        else:
            module.add_module(k, nn.ModuleList(
                ParamTree(x, device, dtype, requires_grad) for x in s))


def tree_params(module: nn.Module, specs) -> Iterator[Tuple[Tuple, Spec, torch.Tensor]]:
    """``(path, Spec, parameter)`` of every leaf of ``specs`` on
    ``module``, in declaration order."""
    for path, spec in iter_specs(specs):
        node = module
        for k in path:
            node = node[k] if isinstance(k, int) else getattr(node, k)
        yield path, spec, node


@torch.no_grad()
def init_params(module: nn.Module, specs, gen: torch.Generator) -> None:
    """Initialise every parameter of ``specs`` on ``module`` from ``gen``
    (a generator on the parameters' device), in declaration order."""
    for _, spec, p in tree_params(module, specs):
        init_tensor(p, spec, gen)
