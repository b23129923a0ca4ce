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
leaf's (`Spec.ndim`).  A stack is a `Stack`, which keeps its layer's
specs and its axis name, so that `stacked_specs` can give back the
reference's stacked declaration, on which the sharding rules
(`dist/sharding.py`) read the logical axes.
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


class Stack(list):
    """The layers of a stack, one spec dict each, and what the list alone
    would lose: the layer's specs (``layer``, kept for a stack of no
    layers too) and the stack's logical axis name (``axis``), which the
    reference's stacked leaf carries in front of its own axes."""

    def __init__(self, layers, layer, axis: str):
        super().__init__(layers)
        self.layer = layer
        self.axis = axis


def _in_stack(specs, n: int):
    if isinstance(specs, Spec):
        return replace(specs, stack=n, stacked=specs.stacked + 1)
    if isinstance(specs, dict):
        return {k: _in_stack(v, n) for k, v in specs.items()}
    return Stack([_in_stack(v, n) for v in specs], _in_stack(specs.layer, n), specs.axis)


def stack_specs(specs: dict, n: int, axis: str = "layers") -> Stack:
    """``n`` layers of ``specs``: one entry per layer of the stack, each
    spec marked as one layer of ``n`` (`Spec.stack`) under one more
    stacked axis (`Spec.stacked`); ``axis`` is the stacked axis's
    logical name, as the reference's `stack_specs` names it."""
    layer = _in_stack(specs, n)
    return Stack([layer] * n, layer, axis)


def stacked_specs(specs):
    """The reference's declaration of ``specs``: each stack one dict of
    leaves whose shape and axes lead with the stack's size and axis name
    (two of each for xLSTM's mLSTM layers: group, then layer of the
    group), the per-layer fields `Spec.stack` and `Spec.stacked` cleared.
    The sharding rules run on these leaves."""
    if isinstance(specs, Spec):
        return replace(specs, stack=None, stacked=0)
    if isinstance(specs, dict):
        return {k: stacked_specs(v) for k, v in specs.items()}

    def lead(s):
        if isinstance(s, Spec):
            return replace(s, shape=(len(specs), *s.shape), axes=(specs.axis, *s.axes))
        return {k: lead(v) for k, v in s.items()}
    return lead(stacked_specs(specs.layer))


def iter_specs(specs, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Spec]]:
    """``(path, Spec)`` of every leaf, a stack's layers by index."""
    items = (specs.items() if isinstance(specs, dict) else enumerate(specs))
    for k, s in items:
        if isinstance(s, Spec):
            yield prefix + (k,), s
        else:
            yield from iter_specs(s, prefix + (k,))


def param_axes(specs):
    """The logical axes of every leaf of a dict tree of specs (as
    `stacked_specs` gives), in its tree."""
    if isinstance(specs, Spec):
        return specs.axes
    return {k: param_axes(v) for k, v in specs.items()}


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
    masters (`train/train_loop.py`).

    ``tp`` is the model axis (`dist.tp.ModelAxis`) that this module's own
    leaves are cut over on a sharded model (`Model` sets it on each
    module with a cut leaf), None where they are whole: the module's
    function then reduces or gathers over it."""

    tp = None

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
