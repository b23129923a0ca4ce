"""Declarative parameter specs (`repro/models/spec.py`).

Every layer declares a nested dict of ``Spec`` (shape + logical axes +
init).  From one declaration the port derives its modules
(`ParamTree`: each Spec a parameter named by its key, each dict a
submodule, each list a `ModuleList`), their initialisation from a
`torch.Generator`, and parameter counts without allocating anything.

A stack of layers is a list of per-layer spec dicts (`stack_specs`), not
a leading axis: the port runs its layers in a Python loop, one module
each.  `models/convert.py` unstacks the reference's scanned axis into
that list.  Logical axes are kept for the sharding rules to come; the
port does not read them yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

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

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def fan_in(self) -> int:
        """The input width a (…, in, out) weight multiplies: its
        second-to-last dim (an expert axis in front is not summed over);
        a vector's size."""
        return self.shape[-2] if len(self.shape) > 1 else self.size


def stack_specs(specs: dict, n: int) -> list:
    """``n`` layers of ``specs``: one entry per layer of the stack."""
    return [specs] * n


def iter_specs(specs, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Spec]]:
    """``(path, Spec)`` of every leaf, a stack's layers by index."""
    items = (specs.items() if isinstance(specs, dict) else enumerate(specs))
    for k, s in items:
        if isinstance(s, Spec):
            yield prefix + (k,), s
        else:
            yield from iter_specs(s, prefix + (k,))


def param_count(specs) -> int:
    return sum(s.size for _, s in iter_specs(specs))


def init_tensor(t: torch.Tensor, spec: Spec, gen: torch.Generator) -> None:
    """Fill ``t`` in place from ``gen`` as ``spec`` says: zeros, ones, its
    custom init, or (normal) a normal truncated at ±2σ with
    σ = scale / √fan_in.  Random values are drawn in float32 on ``t``'s
    device and cast once."""
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
    do not require grad: the port serves, it does not train yet."""

    def __init__(self, specs: dict, device, dtype: torch.dtype):
        super().__init__()
        build_params(self, specs, device, dtype)


def build_params(module: nn.Module, specs: dict, device, dtype) -> None:
    """Register ``specs`` on ``module`` (see `ParamTree`)."""
    for k, s in specs.items():
        if isinstance(s, Spec):
            module.register_parameter(k, nn.Parameter(
                torch.empty(s.shape, device=device, dtype=dtype),
                requires_grad=False))
        elif isinstance(s, dict):
            module.add_module(k, ParamTree(s, device, dtype))
        else:
            module.add_module(k, nn.ModuleList(
                ParamTree(x, device, dtype) for x in s))


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
