"""Carry the reference's weights into the port: `from_reference` loads a
``Model.init(...)`` tree of the JAX package, handed over as nested dicts
of numpy arrays (no JAX needed here), into a `Model`'s parameters;
`unstacked` maps such a tree onto the port's parameter names (the
training loop's `train_state_from_reference` carries a reference
``TrainState`` across with it).

Both packages keep the same dict keys and (in, out) layouts, so a
weight is a copy, never a transpose; the reference's scanned layer axes
(a leading dim on every leaf of a stack, two on xLSTM's mLSTM leaves: a
stack within each group of a stack) are unstacked into nested
`ModuleList`s.  Every shape is checked, and any leaf left unread (but an
empty stack's) or any parameter left unfilled raises.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.spec import tree_params


def _leaves(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def unstacked(model, tree: dict) -> Dict[str, np.ndarray]:
    """Each parameter of ``model`` (by its name) → its slice of ``tree``
    (the reference's parameter tree as nested dicts of numpy arrays).  A
    parameter at layer ``i`` of a stack reads slice ``i`` of its stacked
    leaf, which must hold exactly that stack's layers."""
    leaves: Dict[Tuple, np.ndarray] = dict(_leaves(tree))
    stacks: Dict[Tuple, set] = {}
    out: Dict[str, np.ndarray] = {}
    for path, spec, _ in tree_params(model, model.specs()):
        key = tuple(k for k in path if not isinstance(k, int))
        index = tuple(k for k in path if isinstance(k, int))
        name = ".".join(map(str, path))
        if key not in leaves:
            raise KeyError(f"from_reference: no leaf {'/'.join(key)} for "
                           f"parameter {name}")
        leaf = leaves[key]
        if leaf.shape[len(index):] != spec.shape:
            raise ValueError(f"from_reference: leaf {'/'.join(key)} has shape "
                             f"{leaf.shape}, parameter {name} "
                             f"wants {spec.shape} under {len(index)} stacked axes")
        out[name] = leaf[index]
        stacks.setdefault(key, set()).add(index)
    for key, leaf in leaves.items():
        seen = stacks.get(key)
        if seen is None and leaf.size == 0:
            continue   # a stack of no layers (xLSTM under 4 layers): nothing to place
        if seen is None:
            raise ValueError(f"from_reference: leaf {'/'.join(key)} "
                             f"{leaf.shape} matches no parameter")
        depth = len(next(iter(seen)))
        if len(seen) != int(np.prod(leaf.shape[:depth], dtype=np.int64)):
            raise ValueError(f"from_reference: leaf {'/'.join(key)} stacks "
                             f"{leaf.shape[:depth]} layers, the model has {len(seen)}")
    return out


@torch.no_grad()
def from_reference(model, tree: dict):
    """Fill every parameter of ``model`` from ``tree`` (`unstacked`);
    returns ``model``."""
    values = unstacked(model, tree)
    params = dict(model.named_parameters())
    unfilled = [n for n in params if n not in values]
    if unfilled:
        raise ValueError(f"from_reference: parameters left unfilled: {unfilled}")
    for name, p in params.items():
        p.copy_(torch.tensor(values[name]))
    return model

