"""Atomic train-state checkpoints (`repro/dist/checkpoint.py`).

Layout: one directory per step under the checkpoint root —

    <dir>/step_00000042/arrays.npz     # leaves, flattened in tree order
    <dir>/step_00000042/meta.json      # step + leaf count

A state is a tree of dicts, tuples (NamedTuples included) and lists
whose leaves are tensors or arrays; its leaves go in tree order (a
dict's in its insertion order).  Writes go to a ``.tmp-*`` sibling,
published by one ``os.replace``, so a crash mid-write never leaves a
readable-looking partial checkpoint; a partial one of the same step left
by an earlier crash is removed by the next save of that step.
`restore` unflattens into the caller's tree, each tensor leaf placed on
``like``'s device in its dtype.  ``keep`` prunes old steps after every
save.  `save_async` copies the state to host memory first, then writes
on a daemon thread: the caller may update its tensors in place at once.
A ZeRO-1 run's checkpoint is its full state, as one process's: rank 0
writes it after the moments are gathered, and every rank restores the
whole of it and keeps its slice (`fault_tolerance.py`, `zero1.py`);
`restore` places each array on its ``like`` leaf's device and dtype
whatever that leaf's shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

STEP_PREFIX = "step_"


def _step_dir(path: Path, step: int) -> Path:
    return path / f"{STEP_PREFIX}{step:08d}"


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in tree order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, its structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _host_copy(x) -> np.ndarray:
    if torch.is_tensor(x) and x.device.type != "cpu":
        return x.detach().cpu().numpy()        # .cpu() made a new copy
    return _host(x).copy()


def to_host(state: Any) -> Any:
    """``state`` with every leaf a host numpy array (a copy of a tensor)."""
    return tree_map(_host_copy, state)


def save(path, state: Any, step: int, keep: Optional[int] = None) -> Path:
    """Write ``state`` atomically as ``step``; prune to ``keep`` newest."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    final = _step_dir(path, step)
    for stale in path.glob(f".tmp-{final.name}-*"):
        shutil.rmtree(stale)
    tmp = path / f".tmp-{final.name}-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir()
    leaves = [_host(x) for x in tree_leaves(state)]
    np.savez(tmp / "arrays.npz", **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    (tmp / "meta.json").write_text(json.dumps({"step": step, "n_leaves": len(leaves)}))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep is not None:
        for old in all_steps(path)[:-keep]:
            shutil.rmtree(_step_dir(path, old), ignore_errors=True)
    return final


def save_async(path, state: Any, step: int,
               keep: Optional[int] = None) -> threading.Thread:
    """Copy to host NOW, write in the background; join() to block."""
    host = to_host(state)
    t = threading.Thread(target=save, args=(path, host, step), kwargs={"keep": keep},
                         daemon=True, name=f"ckpt-save-{step}")
    t.start()
    return t


def all_steps(path) -> list:
    path = Path(path)
    if not path.is_dir():
        return []
    return sorted(int(p.name[len(STEP_PREFIX):]) for p in path.iterdir()
                  if p.is_dir() and p.name.startswith(STEP_PREFIX)
                  and p.name[len(STEP_PREFIX):].isdigit())


def latest_step(path) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def place(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s leaf: a tensor on its device in its dtype
    (sharing ``arr``'s memory on the CPU), else the array itself."""
    if torch.is_tensor(ref):
        return torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
    return arr


def restore(path, like: Any, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load ``step`` (default latest) into the structure of ``like``: each
    tensor leaf on its ``like`` leaf's device, in its dtype; any other
    leaf a numpy array."""
    path = Path(path)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = _step_dir(path, step)
    meta = json.loads((d / "meta.json").read_text())
    like_leaves = tree_leaves(like)
    if meta["n_leaves"] != len(like_leaves):
        raise ValueError(f"checkpoint {d.name} has {meta['n_leaves']} leaves, "
                         f"restore target has {len(like_leaves)}")
    with np.load(d / "arrays.npz") as z:
        loaded = iter([place(z[f"leaf_{i}"], r) for i, r in enumerate(like_leaves)])
    return tree_map(lambda _: next(loaded), like), int(meta["step"])
