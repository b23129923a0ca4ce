"""ZeRO-1 data parallelism over a mesh's data axes (the reference's
``zero1_pspecs`` on the optimizer state, `repro/launch/train.py:84-90`).

Every rank holds the whole f32 masters (replicated over data, as the
reference's ``params_pspecs`` leave them) and only its share of the
AdamW moments, by `zero1_pspecs`: a leaf whose pspec puts the DP axes on
a dim is cut into equal chunks along it, one per DP coordinate; a leaf
with no such dim is held whole by every rank.  The pspecs are the
reference's, on its stacked leaves, so the DP axes may land on a stack's
layer axis: a rank then owns whole layers (every parameter of those
layers, whole, and nothing of the others); on any other dim it owns the
same slice of every layer's tensor.  A rank owns ``(dim, lo, hi)`` of
each parameter, an empty range for a layer it does not own.

A data-parallel step (`train_loop.make_train_step(zero1=...)`): each
rank takes its rows of the global batch (`local_batch`, by
`batch_pspecs`), computes its gradients, and the mean over ranks is
all-reduced in f32 (`allreduce_mean`), so every rank holds the same full
mean gradient; the gradient norm and any gradient transform run on it
whole; each rank updates its own slice of the masters and moments
(`view`), and the masters are all-gathered (`gather_into`).  Checkpoints
hold the full state: `full` gathers the moments, rank 0 writes, and
`shard` takes a rank's slice of a restored one.

Only the model axis's size 1 is taken: tensor parallelism is ROADMAP
A13b.  With a world of one rank every collective is skipped.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.dist.sharding import DP_AXES, batch_pspecs, entry_axes, zero1_pspecs
from repro_torch.launch.mesh import MODEL_AXIS, mesh_shape
from repro_torch.models.spec import iter_specs
from repro_torch.optim.adamw import AdamWState

# Gradients are all-reduced in f32 buckets of at most this many elements.
BUCKET = 1 << 25


def rank_coords(mesh) -> List[Dict[str, int]]:
    """Each rank's coordinate on ``mesh`` (axis → index), by rank: a
    `DeviceMesh`'s own layout, else row-major."""
    shape = mesh_shape(mesh)
    if isinstance(mesh, DeviceMesh):
        grid = mesh.mesh
        out: List[Dict[str, int]] = [{}] * grid.numel()
        for pos in itertools.product(*(range(n) for n in grid.shape)):
            out[int(grid[pos])] = dict(zip(shape, pos))
        return out
    names, sizes = list(shape), list(shape.values())
    coords = []
    for r in range(math.prod(sizes)):
        c, rest = {}, r
        for name, n in zip(reversed(names), reversed(sizes)):
            c[name], rest = rest % n, rest // n
        coords.append({k: c[k] for k in names})
    return coords


def _chunk(coord: Dict[str, int], axes: Tuple[str, ...], shape: Dict[str, int]):
    """(this coordinate's chunk, the number of chunks) over ``axes``,
    outer axis first."""
    c = 0
    for a in axes:
        c = c * shape[a] + coord[a]
    return c, math.prod(shape[a] for a in axes)


@dataclass
class _Leaf:
    """One reference leaf: its parameters, their stack indices, and the
    dim of the stacked leaf that carries the DP axes (None: replicated)."""
    names: List[str]
    indices: List[Tuple[int, ...]]
    stack: Tuple[int, ...]           # the leaf's stacked sizes
    dim: Optional[int]
    axes: Tuple[str, ...]


class Zero1:
    """The ZeRO-1 plan of ``model`` on ``mesh`` for ``rank`` (this
    process's rank in the group by default) and its collectives, on the
    default group (which the mesh covers) with tensors on ``device``.
    The plan alone (`view`, `shard`, `local_batch`) needs no group."""

    def __init__(self, model, mesh, rank: Optional[int] = None, device="cpu"):
        self.shape = mesh_shape(mesh)
        if self.shape.get(MODEL_AXIS, 1) > 1:
            raise NotImplementedError(
                f"a mesh with {self.shape[MODEL_AXIS]} model shards is tensor parallelism "
                "over the model axis, ROADMAP A13b; ZeRO-1 here runs on the data axes")
        self.mesh = mesh
        self.coords = rank_coords(mesh)
        self.world = len(self.coords)
        self.rank = dist.get_rank() if rank is None else rank
        self.device = torch.device(device)
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        z = zero1_pspecs(model, mesh)
        leaves: Dict[Tuple, _Leaf] = {}
        for path, spec in iter_specs(model.specs()):
            key = tuple(k for k in path if not isinstance(k, int))
            index = tuple(k for k in path if isinstance(k, int))
            name = ".".join(map(str, path))
            self.shapes[name] = spec.shape
            leaf = leaves.get(key)
            if leaf is None:
                pspec = z
                for k in key:
                    pspec = pspec[k]
                dims = [i for i, e in enumerate(pspec)
                        if set(entry_axes(e)) & set(DP_AXES)]
                leaf = leaves[key] = _Leaf([], [], (), dims[0] if dims else None,
                                           entry_axes(pspec[dims[0]]) if dims else ())
            leaf.names.append(name)
            leaf.indices.append(index)
        for leaf in leaves.values():
            depth = len(leaf.indices[0])
            leaf.stack = tuple(max(i[d] for i in leaf.indices) + 1 for d in range(depth))
        self.leaves = list(leaves.values())
        self._leaf_of = {n: (leaf, i) for leaf in self.leaves
                         for n, i in zip(leaf.names, leaf.indices)}

    # ------------------------------------------------------------- plan
    def owned(self, name: str, rank: Optional[int] = None) -> Tuple[int, int, int]:
        """``(dim, lo, hi)``: the rows of parameter ``name`` that ``rank``
        owns (an empty range: none)."""
        leaf, index = self._leaf_of[name]
        shape = self.shapes[name]
        if leaf.dim is None:
            return 0, 0, shape[0]
        c, parts = _chunk(self.coords[self.rank if rank is None else rank], leaf.axes,
                          self.shape)
        if leaf.dim < len(index):            # a stack's axis: whole layers
            n = leaf.stack[leaf.dim]
            lo, hi = c * n // parts, (c + 1) * n // parts
            return (0, 0, shape[0]) if lo <= index[leaf.dim] < hi else (0, 0, 0)
        d = leaf.dim - len(index)
        return d, c * shape[d] // parts, (c + 1) * shape[d] // parts

    def view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of parameter ``name``'s tensor ``t`` (a view)."""
        d, lo, hi = self.owned(name)
        return t.narrow(d, lo, hi - lo)

    def shard(self, full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's slices of a dict of whole tensors, as copies."""
        return {k: self.view(k, t).clone() for k, t in full.items()}

    def local_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global batch by `batch_pspecs` (all of
        them where the DP axes do not divide the batch)."""
        out = {}
        for k, pspec in batch_pspecs(batch, self.mesh).items():
            x = batch[k]
            axes = entry_axes(pspec[0]) if pspec else ()
            if axes:
                c, parts = _chunk(self.coords[self.rank], axes, self.shape)
                n = x.shape[0] // parts
                x = x[c * n:(c + 1) * n]
            out[k] = x
        return out

    # ------------------------------------------------------ collectives
    def _exchange(self, piece: Callable[[str], torch.Tensor],
                  dst: Dict[str, torch.Tensor]) -> None:
        """Every rank's piece of each sharded leaf into ``dst``'s whole
        tensors: per leaf one all-gather of equal-sized flat pieces."""
        for leaf in self.leaves:
            if leaf.dim is None:
                continue
            local = torch.cat([piece(n).reshape(-1) for n in leaf.names])
            bufs = [torch.empty_like(local) for _ in range(self.world)]
            dist.all_gather(bufs, local)
            for r, buf in enumerate(bufs):
                off = 0
                for n in leaf.names:
                    d, lo, hi = self.owned(n, r)
                    v = dst[n].narrow(d, lo, hi - lo)
                    v.copy_(buf[off:off + v.numel()].view(v.shape))
                    off += v.numel()

    def gather_into(self, full: Dict[str, torch.Tensor]) -> None:
        """All-gather, in place, the slices each rank updated of whole
        tensors every rank holds (the masters after a step)."""
        if self.world > 1:
            self._exchange(lambda n: self.view(n, full[n]), full)

    def gather(self, pieces: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors from every rank's slices (the moments)."""
        if self.world == 1:
            return pieces
        full = {k: p if self._leaf_of[k][0].dim is None
                else torch.empty(self.shapes[k], dtype=p.dtype, device=p.device)
                for k, p in pieces.items()}
        self._exchange(lambda n: pieces[n], full)
        return full

    def allreduce_mean(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The mean over ranks of each gradient, summed in f32 buckets and
        returned in each gradient's dtype: the same bits on every rank."""
        if self.world == 1:
            return grads
        out: Dict[str, torch.Tensor] = {}
        names = list(grads)
        while names:
            bucket, n = [], 0
            while names and (not bucket or n + grads[names[0]].numel() <= BUCKET):
                bucket.append(names.pop(0))
                n += grads[bucket[-1]].numel()
            flat = torch.cat([grads[k].reshape(-1).float() for k in bucket])
            dist.all_reduce(flat)
            flat /= self.world
            off = 0
            for k in bucket:
                g = grads[k]
                out[k] = flat[off:off + g.numel()].view(g.shape).to(g.dtype)
                off += g.numel()
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-dim metric's mean over ranks."""
        if self.world == 1:
            return x
        y = x.detach().float().clone()
        dist.all_reduce(y)
        return y / self.world

    def any(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set (every rank gets the answer)."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    @property
    def writer(self) -> bool:
        """Whether this rank writes the checkpoints (rank 0)."""
        return self.rank == 0

    # ---------------------------------------------------------- states
    def full(self, tree: Any) -> Any:
        """``tree`` (a train state or a carry holding one) with each
        `AdamWState`'s moments gathered whole."""
        return _map_opt(lambda s: AdamWState(s.step, self.gather(s.mu), self.gather(s.nu)),
                        tree)

    def shard_state(self, tree: Any) -> Any:
        """``tree`` with each `AdamWState`'s whole moments cut to this
        rank's slices."""
        return _map_opt(lambda s: AdamWState(s.step, self.shard(s.mu), self.shard(s.nu)),
                        tree)


def _map_opt(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, AdamWState):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_opt(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_opt(fn, v) for v in tree)
    return tree
