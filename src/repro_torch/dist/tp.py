"""The model axis for serving: its process group and the collectives the
tensor-parallel modules call (GSPMD's work in the reference, which has
no module of its own there: it turns the sharding rules into these).

`ModelAxis` is the model dim of a mesh as seen from one rank: its group,
this rank's index on it and its size.  The collectives are plain
functions on tensors, each over the axis's group:

    all_reduce_sum(x, axis)      the sum over the axis, on every rank
    all_gather(x, dim, axis)     the ranks' tensors joined along ``dim``,
                                 in rank order
    all_to_all(x, axis)          equal splits of dim 0: split ``j`` goes
                                 to rank ``j``, what comes back is joined
                                 in source order (`lax.all_to_all` with
                                 ``split_axis = concat_axis = 0``)

On an axis of size 1 each returns its input unchanged, and no group is
needed.  Each runs synchronously on the group's backend and raises if
the group fails (a timeout, a lost rank, a refused dtype); none retries
and none falls back to another backend or to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import MODEL_AXIS, mesh_shape


@dataclass(frozen=True)
class ModelAxis:
    """The model dim seen from one rank.  ``group`` is None only where no
    collective can run: an axis of size 1, or a plan made without ranks
    (`ModelAxis.plan`), whose collectives raise."""
    group: Optional[Any] = None
    rank: int = 0
    size: int = 1

    @classmethod
    def of(cls, mesh=None) -> "ModelAxis":
        """The axis of ``mesh`` (None: one rank).  A `DeviceMesh` gives its
        ``"model"`` dim's group and this rank's index on it; a mesh of
        shapes alone (`launch.mesh.MeshShape`) with a model axis above 1
        has no ranks to talk to: use `plan`."""
        size = 1 if mesh is None else mesh_shape(mesh).get(MODEL_AXIS, 1)
        if size == 1:
            return cls()
        if not isinstance(mesh, DeviceMesh):
            raise ValueError(f"a model axis of {size} needs a DeviceMesh over the ranks; "
                             f"{mesh!r} has none (ModelAxis.plan builds a shard "
                             "without collectives)")
        return cls(mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS), size)

    @classmethod
    def plan(cls, mesh, rank: int) -> "ModelAxis":
        """Rank ``rank``'s place on ``mesh``'s model axis, with no group:
        enough to build or check that rank's shard, not to run it."""
        size = mesh_shape(mesh).get(MODEL_AXIS, 1)
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} on a model axis of {size}")
        return cls(None, rank, size)

    def _group(self):
        if self.group is None:
            raise RuntimeError(f"a collective over a model axis of {self.size} with no "
                               "process group (a ModelAxis.plan shard cannot run)")
        return self.group


def all_reduce_sum(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum of ``x`` over the axis (in ``x``'s dtype), on every rank."""
    if axis.size == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=axis._group())
    return out


def all_gather(x: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) joined along ``dim`` in rank
    order."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis._group())
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Dim 0 of ``x`` cut into ``axis.size`` equal splits, split ``j`` sent
    to rank ``j``; the splits received, joined in source order."""
    if axis.size == 1:
        return x
    if x.shape[0] % axis.size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split into "
                         f"{axis.size} equal parts")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis._group())
    return out
