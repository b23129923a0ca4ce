"""Meshes (`repro/launch/mesh.py`, and `make_mesh_from_devices` of
`repro/launch/train.py:40-51`) on `torch.distributed`.

A mesh is a `DeviceMesh` over the process group's ranks, one rank per
device, with dims named ``("data", "model")`` (``("pod", "data",
"model")`` for the multi-pod production mesh).  The ranks must exist
first: `init_ranks` (or ``with Ranks(device)``) joins torchrun's group,
a group given by its address, or makes a group of this process alone.
Meshes run on CUDA (NCCL) unless the caller asks for the CPU (gloo) or
names the backend: ranks that share one card (NCCL refuses two ranks on
one device) join over gloo, ``init_ranks(backend="gloo")``, and
`init_ranks` raises where NCCL would seat two ranks on one card.

The sharding rules and the resource derating read a mesh only through
its axis names and sizes (`mesh_shape`), so they take a `DeviceMesh`,
a `MeshShape` (a mesh's shape alone, for planning a mesh this process
is not part of) or any object with ``axis_names`` and a ``shape`` dict,
as the reference's tests pass (`tests/test_dist_sched.py:FakeMesh`).
"""
from __future__ import annotations

import math
import os
import socket
import tempfile
from datetime import timedelta
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import resolve_device

MODEL_AXIS = "model"


class MeshShape:
    """A mesh's axis names and sizes, without devices: ``MeshShape(data=1,
    model=4)``."""

    def __init__(self, **shape: int):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}

    def __repr__(self) -> str:
        return f"MeshShape({', '.join(f'{k}={v}' for k, v in self.shape.items())})"


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size, in the mesh's axis order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def init_ranks(device="cuda", timeout: Optional[timedelta] = None, *,
               backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: int = 1, rank: int = 0) -> torch.device:
    """Join the process group (once per process) and return this rank's
    device.  ``backend``: NCCL for CUDA and gloo for the CPU unless
    named.  The group is torchrun's (its env rendezvous) under torchrun,
    else the one at ``init_method`` (``tcp://localhost:<port>``) as
    ``rank`` of ``world_size``, else this process alone.  A CUDA rank
    takes the card of its rank on the node (modulo the cards there); two
    ranks seated on one card under NCCL raise, naming the cause, and no
    other backend is taken in its place.  CUDA asked for and missing
    raises (`resolve_device`)."""
    device = torch.device(device)
    if device.type == "cuda":
        resolve_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = {} if timeout is None else {"timeout": timeout}
        if dist.is_torchelastic_launched():
            dist.init_process_group(backend, init_method="env://", **kw)
        elif init_method is not None:
            dist.init_process_group(backend, init_method=init_method,
                                    world_size=world_size, rank=rank, **kw)
        else:
            fd, store = tempfile.mkstemp(prefix="repro_torch_rank0_")
            os.close(fd)
            os.unlink(store)
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    world_size=1, rank=0, **kw)
    if device.type == "cuda":
        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if "nccl" in str(dist.get_backend()) and dist.get_world_size() > 1:
            _one_rank_per_card(device)
    return device


def shared_card(seats) -> Optional[tuple]:
    """The first two ranks whose seats ((host, card index) by rank) are
    the same, and that seat; None when every rank has a card of its own."""
    first: Dict[tuple, int] = {}
    for r, seat in enumerate(seats):
        seat = tuple(seat)
        if seat in first:
            return first[seat], r, seat
        first[seat] = r
    return None


def _one_rank_per_card(device: torch.device) -> None:
    """Raise if NCCL would seat two ranks of the group on one card (it
    refuses them at the first collective: "Duplicate GPU detected").
    The seats are exchanged over a gloo group of their own."""
    check = dist.new_group(backend="gloo")
    seats = [None] * dist.get_world_size()
    dist.all_gather_object(seats, (socket.gethostname(), device.index), group=check)
    dist.destroy_process_group(check)
    clash = shared_card(seats)
    if clash is not None:
        a, b, (host, index) = clash
        raise RuntimeError(
            f"ranks {a} and {b} would share cuda:{index} of {host} under NCCL, which "
            "refuses two ranks on one card; give each rank its own card, or join the "
            "ranks with init_ranks(backend='gloo')")


class Ranks:
    """``with Ranks(device) as device:`` joins the group (`init_ranks`) and,
    if it was this block that joined it, leaves it at the block's end."""

    def __init__(self, device="cuda", timeout: Optional[timedelta] = None):
        self.device, self.timeout, self.joined = device, timeout, False

    def __enter__(self) -> torch.device:
        self.joined = not dist.is_initialized()
        return init_ranks(self.device, self.timeout)

    def __exit__(self, *exc) -> bool:
        if self.joined and dist.is_initialized():
            dist.destroy_process_group()
        return False


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device="cuda") -> DeviceMesh:
    """A `DeviceMesh` of ``shape`` over every rank of the group, which
    must hold exactly ``prod(shape)`` ranks: no mesh is quietly made
    smaller or larger than asked."""
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, and this process is in "
                           "no process group: run it under torchrun, or call init_ranks")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=names)


def make_debug_mesh(data: int = 1, model: int = 1, *, device="cuda") -> DeviceMesh:
    """A ``data × model`` mesh over the group's ranks."""
    return make_mesh((data, model), ("data", MODEL_AXIS), device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> DeviceMesh:
    """The reference's production mesh: 16 × 16, or 2 × 16 × 16 with a
    leading pure-data ``pod`` axis."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", MODEL_AXIS), device)
    return make_mesh((16, 16), ("data", MODEL_AXIS), device)


def make_mesh_from_devices(device="cuda") -> DeviceMesh:
    """The reference's mesh from what there is, counted in ranks: the
    largest model axis of 16, 8, 4, 2 or 1 that divides them, the rest on
    data."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = next(m for m in (16, 8, 4, 2, 1) if n % m == 0 and m <= n)
    return make_debug_mesh(n // model, model, device=device)
