"""Mesh → available resources (`repro/dist/resources.py`).

GOLDYLOC sizes CD_exec from the resources globally available.  Under
tensor parallelism every device co-hosts one shard of each of the
``model``-axis GEMMs, so the budget a concurrent group can claim, and
the number of concurrency slots worth filling, is the device's divided
by the model-parallel degree.  `mesh_resources` derives that once from a
mesh: the spec through `TPUSpec.scaled(frac)` and ``slot_budget =
max(1, max_cd // model_shards)``, the cap the runtime passes as
``available``.  Data-parallel axes do not derate: replicas run on
disjoint devices.  Pure arithmetic over the mesh's axis names and sizes
(`launch.mesh.mesh_shape`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.cost_model import DEFAULT_SPEC, TPUSpec
from repro_torch.launch.mesh import MODEL_AXIS, mesh_shape


@dataclass(frozen=True)
class MeshResources:
    mesh_shape: Dict[str, int]
    model_shards: int      # co-resident model-parallel degree per device
    frac: float            # per-shard resource fraction (1 / model_shards)
    spec: TPUSpec          # the device's spec scaled to that fraction
    slot_budget: int       # derated concurrency slots (the available cap)


def shard_fraction(mesh) -> float:
    """Per-shard fraction of one device's contendable resources."""
    return 1.0 / max(mesh_shape(mesh).get(MODEL_AXIS, 1), 1)


def mesh_resources(mesh, spec: TPUSpec = DEFAULT_SPEC, max_cd: int = 16) -> MeshResources:
    frac = shard_fraction(mesh)
    model = round(1.0 / frac)
    return MeshResources(mesh_shape=mesh_shape(mesh), model_shards=model, frac=frac,
                         spec=spec.scaled(frac), slot_budget=max(1, max_cd // model))
