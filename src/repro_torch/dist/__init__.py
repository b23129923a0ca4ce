"""Distribution of the port (`repro/dist`): the data axis, the model axis
for serving, and one device's parts; training on the model axis is
ROADMAP A13c.

- ``sharding``        logical-axis rules → partition specs (TP + ZeRO-1),
                      bitwise the reference's, `DTensor` placements, and
                      the port's model-axis layout (`tp_layouts`)
- ``tp``              the model axis's group and the serving collectives
- ``zero1``           ZeRO-1 data parallelism over torch.distributed
- ``compress``        error-feedback gradient compression (int8 EF)
- ``checkpoint``      atomic train-state save/restore with retention
- ``fault_tolerance`` checkpointing driver: NaN rollback, signal save,
                      restart-resume, ranks acting alike
- ``resources``       mesh → per-shard resource fraction: derates the
                      runtime's slot budget (`Runtime.set_mesh`)

`launch/dryrun.py` and `launch/hlo_cost.py` of the reference lower XLA
HLO and have no torch twin.
"""
from repro_torch.dist import checkpoint, compress, fault_tolerance, sharding, tp, zero1
from repro_torch.dist.compress import compress_grads, ef_init
from repro_torch.dist.fault_tolerance import FaultTolerantDriver, FTConfig
from repro_torch.dist.resources import MeshResources, mesh_resources
from repro_torch.dist.sharding import (
    batch_pspecs,
    cache_pspecs,
    named,
    params_pspecs,
    pspec_for_spec,
    zero1_pspecs,
)
from repro_torch.dist.zero1 import Zero1

__all__ = [
    "checkpoint", "compress", "fault_tolerance", "sharding", "tp", "zero1",
    "compress_grads", "ef_init",
    "FaultTolerantDriver", "FTConfig",
    "MeshResources", "mesh_resources",
    "batch_pspecs", "cache_pspecs", "named", "params_pspecs",
    "pspec_for_spec", "zero1_pspecs",
    "Zero1",
]
