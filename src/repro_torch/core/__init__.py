"""GOLDYLOC core of the port: descriptors, cost model, tuner, GO library
and concurrency controller."""
from repro_torch.core.cost_model import (
    DEFAULT_SPEC,
    EVAL_COUNTER,
    RC_FRACTIONS,
    TPUSpec,
    group_time,
    isolated_time,
    sequential_time,
)
from repro_torch.core.gemm_desc import GemmDesc, split_spans
from repro_torch.core.library import GOLibrary, default_library
from repro_torch.core.op_desc import (
    FAMILIES,
    AttentionDesc,
    ScanDesc,
    family_of,
    op_from_key,
)
from repro_torch.core.scheduler import (
    CLASSES,
    CP_OVERHEAD_S,
    ConcurrencyController,
    GemmRequest,
    GroupPlan,
    OpRequest,
    Schedule,
    bind_operands,
    compat_key,
    execute_schedule,
    requests_from_numpy,
)
from repro_torch.core.tuner import (
    CDS,
    FAMILY_TILES,
    GOEntry,
    tune_gemm,
    tune_gemm_batch,
    tune_op,
)

__all__ = [
    "AttentionDesc", "CDS", "CLASSES", "CP_OVERHEAD_S", "ConcurrencyController",
    "DEFAULT_SPEC", "EVAL_COUNTER", "FAMILIES", "FAMILY_TILES", "GOEntry",
    "GOLibrary", "GemmDesc", "GemmRequest", "GroupPlan", "OpRequest",
    "RC_FRACTIONS", "ScanDesc", "Schedule", "TPUSpec", "bind_operands",
    "compat_key", "default_library", "execute_schedule", "family_of",
    "group_time", "isolated_time", "op_from_key", "requests_from_numpy",
    "sequential_time", "split_spans", "tune_gemm", "tune_gemm_batch",
    "tune_op",
]
