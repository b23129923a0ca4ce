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
from repro_torch.core.op_desc import family_of
from repro_torch.core.scheduler import (
    CLASSES,
    CP_OVERHEAD_S,
    ConcurrencyController,
    GemmRequest,
    GroupPlan,
    Schedule,
    compat_key,
    execute_schedule,
    requests_from_numpy,
)
from repro_torch.core.tuner import CDS, GOEntry, tune_gemm, tune_gemm_batch

__all__ = [
    "CDS", "CLASSES", "CP_OVERHEAD_S", "ConcurrencyController", "DEFAULT_SPEC",
    "EVAL_COUNTER", "GOEntry", "GOLibrary", "GemmDesc", "GemmRequest",
    "GroupPlan", "RC_FRACTIONS", "Schedule", "TPUSpec", "compat_key",
    "default_library", "execute_schedule", "family_of", "group_time",
    "isolated_time", "requests_from_numpy",
    "sequential_time", "split_spans", "tune_gemm", "tune_gemm_batch",
]
