"""GOLDYLOC core of the port: descriptors, cost model, tuner, GO library,
measurement harness, concurrency predictor and controller."""
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
from repro_torch.core.measure import Measurement, Measurer, backend_tag
from repro_torch.core.op_desc import (
    FAMILIES,
    AttentionDesc,
    ScanDesc,
    family_of,
    op_from_key,
)
from repro_torch.core.predictor import (
    CLASSES,
    Predictor,
    accuracy_by_available,
    gemm_features,
    generate_gemm_pool,
    op_features,
    profile_dataset,
    train_predictor,
)
from repro_torch.core.scheduler import (
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
    "GOLibrary", "GemmDesc", "GemmRequest", "GroupPlan", "Measurement",
    "Measurer", "OpRequest", "Predictor", "RC_FRACTIONS", "ScanDesc",
    "Schedule", "TPUSpec", "accuracy_by_available", "backend_tag",
    "bind_operands", "compat_key", "default_library", "execute_schedule",
    "family_of", "gemm_features", "generate_gemm_pool", "group_time",
    "isolated_time", "op_features", "op_from_key", "profile_dataset",
    "requests_from_numpy", "sequential_time", "split_spans",
    "train_predictor", "tune_gemm", "tune_gemm_batch", "tune_op",
]
