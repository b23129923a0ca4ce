"""Online concurrent-GEMM serving runtime of the port, with tenant SLOs,
admission slicing, EDF and budgeted flushes, and its fallback ladder,
fault injection and quarantine."""
from repro_torch.runtime.faults import (
    CircuitBreaker,
    FaultInjector,
    FaultRule,
    InjectedFault,
    LaunchFault,
    LaunchStall,
    NonFiniteOutput,
)
from repro_torch.runtime.integration import (
    decode_step_descs,
    decode_step_op_descs,
    decode_step_requests,
    prewarm_decode,
)
from repro_torch.runtime.runtime import (
    DEFAULT_SLO,
    MIXED_CLASS,
    Launch,
    Runtime,
    RuntimeConfig,
    TenantSLO,
    Ticket,
    resolve_device,
)
from repro_torch.runtime.telemetry import GroupRecord, Telemetry

__all__ = [
    "DEFAULT_SLO", "MIXED_CLASS", "CircuitBreaker", "FaultInjector",
    "FaultRule", "GroupRecord", "InjectedFault", "Launch", "LaunchFault",
    "LaunchStall", "NonFiniteOutput", "Runtime", "RuntimeConfig", "Telemetry",
    "TenantSLO", "Ticket",
    "decode_step_descs", "decode_step_op_descs", "decode_step_requests",
    "prewarm_decode", "resolve_device",
]
