"""Online concurrent-GEMM serving runtime of the port, with tenant SLOs,
admission slicing, EDF and budgeted flushes, its fallback ladder, fault
injection and quarantine, and dependency-aware op graphs."""
from repro_torch.runtime.faults import (
    CircuitBreaker,
    FaultInjector,
    FaultRule,
    InjectedFault,
    LaunchFault,
    LaunchStall,
    NonFiniteOutput,
)
from repro_torch.runtime.graph import (
    FAMILY_SLOTS,
    GraphEdge,
    GraphError,
    GraphNode,
    GraphState,
    OpGraph,
)
from repro_torch.runtime.integration import (
    decode_step_descs,
    decode_step_graph,
    decode_step_op_descs,
    decode_step_requests,
    prewarm_decode,
    submit_decode_graph,
    submit_decode_step,
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
    "decode_step_descs", "decode_step_graph", "decode_step_op_descs",
    "decode_step_requests", "prewarm_decode", "resolve_device",
    "submit_decode_graph", "submit_decode_step",
    "FAMILY_SLOTS", "GraphEdge", "GraphError", "GraphNode", "GraphState",
    "OpGraph",
]
