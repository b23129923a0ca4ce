"""Online concurrent-GEMM serving runtime of the port."""
from repro_torch.runtime.integration import (
    decode_step_descs,
    decode_step_op_descs,
    decode_step_requests,
    prewarm_decode,
)
from repro_torch.runtime.runtime import (
    MIXED_CLASS,
    Launch,
    NonFiniteOutput,
    Runtime,
    RuntimeConfig,
    Ticket,
    resolve_device,
)
from repro_torch.runtime.telemetry import GroupRecord, Telemetry

__all__ = [
    "MIXED_CLASS", "GroupRecord", "Launch", "NonFiniteOutput", "Runtime",
    "RuntimeConfig", "Telemetry", "Ticket", "decode_step_descs",
    "decode_step_op_descs", "decode_step_requests",
    "prewarm_decode", "resolve_device",
]
