from repro_torch.kernels.mamba_scan.kernel import (
    chunk_grid,
    chunk_workspace,
    decode_grid,
    mamba_scan_fwd,
    scan_route,
)
from repro_torch.kernels.mamba_scan.ops import (
    mamba_chunk_scan,
    scan_buffers,
    scan_desc_buffers,
    scan_for_desc,
    ssd_scan,
)
from repro_torch.kernels.mamba_scan.ref import (
    mamba_chunk_ref,
    ssd_carry_ref,
    ssd_chunk_outputs_ref,
    ssd_chunk_ref,
    ssd_chunk_states_ref,
    ssd_decomposed_ref,
    ssd_scan_seq_ref,
)

__all__ = ["chunk_grid", "chunk_workspace", "decode_grid", "mamba_chunk_ref",
           "mamba_chunk_scan", "mamba_scan_fwd", "scan_buffers", "scan_desc_buffers",
           "scan_for_desc", "scan_route", "ssd_carry_ref", "ssd_chunk_outputs_ref", "ssd_chunk_ref",
           "ssd_chunk_states_ref", "ssd_decomposed_ref", "ssd_scan", "ssd_scan_seq_ref"]
