from repro_torch.kernels.grouped_gemm.kernel import grouped_matmul, ragged_matmul
from repro_torch.kernels.grouped_gemm.ops import (
    GroupedBuffers,
    block_groups,
    grouped_buffers,
    grouped_for_desc,
    grouped_gemm,
    pool_launches,
    ragged_gemm,
)
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref, ragged_gemm_ref

__all__ = ["GroupedBuffers", "block_groups", "grouped_buffers", "grouped_for_desc",
           "grouped_gemm", "grouped_gemm_ref", "grouped_matmul", "pool_launches",
           "ragged_gemm",
           "ragged_gemm_ref", "ragged_matmul"]
