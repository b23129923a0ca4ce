from repro_torch.kernels.grouped_gemm.kernel import grouped_matmul, ragged_matmul
from repro_torch.kernels.grouped_gemm.ops import block_groups, grouped_gemm, ragged_gemm
from repro_torch.kernels.grouped_gemm.ref import grouped_gemm_ref, ragged_gemm_ref

__all__ = ["block_groups", "grouped_gemm", "grouped_gemm_ref", "grouped_matmul",
           "ragged_gemm", "ragged_gemm_ref", "ragged_matmul"]
