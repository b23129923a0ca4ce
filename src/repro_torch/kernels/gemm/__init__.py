from repro_torch.kernels.gemm.kernel import matmul
from repro_torch.kernels.gemm.ops import TileConfig, gemm
from repro_torch.kernels.gemm.ref import gemm_ref

__all__ = ["TileConfig", "gemm", "gemm_ref", "matmul"]
