from repro_torch.kernels.gemm.kernel import (
    matmul,
    splitk_partials,
    splitk_reduce,
    stream_k_fixup,
    stream_k_geometry,
    stream_k_partials,
)
from repro_torch.kernels.gemm.ops import GemmBuffers, TileConfig, gemm, gemm_buffers
from repro_torch.kernels.gemm.ref import (
    gemm_ref,
    gemm_stream_k_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_fixup_ref,
    stream_k_partials_ref,
)

__all__ = [
    "GemmBuffers", "TileConfig", "gemm", "gemm_buffers", "gemm_ref",
    "gemm_stream_k_ref", "matmul", "splitk_partials", "splitk_partials_ref",
    "splitk_reduce", "splitk_reduce_ref", "stream_k_fixup",
    "stream_k_fixup_ref", "stream_k_geometry", "stream_k_partials",
    "stream_k_partials_ref",
]
