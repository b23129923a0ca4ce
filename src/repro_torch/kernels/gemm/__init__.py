from repro_torch.kernels.gemm.kernel import (
    KernelLaunchError,
    card_geometry,
    fixup_runs,
    matmul,
    splitk_matmul,
    stream_k_geometry,
    stream_k_matmul,
    stream_k_workgroups,
    stream_k_workspace,
    walk_geometry,
)
from repro_torch.kernels.gemm.ops import GemmBuffers, TileConfig, gemm, gemm_buffers
from repro_torch.kernels.gemm.ref import (
    gemm_ref,
    gemm_stream_k_ref,
    splitk_partials_ref,
    splitk_reduce_ref,
    stream_k_fixup_ref,
    stream_k_matmul_ref,
    stream_k_partials_ref,
)

__all__ = [
    "GemmBuffers", "KernelLaunchError", "TileConfig", "card_geometry", "fixup_runs", "gemm", "gemm_buffers",
    "gemm_ref", "gemm_stream_k_ref", "matmul", "splitk_matmul", "splitk_partials_ref",
    "splitk_reduce_ref", "stream_k_fixup_ref", "stream_k_geometry", "stream_k_matmul",
    "stream_k_matmul_ref", "stream_k_partials_ref", "stream_k_workgroups",
    "stream_k_workspace", "walk_geometry",
]
