// Single GEMM kernel: C[M,N] = op(A) . op(B) with f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:45
// `_matmul_kernel` (launched by `matmul_pallas` with split_k = 1).  That
// kernel walks a (m, n, k) grid with k sequential and carries an f32
// scratch tile across k steps; here each CTA owns one (row tile, 64-column)
// output tile and runs the whole K sweep as a loop (tile_gemm.cuh says
// what bounds it and how the design answers that).  `ta`/`tb` select the
// transposed storage layouts (A stored (K, M), B stored (N, K)); the
// output is stored as bf16 or f32 (OutT, the op's `out_dtype`), rounded
// once from the f32 sum.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM, bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  OutT* __restrict__ C, int64_t M, int64_t N, int64_t K) {
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  gemm_tile<T, BM, TA, TB, OutT>(A, TA ? M : K, B, TB ? K : N, C, N, m0, m_end,
                                 n0, N, 0, K);
}

}  // namespace repro

// dtype / out_dtype: 0 = bf16, 1 = f32 (the operands' and the output's);
// cta_m: 16 or 64.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int dtype,
                            int out_dtype, int ta, int tb, int cta_m,
                            long long M, long long N, long long K,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::dispatch_tile(dtype, cta_m, ta, tb, [&](auto t, auto bm, auto ta_,
                                                         auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(bm)::value;
    constexpr bool TA = decltype(ta_)::value, TB = decltype(tb_)::value;
    dim3 grid((unsigned)((N + repro::kBN - 1) / repro::kBN),
              (unsigned)((M + BM - 1) / BM));
    auto run = [&](auto* out) {
      using OutT = typename std::remove_pointer<decltype(out)>::type;
      repro::matmul_kernel<T, BM, TA, TB, OutT><<<grid, repro::kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(b), out, M, N, K);
      return (int)cudaGetLastError();
    };
    return out_dtype == 0 ? run(static_cast<__nv_bfloat16*>(c))
                          : run(static_cast<float*>(c));
  });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
