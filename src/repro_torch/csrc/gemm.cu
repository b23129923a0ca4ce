// Single GEMM kernel: C[M,N] = op(A) . op(B) with f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:45
// `_matmul_kernel` (launched by `matmul_pallas` with split_k = 1).  That
// kernel walks a (m, n, k) grid with k sequential and carries an f32
// scratch tile across k steps; here each CTA owns one (row tile, 64-column)
// output tile and runs the whole K sweep as a loop (tile_gemm.cuh says
// what bounds it and how the design answers that).  `ta`/`tb` select the
// transposed storage layouts (A stored (K, M), B stored (N, K)).
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ C, int64_t M, int64_t N, int64_t K) {
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  gemm_tile<T, BM, TA, TB>(A, TA ? M : K, B, TB ? K : N, C, N, m0, m_end, n0,
                           N, 0, K);
}

template <typename T, int BM, bool TA, bool TB>
static int launch(const void* a, const void* b, void* c, int64_t M, int64_t N,
                  int64_t K, cudaStream_t stream) {
  dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + BM - 1) / BM));
  matmul_kernel<T, BM, TA, TB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M,
      N, K);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
static int by_layout(int ta, int tb, const void* a, const void* b, void* c,
                     int64_t M, int64_t N, int64_t K, cudaStream_t s) {
  if (ta && tb) return launch<T, BM, true, true>(a, b, c, M, N, K, s);
  if (ta) return launch<T, BM, true, false>(a, b, c, M, N, K, s);
  if (tb) return launch<T, BM, false, true>(a, b, c, M, N, K, s);
  return launch<T, BM, false, false>(a, b, c, M, N, K, s);
}

}  // namespace repro

// dtype: 0 = bf16, 1 = f32; cta_m: 16 or 64.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int dtype,
                            int ta, int tb, int cta_m, long long M, long long N,
                            long long K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return cta_m == 16
               ? repro::by_layout<__nv_bfloat16, 16>(ta, tb, a, b, c, M, N, K, s)
               : repro::by_layout<__nv_bfloat16, 64>(ta, tb, a, b, c, M, N, K, s);
  }
  return cta_m == 16 ? repro::by_layout<float, 16>(ta, tb, a, b, c, M, N, K, s)
                     : repro::by_layout<float, 64>(ta, tb, a, b, c, M, N, K, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
