// Grouped and ragged GEMM kernels: the concurrent launch of a GO group.
//
// grouped_matmul replaces src/repro/kernels/grouped_gemm/kernel.py:41
// `_grouped_kernel`: G same-shape GEMMs (G,M,K) x (G,K,N) -> (G,M,N).  The
// TPU kernel interleaves members on its (m, n, G, k) grid; here the member
// is the grid's z axis and every (member, row tile, 64-column stripe) is an
// independent CTA, so the members' weight streams run side by side on the
// SMs.
//
// ragged_matmul replaces src/repro/kernels/grouped_gemm/kernel.py:93
// `_ragged_kernel`: A holds the members' rows concatenated, each member
// padded to a multiple of the TileConfig row block bm; B is (G, K, N).
// The TPU kernel scalar-prefetches a block -> group map to pick B[g] in its
// index map; here each CTA reads its own `block_group[i]` entry.  A bm
// block is covered by bm / BM CTAs when bm > BM (BM = the CTA row tile),
// or by one CTA whose rows past bm are masked when bm <= BM.
//
// Both share the CTA tile of tile_gemm.cuh (what bounds them: bytes).
// Plain C interface, loaded with ctypes by kernels/grouped_gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    grouped_kernel(const T* __restrict__ A, const T* __restrict__ B,
                   T* __restrict__ C, int64_t M, int64_t N, int64_t K) {
  const int64_t g = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  gemm_tile<T, BM, false, false>(A + g * M * K, K, B + g * K * N, N,
                                 C + g * M * N, N, m0, m_end, n0, N, 0, K);
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  const int* __restrict__ block_group, T* __restrict__ C,
                  int bm, int sub, int64_t Mtotal, int64_t N, int64_t K) {
  const int64_t i = blockIdx.y / sub;  // bm block of this CTA
  const int64_t r0 = i * bm + (int64_t)(blockIdx.y % sub) * BM;
  const int64_t rows = bm < BM ? bm : BM;
  const int64_t m_end = r0 + rows < Mtotal ? r0 + rows : Mtotal;
  if (m_end <= r0) return;  // uniform across the CTA
  const int64_t g = block_group[i];
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  gemm_tile<T, BM, false, false>(A, K, B + g * K * N, N, C, N, r0, m_end, n0, N,
                                 0, K);
}

template <typename T, int BM>
static int launch_grouped(const void* a, const void* b, void* c, int64_t G,
                          int64_t M, int64_t N, int64_t K, cudaStream_t s) {
  dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)((M + BM - 1) / BM),
            (unsigned)G);
  grouped_kernel<T, BM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c), M,
      N, K);
  return (int)cudaGetLastError();
}

template <typename T, int BM>
static int launch_ragged(const void* a, const void* b, const int* bg, void* c,
                         int bm, int64_t n_blocks, int64_t Mtotal, int64_t N,
                         int64_t K, cudaStream_t s) {
  const int sub = bm > BM ? bm / BM : 1;
  dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)(n_blocks * sub));
  ragged_kernel<T, BM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bg,
      static_cast<T*>(c), bm, sub, Mtotal, N, K);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dtype: 0 = bf16, 1 = f32; cta_m: 16 or 64.  Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int repro_grouped_matmul(const void* a, const void* b, void* c,
                                    int dtype, int cta_m, long long G,
                                    long long M, long long N, long long K,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cta_m == 16
               ? repro::launch_grouped<__nv_bfloat16, 16>(a, b, c, G, M, N, K, s)
               : repro::launch_grouped<__nv_bfloat16, 64>(a, b, c, G, M, N, K, s);
  return cta_m == 16 ? repro::launch_grouped<float, 16>(a, b, c, G, M, N, K, s)
                     : repro::launch_grouped<float, 64>(a, b, c, G, M, N, K, s);
}

extern "C" int repro_ragged_matmul(const void* a, const void* b,
                                   const void* block_group, void* c, int dtype,
                                   int cta_m, int bm, long long n_blocks,
                                   long long Mtotal, long long N, long long K,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bg = static_cast<const int*>(block_group);
  if (dtype == 0)
    return cta_m == 16 ? repro::launch_ragged<__nv_bfloat16, 16>(
                             a, b, bg, c, bm, n_blocks, Mtotal, N, K, s)
                       : repro::launch_ragged<__nv_bfloat16, 64>(
                             a, b, bg, c, bm, n_blocks, Mtotal, N, K, s);
  return cta_m == 16 ? repro::launch_ragged<float, 16>(a, b, bg, c, bm, n_blocks,
                                                       Mtotal, N, K, s)
                     : repro::launch_ragged<float, 64>(a, b, bg, c, bm, n_blocks,
                                                       Mtotal, N, K, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
