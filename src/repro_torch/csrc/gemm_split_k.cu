// Split-K GEMM: f32 partials of K slices, then a reduce over the slices.
//
// splitk_kernel replaces src/repro/kernels/gemm/kernel.py:65
// `_matmul_splitk_kernel` (grid (split, m, n, k/split), one f32 partial
// block per K slice); reduce_kernel replaces :86 `_reduce_kernel` (the sum
// of the partials over the slice axis, cast to the output dtype).
//
// The TPU kernel needs K padded to a (bk * split) multiple so every slice
// sweeps equally many k tiles.  Here slice s is the K range
// [s * slice_k, min((s + 1) * slice_k, K)) with slice_k =
// ceil(ceil(K / bk) / split) * bk (the reference's padded slice length,
// kernels/gemm/kernel.py:split_k_slices), and the CTA tile masks K past
// the slice's end and past K, so nothing is padded.  A slice that lies
// wholly past K still stores zeros: its partial enters the sum.
//
// What bounds it: bytes.  Split-K exists for skinny decode GEMMs whose
// (row, column) grid is too small to fill the card; each of the split K
// slices is its own set of CTAs (grid z), so a 1 x 5120 x 17408 ffn-down
// at split 8 runs 80 x 8 = 640 CTAs instead of 80, each streaming its
// slice of the weights once.  The partials cost 4 * split * M * N bytes
// written and read again, small beside the weights at decode M.  The CTA
// tile is tile_gemm.cuh's, storing f32.  The reduce is one elementwise
// pass that sums the slices in slot order.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    splitk_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  float* __restrict__ P, int64_t M, int64_t N, int64_t K,
                  int64_t slice_k) {
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  const int64_t s = blockIdx.z;
  const int64_t k0 = s * slice_k;
  const int64_t k1 = k0 + slice_k < K ? k0 + slice_k : K;  // may be <= k0
  gemm_tile<T, BM, TA, TB, float>(A, TA ? M : K, B, TB ? K : N, P + s * M * N, N,
                                  m0, m_end, n0, N, k0, k1);
}

template <typename OutT>
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ P, OutT* __restrict__ C, int split,
                  int64_t MN) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < split; ++s) acc += P[s * MN + i];
    C[i] = from_f32<OutT>(acc);
  }
}

}  // namespace repro

// dtype: 0 = bf16, 1 = f32; cta_m: 16 or 64.  P is (split, M, N) f32.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int repro_splitk_matmul(const void* a, const void* b, void* p,
                                   int dtype, int ta, int tb, int cta_m,
                                   long long M, long long N, long long K,
                                   int split, long long slice_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::dispatch_tile(dtype, cta_m, ta, tb, [&](auto t, auto bm, auto ta_,
                                                         auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(bm)::value;
    dim3 grid((unsigned)((N + repro::kBN - 1) / repro::kBN),
              (unsigned)((M + BM - 1) / BM), (unsigned)split);
    repro::splitk_kernel<T, BM, decltype(ta_)::value, decltype(tb_)::value>
        <<<grid, repro::kThreads, 0, s>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b),
                                          static_cast<float*>(p), M, N, K, slice_k);
    return (int)cudaGetLastError();
  });
}

// C (M, N) in dtype = sum over s of P[s] in slot order.
extern "C" int repro_splitk_reduce(const void* p, void* c, int dtype, int split,
                                   long long MN, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (MN + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? (want > 0 ? want : 1) : 8192);
  const float* P = static_cast<const float*>(p);
  if (dtype == 0)
    repro::reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        P, static_cast<__nv_bfloat16*>(c), split, MN);
  else
    repro::reduce_kernel<float><<<blocks, 256, 0, s>>>(P, static_cast<float*>(c),
                                                       split, MN);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
