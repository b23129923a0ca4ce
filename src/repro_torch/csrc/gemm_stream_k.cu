// Stream-K GEMM: a persistent walk of G spans over the MAC iterations,
// then a fixup that sums each output tile's partials.
//
// stream_k_kernel replaces src/repro/kernels/gemm/kernel.py:215
// `_stream_k_kernel`; fixup_kernel replaces :247 `_stream_k_fixup_kernel`.
//
// The geometry is the reference's, in TileConfig units (bm, bn, bk):
// output tiles q = (i, j) in row-major order, tm x tn of them, each
// tk = ceil(K / bk) k blocks long, so total = tm * tn * tk MAC
// iterations.  Workgroup g walks iterations [g * ipw, min((g + 1) * ipw,
// total)), ipw = ceil(total / G).  Within its span it resets the
// accumulator at each tile frontier and at the span's start, and stores an
// f32 partial of tile q into slot g - (q * tk) / ipw whenever the tile
// changes and at the span's end.  The fixup sums, per element of tile
// (i, j), the first counts[i, j] slots in slot order; slots past the count
// were never written and are never read.  kernels/gemm/kernel.py:
// stream_k_geometry computes total, ipw, the live G, counts and slots.
//
// Mapping: workgroup g is the grid's x index.  A TileConfig tile may be
// wider or taller than one CTA tile (64 columns, 16 or 64 rows), so each
// workgroup is ceil(bn / 64) x ceil(bm / rows) CTAs (grid y and z), and
// every CTA walks the same span over its own sub-block of each tile.
// Every segment of the walk (one tile, a run of its k blocks) is one call
// of tile_gemm.cuh's CTA tile over that K range, stored as f32.
//
// What bounds it: bytes (decode-sized M against large weights).  G is
// the planner's number, a TPU core budget of at most 8, so the walk runs
// G x ceil(bn / 64) x ceil(bm / rows) CTAs, far fewer than the card's 132
// SMs: this first version is right and simple, not fast.  Sizing G from
// the SM count is later work.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    stream_k_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    float* __restrict__ P, int64_t M, int64_t N, int64_t K,
                    int64_t bm, int64_t bn, int64_t bk, int64_t tn, int64_t tk,
                    int64_t total, int64_t ipw) {
  const int64_t g = blockIdx.x;
  const int64_t sub_n = (int64_t)blockIdx.y * kBN;  // CTA offset in the tile
  const int64_t sub_m = (int64_t)blockIdx.z * BM;
  const int64_t MN = M * N;
  const int64_t end = (g + 1) * ipw < total ? (g + 1) * ipw : total;
  for (int64_t i = g * ipw; i < end;) {
    const int64_t q = i / tk;  // output tile of this segment
    const int64_t seg_end = (q + 1) * tk < end ? (q + 1) * tk : end;
    const int64_t k0 = (i - q * tk) * bk;
    const int64_t k_hi = (seg_end - q * tk) * bk;
    const int64_t k1 = k_hi < K ? k_hi : K;
    const int64_t slot = g - (q * tk) / ipw;
    const int64_t tile_m0 = (q / tn) * bm, tile_n0 = (q % tn) * bn;
    const int64_t m0 = tile_m0 + sub_m;
    const int64_t m_hi = tile_m0 + (sub_m + BM < bm ? sub_m + BM : bm);
    const int64_t m_end = m_hi < M ? m_hi : M;
    const int64_t n0 = tile_n0 + sub_n;
    const int64_t n_hi = tile_n0 + bn;
    const int64_t n_end = n_hi < N ? n_hi : N;
    if (m0 < m_end && n0 < n_end)  // uniform across the CTA
      gemm_tile<T, BM, TA, TB, float>(A, TA ? M : K, B, TB ? K : N,
                                      P + slot * MN, N, m0, m_end, n0, n_end,
                                      k0, k1);
    i = seg_end;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(256)
    fixup_kernel(const int* __restrict__ counts, const float* __restrict__ P,
                 OutT* __restrict__ C, int64_t M, int64_t N, int64_t bm,
                 int64_t bn, int64_t tn) {
  const int64_t MN = M * N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < MN;
       e += stride) {
    const int64_t r = e / N, c = e % N;
    const int cnt = counts[(r / bm) * tn + c / bn];
    float acc = 0.f;
    for (int s = 0; s < cnt; ++s) acc += P[s * MN + e];
    C[e] = from_f32<OutT>(acc);
  }
}

}  // namespace repro

// dtype: 0 = bf16, 1 = f32; cta_m: 16 or 64.  P is (slots, M, N) f32.
// Each returns the cudaError_t of its launch (0 on success).
extern "C" int repro_stream_k_matmul(const void* a, const void* b, void* p,
                                     int dtype, int ta, int tb, int cta_m,
                                     long long M, long long N, long long K,
                                     long long bm, long long bn, long long bk,
                                     long long tn, long long tk, long long total,
                                     long long ipw, long long g_live,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::dispatch_tile(dtype, cta_m, ta, tb, [&](auto t, auto rows,
                                                         auto ta_, auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(rows)::value;
    dim3 grid((unsigned)g_live, (unsigned)((bn + repro::kBN - 1) / repro::kBN),
              (unsigned)((bm + BM - 1) / BM));
    repro::stream_k_kernel<T, BM, decltype(ta_)::value, decltype(tb_)::value>
        <<<grid, repro::kThreads, 0, s>>>(
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<float*>(p), M, N, K, bm, bn, bk, tn, tk, total, ipw);
    return (int)cudaGetLastError();
  });
}

// C (M, N) in dtype: per element of tile (i, j), the sum of the first
// counts[i * tn + j] slots of P.
extern "C" int repro_stream_k_fixup(const void* counts, const void* p, void* c,
                                    int dtype, long long M, long long N,
                                    long long bm, long long bn, long long tn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (M * N + 255) / 256;
  const unsigned blocks = (unsigned)(want < 8192 ? (want > 0 ? want : 1) : 8192);
  const int* cnt = static_cast<const int*>(counts);
  const float* P = static_cast<const float*>(p);
  if (dtype == 0)
    repro::fixup_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        cnt, P, static_cast<__nv_bfloat16*>(c), M, N, bm, bn, tn);
  else
    repro::fixup_kernel<float><<<blocks, 256, 0, s>>>(
        cnt, P, static_cast<float*>(c), M, N, bm, bn, tn);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
