// Stream-K GEMM: a persistent walk of W workgroups over the MAC iterations
// of the card's own CTA tiles, then a fixup that sums each output tile's
// partials.
//
// stream_k_kernel replaces src/repro/kernels/gemm/kernel.py:215
// `_stream_k_kernel`; fixup_kernel replaces :247 `_stream_k_fixup_kernel`.
//
// The decomposition is the reference's, in the card's units: output tiles
// q = (i, j) are CTA tiles of BM rows (16, 32 or 64, picked from M) and 64
// columns, in row-major order, tm x tn of them, each tk = ceil(K / BK) k
// steps long (BK the CTA's k step, TileCfg::BK), so total = tm * tn * tk
// MAC iterations.  Workgroup g walks iterations [g * ipw, min((g + 1) *
// ipw, total)), ipw = ceil(total / W).  Within its span it resets the
// accumulator at each tile frontier and at the span's start, and stores an
// f32 partial of tile q into slot g - (q * tk) / ipw whenever the tile
// changes and at the span's end.  The fixup sums, per element of tile
// (i, j), the first counts[i, j] slots in slot order, so the result does
// not depend on the order in which CTAs finish; slots past the count were
// never written and are never read.  kernels/gemm/kernel.py:
// stream_k_geometry computes total, ipw, the live W, counts and slots.
//
// What bounds it: bytes (decode-sized M against large weights: the timed
// 32x512x17408 member reads 17.8 MB of weights for 0.57 GFLOP).  So:
//   - W comes from the card, not from the planner: the planner's G (a TPU
//     pipeline-slot budget, at most G_max = 8) becomes W = ceil(G / G_max
//     * SMs * CTAs_per_SM), CTAs_per_SM being this instantiation's
//     occupancy (repro_stream_k_occupancy).  A member planned at G = G_max
//     fills the card; a smaller G takes a proportional share of its SMs.
//   - each CTA streams its span's A and B k-slabs through a ring of
//     kStages shared-memory stages filled by cp.async (copy_tile,
//     cp_async.cuh), so
//     kStages - 1 slabs (3 x 13.5 KB at 32 rows) are in flight while the
//     tensor cores (WMMA, tile_gemm.cuh's Math) work on the oldest.  The
//     ring runs on across tile frontiers: a segment's partial is staged
//     through its own shared-memory region while the next tile's slabs
//     keep arriving.
// M is at most a few dozen rows here, so a 64-row wgmma tile would idle
// most of its rows; WMMA 16x16x16 keeps the product on the tensor cores.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "cp_async.cuh"
#include "tile_gemm.cuh"

namespace repro {

template <typename T, int BM, bool TA, bool TB>
struct WalkCfg {
  using Cfg = TileCfg<T, BM, TA, TB>;
  static constexpr int STAGE = (Cfg::AB_BYTES + 127) / 128 * 128;
  static constexpr int RING = kStages * STAGE;
  static constexpr int C_BYTES = sizeof(T) == 2 ? Cfg::C_BYTES : 0;
  static constexpr int SMEM = RING + C_BYTES;  // dynamic shared memory
};

template <typename T, int BM, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
    stream_k_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    float* __restrict__ P, int64_t M, int64_t N, int64_t K,
                    int64_t tn, int64_t tk, int64_t total, int64_t ipw) {
  using Cfg = TileCfg<T, BM, TA, TB>;
  using W = WalkCfg<T, BM, TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  // Iteration and tile indices in 32 bits (the launcher keeps total below
  // 2^31): the walk divides by tk and tn every iteration.
  const int g = blockIdx.x, tk32 = (int)tk, tn32 = (int)tn, ipw32 = (int)ipw;
  const int it0 = g * ipw32;
  const int n = (it0 + ipw32 < (int)total ? it0 + ipw32 : (int)total) - it0;
  const int64_t lda = TA ? M : K, ldb = TB ? K : N, MN = M * N;

  auto stage_a = [&](int s) { return reinterpret_cast<T*>(smem + s * W::STAGE); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<T*>(smem + s * W::STAGE + Cfg::B_OFF);
  };
  auto load = [&](int s, int it) {  // iteration it's A and B k-slabs
    const int q = it / tk32;
    const int64_t k0 = (int64_t)(it % tk32) * Cfg::BK;
    const int64_t m0 = (int64_t)(q / tn32) * BM, n0 = (int64_t)(q % tn32) * kBN;
    if (TA) copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
        stage_a(s), A, lda, k0, m0, K, M);   // rows k, columns m
    else    copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
        stage_a(s), A, lda, m0, k0, M, K);   // rows m, columns k
    if (TB) copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
        stage_b(s), B, ldb, n0, k0, N, K);   // rows n, columns k
    else    copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
        stage_b(s), B, ldb, k0, n0, K, N);   // rows k, columns n
  };

  Math<T, BM, TA, TB> math;
  math.init();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, it0 + s);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // iteration j's slabs have landed
    __syncthreads();               // ... for every thread; stage j - 1 is free
    if (j + kStages - 1 < n) load((j + kStages - 1) % kStages, it0 + j + kStages - 1);
    cp_async_commit();
    const int s = j % kStages;
    math.step(stage_a(s), stage_b(s));
    const int it = it0 + j;
    if ((it + 1) % tk32 == 0 || j + 1 == n) {  // tile frontier or span end
      const int q = it / tk32;
      const int64_t m0 = (int64_t)(q / tn32) * BM, n0 = (int64_t)(q % tn32) * kBN;
      const int64_t slot = g - ((int64_t)q * tk32) / ipw32;
      math.template finish<float>(smem + W::RING, P + slot * MN, N, m0,
                                  m0 + BM < M ? m0 + BM : M, n0,
                                  n0 + kBN < N ? n0 + kBN : N);
      math.init();
    }
  }
  cp_async_wait<0>();
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

// Calls f(TypeTag<T>, BM, TA, TB) for dtype 0 = bf16 / 1 = f32, cta_m 16,
// 32 or 64 rows and the storage layouts; cudaErrorInvalidValue for another
// cta_m.
template <typename F>
int dispatch_walk(int dtype, int cta_m, int ta, int tb, F&& f) {
  auto by_layout = [&](auto t, auto bm) {
    if (ta && tb) return f(t, bm, std::true_type{}, std::true_type{});
    if (ta) return f(t, bm, std::true_type{}, std::false_type{});
    if (tb) return f(t, bm, std::false_type{}, std::true_type{});
    return f(t, bm, std::false_type{}, std::false_type{});
  };
  auto by_rows = [&](auto t) {
    if (cta_m == 16) return by_layout(t, std::integral_constant<int, 16>{});
    if (cta_m == 32) return by_layout(t, std::integral_constant<int, 32>{});
    if (cta_m == 64) return by_layout(t, std::integral_constant<int, 64>{});
    return (int)cudaErrorInvalidValue;
  };
  return dtype == 0 ? by_rows(TypeTag<__nv_bfloat16>{}) : by_rows(TypeTag<float>{});
}

// The walk kernel of one instantiation with its dynamic shared memory
// allowed: f(kernel pointer, shared bytes, TypeTag<T>) runs the launch or
// the query.
template <typename F>
int with_walk(int dtype, int cta_m, int ta, int tb, F&& f) {
  return dispatch_walk(dtype, cta_m, ta, tb, [&](auto t, auto rows, auto ta_,
                                                  auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(rows)::value;
    constexpr bool TA = decltype(ta_)::value, TB = decltype(tb_)::value;
    constexpr int smem = WalkCfg<T, BM, TA, TB>::SMEM;
    auto kernel = stream_k_kernel<T, BM, TA, TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    return f(kernel, smem, t);
  });
}

}  // namespace repro

// CTAs of the walk kernel that fit on one SM at once (its occupancy) and
// the shared memory of one CTA in bytes, for dtype 0 = bf16 / 1 = f32,
// cta_m 16, 32 or 64 rows.  Returns the cudaError_t of the query.
extern "C" int repro_stream_k_occupancy(int dtype, int ta, int tb, int cta_m,
                                        int* blocks, int* smem_bytes) {
  return repro::with_walk(dtype, cta_m, ta, tb, [&](auto kernel, int smem,
                                                     auto) {
    *smem_bytes = smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro::kThreads, smem);
  });
}

// The walk of `workgroups` live workgroups over tm x tn CTA tiles of cta_m
// x 64 (tn per row of tiles), tk k steps each, ipw iterations per
// workgroup.  P is (slots, M, N) f32.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_stream_k_matmul(const void* a, const void* b, void* p,
                                     int dtype, int ta, int tb, int cta_m,
                                     long long M, long long N, long long K,
                                     long long tn, long long tk, long long total,
                                     long long ipw, long long workgroups,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_walk(dtype, cta_m, ta, tb, [&](auto kernel, int smem,
                                                     auto t) {
    using T = typename decltype(t)::type;
    kernel<<<(unsigned)workgroups, repro::kThreads, smem, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<float*>(p), M, N, K, tn, tk, total, ipw);
    return (int)cudaGetLastError();
  });
}

// C (M, N) in dtype: per element of CTA tile (i, j) of bm x bn, the sum of
// the first counts[i * tn + j] slots of P.
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
