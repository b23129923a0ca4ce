// Shared CTA-level GEMM tile for the port's GEMM kernels (gemm.cu,
// grouped_gemm.cu, gemm_split_k.cu, gemm_stream_k.cu):
// C[m0:m_end, n0:n0+64] = op(A)[:, k0:k1] . op(B)[k0:k1, :], f32
// accumulation, output cast once (or kept as an f32 tile).
//
// What bounds it on an H100: bytes.  The serving path's GEMMs are decode
// steps (M = 4..16 rows per member) against weights of 10-356 MB, far
// below the ~295 bf16 operations per byte at which the tensor cores and
// not HBM become the limit.  So the design streams every weight element
// from device memory exactly once per CTA row tile and keeps many bytes
// in flight:
//   - one CTA owns a 64-column stripe of the output and the (few) rows of
//     its row tile; the K sweep (the TPU kernel's sequential k grid axis)
//     is a loop inside the CTA;
//   - the K loops that run on this file's tile: `ring_tile` streams the A
//     and B k-slabs through a ring of shared-memory stages filled by
//     cp.async (cp_async.cuh), so all but one stage are in flight while
//     the math works on the oldest (`kRingStages` says how deep, and why);
//     B, read once, is loaded evict-first and A evict-last.  The split-K
//     and grouped kernels run it, and so does `matmul`'s ring feed.  The
//     Stream-K and ragged walks, whose rings run on across tiles, keep
//     their own loops on its slab loader (`load_slabs`).  `matmul`'s
//     other feed, for aligned bf16 operands, is a TMA ring with its own
//     mma.sync tile (gemm.cu, tma.cuh);
//   - BK is 128 for the 16-row bf16 tile (16 KB of weights per slab), else
//     64;
//   - the ragged edges of M, N and K are masked at load (zero fill) and at
//     store, so callers never pad operands.
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (f32
// accumulators); f32 runs as plain FMA, one output column and BM/2 rows
// per thread.
//
// CTA tile rule (see kernels/gemm/kernel.py:cta_rows): a TileConfig row
// block bm <= 16 maps to a 16-row CTA tile, any larger bm to a 64-row
// tile; bn and bk are TPU VMEM tilings and do not carry over: every CTA
// is 64 columns wide, and BK is 128 (bf16, 16 rows) or 64 (otherwise).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"

namespace repro {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBN = 64;        // CTA tile width (output columns)

// f32 accumulator -> stored element (bf16 by round-to-nearest-even).
template <typename OutT>
__device__ __forceinline__ OutT from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int BM, bool TA, bool TB>
struct TileCfg {
  static constexpr int BK = (sizeof(T) == 2 && BM == 16) ? 128 : 64;
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  // Tiles sit in shared memory in their stored orientation: A is (BM, BK)
  // or, transposed, (BK, BM); B is (BK, BN) or (BN, BK).  Each row is
  // padded by one 16-byte chunk, which keeps rows 16-byte aligned and
  // skews rows across banks.
  static constexpr int A_R = TA ? BK : BM, A_C = TA ? BM : BK;
  static constexpr int B_R = TB ? kBN : BK, B_C = TB ? BK : kBN;
  static constexpr int A_LD = A_C + VEC, B_LD = B_C + VEC;
  static constexpr int A_BYTES = A_R * A_LD * (int)sizeof(T);
  static constexpr int B_OFF = (A_BYTES + 127) / 128 * 128;
  static constexpr int AB_BYTES = B_OFF + B_R * B_LD * (int)sizeof(T);
  static constexpr int C_LD = kBN + 4;  // f32 epilogue staging (bf16 path)
  static constexpr int C_BYTES = BM * C_LD * 4;
  static_assert(BM % 16 == 0, "CTA rows are a multiple of 16");
};

template <typename T, int BM, bool TA, bool TB>
struct Math;

// bf16: warp w owns output columns [16w, 16w + 16) of the CTA tile and all
// BM rows, as BM/16 WMMA accumulators.
template <int BM, bool TA, bool TB>
struct Math<__nv_bfloat16, BM, TA, TB> {
  using T = __nv_bfloat16;
  using Cfg = TileCfg<T, BM, TA, TB>;
  using LA = typename std::conditional<TA, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  using LB = typename std::conditional<TB, nvcuda::wmma::col_major,
                                       nvcuda::wmma::row_major>::type;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[BM / 16];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) nvcuda::wmma::fill_fragment(acc[i], 0.f);
  }

  __device__ __forceinline__ void step(const T* As, const T* Bs) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < Cfg::BK; kk += 16) {
      nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, LB> bf;
      nvcuda::wmma::load_matrix_sync(
          bf, TB ? Bs + (w * 16) * Cfg::B_LD + kk : Bs + kk * Cfg::B_LD + w * 16,
          Cfg::B_LD);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, LA> af;
        nvcuda::wmma::load_matrix_sync(
            af, TA ? As + kk * Cfg::A_LD + i * 16 : As + (i * 16) * Cfg::A_LD + kk,
            Cfg::A_LD);
        nvcuda::wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
  }

  // The f32 accumulator tile into shared memory, row-major with the row
  // stride Cfg::C_LD.
  __device__ __forceinline__ void stage(float* Cs) const {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
      nvcuda::wmma::store_matrix_sync(Cs + (i * 16) * Cfg::C_LD + w * 16, acc[i],
                                      Cfg::C_LD, nvcuda::wmma::mem_row_major);
  }

  template <typename OutT>
  __device__ __forceinline__ void finish(unsigned char* smem, OutT* C,
                                         int64_t ldc, int64_t m0, int64_t m_end,
                                         int64_t n0, int64_t n_end) {
    const int w = threadIdx.x / 32;
    float* Cs = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp is done reading the last A/B tiles
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
      nvcuda::wmma::store_matrix_sync(Cs + (i * 16) * Cfg::C_LD + w * 16, acc[i],
                                      Cfg::C_LD, nvcuda::wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      if (m0 + r < m_end && n0 + c < n_end)
        C[(m0 + r) * ldc + n0 + c] = from_f32<OutT>(Cs[r * Cfg::C_LD + c]);
    }
  }
};

// f32: thread t owns output column t % 64 and rows [(t / 64) * BM/2, +BM/2).
template <int BM, bool TA, bool TB>
struct Math<float, BM, TA, TB> {
  using Cfg = TileCfg<float, BM, TA, TB>;
  static constexpr int RPT = BM * kBN / kThreads;
  float acc[RPT];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
    const int c = threadIdx.x % kBN, r0 = (threadIdx.x / kBN) * RPT;
#pragma unroll 4
    for (int k = 0; k < Cfg::BK; ++k) {
      const float b = TB ? Bs[c * Cfg::B_LD + k] : Bs[k * Cfg::B_LD + c];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float a = TA ? As[k * Cfg::A_LD + r0 + j] : As[(r0 + j) * Cfg::A_LD + k];
        acc[j] = fmaf(a, b, acc[j]);
      }
    }
  }

  __device__ __forceinline__ void stage(float* Cs) const {
    const int c = threadIdx.x % kBN, r0 = (threadIdx.x / kBN) * RPT;
#pragma unroll
    for (int j = 0; j < RPT; ++j) Cs[(r0 + j) * Cfg::C_LD + c] = acc[j];
  }

  template <typename OutT>
  __device__ __forceinline__ void finish(unsigned char*, OutT* C, int64_t ldc,
                                         int64_t m0, int64_t m_end, int64_t n0,
                                         int64_t n_end) {
    const int c = threadIdx.x % kBN, r0 = (threadIdx.x / kBN) * RPT;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      if (m0 + r0 + j < m_end && n0 + c < n_end)
        C[(m0 + r0 + j) * ldc + n0 + c] = from_f32<OutT>(acc[j]);
  }
};

// ------------------------------------------------------ the cp.async ring
// The ring depth of the split-K and grouped kernels and of `matmul`'s ring
// feed (gemm.cu): two stages, one k-slab in flight per CTA while the math
// works on the other.  What decides it is
// HBM, not latency: at the decode shapes the grids are a few hundred CTAs
// (grouped G4 and split-K s4 at 5120 x 17408: 320; s8: 640), three of them
// per SM (registers cap the 16-row bf16 tile at three, whatever the depth),
// so two stages already keep 6-7 MB in flight across the card.  Measured on an
// H100 SXM at 700 W (PERF.md section 6): three stages ran 4-9% slower than
// two for grouped and split-K s4 and 1.5% faster for s8; four stages leave
// room for only two CTAs per SM, and G4's 320 CTAs then take two waves of
// 264 slots (1.4x slower); more CTAs per SM (smaller k steps, or registers
// capped) were slower still.
constexpr int kRingStages = 2;

// A ring of STAGES stages, each one A and one B k-slab (128-byte
// aligned), whose bytes, once the K loop has drained, hold the epilogue's
// f32 tile (SMEM, the dynamic shared memory of a CTA that runs it).
template <typename T, int BM, bool TA, bool TB, int STAGES>
struct RingCfg {
  using Cfg = TileCfg<T, BM, TA, TB>;
  static constexpr int ROWS = BM;
  static constexpr int STAGE = (Cfg::AB_BYTES + 127) / 128 * 128;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING > Cfg::C_BYTES ? RING : Cfg::C_BYTES;
  // Operand bytes one stage brings in (the slabs without row padding).
  static constexpr int SLAB =
      (Cfg::A_R * Cfg::A_C + Cfg::B_R * Cfg::B_C) * (int)sizeof(T);
};

// One stage's A and B k-slabs at k by cp.async: A's rows [m0, m_end)
// (columns, when TA) and B's columns [n0, n_end) over k steps [k, k + BK)
// masked at k1 (zero fill past every edge).  B, read once, carries the
// L2 policy `stream` (evict-first); A, read again by every stripe's CTAs,
// `keep` (evict-last).
template <typename T, int BM, bool TA, bool TB>
__device__ __forceinline__ void load_slabs(T* As, T* Bs, const T* __restrict__ A,
                                           int64_t lda, const T* __restrict__ B,
                                           int64_t ldb, int64_t m0, int64_t m_end,
                                           int64_t n0, int64_t n_end, int64_t k,
                                           int64_t k1, uint64_t keep,
                                           uint64_t stream) {
  using Cfg = TileCfg<T, BM, TA, TB>;
  if (TA) copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
      As, A, lda, k, m0, k1, m_end, keep);     // rows k, columns m
  else    copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
      As, A, lda, m0, k, m_end, k1, keep);     // rows m, columns k
  if (TB) copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
      Bs, B, ldb, n0, k, n_end, k1, stream);   // rows n, columns k
  else    copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
      Bs, B, ldb, k, n0, k1, n_end, stream);   // rows k, columns n
}

// One output tile's K sweep [k0, k1) through a STAGES-deep cp.async ring
// in `smem` (RingCfg::RING bytes, 128-byte aligned): STAGES - 1 k-slabs
// in flight while `math` works on the oldest.  A is stored (rows, K)
// with leading dimension lda, or (K, rows) when TA; B is stored (K, N)
// or, when TB, (N, K), with leading dimension ldb; elements at or past
// m_end, n_end or k1 read as zero.
// It adds to math's f32 accumulator and leaves the epilogue to the
// caller; on return every copy has landed and every thread is done with
// the ring, so the caller may reuse its bytes.  An empty range (k1 <= k0)
// adds nothing.
template <typename T, int BM, bool TA, bool TB, int STAGES>
__device__ __forceinline__ void ring_tile(unsigned char* smem,
                                          Math<T, BM, TA, TB>& math,
                                          const T* __restrict__ A, int64_t lda,
                                          const T* __restrict__ B, int64_t ldb,
                                          int64_t m0, int64_t m_end, int64_t n0,
                                          int64_t n_end, int64_t k0, int64_t k1) {
  using Cfg = TileCfg<T, BM, TA, TB>;
  using R = RingCfg<T, BM, TA, TB, STAGES>;
  static_assert(STAGES >= 2, "a ring of one stage keeps nothing in flight");
  const uint64_t stream = l2_policy<true>(), keep = l2_policy<false>();
  auto as = [&](int s) { return reinterpret_cast<T*>(smem + s * R::STAGE); };
  auto bs = [&](int s) {
    return reinterpret_cast<T*>(smem + s * R::STAGE + Cfg::B_OFF);
  };
  auto load = [&](int s, int kt) {  // k step kt into stage s
    load_slabs<T, BM, TA, TB>(as(s), bs(s), A, lda, B, ldb, m0, m_end, n0, n_end,
                              k0 + (int64_t)kt * Cfg::BK, k1, keep, stream);
  };
  const int nk = k1 > k0 ? (int)((k1 - k0 + Cfg::BK - 1) / Cfg::BK) : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  int use = 0, fill = STAGES - 1;  // the stage computed on, the stage refilled
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // k step kt's slabs have landed
    __syncthreads();              // ... for every thread; step kt - 1's stage is free
    if (kt + STAGES - 1 < nk) load(fill, kt + STAGES - 1);
    cp_async_commit();
    math.step(as(use), bs(use));
    use = use + 1 == STAGES ? 0 : use + 1;
    fill = fill + 1 == STAGES ? 0 : fill + 1;
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Calls f(TypeTag<T>, BM, TA, TB) with the compile-time instance that the
// runtime codes select: dtype 0 = bf16, 1 = f32; cta_m 16 or 64 rows;
// ta/tb the storage layouts.  BM, TA and TB arrive as std::integral_constant.
template <typename T>
struct TypeTag {
  using type = T;
};

template <typename F>
int dispatch_tile(int dtype, int cta_m, int ta, int tb, F&& f) {
  auto by_layout = [&](auto t, auto bm) {
    if (ta && tb) return f(t, bm, std::true_type{}, std::true_type{});
    if (ta) return f(t, bm, std::true_type{}, std::false_type{});
    if (tb) return f(t, bm, std::false_type{}, std::true_type{});
    return f(t, bm, std::false_type{}, std::false_type{});
  };
  auto by_rows = [&](auto t) {
    return cta_m == 16 ? by_layout(t, std::integral_constant<int, 16>{})
                       : by_layout(t, std::integral_constant<int, 64>{});
  };
  return dtype == 0 ? by_rows(TypeTag<__nv_bfloat16>{}) : by_rows(TypeTag<float>{});
}

}  // namespace repro
