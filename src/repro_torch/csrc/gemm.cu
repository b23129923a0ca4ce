// Single GEMM kernel: C[M,N] = op(A) . op(B) with f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py:45
// `_matmul_kernel` (launched by `matmul_pallas` with split_k = 1).  That
// kernel walks a (m, n, k) grid with k sequential and carries an f32
// scratch tile across k steps; here each CTA owns one (row tile, 64-column)
// output tile, rows 16 or 64 (kernels/gemm/kernel.py:cta_rows), and runs
// the whole K sweep as a loop.  `ta`/`tb` select the transposed storage
// layouts (A stored (K, M), B stored (N, K)); the output is stored as bf16
// or f32 (OutT, the op's `out_dtype`), rounded once from the f32 sum.
//
// What bounds it on an H100: bytes.  The serving path's `matmul` is a
// decode step, M = 4..16 rows against a weight of 10-356 MB, so the kernel
// streams B once and lives on how many of its bytes are in flight.  The
// grid is the GO tile's, one CTA per output tile: 544 CTAs for Qwen3-14B's
// fused gate+up at batch 8, but 80 for a 5120-wide projection and 16 for a
// KV projection, where one CTA per SM (or fewer) has to keep the memory
// system busy alone.  Two hand-written feeds, chosen per launch by shape
// (kernels/gemm/kernel.py:matmul_feed):
//   - the TMA feed (`tma_matmul_kernel`), for bf16 operands whose bases and
//     row strides are 16-byte multiples, as the TMA unit needs.  One
//     producer lane asks for one box of A and one box of B per 64-deep
//     k-slab into an S-stage ring; each stage completes on a full mbarrier
//     armed with the boxes' bytes, and the consumer warps that read it give
//     it back on an empty mbarrier.  So S - 1 slabs stay in flight whatever
//     the math does, and no thread spends registers or instructions on
//     addresses.  Each operand's tensor map is over its stored layout (A as
//     (M, K), or (K, M) under ta; B as (K, N), or (N, K) under tb): a box
//     whose row is 64 bf16 is 128-byte swizzled, A's box under ta with 16
//     rows 32-byte swizzled, and the consumers read them with ldmatrix
//     (.trans where the stored layout is k-major for B or m-major for A)
//     into mma.sync.m16n8k16 with f32 accumulators; warp w of a consumer
//     group owns the output columns [16w, 16w + 16) and all rows.  The M, N
//     and K edges come from TMA's out-of-bounds zero fill, so nothing is
//     padded.  B, read once, is loaded evict-first and A evict-last.  The
//     ring comes from the launcher (kernels/gemm/kernel.py:matmul_ring): 3
//     stages and one group of four consumer warps when every SM holds two
//     or more CTAs of the grid, whose other CTAs overlap a slab's math with
//     the loads; 8 stages and two groups taking the slabs in turn, as
//     attention's do, when an SM holds one CTA or none (the 16- and 80-CTA
//     grids), where one group alone took longer over a slab's chain of
//     barrier wait, ldmatrix and mma steps than the slab took to arrive.
//     The groups' f32 sums add in the epilogue in group order;
//   - the ring feed (`ring_matmul_kernel`) for everything else (f32
//     operands, a row stride that is not a 16-byte multiple, a base at an
//     odd offset): tile_gemm.cuh's `ring_tile`, the cp.async ring that
//     feeds split-K and grouped, which takes both dtypes, every layout and
//     any alignment.
// Both stage the f32 tile in the drained ring's shared memory and store it
// with masks, cast once.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include <tuple>

#include "tile_gemm.cuh"
#include "tma.cuh"

namespace repro {

// ------------------------------------------------------------ the TMA feed
// The TMA feed's ring: STAGES stages, each one 64-deep k-slab, A's box
// (BM x 64, or 64 x BM under TA) and B's box (64 x 64), 1024-byte aligned
// as the 128-byte swizzle needs; GROUPS groups of four consumer warps take
// the slabs in turn.  After the K loop the ring holds the f32 tile.
template <int STAGES_, int GROUPS_>
struct Ring {
  static constexpr int STAGES = STAGES_, GROUPS = GROUPS_;
};

template <int BM, bool TA, bool TB, typename R>
struct TmaCfg {
  static constexpr int BK = 64;         // k per slab: a 128-byte row of bf16
  static constexpr int STAGES = R::STAGES, GROUPS = R::GROUPS;
  static constexpr int GROUP = 4;       // warps of a consumer group: 16 columns each
  static constexpr int CONSUMERS = GROUP * GROUPS;  // one more warp produces
  static constexpr int THREADS = 32 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * kBN * 2;
  static constexpr int A_SPAN = TA ? BM * 2 : BK * 2;  // A's box row, bytes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int C_LD = kBN + 4;  // f32 epilogue staging
  static constexpr int BAR_OFF = RING;  // full[STAGES], then empty[STAGES]
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;  // + align slack
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "boxes 1 KB aligned");
  static_assert(BM * C_LD * 4 <= RING, "the f32 tile fits in the ring");
  static_assert(SMEM <= 227 * 1024, "an SM's shared memory");
  // Stage s holds slabs s, s + STAGES, ...: with STAGES a multiple of
  // GROUPS they all belong to one group, so a group that waits on a stage
  // has itself released the stage's previous slab, and the full barrier's
  // phase parity cannot alias a phase two behind.
  static_assert(STAGES % GROUPS == 0, "each stage serves one group");
};

template <int BM, bool TA, bool TB, typename R, typename OutT>
__global__ void __launch_bounds__(TmaCfg<BM, TA, TB, R>::THREADS)
    tma_matmul_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      OutT* __restrict__ C, int64_t M, int64_t N, int K) {
  using G = TmaCfg<BM, TA, TB, R>;
  constexpr int STAGES = G::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const unsigned bar0 = smem_u32(smem + G::BAR_OFF);
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int nk = (K + G::BK - 1) / G::BK;
  if (threadIdx.x < STAGES) {
    mbar_init(full(threadIdx.x), 1);                  // the producer's arrive
    mbar_init(empty(threadIdx.x), G::GROUP);          // the group's warps
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == G::CONSUMERS) {  // the producer: one lane issues every box
    if (lane == 0) {
      const uint64_t stream = l2_policy<true>(), keep = l2_policy<false>();
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES, k = kt * G::BK;
        if (kt >= STAGES) mbar_wait(empty(s), (unsigned)((kt / STAGES - 1) & 1));
        unsigned char* As = smem + s * G::STAGE;
        mbar_arrive_tx(full(s), G::STAGE);
        tma_box_2d(As, &amap, TA ? m0 : k, TA ? k : m0, full(s), keep);
        tma_box_2d(As + G::A_BYTES, &bmap, TB ? k : n0, TB ? n0 : k, full(s), stream);
      }
    }
    return;
  }

  // Group grp takes slabs grp, grp + GROUPS, ...; warp wig of the group
  // owns output columns [16 wig, 16 wig + 16).  ldmatrix x4: lane l
  // addresses row l % 8 of 8x8 matrix l / 8.
  const int grp = warp / G::GROUP, wig = warp % G::GROUP;
  const int mi = lane / 8, r8 = lane % 8;
  float acc[BM / 16][2][4] = {};
  for (int kt = grp; kt < nk; kt += G::GROUPS) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (unsigned)((kt / STAGES) & 1));
    const unsigned char* As = smem + s * G::STAGE;
    const unsigned char* Bs = As + G::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      // B fragments of this warp's two 8-column groups: matrices (k 0-7,
      // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
      unsigned b[4];
      const int n = wig * 16 + (mi / 2) * 8;
      if (TB)  // stored (n, k): rows n
        ldsm_x4(b[0], b[1], b[2], b[3],
                Bs + swizzle<128>((n + r8) * 128 + (kk + (mi % 2) * 8) * 2));
      else     // stored (k, n): rows k, transposed
        ldsm_x4_t(b[0], b[1], b[2], b[3],
                  Bs + swizzle<128>((kk + (mi % 2) * 8 + r8) * 128 + n * 2));
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        // A fragment: matrices (m 0-7, k 0-7), (m 8-15, k 0-7),
        // (m 0-7, k 8-15), (m 8-15, k 8-15) of rows i*16 ..
        unsigned a[4];
        const int m = i * 16 + (mi % 2) * 8, k = kk + (mi / 2) * 8;
        if (TA)  // stored (k, m): rows k, transposed
          ldsm_x4_t(a[0], a[1], a[2], a[3],
                    As + swizzle<G::A_SPAN>((k + r8) * G::A_SPAN + m * 2));
        else     // stored (m, k): rows m
          ldsm_x4(a[0], a[1], a[2], a[3],
                  As + swizzle<G::A_SPAN>((m + r8) * G::A_SPAN + k * 2));
        mma_bf16(acc[i][0], a, b[0], b[1]);
        mma_bf16(acc[i][1], a, b[2], b[3]);
      }
    }
    fence_proxy_async();  // the reads above precede the stage's next box
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
  }

  // Every box has landed (each was waited on) and every consumer is past
  // its last read: the ring holds the f32 tile, row stride C_LD, group 0's
  // sums plus group 1's, in that order.
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t = lane % 4;  // mma accumulator coordinates
#pragma unroll
  for (int pass = 0; pass < G::GROUPS; ++pass) {
    consumers_sync<32 * G::CONSUMERS>();
    if (grp != pass) continue;
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* c = reinterpret_cast<float2*>(Cs + (i * 16 + g + 8 * h) * G::C_LD +
                                                wig * 16 + j * 8 + 2 * t);
          const float2 v = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          *c = pass == 0 ? v : make_float2(c->x + v.x, c->y + v.y);
        }
  }
  consumers_sync<32 * G::CONSUMERS>();
  for (int idx = threadIdx.x; idx < BM * kBN; idx += 32 * G::CONSUMERS) {
    const int r = idx / kBN, c = idx % kBN;
    if (m0 + r < M && n0 + c < N)
      C[(m0 + r) * N + n0 + c] = from_f32<OutT>(Cs[r * G::C_LD + c]);
  }
}

// ----------------------------------------------------------- the ring feed
template <typename T, int BM, bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(kThreads)
    ring_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       OutT* __restrict__ C, int64_t M, int64_t N, int64_t K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  Math<T, BM, TA, TB> math;
  math.init();
  ring_tile<T, BM, TA, TB, kRingStages>(smem, math, A, TA ? M : K, B, TB ? K : N,
                                        m0, m_end, n0, N, 0, K);
  math.template finish<OutT>(smem, C, N, m0, m_end, n0, N);
}

// One instantiation of either feed, as a type: its kernel, threads,
// dynamic shared memory, ring stages and the operand bytes a stage brings.
template <int BM, bool TA, bool TB, typename R, typename OutT_>
struct TmaLaunch {
  using G = TmaCfg<BM, TA, TB, R>;
  using OutT = OutT_;
  static constexpr bool kTma = true;
  static constexpr int THREADS = G::THREADS, SMEM = G::SMEM, STAGES = G::STAGES,
                       SLAB = G::STAGE;
  static auto kernel() { return tma_matmul_kernel<BM, TA, TB, R, OutT>; }
};

template <typename T_, int BM, bool TA, bool TB, typename OutT_>
struct RingLaunch {
  using R = RingCfg<T_, BM, TA, TB, kRingStages>;
  using T = T_;
  using OutT = OutT_;
  static constexpr bool kTma = false;
  static constexpr int THREADS = kThreads, SMEM = R::SMEM, STAGES = kRingStages,
                       SLAB = R::SLAB;
  static auto kernel() { return ring_matmul_kernel<T, BM, TA, TB, OutT>; }
};

// The TMA feed's rings, one instantiation each (kernels/gemm/kernel.py:
// TMA_RINGS, matmul_ring): (stages, consumer groups).
using TmaRings = std::tuple<Ring<3, 1>, Ring<8, 2>>;

template <typename F, typename... R>
int by_ring(int stages, int groups, F&& f, std::tuple<R...>*) {
  int r = (int)cudaErrorInvalidValue;
  (void)(((stages == R::STAGES && groups == R::GROUPS) ? (r = f(R{}), true) : false) ||
         ...);
  return r;
}

// Calls f(Launch{}) with the instantiation the runtime codes select: feed
// 0 = the cp.async ring, 1 = TMA boxes (bf16 only, `ring` one of
// TmaRings); cudaErrorInvalidValue for any other choice.
template <typename F>
int with_matmul(int dtype, int out_dtype, int ta, int tb, int cta_m, int feed,
                const int* ring, F&& f) {
  return dispatch_tile(dtype, cta_m, ta, tb, [&](auto t, auto bm, auto ta_, auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(bm)::value;
    constexpr bool TA = decltype(ta_)::value, TB = decltype(tb_)::value;
    auto by_out = [&](auto out) {
      using OutT = typename decltype(out)::type;
      if (feed == 0) return f(RingLaunch<T, BM, TA, TB, OutT>{});
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (feed == 1)
          return by_ring(ring[0], ring[1], [&](auto r) {
            return f(TmaLaunch<BM, TA, TB, decltype(r), OutT>{});
          }, static_cast<TmaRings*>(nullptr));
      }
      return (int)cudaErrorInvalidValue;
    };
    return out_dtype == 0 ? by_out(TypeTag<__nv_bfloat16>{}) : by_out(TypeTag<float>{});
  });
}

// Raises the instantiation's dynamic shared memory limit, once.
template <typename L>
cudaError_t allow_smem() {
  static const cudaError_t e = cudaFuncSetAttribute(
      L::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  return e;
}

}  // namespace repro

// dtype / out_dtype: 0 = bf16, 1 = f32 (the operands' and the output's);
// cta_m: 16 or 64; feed: 0 = the cp.async ring, 1 = TMA boxes into a ring
// of `stages` stages read by `groups` consumer groups (bf16 only; one of
// TmaRings; the ring feed ignores both).  A is (M, K), or (K, M) when ta;
// B is (K, N), or (N, K) when tb; both row-major and dense.  The TMA feed
// encodes both tensor maps here, on every call; if one cannot be encoded
// (a base or row stride not a multiple of 16 bytes), nothing is launched
// and the result is cudaErrorInvalidValue.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_matmul(const void* a, const void* b, void* c, int dtype,
                            int out_dtype, int ta, int tb, int cta_m, int feed,
                            int stages, int groups, long long M, long long N,
                            long long K, void* stream) {
  const int ring[2] = {stages, groups};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((N + repro::kBN - 1) / repro::kBN),
                  (unsigned)((M + cta_m - 1) / cta_m));
  return repro::with_matmul(dtype, out_dtype, ta, tb, cta_m, feed, ring, [&](auto l) {
    using L = decltype(l);
    cudaError_t e = repro::allow_smem<L>();
    if (e != cudaSuccess) return (int)e;
    auto kernel = L::kernel();
    using OutT = typename L::OutT;
    if constexpr (L::kTma) {
      constexpr int box_k = L::G::BK;
      CUtensorMap am, bm;
      if (!repro::tensor_map_2d(&am, a, ta ? K : M, ta ? M : K, ta ? M : K,
                                ta ? box_k : cta_m, ta ? cta_m : box_k) ||
          !repro::tensor_map_2d(&bm, b, tb ? N : K, tb ? K : N, tb ? K : N, box_k,
                                box_k))
        return (int)cudaErrorInvalidValue;
      kernel<<<grid, L::THREADS, L::SMEM, s>>>(am, bm, static_cast<OutT*>(c), M, N,
                                               (int)K);
    } else {
      using T = typename L::T;
      kernel<<<grid, L::THREADS, L::SMEM, s>>>(static_cast<const T*>(a),
                                               static_cast<const T*>(b),
                                               static_cast<OutT*>(c), M, N, K);
    }
    return (int)cudaGetLastError();
  });
}

// What one SM holds of the instantiation the codes select (as for
// repro_matmul): CTAs at once, and one CTA's dynamic shared memory, ring
// stages and the operand bytes a stage brings in.  Returns the
// cudaError_t of the query.
extern "C" int repro_matmul_occupancy(int dtype, int out_dtype, int ta, int tb,
                                      int cta_m, int feed, int stages, int groups,
                                      int* blocks, int* smem_bytes, int* ring_stages,
                                      int* slab_bytes) {
  const int ring[2] = {stages, groups};
  return repro::with_matmul(dtype, out_dtype, ta, tb, cta_m, feed, ring, [&](auto l) {
    using L = decltype(l);
    cudaError_t e = repro::allow_smem<L>();
    if (e != cudaSuccess) return (int)e;
    *smem_bytes = L::SMEM;
    *ring_stages = L::STAGES;
    *slab_bytes = L::SLAB;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, L::kernel(),
                                                              L::THREADS, L::SMEM);
  });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
