// Grouped and ragged GEMM kernels: the concurrent launch of a GO group.
//
// Both take the members' weights as a table of per-member B pointers
// (`Members`), passed by value as a __grid_constant__ kernel parameter:
// the C wrapper fills it from the caller's arrays, so there is no
// device-side table to allocate, copy host-to-device or keep alive, and
// nothing synchronises per launch.  Each member's B is read where it lies,
// in its stored orientation: (K, N) row-major, or (N, K) row-major when TB
// (a transposed weight), with its own leading dimension.  One launch has
// one orientation.  The table holds kMaxMembers (16, the largest
// concurrency class) members; the launchers run a larger group as
// consecutive launches over chunks of members.
//
// grouped_matmul replaces src/repro/kernels/grouped_gemm/kernel.py:41
// `_grouped_kernel`: G same-shape GEMMs (G,M,K) x B[g] -> (G,M,N).  The
// TPU kernel interleaves members on its (m, n, G, k) grid; here the member
// is the grid's z axis and every (member, row tile, 64-column stripe) is an
// independent CTA, so the members' weight streams run side by side on the
// SMs.  Each CTA sweeps all of K through tile_gemm.cuh's cp.async ring
// (`ring_tile`, kRingStages stages, B evict-first, A evict-last).  Three
// CTAs fit on an SM, so at G4 8 x 5120 x 17408 the 320 CTAs run in one
// wave of 396 slots (tile_gemm.cuh says why the ring is not deeper).
//
// ragged_matmul replaces src/repro/kernels/grouped_gemm/kernel.py:93
// `_ragged_kernel`: A (Mtotal, K) holds the members' rows concatenated;
// row block i = rows [i*bm, (i+1)*bm) multiplies the B of the first
// member whose row end lies past the block's first row, clamped to the
// last member (the reference's block -> group map, including zero-size
// members and rows past the last end).  The TPU kernel scalar-prefetches
// that map; here each CTA finds its member in the table's row ends.
//
// What bounds both: bytes.  A decode group streams one weight per member
// (ffn-down: 178 MB each) against a few rows of activations.  The ragged
// kernel's first design ran one CTA per (16-row block, 64-column stripe),
// each sweeping all of K: at 5 blocks x 80 stripes that is 400 CTAs, four
// more than 132 SMs hold at 3 each, so (as its time suggested: 1.7x
// grouped_matmul's for 1.25x the bytes) four CTAs ran a second wave alone.
// Its design now is a persistent walk sized from the card, not the shape:
//   - W = SMs x CTAs_per_SM workgroups (the occupancy of this
//     instantiation, repro_ragged_occupancy) deal the tile-major
//     iterations (row tile, 64-column stripe, k step) into equal
//     contiguous spans, as the Stream-K walk does, so every SM carries
//     the same bytes whatever the shape;
//   - each CTA streams its span's A and B k-slabs through a kStages
//     cp.async ring (tile_gemm.cuh's `load_slabs`), so kStages - 1 slabs
//     (3 x 22 KB at 16 rows) are in flight per CTA while the tensor cores
//     (WMMA, tile_gemm.cuh's Math) work on the oldest.  The ring runs on
//     across tile frontiers, so the walk keeps its own loop: `ring_tile`
//     drains its ring at the end of every tile;
//   - B, read once, is loaded with an L2 evict-first policy and A with
//     evict-last: every stripe's CTAs read the same A slabs, at times
//     spread over the whole walk, and B streaming through L2 would
//     otherwise push them out between reads;
//   - a tile that lies wholly in one span is stored directly; a tile cut
//     by span boundaries is summed by the last of its contributors to
//     arrive: each stores its f32 partial, then counts itself in on the
//     tile's counter; the last sums the partials in workgroup order (a
//     fixed order for a given geometry, whichever CTA finishes first)
//     and stores the tile.  Partials live per workgroup (two slots: the
//     tile its span starts in, the tile it ends in) and counters per
//     first contributor, so both are O(W), allocated (the counters
//     zeroed) by the launcher before each launch.
//
// Plain C interface, loaded with ctypes by kernels/grouped_gemm/kernel.py.
#include "cp_async.cuh"
#include "tile_gemm.cuh"

namespace repro {

constexpr int kMaxMembers = 16;  // members per launch (max(CLASSES))

// The members of one launch, passed by value as a kernel parameter.
struct Members {
  const void* b[kMaxMembers];        // member g's B
  long long ldb[kMaxMembers];        // its leading dimension
  long long row_end[kMaxMembers];    // ragged: member g's end row in A
  int count;
};

template <typename T, int BM, bool TB>
using GroupedRing = RingCfg<T, BM, false, TB, kRingStages>;

template <typename T, int BM, bool TB, typename OutT>
__global__ void __launch_bounds__(kThreads)
    grouped_kernel(const T* __restrict__ A, OutT* __restrict__ C, int64_t M,
                   int64_t N, int64_t K, const __grid_constant__ Members mem) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t g = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  Math<T, BM, false, TB> math;
  math.init();
  ring_tile<T, BM, false, TB, kRingStages>(
      smem, math, A + g * M * K, K, static_cast<const T*>(mem.b[g]), mem.ldb[g],
      m0, m_end, n0, N, 0, K);
  math.template finish<OutT>(smem, C + g * M * N, N, m0, m_end, n0, N);
}

template <typename T, int BM, bool TB>
struct RaggedCfg {
  using Cfg = TileCfg<T, BM, false, TB>;
  static constexpr int STAGE = RingCfg<T, BM, false, TB, kStages>::STAGE;
  static constexpr int RING = kStages * STAGE;
  static constexpr int SMEM = RING + Cfg::C_BYTES;  // + the f32 tile
  static constexpr int TILE = BM * kBN;             // floats of a partial
};

// The walk over tiles q = (row tile, 64-column stripe), tn stripes per
// row tile, in row-major order; row tile i is rows [row_lo + i * rows,
// + rows) cut at row_hi, rows = min(bm, BM) (row_lo is a multiple of bm).
// Each tile is tk k steps, total iterations in all; workgroup g walks
// [g * ipw, min((g + 1) * ipw, total)).  P holds (workgroups, 2, BM * 64)
// f32 partials; counters (workgroups) int32 are zero before the launch.
template <typename T, int BM, bool TB, typename OutT>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ A, OutT* __restrict__ C,
                  float* __restrict__ P, int* __restrict__ counters, int64_t N,
                  int64_t K, int64_t bm, int64_t row_lo, int64_t row_hi,
                  int tn, int tk, int total, int ipw,
                  const __grid_constant__ Members mem) {
  using Cfg = TileCfg<T, BM, false, TB>;
  using R = RaggedCfg<T, BM, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int completes;  // this CTA is the tile's last contributor
  float* Cs = reinterpret_cast<float*>(smem + R::RING);
  // Iteration and tile indices in 32 bits (the launcher keeps the
  // iteration count below 2^31): the walk divides by tk and tn at every
  // tile.
  const int g = blockIdx.x;
  const int it0 = g * ipw;
  const int n = (it0 + ipw < total ? it0 + ipw : total) - it0;
  const int64_t rows = bm < BM ? bm : BM;

  struct Step {
    int q, k;  // tile and k step
  };
  auto step_of = [&](int j) {  // this CTA's j-th iteration
    const int it = it0 + j;
    return Step{it / tk, it % tk};
  };
  struct Tile {
    int64_t r0, r_end, n0, ldb;
    const T* B;
  };
  auto tile_of = [&](int q) {  // rows, columns and member of tile q
    Tile t;
    t.r0 = row_lo + (int64_t)(q / tn) * rows;
    t.r_end = t.r0 + rows < row_hi ? t.r0 + rows : row_hi;
    t.n0 = (int64_t)(q % tn) * kBN;
    const int64_t block_row = t.r0 / bm * bm;  // the bm block's first row
    int j = 0;
    while (j + 1 < mem.count && mem.row_end[j] <= block_row) ++j;
    t.B = static_cast<const T*>(mem.b[j]);
    t.ldb = mem.ldb[j];
    return t;
  };

  auto stage_a = [&](int s) { return reinterpret_cast<T*>(smem + s * R::STAGE); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<T*>(smem + s * R::STAGE + Cfg::B_OFF);
  };
  // The step after `st`, iteration j's: a division only at a tile's end.
  auto next = [&](Step st, int j) { return ++st.k < tk ? st : step_of(j); };
  // B is read once; A's slabs are read again by every stripe's CTAs, at
  // times spread over the whole walk.
  const uint64_t stream = l2_policy<true>(), keep = l2_policy<false>();
  Tile lt{};
  Step ls{-1, tk - 1};  // the step of the slabs loaded last
  auto load = [&](int s, int j) {  // iteration j's A and B k-slabs
    const Step st = j == 0 ? step_of(0) : next(ls, j);
    if (st.q != ls.q) lt = tile_of(st.q);
    ls = st;
    load_slabs<T, BM, false, TB>(stage_a(s), stage_b(s), A, K, lt.B, lt.ldb,
                                 lt.r0, lt.r_end, lt.n0, N,
                                 (int64_t)st.k * Cfg::BK, K, keep, stream);
  };

  Math<T, BM, false, TB> math;
  math.init();
  Step cs{-1, tk - 1};  // the step of the iteration computed last
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, s);
    cp_async_commit();
  }
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // iteration j's slabs have landed
    __syncthreads();               // ... for every thread; stage j - 1 is free
    if (j + kStages - 1 < n) load((j + kStages - 1) % kStages, j + kStages - 1);
    cp_async_commit();
    const int s = j % kStages;
    math.step(stage_a(s), stage_b(s));
    cs = j == 0 ? step_of(0) : next(cs, j);
    const Step st = cs;
    if (st.k != tk - 1 && j + 1 != n) continue;
    // Tile frontier or span end: the span's share of tile q is complete.
    // (The last reads of Cs by an earlier epilogue precede this
    // iteration's __syncthreads.)
    const int q = st.q;
    const Tile t = tile_of(q);
    const int first = (int)((int64_t)q * tk / ipw);
    const int last = (int)(((int64_t)q * tk + tk - 1) / ipw);
    math.stage(Cs);
    __syncthreads();
    math.init();
    if (first == last) {  // the whole tile lies in this span
      for (int idx = threadIdx.x; idx < R::TILE; idx += kThreads) {
        const int r = idx / kBN, c = idx % kBN;
        if (t.r0 + r < t.r_end && t.n0 + c < N)
          C[(t.r0 + r) * N + t.n0 + c] = from_f32<OutT>(Cs[r * Cfg::C_LD + c]);
      }
      continue;
    }
    // Slot 0: the tile a span starts in; slot 1: the tile it ends in.
    auto partial = [&](int w) {
      const int slot = (int64_t)w * ipw >= (int64_t)q * tk ? 0 : 1;
      return P + ((int64_t)w * 2 + slot) * R::TILE;
    };
    float* mine = partial(g);
    for (int idx = threadIdx.x; idx < R::TILE; idx += kThreads)
      mine[idx] = Cs[(idx / kBN) * Cfg::C_LD + idx % kBN];
    __threadfence();  // the partial is visible before the count
    __syncthreads();
    if (threadIdx.x == 0)
      completes = atomicAdd(counters + first, 1) == last - first;
    __syncthreads();
    if (!completes) continue;
    __threadfence();
    for (int idx = threadIdx.x; idx < R::TILE; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      float acc = 0.f;
      for (int w = first; w <= last; ++w)  // workgroup order
        acc += w == g ? Cs[r * Cfg::C_LD + c] : __ldcg(partial(w) + idx);
      if (t.r0 + r < t.r_end && t.n0 + c < N)
        C[(t.r0 + r) * N + t.n0 + c] = from_f32<OutT>(acc);
    }
  }
  cp_async_wait<0>();
}

// Calls f(TypeTag<T>, TypeTag<OutT>, BM, TB) for dtype / out_dtype 0 =
// bf16, 1 = f32, cta_m 16 or 64 rows and B's orientation.
template <typename F>
int dispatch_members(int dtype, int out_dtype, int cta_m, int tb, F&& f) {
  auto by_tb = [&](auto t, auto o, auto bm) {
    return tb ? f(t, o, bm, std::true_type{}) : f(t, o, bm, std::false_type{});
  };
  auto by_rows = [&](auto t, auto o) {
    return cta_m == 16 ? by_tb(t, o, std::integral_constant<int, 16>{})
                       : by_tb(t, o, std::integral_constant<int, 64>{});
  };
  auto by_out = [&](auto t) {
    return out_dtype == 0 ? by_rows(t, TypeTag<__nv_bfloat16>{})
                          : by_rows(t, TypeTag<float>{});
  };
  return dtype == 0 ? by_out(TypeTag<__nv_bfloat16>{}) : by_out(TypeTag<float>{});
}

// The ragged kernel of one instantiation with its dynamic shared memory
// allowed: f(kernel pointer, shared bytes, TypeTag<T>, TypeTag<OutT>).
template <typename F>
int with_ragged(int dtype, int out_dtype, int cta_m, int tb, F&& f) {
  return dispatch_members(dtype, out_dtype, cta_m, tb, [&](auto t, auto o,
                                                           auto bm, auto tb_) {
    using T = typename decltype(t)::type;
    using OutT = typename decltype(o)::type;
    constexpr int BM = decltype(bm)::value;
    constexpr bool TB = decltype(tb_)::value;
    constexpr int smem = RaggedCfg<T, BM, TB>::SMEM;
    auto kernel = ragged_kernel<T, BM, TB, OutT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    return f(kernel, smem, t, o);
  });
}

// The grouped kernel of one instantiation with its dynamic shared memory
// allowed: f(kernel pointer, GroupedRing<...>{}, TypeTag<T>,
// TypeTag<OutT>).
template <typename F>
int with_grouped(int dtype, int out_dtype, int cta_m, int tb, F&& f) {
  return dispatch_members(dtype, out_dtype, cta_m, tb, [&](auto t, auto o,
                                                           auto bm, auto tb_) {
    using T = typename decltype(t)::type;
    using OutT = typename decltype(o)::type;
    constexpr int BM = decltype(bm)::value;
    constexpr bool TB = decltype(tb_)::value;
    using R = GroupedRing<T, BM, TB>;
    auto kernel = grouped_kernel<T, BM, TB, OutT>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
    if (e != cudaSuccess) return (int)e;
    return f(kernel, R{}, t, o);
  });
}

// The table of `count` members from the caller's arrays (row_end may be
// null); cudaErrorInvalidValue for a count outside [1, kMaxMembers].
inline int fill_members(Members& m, const void* const* b, const long long* ldb,
                        const long long* row_end, long long count) {
  if (count < 1 || count > kMaxMembers) return (int)cudaErrorInvalidValue;
  m = Members{};
  m.count = (int)count;
  for (int i = 0; i < count; ++i) {
    m.b[i] = b[i];
    m.ldb[i] = ldb[i];
    m.row_end[i] = row_end ? row_end[i] : 0;
  }
  return 0;
}

}  // namespace repro

// dtype / out_dtype: 0 = bf16, 1 = f32 (operands, output); tb: B stored
// (N, K); cta_m: 16 or 64.  Each returns the cudaError_t of its launch
// (0 on success).

// C (G, M, N) = A (G, M, K) x B[g] for the G <= 16 members b[g] (leading
// dimensions ldb[g]).
extern "C" int repro_grouped_matmul(const void* a, const void* const* b,
                                    const long long* ldb, void* c, int dtype,
                                    int out_dtype, int tb, int cta_m,
                                    long long G, long long M, long long N,
                                    long long K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::Members mem;
  if (int e = repro::fill_members(mem, b, ldb, nullptr, G)) return e;
  return repro::with_grouped(dtype, out_dtype, cta_m, tb, [&](auto kernel, auto r,
                                                              auto t, auto o) {
    using T = typename decltype(t)::type;
    using OutT = typename decltype(o)::type;
    using R = decltype(r);
    dim3 grid((unsigned)((N + repro::kBN - 1) / repro::kBN),
              (unsigned)((M + R::ROWS - 1) / R::ROWS), (unsigned)G);
    kernel<<<grid, repro::kThreads, R::SMEM, s>>>(
        static_cast<const T*>(a), static_cast<OutT*>(c), M, N, K, mem);
    return (int)cudaGetLastError();
  });
}

// CTAs of the grouped kernel that fit on one SM at once (its occupancy),
// one CTA's dynamic shared memory, its ring's stages and the operand
// bytes one stage brings in.  Returns the cudaError_t of the query.
extern "C" int repro_grouped_occupancy(int dtype, int out_dtype, int tb,
                                       int cta_m, int* blocks, int* smem_bytes,
                                       int* stages, int* slab_bytes) {
  return repro::with_grouped(dtype, out_dtype, cta_m, tb, [&](auto kernel, auto r,
                                                              auto, auto) {
    using R = decltype(r);
    *smem_bytes = R::SMEM;
    *stages = R::RING / R::STAGE;
    *slab_bytes = R::SLAB;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro::kThreads, R::SMEM);
  });
}

// CTAs of the ragged walk that fit on one SM at once (its occupancy) and
// the shared memory of one CTA in bytes.  Returns the cudaError_t of the
// query.
extern "C" int repro_ragged_occupancy(int dtype, int out_dtype, int tb,
                                      int cta_m, int* blocks, int* smem_bytes) {
  return repro::with_ragged(dtype, out_dtype, cta_m, tb, [&](auto kernel, int smem,
                                                             auto, auto) {
    *smem_bytes = smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro::kThreads, smem);
  });
}

// The ragged walk over rows [row_lo, row_hi) of A (Mtotal, K) and C
// (Mtotal, N), bm-row blocks, members b[g] with end rows row_end[g]
// (global, cumulative), tn stripes and tk k steps per tile, total
// iterations, ipw per workgroup, `workgroups` live CTAs.  partials is
// (workgroups, 2, cta_m * 64) f32, counters (workgroups) int32 zeros.
extern "C" int repro_ragged_matmul(const void* a, const void* const* b,
                                   const long long* ldb, const long long* row_end,
                                   long long G, void* c, void* partials,
                                   void* counters, int dtype, int out_dtype,
                                   int tb, int cta_m, long long bm,
                                   long long row_lo, long long row_hi,
                                   long long N, long long K, long long tn,
                                   long long tk, long long total, long long ipw,
                                   long long workgroups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  repro::Members mem;
  if (int e = repro::fill_members(mem, b, ldb, row_end, G)) return e;
  return repro::with_ragged(dtype, out_dtype, cta_m, tb, [&](auto kernel, int smem,
                                                             auto t, auto o) {
    using T = typename decltype(t)::type;
    using OutT = typename decltype(o)::type;
    kernel<<<(unsigned)workgroups, repro::kThreads, smem, s>>>(
        static_cast<const T*>(a), static_cast<OutT*>(c),
        static_cast<float*>(partials), static_cast<int*>(counters), N, K, bm,
        row_lo, row_hi, (int)tn, (int)tk, (int)total, (int)ipw, mem);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
