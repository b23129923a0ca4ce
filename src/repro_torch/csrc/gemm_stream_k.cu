// Stream-K GEMM in one launch: a persistent walk of W workgroups over the
// MAC iterations of the card's own CTA tiles, whose cut tiles are summed
// by their last contributors to arrive.
//
// stream_k_matmul_kernel replaces two TPU kernels of
// src/repro/kernels/gemm/kernel.py: :215 `_stream_k_kernel` (the walk's
// f32 partials) and :247 `_stream_k_fixup_kernel` (each tile's partials
// summed and cast), which it runs as the walk's epilogue.
//
// The decomposition is the reference's, in the card's units: output tiles
// q = (i, j) are CTA tiles of BM rows (16, 32 or 64, picked from M) and 64
// columns, in row-major order, tm x tn of them, each tk = ceil(K / BK) k
// steps long (BK the CTA's k step, TileCfg::BK), so total = tm * tn * tk
// MAC iterations.  Workgroup g walks iterations [g * ipw, min((g + 1) *
// ipw, total)), ipw = ceil(total / W).  Within its span it resets the
// accumulator at each tile frontier and at the span's start, and at each
// tile frontier and at the span's end the span's share of tile q is done:
//   - a tile that lies wholly inside one span is cast and stored into C;
//   - a tile cut by span boundaries has n = last - first + 1 contributors,
//     the workgroups first..last.  Each stores its f32 share as one
//     contiguous BM x 64 block (16-byte stores) into its own slot: two per
//     workgroup, slot 0 for the tile its span starts in, slot 1 for the
//     tile it ends in.  The contributors, in workgroup order, form runs of
//     R = fixup_runs(n) = ceil(sqrt(n)) (46 contributors: 7 runs of at most
//     7).  Each contributor counts itself in on its run's counter; the
//     last of the run to arrive sums the run's shares in workgroup order,
//     once its own walk is done (its own share from shared memory, the
//     others landed in its drained ring by 16-byte cp.async.cg, L2 loads
//     like ld.global.cg, all of a run's in flight before the first add and
//     none in registers) and, when the tile has one run, casts and stores
//     the tile; else it stores the run's sum into the run's first slot and
//     counts the run in on the tile's counter, and the last run to arrive
//     sums the runs' sums in run order, casts and stores the tile.  So no
//     CTA reads all n shares: at 46 the last arrivers read at most 6 and 6,
//     where one summer alone would read 45.
// The summation order is fixed by the geometry: per element, the sum over
// runs in run order of the sum over each run's workgroups in workgroup
// order, both from 0.f, cast once.  Whichever CTA arrives last, the bits
// are the same (kernels/gemm/ref.py: stream_k_fixup_ref with runs).
//
// Nothing spins.  A contributor that is not last publishes its share (its
// threads meet at a barrier, then one thread counts in by an atomic add
// that releases the CTA's stores and acquires the earlier arrivals') and
// walks on; the last to arrive finds every other share already visible.
// So no CTA waits for another to be scheduled, and the kernel is right
// with any number of its CTAs resident, beside any other kernel: Stream-K
// members run on side streams of a mixed launch
// (core/scheduler.py:_run_mixed), where the Stream-K paper's fixup, which
// waits on flags, could wait on a CTA that is not resident.  Slots and
// counters are O(W): 4 * live counters, a run and a tile counter per
// slot.  They are zero when a launch starts and zero when it ends: the
// CTA that completes a count resets it, for no other CTA touches a count
// after its last arrival.  So the counters need zeroing once, when they
// are made (kernels/gemm/kernel.py: stream_counters, one buffer per
// stream), and no launch of its own before each launch: a memset there
// cost 2.2 us a launch, more than a tenth of the kernel (PERF.md).
//
// What bounds it: bytes, the weights' (decode-sized M against large
// weights: the timed 32x512x17408 member reads 17.8 MB of weights for 0.57
// GFLOP).  The shares (3 MB at the timed member) are written and read back
// within the launch and stay in the 50 MB L2: B, read once, is copied with
// an L2 evict-first policy (and A, which every stripe's CTAs read again,
// evict-last), so the weights streaming through L2 do not push the shares
// out before their last contributors read them.  So:
//   - W comes from the card, not from the planner: the planner's G (a TPU
//     pipeline-slot budget, at most G_max = 8) becomes W = ceil(G / G_max
//     * SMs * CTAs_per_SM), CTAs_per_SM being this instantiation's
//     occupancy (repro_stream_k_occupancy).  A member planned at G = G_max
//     fills the card; a smaller G takes a proportional share of its SMs.
//   - each CTA streams its span's A and B k-slabs through a ring of
//     kStages shared-memory stages filled by cp.async (copy_tile,
//     cp_async.cuh), so kStages - 1 slabs (3 x 13.5 KB at 32 rows) are in
//     flight while the tensor cores (WMMA, tile_gemm.cuh's Math) work on
//     the oldest.  The ring runs on across tile frontiers: a tile's share
//     is staged through its own shared-memory region while the next
//     tile's slabs keep arriving.
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
  // + two staged f32 tiles: [0] a cut tile met mid-walk, whose sum waits
  // for the span's end; [1] every other tile.
  static constexpr int SMEM = RING + 2 * Cfg::C_BYTES;
  static constexpr int VECS = BM * kBN / 4;       // float4s of a tile
  static constexpr int PER_THREAD = VECS / kThreads;
  static constexpr int SHARE = BM * kBN * 4;      // bytes of one f32 share
  static constexpr int LAND = RING / SHARE;       // shares the drained ring holds
  // CTAs per SM that the shared memory allows (228 KB an SM, 1 KB of it
  // reserved per CTA): the registers must not allow fewer, or W shrinks.
  static constexpr int FIT = (228 * 1024) / (SMEM + 1024);
  static constexpr int MIN_BLOCKS = FIT < 1 ? 1 : FIT > 4 ? 4 : FIT;
  static_assert(VECS % kThreads == 0, "a tile's float4s divide among threads");
  static_assert(LAND >= 1, "the ring holds a share");
};

// R, the run length of a cut tile's two-level sum: ceil(sqrt(n)) for n
// contributors (kernels/gemm/kernel.py: fixup_runs).
__device__ __forceinline__ int fixup_runs(int n) {
  int r = 1;
  while (r * r < n) ++r;
  return r;
}

// C (M, N) row-major, bf16 or (out_f32) f32.
__device__ __forceinline__ void store_out(void* C, int out_f32, int64_t i, float x) {
  if (out_f32)
    static_cast<float*>(C)[i] = x;
  else
    static_cast<__nv_bfloat16*>(C)[i] = __float2bfloat16(x);
}

// What a CTA of the walk does with its finished tiles.  Tiles q = (row
// tile, 64-column stripe), tn stripes per row tile, tk k steps each;
// workgroup g walks [g * ipw, (g + 1) * ipw).  P holds (live, 2, BM * 64)
// f32 shares; counters (4 * live) int32 are zero at launch, and again at
// its end: [0, 2 live) one per run, at its first workgroup's slot;
// [2 live, 4 live) one per cut tile, at its first contributor's slot.
//
// A CTA that completes a run's count sums the run after its own walk,
// when its ring is drained: the ring then lands the other shares, every
// one of a run's 16-byte cp.async.cg copies (L2, as ld.global.cg) in
// flight before the first add and no register spent on them, so the walk
// keeps its registers and occupancy.  Each thread copies, and reads, only
// its own float4 positions of each share.
template <typename T, int BM, bool TA, bool TB>
struct Tiles {
  using Cfg = TileCfg<T, BM, TA, TB>;
  using W = WalkCfg<T, BM, TA, TB>;
  static constexpr int PT = W::PER_THREAD;

  unsigned char* smem;  // the ring: a landing area once drained
  int* last;            // shared: this CTA completed the count it joined
  void* C;
  float* P;
  int* counters;
  int out_f32;
  int64_t M, N;
  int tn, tk, ipw, live, g;

  // This thread's p-th float4 position of a tile: row v / 16, columns 4 (v % 16).
  __device__ __forceinline__ static int vec(int p) { return (int)threadIdx.x + p * kThreads; }
  __device__ __forceinline__ static float4* staged(float* Cs, int p) {
    const int v = vec(p);
    return reinterpret_cast<float4*>(Cs + (v >> 4) * Cfg::C_LD + (v & 15) * 4);
  }
  __device__ __forceinline__ int first(int q) const { return (int)((int64_t)q * tk / ipw); }
  __device__ __forceinline__ int contributors(int q) const {
    return (int)(((int64_t)q * tk + tk - 1) / ipw) - first(q) + 1;
  }
  // Tile q's slot of workgroup w: 0 if w's span starts in q, 1 if it ends in q.
  __device__ __forceinline__ int64_t slot(int w, int q) const {
    return (int64_t)w * 2 + ((int64_t)w * ipw >= (int64_t)q * tk ? 0 : 1);
  }
  __device__ __forceinline__ float4* share(int w, int q) const {
    return reinterpret_cast<float4*>(P + slot(w, q) * (BM * kBN));
  }

  // This thread's float4s x of tile q, cast into C.
  __device__ __forceinline__ void store(int q, const float4 (&x)[PT]) const {
    const int64_t m0 = (int64_t)(q / tn) * BM, n0 = (int64_t)(q % tn) * kBN;
#pragma unroll
    for (int p = 0; p < PT; ++p) {
      const int64_t r = m0 + (vec(p) >> 4), c = n0 + (vec(p) & 15) * 4;
      if (r >= M) continue;
      const float e[4] = {x[p].x, x[p].y, x[p].z, x[p].w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c + k < N) store_out(C, out_f32, r * N + c + k, e[k]);
    }
  }
  __device__ __forceinline__ void store_staged(int q, float* Cs) const {
    float4 x[PT];
#pragma unroll
    for (int p = 0; p < PT; ++p) x[p] = *staged(Cs, p);
    store(q, x);
  }

  // Count this CTA in at `counter`: does it complete the count of `of`
  // arrivals?  The CTA's stores before the call are visible to the CTA
  // that does, and that CTA sees every other arrival's: the threads meet,
  // then one thread counts in by an atomic add that releases what the CTA
  // stored and acquires what the arrivals before it released, and tells
  // the others (the first barrier also keeps its answer until every
  // thread has read the one before).
  __device__ __forceinline__ bool arrive(int* counter, int of) const {
    __syncthreads();
    if (threadIdx.x == 0) {
      int n;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                   : "=r"(n) : "l"(counter) : "memory");
      *last = n == of - 1;
      if (n == of - 1) *counter = 0;  // its last arrival: ready for the next launch
    }
    __syncthreads();
    return *last != 0;
  }

  // acc[p] = the sum over members m < cnt, in order, of member m's float4
  // at position p, member m being the share of workgroup w0 + m * stride in
  // tile q: member `own`'s from the staged tile Cs, every other one landed
  // in the drained ring, LAND shares at a time.
  __device__ __forceinline__ void gather(float4 (&acc)[PT], int cnt, int own, int w0,
                                         int stride, int q, float* Cs) const {
#pragma unroll
    for (int p = 0; p < PT; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < cnt;) {
      int e = m;
      for (int k = 0; e < cnt && (k < W::LAND || e == own); ++e) {
        if (e == own) continue;
        const float4* src = share(w0 + e * stride, q);
        unsigned char* land = smem + k++ * W::SHARE;
#pragma unroll
        for (int p = 0; p < PT; ++p) cp_async16(land + vec(p) * 16, src + vec(p));
      }
      cp_async_commit();
      cp_async_wait<0>();  // this thread's copies have landed
      for (int k = 0; m < e; ++m) {
        const float4* land = reinterpret_cast<const float4*>(smem + k * W::SHARE);
        k += m != own;
#pragma unroll
        for (int p = 0; p < PT; ++p) {
          const float4 x = m == own ? *staged(Cs, p) : land[vec(p)];
          acc[p].x += x.x;
          acc[p].y += x.y;
          acc[p].z += x.z;
          acc[p].w += x.w;
        }
      }
    }
  }

  // Cut tile q's share of this CTA, staged in Cs, into its slot; counts
  // the CTA in on its run.  True if it completed the run.
  __device__ __forceinline__ bool publish(int q, float* Cs) const {
    float4* mine = share(g, q);
#pragma unroll
    for (int p = 0; p < PT; ++p) __stcg(mine + vec(p), *staged(Cs, p));
    const int f = first(q), cnt = contributors(q), R = fixup_runs(cnt);
    const int lo = (g - f) / R * R;
    return arrive(counters + slot(f + lo, q), cnt - lo < R ? cnt - lo : R);
  }

  // The sum of cut tile q, whose run this CTA completed, its own share
  // staged in Cs: the run in workgroup order, then, when the tile has more
  // runs, the runs' sums in run order by the last run to arrive.
  __device__ __forceinline__ void finish(int q, float* Cs) const {
    const int f = first(q), cnt = contributors(q);
    const int R = fixup_runs(cnt), runs = (cnt + R - 1) / R;
    const int run = (g - f) / R, lo = run * R;
    float4 acc[PT];
    gather(acc, cnt - lo < R ? cnt - lo : R, g - f - lo, f + lo, 1, q, Cs);
    if (runs > 1) {
      // The run's sum: into the run's first slot for the other runs' last
      // arriver, into Cs (each thread its own positions) for this one.
      float4* sum = share(f + lo, q);
#pragma unroll
      for (int p = 0; p < PT; ++p) {
        __stcg(sum + vec(p), acc[p]);
        *staged(Cs, p) = acc[p];
      }
      if (!arrive(counters + 2 * live + slot(f, q), runs)) return;
      gather(acc, runs, run, f, R, q, Cs);
    }
    store(q, acc);
  }
};

// The kernel: workgroup g < live walks its span of total iterations.
template <typename T, int BM, bool TA, bool TB>
__global__ void __launch_bounds__(kThreads, (WalkCfg<T, BM, TA, TB>::MIN_BLOCKS))
    stream_k_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                           void* __restrict__ C, float* __restrict__ P,
                           int* __restrict__ counters, int out_f32, int64_t M,
                           int64_t N, int64_t K, int tn, int tk, int total,
                           int ipw, int live) {
  using Cfg = TileCfg<T, BM, TA, TB>;
  using W = WalkCfg<T, BM, TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  float* const staged0 = reinterpret_cast<float*>(smem + W::RING);
  float* const staged1 = staged0 + Cfg::C_BYTES / 4;
  // Iteration and tile indices in 32 bits (the launcher keeps total below
  // 2^31): the walk divides by tk and tn every iteration.
  const int g = blockIdx.x;
  const int it0 = g * ipw;
  const int n = (it0 + ipw < total ? it0 + ipw : total) - it0;
  const int64_t lda = TA ? M : K, ldb = TB ? K : N;
  const uint64_t stream = l2_policy<true>(), keep = l2_policy<false>();
  const Tiles<T, BM, TA, TB> tiles{smem, &last, C, P, counters, out_f32, M, N,
                                   tn, tk, ipw, live, g};

  auto stage_a = [&](int s) { return reinterpret_cast<T*>(smem + s * W::STAGE); };
  auto stage_b = [&](int s) {
    return reinterpret_cast<T*>(smem + s * W::STAGE + Cfg::B_OFF);
  };
  auto load = [&](int s, int it) {  // iteration it's A and B k-slabs
    const int q = it / tk;
    const int64_t k0 = (int64_t)(it % tk) * Cfg::BK;
    const int64_t m0 = (int64_t)(q / tn) * BM, n0 = (int64_t)(q % tn) * kBN;
    if (TA) copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
        stage_a(s), A, lda, k0, m0, K, M, keep);     // rows k, columns m
    else    copy_tile<T, Cfg::A_R, Cfg::A_C, Cfg::A_LD, kThreads>(
        stage_a(s), A, lda, m0, k0, M, K, keep);     // rows m, columns k
    if (TB) copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
        stage_b(s), B, ldb, n0, k0, N, K, stream);   // rows n, columns k
    else    copy_tile<T, Cfg::B_R, Cfg::B_C, Cfg::B_LD, kThreads>(
        stage_b(s), B, ldb, k0, n0, K, N, stream);   // rows k, columns n
  };

  Math<T, BM, TA, TB> math;
  math.init();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(s, it0 + s);
    cp_async_commit();
  }
  int owed0 = -1, owed1 = -1;  // cut tiles whose run this CTA completed
  for (int j = 0; j < n; ++j) {
    cp_async_wait<kStages - 2>();  // iteration j's slabs have landed
    __syncthreads();               // ... for every thread; stage j - 1 is free
    if (j + kStages - 1 < n) load((j + kStages - 1) % kStages, it0 + j + kStages - 1);
    cp_async_commit();
    const int s = j % kStages;
    math.step(stage_a(s), stage_b(s));
    const int it = it0 + j;
    if ((it + 1) % tk != 0 && j + 1 != n) continue;
    // Tile frontier or span end: the span's share of tile q is complete.
    // (The last reads of a staging tile by an earlier epilogue precede
    // this iteration's __syncthreads.)  Only a span's first tile can be
    // cut and met before the span's end: it stages in staged0, all else
    // in staged1.
    const int q = it / tk;
    const bool cut = tiles.contributors(q) > 1, early = cut && j + 1 != n;
    float* const Cs = early ? staged0 : staged1;
    math.stage(Cs);
    __syncthreads();
    math.init();
    if (!cut)  // the whole tile lies in this span
      tiles.store_staged(q, Cs);
    else if (tiles.publish(q, Cs))
      (early ? owed0 : owed1) = q;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is drained: it lands the shares
  if (owed0 >= 0) tiles.finish(owed0, staged0);
  if (owed1 >= 0) tiles.finish(owed1, staged1);
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

// The kernel of one instantiation with its dynamic shared memory allowed:
// f(kernel pointer, shared bytes, TypeTag<T>) runs the launch or the query.
template <typename F>
int with_walk(int dtype, int cta_m, int ta, int tb, F&& f) {
  return dispatch_walk(dtype, cta_m, ta, tb, [&](auto t, auto rows, auto ta_,
                                                  auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(rows)::value;
    constexpr bool TA = decltype(ta_)::value, TB = decltype(tb_)::value;
    constexpr int smem = WalkCfg<T, BM, TA, TB>::SMEM;
    auto kernel = stream_k_matmul_kernel<T, BM, TA, TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    return f(kernel, smem, t);
  });
}

}  // namespace repro

// CTAs of the kernel that fit on one SM at once (its occupancy) and the
// shared memory of one CTA in bytes, for dtype 0 = bf16 / 1 = f32, cta_m
// 16, 32 or 64 rows.  Returns the cudaError_t of the query.
extern "C" int repro_stream_k_occupancy(int dtype, int ta, int tb, int cta_m,
                                        int* blocks, int* smem_bytes) {
  return repro::with_walk(dtype, cta_m, ta, tb, [&](auto kernel, int smem,
                                                     auto) {
    *smem_bytes = smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro::kThreads, smem);
  });
}

// C (M, N) in out_dtype (0 = bf16, 1 = f32) by `live` workgroups over tm x
// tn CTA tiles of cta_m x 64 (tn per row of tiles), tk k steps each, ipw
// iterations per workgroup.  P is (live, 2, cta_m * 64) f32, counters
// (4 * live) int32, zero (a launch leaves them zero).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int repro_stream_k_matmul(const void* a, const void* b, void* c,
                                     void* p, void* counters, int dtype,
                                     int out_dtype, int ta, int tb, int cta_m,
                                     long long M, long long N, long long K,
                                     long long tn, long long tk, long long total,
                                     long long ipw, long long live, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro::with_walk(dtype, cta_m, ta, tb, [&](auto kernel, int smem,
                                                     auto t) {
    using T = typename decltype(t)::type;
    kernel<<<(unsigned)live, repro::kThreads, smem, s>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), c,
        static_cast<float*>(p), static_cast<int*>(counters), out_dtype,
        M, N, K, (int)tn, (int)tk, (int)total, (int)ipw, (int)live);
    return (int)cudaGetLastError();
  });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
