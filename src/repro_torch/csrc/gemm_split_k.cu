// Split-K GEMM in one launch: the K slices of an output tile are the CTAs
// of one thread-block cluster, and the cluster sums their f32 tiles
// through distributed shared memory.
//
// splitk_kernel replaces src/repro/kernels/gemm/kernel.py:65
// `_matmul_splitk_kernel` (grid (split, m, n, k/split), one f32 partial
// block per K slice) and, in its epilogue, :86 `_reduce_kernel` (the sum
// of the partials over the slice axis, cast to the output dtype).
//
// The TPU kernel needs K padded to a (bk * split) multiple so every slice
// sweeps equally many k tiles.  Here slice s is the K range
// [s * slice_k, min((s + 1) * slice_k, K)) with slice_k =
// ceil(ceil(K / bk) / split) * bk (the reference's padded slice length,
// kernels/gemm/kernel.py:split_k_slices), and the CTA masks K past the
// slice's end and past K, so nothing is padded.  A slice that lies wholly
// past K contributes a tile of zeros to the sum.
//
// What bounds it: bytes.  Split-K exists for skinny decode GEMMs whose
// (row, column) grid is too small to fill the card: each of the split K
// slices is its own CTA (grid z), so a 1 x 5120 x 17408 ffn-down at split
// 8 runs 80 x 8 = 640 CTAs instead of 80, each streaming its slice of the
// weights once.  So:
//   - each CTA's K loop is tile_gemm.cuh's `ring_tile`: kRingStages
//     cp.async stages, one k-slab in flight while the math works on the
//     other, B evict-first, A evict-last, and the slabs land in shared
//     memory without passing through registers;
//   - the split CTAs of one output tile form one cluster of (1, 1, split)
//     (launched with cudaLaunchKernelEx; portable up to 8, non-portable
//     9-16, the H100's largest), and the reduce is the cluster's
//     epilogue: each CTA stages its f32 tile in its own shared memory
//     (the drained ring's bytes), the cluster meets at a barrier, and each
//     CTA sums a share of the tile's elements over the split peers'
//     tiles, read through distributed shared memory (`mapa`), in slice
//     order s = 0 .. split - 1, casts and stores them.  A second barrier
//     keeps every CTA's shared memory alive until its peers' last remote
//     read.  No f32 partial reaches HBM, nothing is zeroed or counted, and
//     there is no second launch; the sum for a given geometry has one
//     fixed order, so two runs on the same inputs give the same bits.
//
// Plain C interface, loaded with ctypes by kernels/gemm/kernel.py.
#include "tile_gemm.cuh"

namespace repro {

constexpr int kPortableCluster = 8;  // CTAs of a portable cluster
constexpr int kMaxCluster = 16;      // the H100's largest cluster (non-portable)

// The cluster barrier, in its two halves: arrive publishes this thread's
// shared-memory writes to the cluster (release), wait returns once every
// thread of every CTA of the cluster has arrived (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in the cluster's shared-memory window of `p` (this CTA's
// shared memory) in the CTA of cluster rank `rank`.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <typename T, int BM, bool TA, bool TB>
using SplitRing = RingCfg<T, BM, TA, TB, kRingStages>;

// Grid (N / 64, M / BM, split) in clusters of (1, 1, split): cluster rank
// = blockIdx.z = the CTA's K slice.
template <typename T, int BM, bool TA, bool TB, typename OutT>
__global__ void __launch_bounds__(kThreads)
    splitk_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  OutT* __restrict__ C, int64_t M, int64_t N, int64_t K,
                  int64_t slice_k) {
  using Cfg = TileCfg<T, BM, TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t n0 = (int64_t)blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t m_end = m0 + BM < M ? m0 + BM : M;
  const int s = blockIdx.z, split = gridDim.z;
  const int64_t k0 = s * slice_k;
  const int64_t k1 = k0 + slice_k < K ? k0 + slice_k : K;  // may be <= k0

  Math<T, BM, TA, TB> math;
  math.init();
  ring_tile<T, BM, TA, TB, kRingStages>(smem, math, A, TA ? M : K, B,
                                        TB ? K : N, m0, m_end, n0, N, k0, k1);
  float* Cs = reinterpret_cast<float*>(smem);  // the drained ring's bytes
  math.stage(Cs);
  cluster_arrive();  // every slice's tile is staged ...
  cluster_wait();    // ... in its CTA's shared memory

  // This CTA's share: every split-th 4-column chunk of the tile, summed
  // over the slices in slice order.
  constexpr int CPR = kBN / 4, CHUNKS = BM * CPR;
  for (int q = s + split * threadIdx.x; q < CHUNKS; q += split * kThreads) {
    const int r = q / CPR, c = (q % CPR) * 4;
    const float* src = Cs + r * Cfg::C_LD + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < split; ++p) {
      const float4 v = ld_cluster4(map_rank(src, p));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    if (m0 + r >= m_end) continue;
    OutT* dst = C + (m0 + r) * N + n0 + c;
    const float sum[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n0 + c + e < N) dst[e] = from_f32<OutT>(sum[e]);
  }
  cluster_arrive();  // this CTA's remote reads are done ...
  cluster_wait();    // ... and so are its peers': shared memory may go
}

// Calls f(kernel pointer, launch config with the cluster attribute set,
// TypeTag<T>, TypeTag<OutT>, SplitRing<...>{}) for the instantiation of
// the runtime codes, its dynamic shared memory allowed (and, above 8
// slices, a non-portable cluster).
template <typename F>
int with_splitk(int dtype, int out_dtype, int cta_m, int ta, int tb,
                long long M, long long N, int split, cudaStream_t stream,
                cudaLaunchAttribute* attr, F&& f) {
  if (split < 1 || split > kMaxCluster) return (int)cudaErrorInvalidValue;
  return dispatch_tile(dtype, cta_m, ta, tb, [&](auto t, auto bm, auto ta_,
                                                 auto tb_) {
    using T = typename decltype(t)::type;
    constexpr int BM = decltype(bm)::value;
    constexpr bool TA = decltype(ta_)::value, TB = decltype(tb_)::value;
    using R = SplitRing<T, BM, TA, TB>;
    auto run = [&](auto o) {
      using OutT = typename decltype(o)::type;
      auto kernel = splitk_kernel<T, BM, TA, TB, OutT>;
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
      if (e == cudaSuccess && split > kPortableCluster)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return (int)e;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)((N + kBN - 1) / kBN),
                         (unsigned)((M + BM - 1) / BM), (unsigned)split);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = R::SMEM;
      cfg.stream = stream;
      attr->id = cudaLaunchAttributeClusterDimension;
      attr->val.clusterDim.x = 1;
      attr->val.clusterDim.y = 1;
      attr->val.clusterDim.z = (unsigned)split;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return f(kernel, cfg, t, o, R{});
    };
    return out_dtype == 0 ? run(TypeTag<__nv_bfloat16>{}) : run(TypeTag<float>{});
  });
}

}  // namespace repro

// dtype / out_dtype: 0 = bf16, 1 = f32 (operands, output); cta_m: 16 or
// 64; split: 1-16 slices of slice_k.  C is (M, N).  Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// split outside 1-16).
extern "C" int repro_splitk_matmul(const void* a, const void* b, void* c,
                                   int dtype, int out_dtype, int ta, int tb,
                                   int cta_m, long long M, long long N,
                                   long long K, int split, long long slice_k,
                                   void* stream) {
  cudaLaunchAttribute attr;
  return repro::with_splitk(
      dtype, out_dtype, cta_m, ta, tb, M, N, split,
      static_cast<cudaStream_t>(stream), &attr,
      [&](auto kernel, const cudaLaunchConfig_t& cfg, auto t, auto o, auto) {
        using T = typename decltype(t)::type;
        using OutT = typename decltype(o)::type;
        return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a),
                                       static_cast<const T*>(b),
                                       static_cast<OutT*>(c), (int64_t)M,
                                       (int64_t)N, (int64_t)K, (int64_t)slice_k);
      });
}

// The residency of one instantiation at `split` slices: CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), clusters of `split`
// resident on the card at once (cudaOccupancyMaxActiveClusters), one
// CTA's dynamic shared memory, its ring's stages and the operand bytes
// one stage brings in.  Returns the cudaError_t of the queries.
extern "C" int repro_splitk_occupancy(int dtype, int out_dtype, int ta, int tb,
                                      int cta_m, int split, int* blocks,
                                      int* clusters, int* smem_bytes,
                                      int* stages, int* slab_bytes) {
  cudaLaunchAttribute attr;
  return repro::with_splitk(
      dtype, out_dtype, cta_m, ta, tb, 1, repro::kBN, split, nullptr, &attr,
      [&](auto kernel, const cudaLaunchConfig_t& cfg, auto, auto, auto r) {
        using R = decltype(r);
        *smem_bytes = R::SMEM;
        *stages = R::RING / R::STAGE;
        *slab_bytes = R::SLAB;
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, kernel, repro::kThreads, R::SMEM);
        if (e != cudaSuccess) return (int)e;
        return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
      });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
