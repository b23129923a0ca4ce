// Write path (b) of the SSD scan's decode step, for comparison with the
// product's path (a) in src/repro_torch/csrc/mamba_scan.cu
// (`mamba_decode_kernel`: 16-byte stores straight from registers).  Here
// the CTA builds its pairs' state tile in shared memory and one thread
// writes it with Hopper's 1-D bulk asynchronous copy
// (cp.async.bulk.global.shared::cta, no tensor map); an initial state is
// read the same way, by one bulk copy into a buffer tracked by an mbarrier.
// The thread layout, C . B, C . S0 and y are the product's.
//
// It exports `repro_mamba_decode` with the product's C signature, so
// `kernels/mamba_scan/kernel.py:_decode_launch` launches it on the same
// grid.  It takes whole pairs only (slices == 1) in 16-byte rows (P % 4 ==
// 0, the state and S0 16-byte aligned); anything else returns
// cudaErrorInvalidValue.  Built and timed by probes/scan_decode/ab.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace probe {

constexpr int kThreads = 256;
constexpr int kMaxPairsPerCta = 8;
constexpr int kRowBatch = 4;  // B and C rows loaded before the first store

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecodeParams {
  const void* xd;
  const void* da;
  const void* bm;
  const void* cm;
  const float* s0;
  void* y;
  float* sf;
  int64_t pairs, H;
  int P, N, ppc, gs;
  int64_t x_sb, x_sh, a_sb, a_sh, b_sb, b_sh, c_sb, c_sh;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ int cb_slot(const DecodeParams& p, bool bcast,
                                       int64_t pair0, int pl, int64_t b) {
  if (!bcast) return pl;
  const int64_t first = b * p.H - pair0;
  return first > 0 ? (int)first : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bulk_decode_kernel(DecodeParams p) {
  extern __shared__ __align__(128) float4 tile[];  // the CTA's state rows
  __shared__ float4 part[kThreads];
  __shared__ float cbs[kMaxPairsPerCta];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = p.N, P = p.P, P4 = P / 4;
  const int tp = kThreads / p.ppc;
  int gsp = 1;
  while (gsp < p.gs) gsp <<= 1;
  const int lanes = tp / gsp;
  const int64_t pair0 = (int64_t)blockIdx.x * p.ppc;
  const int npairs = (int)(p.pairs - pair0 < p.ppc ? p.pairs - pair0 : p.ppc);
  const unsigned bytes = (unsigned)npairs * N * P * 4;
  const bool bcast = p.b_sh == 0 && p.c_sh == 0;
  const unsigned mbar = repro::smem_u32(&bar);

  if (p.s0) {
    if (tid == 0) {
      repro::mbar_init(mbar, 1);
      repro::mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      repro::mbar_arrive_tx(mbar, bytes);
      bulk_load(repro::smem_u32(tile), p.s0 + pair0 * N * P, bytes, mbar);
    }
  }
  if (warp < p.ppc && pair0 + warp < p.pairs) {
    const int64_t bh = pair0 + warp, b = bh / p.H, h = bh % p.H;
    if (cb_slot(p, bcast, pair0, warp, b) == warp) {
      const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh;
      const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + h * p.c_sh;
      float g = 0.f;
      for (int n = lane; n < N; n += 32) g = fmaf(to_f32(cm[n]), to_f32(bm[n]), g);
      g = warp_sum(g);
      if (lane == 0) cbs[warp] = g;
    }
  }
  if (p.s0) repro::mbar_wait(mbar, 0);

  const int pl = tid / tp, cg = tid % tp % gsp, rl = tid % tp / gsp;
  const int64_t bh = pair0 + pl;
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bh < p.pairs && cg < p.gs) {
    const int64_t b = bh / p.H, h = bh % p.H;
    const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + cg * 4;
    const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh;
    const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + h * p.c_sh;
    const float x0 = to_f32(xd[0]), x1 = to_f32(xd[1]), x2 = to_f32(xd[2]),
                x3 = to_f32(xd[3]);
    const float decay =
        p.s0 ? expf(to_f32(static_cast<const T*>(p.da)[b * p.a_sb + h * p.a_sh])) : 0.f;
    float4* rows = tile + (int64_t)pl * N * P4 + cg;
    for (int n0 = rl; n0 < N; n0 += lanes * kRowBatch) {
      float bn[kRowBatch], cn[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int n = n0 + i * lanes;
        bn[i] = n < N ? to_f32(bm[n]) : 0.f;
        cn[i] = n < N && p.s0 ? to_f32(cm[n]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int n = n0 + i * lanes;
        if (n >= N) break;
        float4 v = make_float4(bn[i] * x0, bn[i] * x1, bn[i] * x2, bn[i] * x3);
        if (p.s0) {
          const float4 s = rows[n * P4];
          cs.x = fmaf(cn[i], s.x, cs.x);
          cs.y = fmaf(cn[i], s.y, cs.y);
          cs.z = fmaf(cn[i], s.z, cs.z);
          cs.w = fmaf(cn[i], s.w, cs.w);
          v.x = fmaf(bn[i], x0, decay * s.x);
          v.y = fmaf(bn[i], x1, decay * s.y);
          v.z = fmaf(bn[i], x2, decay * s.z);
          v.w = fmaf(bn[i], x3, decay * s.w);
        }
        rows[n * P4] = v;
      }
    }
  }
  repro::fence_proxy_async();  // the tile's generic writes, before the bulk read
  if (p.s0) part[tid] = cs;
  __syncthreads();
  if (tid == 0) bulk_store(p.sf + pair0 * N * P, repro::smem_u32(tile), bytes);

  for (int i = tid; i < p.ppc * p.gs; i += kThreads) {
    const int pi = i / p.gs, gi = i % p.gs;
    const int64_t bhi = pair0 + pi;
    if (bhi >= p.pairs) continue;
    const int64_t b = bhi / p.H, h = bhi % p.H;
    const int c = gi * 4;
    const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + c;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float decay = 0.f;
    if (p.s0) {
      decay = expf(to_f32(static_cast<const T*>(p.da)[b * p.a_sb + h * p.a_sh]));
      for (int r = 0; r < lanes; ++r) {
        const float4 q = part[pi * tp + r * gsp + gi];
        acc[0] += q.x;
        acc[1] += q.y;
        acc[2] += q.z;
        acc[3] += q.w;
      }
    }
    const float cb = cbs[cb_slot(p, bcast, pair0, pi, b)];
    T* y = static_cast<T*>(p.y) + bhi * P + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = from_f32<T>(fmaf(decay, acc[e], cb * to_f32(xd[e])));
  }
}

template <typename T>
static int launch(const DecodeParams& p, cudaStream_t s) {
  const int smem = p.ppc * p.N * p.P * 4;
  cudaError_t e = cudaFuncSetAttribute(bulk_decode_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned ctas = (unsigned)((p.pairs + p.ppc - 1) / p.ppc);
  bulk_decode_kernel<T><<<ctas, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace probe

extern "C" int repro_mamba_decode(
    const void* xd, const void* da, const void* bm, const void* cm,
    const float* s0, void* y, float* sf, int dtype, long long B, long long H,
    long long P, long long N, long long x_sb, long long x_sh, long long a_sb,
    long long a_sh, long long b_sb, long long b_sh, long long c_sb,
    long long c_sh, int slices, int pairs_per_cta, void* stream) {
  const int ppc = pairs_per_cta;
  if (slices != 1 || P % 4 || N < 1 || P < 4 || N > 128 || P > 128 ||
      (ppc != 1 && ppc != 2 && ppc != 4 && ppc != 8) ||
      reinterpret_cast<uintptr_t>(sf) % 16 || reinterpret_cast<uintptr_t>(s0) % 16)
    return (int)cudaErrorInvalidValue;
  probe::DecodeParams p;
  p.xd = xd;
  p.da = da;
  p.bm = bm;
  p.cm = cm;
  p.s0 = s0;
  p.y = y;
  p.sf = sf;
  p.pairs = B * H;
  p.H = H;
  p.P = (int)P;
  p.N = (int)N;
  p.ppc = ppc;
  p.gs = (int)(P / 4);
  p.x_sb = x_sb;
  p.x_sh = x_sh;
  p.a_sb = a_sb;
  p.a_sh = a_sh;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.c_sb = c_sb;
  p.c_sh = c_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? probe::launch<__nv_bfloat16>(p, s) : probe::launch<float>(p, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
