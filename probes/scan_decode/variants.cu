// Stripped variants of the SSD scan decode kernel's store stream, to find
// what its time is made of (probes/scan_decode/ab.py --variants).  Each
// build (-DMODE=k) exports `repro_mamba_decode` with the product's C
// signature and runs the product's grid and thread layout
// (src/repro_torch/csrc/mamba_scan.cu, `mamba_decode_kernel`) without an
// initial state, in 16-byte rows, and writes the state only (no y):
//   MODE 0: stores only, no input loads (the layout's floor);
//   MODE 1: xd and B loaded, B xd^T stored with st.global.cs (evict first);
//   MODE 2: xd and B loaded, B xd^T stored with plain stores.
// Only MODE 2's state is right; none of them is a kernel of the port.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MODE
#define MODE 2
#endif

namespace probe {

constexpr int kThreads = 256;
constexpr int kRowBatch = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Params {
  const void* xd;
  const void* bm;
  float* sf;
  int pairs, H, P, N, slices, ppc, gs;
  int64_t x_sb, x_sh, b_sb, b_sh;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) variant_kernel(Params p) {
  const int tid = threadIdx.x;
  const int N = p.N, P = p.P, H = p.H;
  const int tp = kThreads / p.ppc;
  int gsp = 1;
  while (gsp < p.gs) gsp <<= 1;
  const int lanes = tp / gsp;
  const int slice = (int)(blockIdx.x % p.slices);
  const int pair0 = (int)(blockIdx.x / p.slices) * p.ppc;
  const int pl = tid / tp, cg = tid % tp % gsp, rl = tid % tp / gsp;
  const int bh = pair0 + pl;
  const int c0 = (slice * p.gs + cg) * 4;
  if (bh >= p.pairs || cg >= p.gs || c0 >= P) return;
  float* __restrict__ sf = p.sf + (int64_t)bh * N * P + c0;
#if MODE == 0
  const float x0 = tid, x1 = tid + 1, x2 = tid + 2, x3 = tid + 3;
  for (int n = rl; n < N; n += lanes)
    *reinterpret_cast<float4*>(sf + (int64_t)n * P) =
        make_float4(n * x0, n * x1, n * x2, n * x3);
#else
  const int b = bh / H, h = bh % H;
  const T* __restrict__ xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + c0;
  const T* __restrict__ bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh;
  const float x0 = to_f32(xd[0]), x1 = to_f32(xd[1]), x2 = to_f32(xd[2]),
              x3 = to_f32(xd[3]);
  for (int n0 = rl; n0 < N; n0 += lanes * kRowBatch) {
    float bn[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int n = n0 + i * lanes;
      bn[i] = n < N ? to_f32(bm[n]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      const int n = n0 + i * lanes;
      if (n >= N) break;
      const float4 o = make_float4(bn[i] * x0, bn[i] * x1, bn[i] * x2, bn[i] * x3);
#if MODE == 1
      __stcs(reinterpret_cast<float4*>(sf + (int64_t)n * P), o);
#else
      *reinterpret_cast<float4*>(sf + (int64_t)n * P) = o;
#endif
    }
  }
#endif
}

}  // namespace probe

extern "C" int repro_mamba_decode(
    const void* xd, const void* da, const void* bm, const void* cm,
    const float* s0, void* y, float* sf, int dtype, long long B, long long H,
    long long P, long long N, long long x_sb, long long x_sh, long long a_sb,
    long long a_sh, long long b_sb, long long b_sh, long long c_sb,
    long long c_sh, int slices, int pairs_per_cta, void* stream) {
  if (s0 || P % 4 || reinterpret_cast<uintptr_t>(sf) % 16) return (int)cudaErrorInvalidValue;
  probe::Params p;
  p.xd = xd;
  p.bm = bm;
  p.sf = sf;
  p.pairs = (int)(B * H);
  p.H = (int)H;
  p.P = (int)P;
  p.N = (int)N;
  p.slices = slices;
  p.ppc = pairs_per_cta;
  p.gs = (int)((P / 4 + slices - 1) / slices);
  p.x_sb = x_sb;
  p.x_sh = x_sh;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  const unsigned ctas = (unsigned)((p.pairs + p.ppc - 1) / p.ppc * slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    probe::variant_kernel<__nv_bfloat16><<<ctas, probe::kThreads, 0, s>>>(p);
  else
    probe::variant_kernel<float><<<ctas, probe::kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
