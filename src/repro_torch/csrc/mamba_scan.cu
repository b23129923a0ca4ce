// Chunked SSD (Mamba2) scan: per (batch, head), over chunks of L steps with
// an (N, P) f32 state carried from chunk to chunk.  With s = cumsum(da)
// over the chunk and S_prev the state before it:
//   Y = (C . B^T o exp(s_i - s_j) [i >= j]) . xd + exp(s) o (C . S_prev)
//   S = exp(s_L) . S_prev + B^T . (exp(s_L - s) o xd)
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan/kernel.py:24
// `_mamba_kernel` (launched by `mamba_scan_pallas`, :86).  That kernel runs
// a (B*H, chunks) grid with the chunk axis sequential and the state in VMEM
// scratch, on inputs the op first transposes to (B*H, T, *), pads to a
// multiple of L and converts to f32.
//
// What bounds it on an H100: bytes.  The serving path's member is a decode
// step (T = 1): each (batch, head) reads its inputs (a few hundred bytes)
// and writes y and its 16 KB final state (N = P = 64 for Zamba2), at a
// handful of FLOPs per byte.  A long prefill does O(L) work per element in
// the intra-chunk products, still far below the card's ~67 f32 operations
// per byte on the CUDA cores at L <= 512.  The design:
//   - one CTA per (batch, head) loops over the chunks in order; the state
//     stays in shared memory (N x P f32) for the whole sequence, and the
//     initial state s0 (when given) is read once and the final state
//     written once;
//   - within a chunk the real rows (Lr = min(L, T - c0): no work for rows
//     past T, so a decode step with L = 32 computes one row) are done in
//     row sub-blocks of kLB = 32, each against the column sub-blocks up to
//     its diagonal, so shared memory holds kLB rows of C, B and xd in f32
//     whatever L is (at L = 512 one chunk's xd, B and C are 384 KB);
//   - the i < j half of the decay matrix is masked explicitly, never
//     computed as exp(-inf);
//   - every row's inter-chunk term reads S_prev before the chunk's state
//     update overwrites it;
//   - xd (B,T,H,P), da (B,T,H) and B/C (B,T,H,N) are read through their
//     strides in bf16 or f32 and converted to f32 in registers, so a
//     Mamba2 group-shared B/C can be a broadcast view (head stride 0) and
//     nothing is transposed, padded or copied.
// Products run as f32 FMAs on the CUDA cores; tensor cores are later work.
//
// Plain C interface, loaded with ctypes by kernels/mamba_scan/kernel.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_ms {

constexpr int kThreads = 256;  // 8 warps
constexpr int kLB = 32;        // rows per sub-block
constexpr int kMaxDim = 128;   // N and P capacity
constexpr int kMaxL = 512;     // chunk length capacity
constexpr int kAcc = kLB * kMaxDim / kThreads;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* xd;
  const void* da;
  const void* bm;
  const void* cm;
  const float* s0;  // (B, H, N, P) f32, or null for a zero state
  void* y;          // (B, T, H, P), xd's dtype
  float* sf;        // (B, H, N, P) f32
  int64_t B, T, H, P, N, L;
  int64_t x_sb, x_st, x_sh;
  int64_t a_sb, a_st, a_sh;
  int64_t b_sb, b_st, b_sh;
  int64_t c_sb, c_st, c_sh;
};

inline size_t smem_floats(int64_t N, int64_t P) {
  return (size_t)(N * P + kMaxL + 2 * kLB * (N + 1) + kLB * (P + 1) +
                  kLB * (kLB + 1) + kLB);
}

// Rows t0 .. t0 + n - 1 (n <= kLB) of one (batch, head)'s (T, cols) slice
// into dst (row stride ld) as f32, each row times scale[row] when given;
// rows past n read as zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ base,
                                          int64_t st, int64_t t0, int n,
                                          int cols, const float* scale) {
  for (int i = threadIdx.x; i < kLB * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    float v = 0.f;
    if (r < n) {
      v = to_f32(base[(t0 + r) * st + c]);
      if (scale) v *= scale[r];
    }
    dst[r * ld + c] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = (int)p.N, P = (int)p.P;
  float* S = smem;              // N x P state
  float* s = S + N * P;         // kMaxL, cumsum of da over the chunk
  float* Cs = s + kMaxL;        // kLB x (N + 1)
  float* Bs = Cs + kLB * (N + 1);
  float* Xs = Bs + kLB * (N + 1);  // kLB x (P + 1)
  float* W = Xs + kLB * (P + 1);   // kLB x (kLB + 1)
  float* dec = W + kLB * (kLB + 1);  // kLB, exp(s_L - s_j) of a sub-block

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh;
  const T* da = static_cast<const T*>(p.da) + b * p.a_sb + h * p.a_sh;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + h * p.c_sh;
  T* y = static_cast<T*>(p.y) + (b * p.T * p.H + h) * P;  // row stride H*P
  const int64_t y_st = p.H * P;
  const int64_t bh = b * p.H + h;

  for (int i = tid; i < N * P; i += kThreads)
    S[i] = p.s0 ? p.s0[bh * N * P + i] : 0.f;

  for (int64_t c0 = 0; c0 < p.T; c0 += p.L) {
    const int Lr = (int)(p.T - c0 < p.L ? p.T - c0 : p.L);
    __syncthreads();  // the previous chunk's reads of s are done
    if (warp == 0) {  // inclusive cumsum of da over the chunk's real rows
      float carry = 0.f;
      for (int j0 = 0; j0 < Lr; j0 += 32) {
        const int j = j0 + lane;
        float v = j < Lr ? to_f32(da[(c0 + j) * p.a_st]) : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (j < Lr) s[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float stot = s[Lr - 1];

    for (int i0 = 0; i0 < Lr; i0 += kLB) {
      const int ni = Lr - i0 < kLB ? Lr - i0 : kLB;
      load_rows(Cs, N + 1, cm, p.c_st, c0 + i0, ni, N, nullptr);
      float acc[kAcc];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += kLB) {  // up to the diagonal block
        const int nj = Lr - j0 < kLB ? Lr - j0 : kLB;
        __syncthreads();
        load_rows(Bs, N + 1, bm, p.b_st, c0 + j0, nj, N, nullptr);
        load_rows(Xs, P + 1, xd, p.x_st, c0 + j0, nj, P, nullptr);
        __syncthreads();
        for (int i = tid; i < ni * kLB; i += kThreads) {
          const int r = i / kLB, j = i % kLB;
          float w = 0.f;
          if (j < nj && i0 + r >= j0 + j) {  // lower triangle only
            const float* cr = Cs + r * (N + 1);
            const float* br = Bs + j * (N + 1);
            float g = 0.f;
            for (int n = 0; n < N; ++n) g = fmaf(cr[n], br[n], g);
            w = g * expf(s[i0 + r] - s[j0 + j]);
          }
          W[r * (kLB + 1) + j] = w;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kAcc; ++k) {
          const int idx = tid + k * kThreads;
          if (idx < ni * P) {
            const int r = idx / P, c = idx % P;
            const float* wr = W + r * (kLB + 1);
            float a = acc[k];
            for (int j = 0; j < nj; ++j) a = fmaf(wr[j], Xs[j * (P + 1) + c], a);
            acc[k] = a;
          }
        }
      }
      // Inter-chunk term from S_prev (not yet updated), then y.
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        const int idx = tid + k * kThreads;
        if (idx < ni * P) {
          const int r = idx / P, c = idx % P;
          const float* cr = Cs + r * (N + 1);
          float g = 0.f;
          for (int n = 0; n < N; ++n) g = fmaf(cr[n], S[n * P + c], g);
          y[(c0 + i0 + r) * y_st + c] =
              from_f32<T>(acc[k] + expf(s[i0 + r]) * g);
        }
      }
      __syncthreads();  // Cs, Bs, Xs and W are reloaded next
    }

    // State update: S = exp(s_L) S_prev + B^T (exp(s_L - s) o xd).
    const float es = expf(stot);
    for (int i = tid; i < N * P; i += kThreads) S[i] *= es;
    for (int j0 = 0; j0 < Lr; j0 += kLB) {
      const int nj = Lr - j0 < kLB ? Lr - j0 : kLB;
      __syncthreads();
      if (tid < kLB) dec[tid] = tid < nj ? expf(stot - s[j0 + tid]) : 0.f;
      __syncthreads();
      load_rows(Bs, N + 1, bm, p.b_st, c0 + j0, nj, N, nullptr);
      load_rows(Xs, P + 1, xd, p.x_st, c0 + j0, nj, P, dec);
      __syncthreads();
      for (int i = tid; i < N * P; i += kThreads) {
        const int n = i / P, c = i % P;
        float a = S[i];
        for (int j = 0; j < nj; ++j)
          a = fmaf(Bs[j * (N + 1) + n], Xs[j * (P + 1) + c], a);
        S[i] = a;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) p.sf[bh * N * P + i] = S[i];
}

template <typename T>
static int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.N, p.P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      mamba_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mamba_kernel<T><<<(unsigned)(p.B * p.H), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace repro_ms

// dtype: 0 = bf16, 1 = f32 (xd, da, bm and cm share it; y takes it too).
// N, P <= 128, 1 <= L <= 512.  Strides are in elements, (batch, time,
// head) for each input; the last dim of xd, bm and cm is contiguous.
// s0 may be null (zero initial state).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int repro_mamba_scan(
    const void* xd, const void* da, const void* bm, const void* cm,
    const float* s0, void* y, float* sf, int dtype, long long B, long long T,
    long long H, long long P, long long N, long long L, long long x_sb,
    long long x_st, long long x_sh, long long a_sb, long long a_st,
    long long a_sh, long long b_sb, long long b_st, long long b_sh,
    long long c_sb, long long c_st, long long c_sh, void* stream) {
  if (N < 1 || P < 1 || N > repro_ms::kMaxDim || P > repro_ms::kMaxDim ||
      L < 1 || L > repro_ms::kMaxL)
    return (int)cudaErrorInvalidValue;
  repro_ms::Params p;
  p.xd = xd;
  p.da = da;
  p.bm = bm;
  p.cm = cm;
  p.s0 = s0;
  p.y = y;
  p.sf = sf;
  p.B = B;
  p.T = T;
  p.H = H;
  p.P = P;
  p.N = N;
  p.L = L;
  p.x_sb = x_sb;
  p.x_st = x_st;
  p.x_sh = x_sh;
  p.a_sb = a_sb;
  p.a_st = a_st;
  p.a_sh = a_sh;
  p.b_sb = b_sb;
  p.b_st = b_st;
  p.b_sh = b_sh;
  p.c_sb = c_sb;
  p.c_st = c_st;
  p.c_sh = c_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? repro_ms::launch<__nv_bfloat16>(p, s)
                    : repro_ms::launch<float>(p, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
