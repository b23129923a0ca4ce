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
// Two kernels compute it, chosen by shape alone
// (kernels/mamba_scan/kernel.py:scan_route): `mamba_decode_kernel` for a
// decode step (T = 1), `mamba_kernel` for every other T.  Both read xd
// (B,T,H,P), da (B,T,H) and B/C (B,T,H,N) through their strides in bf16 or
// f32 and convert to f32 in registers, so a Mamba2 group-shared B/C can be
// a broadcast view (head stride 0) and nothing is transposed, padded or
// copied.  Products run as f32 FMAs on the CUDA cores.
//
// The decode step.  At T = 1 the chunk collapses to a closed form (s = da,
// exp(s_i - s_j) = 1):
//   y = (C . B) xd + exp(da) (C . S0),    S = exp(da) S0 + B xd^T.
// What bounds it on an H100 is the state's bytes: B*H*N*P*4 written (16.8
// MB for Zamba2's 64 heads of P = N = 64 at batch 16), read as well when
// S0 is given, against a few hundred input bytes and about one FMA per
// state element.  So the kernel is a stream of 16-byte stores:
//   - every thread owns one 4-column group of a pair's state (a column
//     slice of it at small batch) and a set of rows; it computes its
//     elements in registers and writes each row's group with one
//     st.global.cs.v4 (evict-first: nothing in the launch reads the state
//     again; 4-byte stores where P % 4 != 0 or a row is not 16-byte
//     aligned), neighbouring lanes on neighbouring columns and rows, so a
//     warp writes whole 32-byte sectors; S0 rows are read the same way, the
//     loads of kRowBatch rows issued before their first store;
//   - a CTA of 256 threads takes one pair, or up to 8 small pairs, or one
//     column slice of a pair; the launcher picks the slices so the grid
//     puts work on every SM (at batch 1, 64 pairs become 256 CTAs of 16
//     columns).  A column slice holds every row of its columns, so C . S0
//     sums within the CTA and needs no exchange between CTAs;
//   - no shared-memory staging and, without S0, no barrier: C . B is one
//     warp's shuffle reduction in the warp that writes the pair's y, its
//     loads issued before that warp's stores; with S0 the threads' partial
//     sums of C . S0 meet in shared memory (one barrier) and are added in a
//     fixed order, so a rerun gives the same bits;
//   - only the one real row of xd, da, B and C is read.
// The bulk-copy alternative (the state built in shared memory and written
// by cp.async.bulk) ran slower on the card (PERF.md section 6).
//
// The chunk loop, for every other T.  A long prefill does O(L) work per
// element in the intra-chunk products, still far below the card's ~67 f32
// operations per byte on the CUDA cores at L <= 512; it is bound by its
// latency chain (tensor cores and chunks in parallel are later work):
//   - one CTA per (batch, head) loops over the chunks in order; the state
//     stays in shared memory (N x P f32) for the whole sequence, and the
//     initial state s0 (when given) is read once and the final state
//     written once;
//   - within a chunk the real rows (Lr = min(L, T - c0): no work for rows
//     past T) are done in row sub-blocks of kLB = 32, each against the
//     column sub-blocks up to its diagonal, so shared memory holds kLB rows
//     of C, B and xd in f32 whatever L is (at L = 512 one chunk's xd, B and
//     C are 384 KB);
//   - the i < j half of the decay matrix is masked explicitly, never
//     computed as exp(-inf);
//   - every row's inter-chunk term reads S_prev before the chunk's state
//     update overwrites it.
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


// ------------------------------------------------------------ decode step
constexpr int kDecodeThreads = 256;
constexpr int kMaxPairsPerCta = 8;  // pairs of a CTA (at least a warp each)
constexpr int kRowBatch = 4;        // rows loaded before the first of them is stored

struct DecodeParams {
  const void* xd;
  const void* da;
  const void* bm;
  const void* cm;
  const float* s0;  // (B, H, N, P) f32, or null for a zero state
  void* y;          // (B, 1, H, P), xd's dtype
  float* sf;        // (B, H, N, P) f32
  int pairs, H;  // B * H < 2^31
  int P, N;
  int slices;  // column slices per pair (CTAs of one pair)
  int ppc;     // pairs per CTA: 1, 2, 4 or 8 (> 1 only when slices == 1)
  int gs;      // 4-column groups per slice
  int64_t x_sb, x_sh, a_sb, a_sh, b_sb, b_sh, c_sb, c_sh;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The 4 columns c0 .. c0 + 3 of an f32 row (`left` = P - c0 of them real):
// one 16-byte access when VEC, else masked 4-byte ones.  Both directions
// stream (ld.global.cs / st.global.cs, evict first): the launch touches
// each state byte once.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int left) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (left > 0) v.x = __ldcs(p);
  if (left > 1) v.y = __ldcs(p + 1);
  if (left > 2) v.z = __ldcs(p + 2);
  if (left > 3) v.w = __ldcs(p + 3);
  return v;
}
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, float4 v, int left) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
  if (left > 0) __stcs(p, v.x);
  if (left > 1) __stcs(p + 1, v.y);
  if (left > 2) __stcs(p + 2, v.z);
  if (left > 3) __stcs(p + 3, v.w);
}

// One decode step (T = 1) of the CTA's pairs pair0 .. pair0 + ppc - 1 (or of
// column slice blockIdx.x % slices of one pair).  Thread (pl, rl, cg), with
// tid = pl * tp + rl * gsp + cg, owns columns c0 .. c0 + 3 of pair pl and
// rows rl, rl + lanes, ...; it loads B (and C and S0) for kRowBatch rows
// before it stores the first of them, so a batch waits for one round trip.
// The threads of row lane 0 (lanes 0 .. gsp - 1 of the pair's first warp)
// write y from the registers they hold; that warp loads B and C for C . B
// before its stores and sums them after, so nothing waits on C . B but y.
// VEC: P % 4 == 0 and the state (and S0) start 16-byte aligned, so every
// row group is one float4.  S0: an initial state is given; only then do
// the threads meet at a barrier, to add their C . S0 partial sums.
template <typename T, bool VEC, bool S0>
__global__ void __launch_bounds__(kDecodeThreads, S0 ? 4 : 1)
    mamba_decode_kernel(DecodeParams p) {
  __shared__ float4 part[S0 ? kDecodeThreads : 1];  // C . S0 partial sums
  constexpr int kCb = kMaxDim / 32;                 // C and B values per lane
  const int tid = threadIdx.x, lane = tid % 32;
  const int N = p.N, P = p.P, H = p.H;
  const int tp = kDecodeThreads / p.ppc;  // threads per pair
  int gsp = 1;                            // groups, to a power of two
  while (gsp < p.gs) gsp <<= 1;
  const int lanes = tp / gsp;  // row lanes per pair
  const int slice = (int)(blockIdx.x % p.slices);
  const int pair0 = (int)(blockIdx.x / p.slices) * p.ppc;
  const int pl = tid / tp, cg = tid % tp % gsp, rl = tid % tp / gsp;
  const int bh = pair0 + pl;
  const bool first_warp = tid % tp < 32;  // the pair's C . B and y
  const int c0 = (slice * p.gs + cg) * 4;
  const bool live = bh < p.pairs && cg < p.gs && c0 < P;
  const int b = bh / H, h = bh % H;
  const T* __restrict__ xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + c0;
  const T* __restrict__ bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh;
  const T* __restrict__ cm = static_cast<const T*>(p.cm) + b * p.c_sb + h * p.c_sh;

  float cv[kCb], bv[kCb];  // this lane's share of C . B, loaded first
#pragma unroll
  for (int k = 0; k < kCb; ++k) {
    const int n = lane + 32 * k;
    const bool in = first_warp && bh < p.pairs && n < N;
    cv[k] = in ? to_f32(cm[n]) : 0.f;
    bv[k] = in ? to_f32(bm[n]) : 0.f;
  }

  float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f, decay = 0.f;
  float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // C . S0 over this thread's rows
  if (live) {
    const int left = P - c0;
    x0 = to_f32(xd[0]);
    x1 = left > 1 ? to_f32(xd[1]) : 0.f;
    x2 = left > 2 ? to_f32(xd[2]) : 0.f;
    x3 = left > 3 ? to_f32(xd[3]) : 0.f;
    if (S0) decay = expf(to_f32(static_cast<const T*>(p.da)[b * p.a_sb + h * p.a_sh]));
    float* __restrict__ sf = p.sf + (int64_t)bh * N * P + c0;
    const float* __restrict__ s0 = S0 ? p.s0 + (int64_t)bh * N * P + c0 : nullptr;
    for (int n0 = rl; n0 < N; n0 += lanes * kRowBatch) {
      float bn[kRowBatch], cn[kRowBatch];
      float4 v[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int n = n0 + i * lanes;
        const bool in = n < N;
        bn[i] = in ? to_f32(bm[n]) : 0.f;
        if (S0) {
          cn[i] = in ? to_f32(cm[n]) : 0.f;
          v[i] = in ? load4<VEC>(s0 + (int64_t)n * P, left)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int n = n0 + i * lanes;
        if (n >= N) break;
        float4 o = make_float4(bn[i] * x0, bn[i] * x1, bn[i] * x2, bn[i] * x3);
        if (S0) {
          cs.x = fmaf(cn[i], v[i].x, cs.x);
          cs.y = fmaf(cn[i], v[i].y, cs.y);
          cs.z = fmaf(cn[i], v[i].z, cs.z);
          cs.w = fmaf(cn[i], v[i].w, cs.w);
          o = make_float4(fmaf(bn[i], x0, decay * v[i].x), fmaf(bn[i], x1, decay * v[i].y),
                          fmaf(bn[i], x2, decay * v[i].z), fmaf(bn[i], x3, decay * v[i].w));
        }
        store4<VEC>(sf + (int64_t)n * P, o, left);
      }
    }
  }
  if (S0) {
    part[tid] = cs;
    __syncthreads();
  }
  if (!first_warp || bh >= p.pairs) return;

  // y = (C . B) xd + exp(da) (C . S0) for this thread's columns, by the
  // threads of row lane 0, the partial sums of C . S0 added in row-lane
  // order.
  float g = 0.f;
#pragma unroll
  for (int k = 0; k < kCb; ++k) g = fmaf(cv[k], bv[k], g);
  const float cb = warp_sum(g);
  if (live && rl == 0) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (S0) {
      for (int r = 0; r < lanes; ++r) {
        const float4 q = part[pl * tp + r * gsp + cg];
        acc[0] += q.x;
        acc[1] += q.y;
        acc[2] += q.z;
        acc[3] += q.w;
      }
    }
    const float x[4] = {x0, x1, x2, x3};
    T* y = static_cast<T*>(p.y) + (int64_t)bh * P + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < P) y[e] = from_f32<T>(fmaf(decay, acc[e], cb * x[e]));
  }
}

// f(kernel) for the decode kernel's instantiation of dtype, vec and s0.
template <typename T, typename F>
static int with_decode_t(bool vec, bool s0, F&& f) {
  if (vec)
    return s0 ? f(mamba_decode_kernel<T, true, true>)
              : f(mamba_decode_kernel<T, true, false>);
  return s0 ? f(mamba_decode_kernel<T, false, true>)
            : f(mamba_decode_kernel<T, false, false>);
}
template <typename F>
static int with_decode(int dtype, bool vec, bool s0, F&& f) {
  return dtype == 0 ? with_decode_t<__nv_bfloat16>(vec, s0, f)
                    : with_decode_t<float>(vec, s0, f);
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

// One decode step (T = 1) on the decode kernel.  dtype as above; y is
// (B, 1, H, P) and the state (B, H, N, P), both contiguous.  slices: column
// slices per pair (1 .. ceil(P / 4)); pairs_per_cta: 1, 2, 4 or 8, and 1
// when slices > 1.  Strides are in elements, (batch, head) for each input.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a geometry outside these).
extern "C" int repro_mamba_decode(
    const void* xd, const void* da, const void* bm, const void* cm,
    const float* s0, void* y, float* sf, int dtype, long long B, long long H,
    long long P, long long N, long long x_sb, long long x_sh, long long a_sb,
    long long a_sh, long long b_sb, long long b_sh, long long c_sb,
    long long c_sh, int slices, int pairs_per_cta, void* stream) {
  const long long groups = (P + 3) / 4;
  const int ppc = pairs_per_cta;
  if (N < 1 || P < 1 || N > repro_ms::kMaxDim || P > repro_ms::kMaxDim ||
      slices < 1 || slices > groups ||
      ppc < 1 || ppc > repro_ms::kMaxPairsPerCta || (ppc & (ppc - 1)) ||
      (slices > 1 && ppc != 1) ||
      B * H >= (1LL << 31) || (B * H + ppc - 1) / ppc * slices >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  repro_ms::DecodeParams p;
  p.xd = xd;
  p.da = da;
  p.bm = bm;
  p.cm = cm;
  p.s0 = s0;
  p.y = y;
  p.sf = sf;
  p.pairs = (int)(B * H);
  p.H = (int)H;
  p.P = (int)P;
  p.N = (int)N;
  p.slices = slices;
  p.ppc = ppc;
  p.gs = (int)((groups + slices - 1) / slices);
  p.x_sb = x_sb;
  p.x_sh = x_sh;
  p.a_sb = a_sb;
  p.a_sh = a_sh;
  p.b_sb = b_sb;
  p.b_sh = b_sh;
  p.c_sb = c_sb;
  p.c_sh = c_sh;
  const bool vec = P % 4 == 0 && reinterpret_cast<uintptr_t>(sf) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s0) % 16 == 0;
  const unsigned ctas = (unsigned)(((long long)p.pairs + ppc - 1) / ppc * slices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return repro_ms::with_decode(dtype, vec, s0 != nullptr, [&](auto kernel) {
    kernel<<<ctas, repro_ms::kDecodeThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  });
}

// The residency of the decode kernel's instantiation (vec: 16-byte rows; s0:
// with an initial state): CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its static shared
// memory per CTA.  Returns the cudaError_t of the queries.
extern "C" int repro_mamba_decode_occupancy(int dtype, int vec, int s0,
                                            int* blocks, int* smem_bytes) {
  return repro_ms::with_decode(dtype, vec != 0, s0 != 0, [&](auto kernel) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *smem_bytes = (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro_ms::kDecodeThreads, 0);
  });
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
