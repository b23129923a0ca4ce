// Flash attention forward: out = softmax(scale * q . k^T + mask) . v, with
// an online softmax over the kv sweep (m, l, acc in f32).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:23
// `_flash_kernel` (launched by `flash_attention_pallas`, :129).  That
// kernel runs a (B*Hq, q blocks, kv blocks) grid with kv sequential and the
// softmax state in VMEM scratch, reads K/V per q head through its index
// map (GQA), pads q to bq rows and S to bkv keys, and skips kv blocks
// wholly past the causal or window frontier (:77-84).
//
// What bounds it on an H100: bytes.  The serving path's member is a decode
// step (Sq = 1): each query row reads the whole K and V cache of its head
// once and does ~2 FLOPs per cached element read per row, far below the
// card's ~295 operations per byte.  So the design reads every K/V element
// of a kv head once per CTA and keeps many bytes in flight:
//   - one CTA per (batch, kv head, q block, sub-tile of kRows query rows).
//     The rows of a CTA are the rep = Hq/Hkv query heads of its kv head
//     times the q block's real positions (head-major), so the GQA heads
//     that share a K/V load share it in one CTA: for Qwen3-14B's decode
//     member (rep 5) one CTA holds 5 rows and reads its head's 2 MiB of
//     K+V once, instead of 5 CTAs reading it 5 times.  Only real query
//     rows are computed: decode (Sq = 1) has no padded rows;
//   - the kv range is cut to the bkv blocks the CTA's rows can see (the
//     Pallas kernel's block skip), and swept in sub-tiles of KS keys (64
//     in bf16, 32 in f32) staged through dynamic shared memory as f32: a
//     512 x 128 bf16 K block alone is 128 KB, so a bkv block is several
//     sub-tiles.  Each thread loads its share of the next sub-tile into
//     registers (16-byte loads where aligned) while the CTA computes on
//     the current one;
//   - q, k and v are read through their strides (last dim contiguous), in
//     the layout the op receives: nothing is padded or copied.  dv may
//     differ from dqk (MLA): V is read at its own width;
//   - masks are explicit: a key past S, past the causal frontier
//     (q_offset + row position) or outside the window gets weight 0.  A
//     row that sees no key writes 0 (l = 0 is read as 1, as :88-92 does);
//     the serving path never has one.
// Scores and the PV product run as f32 FMAs on the CUDA cores; wgmma and
// TMA are later work.
//
// Plain C interface, loaded with ctypes by kernels/flash_attention/kernel.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_fa {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 16;      // query rows per CTA
constexpr float kNeg = -1e30f;     // running-max start, as the Pallas body's
constexpr float kMasked = -3e38f;  // score of a masked key (weight 0)

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
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int64_t B, Hq, Hkv, T, S, D, Dv;
  int64_t q_sb, q_sh, q_st;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t window, q_offset, bq, bkv;
  float scale;
  int causal;
};

template <typename T>
struct Geom {
  static constexpr int KS = sizeof(T) == 2 ? 64 : 32;  // keys per sub-tile
};

template <int DMAX, int KS>
constexpr size_t smem_bytes() {
  return (size_t)((kRows + 2 * KS) * (DMAX + 1) + kRows * (KS + 1) +
                  3 * kRows) * sizeof(float);
}

// A KS x DMAX sub-tile of a strided (rows, cols) matrix into registers as
// 16-byte chunks; rows >= `rows` and cols >= `cols` read as zero.
template <typename T, int DMAX, int KS>
struct SubTile {
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                         unsigned int>::type;
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int CPR = DMAX / VEC;
  static constexpr int PER = KS * CPR / kThreads;
  static_assert((KS * CPR) % kThreads == 0, "chunks divide among threads");

  uint4 regs[PER];

  __device__ __forceinline__ void load(const T* __restrict__ src, int64_t ld,
                                       int64_t rows, int64_t cols) {
    const Bits* bits = reinterpret_cast<const Bits*>(src);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int chunk = threadIdx.x + j * kThreads;
      const int64_t r = chunk / CPR;
      const int64_t c = (int64_t)(chunk % CPR) * VEC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < cols) {
        const Bits* p = bits + r * ld + c;
        if (c + VEC <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          v = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          Bits* vb = reinterpret_cast<Bits*>(&v);
#pragma unroll
          for (int e = 0; e < VEC; ++e) vb[e] = (c + e < cols) ? p[e] : Bits(0);
        }
      }
      regs[j] = v;
    }
  }

  // Converted to f32 into shared memory with row stride DMAX + 1.
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int chunk = threadIdx.x + j * kThreads;
      const int r = chunk / CPR;
      const int c = (chunk % CPR) * VEC;
      const T* vals = reinterpret_cast<const T*>(&regs[j]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dst[r * (DMAX + 1) + c + e] = to_f32(vals[e]);
    }
  }
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int KS = Geom<T>::KS;
  constexpr int LD = DMAX + 1;
  constexpr int PLD = KS + 1;
  constexpr int NACC = kRows * DMAX / kThreads;
  static_assert((kRows * DMAX) % kThreads == 0, "accumulators divide");
  extern __shared__ float smem[];
  float* Qs = smem;               // kRows x LD, scaled q rows
  float* Ks = Qs + kRows * LD;    // KS x LD
  float* Vs = Ks + KS * LD;       // KS x LD
  float* Ps = Vs + KS * LD;       // kRows x PLD, scores then weights
  float* m_s = Ps + kRows * PLD;  // running max per row
  float* l_s = m_s + kRows;       // running sum per row
  float* a_s = l_s + kRows;       // this sub-tile's rescale per row
  __shared__ int64_t head_s[kRows], t_s[kRows], qpos_s[kRows];

  const int tid = threadIdx.x;
  const int64_t rep = p.Hq / p.Hkv;
  const int64_t b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int64_t q0 = (int64_t)blockIdx.y * p.bq;
  const int64_t nq = p.T - q0 < p.bq ? p.T - q0 : p.bq;
  const int64_t row0 = (int64_t)blockIdx.z * kRows;
  if (row0 >= rep * nq) return;  // the last q block has fewer rows
  const int n_rows =
      (int)(rep * nq - row0 < kRows ? rep * nq - row0 : (int64_t)kRows);

  if (tid < kRows) {
    const int64_t idx = row0 + tid;
    head_s[tid] = hk * rep + idx / nq;
    t_s[tid] = q0 + idx % nq;
    qpos_s[tid] = t_s[tid] + p.q_offset;
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < kRows * DMAX; i += kThreads) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (r < n_rows && d < p.D)
      x = to_f32(q[b * p.q_sb + head_s[r] * p.q_sh + t_s[r] * p.q_st + d]) *
          p.scale;
    Qs[r * LD + d] = x;
  }

  // The bkv blocks any row of this CTA can see (the Pallas block skip).
  int64_t qmin = qpos_s[0], qmax = qpos_s[0];
  for (int r = 1; r < n_rows; ++r) {
    qmin = qpos_s[r] < qmin ? qpos_s[r] : qmin;
    qmax = qpos_s[r] > qmax ? qpos_s[r] : qmax;
  }
  int64_t kv_lo = 0, kv_hi = p.S;
  if (p.causal) {
    const int64_t hi = qmax < 0 ? 0 : (qmax / p.bkv + 1) * p.bkv;
    kv_hi = hi < p.S ? hi : p.S;
  }
  if (p.window) {
    const int64_t first = qmin - p.window + 1;  // first key qmin sees
    kv_lo = first > 0 ? first / p.bkv * p.bkv : 0;
  }

  const T* kbase = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vbase = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  SubTile<T, DMAX, KS> kt, vt;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (kv_lo < kv_hi) {
    kt.load(kbase + kv_lo * p.k_ss, p.k_ss, kv_hi - kv_lo, p.D);
    vt.load(vbase + kv_lo * p.v_ss, p.v_ss, kv_hi - kv_lo, p.Dv);
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int64_t kv0 = kv_lo; kv0 < kv_hi; kv0 += KS) {
    __syncthreads();  // the previous sub-tile is no longer read
    kt.store(Ks);
    vt.store(Vs);
    __syncthreads();
    const int64_t nxt = kv0 + KS;
    if (nxt < kv_hi) {  // in flight while this sub-tile is computed
      kt.load(kbase + nxt * p.k_ss, p.k_ss, kv_hi - nxt, p.D);
      vt.load(vbase + nxt * p.v_ss, p.v_ss, kv_hi - nxt, p.Dv);
    }

    for (int i = tid; i < n_rows * KS; i += kThreads) {
      const int r = i / KS, j = i % KS;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + j * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DMAX; ++d) s = fmaf(qr[d], kr[d], s);
      const int64_t kpos = kv0 + j, qp = qpos_s[r];
      bool ok = kpos < p.S;
      if (p.causal) ok = ok && qp >= kpos;
      if (p.window) ok = ok && qp - kpos < p.window;
      Ps[r * PLD + j] = ok ? s : kMasked;
    }
    __syncthreads();

    for (int r = warp; r < n_rows; r += kThreads / 32) {
      float mx = kNeg;
      for (int j = lane; j < KS; j += 32) mx = fmaxf(mx, Ps[r * PLD + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < KS; j += 32) {
        const float s = Ps[r * PLD + j];
        const float w = s == kMasked ? 0.f : expf(s - m_new);
        Ps[r * PLD + j] = w;
        sum += w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / DMAX, c = idx % DMAX;
      if (r < n_rows) {
        const float* pr = Ps + r * PLD;
        float a = acc[i] * a_s[r];
#pragma unroll 8
        for (int j = 0; j < KS; ++j) a = fmaf(pr[j], Vs[j * LD + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / DMAX, c = idx % DMAX;
    if (r < n_rows && c < p.Dv) {
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[((b * p.Hq + head_s[r]) * p.T + t_s[r]) * p.Dv + c] =
          from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int DMAX>
static int launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX, Geom<T>::KS>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t rep = p.Hq / p.Hkv;
  const int64_t rows = rep * (p.bq < p.T ? p.bq : p.T);
  dim3 grid((unsigned)(p.B * p.Hkv), (unsigned)((p.T + p.bq - 1) / p.bq),
            (unsigned)((rows + kRows - 1) / kRows));
  flash_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
static int by_width(int dmax, const Params& p, cudaStream_t s) {
  if (dmax == 64) return launch<T, 64>(p, s);
  if (dmax == 128) return launch<T, 128>(p, s);
  if (dmax == 256) return launch<T, 256>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace repro_fa

// dtype: 0 = bf16, 1 = f32; dmax: 64, 128 or 256, at least max(D, Dv).
// Strides are in elements; the last dim of q, k and v is contiguous.  out is
// a contiguous (B, Hq, T, Dv) tensor of q's dtype.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int dmax, long long B, long long Hq, long long Hkv, long long T,
    long long S, long long D, long long Dv, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int causal,
    long long window, long long q_offset, float scale, long long bq,
    long long bkv, void* stream) {
  repro_fa::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.T = T;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.window = window;
  p.q_offset = q_offset;
  p.bq = bq;
  p.bkv = bkv;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? repro_fa::by_width<__nv_bfloat16>(dmax, p, s)
                    : repro_fa::by_width<float>(dmax, p, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
