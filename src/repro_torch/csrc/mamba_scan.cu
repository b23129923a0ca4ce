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
// Two routes compute it, chosen by shape alone
// (kernels/mamba_scan/kernel.py:scan_route): `mamba_decode_kernel` for a
// decode step (T = 1), the chunked form (`ssd_state_kernel`,
// `ssd_carry_kernel`, `ssd_output_kernel`) for every other T.  Both read xd
// (B,T,H,P), da (B,T,H) and B/C (B,T,H,N) through their strides in bf16 or
// f32, so a Mamba2 group-shared B/C can be a broadcast view (head stride 0)
// and nothing is transposed, padded or copied.
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
// The chunked form, for every other T.  Walking a head's chunks in order,
// as the TPU's sequential grid axis does, leaves one CTA per (batch, head)
// on the card (64 CTAs on 132 SMs for Zamba2's 64 heads at batch 1) and
// the whole sequence in one chain.  Here the chunks run in parallel, in
// three launches on the launching stream (the chunked form of state-space
// duality):
//   1. `ssd_state_kernel`, a CTA per (batch, chunk, head group, 64 state
//      rows): s = cumsum(da) and the chunk's local end state
//      S_loc = B^T . (exp(s_L - s) o xd) into an f32 workspace
//      (B, H, chunks, N, P), exp(s_L) into a (B, H, chunks) one;
//   2. `ssd_carry_kernel`, a thread per (batch, head, 4 state elements):
//      S_c = exp(s_L,c) S_{c-1} + S_loc,c from s0 (or zero), the chunks in
//      order with the loads of kCarryAhead chunks issued ahead of the
//      chain; each chunk's slot is overwritten with its incoming state
//      S_{c-1}, and the final state is written;
//   3. `ssd_output_kernel`, a CTA of 8 warps per (batch, chunk, 128-row
//      block, head group): Y = (C . B^T o exp(s_i - s_j) [i >= j]) . xd
//      + exp(s) o (C . S_{c-1}), staged in shared memory and written in
//      16-byte rows.
// The workspace comes from PyTorch's caching allocator on the launching
// stream (kernels/mamba_scan/kernel.py); nothing is allocated here.  Three
// launches and not one with a look-back: the carry is a short chain of
// elementwise FMAs, and separate passes need no spin, ticket or flag.
//
// What bounds it is bytes: the function moves xd, y and B/C once (69.7 MB
// for Zamba2's 4,096-token prompt), the workspace adds 4 x 33.5 MB, and
// the products (about L (N + P) multiply-adds per element of y) sit far
// below the tensor cores' rate; on the card the output pass's loads,
// products and stores, in series at two CTAs per SM, hold it well above
// that bound (PERF.md section 6).  The products run on the tensor cores,
// as mma.sync m16n8k16 (bf16 operands, f32 accumulation) fed by ldmatrix:
//   - C . B^T is one mma per tile: bf16 C and B multiply exactly;
//   - each product with one f32 operand (W = C . B^T o decay against xd,
//     B^T o exp(s_L - s) against xd, C against S_prev) splits it into
//     hi = bf16(x) and lo = bf16(x - hi) and issues two mmas: about 2^-17
//     relative error per term, where one bf16 rounding (2^-9) would spend
//     the scan's 3e-4 tolerance;
//   - f32 inputs (dtype 1) split both operands: hi.hi + hi.lo + lo.hi;
//   - when B and C are head-broadcast views (head stride 0, Mamba2's
//     group-shared layout), P <= 64 and the inputs are bf16, a CTA takes
//     two heads, loads B and C once and computes C . B^T once for both;
//     each head's decay scales the shared tile in registers.
// Staging: bf16 rows go to shared memory by cp.async (16-byte chunks;
// element loads where a row is not 16-byte aligned), f32 rows through
// registers as hi and lo planes; N and P are padded to multiples of 16
// with zeros and rows past T read as zero; the j rows run in 64-row blocks
// through a two-stage ring, so an L = 512 chunk never sits in shared
// memory whole; the i < j half and rows past T are masked explicitly, and
// no exp(-inf) is computed.
//
// Plain C interface, loaded with ctypes by kernels/mamba_scan/kernel.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "tma.cuh"

namespace repro_ms {

using namespace repro;  // cp.async staging, ldmatrix and mma.sync
using bf16 = __nv_bfloat16;

constexpr int kMaxDim = 128;   // N and P of the narrow instantiations
constexpr int kMaxWide = 512;  // N and P capacity (the wide chunked form)
constexpr int kMaxL = 512;     // chunk length capacity

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

// ------------------------------------------------------------ chunked form
constexpr int kChunkThreads = 128;  // state pass: 4 warps of 16 state rows
constexpr int kBlk = 64;            // rows of a j block and of a state block
constexpr int kOutWarps = 8;        // output pass: 8 warps of 16 rows
constexpr int kOutThreads = 32 * kOutWarps;
constexpr int kOutRows = 16 * kOutWarps;  // rows of an output CTA
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kCarryThreads = 256;
constexpr int kCarryAhead = 8;      // chunks whose loads issue ahead of the chain

struct ChunkParams {
  const void* xd;
  const void* da;
  const void* bm;
  const void* cm;
  const float* s0;  // (B, H, N, P) f32, or null for a zero state
  void* y;          // (B, T, H, P), xd's dtype
  float* sf;        // (B, H, N, P) f32
  float* ws;        // (B, H, nc, N, P) f32: S_loc, then the incoming state
  float* decay;     // (B, H, nc) f32: exp(s_L) of each chunk
  int64_t T;
  int B, H, P, N, L;
  int nc;       // chunks, ceil(T / L)
  int Np, Pp;   // N and P padded to multiples of 16
  int Lp;       // L padded to a multiple of kBlk: the cumsum rows kept
  int groups;   // head groups of hpc heads, H / hpc
  int rblocks;  // kOutRows-row blocks of a chunk
  int mblocks;  // 64-row blocks of the state (Np rows)
  int eblocks;  // carry CTAs per (batch, head), 4 state elements a thread
  int carry_vec;  // 16-byte carry accesses: N * P % 4 == 0, s0 and sf aligned
  int pblocks;    // kColBlk-column blocks of P a wide CTA takes (1 when narrow)
  int64_t x_sb, x_st, x_sh;
  int64_t a_sb, a_st, a_sh;
  int64_t b_sb, b_st, b_sh;
  int64_t c_sb, c_st, c_sh;
};

// Bytes of dynamic shared memory of the two tensor-core passes (s2: 1 for
// bf16 inputs, 2 for f32 ones, whose rows take a hi and a lo plane).  A
// ring stage holds B's 64 j rows, then each head's xd rows; the output
// pass keeps its kOutRows C rows, and holds each head's S_prev (hi and lo
// planes) where the ring's second stage goes once S_prev is read, so that
// the first stage loads beside it; its y tile is staged in the ring at the
// end.  Both end with hpc rows of Lp f32.
inline size_t ring_stage(int s2, int hpc, int Np, int Pp) {
  return (size_t)s2 * kBlk * (Np + 8) + (size_t)hpc * s2 * kBlk * (Pp + 8);
}
inline size_t state_smem(int s2, int hpc, int Np, int Pp, int Lp) {
  return 2 * ring_stage(s2, hpc, Np, Pp) * 2 + (size_t)hpc * Lp * 4;
}
inline size_t output_smem(int s2, int hpc, int Np, int Pp, int Lp) {
  const size_t sprev = (size_t)hpc * 2 * Np * (Pp + 8);
  const size_t stage = ring_stage(s2, hpc, Np, Pp);
  return ((size_t)s2 * kOutRows * (Np + 8) + stage + (sprev > stage ? sprev : stage)) * 2 +
         (size_t)hpc * Lp * 4;
}

// Two f32 values as a bf16x2 high part and the bf16x2 of what it leaves
// out.
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<unsigned*>(&h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  lo = *reinterpret_cast<unsigned*>(&l);
}

// Rows 0 .. NROWS - 1 of a (rows, cols) slice `src` (row stride st
// elements; rows past `rows` and columns past `cols`, up to `width`, read
// as zero) into shared memory `dst` with row stride ld, as bf16, by NT
// threads: bf16 rows by cp.async (element loads where a row is not
// 16-byte aligned), f32 rows through registers as a hi plane (dst) and a
// lo plane (dst + plane), the loads of kBatch groups issued first.
template <typename T, int NT, int NROWS = kBlk>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, int plane,
                                           const T* __restrict__ src, int64_t st,
                                           int rows, int cols, int width) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int cpr = width / 8;
    for (int i = threadIdx.x; i < NROWS * cpr; i += NT) {
      const int r = i / cpr, c = (i % cpr) * 8;
      copy_chunk<bf16>(dst + r * ld + c, src, st, r, c, rows, cols);
    }
  } else {
    constexpr int kBatch = 4;
    const int gpr = width / 4;  // 4-column groups of a row
    for (int g0 = threadIdx.x; g0 < NROWS * gpr; g0 += kBatch * NT) {
      float4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int g = g0 + k * NT, r = g / gpr, c = g % gpr * 4;
        v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < NROWS * gpr && r < rows && c < cols) {
          const float* q = src + r * st + c;
          if (c + 4 <= cols && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
            v[k] = *reinterpret_cast<const float4*>(q);
          } else {
            v[k].x = q[0];
            if (c + 1 < cols) v[k].y = q[1];
            if (c + 2 < cols) v[k].z = q[2];
            if (c + 3 < cols) v[k].w = q[3];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int g = g0 + k * NT, r = g / gpr, c = g % gpr * 4;
        if (g < NROWS * gpr) {
          unsigned h0, l0, h1, l1;
          split_pair(v[k].x, v[k].y, h0, l0);
          split_pair(v[k].z, v[k].w, h1, l1);
          *reinterpret_cast<uint2*>(dst + r * ld + c) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(dst + plane + r * ld + c) = make_uint2(l0, l1);
        }
      }
    }
  }
}

// The chunk's j rows r0 .. r0 + 63 (rows past Lr zero) into a ring stage
// `st` by NT threads: B's rows (S2 planes of bplane), then each head's xd
// rows (S2 planes of xplane each); commits one cp.async group.
template <typename T, int HPC, int NT>
__device__ __forceinline__ void stage_jblock(bf16* st, const ChunkParams& p,
                                             const T* bm, const T* xd, int r0, int Lr,
                                             int bplane, int xplane) {
  constexpr int S2 = std::is_same<T, float>::value ? 2 : 1;
  const int rows = Lr - r0 < kBlk ? Lr - r0 : kBlk;
  stage_rows<T, NT>(st, p.Np + 8, bplane, bm + r0 * p.b_st, p.b_st, rows, p.N, p.Np);
  for (int h = 0; h < HPC; ++h)
    stage_rows<T, NT>(st + S2 * bplane + h * S2 * xplane, p.Pp + 8, xplane,
                      xd + h * p.x_sh + r0 * p.x_st, p.x_st, rows, p.P, p.Pp);
  cp_async_commit();
}

// The inclusive cumsum of da over the chunk's rows 0 .. n - 1 for the
// CTA's heads h0 .. h0 + HPC - 1, times `scale`, into s[h * Lp + j], warp h
// for head h0 + h; every load is issued before the first sum.  Returns
// s_{n-1} (unscaled) to the lanes of those warps (lanes past n add zero).
template <typename T, int HPC>
__device__ __forceinline__ float cumsum_da(const ChunkParams& p, float* s,
                                           int64_t b, int h0, int64_t t0, int n,
                                           float scale = 1.f) {
  constexpr int kLoads = kMaxL / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float carry = 0.f;
  if (warp < HPC) {
    const T* da = static_cast<const T*>(p.da) + b * p.a_sb +
                  (int64_t)(h0 + warp) * p.a_sh + t0 * p.a_st;
    float v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = k * 32 + lane;
      v[k] = j < n ? to_f32(da[(int64_t)j * p.a_st]) : 0.f;
    }
    float* sh = s + warp * p.Lp;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (k * 32 < n) {
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v[k], o);
          if (lane >= o) v[k] += u;
        }
        v[k] += carry;
        if (k * 32 + lane < n) sh[k * 32 + lane] = v[k] * scale;
        carry = __shfl_sync(0xffffffffu, v[k], 31);
      }
    }
  }
  return carry;
}

// An (Np, Pp) f32 matrix, rows of P floats (zero past N rows and P
// columns), into shared memory as a bf16 hi plane (dst, row stride ld)
// and a lo plane (dst + plane) by NT threads, 4 columns a thread; 16-byte
// loads where P % 4 == 0, the loads of kBatch groups issued before their
// stores.
template <int NT>
__device__ __forceinline__ void stage_split(bf16* dst, int ld, int plane,
                                            const float* __restrict__ src, int N,
                                            int P, int Np, int Pp) {
  constexpr int kBatch = 8;
  const int gpr = Pp / 4, groups = Np * gpr;
  const bool vec = P % 4 == 0;
  for (int g0 = threadIdx.x; g0 < groups; g0 += kBatch * NT) {
    float4 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int g = g0 + k * NT, n = g / gpr, c = g % gpr * 4;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < groups && n < N && c < P) {
        const float* q = src + n * P + c;
        if (vec) {
          v[k] = *reinterpret_cast<const float4*>(q);
        } else {
          v[k].x = q[0];
          if (c + 1 < P) v[k].y = q[1];
          if (c + 2 < P) v[k].z = q[2];
          if (c + 3 < P) v[k].w = q[3];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int g = g0 + k * NT, n = g / gpr, c = g % gpr * 4;
      if (g < groups) {
        unsigned h0, l0, h1, l1;
        split_pair(v[k].x, v[k].y, h0, l0);
        split_pair(v[k].z, v[k].w, h1, l1);
        *reinterpret_cast<uint2*>(dst + n * ld + c) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(dst + plane + n * ld + c) = make_uint2(l0, l1);
      }
    }
  }
}

// A bf16x2 pair (plus its lo pair for f32 inputs) times (d.x, d.y), split
// as split_pair splits.
template <bool SPLIT>
__device__ __forceinline__ void scale_split(unsigned x, unsigned xl, float2 d,
                                            unsigned& hi, unsigned& lo) {
  float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  if (SPLIT) {
    const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xl));
    f.x += g.x;
    f.y += g.y;
  }
  split_pair(f.x * d.x, f.y * d.y, hi, lo);
}

// Columns col, col + 1 of row `row` of a row-major (rows, cols) f32 matrix.
__device__ __forceinline__ void store_f32_pair(float* m, int rows, int cols, int row,
                                               int col, float v0, float v1) {
  if (row >= rows || col >= cols) return;
  float* q = m + (int64_t)row * cols + col;
  if (col + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<float2*>(q) = make_float2(v0, v1);
  } else {
    q[0] = v0;
    if (col + 1 < cols) q[1] = v1;
  }
}

// Columns col, col + 1 of a row of y (P columns).
template <typename T>
__device__ __forceinline__ void store_y_pair(T* row, int col, int P, float v0, float v1) {
  if (col >= P) return;
  if (col + 1 < P && P % 2 == 0) {
    if constexpr (std::is_same<T, bf16>::value)
      *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
  } else {
    row[col] = from_f32<T>(v0);
    if (col + 1 < P) row[col + 1] = from_f32<T>(v1);
  }
}

// Pass 1: the local end state of one chunk for HPC heads, state rows
// mb * 64 .. mb * 64 + 63 (warp w: 16 of them), every column:
// S_loc = (B^T o exp(s_L - s)) . xd, K = the chunk's rows in 64-row
// blocks.  The A operand is B^T (ldmatrix.trans of B's rows), scaled by
// each head's decay in registers and split into hi and lo; xd is the B
// operand (bf16 exactly, or hi and lo planes).
template <typename T, int HPC, int PT>
__global__ void __launch_bounds__(kChunkThreads) ssd_state_kernel(ChunkParams p) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S2 = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = p.Np + 8, ldp = p.Pp + 8;
  const int bplane = kBlk * ldn, xplane = kBlk * ldp;
  const int stage_elems = S2 * bplane + HPC * S2 * xplane;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* dec = reinterpret_cast<float*>(ring + 2 * stage_elems);  // [HPC][Lp]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane / 8, r8 = lane % 8, tig = lane % 4, grp = lane / 4;
  int idx = blockIdx.x;
  const int mb = idx % p.mblocks;
  idx /= p.mblocks;
  const int g = idx % p.groups;
  idx /= p.groups;
  const int c = idx % p.nc;
  const int64_t b = idx / p.nc;
  const int h0 = g * HPC;
  const int64_t t0 = (int64_t)c * p.L;
  const int Lr = (int)(p.T - t0 < p.L ? p.T - t0 : p.L);
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h0 * p.b_sh + t0 * p.b_st;
  const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h0 * p.x_sh + t0 * p.x_st;

  const int njb = (Lr + kBlk - 1) / kBlk;
  auto stage = [&](int jb) {
    stage_jblock<T, HPC, kChunkThreads>(ring + (jb & 1) * stage_elems, p, bm, xd, jb * kBlk,
                                        Lr, bplane, xplane);
  };
  stage(0);

  // dec[h][j] = exp(s_L - s_j) for the chunk's rows, 0 past them; each
  // lane rewrites only the rows it scanned.
  const float last = cumsum_da<T, HPC>(p, dec, b, h0, t0, Lr);
  if (warp < HPC) {
    float* dh = dec + warp * p.Lp;
    for (int j = lane; j < p.Lp; j += 32) dh[j] = j < Lr ? expf(last - dh[j]) : 0.f;
    if (mb == 0 && lane == 0) p.decay[(b * p.H + h0 + warp) * p.nc + c] = expf(last);
  }

  float acc[HPC][PT][4];
#pragma unroll
  for (int h = 0; h < HPC; ++h)
#pragma unroll
    for (int t = 0; t < PT; ++t) acc[h][t][0] = acc[h][t][1] = acc[h][t][2] = acc[h][t][3] = 0.f;
  const int m0 = mb * kBlk + warp * 16;  // this warp's state rows
  const bool live = m0 < p.Np;
  const int pt = p.Pp / 8;

  for (int jb = 0; jb < njb; ++jb) {
    if (jb + 1 < njb) {
      stage(jb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block jb (and, at jb = 0, dec) is in
    const bf16* Bb = ring + (jb & 1) * stage_elems;
    const bf16* Xb = Bb + S2 * bplane;
    const int kend = Lr - jb * kBlk < kBlk ? Lr - jb * kBlk : kBlk;
    if (live) {
      for (int kk = 0; kk < kend; kk += 16) {
        // A = B^T (16 state rows x 16 j): matrices (j kk, n m0), (j kk, n m0 + 8),
        // (j kk + 8, n m0), (j kk + 8, n m0 + 8).
        unsigned a[4], al[4] = {0u, 0u, 0u, 0u};
        const bf16* pa = Bb + (kk + r8 + (q >> 1) * 8) * ldn + m0 + (q & 1) * 8;
        ldsm_x4_t(a[0], a[1], a[2], a[3], pa);
        if (SPLIT) ldsm_x4_t(al[0], al[1], al[2], al[3], pa + bplane);
        const int j = jb * kBlk + kk + tig * 2;  // a0/a1: j, j + 1; a2/a3: + 8
#pragma unroll
        for (int h = 0; h < HPC; ++h) {
          const float2 d0 = *reinterpret_cast<const float2*>(dec + h * p.Lp + j);
          const float2 d8 = *reinterpret_cast<const float2*>(dec + h * p.Lp + j + 8);
          unsigned ah[4], alo[4];
          scale_split<SPLIT>(a[0], al[0], d0, ah[0], alo[0]);
          scale_split<SPLIT>(a[1], al[1], d0, ah[1], alo[1]);
          scale_split<SPLIT>(a[2], al[2], d8, ah[2], alo[2]);
          scale_split<SPLIT>(a[3], al[3], d8, ah[3], alo[3]);
          const bf16* xh = Xb + h * S2 * xplane;
#pragma unroll
          for (int nt = 0; nt < PT; nt += 2) {
            if (nt < pt) {
              // xd (16 j x 16 p): matrices (j kk, p nt), (j kk + 8, p nt),
              // (j kk, p nt + 1), (j kk + 8, p nt + 1).
              const int off = (kk + r8 + (q & 1) * 8) * ldp + (nt + (q >> 1)) * 8;
              unsigned bx[4];
              ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], xh + off);
              mma_bf16(acc[h][nt], ah, bx[0], bx[1]);
              mma_bf16(acc[h][nt], alo, bx[0], bx[1]);
              mma_bf16(acc[h][nt + 1], ah, bx[2], bx[3]);
              mma_bf16(acc[h][nt + 1], alo, bx[2], bx[3]);
              if (SPLIT) {
                ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], xh + xplane + off);
                mma_bf16(acc[h][nt], ah, bx[0], bx[1]);
                mma_bf16(acc[h][nt + 1], ah, bx[2], bx[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // block jb is read: its stage takes block jb + 2
  }

  if (!live) return;
#pragma unroll
  for (int h = 0; h < HPC; ++h) {
    float* out = p.ws + ((b * p.H + h0 + h) * p.nc + c) * (int64_t)p.N * p.P;
#pragma unroll
    for (int nt = 0; nt < PT; ++nt) {
      if (nt < pt) {
        const int col = nt * 8 + tig * 2;
        store_f32_pair(out, p.N, p.P, m0 + grp, col, acc[h][nt][0], acc[h][nt][1]);
        store_f32_pair(out, p.N, p.P, m0 + grp + 8, col, acc[h][nt][2], acc[h][nt][3]);
      }
    }
  }
}

// Pass 2: per (batch, head), 4 state elements a thread, the chunks in
// order: slot c of the workspace becomes the state entering chunk c, and
// the state after the last chunk is the final state.  The loads of
// kCarryAhead chunks issue before their FMAs; 16-byte accesses when
// N * P % 4 == 0 and s0 and sf are 16-byte aligned (p.carry_vec).
__device__ __forceinline__ float4 carry_load(const float* q, int n, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(q);
  float4 v = make_float4(q[0], 0.f, 0.f, 0.f);
  if (n > 1) v.y = q[1];
  if (n > 2) v.z = q[2];
  if (n > 3) v.w = q[3];
  return v;
}
__device__ __forceinline__ void carry_store(float* q, float4 v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(q) = v;
    return;
  }
  q[0] = v.x;
  if (n > 1) q[1] = v.y;
  if (n > 2) q[2] = v.z;
  if (n > 3) q[3] = v.w;
}

__global__ void __launch_bounds__(kCarryThreads) ssd_carry_kernel(ChunkParams p) {
  const int64_t NP = (int64_t)p.N * p.P;
  const int64_t bh = blockIdx.x / p.eblocks;
  const int64_t e = ((int64_t)(blockIdx.x % p.eblocks) * kCarryThreads + threadIdx.x) * 4;
  if (e >= NP) return;
  const int n = NP - e < 4 ? (int)(NP - e) : 4;
  const bool vec = p.carry_vec && n == 4;
  float* w = p.ws + bh * p.nc * NP + e;
  const float* dec = p.decay + bh * p.nc;
  float4 S = p.s0 ? carry_load(p.s0 + bh * NP + e, n, vec) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += kCarryAhead) {
    float4 loc[kCarryAhead];
    float d[kCarryAhead];
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      if (c0 + i < p.nc) {
        loc[i] = carry_load(w + (c0 + i) * NP, n, vec);
        d[i] = dec[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      if (c0 + i < p.nc) {
        carry_store(w + (c0 + i) * NP, S, n, vec);
        S = make_float4(fmaf(d[i], S.x, loc[i].x), fmaf(d[i], S.y, loc[i].y),
                        fmaf(d[i], S.z, loc[i].z), fmaf(d[i], S.w, loc[i].w));
      }
    }
  }
  carry_store(p.sf + bh * NP + e, S, n, vec);
}

// Pass 3: rows i0 .. i0 + 127 of one chunk's y for HPC heads (warp w: 16
// of them).  First C . S_prev per head (S_prev from the workspace as hi
// and lo planes), scaled by exp(s_i); then, per 64-row j block up to the
// diagonal and 16 j at a time, G = C . B^T once for the CTA's heads, and
// per head W = G o exp(s_i - s_j) [i >= j] (in registers, split into hi
// and lo) times xd.  16-j steps wholly above a warp's last row are
// skipped.  The cumsums are kept times log2(e), so each decay is one
// exp2.  y is staged in shared memory and written in 16-byte rows.
template <typename T, int HPC, int PT>
__global__ void __launch_bounds__(kOutThreads, 2) ssd_output_kernel(ChunkParams p) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S2 = SPLIT ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldn = p.Np + 8, ldp = p.Pp + 8;
  const int bplane = kBlk * ldn, xplane = kBlk * ldp, cplane = kOutRows * ldn;
  const int stage_elems = S2 * bplane + HPC * S2 * xplane;
  const int sprev = p.Np * ldp;  // one plane of one head's S_prev
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // S2 planes of the block's C rows
  bf16* U = Cs + S2 * cplane;                // the ring's two stages
  bf16* Sp = U + stage_elems;                // S_prev planes, in stage 1's place
  const int u_elems = stage_elems + (HPC * 2 * sprev > stage_elems ? HPC * 2 * sprev
                                                                   : stage_elems);
  float* sc = reinterpret_cast<float*>(U + u_elems);  // [HPC][Lp] cumsum x log2(e)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane / 8, r8 = lane % 8, tig = lane % 4, grp = lane / 4;
  int idx = blockIdx.x;
  const int g = idx % p.groups;
  idx /= p.groups;
  const int rb = idx % p.rblocks;
  idx /= p.rblocks;
  const int c = idx % p.nc;
  const int64_t b = idx / p.nc;
  const int h0 = g * HPC;
  const int64_t t0 = (int64_t)c * p.L;
  const int Lr = (int)(p.T - t0 < p.L ? p.T - t0 : p.L);
  const int i0 = rb * kOutRows;
  if (i0 >= Lr) return;  // a row block past a short last chunk
  const int rmax = i0 + kOutRows < Lr ? i0 + kOutRows : Lr;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + h0 * p.c_sh + t0 * p.c_st;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h0 * p.b_sh + t0 * p.b_st;
  const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h0 * p.x_sh + t0 * p.x_st;

  const int njb = (rmax + kBlk - 1) / kBlk;
  auto stage = [&](int jb) {
    stage_jblock<T, HPC, kOutThreads>(U + (jb & 1) * stage_elems, p, bm, xd, jb * kBlk, Lr,
                                      bplane, xplane);
  };
  stage_rows<T, kOutThreads, kOutRows>(Cs, ldn, cplane, cm + i0 * p.c_st, p.c_st, rmax - i0,
                                       p.N, p.Np);
  cp_async_commit();
  stage(0);
  cumsum_da<T, HPC>(p, sc, b, h0, t0, rmax, kLog2e);
  for (int h = 0; h < HPC; ++h)
    stage_split<kOutThreads>(Sp + h * 2 * sprev, ldp, sprev,
                             p.ws + ((b * p.H + h0 + h) * p.nc + c) * (int64_t)p.N * p.P,
                             p.N, p.P, p.Np, p.Pp);
  cp_async_wait<1>();  // C is in; j block 0 may still be on its way
  __syncthreads();

  const int iw = warp * 16;       // this warp's first row of the block
  const int ia = i0 + iw + grp;   // chunk row of accumulator elements 0, 1 (2, 3: + 8)
  const bool live = i0 + iw < Lr;
  float acc[HPC][PT][4];
#pragma unroll
  for (int h = 0; h < HPC; ++h)
#pragma unroll
    for (int t = 0; t < PT; ++t) acc[h][t][0] = acc[h][t][1] = acc[h][t][2] = acc[h][t][3] = 0.f;
  float si[HPC][2];  // s x log2(e) at the thread's two rows
  const int pt = p.Pp / 8;
  if (live) {
#pragma unroll
    for (int h = 0; h < HPC; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) si[h][r] = ia + 8 * r < Lr ? sc[h * p.Lp + ia + 8 * r] : 0.f;
    // The inter-chunk term C . S_prev.  C (16 rows x 16 n): matrices (i iw, n kn),
    // (i iw + 8, n kn), (i iw, n kn + 8), (i iw + 8, n kn + 8).
    for (int kn = 0; kn < p.Np; kn += 16) {
      unsigned a[4], al[4];
      const bf16* pc = Cs + (iw + r8 + (q & 1) * 8) * ldn + kn + (q >> 1) * 8;
      ldsm_x4(a[0], a[1], a[2], a[3], pc);
      if (SPLIT) ldsm_x4(al[0], al[1], al[2], al[3], pc + cplane);
#pragma unroll
      for (int h = 0; h < HPC; ++h) {
        const bf16* hi = Sp + h * 2 * sprev;
#pragma unroll
        for (int nt = 0; nt < PT; nt += 2) {
          if (nt < pt) {
            const int off = (kn + r8 + (q & 1) * 8) * ldp + (nt + (q >> 1)) * 8;
            unsigned bh[4], bl[4];
            ldsm_x4_t(bh[0], bh[1], bh[2], bh[3], hi + off);
            ldsm_x4_t(bl[0], bl[1], bl[2], bl[3], hi + sprev + off);
            mma_bf16(acc[h][nt], a, bh[0], bh[1]);
            mma_bf16(acc[h][nt], a, bl[0], bl[1]);
            mma_bf16(acc[h][nt + 1], a, bh[2], bh[3]);
            mma_bf16(acc[h][nt + 1], a, bl[2], bl[3]);
            if (SPLIT) {
              mma_bf16(acc[h][nt], al, bh[0], bh[1]);
              mma_bf16(acc[h][nt + 1], al, bh[2], bh[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < HPC; ++h) {
      const float e0 = ia < Lr ? exp2f(si[h][0]) : 0.f;
      const float e1 = ia + 8 < Lr ? exp2f(si[h][1]) : 0.f;
#pragma unroll
      for (int t = 0; t < PT; ++t) {
        acc[h][t][0] *= e0;
        acc[h][t][1] *= e0;
        acc[h][t][2] *= e1;
        acc[h][t][3] *= e1;
      }
    }
  }
  __syncthreads();  // S_prev is read: the ring's stage 1 takes its place

  const int ilast = (i0 + iw + 15 < Lr ? i0 + iw + 15 : Lr - 1);  // the warp's last row
  for (int jb = 0; jb < njb; ++jb) {
    if (jb + 1 < njb) {
      stage(jb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Bb = U + (jb & 1) * stage_elems;
    const bf16* Xb = Bb + S2 * bplane;
    const int j0 = jb * kBlk;
    for (int kq = 0; live && kq < kBlk / 16 && j0 + 16 * kq <= ilast; ++kq) {
      // G (16 rows x 16 j) = C . B^T, as two 8-column tiles.  B^T (16 n x 16 j):
      // matrices (j 16 kq, n kn), (j 16 kq, n kn + 8), (j 16 kq + 8, n kn),
      // (j 16 kq + 8, n kn + 8) of B's rows.
      float G[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int kn = 0; kn < p.Np; kn += 16) {
        unsigned a[4], al[4], bb[4];
        const bf16* pc = Cs + (iw + r8 + (q & 1) * 8) * ldn + kn + (q >> 1) * 8;
        ldsm_x4(a[0], a[1], a[2], a[3], pc);
        const bf16* pb = Bb + (16 * kq + r8 + (q >> 1) * 8) * ldn + kn + (q & 1) * 8;
        ldsm_x4(bb[0], bb[1], bb[2], bb[3], pb);
        mma_bf16(G[0], a, bb[0], bb[1]);
        mma_bf16(G[1], a, bb[2], bb[3]);
        if (SPLIT) {
          ldsm_x4(al[0], al[1], al[2], al[3], pc + cplane);
          mma_bf16(G[0], al, bb[0], bb[1]);
          mma_bf16(G[1], al, bb[2], bb[3]);
          ldsm_x4(bb[0], bb[1], bb[2], bb[3], pb + bplane);
          mma_bf16(G[0], a, bb[0], bb[1]);
          mma_bf16(G[1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < HPC; ++h) {
        const float* sh = sc + h * p.Lp;
        float w[8];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int t = e / 4, r = (e % 4) / 2;
          const int i = ia + 8 * r;
          const int j = j0 + 16 * kq + t * 8 + tig * 2;  // and j + 1
          const float2 sj = *reinterpret_cast<const float2*>(sh + j);
          const bool ok0 = j <= i && i < Lr, ok1 = j + 1 <= i && i < Lr;
          const float d0 = exp2f(ok0 ? si[h][r] - sj.x : 0.f);
          const float d1 = exp2f(ok1 ? si[h][r] - sj.y : 0.f);
          w[e] = ok0 ? G[t][e % 4] * d0 : 0.f;
          w[e + 1] = ok1 ? G[t][e % 4 + 1] * d1 : 0.f;
        }
        unsigned ah[4], alo[4];
        split_pair(w[0], w[1], ah[0], alo[0]);
        split_pair(w[2], w[3], ah[1], alo[1]);
        split_pair(w[4], w[5], ah[2], alo[2]);
        split_pair(w[6], w[7], ah[3], alo[3]);
        const bf16* xh = Xb + h * S2 * xplane;
#pragma unroll
        for (int nt = 0; nt < PT; nt += 2) {
          if (nt < pt) {
            const int off = (kq * 16 + r8 + (q & 1) * 8) * ldp + (nt + (q >> 1)) * 8;
            unsigned bx[4];
            ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], xh + off);
            mma_bf16(acc[h][nt], ah, bx[0], bx[1]);
            mma_bf16(acc[h][nt], alo, bx[0], bx[1]);
            mma_bf16(acc[h][nt + 1], ah, bx[2], bx[3]);
            mma_bf16(acc[h][nt + 1], alo, bx[2], bx[3]);
            if (SPLIT) {
              ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], xh + xplane + off);
              mma_bf16(acc[h][nt], ah, bx[0], bx[1]);
              mma_bf16(acc[h][nt + 1], ah, bx[2], bx[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // block jb is read: its stage takes block jb + 2, or y
  }

  // y through shared memory (the ring's place): row r of the block holds
  // its HPC heads' Pp columns, then 16 bytes of padding.
  T* Ys = reinterpret_cast<T*>(U);
  const int ys_ld = HPC * p.Pp + 16 / (int)sizeof(T);
  if (live) {
#pragma unroll
    for (int h = 0; h < HPC; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < PT; ++nt)
          if (nt < pt) {
            T* q2 = Ys + (iw + grp + 8 * r) * ys_ld + h * p.Pp + nt * 8 + tig * 2;
            if constexpr (std::is_same<T, bf16>::value)
              *reinterpret_cast<__nv_bfloat162*>(q2) =
                  __floats2bfloat162_rn(acc[h][nt][2 * r], acc[h][nt][2 * r + 1]);
            else
              *reinterpret_cast<float2*>(q2) =
                  make_float2(acc[h][nt][2 * r], acc[h][nt][2 * r + 1]);
          }
  }
  __syncthreads();
  const int nrows = rmax - i0, width = HPC * p.P;  // contiguous in y: the heads are adjacent
  T* y = static_cast<T*>(p.y) + ((b * p.T + t0 + i0) * p.H + h0) * (int64_t)p.P;
  const int64_t y_st = (int64_t)p.H * p.P;
  if (p.P == p.Pp && (width * (int)sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.y) % 16 == 0) {
    const int cpr = width * (int)sizeof(T) / 16;
    for (int k = tid; k < nrows * cpr; k += kOutThreads) {
      const int r = k / cpr, cc = k % cpr;
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(y + r * y_st) + 16 * cc) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(Ys + r * ys_ld) +
                                          16 * cc);
    }
  } else {
    for (int k = tid; k < nrows * width; k += kOutThreads) {
      const int r = k / width, h = k % width / p.P, col = k % p.P;
      y[r * y_st + h * p.P + col] = Ys[r * ys_ld + h * p.Pp + col];
    }
  }
}

// ------------------------------------------------- the wide chunked form
// N or P above kMaxDim (xLSTM's mLSTM heads, N = P = 512, and their
// normaliser, P = 1 at N = 512): the narrow passes keep a whole head's N
// columns of B and C rows in shared memory, and the output pass a whole
// S_prev (about 1 MB at 512), past the 227 KB a CTA may have.  The wide
// passes take one head a CTA and give it a column-block axis, P in blocks
// of kColBlk columns:
//   - the state pass, a CTA per (batch, chunk, head, column block, 64
//     state rows), stages only its 64 columns of B and its kColBlk
//     columns of xd per 64-row j block (the same two-stage ring);
//   - the output pass, a CTA per (batch, chunk, 128-row block, head,
//     column block), streams C and S_prev in 64-row N blocks: C . S_prev
//     accumulates over the N blocks in the y registers, and per 64-row j
//     block G = C . B^T accumulates over them in registers before it
//     meets the decays and xd;
//   - the carry pass is elementwise and serves both forms unchanged.
// Staging is synchronous (one wait and barrier a block), y is written from
// the registers, and the products, splits and masks are the narrow
// passes'.
constexpr int kColBlk = 128;         // columns of P a wide CTA takes
constexpr int kWideLd = kBlk + 8;    // row stride of a staged 64-column N window
constexpr int kWideLdx = kColBlk + 8;  // row stride of a staged column block

inline size_t wide_state_smem(int s2, int Lp) {
  return 2 * ((size_t)s2 * kBlk * kWideLd + (size_t)s2 * kBlk * kWideLdx) * 2 +
         (size_t)Lp * 4;
}
inline size_t wide_output_smem(int s2, int Lp) {
  return ((size_t)s2 * kOutRows * kWideLd + (size_t)s2 * kBlk * kWideLd +
          (size_t)2 * kBlk * kWideLdx) * 2 + (size_t)Lp * 4;
}

// Pass 1, wide: state rows n0 .. n0 + 63 (warp w: 16 of them) and columns
// p0 .. p0 + kColBlk - 1 of one chunk's local end state for one head.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads) ssd_state_wide_kernel(ChunkParams p) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S2 = SPLIT ? 2 : 1, PT = kColBlk / 8;
  constexpr int bplane = kBlk * kWideLd, xplane = kBlk * kWideLdx;
  constexpr int stage_elems = S2 * bplane + S2 * xplane;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* dec = reinterpret_cast<float*>(ring + 2 * stage_elems);  // [Lp]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane / 8, r8 = lane % 8, tig = lane % 4, grp = lane / 4;
  int idx = blockIdx.x;
  const int mb = idx % p.mblocks;
  idx /= p.mblocks;
  const int pb = idx % p.pblocks;
  idx /= p.pblocks;
  const int h = idx % p.H;
  idx /= p.H;
  const int c = idx % p.nc;
  const int64_t b = idx / p.nc;
  const int64_t t0 = (int64_t)c * p.L;
  const int Lr = (int)(p.T - t0 < p.L ? p.T - t0 : p.L);
  const int n0 = mb * kBlk, p0 = pb * kColBlk;
  const int nrows = p.N - n0 < kBlk ? p.N - n0 : kBlk;         // real state rows
  const int pcols = p.P - p0 < kColBlk ? p.P - p0 : kColBlk;   // real columns
  const int pw = (pcols + 15) / 16 * 16;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh + t0 * p.b_st + n0;
  const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + t0 * p.x_st + p0;

  const int njb = (Lr + kBlk - 1) / kBlk;
  auto stage = [&](int jb) {
    bf16* st = ring + (jb & 1) * stage_elems;
    const int r0 = jb * kBlk, rows = Lr - r0 < kBlk ? Lr - r0 : kBlk;
    stage_rows<T, kChunkThreads>(st, kWideLd, bplane, bm + r0 * p.b_st, p.b_st, rows, nrows,
                                 kBlk);
    stage_rows<T, kChunkThreads>(st + S2 * bplane, kWideLdx, xplane, xd + r0 * p.x_st, p.x_st,
                                 rows, pcols, pw);
    cp_async_commit();
  };
  stage(0);

  // dec[j] = exp(s_L - s_j) for the chunk's rows, 0 past them.
  const float last = cumsum_da<T, 1>(p, dec, b, h, t0, Lr);
  if (warp == 0) {
    for (int j = lane; j < p.Lp; j += 32) dec[j] = j < Lr ? expf(last - dec[j]) : 0.f;
    if (mb == 0 && pb == 0 && lane == 0) p.decay[(b * p.H + h) * p.nc + c] = expf(last);
  }

  float acc[PT][4];
#pragma unroll
  for (int t = 0; t < PT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  const int m0 = warp * 16;  // this warp's rows of the block
  const bool live = m0 < nrows;
  const int pt = pw / 8;

  for (int jb = 0; jb < njb; ++jb) {
    if (jb + 1 < njb) {
      stage(jb + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block jb (and, at jb = 0, dec) is in
    const bf16* Bb = ring + (jb & 1) * stage_elems;
    const bf16* Xb = Bb + S2 * bplane;
    const int kend = Lr - jb * kBlk < kBlk ? Lr - jb * kBlk : kBlk;
    if (live) {
      for (int kk = 0; kk < kend; kk += 16) {
        unsigned a[4], al[4] = {0u, 0u, 0u, 0u};
        const bf16* pa = Bb + (kk + r8 + (q >> 1) * 8) * kWideLd + m0 + (q & 1) * 8;
        ldsm_x4_t(a[0], a[1], a[2], a[3], pa);
        if (SPLIT) ldsm_x4_t(al[0], al[1], al[2], al[3], pa + bplane);
        const int j = jb * kBlk + kk + tig * 2;
        const float2 d0 = *reinterpret_cast<const float2*>(dec + j);
        const float2 d8 = *reinterpret_cast<const float2*>(dec + j + 8);
        unsigned ah[4], alo[4];
        scale_split<SPLIT>(a[0], al[0], d0, ah[0], alo[0]);
        scale_split<SPLIT>(a[1], al[1], d0, ah[1], alo[1]);
        scale_split<SPLIT>(a[2], al[2], d8, ah[2], alo[2]);
        scale_split<SPLIT>(a[3], al[3], d8, ah[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < PT; nt += 2) {
          if (nt < pt) {
            const int off = (kk + r8 + (q & 1) * 8) * kWideLdx + (nt + (q >> 1)) * 8;
            unsigned bx[4];
            ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], Xb + off);
            mma_bf16(acc[nt], ah, bx[0], bx[1]);
            mma_bf16(acc[nt], alo, bx[0], bx[1]);
            mma_bf16(acc[nt + 1], ah, bx[2], bx[3]);
            mma_bf16(acc[nt + 1], alo, bx[2], bx[3]);
            if (SPLIT) {
              ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], Xb + xplane + off);
              mma_bf16(acc[nt], ah, bx[0], bx[1]);
              mma_bf16(acc[nt + 1], ah, bx[2], bx[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // block jb is read: its stage takes block jb + 2
  }

  if (!live) return;
  float* out = p.ws + ((b * p.H + h) * p.nc + c) * (int64_t)p.N * p.P;
#pragma unroll
  for (int nt = 0; nt < PT; ++nt) {
    if (nt < pt) {
      const int col = p0 + nt * 8 + tig * 2;
      store_f32_pair(out, p.N, p.P, n0 + m0 + grp, col, acc[nt][0], acc[nt][1]);
      store_f32_pair(out, p.N, p.P, n0 + m0 + grp + 8, col, acc[nt][2], acc[nt][3]);
    }
  }
}

// Pass 3, wide: rows i0 .. i0 + 127 (warp w: 16 of them) and columns
// p0 .. p0 + kColBlk - 1 of one chunk's y for one head.  First C . S_prev,
// over the 64-row N blocks (C's and S_prev's), scaled by exp(s_i); then per
// 64-row j block up to the diagonal, G = C . B^T over the N blocks for the
// warp's 16-j steps not wholly above its last row, and W = G o exp(s_i -
// s_j) [i >= j] (split into hi and lo) times xd.
template <typename T>
__global__ void __launch_bounds__(kOutThreads, 1) ssd_output_wide_kernel(ChunkParams p) {
  constexpr bool SPLIT = std::is_same<T, float>::value;
  constexpr int S2 = SPLIT ? 2 : 1, PT = kColBlk / 8, KQ = kBlk / 16;
  constexpr int cplane = kOutRows * kWideLd, bplane = kBlk * kWideLd, xplane = kBlk * kWideLdx;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // S2 planes of a 64-column N block of C
  bf16* Bs = Cs + S2 * cplane;               // S2 planes of B's j rows, the same columns
  bf16* Xs = Bs + S2 * bplane;               // S_prev's N block (hi, lo), or xd's j rows
  float* sc = reinterpret_cast<float*>(Xs + 2 * xplane);  // [Lp] cumsum x log2(e)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q = lane / 8, r8 = lane % 8, tig = lane % 4, grp = lane / 4;
  int idx = blockIdx.x;
  const int pb = idx % p.pblocks;
  idx /= p.pblocks;
  const int h = idx % p.H;
  idx /= p.H;
  const int rb = idx % p.rblocks;
  idx /= p.rblocks;
  const int c = idx % p.nc;
  const int64_t b = idx / p.nc;
  const int64_t t0 = (int64_t)c * p.L;
  const int Lr = (int)(p.T - t0 < p.L ? p.T - t0 : p.L);
  const int i0 = rb * kOutRows;
  if (i0 >= Lr) return;  // a row block past a short last chunk
  const int rmax = i0 + kOutRows < Lr ? i0 + kOutRows : Lr;
  const int p0 = pb * kColBlk;
  const int pcols = p.P - p0 < kColBlk ? p.P - p0 : kColBlk;
  const int pw = (pcols + 15) / 16 * 16, pt = pw / 8;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb + h * p.c_sh + t0 * p.c_st;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb + h * p.b_sh + t0 * p.b_st;
  const T* xd = static_cast<const T*>(p.xd) + b * p.x_sb + h * p.x_sh + t0 * p.x_st + p0;
  const float* sprev = p.ws + ((b * p.H + h) * p.nc + c) * (int64_t)p.N * p.P + p0;

  // C's rows i0 .. rmax - 1, columns nb * 64 .. nb * 64 + 63.
  auto stage_c = [&](int nb) {
    const int n0 = nb * kBlk;
    stage_rows<T, kOutThreads, kOutRows>(Cs, kWideLd, cplane, cm + i0 * p.c_st + n0, p.c_st,
                                         rmax - i0, p.N - n0 < kBlk ? p.N - n0 : kBlk, kBlk);
  };
  cumsum_da<T, 1>(p, sc, b, h, t0, rmax, kLog2e);

  const int iw = warp * 16;       // this warp's first row of the block
  const int ia = i0 + iw + grp;   // chunk row of accumulator elements 0, 1 (2, 3: + 8)
  const bool live = i0 + iw < Lr;
  float acc[PT][4];
#pragma unroll
  for (int t = 0; t < PT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  // The inter-chunk term C . S_prev, 64 rows of N at a time.
  for (int nb = 0; nb < p.mblocks; ++nb) {
    const int n0 = nb * kBlk;
    stage_c(nb);
    stage_rows<float, kOutThreads>(Xs, kWideLdx, xplane, sprev + (int64_t)n0 * p.P, p.P,
                                   p.N - n0 < kBlk ? p.N - n0 : kBlk, pcols, pw);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // C's and S_prev's N block (and, at nb = 0, the cumsum) are in
    if (live) {
      for (int kn = 0; kn < kBlk; kn += 16) {
        unsigned a[4], al[4];
        const bf16* pc = Cs + (iw + r8 + (q & 1) * 8) * kWideLd + kn + (q >> 1) * 8;
        ldsm_x4(a[0], a[1], a[2], a[3], pc);
        if (SPLIT) ldsm_x4(al[0], al[1], al[2], al[3], pc + cplane);
#pragma unroll
        for (int nt = 0; nt < PT; nt += 2) {
          if (nt < pt) {
            const int off = (kn + r8 + (q & 1) * 8) * kWideLdx + (nt + (q >> 1)) * 8;
            unsigned bh[4], bl[4];
            ldsm_x4_t(bh[0], bh[1], bh[2], bh[3], Xs + off);
            ldsm_x4_t(bl[0], bl[1], bl[2], bl[3], Xs + xplane + off);
            mma_bf16(acc[nt], a, bh[0], bh[1]);
            mma_bf16(acc[nt], a, bl[0], bl[1]);
            mma_bf16(acc[nt + 1], a, bh[2], bh[3]);
            mma_bf16(acc[nt + 1], a, bl[2], bl[3]);
            if (SPLIT) {
              mma_bf16(acc[nt], al, bh[0], bh[1]);
              mma_bf16(acc[nt + 1], al, bh[2], bh[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the block is read: the next one takes its place
  }
  float si[2];  // s x log2(e) at the thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) si[r] = ia + 8 * r < Lr ? sc[ia + 8 * r] : 0.f;
  {
    const float e0 = ia < Lr ? exp2f(si[0]) : 0.f;
    const float e1 = ia + 8 < Lr ? exp2f(si[1]) : 0.f;
#pragma unroll
    for (int t = 0; t < PT; ++t) {
      acc[t][0] *= e0;
      acc[t][1] *= e0;
      acc[t][2] *= e1;
      acc[t][3] *= e1;
    }
  }

  const int ilast = (i0 + iw + 15 < Lr ? i0 + iw + 15 : Lr - 1);  // the warp's last row
  const int njb = (rmax + kBlk - 1) / kBlk;
  for (int jb = 0; jb < njb; ++jb) {
    const int j0 = jb * kBlk;
    const int jrows = Lr - j0 < kBlk ? Lr - j0 : kBlk;
    float G[KQ][2][4];
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq)
#pragma unroll
      for (int t = 0; t < 2; ++t) G[kq][t][0] = G[kq][t][1] = G[kq][t][2] = G[kq][t][3] = 0.f;
    for (int nb = 0; nb < p.mblocks; ++nb) {
      const int n0 = nb * kBlk;
      stage_c(nb);
      stage_rows<T, kOutThreads>(Bs, kWideLd, bplane, bm + j0 * p.b_st + n0, p.b_st, jrows,
                                 p.N - n0 < kBlk ? p.N - n0 : kBlk, kBlk);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) {
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq) {
          if (j0 + 16 * kq > ilast) continue;
          // G (16 rows x 16 j) += C . B^T over this N block, as two 8-column tiles.
          for (int kn = 0; kn < kBlk; kn += 16) {
            unsigned a[4], al[4], bb[4];
            const bf16* pc = Cs + (iw + r8 + (q & 1) * 8) * kWideLd + kn + (q >> 1) * 8;
            ldsm_x4(a[0], a[1], a[2], a[3], pc);
            const bf16* pbp = Bs + (16 * kq + r8 + (q >> 1) * 8) * kWideLd + kn + (q & 1) * 8;
            ldsm_x4(bb[0], bb[1], bb[2], bb[3], pbp);
            mma_bf16(G[kq][0], a, bb[0], bb[1]);
            mma_bf16(G[kq][1], a, bb[2], bb[3]);
            if (SPLIT) {
              ldsm_x4(al[0], al[1], al[2], al[3], pc + cplane);
              mma_bf16(G[kq][0], al, bb[0], bb[1]);
              mma_bf16(G[kq][1], al, bb[2], bb[3]);
              ldsm_x4(bb[0], bb[1], bb[2], bb[3], pbp + bplane);
              mma_bf16(G[kq][0], a, bb[0], bb[1]);
              mma_bf16(G[kq][1], a, bb[2], bb[3]);
            }
          }
        }
      }
      __syncthreads();  // C's and B's block are read
    }
    stage_rows<T, kOutThreads>(Xs, kWideLdx, xplane, xd + j0 * p.x_st, p.x_st, jrows, pcols, pw);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // xd's j rows are in
    if (live) {
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        if (j0 + 16 * kq > ilast) continue;
        float w[8];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const int t = e / 4, r = (e % 4) / 2;
          const int i = ia + 8 * r;
          const int j = j0 + 16 * kq + t * 8 + tig * 2;  // and j + 1
          const float2 sj = *reinterpret_cast<const float2*>(sc + j);
          const bool ok0 = j <= i && i < Lr, ok1 = j + 1 <= i && i < Lr;
          const float d0 = exp2f(ok0 ? si[r] - sj.x : 0.f);
          const float d1 = exp2f(ok1 ? si[r] - sj.y : 0.f);
          w[e] = ok0 ? G[kq][t][e % 4] * d0 : 0.f;
          w[e + 1] = ok1 ? G[kq][t][e % 4 + 1] * d1 : 0.f;
        }
        unsigned ah[4], alo[4];
        split_pair(w[0], w[1], ah[0], alo[0]);
        split_pair(w[2], w[3], ah[1], alo[1]);
        split_pair(w[4], w[5], ah[2], alo[2]);
        split_pair(w[6], w[7], ah[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < PT; nt += 2) {
          if (nt < pt) {
            const int off = (kq * 16 + r8 + (q & 1) * 8) * kWideLdx + (nt + (q >> 1)) * 8;
            unsigned bx[4];
            ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], Xs + off);
            mma_bf16(acc[nt], ah, bx[0], bx[1]);
            mma_bf16(acc[nt], alo, bx[0], bx[1]);
            mma_bf16(acc[nt + 1], ah, bx[2], bx[3]);
            mma_bf16(acc[nt + 1], alo, bx[2], bx[3]);
            if (SPLIT) {
              ldsm_x4_t(bx[0], bx[1], bx[2], bx[3], Xs + xplane + off);
              mma_bf16(acc[nt], ah, bx[0], bx[1]);
              mma_bf16(acc[nt + 1], ah, bx[2], bx[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // xd's rows are read: the next j block takes the buffers
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ia + 8 * r;
    if (row >= Lr) continue;
    T* yr = static_cast<T*>(p.y) + ((b * p.T + t0 + row) * p.H + h) * (int64_t)p.P;
#pragma unroll
    for (int nt = 0; nt < PT; ++nt)
      if (nt < pt) store_y_pair(yr, p0 + nt * 8 + tig * 2, p.P, acc[nt][2 * r], acc[nt][2 * r + 1]);
  }
}

// Whether N or P takes the wide passes.
inline bool is_wide(long long N, long long P) { return N > kMaxDim || P > kMaxDim; }

// f(state kernel, output kernel) of the instantiation for dtype (0 bf16,
// 1 f32), heads per CTA (2 only with P <= 64) and P's 8-column tiles
// (8: P <= 64; 16: P <= 128), or of the wide passes (N or P > 128).
template <typename T, typename F>
static int with_chunks_t(int hpc, int pt, bool wide, F&& f) {
  if (wide) return f(ssd_state_wide_kernel<T>, ssd_output_wide_kernel<T>);
  if (hpc == 2) return f(ssd_state_kernel<T, 2, 8>, ssd_output_kernel<T, 2, 8>);
  if (pt == 8) return f(ssd_state_kernel<T, 1, 8>, ssd_output_kernel<T, 1, 8>);
  return f(ssd_state_kernel<T, 1, 16>, ssd_output_kernel<T, 1, 16>);
}
template <typename F>
static int with_chunks(int dtype, int hpc, int pt, bool wide, F&& f) {
  return dtype == 0 ? with_chunks_t<bf16>(hpc, pt, wide, f)
                    : with_chunks_t<float>(hpc, pt, wide, f);
}

// Dynamic shared memory of the state and output passes.
inline size_t chunk_state_smem(int s2, int hpc, int Np, int Pp, int Lp, bool wide) {
  return wide ? wide_state_smem(s2, Lp) : state_smem(s2, hpc, Np, Pp, Lp);
}
inline size_t chunk_output_smem(int s2, int hpc, int Np, int Pp, int Lp, bool wide) {
  return wide ? wide_output_smem(s2, Lp) : output_smem(s2, hpc, Np, Pp, Lp);
}

// The geometry of the chunked form for these shapes and heads per CTA
// (as kernels/mamba_scan/kernel.py:chunk_grid computes it); false when
// it is out of range.
static bool chunk_geometry(ChunkParams& p, int hpc) {
  p.Np = (p.N + 15) / 16 * 16;
  p.Pp = (p.P + 15) / 16 * 16;
  p.Lp = (p.L + kBlk - 1) / kBlk * kBlk;
  p.nc = (int)((p.T + p.L - 1) / p.L);
  p.rblocks = (p.L + kOutRows - 1) / kOutRows;
  p.mblocks = (p.Np + kBlk - 1) / kBlk;
  p.eblocks = (p.N * p.P + 4 * kCarryThreads - 1) / (4 * kCarryThreads);
  p.carry_vec = (p.N * p.P) % 4 == 0 && reinterpret_cast<uintptr_t>(p.s0) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(p.sf) % 16 == 0 &&
                reinterpret_cast<uintptr_t>(p.ws) % 16 == 0;
  const bool wide = is_wide(p.N, p.P);
  p.pblocks = wide ? (p.P + kColBlk - 1) / kColBlk : 1;
  if (hpc != 1 && hpc != 2) return false;
  if (hpc == 2 && (wide || p.H % 2 || p.Pp > 64 || p.b_sh != 0 || p.c_sh != 0)) return false;
  p.groups = p.H / hpc;
  const long long cap = (1LL << 31) - 1;
  return (long long)p.B * p.nc * p.groups * p.mblocks * p.pblocks <= cap &&
         (long long)p.B * p.nc * p.groups * p.rblocks * p.pblocks <= cap &&
         (long long)p.B * p.H * p.eblocks <= cap;
}

static int launch_chunks(const ChunkParams& p, int dtype, int hpc, cudaStream_t s) {
  const int s2 = dtype == 0 ? 1 : 2, pt = p.Pp <= 64 ? 8 : 16;
  const bool wide = is_wide(p.N, p.P);
  const size_t st_smem = chunk_state_smem(s2, hpc, p.Np, p.Pp, p.Lp, wide);
  const size_t out_smem = chunk_output_smem(s2, hpc, p.Np, p.Pp, p.Lp, wide);
  return with_chunks(dtype, hpc, pt, wide, [&](auto state_k, auto output_k) {
    cudaError_t e = cudaFuncSetAttribute(
        state_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(output_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out_smem);
    if (e != cudaSuccess) return (int)e;
    if (p.nc > 0) {
      state_k<<<(unsigned)((long long)p.B * p.nc * p.groups * p.mblocks * p.pblocks),
                kChunkThreads, st_smem, s>>>(p);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    ssd_carry_kernel<<<(unsigned)((long long)p.B * p.H * p.eblocks), kCarryThreads, 0, s>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (p.nc > 0) {
      output_k<<<(unsigned)((long long)p.B * p.nc * p.groups * p.rblocks * p.pblocks),
                 kOutThreads, out_smem, s>>>(p);
      e = cudaGetLastError();
    }
    return (int)e;
  });
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
// CB: C and B values a lane holds for C . B, kMaxDim / 32 for N <= 128
// (the narrow instantiations) and kMaxWide / 32 for the wide state.
template <typename T, bool VEC, bool S0, int CB>
__global__ void __launch_bounds__(kDecodeThreads, S0 ? (CB == kMaxDim / 32 ? 4 : 2) : 1)
    mamba_decode_kernel(DecodeParams p) {
  __shared__ float4 part[S0 ? kDecodeThreads : 1];  // C . S0 partial sums
  constexpr int kCb = CB;                           // C and B values per lane
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

// f(kernel) for the decode kernel's instantiation of dtype, vec, s0 and
// width (wide: N > kMaxDim).
template <typename T, int CB, typename F>
static int with_decode_cb(bool vec, bool s0, F&& f) {
  if (vec)
    return s0 ? f(mamba_decode_kernel<T, true, true, CB>)
              : f(mamba_decode_kernel<T, true, false, CB>);
  return s0 ? f(mamba_decode_kernel<T, false, true, CB>)
            : f(mamba_decode_kernel<T, false, false, CB>);
}
template <typename T, typename F>
static int with_decode_t(bool vec, bool s0, bool wide, F&& f) {
  return wide ? with_decode_cb<T, kMaxWide / 32>(vec, s0, f)
              : with_decode_cb<T, kMaxDim / 32>(vec, s0, f);
}
template <typename F>
static int with_decode(int dtype, bool vec, bool s0, bool wide, F&& f) {
  return dtype == 0 ? with_decode_t<__nv_bfloat16>(vec, s0, wide, f)
                    : with_decode_t<float>(vec, s0, wide, f);
}

}  // namespace repro_ms

// dtype: 0 = bf16, 1 = f32 (xd, da, bm and cm share it; y takes it too).
// N, P <= 512 (above 128 on the wide passes), 1 <= L <= 512.  Strides are in elements, (batch, time,
// head) for each input; the last dim of xd, bm and cm is contiguous.
// s0 may be null (zero initial state).  ws is an f32 workspace of
// B * H * ceil(T / L) * N * P floats and decay one of B * H * ceil(T / L):
// after the launches ws holds each chunk's incoming state and decay each
// chunk's exp(s_L).  heads_per_cta: 1, or 2 when H is even, P <= 64,
// N <= 128 and B and C are head-broadcast (b_sh = c_sh = 0).  Three launches on
// `stream`; returns the cudaError_t of the first that fails (0 on
// success; cudaErrorInvalidValue for shapes outside these).
extern "C" int repro_mamba_scan(
    const void* xd, const void* da, const void* bm, const void* cm,
    const float* s0, void* y, float* sf, float* ws, float* decay, int dtype,
    long long B, long long T, long long H, long long P, long long N, long long L,
    long long x_sb, long long x_st, long long x_sh, long long a_sb, long long a_st,
    long long a_sh, long long b_sb, long long b_st, long long b_sh,
    long long c_sb, long long c_st, long long c_sh, int heads_per_cta, void* stream) {
  if (N < 1 || P < 1 || N > repro_ms::kMaxWide || P > repro_ms::kMaxWide ||
      L < 1 || L > repro_ms::kMaxL || B < 0 || T < 0 || H < 0 ||
      B >= (1LL << 31) || H >= (1LL << 31) || (T + L - 1) / L >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  repro_ms::ChunkParams p;
  p.xd = xd;
  p.da = da;
  p.bm = bm;
  p.cm = cm;
  p.s0 = s0;
  p.y = y;
  p.sf = sf;
  p.ws = ws;
  p.decay = decay;
  p.T = T;
  p.B = (int)B;
  p.H = (int)H;
  p.P = (int)P;
  p.N = (int)N;
  p.L = (int)L;
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
  if (!repro_ms::chunk_geometry(p, heads_per_cta)) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return 0;
  return repro_ms::launch_chunks(p, dtype, heads_per_cta, static_cast<cudaStream_t>(stream));
}

// The residency of the chunked form's passes for dtype, heads per CTA and
// these N, P, L: CTAs per SM of the state, carry and output passes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at their dynamic shared
// memory) and the state and output passes' dynamic shared memory per CTA.
// Returns the cudaError_t of the queries (cudaErrorInvalidValue for a
// geometry the launch refuses).
extern "C" int repro_mamba_chunk_occupancy(int dtype, int heads_per_cta, long long N,
                                           long long P, long long L, int* blocks,
                                           int* smem_bytes) {
  if (N < 1 || P < 1 || N > repro_ms::kMaxWide || P > repro_ms::kMaxWide || L < 1 ||
      L > repro_ms::kMaxL || (heads_per_cta != 1 && heads_per_cta != 2))
    return (int)cudaErrorInvalidValue;
  const int Np = (int)(N + 15) / 16 * 16, Pp = (int)(P + 15) / 16 * 16;
  const int Lp = (int)(L + repro_ms::kBlk - 1) / repro_ms::kBlk * repro_ms::kBlk;
  const bool wide = repro_ms::is_wide(N, P);
  if (heads_per_cta == 2 && (Pp > 64 || wide)) return (int)cudaErrorInvalidValue;
  const int s2 = dtype == 0 ? 1 : 2, pt = Pp <= 64 ? 8 : 16;
  const size_t st = repro_ms::chunk_state_smem(s2, heads_per_cta, Np, Pp, Lp, wide);
  const size_t out = repro_ms::chunk_output_smem(s2, heads_per_cta, Np, Pp, Lp, wide);
  smem_bytes[0] = (int)st;
  smem_bytes[1] = (int)out;
  return repro_ms::with_chunks(dtype, heads_per_cta, pt, wide,
                               [&](auto state_k, auto output_k) {
    cudaError_t e = cudaFuncSetAttribute(
        state_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(output_k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)out);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[0], state_k,
                                                        repro_ms::kChunkThreads, st);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks[1], repro_ms::ssd_carry_kernel, repro_ms::kCarryThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[2], output_k,
                                                        repro_ms::kOutThreads, out);
    return (int)e;
  });
}

// One decode step (T = 1) on the decode kernel.  dtype as above; N, P <=
// 512 (N above 128 on the wide instantiation); y is (B, 1, H, P) and the
// state (B, H, N, P), both contiguous.  slices: column
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
  if (N < 1 || P < 1 || N > repro_ms::kMaxWide || P > repro_ms::kMaxWide ||
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
  return repro_ms::with_decode(dtype, vec, s0 != nullptr, N > repro_ms::kMaxDim,
                               [&](auto kernel) {
    kernel<<<ctas, repro_ms::kDecodeThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  });
}

// The residency of the decode kernel's instantiation (vec: 16-byte rows; s0:
// with an initial state; wide: N > 128): CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its static shared
// memory per CTA.  Returns the cudaError_t of the queries.
extern "C" int repro_mamba_decode_occupancy(int dtype, int vec, int s0, int wide,
                                            int* blocks, int* smem_bytes) {
  return repro_ms::with_decode(dtype, vec != 0, s0 != 0, wide != 0, [&](auto kernel) {
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
