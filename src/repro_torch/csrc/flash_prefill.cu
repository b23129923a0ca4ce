// Flash attention forward at a prefill: out = softmax(scale * q . k^T +
// mask) . v for blocks of 128 query positions, designed for the H100's
// warpgroup MMA (`wgmma`) and TMA.  The prefill route of
// kernels/flash_attention/kernel.py:attention_route (bf16, T at or above
// PREFILL_MIN_T, head dims an instantiation holds); decode members and f32
// inputs take flash_attention.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:23
// `_flash_kernel` (launched by `flash_attention_pallas`, :93-154): blocked
// causal, optionally sliding-window GQA attention with an online softmax
// (m, l, acc in f32) that skips kv blocks wholly past the causal or window
// frontier (:77-84).
//
// What bounds it on an H100.  A prefill does (D + Dv) multiply-adds per
// visible (query, key) pair and reads each K/V row once per query block:
// at D 128 it is bound by operations (Qwen3-14B's B4 Hq40 T1000: 41 GFLOP,
// 0.0415 ms at 989 TFLOP/s), at D 64 (Zamba2) and in MLA's 192/128 by
// bytes (0.0196 and 0.0245 ms).  The design:
//   - a CTA holds 128 query positions of one q head: two consumer
//     warpgroups of 64 rows each, wgmma's M, so every K/V tile loaded into
//     shared memory serves 128 rows (the decode kernel's CTA holds 16
//     rows, and at a prefill its CTAs stream each block's K/V up to 40
//     times).  The grid is (B * Hq, ceil(T / 128)); blockIdx.x is b * Hq +
//     h, so the rep q heads of one kv head run in neighbouring CTAs and
//     find their K/V tiles in L2, and blockIdx.y walks the q blocks last
//     first, so the blocks with the most causal work start first and the
//     tail is short.  No kv split and no merge: the smallest prefill on
//     the path (DeepSeek MLA on a rank of 4, B4 H4 T1000) is 128 CTAs;
//   - a producer warpgroup, one thread of it busy, asks the TMA unit for
//     the Q block once (64-row boxes of a 4-D tensor map over q's stored
//     strides: the models hand q over as a transposed (B, T, H, D) view
//     and K/V as transposed views of the cache, and nothing is copied),
//     then for each tile's K and V (kKT keys) into a ring of kStages
//     stages completing on mbarriers' transaction counts; the consumer
//     warps give a stage back on a second mbarrier after
//     `fence.proxy.async` (tma.cuh).  Keys past S arrive as TMA's zero
//     fill and are masked;
//   - registers: ptxas gives each of the 384 threads 168, and at 64-key
//     tiles a consumer thread's S (32), P's two parts (32) and O (up to
//     64) fit with no spill.  At 128-key tiles they spilled, with
//     `setmaxnreg` handing the producer's registers to the consumers or
//     without it; at 64 keys the kernel timed the same with and without
//     it (PERF.md, PR 35), so it is left out;
//   - the products run on `wgmma`: S = Q . K^T as m64n64k16 with Q and K
//     read from the 128-byte-swizzled boxes by descriptor, then O += P . V
//     with P from registers (the accumulator fragment of S is the A
//     fragment of P . V) and V read MN-major by the transpose bit.  The
//     online softmax stays in registers: the running max in base 2, each
//     weight one FFMA (scale * log2(e) folded in) and one ex2, O rescaled
//     only when a row's max moved.  P is split into a bf16 high part and
//     the bf16 of what it leaves out, two wgmmas into one accumulator: P in
//     bf16 alone rounds each weight by up to 2^-9, and a row whose
//     weighted values cancel then misses the 2e-4 floor of
//     flash_attention/ref.py:attention_tol;
//   - each warpgroup pipelines its tiles: S of tile j is issued with P . V
//     of tile j - 1 behind it, so the softmax of tile j runs while the
//     tensor cores work on P . V of tile j - 1;
//   - the walk loads only kv tiles some row of the CTA can see (the Pallas
//     block skip at the kernel's tile: nothing past the causal frontier,
//     nothing before the window); each warpgroup computes only the tiles
//     its own 64 rows can see (a contiguous run of the walk), and only
//     tiles crossing the diagonal, the window's edge or S take the
//     per-element test (prefill_tiles in kernels/flash_attention/kernel.py
//     mirrors the walk).  A row that sees no key writes 0;
//   - the epilogue divides by l in f32, casts once to bf16, stages the
//     64 x Dv tile in the warpgroup's own Q area (16-byte chunks swizzled
//     by row) and stores it in 16-byte vectors to the (B, Hq, T, Dv)
//     output.
//
// Plain C interface, loaded with ctypes by kernels/flash_attention/kernel.py.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace repro_fp {

using namespace repro;  // tma.cuh: mbarriers, TMA boxes, tensor maps

constexpr int kWGs = 2;                     // consumer warpgroups
constexpr int kWGRows = 64;                 // query rows of one: wgmma's M
constexpr int kRows = kWGs * kWGRows;       // query positions of a CTA
constexpr int kThreads = 128 * (kWGs + 1);  // + the producer's warpgroup
constexpr int kKT = 64;                     // keys of a K/V tile
constexpr int kStages = 4;                  // K/V ring depth
constexpr int kBox = 64 * 128;              // bytes of a box: 64 rows x 64 bf16
constexpr float kNeg = -1e30f;              // running-max start (scaled units)
constexpr float kMasked = -INFINITY;        // a masked key's score: weight 0

// Shared memory per instantiation: the Q block (per warpgroup, D / 64
// boxes of 64 rows), the ring (per stage D / 64 boxes of K then Dv / 64 of
// V), the mbarriers (full and empty per stage, then Q's).  64/64: 16 KB +
// 4 x 16 KB; 128/128: 32 KB + 4 x 32 KB; 192/128: 48 KB + 4 x 40 KB.
template <int DQ, int DV>
struct Cfg {
  static constexpr int QBOX = DQ / 64;
  static constexpr int VBOX = DV / 64;
  static constexpr int Q_BYTES = kWGs * QBOX * kBox;
  static constexpr int STAGE = (QBOX + VBOX) * kBox;
  static constexpr int RING = Q_BYTES;
  static constexpr int BARS = RING + kStages * STAGE;
  static constexpr int SMEM = BARS + (2 * kStages + 1) * 8 + 1024;  // + alignment
  static_assert(DQ % 64 == 0 && DV % 64 == 0 && DV <= DQ, "instantiated widths");
  static_assert(SMEM <= 232448, "one CTA's shared memory on an H100");
};

struct Params {
  void* out;  // (B, Hq, T, Dv) bf16, contiguous
  int Hq, T, S, Dv;
  int causal, window, q_offset;
  int q_tiles;   // ceil(T / kRows)
  float scale2;  // scale * log2(e), > 0
};

// The kKT-key tiles [lo, lo + n * kKT) a CTA whose rows sit at positions
// [qlo, qhi] loads: from the tile of the first key its first row sees
// (window) to the last key its last row sees (causal), S cut.
struct Walk {
  int lo, n;
};

__device__ __forceinline__ Walk walk(const Params& p, int qlo, int qhi) {
  int lo = 0, hi = p.S;
  if (p.causal) hi = min(hi, max(qhi + 1, 0));
  if (p.window) {
    const int first = qlo - p.window + 1;
    lo = first > 0 ? first / kKT * kKT : 0;
  }
  return {lo, hi > lo ? (hi - lo + kKT - 1) / kKT : 0};
}

// What a warpgroup whose `rows` real rows sit at [qlo, qhi] does with the
// tile at k0: nothing (no key visible to any row), the per-element mask, or
// nothing to mask (every key visible to every row).
enum Mode { kSkip = 0, kMask = 1, kOpen = 2 };

__device__ __forceinline__ int tile_mode(const Params& p, int k0, int rows, int qlo,
                                         int qhi) {
  if (rows <= 0 || (p.causal && k0 > qhi) ||
      (p.window && k0 + kKT - 1 <= qlo - p.window))
    return kSkip;
  const bool open = k0 + kKT <= p.S && (!p.causal || k0 + kKT - 1 <= qlo) &&
                    (!p.window || qhi - k0 < p.window);
  return open ? kOpen : kMask;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.S;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window) ok = ok && qpos - kpos < p.window;
  return ok;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading (or reusing) registers an in-flight
// wgmma writes (or reads) before the `wgmma_wait` that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The descriptor of a wgmma operand in shared memory under the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128B).  K-major (q, k): 8-row groups 1,024 bytes apart,
// the leading offset unused; MN-major (v): 64-column boxes kBox apart,
// 8-key groups 1,024 bytes apart.  A box starts on a 1,024-byte boundary;
// a k step of 16 columns inside one moves the start by 32 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, int lead, int stride) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T (+ d when scale_d),
// both bf16 in shared memory, K-major under the 128-byte swizzle.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers: a 16-key slice of P) . B
// (16 keys x 64, shared, MN-major under the 128-byte swizzle: the
// transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const unsigned* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16 bf16, registers: a 16-key slice of P) . B
// (16 keys x 128, shared, MN-major under the 128-byte swizzle: the
// transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const unsigned* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int DV>
__device__ __forceinline__ void wgmma_pv(float* d, const unsigned* a, uint64_t b) {
  if constexpr (DV == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    static_assert(DV == 128, "P . V instantiated at Dv 64 and 128");
    wgmma_rs_n128(d, a, b);
  }
}

// ------------------------------------------------------------------ roles
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// A pair of weights as a bf16x2 high part and the bf16x2 of what it
// leaves out.
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The producer's busy thread: the Q block's boxes (the halves with a real
// row), then tile j of the walk into stage j % kStages once the eight
// consumer warps have given the stage's previous tile back.
template <int DQ, int DV>
__device__ __forceinline__ void produce(unsigned char* smem, unsigned bar0,
                                        const CUtensorMap* tmq, const CUtensorMap* tmk,
                                        const CUtensorMap* tmv, int b, int h, int hk,
                                        int q0, int nq, Walk w) {
  using C = Cfg<DQ, DV>;
  const unsigned qbar = bar0 + 16 * kStages;
  const int halves = (nq + kWGRows - 1) / kWGRows;
  mbar_arrive_tx(qbar, (unsigned)(halves * C::QBOX * kBox));
  for (int half = 0; half < halves; ++half)
    for (int c = 0; c < C::QBOX; ++c)
      tma_box(smem + (half * C::QBOX + c) * kBox, tmq, 64 * c, q0 + half * kWGRows, h, b,
              qbar);
  for (int j = 0; j < w.n; ++j) {
    const int s = j % kStages;
    const unsigned full = bar0 + 8 * s, empty = bar0 + 8 * (kStages + s);
    if (j >= kStages) mbar_wait(empty, (unsigned)((j / kStages + 1) & 1));
    unsigned char* Ks = smem + C::RING + s * C::STAGE;
    unsigned char* Vs = Ks + C::QBOX * kBox;
    const int k0 = w.lo + j * kKT;
    mbar_arrive_tx(full, (unsigned)C::STAGE);
    for (int c = 0; c < C::QBOX; ++c) tma_box(Ks + c * kBox, tmk, 64 * c, k0, hk, b, full);
    for (int c = 0; c < C::VBOX; ++c) tma_box(Vs + c * kBox, tmv, 64 * c, k0, hk, b, full);
  }
}

// One consumer warpgroup: its 64 rows of the CTA's block through the walk,
// then its output rows.  Thread `tid` of the warpgroup holds, in wgmma's
// accumulator layout, rows r and r + 8 (r = 16 * warp + lane / 4) and of
// each 8-column group the columns 2 * (lane % 4) and the next.
template <int DQ, int DV>
struct Consumer {
  using C = Cfg<DQ, DV>;
  static constexpr int NS = kKT / 2;   // S accumulator floats a thread holds
  static constexpr int NO = DV / 2;    // O accumulator floats a thread holds
  static constexpr int KS = kKT / 16;  // 16-key steps of P . V

  const Params& p;
  unsigned char* smem;
  unsigned char* Qw;  // the warpgroup's Q boxes, later its output staging
  unsigned bar0;
  int lane, tig, r0, rows, qlo, qhi, qpos[2];
  float o[NO], m[2], l[2];

  __device__ __forceinline__ Consumer(const Params& p_, unsigned char* smem_,
                                      unsigned bar0_, int q0, int nq)
      : p(p_), smem(smem_), bar0(bar0_) {
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    lane = tid % 32;
    tig = lane % 4;
    r0 = (tid / 32) * 16 + lane / 4;
    rows = min(max(nq - wg * kWGRows, 0), kWGRows);
    qlo = q0 + wg * kWGRows + p.q_offset;
    qhi = qlo + rows - 1;
    qpos[0] = qlo + r0;
    qpos[1] = qlo + r0 + 8;
    Qw = smem + wg * C::QBOX * kBox;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    m[0] = m[1] = kNeg;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ const unsigned char* ks(int j) const {
    return smem + C::RING + (j % kStages) * C::STAGE;
  }
  __device__ __forceinline__ void wait_full(int j) const {
    mbar_wait(bar0 + 8 * (j % kStages), (unsigned)((j / kStages) & 1));
  }
  // Every thread's reads of the stage precede the stage's next boxes.
  __device__ __forceinline__ void release(int j) const {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (kStages + j % kStages));
  }

  // S (64 rows x kKT keys) = Q . K^T of tile j, DQ / 16 k steps, in flight.
  __device__ __forceinline__ void issue_s(float (&sc)[NS], int j) const {
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk)
      wgmma_ss_n64(sc, sw128_desc(Qw + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024),
                   sw128_desc(ks(j) + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
  }

  // O (64 x DV) += P . V of tile j, P as its high then its low part, in
  // flight.
  __device__ __forceinline__ void issue_pv(const unsigned (&ph)[KS][4],
                                           const unsigned (&pl)[KS][4], int j) {
    const unsigned char* Vs = ks(j) + C::QBOX * kBox;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t dv = sw128_desc(Vs + kk * 16 * 128, kBox, 1024);
      wgmma_pv<DV>(o, ph[kk], dv);
      wgmma_pv<DV>(o, pl[kk], dv);
    }
    wgmma_commit();
  }

  // The online softmax of tile j's scores, in place: the mask where the
  // tile needs it, each row's max over the quad (base 2, scaled units),
  // the weights 2^(s * scale2 - m) (a masked score's is 0), l.  Returns
  // each row's rescale 2^(m_old - m).
  __device__ __forceinline__ void softmax(float (&sc)[NS], int k0, int mode,
                                          float (&alpha)[2]) {
    if (mode == kMask) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * tig + (i % 2);
        if (!visible(p, qpos[(i % 4) / 2], kpos)) sc[i] = kMasked;
      }
    }
    float mx[2] = {kMasked, kMasked}, neg_m[2];
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * p.scale2);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i % 4) / 2;
      sc[i] = fast_exp2(fmaf(sc[i], p.scale2, neg_m[r]));
      l[r] += sc[i];
    }
  }

  __device__ __forceinline__ void rescale(const float (&alpha)[2]) {
    if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i % 4) / 2];
  }

  // P (64 rows x kKT keys) as 16-key A fragments, high and low parts.
  static __device__ __forceinline__ void split(const float (&sc)[NS], unsigned (&ph)[KS][4],
                                               unsigned (&pl)[KS][4]) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_pair(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);
  }

  // The walk: the tiles the warpgroup's rows see are a run [ja, jb) of it
  // (each row sees a run of keys, and neighbouring rows' runs overlap);
  // the others are waited for and given back.  Within the run, S of tile
  // j is issued with P . V of tile j - 1 behind it; the softmax of j runs
  // while P . V of j - 1 is on the tensor cores, then O is rescaled and
  // stage j - 1 given back.
  __device__ __forceinline__ void run(const Walk& w) {
    int ja = w.n, jb = 0;
    for (int j = 0; j < w.n; ++j)
      if (tile_mode(p, w.lo + j * kKT, rows, qlo, qhi) != kSkip) {
        ja = min(ja, j);
        jb = j + 1;
      }
    if (jb <= ja) ja = jb = 0;
    if (rows > 0) mbar_wait(bar0 + 16 * kStages, 0);  // the Q block is in
    for (int j = 0; j < ja; ++j) {
      wait_full(j);
      release(j);
    }
    if (ja < jb) {
      float sc[NS], alpha[2];
      unsigned ph[KS][4], pl[KS][4];
      wait_full(ja);
      wgmma_fence();
      issue_s(sc, ja);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, w.lo + ja * kKT, tile_mode(p, w.lo + ja * kKT, rows, qlo, qhi), alpha);
      split(sc, ph, pl);
      for (int j = ja + 1; j < jb; ++j) {
        const int k0 = w.lo + j * kKT;
        wait_full(j);
        wgmma_fence();
        issue_s(sc, j);
        issue_pv(ph, pl, j - 1);
        wgmma_wait<1>();  // S of tile j
        fence_regs(sc);
        softmax(sc, k0, tile_mode(p, k0, rows, qlo, qhi), alpha);
        wgmma_wait<0>();  // P . V of tile j - 1
        fence_regs(o);
        fence_regs(ph);
        fence_regs(pl);
        release(j - 1);
        rescale(alpha);
        split(sc, ph, pl);
      }
      wgmma_fence();
      issue_pv(ph, pl, jb - 1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(ph);
      fence_regs(pl);
      release(jb - 1);
    }
    for (int j = jb; j < w.n; ++j) {  // jb = 0 when no tile is computed
      wait_full(j);
      release(j);
    }
  }

  // out = O / l, cast once, staged in the warpgroup's Q area (row stride DV
  // * 2 bytes, 16-byte chunk c of row r at c ^ (r % 8)), then stored in
  // 16-byte vectors.
  __device__ __forceinline__ void store(int b, int h, int q0) {
    if (rows == 0) return;
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {l[0] == 0.f ? 0.f : 1.f / l[0], l[1] == 0.f ? 0.f : 1.f / l[1]};
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int r = (i % 4) / 2, row = r0 + 8 * r, c = i / 4;
      *reinterpret_cast<unsigned*>(Qw + row * DV * 2 + ((c ^ (row % 8)) * 16) + tig * 4) =
          pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    const int64_t row_base = ((int64_t)b * p.Hq + h) * p.T + q0 + wg * kWGRows;
    for (int idx = tid; idx < kWGRows * (DV / 8); idx += 128) {
      const int row = idx / (DV / 8), c = idx % (DV / 8);
      if (row < rows && c * 8 < p.Dv)
        *reinterpret_cast<uint4*>(out + (row_base + row) * p.Dv + c * 8) =
            *reinterpret_cast<const uint4*>(Qw + row * DV * 2 + ((c ^ (row % 8)) * 16));
    }
  }
};

template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(const __grid_constant__ Params p,
                         const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv, int rep) {
  using C = Cfg<DQ, DV>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const unsigned bar0 = smem_u32(smem + C::BARS);
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int q0 = (p.q_tiles - 1 - (int)blockIdx.y) * kRows;  // most work first
  const int nq = min(kRows, p.T - q0);
  const Walk w = walk(p, q0 + p.q_offset, q0 + nq - 1 + p.q_offset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar0 + 8 * s, 1);                      // full: the producer
      mbar_init(bar0 + 8 * (kStages + s), 4 * kWGs);   // empty: every consumer warp
    }
    mbar_init(bar0 + 16 * kStages, 1);                 // the Q block
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 128 * kWGs) {
    produce<DQ, DV>(smem, bar0, &tmq, &tmk, &tmv, b, h, h / rep, q0, nq, w);
  } else if (threadIdx.x < 128 * kWGs) {
    Consumer<DQ, DV> c(p, smem, bar0, q0, nq);
    c.run(w);
    c.store(b, h, q0);
  }
}

template <int DQ, int DV>
static int launch(const Params& p, const void* q, const void* k, const void* v,
                  const long long* dims, const long long* strides, cudaStream_t stream) {
  using C = Cfg<DQ, DV>;
  // dims: B, Hq, Hkv, T, S, D, Dv; strides: q, k, v as (batch, head, row)
  const long long B = dims[0], Hq = dims[1], Hkv = dims[2], T = dims[3], S = dims[4],
                  D = dims[5], Dv = dims[6];
  CUtensorMap tmq, tmk, tmv;
  static_assert(kWGRows == 64 && kKT == 64, "tensor_map_4d's boxes are 64 rows");
  if (!tensor_map_4d(&tmq, q, D, T, Hq, B, strides[2], strides[1], strides[0]) ||
      !tensor_map_4d(&tmk, k, D, S, Hkv, B, strides[5], strides[4], strides[3]) ||
      !tensor_map_4d(&tmv, v, Dv, S, Hkv, B, strides[8], strides[7], strides[6]))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<DQ, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * Hq), (unsigned)p.q_tiles);
  flash_prefill_kernel<DQ, DV><<<grid, kThreads, C::SMEM, stream>>>(p, tmq, tmk, tmv,
                                                                     (int)(Hq / Hkv));
  return (int)cudaGetLastError();
}

}  // namespace repro_fp

// q (B, Hq, T, D), k (B, Hkv, S, D), v (B, Hkv, S, Dv): bf16, element
// strides given, last dim contiguous, bases and strides 16-byte aligned
// (the TMA unit reads them).  (dq, dv) picks the instantiation: (64, 64),
// (128, 128) or (192, 128), at least (D, Dv).  out is a contiguous (B, Hq,
// T, Dv) bf16 tensor; scale > 0.  The launcher keeps B * Hq, T, S and
// every position within 32 bits.  Returns the cudaError_t of the launch (0
// on success), cudaErrorInvalidValue for an instantiation or a tensor the
// TMA unit cannot read.
extern "C" int repro_flash_prefill(
    const void* q, const void* k, const void* v, void* out, int dq, int dv,
    long long B, long long Hq, long long Hkv, long long T, long long S, long long D,
    long long Dv, long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    int causal, long long window, long long q_offset, float scale, void* stream) {
  repro_fp::Params p;
  p.out = out;
  p.Hq = (int)Hq;
  p.T = (int)T;
  p.S = (int)S;
  p.Dv = (int)Dv;
  p.causal = causal;
  p.window = (int)window;
  p.q_offset = (int)q_offset;
  p.q_tiles = (int)((T + repro_fp::kRows - 1) / repro_fp::kRows);
  p.scale2 = scale * 1.4426950408889634f;
  const long long dims[7] = {B, Hq, Hkv, T, S, D, Dv};
  const long long strides[9] = {q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dq == 64 && dv == 64) return repro_fp::launch<64, 64>(p, q, k, v, dims, strides, s);
  if (dq == 128 && dv == 128)
    return repro_fp::launch<128, 128>(p, q, k, v, dims, strides, s);
  if (dq == 192 && dv == 128)
    return repro_fp::launch<192, 128>(p, q, k, v, dims, strides, s);
  return (int)cudaErrorInvalidValue;
}

// CTAs of the (dq, dv) instantiation that fit on one SM at once, and one
// CTA's shared memory in bytes (static and dynamic).  Returns the
// cudaError_t of the query.
extern "C" int repro_flash_prefill_occupancy(int dq, int dv, int* blocks,
                                             int* smem_bytes) {
  auto query = [&](auto kernel, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *smem_bytes = smem + (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, repro_fp::kThreads, smem);
  };
  using repro_fp::Cfg;
  using repro_fp::flash_prefill_kernel;
  if (dq == 64 && dv == 64) return query(flash_prefill_kernel<64, 64>, Cfg<64, 64>::SMEM);
  if (dq == 128 && dv == 128)
    return query(flash_prefill_kernel<128, 128>, Cfg<128, 128>::SMEM);
  if (dq == 192 && dv == 128)
    return query(flash_prefill_kernel<192, 128>, Cfg<192, 128>::SMEM);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
