// Flash attention forward, split over the kv range ("flash-decoding"):
// out = softmax(scale * q . k^T + mask) . v.  Each CTA runs an online
// softmax (m, l, acc in f32) over one split of the keys; the last CTA of
// each row group to finish merges the splits in split order.
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
// of a kv head once, spreads the reading over the whole card, and keeps
// many bytes in flight:
//   - grid (B*Hkv, q blocks, row tiles x kv splits).  The rows of a CTA
//     are the rep = Hq/Hkv query heads of its kv head times the q block's
//     real positions (head-major), padded to kRows = 16, so the GQA heads
//     that share a K/V load share it in one CTA (Qwen3-14B's decode member:
//     5 real rows).  The kv range is cut into `nsplit` splits of
//     `split_len` keys (a multiple of kKT) chosen by the launcher
//     (kernels/flash_attention/kernel.py:kv_splits) so that the grid fills
//     one wave of the card's resident CTAs (SMs x occupancy, 1 CTA per SM
//     at head dim 128): a Qwen3-14B decode member runs 128 CTAs at batch
//     16 and 8 x 16 at batch 1, instead of 8;
//   - warp-specialised loads: one producer warp walks the kKT-key tiles of
//     the split that the CTA's rows can see (the Pallas kernel's block skip
//     at bkv granularity, intersected with the split) and asks the TMA unit
//     for each tile's K and V as 64 x 64 boxes of a 4-D tensor map (d, key,
//     kv head, batch) into a ring of STAGES shared-memory stages, each
//     stage completing on an mbarrier's transaction count; the consumers
//     release a stage through a second mbarrier.  K and V stay bf16 as
//     stored, 32 KB a stage at head dim 128, 4 stages.  Loads run as far
//     ahead as the ring allows whatever the consumers do, and one thread
//     issues them (per-thread 16-byte cp.async copies and row-by-row bulk
//     copies, both tried first, moved fewer bytes a second).  The boxes
//     are 128-byte swizzled, so ldmatrix reads them without bank conflicts
//     (swz).  Where the TMA unit cannot read the cache (a base or
//     stride not a multiple of 16 bytes) the producer warp copies the tiles
//     through registers into the same layout;
//   - bf16 products run on the tensor cores as mma.sync.m16n8k16 with f32
//     accumulators, K and V fragments by ldmatrix (V transposed).  Two
//     groups of 4 consumer warps take the tiles in turn, each warp 16 keys
//     of its group's tile, and every warp keeps its own (m, l, acc), so the
//     softmax needs no barrier inside the loop; the 8 warps merge in warp
//     order at the end.  A tile's work is a chain of dependent steps, and
//     one group of 4 warps alone took longer over it than the tile took to
//     arrive; two groups keep up with the loads (PERF.md).  The score
//     fragments become the A operand of P.V in registers.  P is split
//     into a bf16 high part and a bf16 low part (two MMAs), so P.V keeps
//     ~16 significant bits of each weight and the result stays within f32
//     summation error of the plain f32 version
//     (flash_attention.ref.attention_tol).  wgmma's 64-row minimum would
//     idle 59 of 64 rows of a decode CTA;
//   - masks are explicit: a key past S, past the CTA's key range, past the
//     causal frontier (q_offset + row position) or outside the window gets
//     weight 0 (tiles that every row sees in full skip the per-key test);
//     a split whose rows see no key writes l = 0.  A row that sees no key
//     anywhere writes 0 (ROADMAP queue C).
// f32 inputs (tests only, off the serving path) keep CUDA-core FMAs on f32
// sub-tiles (flash_f32_kernel) inside the same split structure; TF32 would
// break their 2e-4 tolerance.
//
// Partials (nsplit > 1): per split and row, acc (Dv floats, relative to
// the split's max m) and (m, l), in f32 scratch the launcher allocates.
// After storing its own, each CTA counts itself in on its row group's
// counter; the last to arrive computes out = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s over s in split order (M = max_s m_s), so the
// result does not depend on the order in which CTAs finish, and resets the
// counter (merge_splits).  With one split the CTA writes the output itself.
//
// Plain C interface, loaded with ctypes by kernels/flash_attention/kernel.py.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro_fa {

constexpr int kRows = 16;          // query rows per CTA
constexpr float kNeg = -1e30f;     // running-max start, as the Pallas body's
constexpr float kMasked = -3e38f;  // score of a masked key (weight 0)

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
  float* part_acc;  // (nsplit, B, Hq, T, Dv) when nsplit > 1
  float* part_ml;   // (nsplit, B, Hq, T, 2): m, l
  int* counter;     // (B, Hq, T), zero between launches, when nsplit > 1
  int64_t B, Hq, Hkv, T, S, D, Dv;
  int64_t q_sb, q_sh, q_st;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t window, q_offset, bq, bkv;
  int64_t nsplit, split_len;
  float scale;
  int causal;
};

// The CTA's rows and key range, in 32-bit positions (the launcher keeps
// B * Hkv, T and S below 2^31).  blockIdx: x = b * Hkv + kv head, y = q
// block, z = row tile * nsplit + split.
struct Cta {
  int b, hk, q0, nq, row0, split, lo, hi;
  int qlo, qhi;  // the rows' least and greatest query positions
  int n_rows;

  __device__ __forceinline__ bool init(const Params& p) {
    const int rep = (int)(p.Hq / p.Hkv), hkv = (int)p.Hkv, bq = (int)p.bq;
    const int ns = (int)p.nsplit;
    b = blockIdx.x / hkv;
    hk = blockIdx.x % hkv;
    q0 = blockIdx.y * bq;
    nq = (int)p.T - q0 < bq ? (int)p.T - q0 : bq;
    split = blockIdx.z % ns;
    row0 = (blockIdx.z / ns) * kRows;
    if (row0 >= rep * nq) return false;  // the last q block has fewer rows
    n_rows = rep * nq - row0 < kRows ? rep * nq - row0 : kRows;
    // The rows' positions: a run of n_rows of the head-major q block,
    // which wraps to the block's first position at most once per head.
    const int t_first = row0 % nq, off = (int)p.q_offset;
    const bool wraps = t_first + n_rows > nq;
    qlo = q0 + (wraps ? 0 : t_first) + off;
    qhi = q0 + (wraps ? nq - 1 : t_first + n_rows - 1) + off;
    // The bkv blocks any row can see (the Pallas block skip), in the split.
    const int S = (int)p.S, len = (int)p.split_len, bkv = (int)p.bkv;
    lo = split * len;
    hi = S - lo > len ? lo + len : S;
    if (p.causal) {
      const int vis = qhi < 0 ? 0 : (int)(((int64_t)qhi / bkv + 1) * bkv);
      hi = vis < hi ? vis : hi;
    }
    if (p.window) {
      const int first = qlo - (int)p.window + 1;  // first key qlo sees
      const int vis = first > 0 ? first / bkv * bkv : 0;
      lo = vis > lo ? vis : lo;
    }
    return true;
  }
  // Row index idx of the CTA's q block (head-major): its head and position.
  __device__ __forceinline__ int head_of(int idx, int rep) const {
    return hk * rep + idx / nq;
  }
  __device__ __forceinline__ int t_of(int idx) const { return q0 + idx % nq; }
};

__device__ __forceinline__ bool visible(const Params& p, int hi, int qpos,
                                        int kpos) {
  bool ok = kpos < hi;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// Row r's finished (m, l, acc[c]) of this CTA: the output itself when
// there is one split, else split `split`'s partial.
template <typename T>
__device__ __forceinline__ void store_row(const Params& p, const Cta& cta,
                                          int head, int t, int c,
                                          float m, float l, float acc) {
  const int64_t row = (cta.b * p.Hq + head) * p.T + t;
  if (p.nsplit == 1) {
    static_cast<T*>(p.out)[row * p.Dv + c] =
        from_f32<T>(l == 0.f ? 0.f : acc / l);
    return;
  }
  const int64_t prow = cta.split * p.B * p.Hq * p.T + row;
  p.part_acc[prow * p.Dv + c] = acc;
  if (c == 0) {
    p.part_ml[prow * 2] = m;
    p.part_ml[prow * 2 + 1] = l;
  }
}

constexpr int kMaxSplits = 64;  // kv splits one output row may have

// After a CTA has stored its split's partials: the last CTA of its (batch,
// kv head, q block, row tile) group to arrive merges the group's splits in
// split order, out = sum_s w_s acc_s / sum_s w_s l_s with w_s = e^(m_s -
// M), M = max_s m_s (0 for a row whose l sums to 0), and resets the
// group's counter for the next launch.  The arrival is an acquire-release
// atomic after a barrier, so every split's partials are visible to the
// last CTA, which reads them through L2: first every (m, l), then the
// weights per row, then acc; the sums run in split order whichever CTA
// comes last.  `sync` is a barrier of the `nthr` threads taking part;
// `scratch` is shared memory the CTA no longer uses, kMergeFloats floats.
constexpr int kMergeFloats = 2 * kRows * kMaxSplits + kRows;

template <typename T, typename Sync>
__device__ __forceinline__ void merge_splits(const Params& p, const Cta& cta,
                                             int tid, int nthr, Sync sync,
                                             float* scratch) {
  float* m_s = scratch;                     // [row][split]: m, then weights
  float* l_s = m_s + kRows * kMaxSplits;    // [row][split]
  float* sum_s = l_s + kRows * kMaxSplits;  // [row]
  __shared__ int last_s;
  const int rep = (int)(p.Hq / p.Hkv), ns = (int)p.nsplit;
  const int64_t rows = p.B * p.Hq * p.T;
  auto row_of = [&](int r) {
    const int idx = cta.row0 + r;
    return ((int64_t)cta.b * p.Hq + cta.head_of(idx, rep)) * p.T + cta.t_of(idx);
  };
  int* counter = p.counter + row_of(0);
  sync();  // every thread's partials are stored
  if (tid == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(counter) : "memory");
    last_s = before == ns - 1;
  }
  sync();
  if (!last_s) return;
  for (int i = tid; i < cta.n_rows * ns; i += nthr) {
    const int r = i / ns, sp = i % ns;
    const float* ml = p.part_ml + (sp * rows + row_of(r)) * 2;
    m_s[r * kMaxSplits + sp] = __ldcg(ml);
    l_s[r * kMaxSplits + sp] = __ldcg(ml + 1);
  }
  sync();
  for (int r = tid; r < cta.n_rows; r += nthr) {
    float mm = kNeg, ll = 0.f;
    for (int sp = 0; sp < ns; ++sp) mm = fmaxf(mm, m_s[r * kMaxSplits + sp]);
    for (int sp = 0; sp < ns; ++sp) {
      const float w = expf(m_s[r * kMaxSplits + sp] - mm);
      m_s[r * kMaxSplits + sp] = w;
      ll += l_s[r * kMaxSplits + sp] * w;
    }
    sum_s[r] = ll;
  }
  sync();
  for (int i = tid; i < cta.n_rows * (int)p.Dv; i += nthr) {
    const int r = i / (int)p.Dv, c = i % (int)p.Dv;
    const int64_t row = row_of(r);
    float aa = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < ns; ++sp)
      aa += __ldcg(p.part_acc + (sp * rows + row) * p.Dv + c) * m_s[r * kMaxSplits + sp];
    static_cast<T*>(p.out)[row * p.Dv + c] =
        from_f32<T>(sum_s[r] == 0.f ? 0.f : aa / sum_s[r]);
  }
  if (tid == 0) *counter = 0;
}

// ---------------------------------------------------------------- bf16
constexpr int kGroup = 4;                       // warps sharing one tile
constexpr int kGroups = 2;                      // groups taking tiles in turn
constexpr int kConsumers = kGroup * kGroups;    // warps computing on tiles
constexpr int kBfThreads = 32 * (kConsumers + 1);  // + one producer warp
constexpr int kKT = 16 * kGroup;                // keys per tile: 16 per warp

// Shared memory of the bf16 kernel.  K and V tiles are stored as the TMA
// unit writes them with 128-byte swizzling: boxes of 64 keys x 64 columns
// (128 bytes a row), 8 KB each, the 16-byte chunk c of row r at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads fall in 8 different bank
// groups.  q rows are padded by 16 bytes instead.
template <int DMAX>
struct BfCfg {
  // Shared-memory ring depth: 4 stages of 32 KB at head dim 128 (1 CTA per
  // SM), 3 of 64 KB at 256.
  static constexpr int STAGES = DMAX <= 128 ? 4 : 3;
  static constexpr int BOX = 64 * 128;                 // bytes of one box
  static constexpr int TILE = (DMAX / 64) * BOX;       // bytes of K or V
  static constexpr int STAGE = 2 * TILE;               // K then V
  static constexpr int QLD = DMAX + 8;                 // q row stride
  static constexpr int Q_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = Q_OFF + kRows * QLD * 2;
  static constexpr int USED = BAR_OFF + 2 * STAGES * 8;  // + full, empty
  static constexpr int SMEM = USED + 1024;  // room to align the ring to 1 KB
  // After the loop the ring holds each warp's (m, l) and acc for the merge.
  static constexpr int MERGE = kConsumers * kRows * (DMAX + 2) * 4;
  static_assert(MERGE <= STAGES * STAGE, "the merge fits in the ring");
  static_assert(kMergeFloats * 4 <= STAGES * STAGE, "so does merge_splits'");
  static_assert(BAR_OFF % 8 == 0, "mbarriers are 8-byte aligned");
};

// Byte offset of element (row, col) in a swizzled K or V tile.
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 64) * (64 * 128) + row * 128 +
         ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 64 x 64 box of a 4-D tensor map (d, key, kv head, batch) into
// shared memory by the TMA unit (elements past the tensor read as zero);
// completes on `bar`'s transaction count.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int d, int key, int head, int batch,
                                        unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
        "r"(key), "r"(head), "r"(batch), "r"(bar) : "memory");
}

// A barrier of the consumer warps only (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned& r0, unsigned& r1,
                                        unsigned& r2, unsigned& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned& r0, unsigned& r1,
                                          unsigned& r2, unsigned& r3,
                                          const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// d[4] += A (16x16 bf16, a[4]) . B (16x8 bf16, b0 b1), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The producer warp: fills stage j % STAGES with tile j (keys k0 .. k0 +
// 64 of the CTA's range) once the consumer group that read the stage's
// last tile has released it.  With tensor maps, lane 0 asks the TMA unit
// for the tile's boxes (D / 64 of K, Dv / 64 of V); otherwise (rows not
// 16-byte aligned) the lanes copy the tile through registers into the
// same swizzled layout, zero past D, Dv and the range.
template <int DMAX>
__device__ __forceinline__ void produce(const Params& p, const Cta& cta,
                                        unsigned char* ring, unsigned bar0,
                                        int ntiles, const CUtensorMap* tmk,
                                        const CUtensorMap* tmv, bool tma) {
  using Cfg = BfCfg<DMAX>;
  const int lane = threadIdx.x % 32;
  const int kbox = (int)((p.D + 63) / 64), vbox = (int)((p.Dv + 63) / 64);
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + cta.b * p.k_sb + cta.hk * p.k_sh;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + cta.b * p.v_sb + cta.hk * p.v_sh;
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % Cfg::STAGES;
    const unsigned full = bar0 + 8 * s, empty = bar0 + 8 * (Cfg::STAGES + s);
    if (j >= Cfg::STAGES) mbar_wait(empty, (unsigned)((j / Cfg::STAGES + 1) & 1));
    unsigned char* Kd = ring + s * Cfg::STAGE;
    unsigned char* Vd = Kd + Cfg::TILE;
    const int k0 = cta.lo + j * kKT;
    if (tma) {
      if (lane == 0) {
        mbar_arrive_tx(full, (unsigned)((kbox + vbox) * Cfg::BOX));
        for (int h = 0; h < kbox; ++h)
          tma_box(Kd + h * Cfg::BOX, tmk, 64 * h, k0, cta.hk, cta.b, full);
        for (int h = 0; h < vbox; ++h)
          tma_box(Vd + h * Cfg::BOX, tmv, 64 * h, k0, cta.hk, cta.b, full);
      }
    } else {
      const int valid = cta.hi - k0 < kKT ? cta.hi - k0 : kKT;
      for (int ch = lane; ch < kKT * (DMAX / 8); ch += 32) {
        const int r = ch / (DMAX / 8), c = (ch % (DMAX / 8)) * 8;
        uint4 kv[2] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const unsigned short* src = reinterpret_cast<const unsigned short*>(
              t == 0 ? kbase + (k0 + r) * p.k_ss : vbase + (k0 + r) * p.v_ss);
          const int64_t cols = t == 0 ? p.D : p.Dv;
          unsigned short* e = reinterpret_cast<unsigned short*>(&kv[t]);
          if (r < valid)
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = c + i < cols ? src[c + i] : 0;
        }
        *reinterpret_cast<uint4*>(Kd + swz(r, c)) = kv[0];
        *reinterpret_cast<uint4*>(Vd + swz(r, c)) = kv[1];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kBfThreads, 1)
    flash_bf16_kernel(Params p, const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, int tma) {
  using Cfg = BfCfg<DMAX>;
  constexpr int QLD = Cfg::QLD;
  constexpr int NT = DMAX / 8;  // 8-column tiles of the output
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + Cfg::Q_OFF);
  const unsigned bar0 = smem_u32(smem + Cfg::BAR_OFF);

  Cta cta;
  if (!cta.init(p)) return;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = cta.hi > cta.lo ? (cta.hi - cta.lo + kKT - 1) / kKT : 0;
  if (tid < Cfg::STAGES) {
    mbar_init(bar0 + 8 * tid, 1);                          // full: the producer
    mbar_init(bar0 + 8 * (Cfg::STAGES + tid), kGroup);     // empty: a group's warps
  }
  __syncthreads();
  if (warp == kConsumers) {
    produce<DMAX>(p, cta, smem, bar0, ntiles, &tmk, &tmv, tma != 0);
    return;
  }

  // q rows into shared memory, zero past D and past the real rows.
  const int rep = (int)(p.Hq / p.Hkv);
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  for (int ch = tid; ch < kRows * DMAX / 8; ch += 32 * kConsumers) {
    const int r = ch / (DMAX / 8), c = (ch % (DMAX / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < cta.n_rows) {
      const int idx = cta.row0 + r;
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          q + cta.b * p.q_sb + cta.head_of(idx, rep) * p.q_sh +
          cta.t_of(idx) * p.q_st);
      unsigned short* e = reinterpret_cast<unsigned short*>(&x);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = c + i < p.D ? src[c + i] : 0;
    }
    *reinterpret_cast<uint4*>(Qs + r * QLD + c) = x;
  }
  consumers_sync();

  // This thread's two rows (g, g + 8) of the 16 and their positions.
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qpos[h] = cta.t_of(cta.row0 + g + 8 * h) + (int)p.q_offset;
  // Scores, maxima and weights in base 2: s * scale * log2(e), exp2.
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int dq_steps = (int)((p.D + 15) / 16);
  const int dv_tiles = (int)((p.Dv + 15) / 16) * 2;  // in pairs of 8 columns

  // The groups take the tiles in turn, each warp 16 keys of a tile.
  const int grp = warp / kGroup, wig = warp % kGroup;
  for (int j = grp; j < ntiles; j += kGroups) {
    const int s = j % Cfg::STAGES;
    const int k0 = cta.lo + j * kKT;
    // Every key of the tile visible to every row: no per-key mask.
    const bool open = k0 + kKT <= cta.hi && (!p.causal || k0 + kKT - 1 <= cta.qlo) &&
                      (!p.window || cta.qhi - k0 < p.window);
    mbar_wait(bar0 + 8 * s, (unsigned)((j / Cfg::STAGES) & 1));  // tile j is in
    const unsigned char* Ks = smem + s * Cfg::STAGE;
    const unsigned char* Vs = Ks + Cfg::TILE;
    const int key0 = k0 + wig * 16;

    // S (16 rows x 16 keys) = q . k^T, as two m16n8 accumulators.
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk < dq_steps) {
        unsigned a[4], b[4];
        ldsm_x4(a[0], a[1], a[2], a[3],
                Qs + (lane % 16) * QLD + kk * 16 + (lane / 16) * 8);
        const int mi = lane / 8;  // matrix: keys (mi / 2) * 8, d (mi % 2) * 8
        ldsm_x4(b[0], b[1], b[2], b[3],
                Ks + swz(wig * 16 + (mi / 2) * 8 + lane % 8, kk * 16 + (mi % 2) * 8));
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
    }

    // Online softmax per row: scale, mask, max over the quad's 16 keys.
    // Padded rows (past n_rows) are computed on zero q and never stored.
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int kpos = key0 + nt * 8 + tig * 2 + (e % 2);
        const bool ok = open || visible(p, cta.hi, qpos[h], kpos);
        sc[nt][e] = ok ? sc[nt][e] * scale2 : kMasked;
        mx[h] = fmaxf(mx[h], sc[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float w = sc[nt][e] == kMasked ? 0.f : exp2f(sc[nt][e] - m[h]);
        sc[nt][e] = w;
        l[h] += w;
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // P (16 rows x 16 keys) as the A operand, high and low bf16 parts.
    unsigned ph[4], pl[4];
    split_pair(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_pair(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_pair(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_pair(sc[1][2], sc[1][3], ph[3], pl[3]);

    // acc (16 x Dv) += P . V, two 8-column tiles per ldmatrix.
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      if (nt < dv_tiles) {
        unsigned b[4];
        const int mi = lane / 8;  // matrix: keys (mi % 2) * 8, d (nt + mi / 2) * 8
        ldsm_x4_t(b[0], b[1], b[2], b[3],
                  Vs + swz(wig * 16 + (mi % 2) * 8 + lane % 8, (nt + mi / 2) * 8));
        mma_bf16(acc[nt], ph, b[0], b[1]);
        mma_bf16(acc[nt], pl, b[0], b[1]);
        mma_bf16(acc[nt + 1], ph, b[2], b[3]);
        mma_bf16(acc[nt + 1], pl, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar0 + 8 * (Cfg::STAGES + s));  // stage s is free
  }
  consumers_sync();  // every tile is read: the ring becomes the merge area

  // Merge the warps' states in warp order.
  float* ml_s = reinterpret_cast<float*>(smem);          // [warp][row][2]
  float* acc_s = ml_s + kConsumers * kRows * 2;          // [warp][row][DMAX]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (tig == 0) {
      ml_s[(warp * kRows + g + 8 * h) * 2] = m[h];
      ml_s[(warp * kRows + g + 8 * h) * 2 + 1] = l[h];
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2), c = nt * 8 + tig * 2 + (e % 2);
      if (r < cta.n_rows) acc_s[(warp * kRows + r) * DMAX + c] = acc[nt][e];
    }
  consumers_sync();
  for (int i = tid; i < kRows * DMAX; i += 32 * kConsumers) {
    const int r = i / DMAX, c = i % DMAX;
    if (r >= cta.n_rows || c >= p.Dv) continue;
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) mm = fmaxf(mm, ml_s[(w * kRows + r) * 2]);
    float ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      const float f = exp2f(ml_s[(w * kRows + r) * 2] - mm);
      ll += ml_s[(w * kRows + r) * 2 + 1] * f;
      aa += acc_s[(w * kRows + r) * DMAX + c] * f;
    }
    const int idx = cta.row0 + r;
    store_row<__nv_bfloat16>(p, cta, cta.head_of(idx, rep), cta.t_of(idx), c,
                             mm == kNeg ? kNeg : mm * 0.6931471805599453f, ll, aa);
  }
  if (p.nsplit > 1)  // the warps' merge area is read: reuse the ring
    merge_splits<__nv_bfloat16>(p, cta, tid, 32 * kConsumers,
                                [] { consumers_sync(); }, reinterpret_cast<float*>(smem));
}

// ----------------------------------------------------------------- f32
// CUDA-core FMAs on f32 sub-tiles of KS keys, one CTA of kF32Threads per
// (row tile, split); tests only.
constexpr int kF32Threads = 256;
constexpr int KS = 32;  // keys per sub-tile

template <int DMAX>
constexpr size_t f32_smem_bytes() {
  return (size_t)((kRows + 2 * KS) * (DMAX + 1) + kRows * (KS + 1) +
                  3 * kRows) * sizeof(float);
}

// A KS x DMAX sub-tile of a strided (rows, cols) f32 matrix into registers
// as 16-byte chunks; rows >= `rows` and cols >= `cols` read as zero.
template <int DMAX>
struct SubTile {
  static constexpr int CPR = DMAX / 4;
  static constexpr int PER = KS * CPR / kF32Threads;
  static_assert((KS * CPR) % kF32Threads == 0, "chunks divide among threads");

  float4 regs[PER];

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       int64_t ld, int64_t rows, int64_t cols) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int chunk = threadIdx.x + j * kF32Threads;
      const int64_t r = chunk / CPR, c = (int64_t)(chunk % CPR) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < cols) {
        const float* p = src + r * ld + c;
        if (c + 4 <= cols && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          float* vb = reinterpret_cast<float*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) vb[e] = (c + e < cols) ? p[e] : 0.f;
        }
      }
      regs[j] = v;
    }
  }

  // Into shared memory with row stride DMAX + 1.
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int chunk = threadIdx.x + j * kF32Threads;
      const int r = chunk / CPR, c = (chunk % CPR) * 4;
      const float* vals = reinterpret_cast<const float*>(&regs[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[r * (DMAX + 1) + c + e] = vals[e];
    }
  }
};

template <int DMAX>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(Params p) {
  constexpr int LD = DMAX + 1;
  constexpr int PLD = KS + 1;
  constexpr int NACC = kRows * DMAX / kF32Threads;
  static_assert((kRows * DMAX) % kF32Threads == 0, "accumulators divide");
  extern __shared__ float fsmem[];
  float* Qs = fsmem;              // kRows x LD, scaled q rows
  float* Ks = Qs + kRows * LD;    // KS x LD
  float* Vs = Ks + KS * LD;       // KS x LD
  float* Ps = Vs + KS * LD;       // kRows x PLD, scores then weights
  float* m_s = Ps + kRows * PLD;  // running max per row
  float* l_s = m_s + kRows;       // running sum per row
  float* a_s = l_s + kRows;       // this sub-tile's rescale per row
  __shared__ int qpos_s[kRows];

  Cta cta;
  if (!cta.init(p)) return;
  const int rep = (int)(p.Hq / p.Hkv);
  const int tid = threadIdx.x;
  if (tid < kRows) {
    qpos_s[tid] = cta.t_of(cta.row0 + tid) + (int)p.q_offset;
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  const float* q = static_cast<const float*>(p.q);
  for (int i = tid; i < kRows * DMAX; i += kF32Threads) {
    const int r = i / DMAX, d = i % DMAX;
    float x = 0.f;
    if (r < cta.n_rows && d < p.D) {
      const int idx = cta.row0 + r;
      x = q[cta.b * p.q_sb + cta.head_of(idx, rep) * p.q_sh +
            cta.t_of(idx) * p.q_st + d] * p.scale;
    }
    Qs[r * LD + d] = x;
  }
  __syncthreads();

  const float* kbase = static_cast<const float*>(p.k) + cta.b * p.k_sb + cta.hk * p.k_sh;
  const float* vbase = static_cast<const float*>(p.v) + cta.b * p.v_sb + cta.hk * p.v_sh;
  SubTile<DMAX> kt, vt;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (cta.lo < cta.hi) {
    kt.load(kbase + cta.lo * p.k_ss, p.k_ss, cta.hi - cta.lo, p.D);
    vt.load(vbase + cta.lo * p.v_ss, p.v_ss, cta.hi - cta.lo, p.Dv);
  }
  const int warp = tid / 32, lane = tid % 32;
  for (int64_t kv0 = cta.lo; kv0 < cta.hi; kv0 += KS) {
    __syncthreads();  // the previous sub-tile is no longer read
    kt.store(Ks);
    vt.store(Vs);
    __syncthreads();
    const int64_t nxt = kv0 + KS;
    if (nxt < cta.hi) {  // in flight while this sub-tile is computed
      kt.load(kbase + nxt * p.k_ss, p.k_ss, cta.hi - nxt, p.D);
      vt.load(vbase + nxt * p.v_ss, p.v_ss, cta.hi - nxt, p.Dv);
    }

    for (int i = tid; i < cta.n_rows * KS; i += kF32Threads) {
      const int r = i / KS, j = i % KS;
      const float* qr = Qs + r * LD;
      const float* kr = Ks + j * LD;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DMAX; ++d) s = fmaf(qr[d], kr[d], s);
      Ps[r * PLD + j] = visible(p, cta.hi, qpos_s[r], (int)(kv0 + j)) ? s : kMasked;
    }
    __syncthreads();

    for (int r = warp; r < cta.n_rows; r += kF32Threads / 32) {
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
      const int idx = tid + i * kF32Threads;
      const int r = idx / DMAX, c = idx % DMAX;
      if (r < cta.n_rows) {
        const float* pr = Ps + r * PLD;
        float a = acc[i] * a_s[r];
#pragma unroll 8
        for (int j = 0; j < KS; ++j) a = fmaf(pr[j], Vs[j * LD + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int idx = tid + i * kF32Threads;
    const int r = idx / DMAX, c = idx % DMAX;
    if (r < cta.n_rows && c < p.Dv) {
      const int row = cta.row0 + r;
      store_row<float>(p, cta, cta.head_of(row, rep), cta.t_of(row), c, m_s[r],
                       l_s[r], acc[i]);
    }
  }
  if (p.nsplit > 1)  // the tiles are read: reuse their shared memory
    merge_splits<float>(p, cta, tid, kF32Threads, [] { __syncthreads(); }, fsmem);
}

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (no
// link against libcuda); null when the CUDA driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The tensor map of a bf16 K or V cache (B, Hkv, S, cols) with element
// strides ss (key), sh (head), sb (batch) and a contiguous last dim, in
// 64 x 64 boxes with 128-byte swizzling; false when the TMA unit cannot
// read it (a base or a stride not a multiple of 16 bytes).
static bool kv_map(CUtensorMap* map, const void* base, int64_t cols, int64_t S,
                   int64_t H, int64_t B, int64_t ss, int64_t sh, int64_t sb) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (ss * 2) % 16 != 0 || (sh * 2) % 16 != 0 || (sb * 2) % 16 != 0 ||
      ss <= 0 || sh <= 0 || sb <= 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(ss * 2), (cuuint64_t)(sh * 2),
                                 (cuuint64_t)(sb * 2)};
  const cuuint32_t box[4] = {64, (cuuint32_t)kKT, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DMAX>
static int launch(const Params& p, cudaStream_t stream) {
  const int64_t rep = p.Hq / p.Hkv;
  const int64_t rows = rep * (p.bq < p.T ? p.bq : p.T);
  dim3 grid((unsigned)(p.B * p.Hkv), (unsigned)((p.T + p.bq - 1) / p.bq),
            (unsigned)((rows + kRows - 1) / kRows * p.nsplit));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int smem = BfCfg<DMAX>::SMEM;
    cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap tmk, tmv;
    const int tma = kv_map(&tmk, p.k, p.D, p.S, p.Hkv, p.B, p.k_ss, p.k_sh, p.k_sb) &&
                    kv_map(&tmv, p.v, p.Dv, p.S, p.Hkv, p.B, p.v_ss, p.v_sh, p.v_sb);
    flash_bf16_kernel<DMAX><<<grid, kBfThreads, smem, stream>>>(p, tmk, tmv, tma);
  } else {
    constexpr size_t smem = f32_smem_bytes<DMAX>();
    cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    flash_f32_kernel<DMAX><<<grid, kF32Threads, smem, stream>>>(p);
  }
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
// a contiguous (B, Hq, T, Dv) tensor of q's dtype.  With nsplit > 1 (at
// most kMaxSplits) the CTAs write the f32 partials part_acc (nsplit, B, Hq,
// T, Dv) and part_ml (nsplit, B, Hq, T, 2), and the last of each group
// merges them into out; `counter` (B, Hq, T) int32 must be zero and is zero
// again when the launch ends.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* part_acc,
    void* part_ml, void* counter, int dtype, int dmax, long long B, long long Hq,
    long long Hkv, long long T, long long S, long long D, long long Dv,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, int causal, long long window, long long q_offset,
    float scale, long long bq, long long bkv, long long nsplit,
    long long split_len, void* stream) {
  repro_fa::Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.counter = static_cast<int*>(counter);
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
  p.nsplit = nsplit;
  p.split_len = split_len;
  p.scale = scale;
  p.causal = causal;
  if (nsplit < 1 || nsplit > repro_fa::kMaxSplits) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? repro_fa::by_width<__nv_bfloat16>(dmax, p, s)
                    : repro_fa::by_width<float>(dmax, p, s);
}

// CTAs of the attention kernel for dtype (0 = bf16, 1 = f32) and head-dim
// capacity dmax that fit on one SM at once, and the shared memory of one
// CTA in bytes (static and dynamic).  Returns the cudaError_t of the query.
extern "C" int repro_flash_occupancy(int dtype, int dmax, int* blocks,
                                     int* smem_bytes) {
  auto query = [&](auto kernel, int threads, int smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return (int)e;
    *smem_bytes = smem + (int)attr.sharedSizeBytes;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                              threads, smem);
  };
  using namespace repro_fa;
  if (dtype == 0) {
    if (dmax == 64) return query(flash_bf16_kernel<64>, kBfThreads, BfCfg<64>::SMEM);
    if (dmax == 128) return query(flash_bf16_kernel<128>, kBfThreads, BfCfg<128>::SMEM);
    if (dmax == 256) return query(flash_bf16_kernel<256>, kBfThreads, BfCfg<256>::SMEM);
  } else {
    if (dmax == 64) return query(flash_f32_kernel<64>, kF32Threads, (int)f32_smem_bytes<64>());
    if (dmax == 128) return query(flash_f32_kernel<128>, kF32Threads, (int)f32_smem_bytes<128>());
    if (dmax == 256) return query(flash_f32_kernel<256>, kF32Threads, (int)f32_smem_bytes<256>());
  }
  return (int)cudaErrorInvalidValue;
}

// 1 when the bf16 kernel reads this K or V cache (B, H, S, cols; element
// strides ss, sh, sb) by TMA boxes, 0 when its producer warp copies it.
extern "C" int repro_flash_tma(const void* base, long long cols, long long S,
                               long long H, long long B, long long ss,
                               long long sh, long long sb) {
  CUtensorMap map;
  return repro_fa::kv_map(&map, base, cols, S, H, B, ss, sh, sb) ? 1 : 0;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
