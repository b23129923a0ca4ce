// TMA boxes and reading them, shared by the port's TMA-fed kernels
// (flash_attention.cu's K/V ring, flash_prefill.cu's Q tile and K/V ring,
// and gemm.cu's `matmul` feed).
//
// A producer lane asks the TMA unit for whole boxes of a tensor map into a
// ring of shared-memory stages; each stage completes on an mbarrier's
// transaction count (`mbar_arrive_tx` + `tma_box*`), and the consumer warps
// give it back on a second mbarrier.  The boxes are swizzled (`swizzle`),
// so `ldmatrix` reads their 8 x 16-byte rows without bank conflicts into
// `mma.sync` fragments.  `encode_tiled` reaches cuTensorMapEncodeTiled in
// the CUDA driver through the runtime, so nothing links against libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// Makes the initialised mbarriers visible to the TMA unit (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and add `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Orders this thread's reads of a ring stage (generic proxy: ldmatrix,
// plain loads) before the TMA unit's next writes into it (async proxy), as
// the PTX memory model asks of one location accessed through two proxies.
// Every consumer thread runs it before its warp gives the stage back on
// the stage's empty mbarrier.  Without it the card gave a wrong `matmul`
// tile, now and then, in concurrent op bundles (PERF.md section 6).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// One box of a 4-D tensor map (d, key, kv head, batch) into shared memory
// by the TMA unit (elements past the tensor read as zero); completes on
// `bar`'s transaction count.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int d, int key, int head, int batch,
                                        unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(d),
        "r"(key), "r"(head), "r"(batch), "r"(bar) : "memory");
}

// One box of a 2-D tensor map at (inner, outer) coordinates, the same way,
// with an L2 eviction policy (cp_async.cuh's `l2_policy`).
__device__ __forceinline__ void tma_box_2d(void* dst, const CUtensorMap* map,
                                           int inner, int outer, unsigned bar,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner),
        "r"(outer), "r"(bar), "l"(policy) : "memory");
}

// Barrier 1 of THREADS threads: the consumer warps of a warp-specialised
// CTA, whose producer warp has left (barrier 0 is __syncthreads').
template <int THREADS>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// Byte offset `o` of a box whose rows are SPAN bytes (32, 64 or 128), as
// the TMA unit stores it under CU_TENSOR_MAP_SWIZZLE_<SPAN>B: the 16-byte
// chunk index within each 128-byte line is XORed with the line index
// (mod SPAN / 16).  The box must start on a 1024-byte boundary.
template <int SPAN>
__device__ __forceinline__ int swizzle(int o) {
  static_assert(SPAN == 32 || SPAN == 64 || SPAN == 128, "a TMA swizzle span");
  return o ^ ((o >> 3) & ((SPAN / 16 - 1) << 4));
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

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (no
// link against libcuda); null when the CUDA driver does not offer it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// The tensor map of a row-major bf16 matrix (rows, cols) with leading
// dimension `ld` elements, in boxes of (box_rows, box_cols) stored with
// the swizzle of a box_cols * 2-byte row (32, 64 or 128 bytes); elements
// past the matrix read as zero.  False when the TMA unit cannot read it:
// a base or a row stride not a multiple of 16 bytes, or a dimension
// outside its signed 32-bit coordinates.
inline bool tensor_map_2d(CUtensorMap* map, const void* base, int64_t rows,
                          int64_t cols, int64_t ld, int box_rows, int box_cols) {
  const EncodeTiled enc = encode_tiled();
  const int span = box_cols * 2;
  if (enc == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (ld * 2) % 16 != 0 || rows < 1 || cols < 1 || ld < cols ||
      rows >= (int64_t(1) << 31) || cols >= (int64_t(1) << 31) ||
      (span != 32 && span != 64 && span != 128))
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * 2)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUtensorMapSwizzle swz = span == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a bf16 tensor (batch, heads, rows, cols) with element
// strides s_row, s_head, s_batch and contiguous cols, in boxes of 64 rows
// x 64 columns (128 bytes) under 128-byte swizzling; elements past the
// tensor read as zero.  False when the TMA unit cannot read it: a base or
// a stride not a multiple of 16 bytes.
inline bool tensor_map_4d(CUtensorMap* map, const void* base, int64_t cols,
                          int64_t rows, int64_t heads, int64_t batch,
                          int64_t s_row, int64_t s_head, int64_t s_batch) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      s_row <= 0 || s_head <= 0 || s_batch <= 0 || (s_row * 2) % 16 != 0 ||
      (s_head * 2) % 16 != 0 || (s_batch * 2) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)(s_row * 2), (cuuint64_t)(s_head * 2),
                                 (cuuint64_t)(s_batch * 2)};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace repro
