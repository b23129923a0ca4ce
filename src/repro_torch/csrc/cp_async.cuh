// cp.async helpers shared by the port's shared-memory rings (the Stream-K
// walk in gemm_stream_k.cu and the ragged walk in grouped_gemm.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

// cp.async: 16-byte copies from device memory into shared memory that
// bypass the registers and L1 (`cp.async.cg`), grouped and waited on as
// a ring of stages.  `copy_chunk` moves one 16-byte chunk of a row-major
// (rows, cols) matrix: by cp.async when the chunk lies wholly inside the
// matrix and its source is 16-byte aligned, else by element loads (zero
// past the edges) and a plain shared-memory store.  Both land before the
// consumer's `cp_async_wait` + `__syncthreads`, so a stage may mix them.
// A copy may carry an L2 eviction policy (`l2_policy`); `NoHint` is none.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// The same copy with an L2 eviction policy (`l2_policy`): a stream read
// once is marked evict-first, so that it does not push out data that
// other CTAs read again.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "l"(policy));
}

// A copy with no L2 hint.
struct NoHint {};
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, NoHint) {
  cp_async16(smem, gmem);
}

// An L2 access policy for all of an access's lines: evict first (a stream
// read once) or evict last (data read again by other CTAs).
template <bool EVICT_FIRST>
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t p;
  if (EVICT_FIRST)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Chunk (r, c..c+VEC) of a row-major matrix `src` with leading dimension
// `ld` whose element (r, c) exists for r < rows and c < cols, into `dst`
// (16-byte aligned shared memory), by cp.async with L2 hint `hint`.
template <typename T, typename Hint = NoHint>
__device__ __forceinline__ void copy_chunk(T* dst, const T* __restrict__ src,
                                           int64_t ld, int64_t r, int64_t c,
                                           int64_t rows, int64_t cols,
                                           Hint hint = {}) {
  using Bits = typename std::conditional<sizeof(T) == 2, unsigned short,
                                         unsigned int>::type;
  constexpr int VEC = 16 / sizeof(T);
  const Bits* p = reinterpret_cast<const Bits*>(src) + r * ld + c;
  if (r < rows && c + VEC <= cols &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    cp_async16(dst, p, hint);
    return;
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r < rows && c < cols) {
    Bits* vb = reinterpret_cast<Bits*>(&v);
#pragma unroll
    for (int e = 0; e < VEC; ++e) vb[e] = (c + e < cols) ? p[e] : Bits(0);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// A (TR x TC) tile of a row-major matrix, chunk by chunk over NT threads,
// into shared memory with row stride LD elements (LD·sizeof(T) a multiple
// of 16); tile row i is matrix row r0 + i.  `hint` as for copy_chunk.
template <typename T, int TR, int TC, int LD, int NT, typename Hint = NoHint>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src,
                                          int64_t ld, int64_t r0, int64_t c0,
                                          int64_t rows, int64_t cols,
                                          Hint hint = {}) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = TC / VEC;  // chunks per row
  static_assert(TC % VEC == 0, "tile width is whole chunks");
  static_assert((TR * CPR) % NT == 0, "chunks divide among threads");
  static_assert((LD * sizeof(T)) % 16 == 0, "rows stay 16-byte aligned");
#pragma unroll
  for (int j = 0; j < TR * CPR / NT; ++j) {
    const int chunk = threadIdx.x + j * NT;
    const int i = chunk / CPR, cc = (chunk % CPR) * VEC;
    copy_chunk<T>(dst + i * LD + cc, src, ld, r0 + i, c0 + cc, rows, cols,
                  hint);
  }
}

constexpr int kStages = 4;  // shared-memory ring depth of the walks

}  // namespace repro
