// Tensor-core and asynchronous-copy primitives of the attention (K4), the
// bf16 coupling (K1) and the bf16 transition (K2, K3) kernels: ldmatrix, mma.sync.m16n8k16 (bf16 in,
// float32 accumulators) and cp.async, as inline PTX.
//
// Fragment layouts of mma.sync.m16n8k16, lane = 4 * g + t:
//   A (16 x 16, row): a0 = (row g,     k 2t, 2t+1)   a1 = (row g + 8, same k)
//                     a2 = (row g,     k 2t+8, +9)   a3 = (row g + 8, same k)
//   B (16 x 8,  col): b0 = (k 2t, 2t+1, col g)       b1 = (k 2t+8, +9, col g)
//   C (16 x 8):       c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g + 8)
// ldmatrix.x4 reads four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7
// give the addresses of the 8 rows (16 bytes each) of matrix i, and lane
// 4g + t receives elements (g, 2t) and (g, 2t + 1) of each matrix, or with
// .trans elements (2t, g) and (2t + 1, g).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b, one 16 x 8 x 16 product on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; src_bytes < 16 fills the rest
// with zeros (0: all zeros, src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are pending
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile whose rows
// are ROW_BYTES (32, 64 or 128) long, XOR-swizzled so that the 8 rows of
// an ldmatrix (8 consecutive rows, one chunk column) fall into 8 different
// 16-byte bank groups.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  constexpr int n = ROW_BYTES / 16;       // chunks per row
  constexpr int rows_per_line = 8 / n;    // rows per 128 bytes
  return (uint32_t)row * ROW_BYTES +
         (uint32_t)((chunk ^ ((row / rows_per_line) % n)) << 4);
}

}  // namespace vst
