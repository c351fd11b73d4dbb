// Hopper's warpgroup products, as inline PTX, for the coupling kernel at
// C=256 (coupling_mma.cu: coupling_mma_wg_kernel): wgmma.mma_async
// m64n64k16 with A from registers and B read from shared memory through a
// matrix descriptor (its mbarriers and copies are tensor_map.cuh's).
//
// Fragment layouts of wgmma.m64nNk16 (bf16 in, float32 accumulators),
// warp w = warp % 4 of the warpgroup owning rows 16w .. 16w + 15, lane
// 4g + t: A as mma.sync.m16n8k16's A over those 16 rows (mma.cuh), so an
// ldmatrix.x4 makes it; the accumulator d[4j .. 4j + 3] as mma.sync's C of
// n-tile j (columns 8j .. 8j + 7).
//
// B is K-major without swizzle: 8 x 8 core matrices (8 columns n, each 16
// contiguous bytes of 8 k), every core matrix 128 contiguous bytes, so a
// core matrix is one conflict-free shared-memory wavefront. A k-block of
// 16 k x 64 n is the core matrices [n / 8][k / 8] in that order: the two
// k halves of a column group lie 128 bytes apart (the leading byte
// offset), the column groups 256 bytes apart (the stride byte offset).
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace vst {

constexpr int kWgKBlock = 64 * 16 * 2;       // bytes of one 16 x 64 k-block

// descriptor of a k-block at shared address `addr` (no swizzle)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are pending
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a * B for one 64 x 64 x 16 product of the warpgroup
__device__ __forceinline__ void wg_mma_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// four 8 x 8 bf16 matrices in mma fragment layout (register i: matrix i,
// row g, columns 2t, 2t + 1) stored transposed: row j of matrix i (its
// column j, 8 values) at the 16-byte address that lane 8i + j gives
__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, const uint4& v) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// named barrier `id` (1 .. 15) over `count` threads
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace vst
