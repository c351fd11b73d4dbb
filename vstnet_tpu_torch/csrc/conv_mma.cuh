// What the tensor-core conv kernels share (coupling_mma.cu: K1;
// transition_mma.cu: K2 and K3): a 3x3 conv as an implicit GEMM on
// mma.sync.m16n8k16 over position-major swizzled tiles in shared memory.
// Rows of the product are tile positions, columns output channels, depth
// the nine taps times the input channels. A row of an ldmatrix is 16 bytes
// (8 channels) of one position, so the 3x3 gather is a per-lane address:
// the position of the row's centre plus the tap's offset, which a Taps
// policy gives (stride 1, or stride 2 over four 2x2 phase planes). Weights
// are bf16 pieces of [tap][ci][co], streamed by cp.async; ldmatrix.trans
// makes the B fragments.
#pragma once

#include "common.cuh"
#include "mma.cuh"

// Phase timing for scripts/torch_k1_phase_ticks.py (for machines where no
// profiler can look inside a kernel): built with -DVST_PHASE_TICKS, every
// warp of a kernel notes clock64() at its phase boundaries and writes the
// differences to the buffer `buf` (a __device__ pointer of the kernel's own
// source, set through its vst_*_set_ticks entry): a row of 16 warps x 8
// values per block, in the grid's order. Without the flag, as the port
// builds it, the macros are empty.
#ifdef VST_PHASE_TICKS
#define VST_TICKS_BEGIN() \
  long long vst_tk[8];    \
  int vst_nk = 0;         \
  VST_TICK()
#define VST_TICK() (vst_tk[vst_nk++] = clock64())
// a count of cycles (not a stamp), written as it is
#define VST_TICK_VALUE(v) (vst_tk[vst_nk++] = vst_tk[0] + (v))
// stmt, its cycles added to `acc`
#define VST_TIMED(acc, stmt)        \
  do {                              \
    const long long vst_t0 = clock64(); \
    stmt;                           \
    (acc) += clock64() - vst_t0;    \
  } while (0)
#define VST_TICKS_END(buf)                                                  \
  if ((buf) != nullptr && (threadIdx.x & 31) == 0) {                        \
    const size_t blk =                                                      \
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +         \
        blockIdx.x;                                                         \
    for (int i = 0; i < vst_nk; ++i)                                        \
      (buf)[(blk * 16 + (threadIdx.x >> 5)) * 8 + i] =                      \
          vst_tk[i] - vst_tk[0];                                            \
  }
#else
#define VST_TICKS_BEGIN()
#define VST_TICK()
#define VST_TICK_VALUE(v)
#define VST_TIMED(acc, stmt) stmt
#define VST_TICKS_END(buf)
#endif

namespace vst {

// Offset, in positions of the source tile, of tap (ky, kx) = (tap / 3,
// tap % 3) from a row's centre. Stride 1: the 3x3 neighbourhood in a tile
// of pitch PITCH.
template <int PITCH> struct TapsStride1 {
  static __device__ __forceinline__ int shift(int tap) {
    return (tap / 3 - 1) * PITCH + (tap % 3 - 1);
  }
};

// Stride 2 over a window staged as its four 2x2 phases: plane (p, q) holds
// full-res (2r + p, 2c + q) at half-res position (r, c); the planes are
// PLANE positions apart, each of pitch PITCH. Output (r, c) reads full-res
// rows 2r - 1, 2r, 2r + 1: phase 1 of row r - 1, phases 0 and 1 of row r;
// columns alike.
template <int PITCH, int PLANE> struct TapsStride2 {
  static __device__ __forceinline__ int shift(int tap) {
    const int ky = tap / 3, kx = tap % 3;
    const int p = ky == 1 ? 0 : 1, q = kx == 1 ? 0 : 1;
    return (p * 2 + q) * PLANE - (ky == 0 ? PITCH : 0) - (kx == 0 ? 1 : 0);
  }
};

// One weight piece ([rows][ROW_BYTES], contiguous in global memory) into a
// swizzled stage, by all threads of the block.
template <int ROW_BYTES>
__device__ __forceinline__ void load_piece(uint32_t dst, const char* src,
                                           int bytes) {
  constexpr int n = ROW_BYTES / 16;
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    cp_async16(dst + swz<ROW_BYTES>(i / n, i % n), src + (size_t)i * 16);
}

// acc += A * B for one weight piece: MT m-tiles of 16 rows, NT n-tiles of
// 8 columns, nine taps of KSTEPS k-steps. `centre[mt]` is the position, in
// the source tile, of the centre of this lane's ldmatrix row (row lane % 16
// of m-tile mt) and Taps::shift(tap) the tap's offset from it; a_chunk0 the
// 16-byte chunk of a source position where the piece's input channels
// start; b_chunk0 the chunk of a piece row where this warp's columns start.
template <int MT, int NT, int KSTEPS, int A_ROW, int B_ROW, typename Taps>
__device__ __forceinline__ void conv_piece(float (&acc)[MT][NT][4],
                                           uint32_t a_base,
                                           const int (&centre)[MT],
                                           int a_chunk0, uint32_t b_base,
                                           int b_chunk0, int lane) {
  const int khalf = lane >> 4, krow = lane & 15;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = Taps::shift(tap);
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], a_base + swz<A_ROW>(centre[mt] + shift,
                                           a_chunk0 + ks * 2 + khalf));
      const int row = (tap * KSTEPS + ks) * 16 + krow;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_base + swz<B_ROW>(row, b_chunk0 + np * 2 + khalf));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
}

// bf16(ReLU(acc + bias)) of one 32-row unit into a position-major tile of
// `count` positions; rows at or past `count` are padding and not stored
template <int NT, int ROW>
__device__ __forceinline__ void store_hidden(const float (&acc)[2][NT][4],
                                             unsigned char* tile,
                                             const float* __restrict__ bias,
                                             int row0, int count, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = row0 + mt * 16 + g + 8 * hf;
      if (p >= count) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(tile + swz<ROW>(p, nt) + t * 4) =
            pack_bf16(
                fmaxf(acc[mt][nt][2 * hf] + __ldg(bias + co), 0.f),
                fmaxf(acc[mt][nt][2 * hf + 1] + __ldg(bias + co + 1), 0.f));
      }
    }
}

}  // namespace vst
