// Shared device helpers of the coupling (K1) and transition (K2) kernels.
//
// Activations are templated on the element type (float or __nv_bfloat16)
// and are widened to float in shared memory. Weights arrive packed once
// at load time (ops/coupling_fused.py:pack_coupling_weights) as float32
// holding working-dtype values, in [ci][ky][kx][co] order, so the output
// channels a thread computes are read as 16-byte loads.
//
// Packed weight buffer of one block: w1 [Cin][3][3][M], b1 [M],
// w2 [M][3][3][M], b2 [M], w3 [M][3][3][Cout], b3 [Cout]. Every segment
// is a multiple of 4 floats (M % 4 == 0), so float4 loads stay aligned.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

constexpr int kMaxThreads = 512;

// Threads per block: 512 when the block's shared memory leaves room for
// only one block per SM (the C=256 couplings, the M=64 transition), so 16
// warps hide load latency instead of 8; 256 otherwise.
inline int block_threads(size_t smem_bytes) {
  return smem_bytes > 113 * 1024 ? kMaxThreads : kMaxThreads / 2;
}

// input channels staged in shared memory per pass of conv1
constexpr int kChunk = 16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and widened back: the working-dtype rounding point of
// h1 and h2.
template <typename T> __device__ __forceinline__ float round_as(float v) {
  return to_f<T>(from_f<T>(v));
}

// ReflectionPad(1) index map (-1 -> 1, n -> n-2), clamped into [0, n) so
// that positions no output depends on still read in bounds.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ int clampi(int i, int lo, int hi) {
  return min(max(i, lo), hi);
}

// One 3x3 conv over shared memory, as a loop over work items. An item is
// NQ consecutive output channels at NP positions; the positions of item
// (g, b) are b, b + nb, b + 2nb, ... (nb = ceil(P / NP)), so the lanes of a
// warp read neighbouring shared-memory words. For each position `offs`
// gives the 3 row offsets (already times the row pitch) and 3 column
// offsets of its taps in `in` (a stack of planes `plane` floats apart);
// `init(pos, ch)` gives the starting sum and `emit(pos, ch, sum)` takes
// the result. Each output sums ci, then ky, then kx in a fixed order: the
// forward and inverse of a block compute the same F bit for bit.
template <int NP, int NQ, typename Offs, typename Init, typename Emit>
__device__ __forceinline__ void conv_items(int P, int cout, const float* in,
                                           int plane,
                                           const float* __restrict__ w,
                                           int cn, Offs offs, Init init,
                                           Emit emit) {
  const int nb = (P + NP - 1) / NP;
  const int n_items = (cout / NQ) * nb;
  for (int it = threadIdx.x; it < n_items; it += blockDim.x) {
    const int g = it / nb, bnd = it % nb;
    int ro[NP][3], co[NP][3];
    float acc[NP][NQ];
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int pos = min(bnd + k * nb, P - 1);
      offs(pos, ro[k], co[k]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[k][q] = init(pos, NQ * g + q);
    }
    const float* wg = w + NQ * g;
    for (int ci = 0; ci < cn; ++ci) {
      const float* p = in + ci * plane;
      const float* wc = wg + (size_t)ci * 9 * cout;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float v[NP];
#pragma unroll
          for (int k = 0; k < NP; ++k) v[k] = p[ro[k][ky] + co[k][kx]];
#pragma unroll
          for (int q4 = 0; q4 < NQ / 4; ++q4) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(
                wc + (ky * 3 + kx) * cout + 4 * q4));
#pragma unroll
            for (int k = 0; k < NP; ++k) {
              acc[k][4 * q4 + 0] = fmaf(v[k], wv.x, acc[k][4 * q4 + 0]);
              acc[k][4 * q4 + 1] = fmaf(v[k], wv.y, acc[k][4 * q4 + 1]);
              acc[k][4 * q4 + 2] = fmaf(v[k], wv.z, acc[k][4 * q4 + 2]);
              acc[k][4 * q4 + 3] = fmaf(v[k], wv.w, acc[k][4 * q4 + 3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int pos = bnd + k * nb;
      if (pos < P) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) emit(pos, NQ * g + q, acc[k][q]);
      }
    }
  }
}

// conv_items with a register tile picked from the work available: 4
// positions x 8 channels where that still gives every thread an item, else
// 4 x 4, else 1 x 4 (the narrow stage-1 convs). The choice depends only on
// the shape, so it is the same for every block and every call.
template <typename Offs, typename Init, typename Emit>
__device__ __forceinline__ void conv_auto(int P, int cout, const float* in,
                                          int plane,
                                          const float* __restrict__ w, int cn,
                                          Offs offs, Init init, Emit emit) {
  const int nb4 = (P + 3) / 4;
  if (cout % 8 == 0 && (cout / 8) * nb4 >= (int)blockDim.x)
    conv_items<4, 8>(P, cout, in, plane, w, cn, offs, init, emit);
  else if ((cout / 4) * nb4 >= (int)blockDim.x)
    conv_items<4, 4>(P, cout, in, plane, w, cn, offs, init, emit);
  else
    conv_items<1, 4>(P, cout, in, plane, w, cn, offs, init, emit);
}

// h2 from h1, both in shared memory, over a ring of BH x BW positions
// whose image rows/cols start at (br, bc); h1 covers rows/cols starting at
// (br - 1, bc - 1) on an AH x AW grid. Positions outside the image take
// the value at their reflected position (per-conv ReflectionPad2d of h2).
// Result: round_as<T>(ReLU(conv + b2)).
template <typename T, int AH, int AW, int BH, int BW>
__device__ __forceinline__ void conv_h2(const float* h1, float* h2,
                                        const float* __restrict__ w2,
                                        const float* __restrict__ b2, int M,
                                        int br, int bc, int H, int W) {
  conv_auto(
      BH * BW, M, h1, AH * AW, w2, M,
      [=](int pos, int* ro, int* co) {
        const int q = reflect(br + pos / BW, H);
        const int qc = reflect(bc + pos % BW, W);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ro[k] = clampi(q - 1 + k - (br - 1), 0, AH - 1) * AW;
          co[k] = clampi(qc - 1 + k - (bc - 1), 0, AW - 1);
        }
      },
      [](int, int) { return 0.f; },
      [=](int pos, int c, float s) {
        h2[c * BH * BW + pos] = round_as<T>(fmaxf(s + __ldg(b2 + c), 0.f));
      });
}

// Finish h1 in place: round_as<T>(ReLU(sum + b1)).
template <typename T>
__device__ __forceinline__ void finish_h1(float* h1,
                                          const float* __restrict__ b1, int M,
                                          int plane) {
  for (int i = threadIdx.x; i < M * plane; i += blockDim.x)
    h1[i] = round_as<T>(fmaxf(h1[i] + __ldg(b1 + i / plane), 0.f));
}

}  // namespace vst
