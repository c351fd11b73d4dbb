// Shared device helpers of the hand-written kernels: widening and rounding
// of the element types, and the reflect-pad index map.
//
// Activations are templated on the element type (float or __nv_bfloat16)
// and are widened to float in shared memory. The CUDA-core coupling and
// transition kernels' weights arrive packed once at load time
// (ops/coupling_fused.py:pack_coupling_weights) as float32 holding
// working-dtype values, in [ci][ky][kx][co] order: w1 [Cin][3][3][M], b1
// [M], w2 [M][3][3][M], b2 [M], w3 [M][3][3][Cout], b3 [Cout]. Every
// segment is a multiple of 4 floats (M % 4 == 0), so float4 loads stay
// aligned. Their convs are in conv_fma.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vst {

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

}  // namespace vst
