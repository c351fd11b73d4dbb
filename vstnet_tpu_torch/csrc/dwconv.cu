// K5: 3x3 depthwise conv + bias + exact GELU of the SegFormer MixFFN, NHWC.
//
// Replaces the TPU kernel vstnet_tpu/ops/dwconv.py: dwconv3x3_bias_gelu
// (kernel body _dwconv_kernel). For x (B, H, W, C) in bf16, taps w (3, 3, C)
// and bias (C,) in float32 it computes, in one pass,
//   out = gelu(sum_{ky,kx} x[y+ky-1, x+kx-1, c] * w[ky, kx, c] + bias[c])
// with zero SAME padding, the taps multiplied and summed in float32 in
// (ky, kx) order, the erf form of GELU in float32, and one rounding to
// bf16. CUDA has erff, so the TPU kernel's rational erf is not carried
// over; the two differ by less than 1e-6, far under a bf16 ulp.
//
// What bounds it on an H100: 18 FLOP plus one erf per element against
// 4 bytes (x read once, out written once), so it is bound by bytes at
// every shape. The design keeps the traffic near that minimum: channels
// are innermost, one thread owns 8 channels of one pixel and reads each of
// its 9 taps as one 16-byte load (neighbouring threads read neighbouring
// channels, so a warp's load is contiguous); the 8 re-reads of each input
// element by neighbouring pixels hit L1/L2. Padding is a predicate on the
// tap, no padded copy is made. Weights and bias are read through __ldg.
#include "common.cuh"

namespace vst {

constexpr int kDwThreads = 256;

__global__ void __launch_bounds__(kDwThreads)
    dwconv_gelu_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int B, int H, int W,
                       int C) {
  const int groups = C / 8;
  const long long total = (long long)B * H * W * groups;
  const long long idx = (long long)blockIdx.x * kDwThreads + threadIdx.x;
  if (idx >= total) return;
  const int c0 = (int)(idx % groups) * 8;
  const long long pix = idx / groups;
  const int px = (int)(pix % W);
  const int py = (int)((pix / W) % H);
  const long long b = pix / ((long long)W * H);
  const __nv_bfloat16* xb = x + b * H * W * C;

  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int yy = py + ky - 1;
    if (yy < 0 || yy >= H) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int xx = px + kx - 1;
      if (xx < 0 || xx >= W) continue;
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          xb + ((long long)yy * W + xx) * C + c0));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float* wt = w + (ky * 3 + kx) * C + c0;
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wt));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wt + 4));
      const float wa[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = __bfloat1622float2(p[j]);
        acc[2 * j] = fmaf(v.x, wa[2 * j], acc[2 * j]);
        acc[2 * j + 1] = fmaf(v.y, wa[2 * j + 1], acc[2 * j + 1]);
      }
    }
  }
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + c0));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + c0 + 4));
  const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  unsigned int packed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float g[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float s = acc[2 * j + t] + ba[2 * j + t];
      g[t] = 0.5f * s * (1.f + erff(s * 0.70710678f));
    }
    const __nv_bfloat162 r = __floats2bfloat162_rn(g[0], g[1]);
    packed[j] = *reinterpret_cast<const unsigned int*>(&r);
  }
  *reinterpret_cast<uint4*>(out + pix * C + c0) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

}  // namespace vst

extern "C" int vst_dwconv_gelu(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C,
                               void* stream) {
  using namespace vst;
  if (C % 8 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * H * W * (C / 8);
  const long long blocks = (total + kDwThreads - 1) / kDwThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // report only what this launch does
  dwconv_gelu_kernel<<<(unsigned int)blocks, kDwThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), B, H,
      W, C);
  return (int)cudaGetLastError();
}
