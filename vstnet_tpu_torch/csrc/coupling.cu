// K1: one additive coupling block, stride 1, NCHW in and out.
//
// Replaces the TPU kernel vstnet_tpu/ops/coupling_flat.py:
// fused_coupling_flat (kernel body _coupling_kernel_flat). It computes
//   forward  y  = x1 + F(x2)       inverse  x1 = y - F(x2)
// with F = conv3 . ReLU . conv2 . ReLU . conv1, each a 3x3 conv with
// reflect pad 1 and a bias, channels C -> M -> M -> C (M = C/4). h1 and h2
// never leave the SM.
//
// What bounds it on an H100 (per pixel: 9*M*(2C+M) multiply-adds; x1, x2
// read and y written once, 6C bytes in bf16):
//   C=16,  M=4,  512x512 (stage 1)        2592 FLOP /   96 B =  27 FLOP/B
//   C=64,  M=16, 256x256 (stage 2)       41472 FLOP /  384 B = 108 FLOP/B
//   C=256, M=64, 128x128 (stage 3)      663552 FLOP / 1536 B = 432 FLOP/B
//   C=256, M=64, 128x128 (reduction)    the same as stage 3
// This design runs on the CUDA cores (float32 FMA, about 67 TFLOP/s on the
// SXM part, so the ridge is near 20 FLOP/B): all four shapes are bound by
// the FMA rate, not by HBM. It is the route of float32 (a float32 product on
// the tensor cores would be TF32, which every float32 route keeps off) and
// of bf16 at widths coupling_mma.cu is not built for; bf16 at the network's
// three widths runs on the tensor cores there.
//
// The simple design: one thread block per (frame, 16x16 output tile), of
// 512 threads at C=256 (its 216 KB of shared memory admits one block per
// SM) and 256 below. x2's window with a 3-pixel halo is staged in shared
// memory 16 input channels at a time (C=256 does not fit whole) and conv1
// sums into float32 accumulators for h1 on the tile plus a 2-pixel ring,
// held in shared memory. h2 is computed on the tile plus a 1-pixel ring, then
// conv3, the bias and the add or subtract are done in registers and
// written out. Each thread owns a register tile of 4 positions x 8 output
// channels where the conv has work enough (4 x 4, or 1 x 4 for the narrow
// stage-1 convs), on CUDA-core FMAs with float32 sums; weights are read
// through __ldg as float4.
//
// Per-conv reflection: every position of a ring that lies outside the
// image is computed at its reflected position (ReflectionPad2d of h1 and
// h2 themselves, not of x), as the TPU kernel re-reflects after each conv.
// Rounding points match the TPU kernel and the plain twin: h1 and h2 are
// rounded to the working dtype after bias + ReLU; conv3's sum stays float32,
// is added to (subtracted from) x1 in float32 and rounded once. The sum
// order of each output is fixed (no atomics, no split reduction), so the
// inverse recomputes F bit for bit.
#include "common.cuh"

namespace vst {

constexpr int kTH = 16, kTW = 16;              // output tile
constexpr int kXH = kTH + 6, kXW = kTW + 6;    // x2 window
constexpr int kAH = kTH + 4, kAW = kTW + 4;    // h1 ring
constexpr int kBH = kTH + 2, kBW = kTW + 2;    // h2 ring

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    coupling_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                    const float* __restrict__ wp, T* __restrict__ out, int C,
                    int M, int H, int W, int inverse) {
  extern __shared__ float smem[];
  const int chunk = min(C, kChunk);
  float* xs = smem;                          // [chunk][kXH][kXW]
  float* h1 = xs + chunk * kXH * kXW;        // [M][kAH][kAW]
  float* h2 = h1 + M * kAH * kAW;            // [M][kBH][kBW]

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const size_t plane = (size_t)H * W;
  const T* x2b = x2 + (size_t)b * C * plane;

  const float* w1 = wp;
  const float* b1 = w1 + (size_t)C * 9 * M;
  const float* w2 = b1 + M;
  const float* b2 = w2 + (size_t)M * 9 * M;
  const float* w3 = b2 + M;
  const float* b3 = w3 + (size_t)M * 9 * C;

  for (int i = threadIdx.x; i < M * kAH * kAW; i += blockDim.x) h1[i] = 0.f;

  // conv1, accumulated over input-channel chunks
  for (int ci0 = 0; ci0 < C; ci0 += chunk) {
    const int cn = min(chunk, C - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * kXH * kXW; i += blockDim.x) {
      const int ci = i / (kXH * kXW);
      const int rem = i % (kXH * kXW);
      const int gr = reflect(r0 - 3 + rem / kXW, H);
      const int gc = reflect(c0 - 3 + rem % kXW, W);
      xs[i] = to_f<T>(x2b[(ci0 + ci) * plane + (size_t)gr * W + gc]);
    }
    __syncthreads();
    conv_auto(
        kAH * kAW, M, xs, kXH * kXW, w1 + (size_t)ci0 * 9 * M, cn,
        [=](int pos, int* ro, int* co) {
          const int q = reflect(r0 - 2 + pos / kAW, H);
          const int qc = reflect(c0 - 2 + pos % kAW, W);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ro[k] = clampi(q - 1 + k - (r0 - 3), 0, kXH - 1) * kXW;
            co[k] = clampi(qc - 1 + k - (c0 - 3), 0, kXW - 1);
          }
        },
        [=](int pos, int c) { return h1[c * kAH * kAW + pos]; },
        [=](int pos, int c, float s) { h1[c * kAH * kAW + pos] = s; });
  }
  __syncthreads();
  finish_h1<T>(h1, b1, M, kAH * kAW);
  __syncthreads();
  conv_h2<T, kAH, kAW, kBH, kBW>(h1, h2, w2, b2, M, r0 - 1, c0 - 1, H, W);
  __syncthreads();

  // conv3 + bias, then x1 +- F in float32, rounded once
  conv_auto(
      kTH * kTW, C, h2, kBH * kBW, w3, M,
      [=](int pos, int* ro, int* co) {
        const int i = pos / kTW, j = pos % kTW;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ro[k] = (i + k) * kBW;
          co[k] = j + k;
        }
      },
      [](int, int) { return 0.f; },
      [=](int pos, int ch, float s) {
        const int r = r0 + pos / kTW, c = c0 + pos % kTW;
        if (r >= H || c >= W) return;
        const float f = s + __ldg(b3 + ch);
        const size_t idx = ((size_t)b * C + ch) * plane + (size_t)r * W + c;
        const float xv = to_f<T>(x1[idx]);
        out[idx] = from_f<T>(inverse ? xv - f : xv + f);
      });
}

template <typename T>
int launch_coupling(const void* x1, const void* x2, const void* w, void* out,
                    int B, int C, int M, int H, int W, int inverse,
                    cudaStream_t stream) {
  const int chunk = min(C, kChunk);
  const size_t smem = sizeof(float) * ((size_t)chunk * kXH * kXW +
                                       (size_t)M * kAH * kAW +
                                       (size_t)M * kBH * kBW);
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      coupling_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  coupling_kernel<T><<<grid, block_threads(smem), smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const float*>(w), static_cast<T*>(out), C, M, H, W,
      inverse);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_coupling(const void* x1, const void* x2, const void* w,
                            void* out, int B, int C, int M, int H, int W,
                            int inverse, int is_bf16, void* stream) {
  if (C % 4 || M % 4 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vst::launch_coupling<__nv_bfloat16>(x1, x2, w, out, B, C,
                                                       M, H, W, inverse, s)
                 : vst::launch_coupling<float>(x1, x2, w, out, B, C, M, H, W,
                                               inverse, s);
}

extern "C" const char* vst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
