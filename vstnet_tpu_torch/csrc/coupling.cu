// K1: one additive coupling block, stride 1, NCHW in and out, on the CUDA
// cores.
//
// Replaces the TPU kernel vstnet_tpu/ops/coupling_flat.py:
// fused_coupling_flat (kernel body _coupling_kernel_flat). It computes
//   forward  y  = x1 + F(x2)       inverse  x1 = y - F(x2)
// with F = conv3 . ReLU . conv2 . ReLU . conv1, each a 3x3 conv with
// reflect pad 1 and a bias, channels C -> M -> M -> C (M = C/4). h1 and h2
// never leave the SM.
//
// This file is the route of float32 at every width (a float32 product on
// the tensor cores would be TF32, which every float32 route keeps off) and
// of bf16 at widths coupling_mma.cu is not built for.
//
// What bounds it on an H100 SXM (per pixel 9*M*(2C+M) multiply-adds; x1,
// x2 read and y written once, 12C bytes in float32; float32 FMA about 67
// TFLOP/s, HBM 3.35 TB/s, so the ridge is near 20 FLOP/B):
//   C=16,  M=4,  512x512 (stage 1)      2592 FLOP /  192 B =  13.5 FLOP/B: bytes
//   C=64,  M=16, 256x256 (stage 2)     41472 FLOP /  768 B =  54 FLOP/B: FMA
//   C=256, M=64, 128x128 (stages 3, 4) 663552 FLOP / 3072 B = 216 FLOP/B: FMA
// Fused in one block, a 16x16 output tile also computes conv1 on a 2-pixel
// ring (20x20) and conv2 on a 1-pixel ring (18x18): 28 % more FMAs at
// C=256 and C=64. The ring is what keeps h1 and h2 on the SM; at C=16,
// bound by bytes, it costs nothing that shows.
//
// The design (conv_fma.cuh): each conv is an implicit GEMM from shared
// memory into register tiles. conv1's sums stay in registers across all
// input chunks; each chunk of x2's window (16x16 + 3-pixel halo) and its
// weights are copied into shared memory with cp.async while the previous
// chunk is summed; conv2's and conv3's weights are streamed the same way
// beside h1 and h2, which stay in shared memory. The tile of a thread and
// the block size are picked per width (FmaCfg below) so that one round of
// items covers conv1 and the grid fills the SMs:
//   C=256: 256 threads, one block an SM (h1 + h2 take 185 KB); conv1 5x5
//     positions x 4 channels a thread, conv2 1x6 x 16, conv3 in four
//     64-channel rounds of 1x8 x 8;
//   C=64: 320 threads, two blocks an SM; 1x5 x 4, 1x6 x 4, 1x8 x 4;
//   C=16: 128 threads, four blocks an SM; 1x4 x 4, 1x3 x 4, 1x8 x 4;
//   any other width (and bf16 at every width): 256 threads, as C=64.
//
// Rounding points match the TPU kernel and the plain twin: h1 and h2 are
// rounded to the working dtype after bias + ReLU; conv3's sum stays
// float32, is added to (subtracted from) x1 in float32 and rounded once.
#include "conv_fma.cuh"

namespace vst {

constexpr int kTH = 16, kTW = 16;              // output tile
constexpr int kXH = kTH + 6, kXW = kTW + 6;    // x2 window
constexpr int kAH = kTH + 4, kAW = kTW + 4;    // h1 ring
constexpr int kBH = kTH + 2, kBW = kTW + 2;    // h2 ring
// row pitches (one float of padding spreads a tile's rows over the banks)
constexpr int kXP = kXW + 1, kAP = kAW + 1, kBP = kBW + 1;
constexpr int kXPlane = kXH * kXP, kAPlane = kAH * kAP, kBPlane = kBH * kBP;

using G1 = Geom<kAH, kAW, 1, kXP, kXPlane>;   // conv1: x2 window -> h1
using G2 = Geom<kBH, kBW, 1, kAP, kAPlane>;   // conv2: h1 -> h2
using G3 = Geom<kTH, kTW, 1, kBP, kBPlane>;   // conv3: h2 -> out

// the configurations per width (conv_fma.cuh: FmaCfg)
using Wide = FmaCfg<256, 1, Tile<5, 5, 4>, Tile<1, 6, 16>, Tile<1, 8, 8>, 8, 8>;
using Mid = FmaCfg<320, 2, Tile<1, 5, 4>, Tile<1, 6, 4>, Tile<1, 8, 4>, 8, 8>;
using Narrow = FmaCfg<128, 4, Tile<1, 4, 4>, Tile<1, 3, 4>, Tile<1, 8, 4>, 16, 4>;
using Generic =
    FmaCfg<256, 1, Tile<1, 5, 4>, Tile<1, 6, 4>, Tile<1, 8, 4>, 8, 8>;

template <typename T, class K>
__global__ void __launch_bounds__(K::NT, K::MINB)
    coupling_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                    const float* __restrict__ wp, T* __restrict__ out, int C,
                    int M, int H, int W, int inverse, FmaPlan pl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h1 = smem;                         // [M][kAH][kAP]
  float* h2 = smem + pl.h2;                 // [M][kBH][kBP]
  float* const buf1[2] = {smem + pl.s1, smem + pl.s1 + pl.buf1};
  float* const buf2[2] = {smem + pl.s2, smem + pl.s2 + pl.buf2};

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

  // conv1: x2's window (reflected at the image edge) -> h1 on the ring
  conv_fma<K::NT, typename K::Tile1, G1>(
      C, M, pl.kc1, w1, nullptr, pl.in1, buf1,
      [&](float* dst, int ci0, int cn) {
        // one window position a step, all the chunk's channels at it
        for (int e = threadIdx.x; e < kXH * kXW; e += K::NT) {
          const int rr = e / kXW, cc = e % kXW;
          const T* src = x2b + ci0 * plane +
                         (size_t)reflect(r0 - 3 + rr, H) * W +
                         reflect(c0 - 3 + cc, W);
          float* d = dst + rr * kXP + cc;
          for (int ci = 0; ci < cn; ++ci)
            stage_elem<T>(d + ci * kXPlane, src + ci * plane);
        }
      },
      NoStage(), NoLoad(),
      [&](int i, int j0, int ch, const auto& sums, const auto&) {
        const float bias = __ldg(b1 + ch);
        float* d = h1 + ch * kAPlane + i * kAP + j0;
#pragma unroll
        for (int s = 0; s < row_len<decltype(sums)>(); ++s)
          d[s] = round_as<T>(fmaxf(sums[s] + bias, 0.f));
      });
  __syncthreads();
  fill_reflect<K::NT>(h1, M, kAH, kAW, kAP, kAPlane, r0 - 2, c0 - 2, H, W);

  // conv2: h1 -> h2
  conv_fma<K::NT, typename K::Tile2, G2>(
      M, M, pl.kc, w2, h1, 0, buf2, NoStage(), NoStage(), NoLoad(),
      [&](int i, int j0, int ch, const auto& sums, const auto&) {
        const float bias = __ldg(b2 + ch);
        float* d = h2 + ch * kBPlane + i * kBP + j0;
#pragma unroll
        for (int s = 0; s < row_len<decltype(sums)>(); ++s)
          d[s] = round_as<T>(fmaxf(sums[s] + bias, 0.f));
      });
  __syncthreads();
  fill_reflect<K::NT>(h2, M, kBH, kBW, kBP, kBPlane, r0 - 1, c0 - 1, H, W);

  // conv3 + bias, then x1 +- F in float32, rounded once
  conv_fma<K::NT, typename K::Tile3, G3>(
      M, C, pl.kc, w3, h2, 0, buf2, NoStage(), NoStage(),
      [&](int i, int j0, int ch, auto& v) {
        const int r = r0 + i, c = c0 + j0;
        load_row<T>(x1 + ((size_t)b * C + ch) * plane + (size_t)r * W + c,
                    r < H ? min(W - c, row_len<decltype(v)>()) : 0, v);
      },
      [&](int i, int j0, int ch, const auto& sums, const auto& xv) {
        constexpr int S = row_len<decltype(sums)>();
        const int r = r0 + i, c = c0 + j0;
        if (r >= H || c >= W) return;
        const float bias = __ldg(b3 + ch);
        float y[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float f = sums[s] + bias;
          y[s] = inverse ? xv[s] - f : xv[s] + f;
        }
        store_row<T>(out + ((size_t)b * C + ch) * plane + (size_t)r * W + c,
                     min(W - c, S), y);
      });
}

template <typename T, class K>
int launch_coupling(const void* x1, const void* x2, const void* w, void* out,
                    int B, int C, int M, int H, int W, int inverse,
                    cudaStream_t stream) {
  const FmaPlan pl = fma_plan<K, G1, G2, G3>(C, M, C);
  const size_t smem = sizeof(float) * (size_t)pl.total;
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      coupling_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  coupling_kernel<T, K><<<grid, K::NT, smem, stream>>>(
      static_cast<const T*>(x1), static_cast<const T*>(x2),
      static_cast<const float*>(w), static_cast<T*>(out), C, M, H, W,
      inverse, pl);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_coupling(const void* x1, const void* x2, const void* w,
                            void* out, int B, int C, int M, int H, int W,
                            int inverse, int is_bf16, void* stream) {
  using namespace vst;
  if (C % 4 || M % 4 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_coupling<__nv_bfloat16, Generic>(x1, x2, w, out, B, C, M,
                                                   H, W, inverse, s);
  if (C == 256 && M == 64)
    return launch_coupling<float, Wide>(x1, x2, w, out, B, C, M, H, W,
                                        inverse, s);
  if (C == 64 && M == 16)
    return launch_coupling<float, Mid>(x1, x2, w, out, B, C, M, H, W,
                                       inverse, s);
  if (C == 16 && M == 4)
    return launch_coupling<float, Narrow>(x1, x2, w, out, B, C, M, H, W,
                                          inverse, s);
  return launch_coupling<float, Generic>(x1, x2, w, out, B, C, M, H, W,
                                         inverse, s);
}

extern "C" const char* vst_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
