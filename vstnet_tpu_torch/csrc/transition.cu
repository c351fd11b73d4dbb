// K2 and K3: the stride-2 transition block, with the pixel (un)shuffle
// inside (K2) or on streams the caller has already unshuffled (K3), on the
// CUDA cores.
//
// K2 replaces the TPU kernel vstnet_tpu/ops/coupling_flat.py:
// fused_transition_full (kernel bodies _transition_kernel_full and
// _transition_kernel_full_inv, shared _transition_core). With
// u = pixel_unshuffle (channel (p*2 + q)*C + ci) and s = its inverse:
//   forward  (x1, x2) full-res C ch -> (u(x2), F(x2) + u(x1)) half-res 4C
//   inverse  (y1, y2) half-res 4C   -> (s(y2 - F(s(y1))), s(y1)) full-res
// K3 replaces fused_transition_flat of the same file (kernel body
// _transition_kernel_flat): the same block with every stream at half
// resolution in the [p][q][ci] channel order,
//   forward  (a, b) = (u(x1), u(x2)) -> F(s(b)) + a
//   inverse  (a, b) = (y2, y1)       -> a - F(s(b))
// one output each; the other stream of the pair passes through untouched
// and the caller shuffles. It is the HALF instantiation of the one kernel
// below: the conv stream is read through the inverse's index arithmetic,
// and the add stream and the output use the half-res index. The sums and
// their order are K2's, so K2(x1, x2) == K3(u(x1), u(x2)) bit for bit.
// F = conv3 . ReLU . conv2 . ReLU . conv1: conv1 is 3x3 stride 2 C -> M,
// conv2 3x3 M -> M, conv3 3x3 M -> 4C, all with reflect pad 1 and a bias.
// This file is the route of float32 at every width and of bf16 at widths
// transition_mma.cu is not built for.
//
// What bounds it on an H100 SXM (per half-res pixel 9*(C*M + M*M + 4*M*C)
// multiply-adds; x1, x2 read and both outputs written once, 32C bytes in
// float32; float32 FMA about 67 TFLOP/s, ridge near 20 FLOP/B):
//   T1: C=16, M=16, 512x512 -> 64 ch at 256x256    27648 FLOP / 512 B =  54 FLOP/B
//   T2: C=64, M=64, 256x256 -> 256 ch at 128x128  442368 FLOP / 2048 B = 216 FLOP/B
// Both are bound by the FMA rate. A 16x16 half-res output tile also
// computes conv1 on a 2-pixel ring (20x20) and conv2 on a 1-pixel ring
// (18x18): 14 % more FMAs at T2, 23 % at T1.
//
// The design is K1's (coupling.cu, conv_fma.cuh): each conv an implicit
// GEMM from shared memory into register tiles; conv1's sums in registers
// across the input chunks; each chunk of x2's full-res window (41x41:
// 2*20 + 1 rows and columns) and its weights copied in with cp.async while
// the previous chunk is summed; h1 and h2 in shared memory, conv2's and
// conv3's weights streamed beside them. Per width (FmaCfg below):
//   T2: 256 threads, one block an SM; conv1 5x5 positions x 4 channels a
//     thread (stride 2: 11 input columns a row), conv2 1x6 x 16, conv3 in
//     four 64-channel rounds of 1x8 x 8;
//   T1: 320 threads, two blocks an SM; 1x5 x 4, 1x6 x 4, 1x8 x 4;
//   any other width (and bf16 at every width): 256 threads, as T1.
// The (un)shuffle is index arithmetic in the loads and stores: the inverse
// stages s(y1) straight from the half-res y1, so the full-res x2 is never
// built and the same F is recomputed bit for bit.
//
// Stride-2 conv1: half-res row r reads full-res rows 2r-1, 2r, 2r+1; only
// the top edge reflects (row -1 -> row 1), the same for columns. h1 and h2
// are re-reflected per conv as in K1 (fill_reflect), rounded to the working
// dtype after bias + ReLU; conv3's sum stays float32 and is added or
// subtracted in float32 and rounded once.
#include "conv_fma.cuh"

namespace vst {

constexpr int kTrTH = 16, kTrTW = 16;                  // half-res tile
constexpr int kTrAH = kTrTH + 4, kTrAW = kTrTW + 4;    // h1 ring
constexpr int kTrBH = kTrTH + 2, kTrBW = kTrTW + 2;    // h2 ring
constexpr int kTrXH = 2 * kTrAH + 1, kTrXW = 2 * kTrAW + 1;  // full-res x2
constexpr int kTrXP = kTrXW + 1, kTrAP = kTrAW + 1, kTrBP = kTrBW + 1;
constexpr int kTrXPlane = kTrXH * kTrXP, kTrAPlane = kTrAH * kTrAP,
              kTrBPlane = kTrBH * kTrBP;

using TG1 = Geom<kTrAH, kTrAW, 2, kTrXP, kTrXPlane>;  // x2 window -> h1
using TG2 = Geom<kTrBH, kTrBW, 1, kTrAP, kTrAPlane>;  // h1 -> h2
using TG3 = Geom<kTrTH, kTrTW, 1, kTrBP, kTrBPlane>;  // h2 -> out

// the configurations per width (conv_fma.cuh: FmaCfg)
using TWide = FmaCfg<256, 1, Tile<5, 5, 4>, Tile<1, 6, 16>, Tile<1, 8, 8>, 4, 8>;
using TMid = FmaCfg<320, 2, Tile<1, 5, 4>, Tile<1, 6, 4>, Tile<1, 8, 4>, 4, 8>;
using TGeneric =
    FmaCfg<256, 1, Tile<1, 5, 4>, Tile<1, 6, 4>, Tile<1, 8, 4>, 4, 8>;

// Index of the full-res value (ci, R, Cc) of the conv stream: in x2 itself
// (forward) or in the half-res unshuffled y1 (inverse), whose channel
// (p*2 + q)*C + ci holds full-res position (2r + p, 2c + q).
__device__ __forceinline__ size_t conv_in_index(int shuffled, int C, int ci,
                                                int R, int Cc, int h,
                                                int w) {
  if (!shuffled) return ((size_t)ci * 2 * h + R) * 2 * w + Cc;
  const int ch = ((R & 1) * 2 + (Cc & 1)) * C + ci;
  return ((size_t)ch * h + (R >> 1)) * w + (Cc >> 1);
}

template <typename T, bool HALF, class K>
__global__ void __launch_bounds__(K::NT, K::MINB)
    transition_kernel(const T* __restrict__ a, const T* __restrict__ bsrc,
                      const float* __restrict__ wp, T* __restrict__ out0,
                      T* __restrict__ out1, int C, int M, int h, int w,
                      int inverse, FmaPlan pl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h1 = smem;                         // [M][kTrAH][kTrAP]
  float* h2 = smem + pl.h2;                 // [M][kTrBH][kTrBP]
  float* const buf1[2] = {smem + pl.s1, smem + pl.s1 + pl.buf1};
  float* const buf2[2] = {smem + pl.s2, smem + pl.s2 + pl.buf2};

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTrTH, c0 = blockIdx.x * kTrTW;
  const int H = 2 * h, W = 2 * w;
  const int C4 = 4 * C;
  const size_t frame = (size_t)C * H * W;  // == 4C * h * w
  // forward: a = x1, b = x2 (full-res); inverse: a = y2, b = y1 (half-res);
  // HALF: every stream half-res, so the conv stream is always s(b)
  const int shuffled_src = HALF ? 1 : inverse;
  const T* srcb = bsrc + (size_t)b * frame;
  // elements between one input channel of the conv stream and the next
  const size_t cstride = shuffled_src ? (size_t)h * w : (size_t)H * W;

  const float* w1 = wp;
  const float* b1 = w1 + (size_t)C * 9 * M;
  const float* w2 = b1 + M;
  const float* b2 = w2 + (size_t)M * 9 * M;
  const float* w3 = b2 + M;
  const float* b3 = w3 + (size_t)M * 9 * C4;

  // index of (ch, r, c) of a half-res stream, and of the full-res
  // position it holds, ch = (p*2 + q)*C + ci
  const auto half_at = [&](int ch, int r, int c) {
    return (size_t)b * frame + ((size_t)ch * h + r) * w + c;
  };
  const auto full_at = [&](int ch, int r, int c) {
    const int pq = ch / C, ci = ch - pq * C;
    return (size_t)b * frame +
           ((size_t)ci * H + 2 * r + (pq >> 1)) * W + 2 * c + (pq & 1);
  };
  // conv1 (stride 2): the full-res window from row/column 2*(r0 - 2) - 1
  const int xr0 = 2 * r0 - 5, xc0 = 2 * c0 - 5;
  conv_fma<K::NT, typename K::Tile1, TG1>(
      C, M, pl.kc1, w1, nullptr, pl.in1, buf1,
      [&](float* dst, int ci0, int cn) {
        // one window position a step, all the chunk's channels at it
        for (int e = threadIdx.x; e < kTrXH * kTrXW; e += K::NT) {
          const int rr = e / kTrXW, cc = e % kTrXW;
          const int R = reflect(xr0 + rr, H), Cc = reflect(xc0 + cc, W);
          const T* src = srcb + conv_in_index(shuffled_src, C, ci0, R, Cc,
                                              h, w);
          float* d = dst + rr * kTrXP + cc;
          for (int ci = 0; ci < cn; ++ci)
            stage_elem<T>(d + ci * kTrXPlane, src + ci * cstride);
        }
      },
      [&](const float* xs, int ci0, int cn) {
        // K2's pass-through stream from the staged window: u(x2) forward,
        // s(y1) inverse; full-res (2*r0 + R, 2*c0 + Cc) is window
        // (R + 5, Cc + 5), inside the image wherever the output is
        if (HALF) return;
        constexpr int FH = 2 * kTrTH, FW = 2 * kTrTW;  // full-res tile
        for (int i = threadIdx.x; i < cn * FH * FW; i += K::NT) {
          const int ci = i / (FH * FW), R = i / FW % FH, Cc = i % FW;
          const int r = r0 + (R >> 1), c = c0 + (Cc >> 1);
          if (r >= h || c >= w) continue;
          const T v = from_f<T>(xs[ci * kTrXPlane + (R + 5) * kTrXP + Cc + 5]);
          if (!inverse)
            out0[half_at(((R & 1) * 2 + (Cc & 1)) * C + ci0 + ci, r, c)] = v;
          else
            out1[(size_t)b * frame +
                 ((size_t)(ci0 + ci) * H + 2 * r0 + R) * W + 2 * c0 + Cc] = v;
        }
      },
      NoLoad(), [&](int i, int j0, int ch, const auto& sums, const auto&) {
        const float bias = __ldg(b1 + ch);
        float* d = h1 + ch * kTrAPlane + i * kTrAP + j0;
#pragma unroll
        for (int s = 0; s < row_len<decltype(sums)>(); ++s)
          d[s] = round_as<T>(fmaxf(sums[s] + bias, 0.f));
      });
  __syncthreads();
  fill_reflect<K::NT>(h1, M, kTrAH, kTrAW, kTrAP, kTrAPlane, r0 - 2, c0 - 2,
                      h, w);

  conv_fma<K::NT, typename K::Tile2, TG2>(
      M, M, pl.kc, w2, h1, 0, buf2, NoStage(), NoStage(), NoLoad(),
      [&](int i, int j0, int ch, const auto& sums, const auto&) {
        const float bias = __ldg(b2 + ch);
        float* d = h2 + ch * kTrBPlane + i * kTrBP + j0;
#pragma unroll
        for (int s = 0; s < row_len<decltype(sums)>(); ++s)
          d[s] = round_as<T>(fmaxf(sums[s] + bias, 0.f));
      });
  __syncthreads();
  fill_reflect<K::NT>(h2, M, kTrBH, kTrBW, kTrBP, kTrBPlane, r0 - 1, c0 - 1,
                      h, w);

  // the add stream: a itself (HALF, inverse) or u(x1) read at full res
  const bool add_full = !HALF && !inverse;
  conv_fma<K::NT, typename K::Tile3, TG3>(
      M, C4, pl.kc, w3, h2, 0, buf2, NoStage(), NoStage(),
      [&](int i, int j0, int ch, auto& v) {
        constexpr int S = row_len<decltype(v)>();
        const int r = r0 + i, c = c0 + j0;
        const int n = r < h ? min(w - c, S) : 0;
        if (!add_full) {
          load_row<T>(a + half_at(ch, r, c), n, v);
          return;
        }
#pragma unroll
        for (int s = 0; s < S; ++s)
          v[s] = s < n ? ldg_f<T>(a + full_at(ch, r, c + s)) : 0.f;
      },
      [&](int i, int j0, int ch, const auto& sums, const auto& av) {
        constexpr int S = row_len<decltype(sums)>();
        const int r = r0 + i, c = c0 + j0;
        if (r >= h || c >= w) return;
        const int n = min(w - c, S);
        const float bias = __ldg(b3 + ch);
        float y[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float f = sums[s] + bias;
          y[s] = inverse ? av[s] - f : av[s] + f;
        }
        if (HALF || !inverse) {
          store_row<T>(out1 + half_at(ch, r, c), n, y);  // F + a, or a - F
          return;
        }
#pragma unroll
        for (int s = 0; s < S; ++s)                     // s(y2 - F)
          if (s < n) out0[full_at(ch, r, c + s)] = from_f<T>(y[s]);
      });
}

template <typename T, bool HALF, class K>
int launch_transition(const void* a, const void* b, const void* w,
                      void* out0, void* out1, int B, int C, int M, int h,
                      int wd, int inverse, cudaStream_t stream) {
  const FmaPlan pl = fma_plan<K, TG1, TG2, TG3>(C, M, 4 * C);
  const size_t smem = sizeof(float) * (size_t)pl.total;
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      transition_kernel<T, HALF, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wd + kTrTW - 1) / kTrTW, (h + kTrTH - 1) / kTrTH, B);
  transition_kernel<T, HALF, K><<<grid, K::NT, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(w), static_cast<T*>(out0),
      static_cast<T*>(out1), C, M, h, wd, inverse, pl);
  return (int)cudaGetLastError();
}

template <bool HALF>
int dispatch_transition(const void* a, const void* b, const void* w,
                        void* out0, void* out1, int B, int C, int M, int h,
                        int wd, int inverse, int is_bf16,
                        cudaStream_t s) {
  if (is_bf16)
    return launch_transition<__nv_bfloat16, HALF, TGeneric>(
        a, b, w, out0, out1, B, C, M, h, wd, inverse, s);
  if (C == 64 && M == 64)
    return launch_transition<float, HALF, TWide>(a, b, w, out0, out1, B, C,
                                                 M, h, wd, inverse, s);
  if (C == 16 && M == 16)
    return launch_transition<float, HALF, TMid>(a, b, w, out0, out1, B, C,
                                                M, h, wd, inverse, s);
  return launch_transition<float, HALF, TGeneric>(a, b, w, out0, out1, B, C,
                                                  M, h, wd, inverse, s);
}

}  // namespace vst

extern "C" int vst_transition(const void* a, const void* b, const void* w,
                              void* out0, void* out1, int B, int C, int M,
                              int h, int wd, int inverse, int is_bf16,
                              void* stream) {
  if (C % 4 || M % 4 || h < 2 || wd < 2) return (int)cudaErrorInvalidValue;
  return vst::dispatch_transition<false>(a, b, w, out0, out1, B, C, M, h, wd,
                                         inverse, is_bf16,
                                         static_cast<cudaStream_t>(stream));
}

// K3: a, b and out are (B, 4C, h, wd); out = F(s(b)) + a, or a - F(s(b))
// with inverse.
extern "C" int vst_transition_half(const void* a, const void* b,
                                   const void* w, void* out, int B, int C,
                                   int M, int h, int wd, int inverse,
                                   int is_bf16, void* stream) {
  if (C % 4 || M % 4 || h < 2 || wd < 2) return (int)cudaErrorInvalidValue;
  return vst::dispatch_transition<true>(a, b, w, nullptr, out, B, C, M, h,
                                        wd, inverse, is_bf16,
                                        static_cast<cudaStream_t>(stream));
}
