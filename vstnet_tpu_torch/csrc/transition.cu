// K2 and K3: the stride-2 transition block, with the pixel (un)shuffle
// inside (K2) or on streams the caller has already unshuffled (K3).
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
//
// What bounds it on an H100 (per half-res pixel: 9*(C*M + M*M + 4*M*C)
// multiply-adds; x1, x2 read and both outputs written once, 16C bytes in
// bf16):
//   T1: C=16, M=16, 512x512 -> 64 ch at 256x256    27648 FLOP /  512 B = 54 FLOP/B
//   T2: C=64, M=64, 256x256 -> 256 ch at 128x128  442368 FLOP / 2048 B = 216 FLOP/B
// On the CUDA cores (ridge near 20 FLOP/B) both are bound by FMA issue.
//
// The simple design mirrors K1 (coupling.cu) at half resolution: one
// block per (frame, 8x16 half-res output tile), 512 threads for T2 and
// 256 for T1 (common.cuh:block_threads). The full-res
// window of x2 that conv1 reads (2*12+1 rows, 2*20+1 columns) is staged in
// shared memory 16 channels at a time; h1 (tile + 2-pixel ring) and h2
// (tile + 1-pixel ring) stay in shared memory. The (un)shuffle is index
// arithmetic in the loads and stores: the inverse reads s(y1) straight from
// the half-res y1, so the full-res x2 is never built and the same F is
// recomputed bit for bit.
//
// Stride-2 conv1: half-res row r reads full-res rows 2r-1, 2r, 2r+1; only
// the top edge reflects (row -1 -> row 1), the same for columns. h1 and h2
// are re-reflected per conv as in K1, rounded to the working dtype after
// bias + ReLU; conv3's sum stays float32 and is added or subtracted in
// float32 and rounded once.
#include "common.cuh"

namespace vst {

constexpr int kTrTH = 8, kTrTW = 16;                   // half-res tile
constexpr int kTrAH = kTrTH + 4, kTrAW = kTrTW + 4;    // h1 ring
constexpr int kTrBH = kTrTH + 2, kTrBW = kTrTW + 2;    // h2 ring
constexpr int kTrXH = 2 * kTrAH + 1, kTrXW = 2 * kTrAW + 1;  // full-res x2

// Full-res value (ci, R, Cc) of the conv stream: x2 itself (forward) or
// s(y1) read from the half-res unshuffled y1 (inverse).
template <typename T>
__device__ __forceinline__ float conv_in(const T* src, int inverse, int C,
                                         int ci, int R, int Cc, int h,
                                         int w) {
  if (!inverse) return to_f<T>(src[((size_t)ci * 2 * h + R) * 2 * w + Cc]);
  const int ch = ((R & 1) * 2 + (Cc & 1)) * C + ci;
  return to_f<T>(src[((size_t)ch * h + (R >> 1)) * w + (Cc >> 1)]);
}

template <typename T, bool HALF>
__global__ void __launch_bounds__(kMaxThreads)
    transition_kernel(const T* __restrict__ a, const T* __restrict__ bsrc,
                      const float* __restrict__ wp, T* __restrict__ out0,
                      T* __restrict__ out1, int C, int M, int h, int w,
                      int inverse) {
  extern __shared__ float smem[];
  const int chunk = min(C, kChunk);
  float* xs = smem;                           // [chunk][kTrXH][kTrXW]
  float* h1 = xs + chunk * kTrXH * kTrXW;     // [M][kTrAH][kTrAW]
  float* h2 = h1 + M * kTrAH * kTrAW;         // [M][kTrBH][kTrBW]

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTrTH, c0 = blockIdx.x * kTrTW;
  const int H = 2 * h, W = 2 * w;
  const int C4 = 4 * C;
  const size_t frame = (size_t)C * H * W;  // == 4C * h * w
  // forward: a = x1, b = x2 (full-res); inverse: a = y2, b = y1 (half-res);
  // HALF: every stream half-res, so the conv stream is always s(b)
  const int shuffled_src = HALF ? 1 : inverse;
  const T* srcb = bsrc + (size_t)b * frame;

  const float* w1 = wp;
  const float* b1 = w1 + (size_t)C * 9 * M;
  const float* w2 = b1 + M;
  const float* b2 = w2 + (size_t)M * 9 * M;
  const float* w3 = b2 + M;
  const float* b3 = w3 + (size_t)M * 9 * C4;

  for (int i = threadIdx.x; i < M * kTrAH * kTrAW; i += blockDim.x)
    h1[i] = 0.f;

  // full-res window origin: 2*(r0 - 2) - 1
  const int xr0 = 2 * r0 - 5, xc0 = 2 * c0 - 5;
  for (int ci0 = 0; ci0 < C; ci0 += chunk) {
    const int cn = min(chunk, C - ci0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * kTrXH * kTrXW; i += blockDim.x) {
      const int ci = i / (kTrXH * kTrXW);
      const int rem = i % (kTrXH * kTrXW);
      const int R = reflect(xr0 + rem / kTrXW, H);
      const int Cc = reflect(xc0 + rem % kTrXW, W);
      xs[i] = conv_in<T>(srcb, shuffled_src, C, ci0 + ci, R, Cc, h, w);
    }
    __syncthreads();
    conv_auto(
        kTrAH * kTrAW, M, xs, kTrXH * kTrXW, w1 + (size_t)ci0 * 9 * M, cn,
        [=](int pos, int* ro, int* co) {
          const int q = reflect(r0 - 2 + pos / kTrAW, h);
          const int qc = reflect(c0 - 2 + pos % kTrAW, w);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            ro[k] = clampi(2 * q - 1 + k - xr0, 0, kTrXH - 1) * kTrXW;
            co[k] = clampi(2 * qc - 1 + k - xc0, 0, kTrXW - 1);
          }
        },
        [=](int pos, int c) { return h1[c * kTrAH * kTrAW + pos]; },
        [=](int pos, int c, float s) { h1[c * kTrAH * kTrAW + pos] = s; });
  }
  __syncthreads();
  finish_h1<T>(h1, b1, M, kTrAH * kTrAW);
  __syncthreads();
  conv_h2<T, kTrAH, kTrAW, kTrBH, kTrBW>(h1, h2, w2, b2, M, r0 - 1, c0 - 1,
                                         h, w);
  __syncthreads();

  conv_auto(
      kTrTH * kTrTW, C4, h2, kTrBH * kTrBW, w3, M,
      [=](int pos, int* ro, int* co) {
        const int i = pos / kTrTW, j = pos % kTrTW;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ro[k] = (i + k) * kTrBW;
          co[k] = j + k;
        }
      },
      [](int, int) { return 0.f; },
      [=](int pos, int ch, float s) {
        const int r = r0 + pos / kTrTW, c = c0 + pos % kTrTW;
        if (r >= h || c >= w) return;
        const int pq = ch / C, ci = ch % C;   // ch = (p*2 + q)*C + ci
        const int R = 2 * r + (pq >> 1), Cc = 2 * c + (pq & 1);
        const size_t half = (size_t)b * frame + ((size_t)ch * h + r) * w + c;
        const size_t full = (size_t)b * frame + ((size_t)ci * H + R) * W + Cc;
        const float f = s + __ldg(b3 + ch);
        if (HALF) {
          const float av = to_f<T>(a[half]);
          out1[half] = from_f<T>(inverse ? av - f : av + f);
        } else if (!inverse) {
          out0[half] = bsrc[full];                          // u(x2)
          out1[half] = from_f<T>(to_f<T>(a[full]) + f);     // F + u(x1)
        } else {
          out0[full] = from_f<T>(to_f<T>(a[half]) - f);     // s(y2 - F)
          out1[full] = bsrc[half];                          // s(y1)
        }
      });
}

template <typename T, bool HALF>
int launch_transition(const void* a, const void* b, const void* w,
                      void* out0, void* out1, int B, int C, int M, int h,
                      int wd, int inverse, cudaStream_t stream) {
  const int chunk = min(C, kChunk);
  const size_t smem = sizeof(float) * ((size_t)chunk * kTrXH * kTrXW +
                                       (size_t)M * kTrAH * kTrAW +
                                       (size_t)M * kTrBH * kTrBW);
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      transition_kernel<T, HALF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((wd + kTrTW - 1) / kTrTW, (h + kTrTH - 1) / kTrTH, B);
  transition_kernel<T, HALF><<<grid, block_threads(smem), smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(w), static_cast<T*>(out0),
      static_cast<T*>(out1), C, M, h, wd, inverse);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_transition(const void* a, const void* b, const void* w,
                              void* out0, void* out1, int B, int C, int M,
                              int h, int wd, int inverse, int is_bf16,
                              void* stream) {
  if (C % 4 || M % 4 || h < 2 || wd < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vst::launch_transition<__nv_bfloat16, false>(
                       a, b, w, out0, out1, B, C, M, h, wd, inverse, s)
                 : vst::launch_transition<float, false>(
                       a, b, w, out0, out1, B, C, M, h, wd, inverse, s);
}

// K3: a, b and out are (B, 4C, h, wd); out = F(s(b)) + a, or a - F(s(b))
// with inverse.
extern "C" int vst_transition_half(const void* a, const void* b,
                                   const void* w, void* out, int B, int C,
                                   int M, int h, int wd, int inverse,
                                   int is_bf16, void* stream) {
  if (C % 4 || M % 4 || h < 2 || wd < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? vst::launch_transition<__nv_bfloat16, true>(
                       a, b, w, nullptr, out, B, C, M, h, wd, inverse, s)
                 : vst::launch_transition<float, true>(
                       a, b, w, nullptr, out, B, C, M, h, wd, inverse, s);
}
