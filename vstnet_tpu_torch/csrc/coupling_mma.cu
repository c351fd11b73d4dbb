// K1 in bf16 on the tensor cores: one additive coupling block, stride 1,
// NCHW in and out, for the width C=64/M=16; further down a second kernel
// for the narrow C=16/M=4, and a third, coupling_mma_wg_kernel, for the
// widest C=256/M=64 on Hopper's warpgroup products.
//
// Replaces the TPU kernel vstnet_tpu/ops/coupling_flat.py:
// fused_coupling_flat (kernel body _coupling_kernel_flat), like
// coupling.cu, which keeps the float32 route and any other width. It
// computes
//   forward  y  = x1 + F(x2)       inverse  x1 = y - F(x2)
// with F = conv3 . ReLU . conv2 . ReLU . conv1, each a 3x3 conv with
// reflect pad 1 and a bias, channels C -> M -> M -> C (M = C/4). h1 and h2
// never leave the SM.
//
// What bounds it on an H100 (per pixel 2*9*M*(2C+M) FLOP; x1, x2 read and
// y written once, 6C bytes): C=256 432 FLOP/B, bound by operations on the
// tensor cores (989 TFLOP/s bf16, ridge near 295 FLOP/B); C=64 108 FLOP/B,
// bound by bytes.
//
// The design: each conv is an implicit GEMM on mma.sync.m16n8k16 (bf16 in,
// float32 accumulators in registers). Rows are the positions of the 16x16
// output tile plus its ring (20x20 for h1, 18x18 for h2), columns the
// output channels, depth the nine taps times the input channels. x2's
// window, h1 and h2 lie in shared memory as bf16, position-major (the
// channels of one position contiguous), so the row of an ldmatrix is 16
// bytes of one position and the 3x3 gather is nothing but a per-lane
// address: the position of a row's centre plus the tap's offset. The
// window is transposed from NCHW while it is staged, 32 input channels at
// a time in two stages. The weights are packed once on the host as bf16
// pieces of [tap][ci][co] (ops/coupling_fused.py: pack_coupling_mma) and
// stream through a two-stage ring by cp.async, the next piece arriving
// while the tensor cores work on this one; ldmatrix.trans makes the B
// fragments. All tiles are XOR-swizzled, so ldmatrix and the fragment
// stores are free of bank conflicts. A warp owns 32 rows (two m-tiles) and
// all columns of a piece, so each B fragment feeds two products.
//
// Per-conv reflection: every ring position outside the image is computed
// at its reflected position (ReflectionPad2d of h1 and h2 themselves, not
// of x), as the TPU kernel re-reflects after each conv: the centre of such
// a row is simply the reflected position's. Rounding points match the TPU
// kernel and the plain version: h1 and h2 = bf16(ReLU(sum + bias));
// conv3's float32 sum + bias is added to (subtracted from) x1 in float32
// and rounded once. The order of every sum is fixed by the code alone
// (pieces, taps and k-steps in sequence, no atomics, nothing split across
// warps) and forward and inverse run the same code, so the inverse
// recomputes F bit for bit.
#include "conv_mma.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

#ifdef VST_PHASE_TICKS
__device__ long long* vst_ticks = nullptr;  // see conv_mma.cuh
#endif

namespace vst {

constexpr int kMT = 16;                      // output tile, both ways
constexpr int kMX = kMT + 6;                 // x2 window
constexpr int kMA = kMT + 4;                 // h1 ring
constexpr int kMB = kMT + 2;                 // h2 ring
constexpr int kMKC1 = 32;                    // input channels per x stage
constexpr int kMXRow = kMKC1 * 2;            // bytes of one staged position

template <int C, int M> struct MmaCfg {
  static constexpr int kThreads = 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kHRow = M * 2;        // bytes of one h1/h2 position
  static constexpr int kKC = M < 32 ? M : 32;  // ci per piece, conv2 and 3
  static constexpr int kNC3 = 64;            // columns per piece of conv3
  static constexpr int kNP1 = C / kMKC1;
  static constexpr int kNP2 = M / kKC;
  static constexpr int kNP3 = (C / kNC3) * (M / kKC);
  static constexpr int kP1 = 9 * kMKC1 * M * 2;   // piece bytes
  static constexpr int kP2 = 9 * kKC * M * 2;
  static constexpr int kP3 = 9 * kKC * kNC3 * 2;
  static constexpr int kStage =
      kP1 > kP3 ? (kP1 > kP2 ? kP1 : kP2) : (kP3 > kP2 ? kP3 : kP2);
  static constexpr int kH1 = kMA * kMA * kHRow;
  static constexpr int kXS = kMX * kMX * kMXRow;  // one x stage
  static constexpr int kSmem = kH1 + 2 * kXS + 2 * kStage;
  // 32-row units of conv1 and conv2 a warp may have to take
  static constexpr int kU1 = ((kMA * kMA + 31) / 32 + kWarps - 1) / kWarps;
  static constexpr int kU2 = ((kMB * kMB + 31) / 32 + kWarps - 1) / kWarps;
  // conv3: a warp takes 32 rows of the tile and all of a piece's columns
  static constexpr int kNT3 = kNC3 / 8;
  static_assert(kMB * kMB * kHRow <= 2 * kXS, "h2 aliases the x stages");
  static_assert(kMT * kMT == kWarps * 32, "conv3");
};

// KC input channels (from channel ci0 on) of x2's XW x XW window whose
// corner is image position (r0 - 3, c0 - 3), reflected at the image edge,
// from NCHW into a position-major swizzled tile of KC * 2 byte rows, by NW
// warps of which this is number `warp`. A warp-load covers 8 positions x 4
// channel pairs, so its shared-memory stores hit 32 different banks; the
// loads of kBatch items are started together before any is stored, so one
// trip to memory serves them all.
template <int KC, int XW, int NW>
__device__ __forceinline__ void stage_window(
    unsigned char* dst, const __nv_bfloat16* __restrict__ x2b, size_t plane,
    int ci0, int r0, int c0, int H, int W, int warp, int lane) {
  constexpr int kBatch = 8;
  constexpr int octets = (XW * XW + 7) / 8, quads = KC / 8;
  constexpr int items = octets * quads;
  for (int base = warp; base < items; base += NW * kBatch) {
    __nv_bfloat162 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = min(base + k * NW, items - 1);
      const int pos = min((item / quads) * 8 + (lane & 7), XW * XW - 1);
      const int cp = (item % quads) * 4 + (lane >> 3);
      const int gr = reflect(r0 - 3 + pos / XW, H);
      const int gc = reflect(c0 - 3 + pos % XW, W);
      const __nv_bfloat16* src =
          x2b + (size_t)(ci0 + 2 * cp) * plane + (size_t)gr * W + gc;
      v[k].x = src[0];
      v[k].y = src[plane];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + k * NW;
      const int pos = (item / quads) * 8 + (lane & 7);
      if (item < items && pos < XW * XW)
        *reinterpret_cast<__nv_bfloat162*>(
            dst + swz<KC * 2>(pos, item % quads) + (lane >> 3) * 4) = v[k];
    }
  }
}

template <int C, int M>
__global__ void __launch_bounds__(MmaCfg<C, M>::kThreads)
    coupling_mma_kernel(const __nv_bfloat16* __restrict__ x1,
                        const __nv_bfloat16* __restrict__ x2,
                        const char* __restrict__ wq,
                        const float* __restrict__ bias,
                        __nv_bfloat16* __restrict__ out, int H, int W,
                        int inverse) {
  using Cfg = MmaCfg<C, M>;
  VST_TICKS_BEGIN();                         // tick 0: start
  constexpr int NW = Cfg::kWarps, HROW = Cfg::kHRow, KC = Cfg::kKC;
  constexpr int NTM = M / 8;                 // n-tiles of conv1 and conv2
  extern __shared__ __align__(128) unsigned char cm_smem[];
  unsigned char* h1 = cm_smem;
  unsigned char* xs = h1 + Cfg::kH1;         // two x stages, later h2
  unsigned char* h2 = xs;
  const uint32_t h1_a = smem_u32(h1), xs_a = smem_u32(xs);
  const uint32_t wst_a = xs_a + 2 * Cfg::kXS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kMT, c0 = blockIdx.x * kMT;
  const size_t plane = (size_t)H * W;
  const __nv_bfloat16* x2b = x2 + (size_t)b * C * plane;
  const float* b1 = bias;
  const float* b2 = b1 + M + (size_t)M * 9 * M;
  const float* b3 = b2 + M + (size_t)M * 9 * C;

  // weight pieces in the order they are used: conv1's, conv2's, conv3's
  constexpr int kPieces = Cfg::kNP1 + Cfg::kNP2 + Cfg::kNP3;
  auto fetch_piece = [&](int idx) {
    if (idx < kPieces) {
      const uint32_t dst = wst_a + (idx & 1) * Cfg::kStage;
      if (idx < Cfg::kNP1)
        load_piece<HROW>(dst, wq + (size_t)idx * Cfg::kP1, Cfg::kP1);
      else if (idx < Cfg::kNP1 + Cfg::kNP2)
        load_piece<HROW>(dst,
                         wq + (size_t)Cfg::kNP1 * Cfg::kP1 +
                             (size_t)(idx - Cfg::kNP1) * Cfg::kP2,
                         Cfg::kP2);
      else
        load_piece<Cfg::kNC3 * 2>(
            dst,
            wq + (size_t)Cfg::kNP1 * Cfg::kP1 + (size_t)Cfg::kNP2 * Cfg::kP2 +
                (size_t)(idx - Cfg::kNP1 - Cfg::kNP2) * Cfg::kP3,
            Cfg::kP3);
    }
    cp_async_commit();
  };

  auto stage_x = [&](int chunk) {
    stage_window<kMKC1, kMX, NW>(xs + (chunk & 1) * Cfg::kXS, x2b, plane,
                                 chunk * kMKC1, r0, c0, H, W, warp, lane);
  };

  int piece = 0;
  fetch_piece(0);
  stage_x(0);
  VST_TICK();                                // 1: first x chunk staged

  // conv1 over the h1 ring: position p of the ring is image position
  // (r0 - 2 + p / 20, c0 - 2 + p % 20), reflected into the image
  {
    float acc[Cfg::kU1][2][NTM][4];
    int centre[Cfg::kU1][2];
#pragma unroll
    for (int u = 0; u < Cfg::kU1; ++u) {
      zero_acc(acc[u]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = min((warp + u * NW) * 32 + mt * 16 + (lane & 15),
                          kMA * kMA - 1);
        const int q = reflect(r0 - 2 + p / kMA, H);
        const int qc = reflect(c0 - 2 + p % kMA, W);
        centre[u][mt] = clampi(q - (r0 - 3), 1, kMX - 2) * kMX +
                        clampi(qc - (c0 - 3), 1, kMX - 2);
      }
    }
    for (int chunk = 0; chunk < Cfg::kNP1; ++chunk, ++piece) {
      cp_async_wait<0>();
      __syncthreads();
      fetch_piece(piece + 1);
      if (chunk + 1 < Cfg::kNP1) stage_x(chunk + 1);
#pragma unroll
      for (int u = 0; u < Cfg::kU1; ++u)
        if ((warp + u * NW) * 32 < kMA * kMA)
          conv_piece<2, NTM, kMKC1 / 16, kMXRow, HROW,
                     TapsStride1<kMX>>(
              acc[u], xs_a + (chunk & 1) * Cfg::kXS, centre[u], 0,
              wst_a + (piece & 1) * Cfg::kStage, 0, lane);
    }
    VST_TICK();                              // 2: conv1's products done
#pragma unroll
    for (int u = 0; u < Cfg::kU1; ++u)
      store_hidden<NTM, HROW>(acc[u], h1, b1, (warp + u * NW) * 32,
                              kMA * kMA, lane);
  }

  VST_TICK();                                // 3: h1 stored
  // conv2 over the h2 ring (image position (r0 - 1 + p / 18, ...)), from h1
  {
    float acc[Cfg::kU2][2][NTM][4];
    int centre[Cfg::kU2][2];
#pragma unroll
    for (int u = 0; u < Cfg::kU2; ++u) {
      zero_acc(acc[u]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = min((warp + u * NW) * 32 + mt * 16 + (lane & 15),
                          kMB * kMB - 1);
        const int q = reflect(r0 - 1 + p / kMB, H);
        const int qc = reflect(c0 - 1 + p % kMB, W);
        centre[u][mt] = clampi(q - (r0 - 2), 1, kMA - 2) * kMA +
                        clampi(qc - (c0 - 2), 1, kMA - 2);
      }
    }
    for (int kc = 0; kc < Cfg::kNP2; ++kc, ++piece) {
      cp_async_wait<0>();
      __syncthreads();              // h1 is whole; conv1 is done with xs
      fetch_piece(piece + 1);
#pragma unroll
      for (int u = 0; u < Cfg::kU2; ++u)
        if ((warp + u * NW) * 32 < kMB * kMB)
          conv_piece<2, NTM, KC / 16, HROW, HROW, TapsStride1<kMA>>(
              acc[u], h1_a, centre[u], kc * KC / 8,
              wst_a + (piece & 1) * Cfg::kStage, 0, lane);
    }
#pragma unroll
    for (int u = 0; u < Cfg::kU2; ++u)
      store_hidden<NTM, HROW>(acc[u], h2, b2, (warp + u * NW) * 32,
                              kMB * kMB, lane);
  }

  VST_TICK();                                // 4: conv2 done, h2 stored
  // conv3 over the tile, from h2, then x1 +- (sum + bias) rounded once
  {
    constexpr int NT3 = Cfg::kNT3;
    const int g = lane >> 2, t = lane & 3;
    float acc[2][NT3][4];
    int centre[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int p = warp * 32 + mt * 16 + (lane & 15);
      centre[mt] = (p / kMT + 1) * kMB + p % kMT + 1;
    }
    zero_acc(acc);
    for (int cc = 0; cc < C / Cfg::kNC3; ++cc) {
      for (int kc = 0; kc < M / KC; ++kc, ++piece) {
        cp_async_wait<0>();
        __syncthreads();            // h2 is whole; the piece has landed
        fetch_piece(piece + 1);
        conv_piece<2, NT3, KC / 16, HROW, Cfg::kNC3 * 2,
                   TapsStride1<kMB>>(
            acc, smem_u32(h2), centre, kc * KC / 8,
            wst_a + (piece & 1) * Cfg::kStage, 0, lane);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = warp * 32 + mt * 16 + g + 8 * hf;
          const int r = r0 + p / kMT, c = c0 + p % kMT;
          if (r >= H || c >= W) continue;
#pragma unroll
          for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = cc * Cfg::kNC3 + nt * 8 + 2 * t + e;
              const float f = acc[mt][nt][2 * hf + e] + __ldg(b3 + ch);
              const size_t idx =
                  ((size_t)b * C + ch) * plane + (size_t)r * W + c;
              const float xv = __bfloat162float(x1[idx]);
              out[idx] = __float2bfloat16_rn(inverse ? xv - f : xv + f);
            }
        }
      zero_acc(acc);
    }
  }
  cp_async_wait<0>();
  VST_TICK();                                // 5: conv3 and the output done
  VST_TICKS_END(vst_ticks);
}

template <int C, int M>
int launch_coupling_mma(const void* x1, const void* x2, const void* wq,
                        const void* bias, void* out, int B, int H, int W,
                        int inverse, cudaStream_t stream) {
  using Cfg = MmaCfg<C, M>;
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      coupling_mma_kernel<C, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kMT - 1) / kMT, (H + kMT - 1) / kMT, B);
  coupling_mma_kernel<C, M><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x1),
      static_cast<const __nv_bfloat16*>(x2), static_cast<const char*>(wq),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W,
      inverse);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The narrow width, C=16 / M=4 (stage 1 at full resolution): 27 FLOP/B,
// bound by bytes. Four mid channels are too few for a 16-byte ldmatrix row
// and an 8-column n-tile, so h1 and h2 are padded to 8 channels (zeros,
// from zero weights and a zero bias) and a k-step of conv2 and conv3 is
// two taps of 8 padded channels: lanes 0-15 of the ldmatrix point at the
// rows of one tap, lanes 16-31 at the rows of the next (the tenth, missing
// tap has zero weights and re-reads the ninth). conv1 takes one tap of 16
// input channels per k-step. The tensor cores idle half the time on
// padding; what matters at this width is that a staged value feeds many
// products without passing through the CUDA cores. All weights fit in
// registers as B fragments, packed per lane on the host
// (ops/coupling_fused.py: pack_coupling_mma), all 16 input channels of the
// window are staged at once, and the tile is 32x32, so the rings cost 1.27
// times the useful work (1.56 at 16x16). A warp walks over m-tiles of 16
// positions; nothing is carried between them.
constexpr int kNT = 32;                      // output tile, both ways
constexpr int kNX = kNT + 6, kNA = kNT + 4, kNB = kNT + 2;
constexpr int kNThreads = 256;
constexpr int kNXRow = 32;                   // 16 channels
constexpr int kNHRow = 16;                   // 4 channels padded to 8
constexpr int kNSmem =
    kNX * kNX * kNXRow + (kNA * kNA + kNB * kNB) * kNHRow;
constexpr int kNTaps2 = 5;                   // k-steps of two taps

// this lane's tap of k-step j of conv2 / conv3, as an offset in positions
template <int PITCH>
__device__ __forceinline__ int pair_shift(int j, int lane) {
  const int tap = min(2 * j + (lane >> 4), 8);
  return (tap / 3 - 1) * PITCH + (tap % 3 - 1);
}

__global__ void __launch_bounds__(kNThreads, 2)
    coupling_mma_narrow_kernel(const __nv_bfloat16* __restrict__ x1,
                               const __nv_bfloat16* __restrict__ x2,
                               const uint2* __restrict__ wfrag,
                               const float* __restrict__ bias,
                               __nv_bfloat16* __restrict__ out, int H, int W,
                               int inverse) {
  constexpr int C = 16, M = 4, NW = kNThreads / 32;
  VST_TICKS_BEGIN();                         // tick 0: start
  extern __shared__ __align__(128) unsigned char cn_smem[];
  unsigned char* xs = cn_smem;
  unsigned char* h1 = xs + kNX * kNX * kNXRow;
  unsigned char* h2 = h1 + kNA * kNA * kNHRow;
  const uint32_t xs_a = smem_u32(xs), h1_a = smem_u32(h1),
                 h2_a = smem_u32(h2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kNT, c0 = blockIdx.x * kNT;
  const size_t plane = (size_t)H * W;
  const __nv_bfloat16* x2b = x2 + (size_t)b * C * plane;
  const float* b1 = bias;
  const float* b2 = b1 + M + (size_t)M * 9 * M;
  const float* b3 = b2 + M + (size_t)M * 9 * C;

  // x2's window, all 16 channels, NCHW -> position-major
  stage_window<C, kNX, NW>(xs, x2b, plane, 0, r0, c0, H, W, warp, lane);

  // every weight as this lane's B fragments: conv1 9 k-steps, conv2 5,
  // conv3 5 x 2 n-tiles
  uint2 w1f[9], w2f[kNTaps2], w3f[kNTaps2][2];
#pragma unroll
  for (int k = 0; k < 9; ++k) w1f[k] = __ldg(wfrag + k * 32 + lane);
#pragma unroll
  for (int k = 0; k < kNTaps2; ++k) {
    w2f[k] = __ldg(wfrag + (9 + k) * 32 + lane);
    w3f[k][0] = __ldg(wfrag + (9 + kNTaps2 + 2 * k) * 32 + lane);
    w3f[k][1] = __ldg(wfrag + (9 + kNTaps2 + 2 * k + 1) * 32 + lane);
  }
  // biases of this lane's columns 2t, 2t + 1; the padded columns get zero
  const float b1x = t < 2 ? __ldg(b1 + 2 * t) : 0.f;
  const float b1y = t < 2 ? __ldg(b1 + 2 * t + 1) : 0.f;
  const float b2x = t < 2 ? __ldg(b2 + 2 * t) : 0.f;
  const float b2y = t < 2 ? __ldg(b2 + 2 * t + 1) : 0.f;
  __syncthreads();
  VST_TICK();                                // 1: window and weights staged

  // conv1 over the h1 ring
  for (int mt = warp; mt < (kNA * kNA + 15) / 16; mt += NW) {
    const int p = min(mt * 16 + (lane & 15), kNA * kNA - 1);
    const int q = reflect(r0 - 2 + p / kNA, H);
    const int qc = reflect(c0 - 2 + p % kNA, W);
    const int centre = clampi(q - (r0 - 3), 1, kNX - 2) * kNX +
                       clampi(qc - (c0 - 3), 1, kNX - 2);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      uint32_t a[4];
      ldsm_x4(a, xs_a + swz<kNXRow>(
                     centre + (tap / 3 - 1) * kNX + (tap % 3 - 1), lane >> 4));
      mma_bf16(acc, a, w1f[tap].x, w1f[tap].y);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = mt * 16 + g + 8 * hf;
      if (row < kNA * kNA)
        *reinterpret_cast<uint32_t*>(h1 + row * kNHRow + t * 4) =
            pack_bf16(fmaxf(acc[2 * hf] + b1x, 0.f),
                      fmaxf(acc[2 * hf + 1] + b1y, 0.f));
    }
  }
  __syncthreads();
  VST_TICK();                                // 2: conv1 done, h1 stored

  // conv2 over the h2 ring, from h1
  for (int mt = warp; mt < (kNB * kNB + 15) / 16; mt += NW) {
    const int p = min(mt * 16 + (lane & 15), kNB * kNB - 1);
    const int q = reflect(r0 - 1 + p / kNB, H);
    const int qc = reflect(c0 - 1 + p % kNB, W);
    const int centre = clampi(q - (r0 - 2), 1, kNA - 2) * kNA +
                       clampi(qc - (c0 - 2), 1, kNA - 2);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNTaps2; ++j) {
      uint32_t a[4];
      ldsm_x4(a, h1_a + (centre + pair_shift<kNA>(j, lane)) * kNHRow);
      mma_bf16(acc, a, w2f[j].x, w2f[j].y);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = mt * 16 + g + 8 * hf;
      if (row < kNB * kNB)
        *reinterpret_cast<uint32_t*>(h2 + row * kNHRow + t * 4) =
            pack_bf16(fmaxf(acc[2 * hf] + b2x, 0.f),
                      fmaxf(acc[2 * hf + 1] + b2y, 0.f));
    }
  }
  __syncthreads();
  VST_TICK();                                // 3: conv2 done, h2 stored

  // conv3 over the tile, from h2, then x1 +- (sum + bias) rounded once
  for (int mt = warp; mt < kNT * kNT / 16; mt += NW) {
    const int p = mt * 16 + (lane & 15);
    const int centre = (p / kNT + 1) * kNB + p % kNT + 1;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < kNTaps2; ++j) {
      uint32_t a[4];
      ldsm_x4(a, h2_a + (centre + pair_shift<kNB>(j, lane)) * kNHRow);
      mma_bf16(acc[0], a, w3f[j][0].x, w3f[j][0].y);
      mma_bf16(acc[1], a, w3f[j][1].x, w3f[j][1].y);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int po = mt * 16 + g + 8 * hf;
      const int r = r0 + po / kNT, c = c0 + po % kNT;
      if (r >= H || c >= W) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = nt * 8 + 2 * t + e;
          const float f = acc[nt][2 * hf + e] + __ldg(b3 + ch);
          const size_t idx = ((size_t)b * C + ch) * plane + (size_t)r * W + c;
          const float xv = __bfloat162float(x1[idx]);
          out[idx] = __float2bfloat16_rn(inverse ? xv - f : xv + f);
        }
    }
  }
  VST_TICK();                                // 4: conv3 and the output done
  VST_TICKS_END(vst_ticks);
}

inline int launch_coupling_mma_narrow(const void* x1, const void* x2,
                                      const void* wq, const void* bias,
                                      void* out, int B, int H, int W,
                                      int inverse, cudaStream_t stream) {
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      coupling_mma_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kNSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kNT - 1) / kNT, (H + kNT - 1) / kNT, B);
  coupling_mma_narrow_kernel<<<grid, kNThreads, kNSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x1),
      static_cast<const __nv_bfloat16*>(x2), static_cast<const uint2*>(wq),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W,
      inverse);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The widest width, C=256 / M=64 (stage 3 and the reduction blocks), on
// Hopper's warpgroup products. It replaces, at this width, the TPU kernel
// vstnet_tpu/ops/coupling_flat.py:523 fused_coupling_flat, as
// coupling_mma_kernel does at the others. 432 FLOP a byte: bound by
// operations (the ridge is near 295), so the design is about keeping the
// tensor cores fed and issuing few products beyond the useful ones.
//
// Roles. A block is four warpgroups: three consumers run the products on
// wgmma.mma_async.m64n64k16 (bf16 in, float32 accumulators in registers),
// and a producer warpgroup feeds them. One thread of its first warp copies
// the 36 weight pieces (9 taps x 16 input x 64 output channels, 18,432
// bytes each) by bulk copies into a ring of four stages; each stage has a
// full mbarrier (the copy's bytes arrive on it) and an empty one (every
// consumer warp arrives on it when its products have read the piece). Its
// other three warps bring x2's window, 16 input channels (a chunk) at a
// time: a TMA tensor copy of NCHW x2 lands a chunk channel-major, the
// copy engine filling what lies outside the image with zeros; these warps
// set x2's own reflection at the image edge (rows and columns -1 and H, W
// from 1 and H - 2, W - 2: the only ones outside the image that a product
// of an output in it reads) and transpose the chunk, by ldmatrix and
// stmatrix.trans with six loads in flight a warp, into a position-major
// tile, two buffers with full and empty mbarriers of their own. Consumers
// wait only on the stage and the chunk they read; block barriers (named,
// over the 384 consumer threads) stand only where h1 and h2 are handed
// from one conv to the next. Where W is no multiple of 8 (the tensor
// copy's rows must be 16-byte runs) the staging warps load the chunk
// from NCHW themselves, every position reflected.
//
// Products. Rows are tile positions, columns output channels, depth the
// nine taps times the input channels, as in coupling_mma_kernel. A (rows x
// input channels) comes from registers, made by ldmatrix with each lane's
// row centre plus the tap's offset: the 3x3 gather and the per-conv
// reflection (a ring position outside the image computed at its reflected
// position, the centre clamps) are per-lane addresses, which a shared-
// memory descriptor, one start and two strides for all 64 rows, cannot
// express. B (input channels x output channels, the weights) is read by
// wgmma from the ring through a descriptor; pack_coupling_mma lays each
// piece out once on the host as 9 k-blocks (tap, 16 input channels) of
// K-major core matrices (wgmma.cuh), so a bulk copy lands it ready.
//
// Tile and rings. The output tile is 12 x 32, so the h1 ring is 16 x 36 =
// 576 positions = 9 m-tiles of 64 exactly, 3 for each consumer; the h2
// ring 14 x 34 = 476 positions in 8 m-tiles (3, 3, 2); the tile 384 = 6
// m-tiles, 2 each. Products issued: (576 x 256 + 476 -> 512 x 64 + 384 x
// 256) x 9 x 64 over the useful 384 x 576 x 9 x 64 = 1.26 times (the 16x16
// tile of coupling_mma_kernel issues 1.32 times with its 32-row units).
// 180 = 15 x 12 and 320 = 10 x 32, so the main path's 180x320 stage-3
// frames have no ragged tiles. conv1's accumulators, 3 m-tiles x 32 floats
// a thread, are what limits the tile: all of h1 stays in registers until
// conv1's last chunk. conv3 runs in 4 passes of 64 output channels over
// h2, each pass 4 pieces; each pass's x1 comes by cp.async while its
// products run, the output is made in its place in shared memory and
// leaves by 16-byte stores. Shared memory: the two transposed chunks (2 x
// 18 x 48 positions x 32 bytes = 55,296), later h1 (576 x 128 = 73,728)
// and then h2 (476 x 128 = 60,928) in the same bytes, since each is
// stored only after the products that read its predecessor are done; the
// two chunks as copied (16 channels x 19 rows x 56 columns, the 19th row
// and the 8 columns past the window only spreading a channel's rows over
// the banks: 68,096), which x1's staging reuses in conv3; the ring 4 x
// 18,432; 14 mbarriers: 215,664 bytes, one block an SM. Registers: 128 a
// thread at launch, setmaxnreg gives a consumer 152 and the producer 56.
// That is too few for a consumer to keep its own products in flight
// while it loads the next tap's fragments (ptxas serializes its wgmmas),
// so the three consumers take the tensor cores in turn.
//
// Rounding points and the order of every sum are the other kernels': h1
// and h2 = bf16(ReLU(sum + bias)); conv3's float32 sum + bias added to
// (subtracted from) x1 in float32 and rounded once; k-blocks in a fixed
// sequence into one accumulator, nothing split across warpgroups, so the
// inverse recomputes F bit for bit and a launch is deterministic.
constexpr int kWR = 12, kWC = 32;            // output tile: rows, columns
// x2's window: rows r0 - 3 .. r0 + 14, columns c0 - 8 .. c0 + 39 (the
// products read c0 - 3 .. c0 + 34; 48 columns are six 16-byte runs of an
// image row, for the bulk copies and for ldmatrix)
constexpr int kWXR = kWR + 6, kWXC = kWC + 16, kWXOff = 8;
constexpr int kWAR = kWR + 4, kWAC = kWC + 4;  // h1 ring
constexpr int kWBR = kWR + 2, kWBC = kWC + 2;  // h2 ring
constexpr int kWCons = 3;                    // consumer warpgroups
constexpr int kWConsThreads = kWCons * 128, kWConsWarps = kWCons * 4;
constexpr int kWThreads = kWConsThreads + 128;  // and the producer's
constexpr int kWXWarps = 3;                  // the producer's staging warps
// registers a thread after setmaxnreg: 3 x 128 x 152 + 128 x 56 = 65,536
constexpr int kWConsRegs = 152, kWProdRegs = 56;
static_assert(kWCons * 128 * kWConsRegs + 128 * kWProdRegs <= 65536, "");
constexpr int kWKC = 16;                     // input channels of a piece
constexpr int kWXRow = kWKC * 2;             // bytes of one staged position
constexpr int kWHRow = 64 * 2;               // bytes of one h1/h2 position
constexpr int kWPiece = 9 * kWgKBlock;       // 9 taps x 16 x 64
constexpr int kWStages = 4;
constexpr int kWNP1 = 256 / kWKC;            // conv1's pieces (x chunks)
constexpr int kWNP2 = 64 / kWKC;             // conv2's, and a conv3 pass's
constexpr int kWPieces = kWNP1 + kWNP2 + 4 * kWNP2;
constexpr int kWA = kWAR * kWAC, kWB = kWBR * kWBC;  // ring positions
constexpr int kWXS = kWXR * kWXC * kWXRow;   // one x chunk, position-major
// a chunk as the tensor copy lands it: per channel, 19 window rows of 56
// columns (the box: one row and 8 columns more than the window, so that a
// channel's rows lie 2,128 bytes apart and ldmatrix's 8 channel rows fall
// in 8 bank groups)
constexpr int kWRawRows = kWXR + 1, kWRawCols = kWXC + 8;
constexpr int kWRawPitch = kWRawCols * 2;
constexpr int kWRawCh = kWRawRows * kWRawPitch;
constexpr int kWRaw = kWKC * kWRawCh;
// x1 of a conv3 pass, for each consumer: its 4 tile rows x 64 channels x
// 32 columns, channel-major, a channel's 4 rows 272 bytes apart (16 bytes
// of padding: the epilogue's reads from 4 channels fall in 4 bank groups)
constexpr int kWX1Pitch = 4 * kWC * 2 + 16;
constexpr int kWX1 = 64 * kWX1Pitch;
constexpr int kWX1At = (kWB * kWHRow + 127) / 128 * 128;  // after h2
// shared memory: [act: two x chunks; then h1; then h2] [the two chunks as
// copied] (x1's staging spans the end of both, after the last chunk)
// [the weight ring] [mbarriers]
constexpr int kWAct = kWA * kWHRow > 2 * kWXS ? kWA * kWHRow : 2 * kWXS;
constexpr int kWRawAt = kWAct;
constexpr int kWRingAt = kWRawAt + 2 * kWRaw;
constexpr int kWBarsAt = kWRingAt + kWStages * kWPiece;
constexpr int kWBars = 2 * kWStages + 6;     // ring, x chunks, raw chunks
constexpr int kWSmem = kWBarsAt + 8 * kWBars;
static_assert(kWB * kWHRow <= kWAct && kWX1At + kWCons * kWX1 <= kWRingAt,
              "h2, x1");
static_assert(kWA == 9 * 64 && kWB <= 8 * 64 && kWR * kWC == 6 * 64,
              "m-tiles: 3, 3 (or 2) and 2 a consumer");
static_assert(kWAct % 128 == 0 && kWRaw % 128 == 0 && kWPiece % 128 == 0,
              "alignment");
static_assert(kWSmem <= 232448, "shared memory");

// One chunk (16 input channels) of x2's window from its copy (`raw`: per
// channel, window rows kWRawPitch bytes apart) into the position-major
// swizzled tile `dst` (32-byte rows), by staging warp xw (0 .. kWXWarps -
// 1). A unit is 8 positions (one 8-column group of a row) x 8 channels:
// ldmatrix.x4 reads four units' channel rows (16 bytes each) and
// stmatrix.x4.trans stores their positions' rows.
__device__ __forceinline__ void transpose_chunk(uint32_t dst, uint32_t raw,
                                                int xw, int lane) {
  constexpr int kGroupsRow = kWXC / 8;
  constexpr int kUnits = kWXR * kGroupsRow * 2;   // x 2 channel halves
  // a warp's steps, kBatch loads in flight before their stores: the
  // consumers keep shared memory busy, so a lone load waits long
  constexpr int kSteps = kUnits / 4 / kWXWarps, kBatch = 6;
  static_assert(kUnits % (4 * kWXWarps) == 0 && kSteps % kBatch == 0,
                "whole steps");
  const int i = lane >> 3, j = lane & 7;
  auto unit = [&](int n, int& half, int& row, int& col8) {
    const int u = 4 * (xw + kWXWarps * n) + i;    // this lane's unit
    half = u & 1;
    row = (u >> 1) / kGroupsRow;
    col8 = (u >> 1) % kGroupsRow * 8;
  };
  for (int n0 = 0; n0 < kSteps; n0 += kBatch) {
    uint32_t v[kBatch][4];
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      int half, row, col8;
      unit(n0 + n, half, row, col8);
      ldsm_x4(v[n],
              raw + (half * 8 + j) * kWRawCh + row * kWRawPitch + col8 * 2);
    }
    // register m of each lane holds unit m's (channel g, columns 2t,
    // 2t + 1); stored transposed, row j of unit m is its position j
#pragma unroll
    for (int n = 0; n < kBatch; ++n) {
      int half, row, col8;
      unit(n0 + n, half, row, col8);
      stsm_x4_trans(dst + swz<kWXRow>(row * kWXC + col8 + j, half),
                    make_uint4(v[n][0], v[n][1], v[n][2], v[n][3]));
    }
  }
}

// The same chunk straight from NCHW for any W (the tensor copy needs W a
// multiple of 8), one value at a time, each position reflected; a
// warp-load covers 8 positions x 4 channel pairs
__device__ __forceinline__ void stage_chunk_any(
    unsigned char* dst, const __nv_bfloat16* __restrict__ x2b, size_t plane,
    int ci0, int r0, int c0, int H, int W, int xw, int lane) {
  constexpr int kBatch = 8, kPos = kWXR * kWXC;
  constexpr int items = (kPos / 8) * 2;      // octets x channel quads
  for (int base = xw; base < items; base += kWXWarps * kBatch) {
    __nv_bfloat162 v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = min(base + kWXWarps * k, items - 1);
      const int pos = (item / 2) * 8 + (lane & 7);
      const int cp = (item % 2) * 4 + (lane >> 3);
      const int gr = reflect(r0 - 3 + pos / kWXC, H);
      const int gc = reflect(c0 - kWXOff + pos % kWXC, W);
      const __nv_bfloat16* src =
          x2b + (size_t)(ci0 + 2 * cp) * plane + (size_t)gr * W + gc;
      v[k].x = src[0];
      v[k].y = src[plane];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + kWXWarps * k;
      if (item < items)
        *reinterpret_cast<__nv_bfloat162*>(
            dst + swz<kWXRow>((item / 2) * 8 + (lane & 7), item % 2) +
            (lane >> 3) * 4) = v[k];
    }
  }
}

// acc += A * B over one piece: nine taps of one k-step of 16 input
// channels; `mts` m-tiles of this warpgroup, whose lane rows have centres
// `centre` in the source tile (ROW bytes a position, the piece's channels
// at 16-byte chunk a_chunk0); B the piece at shared address `piece`. Tap
// kb's A fragments are loaded while the products of tap kb - 1 run, into
// the other of two register sets.
template <int MT, int ROW, int PITCH>
__device__ __forceinline__ void wg_piece(float (&acc)[MT][32], int mts,
                                         uint32_t a_base,
                                         const int (&centre)[MT],
                                         int a_chunk0, uint32_t piece,
                                         int lane) {
  const int chunk = a_chunk0 + (lane >> 4);
  uint32_t a[2][MT][4];
  auto load = [&](int tap, uint32_t (&dst)[MT][4]) {
    const int shift = TapsStride1<PITCH>::shift(tap);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (mt < mts)
        ldsm_x4(dst[mt], a_base + swz<ROW>(centre[mt] + shift, chunk));
  };
  load(0, a[0]);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    wg_fence();
    const uint64_t b = wg_desc(piece + tap * kWgKBlock);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (mt < mts) wg_mma_n64(acc[mt], a[tap & 1][mt], b);
    wg_commit();
    if (tap + 1 < 9) {
      wg_wait<1>();                  // tap - 1's products have read their set
      load(tap + 1, a[(tap + 1) & 1]);
    }
  }
  wg_wait<0>();
}

// bf16(ReLU(acc + bias)) of one warp's 16 rows of an m-tile (rows row0 +
// g, row0 + g + 8) into a position-major tile of `count` positions
__device__ __forceinline__ void wg_store_hidden(const float (&acc)[32],
                                                unsigned char* tile,
                                                const float* __restrict__ bias,
                                                int row0, int count,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = row0 + g + 8 * hf;
    if (p >= count) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int co = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(tile + swz<kWHRow>(p, j) + t * 4) =
          pack_bf16(fmaxf(acc[4 * j + 2 * hf] + __ldg(bias + co), 0.f),
                    fmaxf(acc[4 * j + 2 * hf + 1] + __ldg(bias + co + 1),
                          0.f));
    }
  }
}

template <int MT>
__device__ __forceinline__ void wg_zero(float (&acc)[MT][32]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
}

__global__ void __launch_bounds__(kWThreads, 1)
    coupling_mma_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __nv_bfloat16* __restrict__ x1,
                           const __nv_bfloat16* __restrict__ x2,
                           const char* __restrict__ wq,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int H, int W,
                           int inverse, int tma) {
  constexpr int C = 256, M = 64;
  VST_TICKS_BEGIN();                         // tick 0: start
  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* act = wg_smem;
  const uint32_t act_a = smem_u32(act);
  const uint32_t raw_a = act_a + kWRawAt;
  const uint32_t ring_a = act_a + kWRingAt;
  const uint32_t bars = act_a + kWBarsAt;
  // mbarriers: the ring's full and empty, the x chunks' full and empty,
  // the copied chunks' full
  auto w_full = [&](int s) { return bars + 8 * s; };
  auto w_empty = [&](int s) { return bars + 8 * (kWStages + s); };
  auto x_full = [&](int s) { return bars + 8 * (2 * kWStages + s); };
  auto x_empty = [&](int s) { return bars + 8 * (2 * kWStages + 2 + s); };
  auto raw_full = [&](int s) { return bars + 8 * (2 * kWStages + 4 + s); };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warpgroup, as a value the compiler knows to be the same across the
  // warp: wgmma under a branch it sees as divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kWR, c0 = blockIdx.x * kWC;
  const size_t plane = (size_t)H * W;

  // every consumer warp arrives once on an empty barrier, every staging
  // warp once on a chunk's full barrier
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init_count(w_full(s), 1);
      mbar_init_count(w_empty(s), kWConsWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init_count(x_full(s), kWXWarps);
      mbar_init_count(x_empty(s), kWConsWarps);
      mbar_init_count(raw_full(s), 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kWCons) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProdRegs));
    long long waited = 0;
    if (warp == 4 * kWCons) {
      // the weight ring: one thread streams the pieces, each as soon as
      // every consumer warp is done with the piece its stage held before
      if (lane == 0)
        for (int i = 0; i < kWPieces; ++i) {
          const int s = i % kWStages, round = i / kWStages;
          if (round > 0)
            VST_TIMED(waited, mbar_wait_parity(w_empty(s), (round - 1) & 1));
          bulk_load(ring_a + s * kWPiece, wq + (size_t)i * kWPiece, kWPiece,
                    w_full(s));
        }
      __syncwarp();
      VST_TICK();                            // 1: every piece issued
      VST_TICK_VALUE(waited);                // 2: cycles waited for room
      VST_TICKS_END(vst_ticks);
      return;
    }
    // x2's window, by the other kWXWarps warps: chunk k's tensor copy
    // lands in raw buffer k % 2, x2's own reflection is set at the image
    // edge (rows and columns -1 and H, W, which the products read as 1 and
    // H - 2, W - 2; the copy fills the rest outside the image with zeros,
    // and no product of an output in the image reads them), and the chunk
    // is transposed into act buffer k % 2
    const int xw = warp - 4 * kWCons - 1, xt = xw * 32 + lane;
    const __nv_bfloat16* x2b = x2 + (size_t)b * C * plane;
    const int top = r0 == 0 ? 2 : -1;        // window row of image row -1
    const int bottom = H - r0 + 3 < kWXR ? H - r0 + 3 : -1;  // of row H
    const int left = c0 == 0 ? kWXOff - 1 : -1;  // window column of -1
    const int right = W - c0 + kWXOff < kWXC ? W - c0 + kWXOff : -1;
    auto start_copy = [&](int k) {
      tensor_load_4d(raw_a + (k & 1) * kWRaw, &xmap, c0 - kWXOff, r0 - 3,
                     k * kWKC, b, kWRaw, raw_full(k & 1));
    };
    if (tma && xt == 0) {
      start_copy(0);
      start_copy(1);
    }
    for (int k = 0; k < kWNP1; ++k) {
      if (k >= 2)
        VST_TIMED(waited,
                  mbar_wait_parity(x_empty(k & 1), ((k >> 1) - 1) & 1));
      if (tma) {
        VST_TIMED(waited, mbar_wait_parity(raw_full(k & 1), (k >> 1) & 1));
        unsigned char* raw = act + kWRawAt + (k & 1) * kWRaw;
        if (top >= 0 || bottom >= 0) {
          // a row is 7 runs of 16 bytes
          for (int u = xt; u < 2 * kWKC * 7; u += kWXWarps * 32) {
            const int dst = u < kWKC * 7 ? top : bottom;
            if (dst < 0) continue;
            unsigned char* ch = raw + (u / 7 % kWKC) * kWRawCh + u % 7 * 16;
            *reinterpret_cast<uint4*>(ch + dst * kWRawPitch) =
                *reinterpret_cast<const uint4*>(
                    ch + (dst == top ? dst + 2 : dst - 2) * kWRawPitch);
          }
          named_sync(5, kWXWarps * 32);      // the rows are set
        }
        if (left >= 0 || right >= 0) {
          for (int u = xt; u < kWXR * kWKC; u += kWXWarps * 32) {
            __nv_bfloat16* rr = reinterpret_cast<__nv_bfloat16*>(
                raw + (u % kWKC) * kWRawCh + (u / kWKC) * kWRawPitch);
            if (left >= 0) rr[left] = rr[left + 2];
            if (right >= 0) rr[right] = rr[right - 2];
          }
          named_sync(5, kWXWarps * 32);      // the columns are set
        }
        transpose_chunk(act_a + (k & 1) * kWXS, raw_a + (k & 1) * kWRaw, xw,
                        lane);
      } else {
        stage_chunk_any(act + (k & 1) * kWXS, x2b, plane, k * kWKC, r0, c0,
                        H, W, xw, lane);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive_one(x_full(k & 1));
      if (tma && k + 2 < kWNP1) {
        fence_proxy_async();                 // this thread's reads of the
        named_sync(5, kWXWarps * 32);        // copy come before the copy
        if (xt == 0) start_copy(k + 2);      // engine's next writes
      }
    }
    VST_TICK();                              // 1: x2's window staged
    VST_TICK_VALUE(waited);                  // 2: cycles waited
    VST_TICKS_END(vst_ticks);
    return;
  }

  // consumers: warpgroup wg, warp cw of it
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsRegs));
  const int cw = warp & 3;
  const int g = lane >> 2, t = lane & 3, krow = lane & 15;
  const float* b1 = bias;
  const float* b2 = b1 + M + (size_t)M * 9 * M;
  const float* b3 = b2 + M + (size_t)M * 9 * C;
  long long waited = 0, epilogue = 0, x1wait = 0;
  int piece = 0;

  // conv1 over the h1 ring (image position (r0 - 2 + p / 36, c0 - 2 +
  // p % 36), reflected into the image): m-tiles wg, wg + 3, wg + 6
  {
    float acc[3][32];
    int centre[3];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      const int p = min((wg + 3 * mt) * 64 + cw * 16 + krow, kWA - 1);
      const int q = reflect(r0 - 2 + p / kWAC, H);
      const int qc = reflect(c0 - 2 + p % kWAC, W);
      centre[mt] = clampi(q - (r0 - 3), 1, kWXR - 2) * kWXC +
                   clampi(qc - (c0 - kWXOff), 1, kWXC - 2);
    }
    wg_zero(acc);
    for (int k = 0; k < kWNP1; ++k, ++piece) {
      const int s = piece % kWStages;
      VST_TIMED(waited, mbar_wait_parity(x_full(k & 1), (k >> 1) & 1));
      VST_TIMED(waited, mbar_wait_parity(w_full(s), (piece / kWStages) & 1));
      wg_piece<3, kWXRow, kWXC>(acc, 3, act_a + (k & 1) * kWXS, centre, 0,
                                ring_a + s * kWPiece, lane);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_one(x_empty(k & 1));
        mbar_arrive_one(w_empty(s));
      }
    }
    VST_TICK();                              // 1: conv1's products done
    named_sync(1, kWConsThreads);            // every x chunk is read
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
      wg_store_hidden(acc[mt], act, b1, (wg + 3 * mt) * 64 + cw * 16, kWA,
                      lane);
    named_sync(1, kWConsThreads);            // h1 is whole
  }
  VST_TICK();                                // 2: h1 stored

  // conv2 over the h2 ring (image position (r0 - 1 + p / 34, ...)), from
  // h1: m-tiles wg, wg + 3 and, for the first two consumers, wg + 6
  {
    constexpr int kMT2 = (kWB + 63) / 64;
    const int mts = wg + 6 < kMT2 ? 3 : 2;
    float acc[3][32];
    int centre[3];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt) {
      const int p = min((wg + 3 * mt) * 64 + cw * 16 + krow, kWB - 1);
      const int q = reflect(r0 - 1 + p / kWBC, H);
      const int qc = reflect(c0 - 1 + p % kWBC, W);
      centre[mt] = clampi(q - (r0 - 2), 1, kWAR - 2) * kWAC +
                   clampi(qc - (c0 - 2), 1, kWAC - 2);
    }
    wg_zero(acc);
    for (int h = 0; h < kWNP2; ++h, ++piece) {
      const int s = piece % kWStages;
      VST_TIMED(waited, mbar_wait_parity(w_full(s), (piece / kWStages) & 1));
      wg_piece<3, kWHRow, kWAC>(acc, mts, act_a, centre, 2 * h,
                                ring_a + s * kWPiece, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive_one(w_empty(s));
    }
    named_sync(1, kWConsThreads);            // every read of h1 is done
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
      if (mt < mts)
        wg_store_hidden(acc[mt], act, b2, (wg + 3 * mt) * 64 + cw * 16, kWB,
                        lane);
    named_sync(1, kWConsThreads);            // h2 is whole
  }
  VST_TICK();                                // 3: conv2 done, h2 stored

  // conv3 over the tile, from h2, 64 output channels a pass: m-tiles wg
  // and wg + 3; then x1 +- (sum + bias) rounded once
  {
    float acc[2][32];
    int centre[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int p = (wg + 3 * mt) * 64 + cw * 16 + krow;
      centre[mt] = (p / kWC + 1) * kWBC + p % kWC + 1;
    }
    // Where the tile's 32 columns lie in the image in 16-byte runs, each
    // pass's x1 is fetched into shared memory by cp.async while the pass's
    // products run, the output is made there in its place and written by
    // 16-byte stores; else x1 and the output go straight to and from
    // global memory, one value at a time
    const bool staged =
        W % 8 == 0 && c0 + kWC <= W &&
        (reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(out)) %
                16 == 0;
    const uint32_t x1s_a = act_a + kWX1At + wg * kWX1;
    unsigned char* x1s = act + kWX1At + wg * kWX1;
    const int wt = threadIdx.x & 127;
    // this thread's 16-byte pieces of the staged rows: (channel, tile row
    // lr of the warpgroup's four, 16 bytes q), as offsets in shared and in
    // global memory (channel cc * 64 + ch of image row r); false past row H
    auto piece_of = [&](int k, int cc, uint32_t& sm, size_t& gm) {
      const int item = wt + 128 * k;
      const int ch = item >> 4, lr = (item >> 2) & 3, q = item & 3;
      const int r = r0 + 2 * (wg + 3 * (lr >> 1)) + (lr & 1);
      sm = ch * kWX1Pitch + lr * kWC * 2 + q * 16;
      gm = ((size_t)b * C + cc * 64 + ch) * plane + (size_t)r * W + c0 +
           q * 8;
      return r < H;
    };
    constexpr int kPieces16 = 64 * 4 * 4 / 128;
    for (int cc = 0; cc < C / 64; ++cc) {
      if (staged) {
        named_sync(2 + wg, 128);             // the last pass's rows are out
#pragma unroll
        for (int k = 0; k < kPieces16; ++k) {
          uint32_t sm;
          size_t gm;
          if (piece_of(k, cc, sm, gm)) cp_async16(x1s_a + sm, x1 + gm);
        }
        cp_async_commit();
      }
      // this thread's 16 biases of the pass: channels j * 8 + 2t + e
      float bj[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bj[j][e] = __ldg(b3 + cc * 64 + j * 8 + 2 * t + e);
      wg_zero(acc);
      for (int h = 0; h < kWNP2; ++h, ++piece) {
        const int s = piece % kWStages;
        VST_TIMED(waited,
                  mbar_wait_parity(w_full(s), (piece / kWStages) & 1));
        wg_piece<2, kWHRow, kWBC>(acc, 2, act_a, centre, 2 * h,
                                  ring_a + s * kWPiece, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive_one(w_empty(s));
      }
#ifdef VST_PHASE_TICKS
      const long long e0 = clock64();
#endif
      if (staged) {
        VST_TIMED(x1wait, cp_async_wait<0>();
                  named_sync(2 + wg, 128));  // this pass's x1 has landed
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = (wg + 3 * mt) * 64 + cw * 16 + g + 8 * hf;
            if (r0 + p / kWC >= H) continue;
            // the staged row: this m-tile's tile row cw / 2 of its two
            unsigned char* x1row =
                x1s + (2 * mt + (cw >> 1)) * kWC * 2 + (p % kWC) * 2;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(
                    x1row + (j * 8 + 2 * t + e) * kWX1Pitch);
                const float f = acc[mt][4 * j + 2 * hf + e] + bj[j][e];
                const float xv = __bfloat162float(*at);
                *at = __float2bfloat16_rn(inverse ? xv - f : xv + f);
              }
          }
        named_sync(2 + wg, 128);             // the pass's rows are whole
#pragma unroll
        for (int k = 0; k < kPieces16; ++k) {
          uint32_t sm;
          size_t gm;
          if (piece_of(k, cc, sm, gm))
            *reinterpret_cast<uint4*>(out + gm) =
                *reinterpret_cast<const uint4*>(x1s + sm);
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = (wg + 3 * mt) * 64 + cw * 16 + g + 8 * hf;
            const int r = r0 + p / kWC, c = c0 + p % kWC;
            if (r >= H || c >= W) continue;
            const __nv_bfloat16* xp =
                x1 + ((size_t)b * C + cc * 64) * plane + (size_t)r * W + c;
            __nv_bfloat16* op = out + (xp - x1);
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const size_t at = (size_t)(j * 8 + 2 * t + e) * plane;
                const float f = acc[mt][4 * j + 2 * hf + e] + bj[j][e];
                const float xv = __bfloat162float(xp[at]);
                op[at] = __float2bfloat16_rn(inverse ? xv - f : xv + f);
              }
          }
      }
#ifdef VST_PHASE_TICKS
      epilogue += clock64() - e0;
#endif
    }
  }
  VST_TICK();                                // 4: conv3 and the output done
  VST_TICK_VALUE(waited);                    // 5: cycles waited for data
  VST_TICK_VALUE(epilogue);                  // 6: cycles of the epilogue
  VST_TICK_VALUE(x1wait);                    // 7: of which waited for x1
  VST_TICKS_END(vst_ticks);
}

int launch_coupling_mma_wg(const void* x1, const void* x2, const void* wq,
                           const void* bias, void* out, int B, int H, int W,
                           int inverse, cudaStream_t stream) {
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      coupling_mma_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWSmem);
  if (err != cudaSuccess) return (int)err;
  // x2's window chunks come by tensor copies where the rows are 16-byte
  // aligned (W a multiple of 8); else the staging warps load them
  CUtensorMap map{};
  const int tma = W % 8 == 0 && reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  if (tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    // NCHW as a 4-d tensor, W innermost; the box is one raw chunk
    const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, 256,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                   (cuuint64_t)256 * H * W * 2};
    const cuuint32_t box[4] = {kWRawCols, kWRawRows, kWKC, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(x2), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((W + kWC - 1) / kWC, (H + kWR - 1) / kWR, B);
  coupling_mma_wg_kernel<<<grid, kWThreads, kWSmem, stream>>>(
      map, static_cast<const __nv_bfloat16*>(x1),
      static_cast<const __nv_bfloat16*>(x2), static_cast<const char*>(wq),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W,
      inverse, tma);
  return (int)cudaGetLastError();
}

}  // namespace vst

// x1, x2, out: bf16 NCHW (B, C, H, W). wq: the bf16 pieces (C=64; at
// C=256 as wgmma's B) or B fragments (C=16) of pack_coupling_mma. bias: b1
// inside the float32 packed buffer of coupling.cu (b1, w2, b2, w3, b3
// follow each other there).
extern "C" int vst_coupling_mma(const void* x1, const void* x2,
                                const void* wq, const void* bias, void* out,
                                int B, int C, int M, int H, int W,
                                int inverse, void* stream) {
  if (H < 2 || W < 2 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256 && M == 64)
    return vst::launch_coupling_mma_wg(x1, x2, wq, bias, out, B, H, W,
                                       inverse, s);
  if (C == 64 && M == 16)
    return vst::launch_coupling_mma<64, 16>(x1, x2, wq, bias, out, B, H, W,
                                            inverse, s);
  if (C == 16 && M == 4)
    return vst::launch_coupling_mma_narrow(x1, x2, wq, bias, out, B, H, W,
                                           inverse, s);
  return (int)cudaErrorInvalidValue;
}

#ifdef VST_PHASE_TICKS
// ticks: device buffer of at least blocks x 16 x 8 int64, or null to stop
// recording
extern "C" int vst_coupling_mma_set_ticks(void* ticks) {
  return (int)cudaMemcpyToSymbol(vst_ticks, &ticks, sizeof(ticks));
}
#endif
