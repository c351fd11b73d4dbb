// K1 in bf16 on the tensor cores: one additive coupling block, stride 1,
// NCHW in and out, for the widths C=256/M=64 and C=64/M=16, and further
// down a second kernel for the narrow C=16/M=4.
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
// all columns of a piece, or half of them in conv3, so each B fragment
// feeds two products.
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
  static constexpr int kThreads = C >= 256 ? 512 : 256;
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
  // conv3: 8 row groups of 32; 16 warps split a piece's columns in two
  static constexpr int kCS3 = kWarps / 8;
  static constexpr int kNT3 = kNC3 / 8 / kCS3;
  static_assert(kMB * kMB * kHRow <= 2 * kXS, "h2 aliases the x stages");
  static_assert(kMT * kMT == 8 * 32 && (kCS3 == 1 || kCS3 == 2), "conv3");
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
    const int rg = warp / Cfg::kCS3, half = warp % Cfg::kCS3;
    const int g = lane >> 2, t = lane & 3;
    float acc[2][NT3][4];
    int centre[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int p = rg * 32 + mt * 16 + (lane & 15);
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
            wst_a + (piece & 1) * Cfg::kStage, half * NT3, lane);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = rg * 32 + mt * 16 + g + 8 * hf;
          const int r = r0 + p / kMT, c = c0 + p % kMT;
          if (r >= H || c >= W) continue;
#pragma unroll
          for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch =
                  cc * Cfg::kNC3 + (half * NT3 + nt) * 8 + 2 * t + e;
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

}  // namespace vst

// x1, x2, out: bf16 NCHW (B, C, H, W). wq: the bf16 pieces (C=256, C=64)
// or B fragments (C=16) of pack_coupling_mma. bias: b1 inside the float32 packed buffer of
// coupling.cu (b1, w2, b2, w3, b3 follow each other there).
extern "C" int vst_coupling_mma(const void* x1, const void* x2,
                                const void* wq, const void* bias, void* out,
                                int B, int C, int M, int H, int W,
                                int inverse, void* stream) {
  if (H < 2 || W < 2 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 256 && M == 64)
    return vst::launch_coupling_mma<256, 64>(x1, x2, wq, bias, out, B, H, W,
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
