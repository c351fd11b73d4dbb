// K2 and K3 in bf16 on the tensor cores: the stride-2 transition block at
// the two widths the shipped configs run, (C, M) = (64, 64) and (16, 16).
//
// Replaces the TPU kernels vstnet_tpu/ops/coupling_flat.py:
// fused_transition_full (K2; kernel bodies _transition_kernel_full and
// _transition_kernel_full_inv) and fused_transition_flat (K3; kernel body
// _transition_kernel_flat), like transition.cu, which keeps the float32
// route and any other width. With u = pixel_unshuffle (channel
// (p*2 + q)*C + ci) and s = its inverse:
//   K2 forward  (x1, x2) full-res C ch -> (u(x2), F(x2) + u(x1)) half-res 4C
//   K2 inverse  (y2, y1) half-res 4C   -> (s(y2 - F(s(y1))), s(y1)) full-res
//   K3 forward  (a, b) = (u(x1), u(x2)) -> F(s(b)) + a     every stream at
//   K3 inverse  (a, b) = (y2, y1)       -> a - F(s(b))     half resolution
// F = conv3 . ReLU . conv2 . ReLU . conv1: conv1 3x3 stride 2 C -> M, conv2
// 3x3 M -> M, conv3 3x3 M -> 4C, each with reflect pad 1 and a bias. h1 and
// h2 never leave the SM.
//
// What bounds it on an H100 (per half-res pixel 2*9*(C*M + M*M + 4*M*C)
// FLOP; K2 moves 16C bytes, K3 12C): T2 (C=64) 216 FLOP/B, T1 (C=16) 54
// FLOP/B, both under the tensor cores' ridge near 295 FLOP/B: bound by
// bytes, where the CUDA-core kernel is bound by its FMA rate.
//
// The design: three implicit GEMMs on mma.sync.m16n8k16 per block
// (conv_mma.cuh, shared with K1), one block per (frame, 16x16 half-res
// output tile) with its rings (20x20 for h1, 18x18 for h2).
//
// The window of conv1 is staged as its four 2x2 phases, not at full
// resolution: plane (p, q) holds full-res (2r + p, 2c + q) at half-res
// position (r, c), position-major and swizzled, 21x21 positions a plane.
// Why phases: (1) consecutive rows of an ldmatrix are then consecutive
// positions of one plane, 32 bytes apart, and the swizzle keeps them free
// of bank conflicts, where a full-res window would put them two positions
// apart; a stride-2 tap is a plane and an offset in it (TapsStride2). (2)
// It is the layout of every half-res stream: the inverse and K3 read
// planes as they lie in memory and the forward's pass-through u(x2) is
// written plane by plane. (3) Reflection needs no arithmetic: only the top
// and left edge reflect (full-res row -1 -> row 1), and row 1 is phase 1 of
// half-res row 0, which is what clamping the half-res coordinate gives.
//
// Shared memory decides the chunking: at C=64 the whole window would be
// 4 x 441 x 128 B = 226 KB, so it is staged 16 channels at a time in two
// stages (2 x 56 KB) beside h1 (51 KB) and a two-stage ring of weight
// pieces of 16 input channels (2 x 18 KB): 201 KB, one block of 512
// threads per SM. h2 aliases the window. At C=16 one stage holds all
// channels and every conv is one piece: 106 KB, two blocks of 256 threads
// per SM. conv3 has no ring and is two thirds of the products, so the 16x16
// tile's rings cost 1.14x.
//
// Global traffic: a full-res source (K2 forward) is read as 4-byte pairs
// of columns, which are the two q phases of one half-res position, and
// split in registers; a half-res source is read plane by plane. The
// pass-through stream (u(x2) forward, s(y1) inverse) is written from the
// registers that stage the window, so it is never read a second time; the
// inverse writes it as 4-byte column pairs.
//
// Rounding points and order of sums are transition.cu's: h1 and h2 =
// bf16(ReLU(sum + bias)); conv3's float32 sum + bias is added to or
// subtracted from the other stream in float32 and rounded once. Sums run in
// code order only (pieces, taps, k-steps; no atomics, nothing split across
// warps), and every instantiation runs the same products in the same order,
// so the inverse recomputes F bit for bit and K2(x1, x2) == K3(u(x1),
// u(x2)) bit for bit.
#include "conv_mma.cuh"

#ifdef VST_PHASE_TICKS
__device__ long long* vst_tr_ticks = nullptr;  // see conv_mma.cuh
#endif

namespace vst {

constexpr int kTT = 16;                      // half-res output tile, both ways
constexpr int kTA = kTT + 4;                 // h1 ring
constexpr int kTB = kTT + 2;                 // h2 ring
constexpr int kTP = kTT + 5;                 // phase plane: ring + 1 up, left
constexpr int kTPlane = kTP * kTP;           // positions of one phase plane
constexpr int kTKC = 16;                     // input channels per piece, stage
constexpr int kTXRow = kTKC * 2;             // bytes of one staged position
constexpr int kTNC3 = 64;                    // columns per piece of conv3

template <int C, int M> struct TrCfg {
  static constexpr int kThreads = M >= 64 ? 512 : 256;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kBlocks = M >= 64 ? 1 : 2;   // per SM
  static constexpr int kHRow = M * 2;        // bytes of one h1/h2 position
  static constexpr int kNP1 = C / kTKC;      // pieces of conv1 = x chunks
  static constexpr int kNP2 = M / kTKC;
  static constexpr int kNP3 = (4 * C / kTNC3) * (M / kTKC);
  static constexpr int kP12 = 9 * kTKC * M * 2;      // piece bytes
  static constexpr int kP3 = 9 * kTKC * kTNC3 * 2;
  static constexpr int kStage = kP12 > kP3 ? kP12 : kP3;
  static constexpr int kH1 = kTA * kTA * kHRow;
  static constexpr int kXS = 4 * kTPlane * kTXRow;   // one x stage
  static constexpr int kNXS = kNP1 > 1 ? 2 : 1;
  static constexpr int kSmem = kH1 + kNXS * kXS + 2 * kStage;
  // 32-row units of conv1 and conv2 a warp may have to take
  static constexpr int kU1 = ((kTA * kTA + 31) / 32 + kWarps - 1) / kWarps;
  static constexpr int kU2 = ((kTB * kTB + 31) / 32 + kWarps - 1) / kWarps;
  // conv3: 8 row groups of 32; 16 warps split a piece's columns in two
  static constexpr int kCS3 = kWarps / 8;
  static constexpr int kNT3 = kTNC3 / 8 / kCS3;
  static_assert(C % kTKC == 0 && M % kTKC == 0 && (4 * C) % kTNC3 == 0,
                "widths");
  static_assert(kTB * kTB * kHRow <= kNXS * kXS, "h2 aliases the x stages");
  static_assert(kTT * kTT == 8 * 32 && (kCS3 == 1 || kCS3 == 2), "conv3");
};

// Where the pass-through stream goes while the window is staged
enum { kPassNone = 0, kPassToHalf = 1, kPassToFull = 2 };

// 16 input channels (from ci0 on) of the four phase planes whose corner is
// half-res position (r0 - 3, c0 - 3), clamped into the image (which also
// reflects the one row and column above and left of it that conv1 reads,
// see the top of the file), into a position-major swizzled stage of 32-byte
// rows, row = plane * kTPlane + position. An item is 8 positions x 4
// channel pairs of one row phase p, and gives each lane both column phases
// of two channels: from a full-res source (SRC_HALF false: (B, C, 2h, 2w))
// as two 4-byte loads of a column pair, from a half-res source ((B, 4C, h,
// w), channel (p*2 + q)*C + ci) as four 2-byte loads. The loads of kBatch
// items are started together before any is stored. The shared-memory
// stores of a warp hit 32 different banks. PASS also writes the tile's
// positions (not its ring) to the pass-through output `pass`: to the
// half-res layout from a full-res source, or the other way round.
template <int C, bool SRC_HALF, int PASS, int NW>
__device__ __forceinline__ void stage_phases(
    unsigned char* dst, const __nv_bfloat16* __restrict__ src,
    __nv_bfloat16* __restrict__ pass, int ci0, int r0, int c0, int h, int w,
    int warp, int lane) {
  constexpr int kBatch = 4;
  constexpr int octets = (kTPlane + 7) / 8;
  constexpr int items = octets * 2 * 2;      // x 2 channel quads x 2 p
  const size_t hplane = (size_t)h * w;
  const int W = 2 * w;
  const int cpair = 2 * (lane >> 3);
  for (int base = warp; base < items; base += NW * kBatch) {
    uint32_t s[kBatch][2];                   // [q]: channels ci, ci + 1
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = min(base + k * NW, items - 1);
      const int p = item & 1, quad = (item >> 1) & 1;
      const int pos = min((item >> 2) * 8 + (lane & 7), kTPlane - 1);
      const int ci = ci0 + quad * 8 + cpair;
      const int hr = clampi(r0 - 3 + pos / kTP, 0, h - 1);
      const int hc = clampi(c0 - 3 + pos % kTP, 0, w - 1);
      if (SRC_HALF) {
        const __nv_bfloat16* g =
            src + (size_t)(2 * p * C + ci) * hplane + (size_t)hr * w + hc;
        __nv_bfloat162 q0, q1;
        q0.x = g[0];
        q0.y = g[hplane];
        q1.x = g[(size_t)C * hplane];
        q1.y = g[(size_t)(C + 1) * hplane];
        s[k][0] = *reinterpret_cast<const uint32_t*>(&q0);
        s[k][1] = *reinterpret_cast<const uint32_t*>(&q1);
      } else {
        const __nv_bfloat16* g =
            src + ((size_t)ci * 2 * h + 2 * hr + p) * W + 2 * hc;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(g);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(g + 4 * hplane);
        s[k][0] = __byte_perm(w0, w1, 0x5410);   // q = 0 of ci, ci + 1
        s[k][1] = __byte_perm(w0, w1, 0x7632);   // q = 1
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int item = base + k * NW;
      const int p = item & 1, quad = (item >> 1) & 1;
      const int pos = (item >> 2) * 8 + (lane & 7);
      if (item >= items || pos >= kTPlane) continue;
      const int row = 2 * p * kTPlane + pos;
      *reinterpret_cast<uint32_t*>(dst + swz<kTXRow>(row, quad) + cpair * 2) =
          s[k][0];
      *reinterpret_cast<uint32_t*>(dst + swz<kTXRow>(row + kTPlane, quad) +
                                   cpair * 2) = s[k][1];
      if (PASS == kPassNone) continue;
      const int wr = pos / kTP - 3, wc = pos % kTP - 3;
      const int r = r0 + wr, c = c0 + wc;
      if (wr < 0 || wr >= kTT || wc < 0 || wc >= kTT || r >= h || c >= w)
        continue;
      const int ci = ci0 + quad * 8 + cpair;
      if (PASS == kPassToHalf) {
        unsigned short* o = reinterpret_cast<unsigned short*>(pass) +
                            (size_t)(2 * p * C + ci) * hplane +
                            (size_t)r * w + c;
        o[0] = (unsigned short)(s[k][0] & 0xffff);
        o[hplane] = (unsigned short)(s[k][0] >> 16);
        o[(size_t)C * hplane] = (unsigned short)(s[k][1] & 0xffff);
        o[(size_t)(C + 1) * hplane] = (unsigned short)(s[k][1] >> 16);
      } else {
        __nv_bfloat16* o =
            pass + ((size_t)ci * 2 * h + 2 * r + p) * W + 2 * c;
        *reinterpret_cast<uint32_t*>(o) =
            __byte_perm(s[k][0], s[k][1], 0x5410);   // ci: q = 0, 1
        *reinterpret_cast<uint32_t*>(o + 4 * hplane) =
            __byte_perm(s[k][0], s[k][1], 0x7632);   // ci + 1
      }
    }
  }
}

// HALF: K3 (every stream half-res, one output). INV: the inverse. `a` is
// the stream F is added to (x1 full-res, or u(x1)) or subtracted from (y2),
// `bsrc` the stream F is computed from, `out` takes a +- F and `pass` the
// pass-through copy of bsrc in the other layout (K2 only).
template <int C, int M, bool HALF, bool INV>
__global__ void __launch_bounds__(TrCfg<C, M>::kThreads,
                                  TrCfg<C, M>::kBlocks)
    transition_mma_kernel(const __nv_bfloat16* __restrict__ a,
                          const __nv_bfloat16* __restrict__ bsrc,
                          const char* __restrict__ wq,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out,
                          __nv_bfloat16* __restrict__ pass, int h, int w) {
  using Cfg = TrCfg<C, M>;
  VST_TICKS_BEGIN();                         // tick 0: start
  constexpr int NW = Cfg::kWarps, HROW = Cfg::kHRow;
  constexpr int NTM = M / 8;                 // n-tiles of conv1 and conv2
  constexpr int C4 = 4 * C;
  constexpr bool kSrcHalf = HALF || INV;
  constexpr int kPass = HALF ? kPassNone : (INV ? kPassToFull : kPassToHalf);
  extern __shared__ __align__(128) unsigned char tm_smem[];
  unsigned char* h1 = tm_smem;
  unsigned char* xs = h1 + Cfg::kH1;         // the x stages, later h2
  unsigned char* h2 = xs;
  const uint32_t h1_a = smem_u32(h1), xs_a = smem_u32(xs);
  const uint32_t wst_a = xs_a + Cfg::kNXS * Cfg::kXS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kTT, c0 = blockIdx.x * kTT;
  const size_t hplane = (size_t)h * w;
  const size_t frame = (size_t)C4 * hplane;  // == C * 2h * 2w
  const __nv_bfloat16* srcb = bsrc + (size_t)b * frame;
  __nv_bfloat16* passb = kPass == kPassNone ? nullptr : pass + (size_t)b * frame;
  const float* b1 = bias;
  const float* b2 = b1 + M + (size_t)M * 9 * M;
  const float* b3 = b2 + M + (size_t)M * 9 * C4;

  // weight pieces in the order they are used: conv1's, conv2's, conv3's
  constexpr int kPieces = Cfg::kNP1 + Cfg::kNP2 + Cfg::kNP3;
  auto fetch_piece = [&](int idx) {
    if (idx < kPieces) {
      const uint32_t dst = wst_a + (idx & 1) * Cfg::kStage;
      if (idx < Cfg::kNP1 + Cfg::kNP2)
        load_piece<HROW>(dst, wq + (size_t)idx * Cfg::kP12, Cfg::kP12);
      else
        load_piece<kTNC3 * 2>(
            dst,
            wq + (size_t)(Cfg::kNP1 + Cfg::kNP2) * Cfg::kP12 +
                (size_t)(idx - Cfg::kNP1 - Cfg::kNP2) * Cfg::kP3,
            Cfg::kP3);
    }
    cp_async_commit();
  };

  auto stage_x = [&](int chunk) {
    stage_phases<C, kSrcHalf, kPass, NW>(
        xs + (chunk % Cfg::kNXS) * Cfg::kXS, srcb, passb, chunk * kTKC, r0,
        c0, h, w, warp, lane);
  };

  int piece = 0;
  fetch_piece(0);
  stage_x(0);
  VST_TICK();                                // 1: first x chunk staged

  // conv1 (stride 2) over the h1 ring: position p of the ring is half-res
  // position (r0 - 2 + p / 20, c0 - 2 + p % 20), reflected into the image;
  // its centre in a phase plane is that position less the plane's corner
  {
    float acc[Cfg::kU1][2][NTM][4];
    int centre[Cfg::kU1][2];
#pragma unroll
    for (int u = 0; u < Cfg::kU1; ++u) {
      zero_acc(acc[u]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = min((warp + u * NW) * 32 + mt * 16 + (lane & 15),
                          kTA * kTA - 1);
        const int q = reflect(r0 - 2 + p / kTA, h);
        const int qc = reflect(c0 - 2 + p % kTA, w);
        centre[u][mt] = clampi(q - (r0 - 3), 1, kTP - 1) * kTP +
                        clampi(qc - (c0 - 3), 1, kTP - 1);
      }
    }
    for (int chunk = 0; chunk < Cfg::kNP1; ++chunk, ++piece) {
      cp_async_wait<0>();
      __syncthreads();
      fetch_piece(piece + 1);
      if (chunk + 1 < Cfg::kNP1) stage_x(chunk + 1);
#pragma unroll
      for (int u = 0; u < Cfg::kU1; ++u)
        if ((warp + u * NW) * 32 < kTA * kTA)
          conv_piece<2, NTM, 1, kTXRow, HROW, TapsStride2<kTP, kTPlane>>(
              acc[u], xs_a + (chunk % Cfg::kNXS) * Cfg::kXS, centre[u], 0,
              wst_a + (piece & 1) * Cfg::kStage, 0, lane);
    }
    VST_TICK();                              // 2: conv1's products done
#pragma unroll
    for (int u = 0; u < Cfg::kU1; ++u)
      store_hidden<NTM, HROW>(acc[u], h1, b1, (warp + u * NW) * 32,
                              kTA * kTA, lane);
  }

  VST_TICK();                                // 3: h1 stored
  // conv2 over the h2 ring (half-res position (r0 - 1 + p / 18, ...)), from
  // h1
  {
    float acc[Cfg::kU2][2][NTM][4];
    int centre[Cfg::kU2][2];
#pragma unroll
    for (int u = 0; u < Cfg::kU2; ++u) {
      zero_acc(acc[u]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = min((warp + u * NW) * 32 + mt * 16 + (lane & 15),
                          kTB * kTB - 1);
        const int q = reflect(r0 - 1 + p / kTB, h);
        const int qc = reflect(c0 - 1 + p % kTB, w);
        centre[u][mt] = clampi(q - (r0 - 2), 1, kTA - 2) * kTA +
                        clampi(qc - (c0 - 2), 1, kTA - 2);
      }
    }
    for (int kc = 0; kc < Cfg::kNP2; ++kc, ++piece) {
      cp_async_wait<0>();
      __syncthreads();              // h1 is whole; conv1 is done with xs
      fetch_piece(piece + 1);
#pragma unroll
      for (int u = 0; u < Cfg::kU2; ++u)
        if ((warp + u * NW) * 32 < kTB * kTB)
          conv_piece<2, NTM, 1, HROW, HROW, TapsStride1<kTA>>(
              acc[u], h1_a, centre[u], kc * 2,
              wst_a + (piece & 1) * Cfg::kStage, 0, lane);
    }
#pragma unroll
    for (int u = 0; u < Cfg::kU2; ++u)
      store_hidden<NTM, HROW>(acc[u], h2, b2, (warp + u * NW) * 32,
                              kTB * kTB, lane);
  }

  VST_TICK();                                // 4: conv2 done, h2 stored
  // conv3 over the tile, from h2, then a +- (sum + bias) rounded once.
  // Column ch = (p*2 + q)*C + ci of the product is full-res (2r + p, 2c + q)
  // of channel ci.
  {
    constexpr int NT3 = Cfg::kNT3;
    const int rg = warp / Cfg::kCS3, half = warp % Cfg::kCS3;
    const int g = lane >> 2, t = lane & 3;
    const int W = 2 * w;
    const __nv_bfloat16* ab = a + (size_t)b * frame;
    __nv_bfloat16* outb = out + (size_t)b * frame;
    float acc[2][NT3][4];
    int centre[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int p = rg * 32 + mt * 16 + (lane & 15);
      centre[mt] = (p / kTT + 1) * kTB + p % kTT + 1;
    }
    zero_acc(acc);
    for (int cc = 0; cc < C4 / kTNC3; ++cc) {
      for (int kc = 0; kc < M / kTKC; ++kc, ++piece) {
        cp_async_wait<0>();
        __syncthreads();            // h2 is whole; the piece has landed
        fetch_piece(piece + 1);
        conv_piece<2, NT3, 1, HROW, kTNC3 * 2, TapsStride1<kTB>>(
            acc, smem_u32(h2), centre, kc * 2,
            wst_a + (piece & 1) * Cfg::kStage, half * NT3, lane);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = rg * 32 + mt * 16 + g + 8 * hf;
          const int r = r0 + p / kTT, c = c0 + p % kTT;
          if (r >= h || c >= w) continue;
#pragma unroll
          for (int nt = 0; nt < NT3; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ch = cc * kTNC3 + (half * NT3 + nt) * 8 + 2 * t + e;
              const float f = acc[mt][nt][2 * hf + e] + __ldg(b3 + ch);
              const int pq = ch / C, ci = ch % C;
              const size_t hidx = (size_t)ch * hplane + (size_t)r * w + c;
              const size_t fidx =
                  ((size_t)ci * 2 * h + 2 * r + (pq >> 1)) * W + 2 * c +
                  (pq & 1);
              if (HALF) {
                const float av = __bfloat162float(ab[hidx]);
                outb[hidx] = __float2bfloat16_rn(INV ? av - f : av + f);
              } else if (!INV) {
                outb[hidx] =
                    __float2bfloat16_rn(__bfloat162float(ab[fidx]) + f);
              } else {
                outb[fidx] =
                    __float2bfloat16_rn(__bfloat162float(ab[hidx]) - f);
              }
            }
        }
      zero_acc(acc);
    }
  }
  cp_async_wait<0>();
  VST_TICK();                                // 5: conv3 and the output done
  VST_TICKS_END(vst_tr_ticks);
}

template <int C, int M, bool HALF, bool INV>
int launch_tr(const void* a, const void* b, const void* wq, const void* bias,
              void* out, void* pass, int B, int h, int w,
              cudaStream_t stream) {
  using Cfg = TrCfg<C, M>;
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      transition_mma_kernel<C, M, HALF, INV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kTT - 1) / kTT, (h + kTT - 1) / kTT, B);
  transition_mma_kernel<C, M, HALF, INV>
      <<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(
          static_cast<const __nv_bfloat16*>(a),
          static_cast<const __nv_bfloat16*>(b), static_cast<const char*>(wq),
          static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
          static_cast<__nv_bfloat16*>(pass), h, w);
  return (int)cudaGetLastError();
}

template <bool HALF>
int launch_transition_mma(const void* a, const void* b, const void* wq,
                          const void* bias, void* out, void* pass, int B,
                          int C, int M, int h, int w, int inverse,
                          cudaStream_t s) {
  if (h < 2 || w < 2 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  // the staging reads and writes full-res column pairs as 4 bytes
  if (((uintptr_t)b | (uintptr_t)pass) & 3) return (int)cudaErrorInvalidValue;
  if (C == 64 && M == 64)
    return inverse ? launch_tr<64, 64, HALF, true>(a, b, wq, bias, out, pass,
                                                   B, h, w, s)
                   : launch_tr<64, 64, HALF, false>(a, b, wq, bias, out, pass,
                                                    B, h, w, s);
  if (C == 16 && M == 16)
    return inverse ? launch_tr<16, 16, HALF, true>(a, b, wq, bias, out, pass,
                                                   B, h, w, s)
                   : launch_tr<16, 16, HALF, false>(a, b, wq, bias, out, pass,
                                                    B, h, w, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace vst

// K2. forward: a = x1, b = x2 (B, C, 2h, 2w) -> out0 = u(x2), out1 = F(x2)
// + u(x1), (B, 4C, h, w). inverse: a = y2, b = y1 half-res -> out0 = x1,
// out1 = x2 full-res. wq: the bf16 pieces of pack_transition_mma. bias: b1
// inside the float32 packed buffer of transition.cu (b1, w2, b2, w3, b3
// follow each other there).
extern "C" int vst_transition_mma(const void* a, const void* b,
                                  const void* wq, const void* bias,
                                  void* out0, void* out1, int B, int C, int M,
                                  int h, int w, int inverse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return inverse ? vst::launch_transition_mma<false>(
                       a, b, wq, bias, out0, out1, B, C, M, h, w, 1, s)
                 : vst::launch_transition_mma<false>(
                       a, b, wq, bias, out1, out0, B, C, M, h, w, 0, s);
}

// K3: a, b and out are (B, 4C, h, w); out = F(s(b)) + a, or a - F(s(b))
// with inverse.
extern "C" int vst_transition_half_mma(const void* a, const void* b,
                                       const void* wq, const void* bias,
                                       void* out, int B, int C, int M, int h,
                                       int w, int inverse, void* stream) {
  return vst::launch_transition_mma<true>(
      a, b, wq, bias, out, nullptr, B, C, M, h, w, inverse,
      static_cast<cudaStream_t>(stream));
}

#ifdef VST_PHASE_TICKS
// ticks: device buffer of at least blocks x 16 x 8 int64, or null to stop
// recording
extern "C" int vst_transition_mma_set_ticks(void* ticks) {
  return (int)cudaMemcpyToSymbol(vst_tr_ticks, &ticks, sizeof(ticks));
}
#endif
