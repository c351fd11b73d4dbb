// K5: 3x3 depthwise conv + bias + exact GELU of the SegFormer MixFFN, NHWC.
//
// Replaces the TPU kernel vstnet_tpu/ops/dwconv.py: dwconv3x3_bias_gelu
// (kernel body _dwconv_kernel). For x (B, H, W, C) in bf16, taps w (3, 3, C)
// and bias (C,) in float32 it computes, in one pass,
//   out = gelu(sum_{ky,kx} x[y+ky-1, x+kx-1, c] * w[ky, kx, c] + bias[c])
// with zero SAME padding, the taps multiplied and summed in float32 in
// (ky, kx) order by fmaf from 0, the erf form of GELU in float32 with
// erff, and one rounding to bf16. CUDA has erff, so the TPU kernel's
// rational erf is not carried over; the two differ by less than 1e-6, far
// under a bf16 ulp.
//
// What bounds it on an H100: 4 bytes of device memory per element (x read
// once, out written once) against 9 multiply-adds, the bias and a GELU
// whose erff alone is ~26 instructions (branch-free: both ranges' terms
// selected by FSEL). The bound counts the bytes (0.040 ms at C=256 128x128
// B=8), but the card issues 4 warp-instructions a clock per SM, and the
// ~45 instructions an element needs at the least take about as long at
// 1.98 GHz: the kernel is bound by instruction issue, and its design
// spends as few instructions as it can on anything but the arithmetic.
//
// Design. A block of 256 threads (128 for images 8 wide or less) owns a
// channel slab and walks over tiles of 8 rows x TW columns (TW = 32, 16 or
// 8 by the image width; slab 32, 64 or 64 channels, so narrow images keep
// the threads on pixels). One thread loads each tile with its one-pixel
// halo, (8 + 2) x (TW + 2) x slab bf16, by a TMA tiled copy of an NHWC
// tensor map into shared memory: the copy engine computes the addresses
// and zero-fills what lies outside the image or past C, so the padding and
// the staging cost the other threads no instruction. The blocks are
// persistent (two per SM, as many as the card holds at once) and
// double-buffered: the next tile's copy is issued when the current one has
// landed and flies while it is computed, and an mbarrier per buffer says
// when a copy is in. Tiles go slab-fastest, so the blocks on the card at
// one time read whole pixel rows of memory and share their halo rows
// through L2; a tile's coordinates come from a multiply-and-shift division.
//
// Each thread owns 4 channels of one column and walks down its 8 rows: an
// input row's three columns are read from shared memory once (three
// 8-byte loads, conflict-free: a warp reads 256 contiguous bytes), widened
// once, and fed to the three output rows that use it (ky = 2 of the row
// above, ky = 1 of its own, ky = 0 of the row below). Every output's nine
// fmaf still run in (ky, kx) order from 0, so the result is the earlier
// per-pixel kernel's, and its plain version's, bit for bit wherever those
// agree: a zero-filled tap adds +-0 to a sum that is never -0. Taps and
// bias (40 floats) stay in registers; each output row is one 8-byte store.
// Measured and not kept: two or four columns a thread (fewer instructions,
// but 4-warp blocks stall on their dependency chains), 64-channel slabs
// at every width, 16-row tiles staged by cp.async, three or four blocks an
// SM, a prefetched tensor map.
#include <atomic>

#include "common.cuh"
#include "conv_mma.cuh"
#include "tensor_map.cuh"

#ifdef VST_PHASE_TICKS
__device__ long long* vst_dw_ticks = nullptr;  // see conv_mma.cuh
#endif

namespace vst {

constexpr int kDwRows = 8;  // output rows of a tile
constexpr int kDwMinBlocks = 2;

template <int TW> struct DwCfg {
  static constexpr int kGroups = TW == 8 ? 16 : 256 / TW;  // 4 channels each
  static constexpr int kThreads = kGroups * TW;
  static constexpr int kSlab = 4 * kGroups;  // channels of a tile
  static constexpr int kRows = kDwRows + 2;  // staged rows
  static constexpr int kCols = TW + 2;       // staged columns
  static constexpr int kElems = kRows * kCols * kSlab;
  static constexpr int kBytes = kElems * 2;  // one staged tile
};

__device__ __forceinline__ void widen4(uint2 raw, float (&f)[4]) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1; m and s
// from the host, fast_div): a tile's coordinates cost no division loop.
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

inline FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, (unsigned)m, s};
}

// Tile t (slab-fastest) -> TMA coordinates of its staged corner.
struct DwTile {
  int c0, x0, y0, b;
};

template <int TW>
__device__ __forceinline__ DwTile dw_tile(unsigned t, const FastDiv& slabs,
                                          const FastDiv& tiles_x,
                                          const FastDiv& tiles_y) {
  DwTile r;
  unsigned q = slabs.div(t);
  r.c0 = (int)(t - q * slabs.d) * DwCfg<TW>::kSlab;
  t = q;
  q = tiles_x.div(t);
  r.x0 = (int)(t - q * tiles_x.d) * TW - 1;
  t = q;
  q = tiles_y.div(t);
  r.y0 = (int)(t - q * tiles_y.d) * kDwRows - 1;
  r.b = (int)q;
  return r;
}

// One thread: the tile's copy into `dst`, completing on `bar`.
template <int TW>
__device__ __forceinline__ void dw_load(const CUtensorMap& map, uint32_t dst,
                                        uint32_t bar, const DwTile& t) {
  tensor_load_4d(dst, &map, t.c0, t.x0, t.y0, t.b, DwCfg<TW>::kBytes, bar);
}

__device__ __forceinline__ void dw_taps(const float* __restrict__ w,
                                        const float* __restrict__ bias,
                                        int c, int C, float (&wt)[9][4],
                                        float (&bs)[4]) {
  if (c < C) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w + t * C + c));
      wt[t][0] = v.x;
      wt[t][1] = v.y;
      wt[t][2] = v.z;
      wt[t][3] = v.w;
    }
    const float4 v = __ldg(reinterpret_cast<const float4*>(bias + c));
    bs[0] = v.x;
    bs[1] = v.y;
    bs[2] = v.z;
    bs[3] = v.w;
  } else {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) wt[t][q] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) bs[q] = 0.f;
  }
}

// Walk down one column of a staged tile (`src`: this thread's channels in
// staged row 0, column 0 of its window): staged row i feeds ky = 2 of
// output row i - 2, ky = 1 of row i - 1 and ky = 0 of row i. `rows` output
// rows lie in the image; `dst` is output row 0 of this thread.
template <int TW>
__device__ __forceinline__ void dw_column(const __nv_bfloat16* src,
                                          __nv_bfloat16* dst, size_t pitch,
                                          int rows, bool active,
                                          const float (&wt)[9][4],
                                          const float (&bs)[4]) {
  using Cfg = DwCfg<TW>;
  float acc[kDwRows][4];
#pragma unroll
  for (int i = 0; i < kDwRows + 2; ++i) {
    uint2 raw[3];
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
      raw[kx] = *reinterpret_cast<const uint2*>(
          src + (i * Cfg::kCols + kx) * Cfg::kSlab);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      float f[4];
      widen4(raw[kx], f);
#pragma unroll
      for (int ky = 2; ky >= 0; --ky) {
        const int r = i - ky;
        if (r < 0 || r >= kDwRows) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = fmaf(f[q], wt[ky * 3 + kx][q],
                           ky == 0 && kx == 0 ? 0.f : acc[r][q]);
      }
    }
    const int r = i - 2;
    if (r >= 0 && active && r < rows) {
      float gl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = acc[r][q] + bs[q];
        gl[q] = 0.5f * v * (1.f + erff(v * 0.70710678f));
      }
      *reinterpret_cast<uint2*>(dst + (size_t)r * pitch) =
          make_uint2(pack_bf16(gl[0], gl[1]), pack_bf16(gl[2], gl[3]));
    }
  }
}

template <int TW>
__global__ void __launch_bounds__(DwCfg<TW>::kThreads, kDwMinBlocks)
    dwconv_gelu_kernel(const __grid_constant__ CUtensorMap map,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ out, int H, int W, int C,
                       FastDiv slabs, FastDiv tiles_x, FastDiv tiles_y,
                       int tiles) {
  using Cfg = DwCfg<TW>;
  __shared__ __align__(128) __nv_bfloat16 tile[2][Cfg::kElems];
  __shared__ __align__(8) uint64_t full[2];
  VST_TICKS_BEGIN();                         // tick 0: start
  const uint32_t bar0 = smem_u32(&full[0]), bar1 = smem_u32(&full[1]);
  const uint32_t buf0 = smem_u32(tile[0]), buf1 = smem_u32(tile[1]);
  const int step = gridDim.x;
  if (threadIdx.x == 0) {
    mbar_init_count(bar0, 1);
    mbar_init_count(bar1, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    dw_load<TW>(map, buf0, bar0,
                dw_tile<TW>(blockIdx.x, slabs, tiles_x, tiles_y));
  const int g = threadIdx.x % Cfg::kGroups, col = threadIdx.x / Cfg::kGroups;
  const size_t pitch = (size_t)W * C;
#ifdef VST_PHASE_TICKS
  long long waited = 0;
#endif
  int n = 0;
  for (int t = blockIdx.x; t < tiles; t += step, ++n) {
    const int s = n & 1;
    const DwTile cur = dw_tile<TW>(t, slabs, tiles_x, tiles_y);
    const int c = cur.c0 + 4 * g, xo = cur.x0 + 1 + col;
    float wt[9][4], bs[4];
    dw_taps(w, bias, c, C, wt, bs);
#ifdef VST_PHASE_TICKS
    const long long w0 = clock64();
#endif
    mbar_wait_parity(s ? bar1 : bar0, (n >> 1) & 1);
#ifdef VST_PHASE_TICKS
    if (n == 0) {
      VST_TICK();                            // 1: first tile staged
    } else {
      waited += clock64() - w0;
    }
#endif
    // the next tile's copy flies while this one is computed; its buffer
    // was released by the barrier that ended the tile before this one
    if (threadIdx.x == 0 && t + step < tiles)
      dw_load<TW>(map, s ? buf0 : buf1, s ? bar0 : bar1,
                  dw_tile<TW>(t + step, slabs, tiles_x, tiles_y));
    dw_column<TW>(tile[s] + col * Cfg::kSlab + 4 * g,
                  out + ((size_t)(cur.b * H + cur.y0 + 1) * W + xo) * C + c,
                  pitch, H - cur.y0 - 1, c < C && xo < W, wt, bs);
#ifdef VST_PHASE_TICKS
    if (n == 0) VST_TICK();                  // 2: first tile computed
#endif
    __syncthreads();  // every thread is done with buffer s
  }
#ifdef VST_PHASE_TICKS
  VST_TICK();                                // 3: every tile done
  vst_tk[vst_nk++] = vst_tk[0] + waited;     // 4: waits after the first
  vst_tk[vst_nk++] = vst_tk[0] + n;          // 5: tiles of this block
#endif
  VST_TICKS_END(vst_dw_ticks);
}

constexpr int kMaxDevices = 64;

// The blocks the current device holds at once, for kernel instance TW. The
// count belongs to a device, so it is kept per device ordinal, in an atomic
// slot that is 0 until the device's first launch computes it; two threads
// that compute it together store the same value.
template <int TW>
cudaError_t resident_blocks(int* out) {
  static std::atomic<int> resident[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int r = resident[dev].load(std::memory_order_relaxed);
  if (r == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dwconv_gelu_kernel<TW>, DwCfg<TW>::kThreads, 0);
    if (e != cudaSuccess) return e;
    r = sms * (per_sm > 0 ? per_sm : 1);
    resident[dev].store(r, std::memory_order_relaxed);
  }
  *out = r;
  return cudaSuccess;
}

template <int TW>
int launch_dwconv(const void* x, const void* w, const void* bias, void* out,
                  int B, int H, int W, int C, cudaStream_t stream) {
  using Cfg = DwCfg<TW>;
  const int slabs = (C + Cfg::kSlab - 1) / Cfg::kSlab;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + kDwRows - 1) / kDwRows;
  const long long tiles = (long long)B * tiles_y * tiles_x * slabs;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidValue;
  int resident = 0;
  const cudaError_t e = resident_blocks<TW>(&resident);
  if (e != cudaSuccess) return (int)e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // NHWC as a 4-d tensor, channels innermost; the box is one staged tile
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {Cfg::kSlab, Cfg::kCols, Cfg::kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map;
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(tiles < resident ? tiles : resident);
  dwconv_gelu_kernel<TW><<<blocks, Cfg::kThreads, 0, stream>>>(
      map, static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, C, fast_div(slabs),
      fast_div(tiles_x), fast_div(tiles_y), (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace vst

extern "C" int vst_dwconv_gelu(const void* x, const void* w, const void* bias,
                               void* out, int B, int H, int W, int C,
                               void* stream) {
  using namespace vst;
  if (C % 8 || B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // report only what this launch does
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile's width follows the image's, so narrow images do not leave
  // threads idle: the slab widens instead
  if (W > 16) return launch_dwconv<32>(x, w, bias, out, B, H, W, C, s);
  if (W > 8) return launch_dwconv<16>(x, w, bias, out, B, H, W, C, s);
  return launch_dwconv<8>(x, w, bias, out, B, H, W, C, s);
}

#ifdef VST_PHASE_TICKS
// ticks: device buffer of at least blocks x 16 x 8 int64, or null to stop
// recording
extern "C" int vst_dwconv_set_ticks(void* ticks) {
  return (int)cudaMemcpyToSymbol(vst_dw_ticks, &ticks, sizeof(ticks));
}
#endif
