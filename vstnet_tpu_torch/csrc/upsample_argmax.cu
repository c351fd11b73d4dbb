// The segmenter's last step in one pass: the half-pixel bilinear upsample
// of its float32 logits (B, h, w, C) to (B, H, W, C), align_corners=False,
// and the argmax over C, written as int32 (B, H, W). The upsampled logits
// are never stored.
//
// Each value is F.interpolate's on a CUDA card (its channels-last kernel),
// bit for bit: the source index scale * (i + 0.5) - 0.5 clamped at 0, with
// scale the float in / out; the lower tap floor of it, the upper one the
// next row or column inside the image; the blend
//   h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d)
// in float32 with the fused multiply-adds that nvcc makes of that
// expression: fma(h0, fma(w1, b, w0 * a), h1 * fma(w0, c, w1 * d)), the
// sums of the lower tap's row and of the upper tap's contracted in
// opposite orders (found by comparing every contraction with torch's
// kernel on an H100; CUDA 12.8, torch 2.11). The argmax is torch's: a NaN beats any number, and a
// tie goes to the lower index.
//
// A block covers kUaRows output rows by kUaCols output columns of one
// frame, one thread a column. It stages the input rows and columns that
// tile reads, kUaChunk channels at a time, in shared memory by cp.async,
// the next chunk loading while the last is read (two buffers; a pixel's
// channels padded to kUaChunk + 1 floats, so that a warp's threads
// reading different pixels hit different banks). Per channel a thread
// blends each staged input row along x once in each of its two roles (the
// lower and the upper tap) and reuses it for every output row that reads
// it; the block's output rows are the same for all its threads, so the
// reuse branches never diverge. The logits grow at least twofold on both
// axes, which bounds the window: 7 x 67 pixels (124 KB for both buffers)
// at twofold, 4 x 34 (36 KB) at the head's fourfold.
#include <cuda_runtime.h>

#include <cmath>

#include "conv_fma.cuh"  // cp_async4, cp_async_commit, cp_async_wait

namespace vst {

constexpr int kUaCols = 128;   // output columns a block, one a thread
constexpr int kUaRows = 8;     // output rows a block
constexpr int kUaChunk = 32;   // channels staged at a time
constexpr int kUaPitch = kUaChunk + 1;

// F.interpolate's source index (align_corners=False, not cubic)
__device__ __forceinline__ float ua_source(float scale, int dst) {
  const float s = __fmaf_rn(scale, (float)dst + 0.5f, -0.5f);
  return s < 0.f ? 0.f : s;
}

// the lower tap, the upper one (inside the image) and the upper weight
__device__ __forceinline__ void ua_taps(float scale, int dst, int n_in,
                                        int* lo, int* hi, float* lambda) {
  const float r = ua_source(scale, dst);
  const int i = (int)r;
  *lo = i;
  *hi = i + (i < n_in - 1 ? 1 : 0);
  *lambda = r - (float)i;
}

__global__ void __launch_bounds__(kUaCols)
    upsample_argmax_kernel(const float* __restrict__ in,
                           int* __restrict__ out, int h, int w, int C, int H,
                           int W, float rh, float rw, int rows_max,
                           int cols_max) {
  extern __shared__ float stage[];
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * kUaRows;
  const int ox0 = blockIdx.x * kUaCols;
  const int ox = ox0 + threadIdx.x;

  // the tile's input window: rows y_lo..y_hi, columns x_lo..x_hi
  int y_lo, y_hi, x_lo, x_hi, t;
  float unused;
  const int rows_out = min(kUaRows, H - oy0);
  const int cols_out = min(kUaCols, W - ox0);
  ua_taps(rh, oy0, h, &y_lo, &t, &unused);
  ua_taps(rh, oy0 + rows_out - 1, h, &t, &y_hi, &unused);
  ua_taps(rw, ox0, w, &x_lo, &t, &unused);
  ua_taps(rw, ox0 + cols_out - 1, w, &t, &x_hi, &unused);
  const int n_rows = y_hi - y_lo + 1;
  const int n_cols = x_hi - x_lo + 1;
  if (n_rows > rows_max || n_cols > cols_max) __trap();  // ua_window's bound

  // this thread's column: its two taps in the window and their weights
  int xa, xb;
  float w1;
  ua_taps(rw, min(ox, W - 1), w, &xa, &xb, &w1);
  const float w0 = 1.f - w1;
  xa = (xa - x_lo) * kUaPitch;
  xb = (xb - x_lo) * kUaPitch;
  // the block's rows: each one's two taps (window rows) and weights; rows
  // past the image repeat the last
  int ra[kUaRows], rb[kUaRows];
  float h0[kUaRows], h1[kUaRows];
#pragma unroll
  for (int r = 0; r < kUaRows; ++r) {
    ua_taps(rh, oy0 + min(r, rows_out - 1), h, &ra[r], &rb[r], &h1[r]);
    h0[r] = 1.f - h1[r];
    ra[r] -= y_lo;
    rb[r] -= y_lo;
  }

  float best[kUaRows];
  int arg[kUaRows];
#pragma unroll
  for (int r = 0; r < kUaRows; ++r) {
    best[r] = -INFINITY;
    arg[r] = 0;
  }

  // a chunk's window into stage buffer `buf` by cp.async, a warp a pixel
  // at a time and a channel a lane, committed as one group
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pixels = n_rows * n_cols;
  const int buf_floats = rows_max * cols_max * kUaPitch;
  const float* frame = in + (size_t)b * h * w * C;
  auto load_chunk = [&](int c0, float* buf) {
    if (lane < min(kUaChunk, C - c0)) {
      int py = warp / n_cols, px = warp - py * n_cols;
      for (int p = warp; p < pixels; p += kUaCols / 32) {
        cp_async4(buf + (py * cols_max + px) * kUaPitch + lane,
                  frame + ((size_t)(y_lo + py) * w + x_lo + px) * C + c0 +
                      lane);
        for (px += kUaCols / 32; px >= n_cols; px -= n_cols) ++py;
      }
    }
    cp_async_commit();
  };

  load_chunk(0, stage);
  for (int c0 = 0, i = 0; c0 < C; c0 += kUaChunk, ++i) {
    const float* buf = stage + (i & 1) * buf_floats;
    // the next chunk loads while this one is read
    if (c0 + kUaChunk < C) {
      load_chunk(c0 + kUaChunk, stage + ((i + 1) & 1) * buf_floats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int cc = min(kUaChunk, C - c0);
    if (ox < W) {
      for (int c = 0; c < cc; ++c) {
        const float* col = buf + c;
        // the x blend of window row y as the lower tap's row and as the
        // upper tap's, contracted as F.interpolate's build contracts them
        auto lower_tap = [&](int y) {
          const float* row = col + y * cols_max * kUaPitch;
          return __fmaf_rn(w1, row[xb], __fmul_rn(w0, row[xa]));
        };
        auto upper_tap = [&](int y) {
          const float* row = col + y * cols_max * kUaPitch;
          return __fmaf_rn(w0, row[xa], __fmul_rn(w1, row[xb]));
        };
        int ya = -1, yb = -1;
        float va = 0.f, vb = 0.f;
#pragma unroll
        for (int r = 0; r < kUaRows; ++r) {
          if (ra[r] != ya) {
            va = lower_tap(ra[r]);
            ya = ra[r];
          }
          if (rb[r] != yb) {
            vb = upper_tap(rb[r]);
            yb = rb[r];
          }
          const float v = __fmaf_rn(h0[r], va, __fmul_rn(h1[r], vb));
          // torch's order: v wins if above (or NaN beside a number); once
          // the best is NaN nothing displaces it
          if (!(v <= best[r]) && best[r] == best[r]) {
            best[r] = v;
            arg[r] = c0 + c;
          }
        }
      }
    }
    __syncthreads();  // every read of buf is done before it is refilled
  }
  if (ox >= W) return;
#pragma unroll
  for (int r = 0; r < kUaRows; ++r)
    if (r < rows_out)
      out[((size_t)b * H + oy0 + r) * W + ox] = arg[r];
}

// the window's extent on one axis for a tile of n outputs, at most: the
// lower taps of its first and last output lie floor(scale * (n - 1)) + 1
// apart, the upper tap adds one, and one more is kept for the rounding of
// the source index
inline int ua_window(float scale, int n, int n_in) {
  const int span = (int)floorf(scale * (float)(n - 1)) + 4;
  return span < n_in ? span : n_in;
}

}  // namespace vst

// logits (B, h, w, C) float32 contiguous -> out (B, H, W) int32, with
// H >= 2h and W >= 2w
extern "C" int vst_upsample_argmax(const void* logits, void* out, int B,
                                   int h, int w, int C, int H, int W,
                                   void* stream) {
  using namespace vst;
  if (B < 1 || h < 1 || w < 1 || C < 1 || H < 2 * h || W < 2 * w ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // report only what this launch does
  // F.interpolate's scales: float(in) / out
  const float rh = (float)h / (float)H, rw = (float)w / (float)W;
  const int rows_max = ua_window(rh, kUaRows, h);
  const int cols_max = ua_window(rw, kUaCols, w);
  const size_t smem =
      2 * (size_t)rows_max * cols_max * kUaPitch * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        upsample_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kUaCols - 1) / kUaCols, (H + kUaRows - 1) / kUaRows,
                  B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  upsample_argmax_kernel<<<grid, kUaCols, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<int*>(out), h, w, C, H,
      W, rh, rw, rows_max, cols_max);
  return (int)cudaGetLastError();
}
