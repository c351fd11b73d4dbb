// The regional cWCT's two passes over the latent's rows: per-label moments
// summed in float64, and the per-label transform applied to each row.
//
// Replaces no TPU kernel. The JAX package sums the per-label moments as
// one-hot products scanned over chunks of rows and applies every label's
// transform to every row before picking one (vstnet_tpu/models/cwct.py:
// region_moments, apply_regions), both left to XLA; the port's torch
// version of the same (models/cwct.py: region_moments_plain,
// apply_regions_plain) costs a dozen launches a chunk of rows, a few
// thousand a video batch, and K times the arithmetic a row needs. These
// kernels take a batch of frames in one launch each, and each row meets
// its own region alone: a row finds its label's slot in a K-entry table in
// shared memory, and the one-hot product is never formed.
//
// x (B, N, C) rows in bf16 or float32, C = 32 or 128; m (B, N) int32
// labels; labels (K,) shared by the frames or (B, K) one table a frame
// (label_stride 0 or K).
//
// Moments. For each frame and slot k: the count, the sums and the Gram
// (C x C) of the rows whose label equals labels[k], in float64. A row adds
// to every slot of its label (the repeated -1 pad slots), and a row whose
// label is in no slot (the tiler's -2) adds nothing. A frame's rows are
// cut into P chunks of R rows; a group (one warp at C = 32, eight at 128)
// walks one chunk in order, 32 rows a tile staged in shared memory as
// float64 (the next tile's 16-byte loads in flight while one is summed),
// four rows at a time: a quad is one k-step of the float64 tensor cores'
// D (8x8) += A (8x4) B (4x8), whose A and B fragments are the same values
// (lane l holds channel 8 I + l / 4 of the quad's row l % 4), so the 10
// blocks I <= J of the Gram's upper triangle (136 at C = 128) cost 10 mma
// a quad. bf16 and float32 values multiply exactly in float64. Masks are
// spatially coherent, so a chunk meets few labels, in runs: a quad within
// the run is summed whole; at a run's end the quad's rows of each label
// are summed in turn, the others entering as zeros, and the run's
// registers are stored to (first time) or added to the chunk's partial of
// that slot in device memory. A second kernel adds each slot's chunk
// partials in chunk order and mirrors the upper triangle, so the Gram is
// symmetric bit for bit. Every sum runs in a fixed order: two runs give
// the same bits. Bound by the bytes at C = 32: a bf16 batch of 8 frames of
// 1280x720 (7.4 M rows, 472 MB) and its labels read once, 0.15 ms, against
// 0.12 ms for its 8.3 GFLOP (the upper triangle and the sums) at the
// float64 tensor cores' 67 TFLOP/s. Partials take P x K x (C*C + C + 1) float64 a
// frame; the wrapper caps P so that they fit its budget.
//
// Apply. For each row: the first slot whose label equals the row's and
// that is valid (apply_regions' argmax), then y = T x + b with T rounded to
// the latent's dtype (the wrapper hands it over so), the products summed in
// float32 from 0 in channel order, b added and the result rounded once to
// the latent's dtype; a row with no valid slot keeps its content. A group
// of C threads walks a chunk of rows staged as float32 tiles; thread p
// holds row p of the run's T in registers, reloads it when the label
// changes, and writes channel p of each row, reading the row's values as
// broadcasts. Bound by the bytes: the batch read once and written once,
// 0.29 ms at 8 x 1280x720 in bf16 (1024 float32 fma a row, 0.22 ms at 67
// TFLOP/s).
#include <cstdint>

#include "common.cuh"

namespace vst {

constexpr int kRgRows = 32;  // rows a tile

template <typename T> struct Lanes;  // elements in 16 bytes
template <> struct Lanes<float> { static constexpr int n = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int n = 8; };

template <typename T>
__device__ __forceinline__ void widen16(const uint4& v, float* f);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& v,
                                                      float* f) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// barrier of one group of G threads: the warp, or named barrier g + 1
template <int G> __device__ __forceinline__ void group_sync(int g) {
  if constexpr (G == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(G) : "memory");
  }
}

// A group's chunk of rows, staged a tile at a time into shared memory as S
// (double or float), kStride elements a row; the next tile's 16-byte loads
// fly while one is used.
template <typename T, typename S, int C, int G, int kStride>
struct RowTiles {
  static constexpr int kV = Lanes<T>::n;
  static constexpr int kNV = kRgRows * C / kV / G;  // vectors a thread
  static_assert(kNV >= 1 && kNV * kV * G == kRgRows * C, "tile split");
  const T* x;      // the frame's rows
  const int* m;    // the frame's labels
  long long end;   // one past the chunk's last row
  uint4 v[kNV];
  int lab;

  __device__ __forceinline__ void load(long long r0, int t) {
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const long long e = r0 * C + (long long)(t + i * G) * kV;
      if (e < end * C) v[i] = __ldg(reinterpret_cast<const uint4*>(x + e));
    }
    if (t < kRgRows && r0 + t < end) lab = __ldg(m + r0 + t);
  }

  __device__ __forceinline__ void stage(long long r0, int t, S* xs,
                                        int* ml) const {
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      const int o = (t + i * G) * kV;
      if (r0 * C + o < end * C) {
        float f[kV];
        widen16<T>(v[i], f);
        S* dst = xs + (o / C) * kStride + o % C;
#pragma unroll
        for (int j = 0; j < kV; ++j) dst[j] = static_cast<S>(f[j]);
      }
    }
    if (t < kRgRows) ml[t] = lab;
  }
};

// D (8x8) += A (8x4) B (4x8) in float64 on the tensor cores. Lane l holds
// A[l / 4][l % 4], B[l % 4][l / 4] and D[l / 4][2 (l % 4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// the t-th 8x8 block (row I, column J >= I) of the Gram's upper triangle
// of nb x nb blocks, row by row
__host__ __device__ constexpr int tri_row(int t, int nb) {
  int i = 0;
  while (t >= nb - i) {
    t -= nb - i;
    ++i;
  }
  return i;
}
__host__ __device__ constexpr int tri_col(int t, int nb) {
  int i = 0;
  while (t >= nb - i) {
    t -= nb - i;
    ++i;
  }
  return i + t;
}

// v stored to *e (first) or added to it, by relaxed operations at device
// scope: one thread's operations on one address keep their order
__device__ __forceinline__ void put(double* e, double v, bool first) {
  if (first)
    asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(e), "d"(v)
                 : "memory");
  else
    asm volatile("red.relaxed.gpu.global.add.f64 [%0], %1;" ::"l"(e), "d"(v)
                 : "memory");
}

template <int C> struct MomentsCfg {
  static constexpr int kNB = C / 8;                // channel blocks
  static constexpr int kNT = kNB * (kNB + 1) / 2;  // Gram blocks, I <= J
  static constexpr int kWarps = C <= 32 ? 1 : 8;   // warps a chunk
  static constexpr int kBPW = kNT / kWarps;        // Gram blocks a warp
  static constexpr int kSPW = kNB / kWarps;        // sum blocks a warp
  static_assert(kBPW * kWarps == kNT && kSPW * kWarps == kNB, "split");
  static constexpr int kGroup = 32 * kWarps;       // threads a chunk
  static constexpr int kGroups = 256 / kGroup;     // chunks a block
  static constexpr int kThreads = kGroup * kGroups;
  // doubles a staged row: a fragment's 4 rows x 8 channels fill each bank
  // pair twice, the fewest passes a 256-byte load takes
  static constexpr int kStride = C + 8;
  static constexpr int kE = C * C + C + 1;  // Gram, sums, count
};

template <int C> constexpr int moments_smem(int K) {
  using Cfg = MomentsCfg<C>;
  return Cfg::kGroups * kRgRows * Cfg::kStride * 8 +
         Cfg::kGroups * kRgRows * 4 + K * 4 +
         (Cfg::kGroups * K + 15) / 16 * 16;
}

template <int C, typename T>
__global__ void __launch_bounds__(MomentsCfg<C>::kThreads)
    region_moments_kernel(const T* __restrict__ x, const int* __restrict__ m,
                          const int* __restrict__ labels, int label_stride,
                          double* __restrict__ partial,
                          unsigned char* __restrict__ touched_out,
                          long long N, int K, int P, int R) {
  using Cfg = MomentsCfg<C>;
  constexpr int G = Cfg::kGroup, S = Cfg::kStride;
  extern __shared__ __align__(16) unsigned char rg_smem[];
  double* xs_all = reinterpret_cast<double*>(rg_smem);
  int* ml_all = reinterpret_cast<int*>(xs_all + Cfg::kGroups * kRgRows * S);
  int* lab = ml_all + Cfg::kGroups * kRgRows;
  unsigned char* touched_all = reinterpret_cast<unsigned char*>(lab + K);

  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    lab[k] = labels[(long long)b * label_stride + k];
  for (int i = threadIdx.x; i < Cfg::kGroups * K; i += blockDim.x)
    touched_all[i] = 0;
  __syncthreads();
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int chunk = blockIdx.x * Cfg::kGroups + g;
  if (chunk >= P) return;  // whole groups leave; only group barriers follow

  double* xs = xs_all + g * kRgRows * S;
  int* ml = ml_all + g * kRgRows;
  unsigned char* touched = touched_all + g * K;
  const long long row0 = (long long)chunk * R;
  RowTiles<T, double, C, G, S> tiles{x + (long long)b * N * C,
                                     m + (long long)b * N,
                                     row0 + R < N ? row0 + R : N};
  // lane (s, c) feeds sample s of a quad of rows, channels 8 I + c
  const int w = t / 32, lane = t % 32, s = lane % 4, c = lane / 4;
  double d[Cfg::kBPW][2];
  double sum[Cfg::kSPW];
#pragma unroll
  for (int i = 0; i < Cfg::kBPW; ++i) d[i][0] = d[i][1] = 0.0;
#pragma unroll
  for (int j = 0; j < Cfg::kSPW; ++j) sum[j] = 0.0;
  int cnt = 0;
  double* base = partial + ((long long)b * P + chunk) * K * Cfg::kE;

  // the Gram blocks, sums and count of a quad's samples that `keep` (this
  // lane's sample) holds: the others enter as zeros
  auto accumulate = [&](const double* xr, bool keep) {
    if constexpr (Cfg::kWarps == 1) {
      double f[Cfg::kNB];
#pragma unroll
      for (int i = 0; i < Cfg::kNB; ++i) f[i] = keep ? xr[8 * i + c] : 0.0;
#pragma unroll
      for (int i = 0; i < Cfg::kBPW; ++i)
        dmma(d[i], f[tri_row(i, Cfg::kNB)], f[tri_col(i, Cfg::kNB)]);
#pragma unroll
      for (int j = 0; j < Cfg::kSPW; ++j) sum[j] += f[j];
    } else {
#pragma unroll
      for (int i = 0; i < Cfg::kBPW; ++i) {
        const int tb = w * Cfg::kBPW + i;
        const double a = keep ? xr[8 * tri_row(tb, Cfg::kNB) + c] : 0.0;
        const double v = keep ? xr[8 * tri_col(tb, Cfg::kNB) + c] : 0.0;
        dmma(d[i], a, v);
      }
#pragma unroll
      for (int j = 0; j < Cfg::kSPW; ++j)
        sum[j] += keep ? xr[8 * (w * Cfg::kSPW + j) + c] : 0.0;
    }
  };

  // the run's registers stored to (first time) or added to slot k's
  // partial: its Gram's upper blocks, its sums, its count. Each entry has
  // one writer, this lane, whose store and adds reach it in program order;
  // the adds are fire-and-forget, so a run's end costs no round trip
  auto flush = [&](int k) {
    group_sync<G>(g);
    const bool first = !touched[k];
    group_sync<G>(g);
    if (t == 0) touched[k] = 1;
    double* dst = base + (long long)k * Cfg::kE;
#pragma unroll
    for (int i = 0; i < Cfg::kBPW; ++i) {
      const int tb = w * Cfg::kBPW + i;
      double* e = dst + (8 * tri_row(tb, Cfg::kNB) + c) * C +
                  8 * tri_col(tb, Cfg::kNB) + 2 * s;
      put(e, d[i][0], first);
      put(e + 1, d[i][1], first);
      d[i][0] = d[i][1] = 0.0;
    }
#pragma unroll
    for (int j = 0; j < Cfg::kSPW; ++j) {
      double v = sum[j];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (s == 0) put(dst + C * C + 8 * (w * Cfg::kSPW + j) + c, v, first);
      sum[j] = 0.0;
    }
    if (t == 0) put(dst + C * C + C, (double)cnt, first);
    cnt = 0;
  };

  bool have = false;
  int run = 0, slot = -1;
  auto enter = [&](int L) {  // a row of label L follows the run
    if (have && L == run) return;
    if (have && slot >= 0) flush(slot);
    have = true;
    run = L;
    slot = -1;
    for (int k = 0; k < K; ++k)
      if (lab[k] == L) {
        slot = k;
        break;
      }
  };

  tiles.load(row0, t);
  for (long long r0 = row0; r0 < tiles.end; r0 += kRgRows) {
    group_sync<G>(g);  // the last tile is read
    tiles.stage(r0, t, xs, ml);
    if (r0 + kRgRows < tiles.end) tiles.load(r0 + kRgRows, t);
    group_sync<G>(g);
    const int rows =
        (int)(tiles.end - r0 < kRgRows ? tiles.end - r0 : kRgRows);
    for (int r = 0; r < rows; r += 4) {
      const int4 q4 = *reinterpret_cast<const int4*>(ml + r);
      const int l[4] = {q4.x, q4.y, q4.z, q4.w};
      const unsigned live = rows - r >= 4 ? 0xfu : (1u << (rows - r)) - 1u;
      const double* xr = xs + (r + s) * S;
      if (live == 0xfu && have && l[0] == run && l[1] == run &&
          l[2] == run && l[3] == run) {
        if (slot >= 0) {
          accumulate(xr, true);
          cnt += 4;
        }
        continue;
      }
      // a quad across runs: each label's samples in turn, in row order
      unsigned todo = live;
      while (todo) {
        const int f = __ffs(todo) - 1;
        const int L = f == 0 ? l[0] : f == 1 ? l[1] : f == 2 ? l[2] : l[3];
        unsigned mine = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (((todo >> q) & 1u) && l[q] == L) mine |= 1u << q;
        todo &= ~mine;
        enter(L);
        if (slot >= 0) {
          accumulate(xr, (mine >> s) & 1u);
          cnt += __popc(mine);
        }
      }
    }
  }
  if (have && slot >= 0) flush(slot);
  group_sync<G>(g);
  unsigned char* flags = touched_out + ((long long)b * P + chunk) * K;
  for (int k = t; k < K; k += G) flags[k] = touched[k];
}

// out (B, K, E): slot k of frame b is the sum, in chunk order, of the
// chunk partials of the first slot that holds k's label, the Gram mirrored
// from its upper triangle. Block (k, b, z) adds entries [256 z, 256 z +
// 256) over the chunks it lists first: those whose flag says they met the
// slot.
__global__ void __launch_bounds__(256)
    region_reduce_kernel(const double* __restrict__ partial,
                         const unsigned char* __restrict__ touched,
                         const int* __restrict__ labels, int label_stride,
                         double* __restrict__ out, int K, int P, int C) {
  extern __shared__ int rg_list[];  // [P] chunk indices
  __shared__ int warp_n[8];
  const int k = blockIdx.x, b = blockIdx.y, E = C * C + C + 1;
  const int* lab = labels + (long long)b * label_stride;
  int c = k;
  for (int j = 0; j < k; ++j)
    if (lab[j] == lab[k]) {
      c = j;
      break;
    }
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int n = 0;
  for (int p0 = 0; p0 < P; p0 += 256) {
    const int pc = p0 + threadIdx.x;
    const bool f = pc < P && touched[((long long)b * P + pc) * K + c];
    const unsigned bal = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[w] = __popc(bal);
    __syncthreads();
    int off = n, total = 0;
    for (int i = 0; i < 8; ++i) {
      off += i < w ? warp_n[i] : 0;
      total += warp_n[i];
    }
    if (f) rg_list[off + __popc(bal & ((1u << lane) - 1u))] = pc;
    n += total;
    __syncthreads();
  }
  const int e = blockIdx.z * 256 + threadIdx.x;
  if (e >= E) return;
  int src = e;
  if (e < C * C && e / C > e % C) src = (e % C) * C + e / C;
  double a = 0.0;
  for (int i = 0; i < n; ++i)
    a += partial[(((long long)b * P + rg_list[i]) * K + c) * E + src];
  out[((long long)b * K + k) * E + e] = a;
}

template <int C> struct ApplyCfg {
  static constexpr int kGroups = 256 / C;  // a group of C threads a chunk
  static constexpr int kThreads = 256;
};

template <int C> constexpr int apply_smem(int K) {
  using Cfg = ApplyCfg<C>;
  return Cfg::kGroups * kRgRows * C * 4 + Cfg::kGroups * kRgRows * 4 +
         K * 4 + (K + 15) / 16 * 16;
}

template <int C, typename T>
__global__ void __launch_bounds__(256)
    region_apply_kernel(const T* __restrict__ x, const int* __restrict__ m,
                        const int* __restrict__ labels, int label_stride,
                        const T* __restrict__ ts, const float* __restrict__ bs,
                        const unsigned char* __restrict__ valid,
                        T* __restrict__ out, long long N, int K, int P,
                        int R) {
  using Cfg = ApplyCfg<C>;
  extern __shared__ __align__(16) unsigned char rg_smem[];
  float* xs_all = reinterpret_cast<float*>(rg_smem);
  int* ml_all = reinterpret_cast<int*>(xs_all + Cfg::kGroups * kRgRows * C);
  int* lab = ml_all + Cfg::kGroups * kRgRows;
  unsigned char* ok = reinterpret_cast<unsigned char*>(lab + K);

  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    lab[k] = labels[(long long)b * label_stride + k];
    ok[k] = valid[(long long)b * K + k];
  }
  __syncthreads();
  const int g = threadIdx.x / C, p = threadIdx.x % C;
  const int chunk = blockIdx.x * Cfg::kGroups + g;
  if (chunk >= P) return;

  float* xs = xs_all + g * kRgRows * C;
  int* ml = ml_all + g * kRgRows;
  const long long row0 = (long long)chunk * R;
  RowTiles<T, float, C, C, C> tiles{x + (long long)b * N * C,
                                    m + (long long)b * N,
                                    row0 + R < N ? row0 + R : N};
  T* ob = out + (long long)b * N * C;
  constexpr int V = Lanes<T>::n;
  float tr[C];
  float bp = 0.0f;
  bool have = false;
  int run = 0, slot = -1;
  tiles.load(row0, p);
  for (long long r0 = row0; r0 < tiles.end; r0 += kRgRows) {
    group_sync<C>(g);
    tiles.stage(r0, p, xs, ml);
    if (r0 + kRgRows < tiles.end) tiles.load(r0 + kRgRows, p);
    group_sync<C>(g);
    const int rows =
        (int)(tiles.end - r0 < kRgRows ? tiles.end - r0 : kRgRows);
    for (int r = 0; r < rows; ++r) {
      const int L = ml[r];
      if (!have || L != run) {
        have = true;
        run = L;
        slot = -1;
        for (int k = 0; k < K; ++k)
          if (lab[k] == L && ok[k]) {
            slot = k;
            break;
          }
        if (slot >= 0) {  // row p of the slot's T, widened
          const long long tb = (long long)b * K + slot;
          const uint4* row =
              reinterpret_cast<const uint4*>(ts + (tb * C + p) * C);
#pragma unroll
          for (int q = 0; q < C / V; ++q)
            widen16<T>(__ldg(row + q), tr + q * V);
          bp = __ldg(bs + tb * C + p);
        }
      }
      const float* xr = xs + r * C;
      float y;
      if (slot < 0) {
        y = xr[p];
      } else {
        float a = 0.0f;
#pragma unroll
        for (int q = 0; q < C; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + q);
          a = fmaf(tr[q], v.x, a);
          a = fmaf(tr[q + 1], v.y, a);
          a = fmaf(tr[q + 2], v.z, a);
          a = fmaf(tr[q + 3], v.w, a);
        }
        y = a + bp;
      }
      ob[(r0 + r) * C + p] = from_f<T>(y);
    }
  }
}

template <int C, typename T>
int launch_moments(const void* x, const void* m, const void* labels,
                   int label_stride, void* partial, void* touched, void* out,
                   int B, long long N, int K, int P, int R,
                   cudaStream_t s) {
  using Cfg = MomentsCfg<C>;
  const int smem = moments_smem<C>(K);
  cudaError_t err = cudaFuncSetAttribute(
      region_moments_kernel<C, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + Cfg::kGroups - 1) / Cfg::kGroups, B);
  region_moments_kernel<C, T><<<grid, Cfg::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(m),
      static_cast<const int*>(labels), label_stride,
      static_cast<double*>(partial), static_cast<unsigned char*>(touched), N,
      K, P, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  region_reduce_kernel<<<dim3(K, B, (Cfg::kE + 255) / 256), 256,
                         P * (int)sizeof(int), s>>>(
      static_cast<const double*>(partial),
      static_cast<const unsigned char*>(touched),
      static_cast<const int*>(labels), label_stride,
      static_cast<double*>(out), K, P, C);
  return (int)cudaGetLastError();
}

template <int C, typename T>
int launch_apply(const void* x, const void* m, const void* labels,
                 int label_stride, const void* ts, const void* bs,
                 const void* valid, void* out, int B, long long N, int K,
                 int P, int R, cudaStream_t s) {
  using Cfg = ApplyCfg<C>;
  const int smem = apply_smem<C>(K);
  cudaError_t err = cudaFuncSetAttribute(
      region_apply_kernel<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + Cfg::kGroups - 1) / Cfg::kGroups, B);
  region_apply_kernel<C, T><<<grid, Cfg::kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const int*>(m),
      static_cast<const int*>(labels), label_stride,
      static_cast<const T*>(ts), static_cast<const float*>(bs),
      static_cast<const unsigned char*>(valid), static_cast<T*>(out), N, K, P,
      R);
  return (int)cudaGetLastError();
}

bool region_args_ok(int B, long long N, int K, int P, int R) {
  // P chunk indices fit the reduction's 48 KB of shared memory
  return B >= 1 && B <= 65535 && N >= 1 && K >= 1 && K <= 65535 && P >= 1 &&
         P <= 12288 && R >= 1 && R % kRgRows == 0 &&
         (long long)P * R >= N && (long long)(P - 1) * R < N;
}

}  // namespace vst

// x (B, N, C) contiguous, 16-byte aligned; partial: B*P*K*(C*C+C+1)
// float64 and touched: B*P*K bytes of scratch, neither initialised; out
// (B, K, C*C+C+1) float64: per slot the Gram, the sums, the count. P
// chunks of R rows a frame, R a multiple of 32.
extern "C" int vst_region_moments(const void* x, const void* m,
                                  const void* labels, int label_stride,
                                  void* partial, void* touched, void* out,
                                  int B, long long N, int C, int K, int P,
                                  int R, int is_bf16, void* stream) {
  using namespace vst;
  if (!region_args_ok(B, N, K, P, R)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // report only what this launch does
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return is_bf16 ? launch_moments<32, __nv_bfloat16>(
                         x, m, labels, label_stride, partial, touched, out, B,
                         N, K, P, R, s)
                   : launch_moments<32, float>(x, m, labels, label_stride,
                                               partial, touched, out, B, N, K,
                                               P, R, s);
  if (C == 128)
    return is_bf16 ? launch_moments<128, __nv_bfloat16>(
                         x, m, labels, label_stride, partial, touched, out, B,
                         N, K, P, R, s)
                   : launch_moments<128, float>(x, m, labels, label_stride,
                                                partial, touched, out, B, N,
                                                K, P, R, s);
  return (int)cudaErrorInvalidValue;
}

// x, out (B, N, C) contiguous, 16-byte aligned; ts (B, K, C, C), bs
// (B, K, C) float32; valid (B, K) bytes. P chunks of R rows a frame.
extern "C" int vst_region_apply(const void* x, const void* m,
                                const void* labels, int label_stride,
                                const void* ts, const void* bs,
                                const void* valid, void* out, int B,
                                long long N, int C, int K, int P, int R,
                                int is_bf16, void* stream) {
  using namespace vst;
  if (!region_args_ok(B, N, K, P, R)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 32)
    return is_bf16 ? launch_apply<32, __nv_bfloat16>(x, m, labels,
                                                     label_stride, ts, bs,
                                                     valid, out, B, N, K, P,
                                                     R, s)
                   : launch_apply<32, float>(x, m, labels, label_stride, ts,
                                             bs, valid, out, B, N, K, P, R,
                                             s);
  if (C == 128)
    return is_bf16 ? launch_apply<128, __nv_bfloat16>(x, m, labels,
                                                      label_stride, ts, bs,
                                                      valid, out, B, N, K, P,
                                                      R, s)
                   : launch_apply<128, float>(x, m, labels, label_stride, ts,
                                              bs, valid, out, B, N, K, P, R,
                                              s);
  return (int)cudaErrorInvalidValue;
}
