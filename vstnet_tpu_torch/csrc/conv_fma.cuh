// The CUDA-core 3x3 convs of the coupling (K1, coupling.cu) and transition
// (K2/K3, transition.cu) kernels: an implicit GEMM (output positions x
// output channels, K = input channels x 9) on float32 FMAs, operands from
// shared memory.
//
// One conv of a block runs in rounds of NT work items, one item a thread.
// An item is a register tile of R x S output positions (R rows of S
// neighbouring columns) by Q output channels. Its input rows are loaded
// once per (ci, ky) and slid over the three kx taps; the Q weights of a
// tap are float4 loads. A warp's lanes take 8 blocks of positions x 4
// channel groups (lane_groups), so that its loads hit distinct banks or
// broadcast. K is walked in chunks of kc input channels: each chunk's
// weights (and, for conv1, its planes of the input window) are copied into
// one of two shared-memory buffers with cp.async while the other chunk is
// summed, and the sums stay in registers across all chunks. Results leave
// a tile row of S at a time, the values beside them (the add stream) all
// loaded first, float4 where a float32 row is aligned.
//
// Sum order: every output sums ci, then ky, then kx, one fmaf each, from
// 0.f, in one chain; the bias comes after. Tiling only regroups outputs, so
// the kernels equal their plain versions (ops/coupling_fused.py) and the
// inverse recomputes F bit for bit.
//
// Per-conv reflection: every position of a ring is computed at its own
// coordinates (taps reflected only where they read the staged input), then
// `fill_reflect` overwrites the ring positions that lie outside the image
// with the value at their reflected position: ReflectionPad2d(1) of h1 and
// h2 themselves.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace vst {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One staged element of a T input: float32 by cp.async, bf16 widened by a
// plain load (cp.async moves at least 4 bytes).
template <typename T>
__device__ __forceinline__ void stage_elem(float* dst, const T* src);
template <>
__device__ __forceinline__ void stage_elem<float>(float* dst,
                                                  const float* src) {
  cp_async4(dst, src);
}
template <>
__device__ __forceinline__ void stage_elem<__nv_bfloat16>(
    float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// A read-only global value widened to float (ld.global.nc).
template <typename T>
__device__ __forceinline__ float ldg_f(const T* p) {
  return to_f<T>(__ldg(p));
}

// The first n (<= S) of S neighbouring values at p, widened to float;
// float4 loads where a whole float32 row is 16-byte aligned.
template <typename T, int S>
__device__ __forceinline__ void load_row(const T* p, int n, float (&v)[S]) {
  if constexpr (std::is_same<T, float>::value && S % 4 == 0) {
    if (n == S && (reinterpret_cast<size_t>(p) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < S / 4; ++k) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p) + k);
        v[4 * k] = t.x;
        v[4 * k + 1] = t.y;
        v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) v[s] = s < n ? ldg_f<T>(p + s) : 0.f;
}

// v's first n (<= S) values rounded to T into S neighbouring places at p;
// float4 stores where a whole float32 row is 16-byte aligned.
template <typename T, int S>
__device__ __forceinline__ void store_row(T* p, int n, const float (&v)[S]) {
  if constexpr (std::is_same<T, float>::value && S % 4 == 0) {
    if (n == S && (reinterpret_cast<size_t>(p) & 15) == 0) {
#pragma unroll
      for (int k = 0; k < S / 4; ++k)
        reinterpret_cast<float4*>(p)[k] =
            make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      return;
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < n) p[s] = from_f<T>(v[s]);
}

// S, the row length of a tile row passed to a load or an emit.
template <class A>
__host__ __device__ constexpr int row_len() {
  return std::extent<std::remove_reference_t<A>>::value;
}

// The load of a conv whose emit needs no value beside its sums.
struct NoLoad {
  template <int S>
  __device__ void operator()(int, int, int, float (&v)[S]) const {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = 0.f;
  }
};

// Staging and staged-chunk hooks of a conv whose input lies in shared
// memory already, or that reads nothing more of its staged chunks.
struct NoStage {
  __device__ void operator()(float*, int, int) const {}
  __device__ void operator()(const float*, int, int) const {}
};

template <int R_, int S_, int Q_>
struct Tile {
  static constexpr int R = R_, S = S_, Q = Q_;
};

// A conv's output ring: ROWS x COLS positions, read with stride ST from
// input planes of IN_PITCH floats a row and IN_PLANE floats a plane.
template <int ROWS_, int COLS_, int ST_, int IN_PITCH_, int IN_PLANE_>
struct Geom {
  static constexpr int ROWS = ROWS_, COLS = COLS_, ST = ST_;
  static constexpr int IN_PITCH = IN_PITCH_, IN_PLANE = IN_PLANE_;
};

// A kernel's configuration: threads, blocks an SM, the three convs'
// tiles, input channels a chunk of conv1 and of conv2/conv3.
template <int NT_, int MINB_, class T1_, class T2_, class T3_, int KC1_,
          int KC_>
struct FmaCfg {
  static constexpr int NT = NT_, MINB = MINB_, KC1 = KC1_, KC = KC_;
  using Tile1 = T1_;
  using Tile2 = T2_;
  using Tile3 = T3_;
};

// Blocks of positions a tile makes of a conv's ring.
template <class Tl, class G>
__host__ __device__ constexpr int tile_blocks() {
  return (G::ROWS / Tl::R) * (G::COLS / Tl::S);
}

// Output channels [lo, hi) that the items of the round starting at `base`
// touch, items being channel-group major (item = group * npb + block) in
// groups of q channels.
__host__ __device__ inline void round_channels(int base, int nt, int n_items,
                                               int npb, int q, int cout,
                                               int* lo, int* hi) {
  const int last = (base + nt < n_items ? base + nt : n_items) - 1;
  *lo = base / npb * q;
  const int h = (last / npb + 1) * q;
  *hi = h < cout ? h : cout;
}

// Channel groups that neighbouring lanes of a warp take at one block of
// positions: 4 where the groups divide by 4. A warp then reads 8 blocks'
// inputs (in distinct banks) and 4 groups' weights per load, where lanes
// all on positions would conflict on the banks.
__host__ __device__ inline int lane_groups(int ng) {
  return ng % 4 == 0 ? 4 : ng % 2 == 0 ? 2 : 1;
}

// The largest hi - lo over the rounds of a conv (npb blocks of positions,
// cout / q channel groups): the channels a staged weight chunk holds.
__host__ __device__ inline int max_round_channels(int nt, int npb, int q,
                                                  int cout) {
  const int lg = lane_groups(cout / q);
  const int n_items = npb * (cout / q);
  int most = 0;
  for (int base = 0; base < n_items; base += nt) {
    int lo, hi;
    round_channels(base, nt, n_items, npb * lg, q * lg, cout, &lo, &hi);
    most = hi - lo > most ? hi - lo : most;
  }
  return most;
}

// Sum one chunk of cn input channels into a thread's tile. `in` points at
// the tile's first input (row ST*R*pr, column ST*S*pc of plane 0); `w` at
// its first weight, [ci][9][nch] with the tile's channels at offset 0.
template <class Tl, class G>
__device__ __forceinline__ void conv_chunk(float (&acc)[Tl::R][Tl::S][Tl::Q],
                                           const float* in, const float* w,
                                           int nch, int cn) {
  constexpr int R = Tl::R, S = Tl::S, Q = Tl::Q, ST = G::ST;
  constexpr int NV = ST * (S - 1) + 3;  // input columns of one tile row
  static_assert(Q % 4 == 0, "Q must be a multiple of 4");
  // two channels in flight where the tile leaves the registers for it
  constexpr int UNROLL = R * S * Q <= 32 ? 2 : 1;
#pragma unroll UNROLL
  for (int ci = 0; ci < cn; ++ci) {
    const float* p = in + ci * G::IN_PLANE;
    const float* wc = w + ci * 9 * nch;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      if constexpr (R == 1) {
        float v[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) v[j] = p[ky * G::IN_PITCH + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[Q];
#pragma unroll
          for (int q4 = 0; q4 < Q / 4; ++q4) {
            const float4 t = *reinterpret_cast<const float4*>(
                wc + (ky * 3 + kx) * nch + 4 * q4);
            wv[4 * q4] = t.x;
            wv[4 * q4 + 1] = t.y;
            wv[4 * q4 + 2] = t.z;
            wv[4 * q4 + 3] = t.w;
          }
#pragma unroll
          for (int s = 0; s < S; ++s)
#pragma unroll
            for (int q = 0; q < Q; ++q)
              acc[0][s][q] = fmaf(v[ST * s + kx], wv[q], acc[0][s][q]);
        }
      } else {
        // the three taps' weights once, then one input row at a time
        float wv[3][Q];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int q4 = 0; q4 < Q / 4; ++q4) {
            const float4 t = *reinterpret_cast<const float4*>(
                wc + (ky * 3 + kx) * nch + 4 * q4);
            wv[kx][4 * q4] = t.x;
            wv[kx][4 * q4 + 1] = t.y;
            wv[kx][4 * q4 + 2] = t.z;
            wv[kx][4 * q4 + 3] = t.w;
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float v[NV];
#pragma unroll
          for (int j = 0; j < NV; ++j)
            v[j] = p[(ST * r + ky) * G::IN_PITCH + j];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int s = 0; s < S; ++s)
#pragma unroll
              for (int q = 0; q < Q; ++q)
                acc[r][s][q] = fmaf(v[ST * s + kx], wv[kx][q], acc[r][s][q]);
        }
      }
    }
  }
}

// One 3x3 conv of a block: cin input channels -> cout output channels on
// G's ring, in rounds of NT items.
//   wg        global weights [cin][9][cout] (float4-aligned);
//   in_smem   the input planes when they already lie in shared memory, or
//             nullptr: then `stage_in(dst, ci0, cn)` stages the chunk's cn
//             planes into dst (in_floats floats ahead of its weights);
//   buf[2]    the two chunk buffers;
//   staged(buf, ci0, cn) sees each staged input chunk, once it has landed
//   and before it is summed (all threads);
//   load(row, col0, ch, v) gives S values beside each tile row of S
//   results (columns col0 ...), all of a tile's loads issued before its
//   first emit (so that global loads of the add stream overlap instead of
//   waiting on the stores between them);
//   emit(row, col0, ch, sums, loaded) takes each tile row's S results.
template <int NT, class Tl, class G, class StageIn, class Staged,
          class Load, class Emit>
__device__ __forceinline__ void conv_fma(int cin, int cout, int kc,
                                         const float* __restrict__ wg,
                                         const float* in_smem, int in_floats,
                                         float* const (&buf)[2],
                                         StageIn stage_in, Staged staged,
                                         Load load, Emit emit) {
  constexpr int R = Tl::R, S = Tl::S, Q = Tl::Q, ST = G::ST;
  static_assert(G::ROWS % R == 0 && G::COLS % S == 0, "ring % tile");
  constexpr int NBC = G::COLS / S;
  constexpr int NPB = tile_blocks<Tl, G>();
  const int ng = cout / Q;
  const int lg = lane_groups(ng);
  const int n_items = NPB * ng;
  const int nchunks = (cin + kc - 1) / kc;
  const int tid = threadIdx.x;
  for (int base = 0; base < n_items; base += NT) {
    // item = (group / lg * NPB + block) * lg + group % lg
    const int item = base + tid;
    const bool active = item < n_items;
    const int it = active ? item : base;
    const int pb = it / lg % NPB;
    const int g = it / (lg * NPB) * lg + it % lg;
    const int pr = pb / NBC, pc = pb % NBC;
    int lo, hi;
    round_channels(base, NT, n_items, NPB * lg, Q * lg, cout, &lo, &hi);
    const int nch = hi - lo;
    const int nch4 = nch / 4;
    // this thread's first float4 of a weight chunk ([row][nch4]) and its
    // step, so that staging divides nothing
    const int row0 = tid / nch4, c40 = tid % nch4;
    const int drow = NT / nch4, dc4 = NT % nch4;

    auto stage = [&](int c, float* dst) {
      const int ci0 = c * kc, cn = min(kc, cin - ci0);
      if (!in_smem) stage_in(dst, ci0, cn);
      float* wd = dst + in_floats;
      const float* ws = wg + (size_t)ci0 * 9 * cout + lo;
      const int rows = cn * 9;
      for (int row = row0, c4 = c40; row < rows;) {
        cp_async16(wd + row * nch + 4 * c4, ws + (size_t)row * cout + 4 * c4);
        row += drow;
        c4 += dc4;
        if (c4 >= nch4) {
          c4 -= nch4;
          ++row;
        }
      }
      cp_async_commit();
    };

    float acc[R][S][Q];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[r][s][q] = 0.f;

    const int off = ST * R * pr * G::IN_PITCH + ST * S * pc;
    stage(0, buf[0]);
    for (int c = 0; c < nchunks; ++c) {
      if (c + 1 < nchunks) {
        stage(c + 1, buf[(c + 1) & 1]);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (!in_smem) staged(buf[c & 1], c * kc, min(kc, cin - c * kc));
      if (active) {
        const int ci0 = c * kc;
        const float* in = in_smem ? in_smem + ci0 * G::IN_PLANE + off
                                  : buf[c & 1] + off;
        conv_chunk<Tl, G>(acc, in, buf[c & 1] + in_floats + (g * Q - lo),
                          nch, min(kc, cin - ci0));
      }
      __syncthreads();
    }
    if (active) {
      float got[R][Q][S];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          load(R * pr + r, S * pc, Q * g + q, got[r][q]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float sums[S];
#pragma unroll
          for (int s = 0; s < S; ++s) sums[s] = acc[r][s][q];
          emit(R * pr + r, S * pc, Q * g + q, sums, got[r][q]);
        }
    }
  }
}

// Overwrite the positions of a ring (ch planes of rows x cols, pitch and
// plane in floats; ring row i is image row r0 + i, column j image column
// c0 + j) that lie on image row -1 or n_r (column -1 or n_c) with the
// value at row 1 or n_r - 2 (column 1 or n_c - 2): the ring of a conv with
// ReflectionPad2d(1). Rows first, then columns, so corners take the
// diagonal. Positions further out are never read. Called by every thread
// after a __syncthreads; ends with one where it wrote.
template <int NT>
__device__ __forceinline__ void fill_reflect(float* h, int ch, int rows,
                                             int cols, int pitch, int plane,
                                             int r0, int c0, int n_r,
                                             int n_c) {
  const int top = -1 - r0, bot = n_r - r0;
  const bool rt = top >= 0, rb = bot < rows;
  if (rt || rb) {
    for (int i = threadIdx.x; i < ch * cols; i += NT) {
      float* p = h + (i / cols) * plane + i % cols;
      if (rt) p[top * pitch] = p[(top + 2) * pitch];
      if (rb) p[bot * pitch] = p[(bot - 2) * pitch];
    }
    __syncthreads();
  }
  const int left = -1 - c0, right = n_c - c0;
  const bool cl = left >= 0, cr = right < cols;
  if (cl || cr) {
    for (int i = threadIdx.x; i < ch * rows; i += NT) {
      float* p = h + (i / rows) * plane + (i % rows) * pitch;
      if (cl) p[left] = p[left + 2];
      if (cr) p[right] = p[right - 2];
    }
    __syncthreads();
  }
}

// Shared-memory plan of one launch, in floats, made on the host: h1 and h2
// (conv2's and conv3's input planes), the conv1 chunk buffers (input
// window planes, then the chunk's weights) and the conv2/conv3 weight
// buffers. conv1's buffers lie in h2's place when they fit there (h2 is
// written only after conv1).
struct FmaPlan {
  int kc1, kc;         // input channels a chunk: conv1, conv2 and conv3
  int h2, s1, s2;      // offsets of h2, conv1's buffers, conv2/3's buffers
  int buf1, buf2;      // floats a buffer
  int in1;             // floats of input planes in a conv1 buffer
  int total;           // floats in all
};

inline int round4(int n) { return (n + 3) / 4 * 4; }

// The plan of a block cin -> m -> m -> cout under configuration K, its
// three convs on the geometries G1, G2, G3.
template <class K, class G1, class G2, class G3>
FmaPlan fma_plan(int cin, int m, int cout) {
  FmaPlan p;
  p.kc1 = std::min(K::KC1, cin);
  p.kc = std::min(K::KC, m);
  const int h1 = round4(m * G2::IN_PLANE), h2 = round4(m * G3::IN_PLANE);
  p.in1 = round4(p.kc1 * G1::IN_PLANE);
  p.buf1 = p.in1 + round4(p.kc1 * 9 * max_round_channels(
                                          K::NT,
                                          tile_blocks<typename K::Tile1, G1>(),
                                          K::Tile1::Q, m));
  const int n2 = std::max(
      max_round_channels(K::NT, tile_blocks<typename K::Tile2, G2>(),
                         K::Tile2::Q, m),
      max_round_channels(K::NT, tile_blocks<typename K::Tile3, G3>(),
                         K::Tile3::Q, cout));
  p.buf2 = round4(p.kc * 9 * n2);
  const int need1 = (cin > p.kc1 ? 2 : 1) * p.buf1;
  const int need2 = (m > p.kc ? 2 : 1) * p.buf2;
  p.h2 = h1;
  p.s2 = h1 + h2;
  p.s1 = need1 <= h2 ? p.h2 : p.s2;
  p.total = p.s2 + std::max(need2, p.s1 == p.s2 ? need1 : 0);
  return p;
}

}  // namespace vst
