// K4: attention for SegFormer's spatial-reduction attention, on the tensor
// cores.
//
// Replaces the TPU kernel vstnet_tpu/ops/attention.py: sr_attention_flash
// (kernel body _attn_kernel). Per batch b and head h it computes
//   o = softmax(q k^T * scale) v        q (N, D), k and v (M, D), D = 64
// with the TPU kernel's dtype chain: bf16 inputs, scores in float32, the
// row max, exp and the normalisation by the row sum in float32, the
// probabilities rounded to bf16 and only then multiplied by v with float32
// sums, one rounding to bf16 at the output. The online-softmax form would
// normalise after P.V and move the bf16 rounding point, so it is not used
// as it stands.
//
// What bounds it on an H100 (4*N*M*D FLOP per (b, h); q read and o written
// once, k and v read once: 4*(N + M)*D bytes in bf16, so N*M/(N+M) FLOP/B):
//   N=16384, M=256  (512x512 frames, stage 1)     252 FLOP/B
//   N=65536, M=1024 (1024x1024 frames, stage 1)  1008 FLOP/B
//   N=16384, M=1024 (1024x1024 frames, stage 2)   964 FLOP/B
// On the tensor cores (989 TFLOP/s bf16, ridge near 295 FLOP/B) the first
// is bound by bytes and the other two by operations.
//
// The design: two passes over K, so that no score tile is ever stored and
// M has no limit. One block of 4 warps owns 128 query rows of one (b, h),
// 32 rows a warp; the warp's Q fragments stay in registers. K (and in pass
// 2 V) tiles of 64 keys arrive by cp.async in a ring of three bf16 stages,
// swizzled so that ldmatrix is free of bank conflicts. Pass 1 computes
// S = scale * Q K^T with mma.sync (bf16 in, float32 out) and keeps each
// row's running max and sum of exp (the online recurrence, on the scores
// only). Pass 2 recomputes the same S by the same instructions, forms
// p = exp(s - max) / sum in float32, rounds it to bf16 in registers (the C
// fragment of one product is the A fragment of the next) and accumulates
// O += P V with mma.sync, V read through ldmatrix.trans. That is 1.5 times
// the operations of one pass; the path's shape is bound by bytes. Rows
// past N are computed on a clamped row and not stored; keys past M get a
// score of -inf, so they enter neither the max nor the sum, and their V
// rows are zero-filled. q, k, v and o are addressed by (batch, head, row)
// strides, so the (B, N, heads, D) views of the model are read in place.
// The output tile goes through shared memory so that rows leave as
// 16-byte stores.
#include "mma.cuh"

namespace vst {

constexpr int kAtD = 64;              // head dim
constexpr int kAtWarps = 4;
constexpr int kAtThreads = kAtWarps * 32;
constexpr int kAtWM = 32;             // query rows per warp (2 m-tiles)
constexpr int kAtBM = kAtWarps * kAtWM;
constexpr int kAtBK = 64;             // keys per stage
constexpr int kAtSub = 32;            // keys per register tile of scores
constexpr int kAtStages = 3;
constexpr int kAtRowBytes = kAtD * 2;
constexpr int kAtTileBytes = kAtBK * kAtRowBytes;
constexpr int kAtSmem = kAtBM * kAtRowBytes + kAtStages * 2 * kAtTileBytes;

struct AtStride {
  long long b, h, n;                  // in elements; the D axis has stride 1
};

// rows [r0, r0 + rows) of a (count, 64) bf16 matrix -> swizzled tile;
// rows at or past `count` are zero-filled
__device__ __forceinline__ void at_load_tile(uint32_t tile,
                                             const __nv_bfloat16* g,
                                             long long stride, int r0,
                                             int rows, int count, int tid) {
  for (int i = tid; i < rows * 8; i += kAtThreads) {
    const int row = i >> 3, chunk = i & 7;
    const int src = r0 + row;
    const bool ok = src < count;
    cp_async16(tile + swz<kAtRowBytes>(row, chunk),
               g + (long long)(ok ? src : count - 1) * stride + chunk * 8,
               ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kAtThreads)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int H, int N, int M,
                     float scale, AtStride qs, AtStride ks, AtStride vs,
                     AtStride os) {
  extern __shared__ __align__(128) unsigned char at_smem[];
  const uint32_t q_tile = smem_u32(at_smem);
  const uint32_t ring = q_tile + kAtBM * kAtRowBytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * kAtBM;
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  __nv_bfloat16* og = o + b * os.b + h * os.h;

  const int tiles = (M + kAtBK - 1) / kAtBK;
  const int jobs = 2 * tiles;         // pass 1 then pass 2 over the K tiles

  auto fetch = [&](int j) {
    if (j < jobs) {
      const int tile = j % tiles;
      const uint32_t st = ring + (j % kAtStages) * 2 * kAtTileBytes;
      at_load_tile(st, kg, ks.n, tile * kAtBK, kAtBK, M, tid);
      if (j >= tiles)
        at_load_tile(st + kAtTileBytes, vg, vs.n, tile * kAtBK, kAtBK, M,
                     tid);
    }
    cp_async_commit();
  };

  // Q rows past N read row N - 1 (never stored)
  for (int i = tid; i < kAtBM * 8; i += kAtThreads) {
    const int row = i >> 3, chunk = i & 7;
    cp_async16(q_tile + swz<kAtRowBytes>(row, chunk),
               qg + (long long)min(n0 + row, N - 1) * qs.n + chunk * 8);
  }
  fetch(0);
  fetch(1);
  cp_async_wait<1>();
  __syncthreads();

  // the warp's Q fragments: 2 m-tiles x 4 k-steps of 16
  uint32_t qf[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int row = warp * kAtWM + mt * 16 + (lane & 15);
      ldsm_x4(qf[mt][kk],
              q_tile + swz<kAtRowBytes>(row, kk * 2 + (lane >> 4)));
    }

  float mx[2][2], sum[2][2];          // per m-tile, rows g and g + 8
  float acc[2][8][4];                 // O: 2 m-tiles x 8 n-tiles of D
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    mx[mt][0] = mx[mt][1] = -INFINITY;
    sum[mt][0] = sum[mt][1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
  }

  for (int j = 0; j < jobs; ++j) {
    cp_async_wait<kAtStages - 2>();
    __syncthreads();                  // job j landed; job j - 1 is done with
    fetch(j + kAtStages - 1);         // the stage this refills
    const bool pass2 = j >= tiles;
    const int k0 = (j % tiles) * kAtBK;
    const uint32_t k_tile = ring + (j % kAtStages) * 2 * kAtTileBytes;
    const uint32_t v_tile = k_tile + kAtTileBytes;

    if (j == tiles) {
      // between the passes: the row sums over the quad, then their inverse
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float s = sum[mt][hf];
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          sum[mt][hf] = 1.f / s;
        }
    }

#pragma unroll
    for (int sub = 0; sub < kAtBK / kAtSub; ++sub) {
      const int key0 = k0 + sub * kAtSub;
      if (key0 >= M) break;
      // S = scale * Q K^T on 32 rows x 32 keys
      float s[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][nt][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bk[4];
          const int row = sub * kAtSub + np * 16 + (lane & 7) +
                          ((lane >> 4) << 3);
          ldsm_x4(bk, k_tile + swz<kAtRowBytes>(
                                   row, kk * 2 + ((lane >> 3) & 1)));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt][kk], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt][kk], bk[2], bk[3]);
          }
        }
      const bool ragged = key0 + kAtSub > M;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = key0 + nt * 8 + 2 * t + (c & 1);
            s[mt][nt][c] = (ragged && key >= M) ? -INFINITY
                                                : s[mt][nt][c] * scale;
          }

      if (!pass2) {
        // running max and sum of exp of each row; the max is shared by
        // the quad that holds the row, the sum stays per thread
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float m = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              m = fmaxf(m, fmaxf(s[mt][nt][2 * hf], s[mt][nt][2 * hf + 1]));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            m = fmaxf(m, mx[mt][hf]);
            float part = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              part += __expf(s[mt][nt][2 * hf] - m) +
                      __expf(s[mt][nt][2 * hf + 1] - m);
            sum[mt][hf] = sum[mt][hf] * __expf(mx[mt][hf] - m) + part;
            mx[mt][hf] = m;
          }
      } else {
        // p = exp(s - max) / sum, rounded to bf16, then O += P V
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t pa[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int nt = 2 * kk + (r >> 1), hf = r & 1;
              pa[mt][r] = pack_bf16(
                  __expf(s[mt][nt][2 * hf] - mx[mt][hf]) * sum[mt][hf],
                  __expf(s[mt][nt][2 * hf + 1] - mx[mt][hf]) * sum[mt][hf]);
            }
#pragma unroll
          for (int dp = 0; dp < 4; ++dp) {
            uint32_t bv[4];
            const int row = sub * kAtSub + kk * 16 + (lane & 15);
            ldsm_x4_trans(bv, v_tile + swz<kAtRowBytes>(
                                           row, dp * 2 + (lane >> 4)));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
              mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the warp's 32 x 64 output through its own rows of the Q tile
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = warp * kAtWM + mt * 16 + g + 8 * hf;
        *reinterpret_cast<uint32_t*>(at_smem + swz<kAtRowBytes>(row, nt) +
                                     t * 4) =
            pack_bf16(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
      }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < kAtWM * 8 / 32; ++it) {
    const int idx = it * 32 + lane;
    const int row = warp * kAtWM + (idx >> 3), chunk = idx & 7;
    if (n0 + row < N)
      *reinterpret_cast<uint4*>(og + (long long)(n0 + row) * os.n +
                                chunk * 8) =
          *reinterpret_cast<const uint4*>(at_smem +
                                          swz<kAtRowBytes>(row, chunk));
  }
}

}  // namespace vst

// q, o: (B, H, N, 64) addressed by element strides (b, h, n); k, v:
// (B, H, M, 64) likewise. Every stride and base pointer must keep rows
// 16-byte aligned (multiples of 8 elements); the wrapper checks.
extern "C" int vst_attention(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int N, int M, int D,
                             float scale, long long qsb, long long qsh,
                             long long qsn, long long ksb, long long ksh,
                             long long ksn, long long vsb, long long vsh,
                             long long vsn, long long osb, long long osh,
                             long long osn, void* stream) {
  using namespace vst;
  if (D != kAtD || B < 1 || H < 1 || N < 1 || M < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAtSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kAtBM - 1) / kAtBM, B * H);
  attention_kernel<<<grid, kAtThreads, kAtSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      N, M, scale, AtStride{qsb, qsh, qsn}, AtStride{ksb, ksh, ksn},
      AtStride{vsb, vsh, vsn}, AtStride{osb, osh, osn});
  return (int)cudaGetLastError();
}
