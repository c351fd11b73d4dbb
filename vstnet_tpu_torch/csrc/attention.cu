// K4: single-pass attention for SegFormer's spatial-reduction attention.
//
// Replaces the TPU kernel vstnet_tpu/ops/attention.py: sr_attention_flash
// (kernel body _attn_kernel). Per batch b and head h it computes
//   o = softmax(q k^T * scale) v        q (N, D), k and v (M, D), D = 64
// with the TPU kernel's dtype chain: bf16 inputs, scores in float32, the
// row max, exp and the division by the row sum in float32, the
// probabilities rounded to bf16 and only then multiplied by v with float32
// sums, one rounding to bf16 at the output. The softmax is NOT the online
// form: that would normalise after P.V and move the bf16 rounding point.
//
// What bounds it on an H100 (4*N*M*D FLOP per (b, h); q read and o written
// once, k and v read once: 4*(N + M)*D bytes in bf16, so N*M/(N+M) FLOP/B):
//   N=16384, M=256  (512x512 frames, stage 1)     252 FLOP/B
//   N=65536, M=1024 (1024x1024 frames, stage 1)  1008 FLOP/B
//   N=16384, M=1024 (1024x1024 frames, stage 2)   964 FLOP/B
// On the tensor cores (989 TFLOP/s bf16, ridge near 295 FLOP/B) the first
// is bound by bytes and the other two by operations. This simple design
// runs on the CUDA cores (float32 FMA, ridge near 20 FLOP/B) and is bound
// by FMA rate and shared-memory loads at every shape; tensor cores
// (mma.sync / wgmma on the bf16 operands) are later work.
//
// The simple design: one block of 256 threads owns TN query rows of one
// (b, h). The float32 score rows of the tile stay in shared memory for the
// whole block, so TN is sized from M (128 KB of scores: 64 rows up to
// M = 512, 32 at M = 1024, ..., 4 at M = 8192). K and then V do not fit
// beside them, so both stream through one shared buffer in chunks of KC
// keys. Phase 1: S = scale * Q K^T, each thread a 4x4 register tile, K
// chunk transposed to [d][key] so both operands are 16-byte shared loads.
// Phase 2: one warp per row does max, exp, sum, divide and the bf16
// rounding in place. Phase 3: O = P V, each thread 4 rows x 4 columns of
// D, accumulators in registers across the V chunks. Rows past N are
// computed on zeros and not stored; keys past M are zeros in the staged
// chunk and are left out of the softmax. q, k, v and o are addressed by
// (batch, head, row) strides, so the (B, N, heads, D) views of the model
// are read in place and no (G, N, D) copy is made.
#include "common.cuh"

namespace vst {

constexpr int kAtD = 64;              // head dim
constexpr int kAtThreads = 256;
constexpr int kAtMaxTN = 64;          // query rows per block, at most
constexpr int kAtScoreBytes = 128 * 1024;
constexpr int kAtMaxKC = 256;         // keys per staged chunk, at most

struct AtStride {
  long long b, h, n;                  // in elements; the D axis has stride 1
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(p[j]);
    f[2 * j] = v.x;
    f[2 * j + 1] = v.y;
  }
}

__global__ void __launch_bounds__(kAtThreads)
    attention_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int H, int N, int M,
                     int Mp, int TN, int KC, float scale, AtStride qs,
                     AtStride ks, AtStride vs, AtStride os) {
  extern __shared__ __align__(16) float at_smem[];
  float* S = at_smem;                 // [TN][Mp] scores, then probabilities
  float* Qs = S + TN * Mp;            // [D][TN]
  float* KV = Qs + kAtD * TN;         // K chunk [D][KC], then V chunk [KC][D]

  const int tid = threadIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int n0 = blockIdx.x * TN;
  const __nv_bfloat16* qg = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kg = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vg = v + b * vs.b + h * vs.h;
  __nv_bfloat16* og = o + b * os.b + h * os.h;

  // Q tile, widened and transposed to [d][row]; rows past N are zeros
  for (int i = tid; i < TN * (kAtD / 8); i += kAtThreads) {
    const int row = i / (kAtD / 8), dg = i % (kAtD / 8);
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n0 + row < N)
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  qg + (long long)(n0 + row) * qs.n + dg * 8)), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) Qs[(dg * 8 + j) * TN + row] = f[j];
  }

  // Phase 1: S = scale * Q K^T over chunks of KC keys
  const int kq = KC / 4;
  const int items1 = (TN / 4) * kq;
  for (int kc0 = 0; kc0 < M; kc0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * (kAtD / 8); i += kAtThreads) {
      const int key = i % KC, dg = i / KC;
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (kc0 + key < M)
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    kg + (long long)(kc0 + key) * ks.n + dg * 8)), f);
#pragma unroll
      for (int j = 0; j < 8; ++j) KV[(dg * 8 + j) * KC + key] = f[j];
    }
    __syncthreads();
    for (int it = tid; it < items1; it += kAtThreads) {
      const int ty = it / kq, tx = it % kq;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < kAtD; ++d) {
        const float4 qv =
            *reinterpret_cast<const float4*>(Qs + d * TN + ty * 4);
        const float4 kv =
            *reinterpret_cast<const float4*>(KV + d * KC + tx * 4);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(qa[r], ka[c], acc[r][c]);
      }
      const int key0 = kc0 + tx * 4;
      if (key0 < Mp) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(S + (ty * 4 + r) * Mp + key0) =
              make_float4(acc[r][0] * scale, acc[r][1] * scale,
                          acc[r][2] * scale, acc[r][3] * scale);
      }
    }
  }
  __syncthreads();

  // Phase 2: softmax of each row over its M keys, in float32, then the
  // probabilities rounded to bf16 (held as float32 values)
  const int warp = tid / 32, lane = tid % 32;
  for (int row = warp; row < TN; row += kAtThreads / 32) {
    float* sr = S + row * Mp;
    float mx = -INFINITY;
    for (int m = lane; m < M; m += 32) mx = fmaxf(mx, sr[m]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) {
      const float e = expf(sr[m] - mx);
      sr[m] = e;
      sum += e;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, s);
    for (int m = lane; m < M; m += 32)
      sr[m] = round_as<__nv_bfloat16>(sr[m] / sum);
  }

  // Phase 3: O = P V over chunks of KC keys; one 4x4 tile of O per thread
  const bool active = tid < (TN / 4) * (kAtD / 4);
  const int ty = tid / (kAtD / 4), tx = tid % (kAtD / 4);
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int vc0 = 0; vc0 < M; vc0 += KC) {
    __syncthreads();
    for (int i = tid; i < KC * (kAtD / 8); i += kAtThreads) {
      const int key = i / (kAtD / 8), dg = i % (kAtD / 8);
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (vc0 + key < M)
        unpack8(__ldg(reinterpret_cast<const uint4*>(
                    vg + (long long)(vc0 + key) * vs.n + dg * 8)), f);
      float4* dst = reinterpret_cast<float4*>(KV + key * kAtD + dg * 8);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();
    if (active) {
      // keys in [M, Mp) hold zero scores and zero V rows
      const int cnt = min(KC, Mp - vc0);
      for (int m = 0; m < cnt; m += 4) {
        float pa[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 pv = *reinterpret_cast<const float4*>(
              S + (ty * 4 + r) * Mp + vc0 + m);
          pa[r][0] = pv.x; pa[r][1] = pv.y; pa[r][2] = pv.z; pa[r][3] = pv.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              KV + (m + j) * kAtD + tx * 4);
          const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = fmaf(pa[r][j], va[c], acc[r][c]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = n0 + ty * 4 + r;
      if (row >= N) continue;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
      uint2 packed;
      packed.x = *reinterpret_cast<const unsigned int*>(&lo);
      packed.y = *reinterpret_cast<const unsigned int*>(&hi);
      *reinterpret_cast<uint2*>(og + (long long)row * os.n + tx * 4) = packed;
    }
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
  const int Mp = (M + 3) & ~3;
  int TN = kAtMaxTN;
  while (TN > 4 && (size_t)TN * Mp * sizeof(float) > kAtScoreBytes) TN /= 2;
  if ((size_t)TN * Mp * sizeof(float) > kAtScoreBytes)
    return (int)cudaErrorInvalidValue;
  const int KC = min(kAtMaxKC, kAtMaxTN * 64 / TN);
  const size_t smem =
      sizeof(float) * ((size_t)TN * Mp + (size_t)kAtD * TN + (size_t)KC * kAtD);
  cudaGetLastError();  // report only what this launch does
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TN - 1) / TN, B * H);
  attention_kernel<<<grid, kAtThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H,
      N, M, Mp, TN, KC, scale, AtStride{qsb, qsh, qsn},
      AtStride{ksb, ksh, ksn}, AtStride{vsb, vsh, vsn},
      AtStride{osb, osh, osn});
  return (int)cudaGetLastError();
}
