// Asynchronous copies from global to shared memory, for the kernels that
// stage tiles by the copy engine (dwconv.cu: K5; coupling_mma.cu: the C=256
// coupling kernel's x2 window and weight ring): the CUDA driver's
// cuTensorMapEncodeTiled, found at run time so that the library does not
// link libcuda, mbarriers, and bulk and TMA tensor copies that complete on
// an mbarrier, as inline PTX.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace vst {

// cuTensorMapEncodeTiled from the driver, without linking libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's address is one for the process, whatever the
// device: it is looked up once, and C++ initialises a function-local static
// once even when two host threads make the first launch together.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                            : nullptr;
  }();
  return fn;
}

__device__ __forceinline__ void mbar_init_count(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_one(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed; the warp is
// suspended meanwhile (for at most kTryWaitNs a try), so waiting warps
// take no issue slots from the others
constexpr uint32_t kTryWaitNs = 10000000;

__device__ __forceinline__ void mbar_wait_parity(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity), "r"(kTryWaitNs)
        : "memory");
  } while (!done);
}

// one thread: `bytes` (a multiple of 16) from global `src` to shared `dst`,
// completing on `bar`, which is told to expect them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one thread: the box of a 4-d tensor map whose corner is (c0, c1, c2, c3)
// (innermost first; outside the tensor, zeros) to shared `dst`, completing
// on `bar`, which is told to expect its `bytes`
__device__ __forceinline__ void tensor_load_4d(uint32_t dst, const void* map,
                                               int c0, int c1, int c2, int c3,
                                               int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// after one thread's mbar_init_count calls, before the barriers are used
// by other threads or the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// order this thread's earlier shared-memory accesses before later ones of
// the copy engine (bulk and tensor copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace vst
