// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (quant_matmul.cu, attention.cu): mbarriers, TMA tile loads, wgmma shared
// memory descriptors and fences, and the host-side tensor-map encoder.
//
// Conventions:
// - Every operand tile is loaded by TMA with the 128-byte swizzle and has
//   rows of exactly 128 bytes (64 bf16 or 128 int8 values), so eight rows
//   form one 1024-byte swizzle atom.  Tiles start on 1024-byte boundaries,
//   which lets a descriptor step through a row in 32-byte k-steps by adding
//   to its start address.
// - A ring stage has a "full" barrier (one producer arrival plus the TMA
//   transaction bytes) and an "empty" barrier (one arrival from each
//   consumer warpgroup, by its first thread once wgmma.wait_group has
//   returned: the group's products, and so its reads of the stage, are
//   done).  Round r of a stage waits on parity r & 1.
// - The tensor map encoder is taken from the driver at run time, so the
//   shared library needs no -lcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- device ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte aligned address at or after `p` (dynamic shared
// memory carries 1024 bytes of slack for this).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA); follow with
// __syncthreads().
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Spin until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA tile loads into shared memory, completing on `bar`.  Coordinates are
// in elements, innermost dimension first; boxes past the tensor's edge
// arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile.  Offsets are
// in 16-byte units: K-major operands take lbo 1 (unused) and sbo 64 (1024
// bytes to the next eight rows).  An MN-major operand 64 bf16 wide (one
// swizzle atom along MN) takes 64 for both: sbo steps to the next eight k
// rows, and lbo, the step to a next MN atom, is not read.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFFu) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFFu) << 32) | (1ull << 62);
}

// Orders register and shared-memory writes before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of wgmma operand registers across
// the issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------------------------------ host ---

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A row-major tensor map with the 128-byte swizzle: `dims` and `box`
// innermost first, `strides` in bytes for dims 1..rank-1.  Returns a
// cudaError_t value (0 on success).
inline int encode_sw128(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                        const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  const EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                        reinterpret_cast<const cuuint64_t*>(dims),
                        reinterpret_cast<const cuuint64_t*>(strides),
                        reinterpret_cast<const cuuint32_t*>(box), elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static const int n = []() {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

}  // namespace hopper
