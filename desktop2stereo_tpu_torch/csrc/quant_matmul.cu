// Fused int8 dense: per-row dynamic int8 quantisation of x, an
// int8 x int8 -> int32 product with the int8 weight, and the f32 rescale +
// bias, in one launch:
//
//   s[m]      = max(max_k |x[m, k]|, 1e-8) * f32(1/127)   (or row_scale[m])
//   q[m, k]   = clamp(rint(x[m, k] / s[m]), -127, 127)
//   acc[m, f] = sum_k q[m, k] * w[f, k]                   (int32, exact)
//   out[m, f] = fma((float)acc, s[m] * scale[f], bias[f])  -> f32 or bf16
//               (acc * (s[m] * scale[f]) with no bias; the raw acc in the
//               int32 mode)
//
// Replaces: desktop2stereo_tpu/ops/pallas/quant_matmul.py:quant_dense_matmul
// (kernel body _body).  As on the TPU, nothing int8 or int32 reaches device
// memory: a block owns a 64-row x 64-feature output tile, first takes the
// abs-max of its own 64 rows over all of K (unless row_scale is given), then
// walks K in 64-wide steps, quantising its x tile into shared memory as it
// loads it, staging the int8 weight tile beside it, and running WMMA
// 16x16x16 s8 products with int32 accumulators (4 warps, each a 32x32
// quarter of the tile).  The epilogue goes through shared memory so that
// the single output write is coalesced.  Rows past M, features past F and
// the last 32 of a K that is an odd multiple of 32 are masked (zeros in
// shared memory, no store).
//
// Rounding is that of its plain version (ops/kernels/quant_matmul.py:
// quant_dense_ref), which is that of XLA's CPU compile of the JAX
// formulation: the f32 reciprocal of 127, IEEE division (__fdiv_rn),
// half-to-even rint, one fused multiply-add in the epilogue (__fmaf_rn on
// __fmul_rn(s, scale)), round-to-nearest-even to bf16.  The intrinsics pin
// every rounding point, so the build needs no -fmad=false; no fast math.
//
// What bounds it on the H100 (SXM, 3.35 TB/s, 1,979 TOPS int8 dense): at
// the DA-V2-Large shapes (M = 778 tokens, bf16 x) each of the four encoder
// products moves more bytes than it computes: x once + W once + out once
// is 9.54 MB for qkv (1024 -> 3072; 2.85 us, against 2.47 us of
// operations), 4.23 MB for proj (1024 -> 1024; 1.26 us), 12.19 MB for fc1
// (1024 -> 4096; 3.64 us) and 12.16 MB for fc2 (4096 -> 1024; 3.63 us):
// ~11.4 us a layer, ~0.27 ms for 24 layers.  This first version is far from
// that: mma.sync-class WMMA, no cp.async or TMA pipeline, x re-read (from
// L2) and re-quantised (an IEEE division per element) by every feature tile,
// and read once more for the abs-max.  Holding a whole K step's loads (and
// the next step's) in registers was tried and was slower: 120-166 registers
// a thread instead of 64 left 3-4 blocks an SM instead of 8.  wgmma with a
// TMA ring, and x quantised once per row tile, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // features per block
constexpr int BK = 64;        // K per step
constexpr int KC = BK / 16;   // 16-wide K chunks per step
constexpr int NTHREADS = 128; // 4 warps, 2 x 2 over the tile
constexpr int LDC = BN + 4;   // int32 pitch of the epilogue tile

enum OutKind { kF32 = 0, kBF16 = 1, kInt32 = 2 };

// The int8 tiles live as [KC][rows][16]: each 16-byte row of a chunk is one
// WMMA fragment row, and every fragment pointer is 256-bit aligned.
struct __align__(32) Smem {
  int8_t a[KC][BM][16];
  int8_t b[KC][BN][16];
  int c[BM][LDC];
  float s[BM];
};

// Element j of a 16-byte load of T values, as f32 (bf16 widens exactly by
// a shift).  With j known at compile time this stays in registers.
template <typename T>
__device__ __forceinline__ float element(const uint4& raw, int j) {
  constexpr int PER_WORD = 4 / sizeof(T);
  const int i = j / PER_WORD;
  const uint32_t w = i == 0 ? raw.x : i == 1 ? raw.y : i == 2 ? raw.z : raw.w;
  if constexpr (PER_WORD == 1) return __uint_as_float(w);
  return __uint_as_float(j % 2 == 0 ? w << 16 : w & 0xffff0000u);
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)(int)q;
}

// Per-row abs-max: warp w takes rows w, w+4, ...; lanes stride K by 16 bytes.
template <typename T>
__device__ void row_scales(const T* __restrict__ x, int lda, int m0, int M, int K,
                           float* __restrict__ s) {
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const int m = m0 + r;
    float amax = 0.0f;
    if (m < M) {
      const T* row = x + (size_t)m * lda;
      for (int k = lane * VEC; k < K; k += 32 * VEC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + k);
#pragma unroll
        for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(element<T>(raw, j)));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) s[r] = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  }
}

// Load x[m0:m0+BM, k0:k0+BK], quantise with the row scales, store int8.
template <typename T>
__device__ void load_x(const T* __restrict__ x, int lda, int m0, int M, int k0, int K,
                       Smem& sm) {
  constexpr int VEC = 16 / sizeof(T);   // 8 bf16 or 4 f32 per 16-byte load
  constexpr int PER_ROW = BK / VEC;
  for (int i = threadIdx.x; i < BM * PER_ROW; i += NTHREADS) {
    const int r = i / PER_ROW;
    const int kk = (i % PER_ROW) * VEC;
    const int m = m0 + r, k = k0 + kk;
    uint32_t packed[VEC / 4] = {};  // the int8 values, four to a word
    if (m < M && k < K) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * lda + k);
      const float s = sm.s[r];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        packed[j / 4] |= (uint32_t)(uint8_t)quantize(element<T>(raw, j), s) << (8 * (j % 4));
    }
    int8_t* dst = &sm.a[kk / 16][r][kk % 16];
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = packed[0];
    }
  }
}

// Load w[f0:f0+BN, k0:k0+BK] (int8, [F, K] row-major), 16 bytes a thread.
__device__ void load_w(const int8_t* __restrict__ w, int f0, int F, int k0, int K, Smem& sm) {
  for (int i = threadIdx.x; i < BN * KC; i += NTHREADS) {
    const int n = i / KC, c = i % KC;
    const int f = f0 + n, k = k0 + c * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (f < F && k < K) v = *reinterpret_cast<const uint4*>(w + (size_t)f * K + k);
    *reinterpret_cast<uint4*>(&sm.b[c][n][0]) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
quant_dense_kernel(const T* __restrict__ x, int lda, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ row_scale, void* __restrict__ out,
                   int out_kind, int M, int K, int F) {
  __shared__ Smem sm;
  const int f0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  if (row_scale != nullptr) {
    for (int r = threadIdx.x; r < BM; r += NTHREADS)
      sm.s[r] = m0 + r < M ? row_scale[m0 + r] : 1.0f;
  } else {
    row_scales(x, lda, m0, M, K, sm.s);
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_x(x, lda, m0, M, k0, K, sm);
    load_w(w, f0, F, k0, K, sm);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], reinterpret_cast<const signed char*>(&sm.a[c][wm + 16 * i][0]), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], reinterpret_cast<const signed char*>(&sm.b[c][wn + 16 * j][0]), 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are rewritten by the next step
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sm.c[wm + 16 * i][wn + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  // Epilogue: thread t owns column t % BN of every other row.
  const int n = threadIdx.x % BN;
  const int f = f0 + n;
  if (f >= F) return;
  const float sc = scale[f];
  const float bi = bias != nullptr ? bias[f] : 0.0f;
  for (int r = threadIdx.x / BN; r < BM; r += NTHREADS / BN) {
    const int m = m0 + r;
    if (m >= M) break;
    const int a = sm.c[r][n];
    const size_t o = (size_t)m * F + f;
    if (out_kind == kInt32) {
      static_cast<int*>(out)[o] = a;
      continue;
    }
    const float rescale = __fmul_rn(sm.s[r], sc);
    const float af = __int2float_rn(a);
    const float v = bias != nullptr ? __fmaf_rn(af, rescale, bi) : __fmul_rn(af, rescale);
    if (out_kind == kBF16) {
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] bf16 (x_is_bf16) or f32, row stride lda elements, 16-byte
// aligned rows; w: contiguous [F, K] int8; scale: [F] f32; bias: [F] f32 or
// null; row_scale: [M] f32 or null; out: contiguous [M, F] f32 (out_kind 0),
// bf16 (1) or int32 (2).  K is a multiple of 32.
int d2s_quant_dense(const void* x, int x_is_bf16, int lda, const void* w,
                    const void* scale, const void* bias, const void* row_scale,
                    void* out, int out_kind, int M, int K, int F, void* stream) {
  const dim3 grid((F + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* rs = static_cast<const float*>(row_scale);
  if (x_is_bf16) {
    quant_dense_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lda, wq, sc, bi, rs, out, out_kind, M, K, F);
  } else {
    quant_dense_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), lda, wq, sc, bi, rs, out, out_kind, M, K, F);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
