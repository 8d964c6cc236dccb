// Fused int8 dense: per-row dynamic int8 quantisation of x, an
// int8 x int8 -> int32 product with the int8 weight, and the f32 rescale +
// bias:
//
//   s[m]      = max(max_k |x[m, k]|, 1e-8) * f32(1/127)   (or row_scale[m])
//   q[m, k]   = clamp(rint(x[m, k] / s[m]), -127, 127)
//   acc[m, f] = sum_k q[m, k] * w[f, k]                   (int32, exact)
//   out[m, f] = fma((float)acc, s[m] * scale[f], bias[f])  -> f32 or bf16
//               (acc * (s[m] * scale[f]) with no bias; the raw acc in the
//               int32 mode)
//
// Replaces: desktop2stereo_tpu/ops/pallas/quant_matmul.py:quant_dense_matmul
// (kernel body _body).  One call of d2s_quant_dense runs two device kernels
// on the caller's stream:
//
// 1. quantize_rows_kernel: one warp a row takes the abs-max over all of K
//    and writes q as int8 to a scratch [M, K] and s to a scratch [M].  Each
//    row is quantised once, not once per feature tile.
// 2. quant_gemm_kernel: a block owns a BM x 128 output tile.  One producer
//    warp keeps TMA loads of 128-wide K slices of q [BM, 128] and of the
//    weight [128, 128] in a ring of shared-memory stages (128-byte swizzle,
//    mbarrier full/empty pairs); NC consumer warpgroups of 64 rows each run
//    wgmma m64n128k32 s8 on the arrived stage with int32 accumulators in
//    registers.  Both operands are K-major exactly as stored: q [M, K] and
//    the weight [F, K] as nn.Linear stores it.  The epilogue is fused and
//    masked at the M and F edges; K past its end (K is a multiple of 32,
//    the slices are 128 wide) arrives as zeros from TMA.
//
// Rounding is that of its plain version (ops/kernels/quant_matmul.py:
// quant_dense_ref), which is that of XLA's CPU compile of the JAX
// formulation: the f32 reciprocal of 127, IEEE division (__fdiv_rn),
// half-to-even rint, one fused multiply-add in the epilogue (__fmaf_rn on
// __fmul_rn(s, scale)), round-to-nearest-even to bf16.  The intrinsics pin
// every rounding point, so the build needs no -fmad=false; no fast math.
//
// Tiles, at the DA-V2-Large shapes (M = 778 tokens) on 132 SMs: 128 x 128
// tiles (NC = 2) give qkv (F 3072) 7 x 24 = 168 blocks and fc1 (F 4096) 224,
// and move 41 and 55 MB from L2 instead of 60 and 80 MB with 64-row tiles.
// For proj and fc2 (F 1024) they give only 7 x 8 = 56 blocks, less than half
// a wave, so those take 64 x 128 tiles (NC = 1): 13 x 8 = 104 blocks.  The
// host takes NC = 2 when 128-row tiles give at least one block an SM.
// Stages: 4 of 24 KB (NC = 1) or 3 of 32 KB (NC = 2), 96 KB either way, so
// two blocks fit an SM.  Measured slower at these shapes, and so not used
// (PERF.md): 128-row tiles for proj and fc2 split over K across a two-block
// cluster with the partial sums reduced through distributed shared memory;
// the weight tile multicast by TMA across a two-block cluster along M; a
// programmatic dependent launch of the product behind the row pass.
//
// What bounds it on the H100 (SXM, 3.35 TB/s, 1,979 TOPS int8 dense): each
// of the four encoder products moves more bytes than it computes: x once +
// W once + out once is 9.54 MB for qkv (2.85 us, against 2.47 us of
// operations), 4.23 MB for proj (1.26 us), 12.19 MB for fc1 (3.64 us) and
// 12.16 MB for fc2 (3.63 us).  The row pass adds M x K int8 written and
// read back, which stays in the 50 MB L2.  Measured, the call is far from
// that bound: the row pass is a second launch of a few microseconds, and
// the product reads the tiles of q and W again for every tile pair it
// meets, 20-80 MB from L2 a call (fc2's 80 MB at 64-row tiles sets its
// time).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BN = 128;        // features per block: the wgmma N
constexpr int BK = 128;        // K bytes per stage: one swizzled 128-byte row
constexpr int KSTEP = 32;      // wgmma K for s8
constexpr int ROW_WARPS = 8;   // rows per block of the row pass

enum OutKind { kF32 = 0, kBF16 = 1, kInt32 = 2 };

template <int NC>
struct Cfg {
  static constexpr int BM = 64 * NC;
  static constexpr int STAGES = NC == 1 ? 4 : 3;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  static constexpr int THREADS = NC * 128 + 32;  // consumers, then the producer warp
  static constexpr size_t SMEM =
      1024 + static_cast<size_t>(STAGES) * (A_BYTES + B_BYTES) + 2 * STAGES * sizeof(uint64_t);
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
  return static_cast<int8_t>(static_cast<int>(q));
}

// Row pass: warp w of block b quantises row 8b + w; lanes stride K by 16
// bytes of x.
template <typename T>
__global__ void __launch_bounds__(ROW_WARPS * 32)
quantize_rows_kernel(const T* __restrict__ x, int lda, const float* __restrict__ row_scale,
                     int8_t* __restrict__ xq, float* __restrict__ xs, int M, int K) {
  constexpr int VEC = 16 / sizeof(T);  // 8 bf16 or 4 f32 per 16-byte load
  const int lane = threadIdx.x % 32;
  const int m = blockIdx.x * ROW_WARPS + threadIdx.x / 32;
  if (m >= M) return;
  const T* row = x + static_cast<size_t>(m) * lda;
  float s;
  if (row_scale != nullptr) {
    s = row_scale[m];
  } else {
    float amax = 0.0f;
#pragma unroll 4
    for (int k = lane * VEC; k < K; k += 32 * VEC) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + k));
#pragma unroll
      for (int j = 0; j < VEC; ++j) amax = fmaxf(amax, fabsf(element<T>(raw, j)));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    s = __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
  }
  if (lane == 0) xs[m] = s;
  int8_t* qrow = xq + static_cast<size_t>(m) * K;
#pragma unroll 4
  for (int k = lane * VEC; k < K; k += 32 * VEC) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + k));
    uint32_t packed[VEC / 4] = {};  // the int8 values, four to a word
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      packed[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quantize(element<T>(raw, j), s)))
                       << (8 * (j % 4));
    if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(qrow + k) = make_uint2(packed[0], packed[1]);
    } else {
      *reinterpret_cast<uint32_t*>(qrow + k) = packed[0];
    }
  }
}

// d (+)= A[64 x 32] . B[128 x 32]^T, s8 in, s32 out; both operands K-major
// in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int NC>
__global__ void __launch_bounds__(Cfg<NC>::THREADS)
quant_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  void* __restrict__ out, int out_kind, int M, int K, int F) {
  using C = Cfg<NC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align_1024(smem_raw);                 // [STAGES][BM][128] int8 q
  uint8_t* b_s = a_s + C::STAGES * C::A_BYTES;         // [STAGES][BN][128] int8 w
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + C::STAGES * C::B_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int f0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * C::BM;
  const int ktiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], NC);  // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == NC * 4) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % C::STAGES;
        if (kt >= C::STAGES) mbar_wait(&empty[st], ((kt / C::STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], C::A_BYTES + C::B_BYTES);
        tma_load_2d(a_s + st * C::A_BYTES, &xmap, &full[st], kt * BK, m0);
        tma_load_2d(b_s + st * C::B_BYTES, &wmap, &full[st], kt * BK, f0);
      }
    }
    return;
  }

  // Consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the tile.
  const int wg = warp / 4;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const uint32_t a_base = smem_u32(a_s) + wg * 64 * BK;
  const uint32_t b_base = smem_u32(b_s);

  fence_regs(acc);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % C::STAGES;
    mbar_wait(&full[st], (kt / C::STAGES) & 1);
    const uint32_t a = a_base + st * C::A_BYTES;
    const uint32_t b = b_base + st * C::B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / KSTEP; ++kk)
      wgmma_m64n128k32_s8(acc, desc_sw128(a + kk * KSTEP, 1, 64),
                          desc_sw128(b + kk * KSTEP, 1, 64));
    wgmma_commit();
    // The previous stage's products are done once at most this group is in
    // flight: hand that stage back to the producer.
    wgmma_wait<1>();
    if (kt > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(kt - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue.  Accumulator layout of wgmma m64nN: warp w4 of the group owns
  // rows 16 w4 + lane / 4 and + 8; acc[4 i + 2 h + e] is row (+8 h), column
  // 8 i + 2 (lane % 4) + e.  A thread's two columns e = 0, 1 go out as one
  // vector store where F is even (the pair is then aligned and whole).
  const int w4 = warp % 4;
  const int r0 = m0 + wg * 64 + w4 * 16 + lane / 4;
  const int c0 = f0 + 2 * (lane % 4);
  const float s_row[2] = {r0 < M ? xs[r0] : 0.0f, r0 + 8 < M ? xs[r0 + 8] : 0.0f};
  const bool pairs = F % 2 == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int f = c0 + 8 * i;  // even
    if (f >= F) continue;
    const bool second = f + 1 < F;
    const float sc[2] = {scale[f], second ? scale[f + 1] : 0.0f};
    const float bi[2] = {bias != nullptr ? bias[f] : 0.0f,
                         bias != nullptr && second ? bias[f + 1] : 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = r0 + 8 * h;
      if (m >= M) continue;
      const size_t o = static_cast<size_t>(m) * F + f;
      const int a0 = acc[4 * i + 2 * h], a1 = acc[4 * i + 2 * h + 1];
      if (out_kind == kInt32) {
        int* dst = static_cast<int*>(out) + o;
        if (pairs) {
          *reinterpret_cast<int2*>(dst) = make_int2(a0, a1);
        } else {
          dst[0] = a0;
          if (second) dst[1] = a1;
        }
        continue;
      }
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rescale = __fmul_rn(s_row[h], sc[e]);
        const float af = __int2float_rn(e == 0 ? a0 : a1);
        v[e] = bias != nullptr ? __fmaf_rn(af, rescale, bi[e]) : __fmul_rn(af, rescale);
      }
      if (out_kind == kBF16) {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          dst[0] = __float2bfloat16_rn(v[0]);
          if (second) dst[1] = __float2bfloat16_rn(v[1]);
        }
      } else {
        float* dst = static_cast<float*>(out) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (second) dst[1] = v[1];
        }
      }
    }
  }
}

// Sets the kernel's shared-memory limit once per process.
template <int NC>
cudaError_t prepare_gemm() {
  static const cudaError_t err =
      cudaFuncSetAttribute(quant_gemm_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Cfg<NC>::SMEM));
  return err;
}

template <int NC>
int launch_gemm(const void* xq, const void* w, const float* xs, const float* scale,
                const float* bias, void* out, int out_kind, int M, int K, int F,
                cudaStream_t st) {
  using C = Cfg<NC>;
  cudaError_t err = prepare_gemm<NC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t wdims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(F)};
  const uint64_t strides[1] = {static_cast<uint64_t>(K)};
  const uint32_t xbox[2] = {BK, C::BM};
  const uint32_t wbox[2] = {BK, BN};
  int code = encode_sw128(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xdims, strides, xbox);
  if (code != 0) return code;
  code = encode_sw128(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, w, wdims, strides, wbox);
  if (code != 0) return code;
  const dim3 grid((F + BN - 1) / BN, (M + C::BM - 1) / C::BM);
  quant_gemm_kernel<NC><<<grid, C::THREADS, C::SMEM, st>>>(xmap, wmap, xs, scale, bias, out,
                                                           out_kind, M, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [M, K] bf16 (x_is_bf16) or f32, row stride lda elements, 16-byte
// aligned rows; w: contiguous [F, K] int8, 16-byte aligned; scale: [F] f32;
// bias: [F] f32 or null; row_scale: [M] f32 or null; xq: scratch [M, K]
// int8 and xs: scratch [M] f32, both written here; out: contiguous [M, F]
// f32 (out_kind 0), bf16 (1) or int32 (2).  K is a multiple of 32.  Runs
// the row pass, then the product, on `stream`.
int d2s_quant_dense(const void* x, int x_is_bf16, int lda, const void* w, const void* scale,
                    const void* bias, const void* row_scale, void* xq, void* xs, void* out,
                    int out_kind, int M, int K, int F, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rs = static_cast<const float*>(row_scale);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  const int row_blocks = (M + ROW_WARPS - 1) / ROW_WARPS;
  if (x_is_bf16) {
    quantize_rows_kernel<__nv_bfloat16><<<row_blocks, ROW_WARPS * 32, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), lda, rs, q, s, M, K);
  } else {
    quantize_rows_kernel<float><<<row_blocks, ROW_WARPS * 32, 0, st>>>(
        static_cast<const float*>(x), lda, rs, q, s, M, K);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const long long tiles128 =
      static_cast<long long>((M + 127) / 128) * ((F + BN - 1) / BN);
  if (tiles128 >= sm_count())
    return launch_gemm<2>(xq, w, s, sc, bi, out, out_kind, M, K, F, st);
  return launch_gemm<1>(xq, w, s, sc, bi, out, out_kind, M, K, F, st);
}

}  // extern "C"
