// Non-causal multi-head attention, softmax(Q K^T / sqrt(hd)) V, for hd = 64.
//
// Replaces: desktop2stereo_tpu/ops/pallas/flash_attention.py:flash_attention
// (kernel body _attn_kernel).  The TPU kernel holds a head's whole K/V in
// VMEM and runs one single-pass softmax per query block; an SM has at most
// 227 KB of shared memory, so this kernel streams K/V tiles instead and keeps
// an online softmax (running max m, running sum l, rescaled accumulator).
//
// Layout: q/k/v are [B, N, H, 64] bf16 read through element strides (batch,
// token, head; the head dim is contiguous), so the q/k/v views of a fused
// qkv projection need no copy.  The output is a fresh contiguous
// [B, N, H, 64] bf16 tensor.  Logits, softmax and accumulation are f32;
// probabilities are rounded to bf16 before the P·V product, as the TPU
// kernel casts p to v's dtype.
//
// Grid: (ceil(N / 64) query tiles, B*H).  Block: 4 warps; warp w owns query
// rows [16w, 16w+16) of the tile.  Per 64-key tile: the block stages K and V
// in shared memory; each warp computes S = Q K^T (16x64) and P V (16x64)
// with WMMA m16n16k16 bf16 tensor-core products; lanes then own half a row
// each (row = lane/2, 32 columns) for the softmax update and the output
// accumulator, which lives in registers.  Keys past N (the ragged last tile,
// 778 = 12*64 + 10 at the flagship shape) are masked to -inf and their K/V
// rows zero-filled.
//
// What bounds it on the H100: at the flagship [1, 778, 16, 64] one layer is
// 4*16*778^2*64 = 2.5 GFLOP against ~6 MB of q/k/v/o traffic, so the tensor
// cores, not HBM, set the floor (a few microseconds at the bf16 peak).  This
// first version launches 208 blocks of 128 threads and uses mma.sync-class
// WMMA rather than wgmma/TMA, so it sits well below that floor; the rewrite
// with wgmma, a TMA ring and larger query tiles is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;       // head dim (the wrapper refuses anything else)
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int NWARPS = 4;
constexpr int LDB = HD + 8;  // bf16 row pitch in shared memory (16 B pad)
constexpr int LDF = BK + 4;  // f32 row pitch of the per-warp scratch

struct Strides {
  long long b, n, h;  // element strides of batch, token, head
};

constexpr size_t kSmemBytes =
    (size_t)(BQ + 2 * BK + NWARPS * 16) * LDB * sizeof(__nv_bfloat16) +
    (size_t)NWARPS * 16 * LDF * sizeof(float);

// Copy rows [row0, row0+rows) of one head into shared memory as a
// [rows][LDB] bf16 tile, 16 bytes per thread per step; rows >= n are zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          Strides s, int b, int h, int row0,
                                          int rows, int n) {
  const int chunks = rows * (HD / 8);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int r = i / (HD / 8);
    const int c = (i % (HD / 8)) * 8;
    const int tok = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (tok < n) {
      const __nv_bfloat16* src = base + b * s.b + (long long)tok * s.n + h * s.h + c;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
  }
}

__global__ void __launch_bounds__(NWARPS * 32)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     int n, int heads, Strides qs, Strides ks, Strides vs,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = q_s + BQ * LDB;
  __nv_bfloat16* v_s = k_s + BK * LDB;
  __nv_bfloat16* p_all = v_s + BK * LDB;
  float* f_all = reinterpret_cast<float*>(p_all + NWARPS * 16 * LDB);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BQ;

  __nv_bfloat16* p_s = p_all + warp * 16 * LDB;  // this warp's P (16 x BK)
  float* f_s = f_all + warp * 16 * LDF;          // this warp's S / PV scratch

  load_tile(q_s, q, qs, b, h, q0, BQ, n);

  // Lane (row r, column half c0) state: running max, running sum, and the
  // 32 output columns it owns.
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  float m_i = -INFINITY;
  float l_i = 0.0f;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // previous tile's K/V fully consumed (and Q staged)
    load_tile(k_s, k, ks, b, h, k0, BK, n);
    load_tile(v_s, v, vs, b, h, k0, BK, n);
    __syncthreads();

    // S = Q_w K^T: 16 x 64, four 16x16 output tiles, four k-steps each.
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_frag;
      wmma::fill_fragment(s_frag, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, q_s + (warp * 16) * LDB + kk * 16, LDB);
        wmma::load_matrix_sync(bt, k_s + (nt * 16) * LDB + kk * 16, LDB);
        wmma::mma_sync(s_frag, a, bt, s_frag);
      }
      wmma::store_matrix_sync(f_s + nt * 16, s_frag, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax on this lane's half row.
    float s_val[32];
    float t_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = k0 + c0 + j;
      const float x = key < n ? f_s[r * LDF + c0 + j] * scale : -INFINITY;
      s_val[j] = x;
      t_max = fmaxf(t_max, x);
    }
    t_max = fmaxf(t_max, __shfl_xor_sync(0xffffffffu, t_max, 1));
    const float m_new = fmaxf(m_i, t_max);  // finite: key k0 is always valid
    const float alpha = expf(m_i - m_new);
    float t_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(s_val[j] - m_new);
      t_sum += p;
      p_s[r * LDB + c0 + j] = __float2bfloat16(p);
    }
    t_sum += __shfl_xor_sync(0xffffffffu, t_sum, 1);
    l_i = l_i * alpha + t_sum;
    m_i = m_new;
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] *= alpha;
    __syncwarp();

    // PV = P_w V: 16 x 64 over the 64 keys of the tile.
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_frag;
      wmma::fill_fragment(o_frag, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, p_s + kk * 16, LDB);
        wmma::load_matrix_sync(bv, v_s + (kk * 16) * LDB + nt * 16, LDB);
        wmma::mma_sync(o_frag, a, bv, o_frag);
      }
      wmma::store_matrix_sync(f_s + nt * 16, o_frag, LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += f_s[r * LDF + c0 + j];
    __syncwarp();  // f_s is rewritten by the next tile's S product
  }

  const int tok = q0 + warp * 16 + r;
  if (tok < n) {
    const float inv_l = 1.0f / l_i;
    __nv_bfloat16* dst = o + ((long long)(b * n + tok) * heads + h) * HD + c0;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + j) =
          __floats2bfloat162_rn(acc[j] * inv_l, acc[j + 1] * inv_l);
    }
  }
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v: [batch, n, heads, 64] bf16 with element strides (*_sb, *_sn, *_sh)
// and a contiguous head dim; o: contiguous [batch, n, heads, 64] bf16.
int d2s_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int batch, int n, int heads,
                      long long q_sb, long long q_sn, long long q_sh,
                      long long k_sb, long long k_sn, long long k_sh,
                      long long v_sb, long long v_sn, long long v_sh,
                      float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + BQ - 1) / BQ, batch * heads);
  attention_fwd_kernel<<<grid, NWARPS * 32, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n,
      heads, Strides{q_sb, q_sn, q_sh}, Strides{k_sb, k_sn, k_sh},
      Strides{v_sb, v_sn, v_sh}, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
