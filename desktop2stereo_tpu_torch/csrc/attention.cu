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
// qkv projection need no copy: each is a rank-4 TMA tensor map over its own
// strides.  The output is a fresh contiguous [B, N, H, 64] bf16 tensor.
// Logits, softmax and accumulation are f32; probabilities are rounded to
// bf16 before the P.V product, as the TPU kernel casts p to v's dtype.
//
// Grid: (ceil(N / 64) query tiles, B*H); a block owns one 64-row query tile
// of one (batch, head).  Block: one consumer warpgroup (warps 0-3) and one
// producer warp (warp 4).  The producer's lane 0 loads the Q tile once, then
// K and V tiles of 128 keys into a ring of two stages, by TMA with the
// 128-byte swizzle (64 bf16 = 128 bytes a row); rows past N arrive as zeros.
// For each K/V tile the consumer warpgroup:
//   - runs wgmma m64n128k16 (Q and K from shared memory, both K-major) into
//     64 f32 registers a thread: S never touches shared memory;
//   - masks keys >= N to -inf and updates the online softmax in registers,
//     with exp2f on the logits scaled by log2(e) / sqrt(hd) in one FMA;
//   - converts P to bf16 in registers, where the wgmma accumulator layout of
//     S is the register A-operand layout of the next product, and runs
//     wgmma m64n64k16 with V from shared memory as an MN-major B operand
//     (the transpose 16-bit types allow): P never touches shared memory;
//   - hands the stage back to the producer.
// At the end it normalises by 1/l and writes bf16 rows.
//
// Additive bias (BEiT's relative-position bias), two more entry points:
//
// - d2s_attention_bias_fwd takes a contiguous dense [H, N, N] bias, bf16 or
//   f32, shared by every batch element, and adds it to the scaled logits
//   before the softmax, as the plain version does (logits * 1/sqrt(hd) +
//   bias, in f32).  Each thread reads the bias element of every accumulator
//   register it owns straight from global memory (in the bias's own dtype,
//   widened to f32) and folds scale and log2(e) into the logits in place,
//   s' = s * log2(e)/sqrt(hd) + bias * log2(e), so the softmax below runs on
//   s' with a scale of 1: the bias is scaled by log2(e) like the logits,
//   since exp2 stands in for exp.  Keys >= N read no bias and are masked as
//   before; query rows >= N read row N-1 (their output is dropped).  It
//   costs one read of H*N*N elements a call, with the latency of scalar
//   loads (odd N leaves the rows unaligned) exposed on every key tile.
// - d2s_attention_relpos_fwd (the JAX package has no kernel for it: its
//   models/beit.py build_rel_pos_bias materialises the bias and
//   ops/attention.py xla_attention adds it) takes the bias as what it is,
//   a gather B[h, i, j] = T[idx(i, j), h] from one layer's table T, passed transposed
//   as a contiguous [H, R] table (bf16 or f32), R = (2gh-1)(2gw-1) + 3, for
//   an N = gh*gw + 1 token grid (token 0 is cls).  A block stages its head's
//   row once, beside the Q load, into shared memory as f32 already
//   multiplied by log2(e) (the product the dense entry forms per element, so
//   both entries add the same f32 values), and the key offsets b_j of every
//   key it will visit.  The index has a closed form: for patches
//   i, j >= 1 at (y, x) = ((t-1) / gw, (t-1) % gw),
//     idx(i, j) = a_i - b_j,  a_i = (y_i + gh - 1)(2gw - 1) + x_i + gw - 1,
//                             b_j = y_j (2gw - 1) + x_j,
//   and the cls entries are idx(0, j>=1) = R-3, idx(i>=1, 0) = R-2,
//   idx(0, 0) = R-1 (HF's generate_relative_position_index row for row).
//   Each thread computes a_i for its two rows once (the cls row takes
//   a = R-3 with b multiplied by 0), so an accumulator element costs one
//   integer multiply-add and one shared-memory load in place of a global
//   load; key 0 takes its cls entry by a select in the first key tile.  No
//   [H, N, N] tensor is read or built.  The result equals the dense entry's
//   on the expanded bias bit for bit (the same f32 operands, the same
//   operations).  Shared memory grows by 4R bytes and 4 bytes a visited key
//   (11.4 KB at 18x32: 84 KB a block, still two blocks an SM, which the
//   registers allow anyway); the wrapper refuses a grid whose staging would
//   not fit one block.
// The three entries share one kernel body (`attention_fwd`): the unbiased
// and dense-bias instances behind `attention_fwd_kernel`, with no bias code
// in the unbiased one's loop, and the table instances behind
// `attention_fwd_kernel_relpos`, whose launch bounds hold it to two blocks
// an SM.

// Waves at the flagship [1, 778, 16, 64]: 13 x 16 = 208 blocks of one
// consumer warpgroup, 73 KB of shared memory each.  Two or three fit an SM,
// so all 208 run in one wave, and one block's softmax overlaps another's
// products on the same SM.  Two consumer warpgroups a block (7 x 16 = 112
// blocks) would share each K/V load between 128 query rows but leave 20 of
// 132 SMs idle and give each SM one block, with nothing to overlap.
//
// What bounds it on the H100: at the flagship shape one layer is
// 4*16*778^2*64 = 2.5 GFLOP against ~6 MB of q/k/v/o traffic, so the tensor
// cores, not HBM, set the floor (2.5 us at the bf16 peak).  The dense biased
// entry adds 2*H*N^2 bytes (10.7 MB at BEiT-L's [1, 577, 16, 64]), which
// makes bytes its floor; the table entry adds H*R elements (71 KB), and its
// floor is again the operations' (1.4 us there).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int HD = 64;        // head dim (the wrapper refuses anything else)
constexpr int BQ = 64;        // query rows per block: one wgmma M
constexpr int BKV = 128;      // keys per K/V tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 128 + 32;
constexpr int Q_BYTES = BQ * HD * 2;
constexpr int KV_BYTES = BKV * HD * 2;
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 2 * STAGES) * sizeof(uint64_t);
// The table entry: the barriers' slot rounded up to 48 bytes, then the head's
// table row (f32, R rounded up to 4) and the key offsets (int, whole tiles).
constexpr int BAR_SLOT = 48;
constexpr size_t RELPOS_BASE = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_SLOT;
constexpr size_t SMEM_MAX = 232448;  // 227 KB, the most one block may take
constexpr float LOG2E = 1.4426950408889634f;

size_t relpos_smem(int n, int r) {
  return RELPOS_BASE + (static_cast<size_t>(r) + 3) / 4 * 16 +
         static_cast<size_t>((n + BKV - 1) / BKV) * BKV * 4;
}

// The 128 threads of the consumer warpgroup (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// TMA coordinates for a map whose dims 1..3 are (head, token, batch) in the
// order `perm` gives: two bits a dim, 0 head, 1 token, 2 batch.
__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int perm, int h, int row, int b) {
  auto coord = [&](int which) { return which == 0 ? h : which == 1 ? row : b; };
  tma_load_4d(dst, map, bar, 0, coord(perm & 3), coord((perm >> 2) & 3), coord((perm >> 4) & 3));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (+)= Q[64 x 16] . K[128 x 16]^T, bf16 in, f32 out; both K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += P[64 x 16] . V[16 x 64]: P bf16 from registers (a0..a3), V bf16 from
// shared memory, MN-major (transposed B).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float bias_at(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ float bias_at(const float* p) { return __ldg(p); }

// The kernel body.  BiasT: void (no bias), __nv_bfloat16 or float: a
// contiguous [heads, n, n] bias, or with kRelPos a contiguous [heads, r]
// table for a gh x gw grid.
template <typename BiasT, bool kRelPos>
__device__ __forceinline__ void attention_fwd(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                              const CUtensorMap& vmap,
                                              __nv_bfloat16* __restrict__ o,
                                              const BiasT* __restrict__ bias, int n, int heads,
                                              int perms, float scale_log2, int r_entries, int gh,
                                              int gw) {
  constexpr bool kBias = !std::is_void<BiasT>::value;
  // the softmax's scale on the logits: folded into them when there is a bias
  const float sl = kBias ? 1.0f : scale_log2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);        // [BQ][64] bf16, swizzled
  uint8_t* k_s = q_s + Q_BYTES;               // [STAGES][BKV][64]
  uint8_t* v_s = k_s + STAGES * KV_BYTES;     // [STAGES][BKV][64]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + STAGES * KV_BYTES);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;
  float* tab_s = reinterpret_cast<float*>(v_s + STAGES * KV_BYTES + BAR_SLOT);  // kRelPos
  int* key_s = reinterpret_cast<int*>(tab_s + ((r_entries + 3) & ~3));          // kRelPos

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (n + BKV - 1) / BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);  // one arrival from the consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
      load_rows(q_s, &qmap, q_bar, perms & 63, h, q0, b);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * KV_BYTES);
        load_rows(k_s + st * KV_BYTES, &kmap, &full[st], (perms >> 6) & 63, h, j * BKV, b);
        load_rows(v_s + st * KV_BYTES, &vmap, &full[st], (perms >> 12) & 63, h, j * BKV, b);
      }
    }
    return;
  }

  // Accumulator layout of wgmma m64nN (f32): warp w owns rows 16 w + lane/4
  // (r = 0) and + 8 (r = 1); register 4 i + 2 r + e is column
  // 8 i + 2 (lane % 4) + e of its row.
  const int quad = lane % 4;
  float s_acc[64];
  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) s_acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of the logits (s, or s')
  float l_run[2] = {0.0f, 0.0f};            // this thread's share of the running sum

  // The table entry: stage the head's row (times log2(e)) and the offsets
  // b_j of every key the tiles visit (0 for key 0 and keys >= n) while the
  // producer loads Q; a_i, its multiplier (0 on the cls row) and the index
  // for key 0 for this thread's two rows.
  int a_row[2] = {0, 0}, m_row[2] = {0, 0}, c0_row[2] = {0, 0};
  if constexpr (kRelPos) {
    const BiasT* trow = bias + static_cast<long long>(h) * r_entries;
#pragma unroll 4
    for (int t = threadIdx.x; t < r_entries; t += 128) tab_s[t] = bias_at(trow + t) * LOG2E;
    const int w2 = 2 * gw - 1;
    for (int c = threadIdx.x; c < ntiles * BKV; c += 128) {
      int off = 0;
      if (c >= 1 && c < n) {
        const int y = (c - 1) / gw;
        off = y * w2 + (c - 1 - y * gw);
      }
      key_s[c] = off;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = min(q0 + (warp % 4) * 16 + lane / 4 + 8 * r, n - 1);
      if (row == 0) {
        a_row[r] = r_entries - 3;
        c0_row[r] = r_entries - 1;
      } else {
        const int y = (row - 1) / gw;
        a_row[r] = (y + gh - 1) * w2 + (row - 1 - y * gw) + gw - 1;
        m_row[r] = 1;
        c0_row[r] = r_entries - 2;
      }
    }
    consumer_sync();
  }

  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_bar, 0);
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % STAGES;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t k_addr = smem_u32(k_s + st * KV_BYTES);
    const uint32_t v_addr = smem_u32(v_s + st * KV_BYTES);

    // S = Q K^T over the 64 head dims: four k16 steps of 32 bytes.
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk(s_acc, desc_sw128(q_addr + kk * 32, 1, 64), desc_sw128(k_addr + kk * 32, 1, 64),
               kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s_acc);

    if constexpr (kRelPos) {  // s' = s * scale * log2(e) + T[idx] * log2(e)
      const int* kc = key_s + j * BKV + 2 * quad;
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i) {
        const int2 off = *reinterpret_cast<const int2*>(kc + 8 * i);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int idx = a_row[r] - m_row[r] * (e ? off.y : off.x);
            if (i == 0 && e == 0 && j == 0 && quad == 0) idx = c0_row[r];  // key 0: cls
            s_acc[4 * i + 2 * r + e] = fmaf(s_acc[4 * i + 2 * r + e], scale_log2, tab_s[idx]);
          }
      }
    } else if constexpr (kBias) {  // s' = s * scale * log2(e) + bias * log2(e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = min(q0 + (warp % 4) * 16 + lane / 4 + 8 * r, n - 1);
        const BiasT* brow = bias + (static_cast<long long>(h) * n + row) * n;
#pragma unroll
        for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j * BKV + 8 * i + 2 * quad + e;
            const float bv = col < n ? bias_at(brow + col) : 0.0f;
            s_acc[4 * i + 2 * r + e] =
                fmaf(s_acc[4 * i + 2 * r + e], scale_log2, bv * LOG2E);
          }
      }
    }

    if ((j + 1) * BKV > n) {  // the ragged last tile: keys >= n take no weight
#pragma unroll
      for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * BKV + 8 * i + 2 * quad + e >= n) {
            s_acc[4 * i + e] = -INFINITY;
            s_acc[4 * i + 2 + e] = -INFINITY;
          }
    }

    // Online softmax: the row max over the quad's 128 columns.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(mx[r], fmaxf(s_acc[4 * i + 2 * r], s_acc[4 * i + 2 * r + 1]));
    float neg[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: every tile holds at least one key < n
      alpha[r] = exp2f((m_run[r] - mx[r]) * sl);
      m_run[r] = mx[r];
      neg[r] = -mx[r] * sl;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(fmaf(s_acc[4 * i + 2 * r + e], sl, neg[r]));
          s_acc[4 * i + 2 * r + e] = p;
          sum[r] += p;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        o_acc[4 * i + 2 * r] *= alpha[r];
        o_acc[4 * i + 2 * r + 1] *= alpha[r];
      }

    // P (bf16, registers) . V: k16 step kk covers keys 16 kk .. 16 kk + 15,
    // i.e. S registers 8 kk .. 8 kk + 7, which are exactly the A fragment
    // (row, k 0-1), (row + 8, k 0-1), (row, k 8-9), (row + 8, k 8-9).
    uint32_t p_frag[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) p_frag[i] = pack_bf16(s_acc[2 * i], s_acc[2 * i + 1]);
    fence_regs(p_frag);
    fence_regs(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_pv(o_acc, p_frag[4 * kk], p_frag[4 * kk + 1], p_frag[4 * kk + 2], p_frag[4 * kk + 3],
               desc_sw128(v_addr + kk * 16 * HD * 2, 64, 64));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    if (threadIdx.x == 0) mbar_arrive(&empty[st]);  // the group's products are done
  }

  const int row0 = q0 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = row0 + 8 * r;
    if (row >= n) continue;
    const float inv_l = 1.0f / l;
    __nv_bfloat16* dst =
        o + (static_cast<long long>(b) * n + row) * heads * HD + static_cast<long long>(h) * HD +
        2 * quad;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) = __floats2bfloat162_rn(
          o_acc[4 * i + 2 * r] * inv_l, o_acc[4 * i + 2 * r + 1] * inv_l);
  }
}

// The unbiased and dense-bias instances (their launch bounds leave the
// register count to ptxas: 130 and 200).
template <typename BiasT>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
                     const BiasT* __restrict__ bias, int n, int heads, int perms,
                     float scale_log2) {
  attention_fwd<BiasT, false>(qmap, kmap, vmap, o, bias, n, heads, perms, scale_log2, 0, 0, 0);
}

// The table instances, held to two resident blocks an SM (at most 204
// registers a thread).
template <typename TableT>
__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_kernel_relpos(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, const TableT* __restrict__ table,
                            int n, int heads, int perms, float scale_log2, int r_entries, int gh,
                            int gw) {
  attention_fwd<TableT, true>(qmap, kmap, vmap, o, table, n, heads, perms, scale_log2, r_entries,
                              gh, gw);
}

// The instance's entry, for the runtime's attribute and occupancy calls.
template <typename BiasT, bool kRelPos>
const void* kernel_entry() {
  if constexpr (kRelPos)
    return reinterpret_cast<const void*>(attention_fwd_kernel_relpos<BiasT>);
  else
    return reinterpret_cast<const void*>(attention_fwd_kernel<BiasT>);
}

// One rank-4 map over [B, N, H, 64] with element strides (sb, sn, sh): dims
// 1..3 are head, token and batch sorted by stride, size-1 dims last (their
// stride is never used and is set to the packed one).  Returns the order as
// `attention_fwd_kernel` reads it, or -1 if the encoder refuses the map.
int encode_qkv(CUtensorMap* map, const void* base, int batch, int n, int heads, long long sb,
               long long sn, long long sh, int rows) {
  struct Dim {
    uint64_t size, stride;
    int which;
  } d[3] = {{static_cast<uint64_t>(heads), static_cast<uint64_t>(sh) * 2, 0},
            {static_cast<uint64_t>(n), static_cast<uint64_t>(sn) * 2, 1},
            {static_cast<uint64_t>(batch), static_cast<uint64_t>(sb) * 2, 2}};
  auto before = [](const Dim& a, const Dim& c) {
    if ((a.size == 1) != (c.size == 1)) return c.size == 1;
    return a.stride < c.stride;
  };
  for (int i = 1; i < 3; ++i)  // insertion sort of three
    for (int j = i; j > 0 && before(d[j], d[j - 1]); --j) {
      const Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  uint64_t packed = HD * 2;
  for (int i = 0; i < 3; ++i) {
    if (d[i].size == 1) d[i].stride = packed;
    packed = d[i].stride * d[i].size;
  }
  const uint64_t dims[4] = {HD, d[0].size, d[1].size, d[2].size};
  const uint64_t strides[3] = {d[0].stride, d[1].stride, d[2].stride};
  uint32_t box[4] = {HD, 1, 1, 1};
  int perm = 0;
  for (int i = 0; i < 3; ++i) {
    if (d[i].which == 1) box[i + 1] = rows;
    perm |= d[i].which << (2 * i);
  }
  const int code = encode_sw128(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
  return code == 0 ? perm : -1;
}

// Sets the instance's shared-memory limit once; its result thereafter.
template <typename BiasT, bool kRelPos>
cudaError_t prepare() {
  static const cudaError_t attr = [] {
    const void* fn = kernel_entry<BiasT, kRelPos>();
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kRelPos ? SMEM_MAX : SMEM));
    if (e == cudaSuccess && kRelPos)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return attr;
}

// Encodes the three maps and launches the kernel instance; `bias` is the
// dense bias or the table, `r`, `gh` and `gw` the table's (0 otherwise).
template <typename BiasT, bool kRelPos>
int launch(const void* q, const void* k, const void* v, void* o, const void* bias, int batch,
           int n, int heads, const long long* qs, const long long* ks, const long long* vs,
           float scale, int r, int gh, int gw, void* stream) {
  const cudaError_t attr = prepare<BiasT, kRelPos>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = kRelPos ? relpos_smem(n, r) : SMEM;
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  const int pq = encode_qkv(&qmap, q, batch, n, heads, qs[0], qs[1], qs[2], BQ);
  const int pk = encode_qkv(&kmap, k, batch, n, heads, ks[0], ks[1], ks[2], BKV);
  const int pv = encode_qkv(&vmap, v, batch, n, heads, vs[0], vs[1], vs[2], BKV);
  if (pq < 0 || pk < 0 || pv < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + BQ - 1) / BQ, batch * heads);
  const dim3 block(THREADS);
  auto* out = static_cast<__nv_bfloat16*>(o);
  auto* operand = static_cast<const BiasT*>(bias);
  const int perms = pq | (pk << 6) | (pv << 12);
  const float scale_log2 = scale * LOG2E;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kRelPos)
    attention_fwd_kernel_relpos<BiasT><<<grid, block, smem, st>>>(
        qmap, kmap, vmap, out, operand, n, heads, perms, scale_log2, r, gh, gw);
  else
    attention_fwd_kernel<BiasT><<<grid, block, smem, st>>>(qmap, kmap, vmap, out, operand, n,
                                                           heads, perms, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local (spill) bytes, dynamic shared memory and resident blocks
// an SM of one instance at n tokens (and r table entries).
template <typename BiasT, bool kRelPos>
int info(int n, int r, int* out) {
  const cudaError_t attr = prepare<BiasT, kRelPos>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel_entry<BiasT, kRelPos>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = kRelPos ? relpos_smem(n, r) : SMEM;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_entry<BiasT, kRelPos>(),
                                                    THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q/k/v: [batch, n, heads, 64] bf16 with element strides (*_sb, *_sn, *_sh)
// and a contiguous head dim; o: contiguous [batch, n, heads, 64] bf16.
int d2s_attention_fwd(const void* q, const void* k, const void* v, void* o, int batch, int n,
                      int heads, long long q_sb, long long q_sn, long long q_sh, long long k_sb,
                      long long k_sn, long long k_sh, long long v_sb, long long v_sn,
                      long long v_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  return launch<void, false>(q, k, v, o, nullptr, batch, n, heads, qs, ks, vs, scale, 0, 0, 0,
                            stream);
}

// As d2s_attention_fwd, plus a contiguous [heads, n, n] bias added to the
// scaled logits: bf16 when bias_f32 is 0, else f32.
int d2s_attention_bias_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                           int n, int heads, long long q_sb, long long q_sn, long long q_sh,
                           long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                           long long v_sn, long long v_sh, float scale, const void* bias,
                           int bias_f32, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bias_f32 ? launch<float, false>(q, k, v, o, bias, batch, n, heads, qs, ks, vs, scale, 0,
                                         0, 0, stream)
                  : launch<__nv_bfloat16, false>(q, k, v, o, bias, batch, n, heads, qs, ks, vs,
                                                 scale, 0, 0, 0, stream);
}

// As d2s_attention_fwd, plus BEiT's relative-position bias gathered from a
// contiguous [heads, r] table (bf16 when table_f32 is 0, else f32) for a
// gh x gw grid: n must be gh * gw + 1 and r (2 gh - 1)(2 gw - 1) + 3.
int d2s_attention_relpos_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                             int n, int heads, long long q_sb, long long q_sn, long long q_sh,
                             long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                             long long v_sn, long long v_sh, float scale, const void* table,
                             int table_f32, int r, int gh, int gw, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  if (table == nullptr || gh < 1 || gw < 1 || n != gh * gw + 1 ||
      r != (2 * gh - 1) * (2 * gw - 1) + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  return table_f32 ? launch<float, true>(q, k, v, o, table, batch, n, heads, qs, ks, vs, scale, r,
                                         gh, gw, stream)
                   : launch<__nv_bfloat16, true>(q, k, v, o, table, batch, n, heads, qs, ks, vs,
                                                 scale, r, gh, gw, stream);
}

// out[4] = registers a thread, local bytes a thread (spills), dynamic shared
// memory bytes and resident blocks an SM, for entry 0 (no bias), 1 (dense
// bias) or 2 (table) with a bf16 (f32 = 0) or f32 operand, at n tokens and r
// table entries.
int d2s_attention_info(int entry, int f32, int n, int r, int* out) {
  switch (entry * 2 + (f32 != 0)) {
    case 0:
    case 1:
      return info<void, false>(n, r, out);
    case 2:
      return info<__nv_bfloat16, false>(n, r, out);
    case 3:
      return info<float, false>(n, r, out);
    case 4:
      return info<__nv_bfloat16, true>(n, r, out);
    case 5:
      return info<float, true>(n, r, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
