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

// BEiT's relative-position index in its closed form (see the header), shared
// by the bf16 and f32 table entries.  b_j for key c: 0 for the cls key and for
// keys >= n (masked anyway).
__device__ __forceinline__ int relpos_key_offset(int c, int n, int gw) {
  if (c < 1 || c >= n) return 0;
  const int y = (c - 1) / gw;
  return y * (2 * gw - 1) + (c - 1 - y * gw);
}

// For query row `row` < n: a_i, its multiplier m_i (0 on the cls row, whose
// patch keys all take R-3) and idx(i, 0), the entry of key 0.
__device__ __forceinline__ void relpos_row(int row, int gh, int gw, int r_entries, int& a, int& m,
                                           int& c0) {
  if (row == 0) {
    a = r_entries - 3;
    m = 0;
    c0 = r_entries - 1;
  } else {
    const int y = (row - 1) / gw;
    a = (y + gh - 1) * (2 * gw - 1) + (row - 1 - y * gw) + gw - 1;
    m = 1;
    c0 = r_entries - 2;
  }
}

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
    for (int c = threadIdx.x; c < ntiles * BKV; c += 128) key_s[c] = relpos_key_offset(c, n, gw);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      relpos_row(min(q0 + (warp % 4) * 16 + lane / 4 + 8 * r, n - 1), gh, gw, r_entries, a_row[r],
                 m_row[r], c0_row[r]);
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

// out[4]: registers, local (spill) bytes a thread, dynamic shared memory and
// resident blocks an SM of kernel `fn` launched with `threads` and `smem`.
int kernel_report(cudaError_t attr, const void* fn, int threads, size_t smem, int* out) {
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  return 0;
}

// The report of one instance at n tokens (and r table entries).
template <typename BiasT, bool kRelPos>
int info(int n, int r, int* out) {
  return kernel_report(prepare<BiasT, kRelPos>(), kernel_entry<BiasT, kRelPos>(), THREADS,
                       kRelPos ? relpos_smem(n, r) : SMEM, out);
}


// ---- The float32 entries ---------------------------------------------------------------
//
// softmax(Q K^T / sqrt(64) + bias) V in true f32 for f32 q/k/v (`--fp32`, the
// converter's gate): FMA on the CUDA cores, no TF32 and no wgmma, so the
// result is the plain f32 version's up to summation order.  The same three
// bias modes as the bf16 entries: none, a dense [heads, n, n] bias (bf16 or
// f32), or BEiT's [heads, r] table through the closed-form index above.
//
// Grid: (ceil(n / F_BQ) query tiles, batch * heads).  A block of 128
// threads owns F_BQ = 64 query rows of one (batch, head) and walks the keys
// in tiles of F_BKV = 64.  Both products are register-tiled outer products
// on the CUDA cores: thread (rg, cg), rg = 0..7 and cg = 0..15 (a warp is two
// rg of 16 cg, cg = lane % 16), owns rows 8rg..8rg+7 (F_TM = 8) of the block
// and, for S = Q K^T, keys cg, cg+16, cg+32, cg+48 of the tile (8 x 4
// logits), for O = P V, dims 4cg..4cg+3 (8 x 4 accumulators).  In each step
// of four dims (keys for P V) a thread loads eight float4 of its rows and
// four float4 of its keys (V rows) from shared memory and does 128 FMAs,
// 10.7 a shared float4, with 32 independent sums in flight.  A warp's loads
// are broadcasts of 2 rows, which share banks (8 rows x 68 = 0 mod 32), and
// 16 distinct K (V) rows: 24 wavefronts a step of 128 FMA instructions a
// thread.  Rows interleaved between the warp's halves (no shared bank) and
// P in a buffer of its own (one block barrier a tile, not three) each timed
// within 2% of this layout.
//
// Shared memory (F_SMEM, 84 KB): the Q tile [64][68] (rows padded by 4
// floats), staged once; two stages, each a K tile [64][68] and a V tile
// [64][64], filled by cp.async, the next tile in flight while this one is
// used (rows >= n arrive as zeros); two ints a query row (below).  The
// padding puts a warp's 16 K rows on distinct banks (68 = 4 mod 32).  For
// each tile:
//   - S from Q and the K tile; the logits scaled (and biased) into log2
//     units as in the bf16 entries, keys >= n masked to -inf;
//   - each row's max by shfl_xor over the 16 lanes sharing it; the online
//     softmax in f32 with exp2f: O's rows and the thread's partial row sums
//     (its own keys) rescaled by exp2(m_old - m_new);
//   - P = exp2(s - m) written as [64 rows][68] over the K tile (dead once
//     every warp has its logits), then O += P V from it and the V tile.
// At the end the partial sums are added over the 16 lanes of a row, O is
// normalised by 1/l and written as float4 rows.  The output is a fresh
// contiguous [batch, n, heads, 64] f32 tensor.  The table and dense entries
// are one template body and run the same steps, so the table entry equals
// the dense entry on the expanded table bit for bit.  The table entry stages
// the head's table row (times log2(e)), every key's b_j and the block's a_i
// and idx(i, 0) in shared memory; the dense entry reads the bias from global
// memory, each row's offset from shared memory, so that no row pointer holds
// registers through the products.
//
// Occupancy: ptxas takes 202-254 registers a thread (the launch bound asks
// for two blocks of 128 threads an SM, 255 at most), and two blocks of 84 KB
// (95 KB with BEiT-L's 18x32 table staged) fit the SM's 228 KB: 8 warps an
// SM.  At the flagship's [1, 778, 16, 64] the grid is 13 x 16 = 208 blocks
// on 132 SMs, one wave.  A 4-row tile a thread (F_TM = 4: 256 threads, 16
// warps an SM, held to 128 registers) times within 5% of it either way, but
// ptxas spills its dense-bias instances at 128.
//
// Strides: no tensor map, so a zero stride is allowed; each row is read as
// float4, so the pointers must be 16-byte aligned and every stride a
// multiple of 4 elements (the entries refuse anything else), with the head
// dim contiguous.
//
// What bounds it on the H100: 4 * n^2 * 64 FLOP a (batch, head) at the f32
// CUDA-core peak (67 TFLOP/s): 0.037 ms at [1, 778, 16, 64].  An SM retires
// 4 FMA instructions and 1 shared wavefront (128 bytes) a clock; at 24
// wavefronts per 128 FMA instructions the products need 75% of the shared
// pipe at the FMA peak, and FMAs are ~85% of the instructions, so the FMA
// units set its time.  It reaches about half that peak on a full card.

constexpr int F_BQ = 64;                        // query rows a block
constexpr int F_BKV = 64;                       // keys a K/V tile
constexpr int F_TM = 8;                         // query rows a thread
constexpr int F_THREADS = (F_BQ / F_TM) * 16;   // 16 threads a row group: 4 keys (dims) each
constexpr int F_MIN_BLOCKS = 2;                 // blocks an SM ptxas must allow
constexpr int F_PAD = HD + 4;                   // row stride of the Q, K and P tiles (floats)
constexpr int F_Q = F_BQ * F_PAD;               // floats of the Q tile
constexpr int F_STAGE = F_BKV * F_PAD + F_BKV * HD;  // floats of a stage: its K and V tiles
// the tiles, then 8 bytes a query row: the table's a_i and idx(i, 0), or the
// dense bias's row offset
constexpr size_t F_SMEM = (F_Q + 2 * F_STAGE + 2 * F_BQ) * sizeof(float);  // 85,504 bytes
static_assert(F_BKV == HD, "O's 4-dim columns reuse S's 16 key columns");
static_assert(F_BQ * F_PAD <= F_BKV * F_PAD, "P [F_BQ][F_PAD] must fit over a K tile");

// The f32 table entry's dynamic shared memory: the tiles, a_i and idx(i, 0)
// of the block's rows, then the head's table row (f32, R rounded up to 4) and
// every key's offset b_j.
size_t relpos_smem_f32(int n, int r) {
  return F_SMEM + (static_cast<size_t>(r) + 3) / 4 * 16 +
         static_cast<size_t>((n + F_BKV - 1) / F_BKV) * F_BKV * 4;
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// kRows rows of 64 floats from `src` (row i at src + i * stride, rows at
// or past `valid` as zeros) into shared memory at `dst`, row stride `pitch`;
// each thread issues kRows * 16 / F_THREADS float4 copies.
template <int kRows>
__device__ __forceinline__ void stage_rows(float* dst, int pitch, const float* src,
                                           long long stride, int valid) {
  constexpr int kStep = F_THREADS / (HD / 4);  // rows apart of a thread's copies
  const int r0 = threadIdx.x / (HD / 4), c = 4 * (threadIdx.x % (HD / 4));
  const float* p = src + r0 * stride + c;
#pragma unroll
  for (int i = 0; i < kRows / kStep; ++i) {
    const int row = r0 + i * kStep;
    cp_async_16(dst + row * pitch + c, row < valid ? p : src, row < valid);
    p += kStep * stride;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// BiasT: void (no bias), __nv_bfloat16 or float: a contiguous [heads, n, n]
// bias, or with kRelPos a contiguous [heads, r] table for a gh x gw grid.
template <typename BiasT, bool kRelPos>
__global__ void __launch_bounds__(F_THREADS, F_MIN_BLOCKS)
    attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, long long q_sb,
                         long long q_sn, long long q_sh, long long k_sb, long long k_sn,
                         long long k_sh, long long v_sb, long long v_sn, long long v_sh,
                         const BiasT* __restrict__ bias, int n, int heads, float scale_log2,
                         int r_entries, int gh, int gw) {
  constexpr bool kBias = !std::is_void<BiasT>::value;
  extern __shared__ __align__(16) float f_smem[];
  float* q_s = f_smem;                                                  // [F_BQ][F_PAD]
  // per query row of the block: a_i and idx(i, 0) (kRelPos), or the offset of
  // its bias row (kBias)
  int* rowa_s = reinterpret_cast<int*>(f_smem + F_Q + 2 * F_STAGE);
  int* rowc_s = rowa_s + F_BQ;
  long long* rowoff_s = reinterpret_cast<long long*>(rowa_s);
  float* tab_s = reinterpret_cast<float*>(rowc_s + F_BQ);               // kRelPos
  int* key_s = reinterpret_cast<int*>(tab_s + ((r_entries + 3) & ~3));  // kRelPos

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int lane = threadIdx.x % 32;
  const int rg = 2 * (threadIdx.x / 32) + lane / 16;  // rows F_TM rg + i of the block
  const int cg = lane % 16;                           // keys cg + 16j; dims 4cg..4cg+3
  const int q0 = blockIdx.x * F_BQ;
  const int ntiles = (n + F_BKV - 1) / F_BKV;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  // kBias: each row's offset in the bias, read from shared memory where it is
  // used, so that no row pointer holds registers through the products
  if constexpr (kBias && !kRelPos) {
    if (threadIdx.x < F_BQ)
      rowoff_s[threadIdx.x] =
          (static_cast<long long>(h) * n + min(q0 + static_cast<int>(threadIdx.x), n - 1)) * n;
  }

  // tile t's K rows into its stage's [F_BKV][F_PAD], its V rows into [F_BKV][64]
  auto load_tile = [&](int t) {
    float* st = f_smem + F_Q + (t & 1) * F_STAGE;
    const int valid = n - t * F_BKV;
    stage_rows<F_BKV>(st, F_PAD, kb + t * F_BKV * k_sn, k_sn, valid);
    stage_rows<F_BKV>(st + F_BKV * F_PAD, HD, vb + t * F_BKV * v_sn, v_sn, valid);
    cp_async_commit();
  };
  stage_rows<F_BQ>(q_s, F_PAD, q + b * q_sb + q0 * q_sn + h * q_sh, q_sn, n - q0);
  load_tile(0);

  // The table entry: the head's row (times log2(e)), every key's b_j and the
  // block's a_i and idx(i, 0) (m_i is 0 on the cls row only), visible after
  // the first tile's barrier.  A row >= n takes row n-1's (its output is
  // dropped), as it takes row n-1's dense bias (above).
  if constexpr (kRelPos) {
    const BiasT* trow = bias + static_cast<long long>(h) * r_entries;
    for (int t = threadIdx.x; t < r_entries; t += F_THREADS) tab_s[t] = bias_at(trow + t) * LOG2E;
    for (int c = threadIdx.x; c < ntiles * F_BKV; c += F_THREADS)
      key_s[c] = relpos_key_offset(c, n, gw);
    if (threadIdx.x < F_BQ) {
      int m_unused;
      relpos_row(min(q0 + static_cast<int>(threadIdx.x), n - 1), gh, gw, r_entries,
                 rowa_s[threadIdx.x], m_unused, rowc_s[threadIdx.x]);
    }
  }

  float acc[F_TM][4];   // O: rows F_TM rg + i, dims 4cg + j
  float m_run[F_TM];    // running max of each row's log2-unit logits
  float l_run[F_TM];    // this thread's share of each row's sum of their exp2
#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t (and Q) landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_tile(t + 1);
    float* k_t = f_smem + F_Q + (t & 1) * F_STAGE;
    const float* v_t = k_t + F_BKV * F_PAD;
    const int key0 = t * F_BKV;

    // S = Q K^T: 16 steps of 4 dims, 16 F_TM FMAs a step
    float s[F_TM][4];
#pragma unroll
    for (int i = 0; i < F_TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qa[F_TM], kv[4];
#pragma unroll
      for (int i = 0; i < F_TM; ++i) qa[i] = ld4(q_s + (F_TM * rg + i) * F_PAD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ld4(k_t + (cg + 16 * j) * F_PAD + d);
#pragma unroll
      for (int i = 0; i < F_TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale and bias into log2 units, mask, and the online softmax
    int koff[4];
    if constexpr (kRelPos) {
#pragma unroll
      for (int j = 0; j < 4; ++j) koff[j] = key_s[key0 + cg + 16 * j];
    }
#pragma unroll
    for (int i = 0; i < F_TM; ++i) {
      const int row = q0 + F_TM * rg + i;
      // kBias: one row's four bias loads in flight at a time (the dense
      // instances take the most registers)
      if constexpr (kBias && !kRelPos) asm volatile("" ::: "memory");
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + cg + 16 * j;
        float x = s[i][j];
        if constexpr (kRelPos) {  // s' = s * scale * log2(e) + T[idx] * log2(e)
          const int idx = key == 0 ? rowc_s[F_TM * rg + i]
                                   : rowa_s[F_TM * rg + i] - (row != 0) * koff[j];
          x = fmaf(x, scale_log2, tab_s[idx]);
        } else if constexpr (kBias) {  // s' = s * scale * log2(e) + bias * log2(e)
          const BiasT* brow = bias + rowoff_s[F_TM * rg + i];
          x = fmaf(x, scale_log2, key < n ? bias_at(brow + key) * LOG2E : 0.0f);
        } else {
          x *= scale_log2;
        }
        s[i][j] = key < n ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f(m_run[i] - mx);  // 0 on the first tile
      m_run[i] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - mx);
        sum += s[i][j];
      }
      l_run[i] = fmaf(l_run[i], alpha, sum);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every warp has its logits: the K tile becomes P
    float* p_s = k_t;  // [F_BQ][F_PAD]
#pragma unroll
    for (int i = 0; i < F_TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p_s[(F_TM * rg + i) * F_PAD + cg + 16 * j] = s[i][j];
    __syncthreads();

    // O += P V: 16 steps of 4 keys, 16 F_TM FMAs a step
#pragma unroll
    for (int c = 0; c < F_BKV; c += 4) {
      float4 pa[F_TM], vv[4];
#pragma unroll
      for (int i = 0; i < F_TM; ++i) pa[i] = ld4(p_s + (F_TM * rg + i) * F_PAD + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = ld4(v_t + (c + j) * HD + 4 * cg);
#pragma unroll
      for (int i = 0; i < F_TM; ++i) {
        const float p4[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(p4[j], vv[j].x, acc[i][0]);
          acc[i][1] = fmaf(p4[j], vv[j].y, acc[i][1]);
          acc[i][2] = fmaf(p4[j], vv[j].z, acc[i][2]);
          acc[i][3] = fmaf(p4[j], vv[j].w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < F_TM; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 1; off < 16; off *= 2) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int qrow = q0 + F_TM * rg + i;
    if (qrow >= n) continue;
    const float inv_l = 1.0f / l;
    float* dst = o + ((static_cast<long long>(b) * n + qrow) * heads + h) * HD + 4 * cg;
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[i][0] * inv_l, acc[i][1] * inv_l, acc[i][2] * inv_l, acc[i][3] * inv_l);
  }
}

template <typename BiasT, bool kRelPos>
const void* f32_kernel_entry() {
  return reinterpret_cast<const void*>(attention_f32_kernel<BiasT, kRelPos>);
}

// Sets the instance's shared-memory limit and carveout once; its result thereafter.
template <typename BiasT, bool kRelPos>
cudaError_t prepare_f32() {
  static const cudaError_t attr = [] {
    const void* fn = f32_kernel_entry<BiasT, kRelPos>();
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM_MAX));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return attr;
}

bool f32_operand_ok(const void* p, const long long* st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (st[0] | st[1] | st[2]) % 4 == 0;
}

// Launches the f32 instance; `bias` is the dense bias or the table, `r`,
// `gh` and `gw` the table's (0 otherwise).
template <typename BiasT, bool kRelPos>
int launch_f32(const void* q, const void* k, const void* v, void* o, const void* bias, int batch,
               int n, int heads, const long long* qs, const long long* ks, const long long* vs,
               float scale, int r, int gh, int gw, void* stream) {
  const cudaError_t attr = prepare_f32<BiasT, kRelPos>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = kRelPos ? relpos_smem_f32(n, r) : F_SMEM;
  if (smem > SMEM_MAX || n < 1 || batch * heads > 65535 || !f32_operand_ok(q, qs) ||
      !f32_operand_ok(k, ks) || !f32_operand_ok(v, vs) || reinterpret_cast<uintptr_t>(o) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + F_BQ - 1) / F_BQ, batch * heads);
  attention_f32_kernel<BiasT, kRelPos>
      <<<grid, F_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      static_cast<const BiasT*>(bias), n, heads, scale * LOG2E, r, gh, gw);
  return static_cast<int>(cudaGetLastError());
}

// As `info`, for an f32 instance.
template <typename BiasT, bool kRelPos>
int info_f32(int n, int r, int* out) {
  return kernel_report(prepare_f32<BiasT, kRelPos>(), f32_kernel_entry<BiasT, kRelPos>(),
                       F_THREADS, kRelPos ? relpos_smem_f32(n, r) : F_SMEM, out);
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

// The f32 entries: as d2s_attention_fwd, d2s_attention_bias_fwd and
// d2s_attention_relpos_fwd, for f32 q/k/v (16-byte aligned pointers,
// strides in multiples of 4 elements) and a contiguous f32 output.
int d2s_attention_f32_fwd(const void* q, const void* k, const void* v, void* o, int batch, int n,
                          int heads, long long q_sb, long long q_sn, long long q_sh,
                          long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                          long long v_sn, long long v_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  return launch_f32<void, false>(q, k, v, o, nullptr, batch, n, heads, qs, ks, vs, scale, 0, 0, 0,
                                 stream);
}

int d2s_attention_bias_f32_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                               int n, int heads, long long q_sb, long long q_sn, long long q_sh,
                               long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                               long long v_sn, long long v_sh, float scale, const void* bias,
                               int bias_f32, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  if (bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bias_f32 ? launch_f32<float, false>(q, k, v, o, bias, batch, n, heads, qs, ks, vs, scale,
                                             0, 0, 0, stream)
                  : launch_f32<__nv_bfloat16, false>(q, k, v, o, bias, batch, n, heads, qs, ks,
                                                     vs, scale, 0, 0, 0, stream);
}

int d2s_attention_relpos_f32_fwd(const void* q, const void* k, const void* v, void* o, int batch,
                                 int n, int heads, long long q_sb, long long q_sn, long long q_sh,
                                 long long k_sb, long long k_sn, long long k_sh, long long v_sb,
                                 long long v_sn, long long v_sh, float scale, const void* table,
                                 int table_f32, int r, int gh, int gw, void* stream) {
  const long long qs[3] = {q_sb, q_sn, q_sh}, ks[3] = {k_sb, k_sn, k_sh},
                  vs[3] = {v_sb, v_sn, v_sh};
  if (table == nullptr || gh < 1 || gw < 1 || n != gh * gw + 1 ||
      r != (2 * gh - 1) * (2 * gw - 1) + 3)
    return static_cast<int>(cudaErrorInvalidValue);
  return table_f32 ? launch_f32<float, true>(q, k, v, o, table, batch, n, heads, qs, ks, vs,
                                             scale, r, gh, gw, stream)
                   : launch_f32<__nv_bfloat16, true>(q, k, v, o, table, batch, n, heads, qs, ks,
                                                     vs, scale, r, gh, gw, stream);
}

// out[4] = registers a thread, local bytes a thread (spills), dynamic shared
// memory bytes and resident blocks an SM, for entry 0 (no bias), 1 (dense
// bias) or 2 (table) of the bf16 kernel, or 3, 4 or 5 of the f32 one, with a
// bf16 (f32 = 0) or f32 bias or table, at n tokens and r table entries.
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
    case 6:
    case 7:
      return info_f32<void, false>(n, r, out);
    case 8:
      return info_f32<__nv_bfloat16, false>(n, r, out);
    case 9:
      return info_f32<float, false>(n, r, out);
    case 10:
      return info_f32<__nv_bfloat16, true>(n, r, out);
    case 11:
      return info_f32<float, true>(n, r, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
