// Row-segment tiles for the DIBR kernels (dibr_pair.cu, K1; dibr_fill.cu, K5).
//
// A block owns a segment [s0, s0 + seg) of one row and stages the columns
// [s0 - halo, s0 + seg + halo) once in shared memory, clamp-to-edge at the
// frame's ends, as float4 {r, g, b, 1 - d} plus the raw depth as a float row
// (the centre smooth and the jump read raw depth, which 1 - (1 - d) does not
// give back exactly).  Each thread owns kPix consecutive pixels and walks the
// staged columns once per sweep, in the sweep's own direction, so that one
// shared-memory load feeds up to kPix pixels and every pixel still receives
// its taps in the order t = 1, 2, ...: its arithmetic is that of a thread
// per pixel reading the same values from global memory.
//
// Layout: staged column l (0-based from s0 - halo) sits at float4 slot
// l + l / 4.  Thread i's pixels start at l = 4 * (i + halo / 4), so its
// window starts at slot 5 * (i + halo / 4): a quarter-warp's eight 16-byte
// loads land 80 bytes apart, on eight distinct bank quads, and a float4 load
// of a column offset that is known at compile time is conflict-free.
//
// The launch geometry (seg, halo, threads, shared bytes, grid) is computed by
// the Python wrappers (ops/kernels/dibr.py:tile_geometry) and checked here.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace d2s_tile {

constexpr int kPix = 4;            // consecutive pixels a thread
constexpr int kMaxThreads = 256;   // threads a block, the kernels' __launch_bounds__
constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may use

struct Geometry {
  int seg;      // pixels a block owns (a multiple of kPix)
  int halo;     // staged columns each side (a multiple of 4, >= 4)
  int threads;  // threads a block
  int smem;     // dynamic shared-memory bytes
  int grid_x;   // blocks a row
};

__host__ __device__ constexpr int tile_slots(int cols) { return cols + cols / 4; }

inline int smem_bytes(int seg, int halo) {
  const int cols = seg + 2 * halo;
  return 16 * tile_slots(cols) + 4 * cols;
}

// The checks the wrappers' geometry has to pass; min_halo is the farthest
// horizontal tap of the call.
inline bool geometry_ok(const Geometry& g, int width, int pix, int min_halo) {
  return pix == kPix && width >= 1 && g.seg >= kPix && g.seg % kPix == 0 &&
         g.halo >= min_halo && g.halo >= 4 && g.halo % 4 == 0 && g.threads >= 1 &&
         g.threads <= kMaxThreads && g.threads * kPix <= g.seg &&
         g.smem == smem_bytes(g.seg, g.halo) && g.smem <= kMaxSmem &&
         g.grid_x == (width + g.seg - 1) / g.seg;
}

// Allow the kernel the dynamic shared memory the geometry asks for (above
// 48 KB it has to be asked for once per kernel and size).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

__device__ __forceinline__ int slot(int l) { return l + (l >> 2); }

// floor(c / 4) of a column offset known at compile time (negative too)
__host__ __device__ constexpr int floor4(int c) { return c >= 0 ? c / 4 : -((3 - c) / 4); }

// The staged tile of one block: float4 {r, g, b, 1 - d} slots, then the raw
// depth row.
struct Tile {
  float4* cols;
  float* depth;
};

__device__ __forceinline__ Tile tile_of(float4* smem, const Geometry& g) {
  return Tile{smem, reinterpret_cast<float*>(smem + tile_slots(g.seg + 2 * g.halo))};
}

// Stage columns [lo, lo + seg + 2*halo) of one row, clamped to [0, W-1];
// load(x) returns {r, g, b, d} of column x.  Consecutive threads take
// consecutive columns, so the global reads of a warp are contiguous.
template <class Load>
__device__ __forceinline__ void stage(const Tile& t, const Geometry& g, int lo, int W,
                                      Load load) {
  const int cols = g.seg + 2 * g.halo;
  for (int l = threadIdx.x; l < cols; l += blockDim.x) {
    const int x = min(max(lo + l, 0), W - 1);
    const float4 v = load(x);
    t.cols[slot(l)] = make_float4(v.x, v.y, v.z, 1.0f - v.w);
    t.depth[l] = v.w;
  }
}

// Raw depth at the thread's pixels - 4 .. + 7 (win[4 + j] is pixel j), from
// three aligned float4 loads; q = i + halo / 4 for thread-group i.
__device__ __forceinline__ void depth_window(const Tile& t, int q, float win[12]) {
  const float4* d4 = reinterpret_cast<const float4*>(t.depth);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 v = d4[q - 1 + k];
    win[4 * k] = v.x;
    win[4 * k + 1] = v.y;
    win[4 * k + 2] = v.z;
    win[4 * k + 3] = v.w;
  }
}

// The staged column at offset c (compile-time) from the thread's first pixel.
__device__ __forceinline__ float4 column(const Tile& t, int q5, int c) {
  return t.cols[q5 + c + floor4(c)];
}

// 1: a sweep stops once no pixel of the warp can take another tap (0 walks
// every column; kernel_ab.py --variant compares the two)
#ifndef D2S_DIBR_SWEEP_STOP
#define D2S_DIBR_SWEEP_STOP 1
#endif

// One sweep of kPix pixels over the staged columns.  kDir = -1 visits the
// columns from the last pixel - 1 down to the first pixel - kMaxR; kDir = +1
// from the first pixel + 1 up to the last + kMaxR.  Pixel j receives the
// column at distance t = |c - j| (1 <= t <= radius) as tap(j, t, column), in
// the order t = 1, 2, ... .  radius <= kMaxR; columns past the last one any
// pixel needs are not loaded.
//
// done() is true when none of the thread's pixels can take a tap any more
// (each pixel's running weight is past its gate, which only grows, or the
// pixel's sweep result is not used).  The sweep ends when done() holds on
// every active lane of the warp: before the first column, and after each
// column from the one that gives every pixel its first tap.  The taps it
// skips would all have been gated off, so the result is that of the full
// walk.
template <int kDir, int kMaxR, class Tap, class Done>
__device__ __forceinline__ void sweep(const Tile& t, int q5, int radius, Tap tap, Done done) {
  if (D2S_DIBR_SWEEP_STOP && __all_sync(__activemask(), done())) return;
#pragma unroll
  for (int k = 1; k <= kMaxR + kPix - 1; ++k) {
    if (k > radius + kPix - 1) break;
    const int c = kDir < 0 ? kPix - 1 - k : k;
    const float4 v = column(t, q5, c);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int d = kDir < 0 ? j - c : c - j;
      if (d >= 1 && d <= kMaxR && d <= radius) tap(j, d, v);
    }
    if (D2S_DIBR_SWEEP_STOP && k >= kPix && __all_sync(__activemask(), done())) break;
  }
}

// kPix consecutive floats at row[x0 ..]: one float4 where `vec` (every row
// and pointer 16-byte aligned, so x0 + 3 < W), else scalar loads clamped
// to column W - 1 (what the masked tail pixels read is never stored).
__device__ __forceinline__ void load_pix(const float* __restrict__ row, int x0, int W,
                                         bool vec, float out[kPix]) {
  if (vec) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + x0));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) out[j] = __ldg(row + min(x0 + j, W - 1));
  }
}

// kPix consecutive HWC pixels (3 floats each) at row[3 * x0 ..]: three
// float4 where `vec`, else clamped scalar loads.
__device__ __forceinline__ void load_pix3(const float* __restrict__ row, int x0, int W,
                                          bool vec, float out[kPix][3]) {
  if (vec) {
    const float4* r4 = reinterpret_cast<const float4*>(row + 3 * x0);
    float f[12];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 v = __ldg(r4 + k);
      f[4 * k] = v.x;
      f[4 * k + 1] = v.y;
      f[4 * k + 2] = v.z;
      f[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c) out[j][c] = f[3 * j + c];
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const int x = min(x0 + j, W - 1);
#pragma unroll
      for (int c = 0; c < 3; ++c) out[j][c] = __ldg(row + 3 * x + c);
    }
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace d2s_tile
