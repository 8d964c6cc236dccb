// One stereo eye: bilinear colour warp at a given position, directional
// push-pull background inpaint over RAW depth, vertical blur, and the
// disocclusion-confidence blend.
//
// Replaces: desktop2stereo_tpu/ops/pallas/dibr.py:dibr_warp_fill_blend
// (kernel body _dibr_kernel), the TPU body of the per-eye
// ops/stereo.py:dibr_render.  The TPU kernel owns a full-width row tile in
// VMEM, takes +-1 tile row halos for the vertical taps, and decomposes the
// data-dependent warp into lane-group gathers over an edge- and
// tile-padded frame.  On the GPU the warp is a plain indexed load, so none of
// that is carried over: a block stages a segment of one row, each thread
// computes 4 consecutive pixels, clamp-to-edge indexing on the true H x W
// frame (the edge padding replicated the last row and column, so
// the values are the same).  The TPU's disparity bound (max_disp) only sized
// its gather and has no meaning here.
//
// Semantics kept from the TPU kernel: the centre depth is the symmetric
// 3-tap smooth at +-1.5 px of RAW depth; the sweep taps and the vertical taps
// read RAW depth; a tap joins a sweep while the running weight is <= 5; the
// opposite sweep joins where the first found weight < 2.  Float operations
// follow the TPU kernel's order, and the file is built with -fmad=false so
// that no multiply-add is contracted: the tap and threshold decisions then
// round as in the plain PyTorch version (dibr_warp_fill_blend_ref).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): not HBM.  At 4K
// (2160 x 3840) it must read rgb (100 MB) and depth, confidence and position
// (33 MB each) and write 100 MB: 89 us at 3.35 TB/s.  A thread a pixel (the
// previous design) issued ~110 scalar loads a pixel from global memory, its
// rgb as HWC triples at a 12-byte stride, its tap loop over a runtime radius
// (not unrolled) and its weights indexed at run time: L1 wavefronts and
// issue, 0.282 ms.  The design is K1's (dibr_tile.cuh): a block stages a
// 512-pixel row segment once in shared memory as float4 {r, g, b, 1 - d},
// each thread walks the staged columns once per sweep for 4 consecutive
// pixels and its warp leaves a sweep once none of its pixels can take a tap,
// the tap loop is unrolled with the weights as constants for the radius
// dibr_render uses (12), with a generic instantiation of the same kernel for
// any other radius up to 32, and the position, confidence, vertical taps and
// output move as float4 where the rows are aligned.  When one block holds the
// whole row the warp gathers read the staged row too.  Measured in one call
// with the thread-per-pixel kernel (kernel_ab.py, graph-timed): 0.155 ms
// against 0.282, 57% of its bound; 64 registers (32 warps an SM) with 24
// bytes of spill (PERF.md).
//
// The launch geometry comes from the wrapper (ops/kernels/dibr.py:
// tile_geometry) and is checked here; a mismatch returns
// cudaErrorInvalidValue.  Every pixel's float operations are those of the
// earlier thread-per-pixel kernel in the same order, so the output is
// bit-identical to it.

#include <cuda_runtime.h>
#include <math.h>

#include "dibr_tile.cuh"

namespace {

using namespace d2s_tile;

constexpr int kMaxRadius = 32;
constexpr int kFixedRadius = 12;  // dibr_render's search radius
constexpr int kVShift = 2;        // vertical blur tap distance (rows)

// Blocks of kMaxThreads an SM the compiler has to fit: 4 caps the kernel at
// 64 registers (32 warps an SM); it is latency-bound (PERF.md;
// kernel_ab.py --variant measures other values).
#ifndef D2S_DIBR_MIN_BLOCKS
#define D2S_DIBR_MIN_BLOCKS 4
#endif

struct FillParams {
  int height, width;
  int radius;          // taps per sweep
  int vec;             // rows and pointers 16-byte aligned: float4 access
  float tol;           // depth_tolerance
  float tol_half;      // depth_tolerance * 0.5
  float fwd_w[kMaxRadius];  // exp(-t*0.15)
  float bwd_w[kMaxRadius];  // exp(-t*0.2)
};

// The kPix pixels x0 .. x0+3 of row y (thread-group i of the block whose
// segment starts at s0).  kR: the radius, or 0 for p.radius (<= 32);
// kSign: the direction of the depth-weighted sweep.
template <int kR, int kSign>
__device__ __forceinline__ void fill_pixels(const Tile& t, const Geometry& g,
                                            const FillParams& p,
                                            const float* __restrict__ rgb,
                                            const float* __restrict__ dep,
                                            const float* __restrict__ conf,
                                            const float* __restrict__ px,
                                            float* __restrict__ out, int y, int s0, int i,
                                            bool row_in_smem) {
  constexpr int kMaxR = kR ? kR : kMaxRadius;
  const int radius = kR ? kR : p.radius;
  const int W = p.width;
  const int H = p.height;
  const int x0 = s0 + kPix * i;
  const int q = i + g.halo / 4;
  const int q5 = 5 * q;
  const bool vec = p.vec;
  const size_t pix = (size_t)y * W + x0;

  // --- centre depth: symmetric 3-tap smooth of RAW depth ------------------
  float win[12];
  depth_window(t, q, win);
  float cdi[kPix], thr[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float htap = (win[5 + j] * 0.5f + win[6 + j] * 0.5f) +
                       (win[3 + j] * 0.5f + win[2 + j] * 0.5f);
    cdi[j] = -(win[4 + j] * 0.7f + htap * 0.15f);
    thr[j] = cdi[j] + p.tol;
  }

  // --- push-pull sweeps over the staged columns ---------------------------
  float fwd[kPix][3] = {}, fwd_w[kPix] = {};
  float bwd[kPix][3] = {}, bwd_w[kPix] = {};
  // depth-weighted, decay 0.15, in the direction of sign
  sweep<kSign, kMaxR>(t, q5, radius, [&](int j, int tap, float4 v) {
    if (v.w > thr[j] && fwd_w[j] <= 5.0f) {
      const float w = p.fwd_w[tap - 1] * (1.0f + (v.w - cdi[j]) * 10.0f);
      fwd[j][0] = fwd[j][0] + v.x * w;
      fwd[j][1] = fwd[j][1] + v.y * w;
      fwd[j][2] = fwd[j][2] + v.z * w;
      fwd_w[j] = fwd_w[j] + w;
    }
  }, [&] {
    bool d = true;
#pragma unroll
    for (int j = 0; j < kPix; ++j) d = d && !(fwd_w[j] <= 5.0f);
    return d;
  });
  // opposite direction, plain decay 0.2; read only where the first sweep
  // found a weight below 2
  sweep<-kSign, kMaxR>(t, q5, radius, [&](int j, int tap, float4 v) {
    if (v.w > thr[j] && bwd_w[j] <= 5.0f) {
      const float w = p.bwd_w[tap - 1];
      bwd[j][0] = bwd[j][0] + v.x * w;
      bwd[j][1] = bwd[j][1] + v.y * w;
      bwd[j][2] = bwd[j][2] + v.z * w;
      bwd_w[j] = bwd_w[j] + w;
    }
  }, [&] {
    bool d = true;
#pragma unroll
    for (int j = 0; j < kPix; ++j) d = d && (!(fwd_w[j] < 2.0f) || !(bwd_w[j] <= 5.0f));
    return d;
  });
  float vert[kPix][3], vert_w[kPix];
  bool found[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const bool need_bwd = fwd_w[j] < 2.0f;
    const float best_w = fwd_w[j] + (need_bwd ? bwd_w[j] : 0.0f);
    found[j] = best_w > 0.01f;
    const float inv_w = 1.0f / fmaxf(best_w, 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      vert[j][c] = ((fwd[j][c] + (need_bwd ? bwd[j][c] : 0.0f)) * inv_w) * 0.5f;
    vert_w[j] = 0.5f;
  }

  // --- vertical blur taps at -+kVShift rows (RAW depth) -------------------
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yy = min(max(k == 0 ? y - kVShift : y + kVShift, 0), H - 1);
    float v_raw[kPix], v_rgb[kPix][3];
    load_pix(dep + (size_t)yy * W, x0, W, vec, v_raw);
    load_pix3(rgb + (size_t)yy * W * 3, x0, W, vec, v_rgb);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if ((1.0f - v_raw[j]) > cdi[j] + p.tol_half) {
#pragma unroll
        for (int c = 0; c < 3; ++c) vert[j][c] = vert[j][c] + v_rgb[j][c] * 0.25f;
        vert_w[j] = vert_w[j] + 0.25f;
      }
    }
  }

  // --- warp at px (already clamped to [0, W-1]) and confidence blend -----
  float pp[kPix], cf[kPix];
  load_pix(px + (size_t)y * W, x0, W, vec, pp);
  load_pix(conf + (size_t)y * W, x0, W, vec, cf);
  const float* row_r = rgb + (size_t)y * W * 3;
  float val[kPix][3];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float x0f = floorf(pp[j]);
    const float frac = pp[j] - x0f;
    const int i0 = min(max((int)x0f, 0), W - 1);
    const int i1 = min(i0 + 1, W - 1);
    float g0[3], g1[3];
    if (row_in_smem) {  // the block staged the whole row: s0 = 0
      const float4 a = t.cols[slot(i0 + g.halo)];
      const float4 b = t.cols[slot(i1 + g.halo)];
      g0[0] = a.x; g0[1] = a.y; g0[2] = a.z;
      g1[0] = b.x; g1[1] = b.y; g1[2] = b.z;
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g0[c] = __ldg(row_r + i0 * 3 + c);
        g1[c] = __ldg(row_r + i1 * 3 + c);
      }
    }
    const float inv_vw = 1.0f / vert_w[j];
    const float4 centre = column(t, q5, j);
    const float own[3] = {centre.x, centre.y, centre.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float color = g0[c] * (1.0f - frac) + g1[c] * frac;
      const float filled = found[j] ? vert[j][c] * inv_vw : own[c];
      val[j][c] = color + cf[j] * (filled - color);
    }
  }
  float* o = out + pix * 3;
  if (vec) {  // 12 floats, 16-byte aligned: three float4 stores
#pragma unroll
    for (int k = 0; k < 3; ++k)
      reinterpret_cast<float4*>(o)[k] =
          make_float4(val[(4 * k) / 3][(4 * k) % 3], val[(4 * k + 1) / 3][(4 * k + 1) % 3],
                      val[(4 * k + 2) / 3][(4 * k + 2) % 3],
                      val[(4 * k + 3) / 3][(4 * k + 3) % 3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (x0 + j < W)
#pragma unroll
        for (int c = 0; c < 3; ++c) o[3 * j + c] = val[j][c];
  }
}

template <int kR, int kSign>
__global__ void __launch_bounds__(kMaxThreads, D2S_DIBR_MIN_BLOCKS)
    dibr_fill_kernel(const float* __restrict__ rgb, const float* __restrict__ dep,
                     const float* __restrict__ conf, const float* __restrict__ px,
                     float* __restrict__ out, const __grid_constant__ FillParams p,
                     const __grid_constant__ Geometry g) {
  extern __shared__ float4 smem[];
  const Tile t = tile_of(smem, g);
  const int W = p.width;
  const int y = blockIdx.y;
  const float* row_d = dep + (size_t)y * W;
  const float* row_r = rgb + (size_t)y * W * 3;
  const int s0 = blockIdx.x * g.seg;
  stage(t, g, s0 - g.halo, W, [&](int x) {
    return make_float4(row_r[3 * x], row_r[3 * x + 1], row_r[3 * x + 2], row_d[x]);
  });
  __syncthreads();
  const bool row_in_smem = g.seg >= W;
  const int end = min(s0 + g.seg, W);
  for (int i = threadIdx.x; s0 + kPix * i < end; i += blockDim.x)
    fill_pixels<kR, kSign>(t, g, p, rgb, dep, conf, px, out, y, s0, i, row_in_smem);
}

template <int kR, int kSign>
int launch(const void* rgb, const void* dep, const void* conf, const void* px, void* out,
           const FillParams& p, const Geometry& g, void* stream) {
  static int allowed = 0;
  const cudaError_t err = allow_smem(dibr_fill_kernel<kR, kSign>, g.smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  dibr_fill_kernel<kR, kSign><<<dim3(g.grid_x, p.height), g.threads, g.smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(dep),
      static_cast<const float*>(conf), static_cast<const float*>(px),
      static_cast<float*>(out), p, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rgb, out: contiguous [height, width, 3] f32 (0..255); dep (RAW depth),
// conf, px: contiguous [height, width] f32; sign: +1 or -1; radius <= 32.
// seg .. grid_x: the launch geometry of ops/kernels/dibr.py:tile_geometry
// (pix = 4, halo >= radius).
int d2s_dibr_warp_fill_blend(const void* rgb, const void* dep, const void* conf,
                             const void* px, void* out, int height, int width,
                             int sign, int radius, double depth_tolerance, int seg,
                             int halo, int pix, int threads, int smem, int grid_x,
                             void* stream) {
  const Geometry g{seg, halo, threads, smem, grid_x};
  if (radius < 0 || radius > kMaxRadius || (sign != 1 && sign != -1) || height < 1 ||
      height > 65535 || !geometry_ok(g, width, pix, radius))
    return (int)cudaErrorInvalidValue;
  FillParams p;
  p.height = height;
  p.width = width;
  p.radius = radius;
  p.vec = width % 4 == 0 && aligned16(rgb) && aligned16(dep) && aligned16(conf) &&
          aligned16(px) && aligned16(out);
  // Constants rounded from double exactly as the TPU kernel's Python floats
  // are when they meet f32 arrays.
  p.tol = (float)depth_tolerance;
  p.tol_half = (float)(depth_tolerance * 0.5);
  for (int t = 1; t <= kMaxRadius; ++t) {
    p.fwd_w[t - 1] = (float)exp(-(double)t * 0.15);
    p.bwd_w[t - 1] = (float)exp(-(double)t * 0.2);
  }
  if (radius == kFixedRadius)
    return sign > 0 ? launch<kFixedRadius, 1>(rgb, dep, conf, px, out, p, g, stream)
                    : launch<kFixedRadius, -1>(rgb, dep, conf, px, out, p, g, stream);
  return sign > 0 ? launch<0, 1>(rgb, dep, conf, px, out, p, g, stream)
                  : launch<0, -1>(rgb, dep, conf, px, out, p, g, stream);
}

}  // extern "C"
