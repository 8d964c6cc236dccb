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
// that is carried over: one thread per pixel, clamp-to-edge indexing on the
// true H x W frame (the edge padding replicated the last row and column, so
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
// What bounds it on the H100: at 4K (2160 x 3840) it must read rgb (100 MB)
// and depth, confidence and position (33 MB each) and write 100 MB: ~89 us
// at 3.35 TB/s.  Each pixel's 24 sweep taps, 4 vertical taps and 2 warp
// gathers hit neighbouring addresses, which L1/L2 serve; row tiles in shared
// memory are the next step if it turns out cache-bound.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxRadius = 32;
constexpr int kVShift = 2;  // vertical blur tap distance (rows)

struct FillParams {
  int height, width;
  int sign;            // direction of the depth-weighted sweep (+1 / -1)
  int radius;          // taps per sweep
  float tol;           // depth_tolerance
  float tol_half;      // depth_tolerance * 0.5
  float fwd_w[kMaxRadius];  // exp(-t*0.15)
  float bwd_w[kMaxRadius];  // exp(-t*0.2)
};

__global__ void dibr_fill_kernel(const float* __restrict__ rgb,
                                 const float* __restrict__ dep,
                                 const float* __restrict__ conf,
                                 const float* __restrict__ px,
                                 float* __restrict__ out, FillParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int W = p.width;
  const int H = p.height;
  if (x >= W) return;

  const size_t pix = (size_t)y * W + x;
  const float* row_d = dep + (size_t)y * W;
  const float* row_r = rgb + (size_t)y * W * 3;
  auto cx = [W](int xx) { return min(max(xx, 0), W - 1); };
  auto cy = [H](int yy) { return min(max(yy, 0), H - 1); };

  // --- warp: bilinear at px (already clamped to [0, W-1]) ----------------
  const float pp = px[pix];
  const float x0 = floorf(pp);
  const float frac = pp - x0;
  const int i0 = min(max((int)x0, 0), W - 1);
  const int i1 = min(i0 + 1, W - 1);
  float color[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    color[c] = row_r[i0 * 3 + c] * (1.0f - frac) + row_r[i1 * 3 + c] * frac;

  // --- centre depth: symmetric 3-tap smooth of RAW depth ------------------
  const float d0 = row_d[x];
  const float htap = (row_d[cx(x + 1)] * 0.5f + row_d[cx(x + 2)] * 0.5f) +
                     (row_d[cx(x - 1)] * 0.5f + row_d[cx(x - 2)] * 0.5f);
  const float cdi = -(d0 * 0.7f + htap * 0.15f);
  const float thr = cdi + p.tol;

  // --- push-pull sweeps over RAW depth ------------------------------------
  float fwd[3] = {0.0f, 0.0f, 0.0f}, fwd_w = 0.0f;
  for (int t = 1; t <= p.radius; ++t) {  // depth-weighted, decay 0.15
    const int xs = cx(x + p.sign * t);
    const float s_inv = 1.0f - row_d[xs];
    if (s_inv > thr && fwd_w <= 5.0f) {
      const float w = p.fwd_w[t - 1] * (1.0f + (s_inv - cdi) * 10.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c) fwd[c] = fwd[c] + row_r[xs * 3 + c] * w;
      fwd_w = fwd_w + w;
    }
  }
  float bwd[3] = {0.0f, 0.0f, 0.0f}, bwd_w = 0.0f;
  for (int t = 1; t <= p.radius; ++t) {  // opposite direction, plain decay 0.2
    const int xs = cx(x - p.sign * t);
    const float s_inv = 1.0f - row_d[xs];
    if (s_inv > thr && bwd_w <= 5.0f) {
      const float w = p.bwd_w[t - 1];
#pragma unroll
      for (int c = 0; c < 3; ++c) bwd[c] = bwd[c] + row_r[xs * 3 + c] * w;
      bwd_w = bwd_w + w;
    }
  }
  const bool need_bwd = fwd_w < 2.0f;
  const float best_w = fwd_w + (need_bwd ? bwd_w : 0.0f);
  const bool found = best_w > 0.01f;
  const float inv_w = 1.0f / fmaxf(best_w, 1e-12f);
  float vert[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    vert[c] = ((fwd[c] + (need_bwd ? bwd[c] : 0.0f)) * inv_w) * 0.5f;

  // --- vertical blur taps at -+kVShift rows (RAW depth) -------------------
  float vert_w = 0.5f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yy = cy(k == 0 ? y - kVShift : y + kVShift);
    const float v_raw = dep[(size_t)yy * W + x];
    if ((1.0f - v_raw) > cdi + p.tol_half) {
      const float* v_rgb = rgb + ((size_t)yy * W + x) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) vert[c] = vert[c] + v_rgb[c] * 0.25f;
      vert_w = vert_w + 0.25f;
    }
  }
  const float inv_vw = 1.0f / vert_w;

  // --- confidence blend ----------------------------------------------------
  const float cf = conf[pix];
  float* o = out + pix * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float filled = found ? vert[c] * inv_vw : row_r[x * 3 + c];
    o[c] = color[c] + cf * (filled - color[c]);
  }
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rgb, out: contiguous [height, width, 3] f32 (0..255); dep (RAW depth),
// conf, px: contiguous [height, width] f32; sign: +1 or -1; radius <= 32.
int d2s_dibr_warp_fill_blend(const void* rgb, const void* dep, const void* conf,
                             const void* px, void* out, int height, int width,
                             int sign, int radius, double depth_tolerance,
                             void* stream) {
  if (radius < 0 || radius > kMaxRadius) return (int)cudaErrorInvalidValue;
  FillParams p;
  p.height = height;
  p.width = width;
  p.sign = sign;
  p.radius = radius;
  // Constants rounded from double exactly as the TPU kernel's Python floats
  // are when they meet f32 arrays.
  p.tol = (float)depth_tolerance;
  p.tol_half = (float)(depth_tolerance * 0.5);
  for (int t = 1; t <= kMaxRadius; ++t) {
    p.fwd_w[t - 1] = (float)exp(-(double)t * 0.15);
    p.bwd_w[t - 1] = (float)exp(-(double)t * 0.2);
  }
  const dim3 block(128);
  const dim3 grid((width + block.x - 1) / block.x, height);
  dibr_fill_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(dep),
      static_cast<const float*>(conf), static_cast<const float*>(px),
      static_cast<float*>(out), p);
  return (int)cudaGetLastError();
}

}  // extern "C"
