// Both stereo eyes in one pass: depth pre-smooth and shaping, edge falloff,
// disocclusion confidence, push-pull background inpaint, vertical blur,
// per-eye bilinear warp and confidence blend, optional edge feather, then
// either u8 quantisation into the Half-SBS / Half-TAB arrangement of the
// finished HWC frame (d2s_dibr_pair_half) or both eyes as planar f32
// (d2s_dibr_pair_eyes, the generic stereo tail's full-width eyes).
//
// Replaces: desktop2stereo_tpu/ops/pallas/dibr.py:dibr_render_pair_planar
// (kernel body _dibr_pair_kernel): out_mode="eyes_u8" plus the XLA concat
// and CHW->HWC transpose that follow it in pipeline/programs.py, and
// out_mode="eyes" as ops/stereo.py:stereo_compose calls it.  The TPU
// kernel owns a full-width row tile in VMEM, reads +-1 tile row halos, and
// decomposes the data-dependent warp into lane-group gathers over an
// edge-padded frame.  On the GPU the warp is a plain indexed load, so none
// of that is carried over: one thread per eye pixel, clamp-to-edge indexing
// on the true eh x ew frame (edge padding replicated the last row/column, so
// the values are the same), and the thread writes its pixel of both eyes
// straight into the output frame.
//
// Semantics kept from the TPU kernel: only the centre depth is 3-tap
// smoothed; the inpaint sweep taps and the vertical taps read RAW depth.
// The two sweeps are shared by both eyes (the reference's direction signs
// cancel), so `filled` is computed once and only the warp and blend are per
// eye.  Float operations follow the TPU kernel's order; the file is built
// with -fmad=false so no multiply-add is contracted, which keeps the result
// within rounding of the plain PyTorch version (dibr_pair_half_ref).
//
// What bounds it on the H100: at the 4K eye (2160 x 1920) the kernel reads
// 4 f32 planes (~66 MB) and writes 25 MB of u8 (~27 us at 3.35 TB/s); the
// eyes mode at the full 4K frame (2160 x 3840) reads 133 MB and writes two
// f32 eyes, 199 MB (~99 us).  Each pixel's 24 sweep taps,
// 4 vertical taps and 2 warp gathers hit neighbouring addresses that L1/L2
// serve, so it should be bound by L1/L2 bandwidth and HBM, not arithmetic.
// Row-tiling through shared memory is the obvious next step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 12;  // inpaint search radius (taps per sweep)
constexpr int kVShift = 2;   // vertical blur tap distance (rows)

// Edge coordinates u = (i + 0.5)/n scaled by s, as (u*s, (1-u)*s): 1/n and s
// fold into one constant and 1-u is one fused multiply-add (the rounding
// XLA gives the TPU kernel's expressions; see dibr.py:_edge_coords).
struct EdgeScale {
  float inv_n;    // 1/n
  float lo;       // (1/n) * s
  float s;
};

struct DibrParams {
  int height, width;      // eye size
  float disp_l, disp_r;   // eye offset * width, per eye (-|ipd/2|*W, +|ipd/2|*W)
  float depth_strength;
  float convergence;
  int feather;            // 0: off
  int tab;                // 0: Half-SBS [H, 2W, 3], 1: Half-TAB [2H, W, 3]
  float tol;              // depth_tolerance
  float tol_half;         // depth_tolerance * 0.5
  float jump_lo, jump_span;
  EdgeScale margin_w;     // s = 1/edge_margin over the width
  EdgeScale feather_w;    // s = 1/feather over the width
  EdgeScale feather_h;    // s = 1/feather over the height
  float fwd_a[kRadius];   // exp(-t*0.15)
  float fwd_b[kRadius];   // 10*exp(-t*0.15)
  float bwd_w[kRadius];   // exp(-t*0.2)
};

EdgeScale edge_scale(int n, float s) {
  EdgeScale e;
  e.inv_n = (float)(1.0 / n);
  e.lo = e.inv_n * s;
  e.s = s;
  return e;
}

__device__ __forceinline__ float edge_lo(float c, EdgeScale e) { return c * e.lo; }
__device__ __forceinline__ float edge_hi(float c, EdgeScale e) {
  return fmaf(-c, e.inv_n, 1.0f) * e.s;
}

__device__ __forceinline__ float smoothstep01(float t) {
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint8_t quantize(float x) {
  return (uint8_t)(int)fminf(fmaxf(x + 0.5f, 0.0f), 255.0f);
}

// kEyes = false: out0 is the u8 Half-SBS/TAB frame (out1 unused);
// kEyes = true: out0 / out1 are the left / right planar f32 [3, H, W] eyes.
template <bool kEyes>
__global__ void dibr_pair_kernel(const float* __restrict__ rgb,
                                 const float* __restrict__ dep,
                                 void* __restrict__ out0,
                                 void* __restrict__ out1, DibrParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  const int W = p.width;
  const int H = p.height;
  if (x >= W) return;

  const size_t plane = (size_t)H * W;
  const float* row_d = dep + (size_t)y * W;
  const float* row_r = rgb + (size_t)y * W;
  auto cx = [W](int xx) { return min(max(xx, 0), W - 1); };
  auto cy = [H](int yy) { return min(max(yy, 0), H - 1); };

  // --- eye-independent depth work --------------------------------------
  const float d0 = row_d[x];
  const float dm2 = row_d[cx(x - 2)], dm1 = row_d[cx(x - 1)];
  const float dp1 = row_d[cx(x + 1)], dp2 = row_d[cx(x + 2)];
  const float h_lo = dm2 * 0.5f + dm1 * 0.5f;  // tap at -1.5 px
  const float h_hi = dp1 * 0.5f + dp2 * 0.5f;  // tap at +1.5 px
  const float smooth = fmaf(h_hi, 0.15f, fmaf(d0, 0.7f, h_lo * 0.15f));
  const float cdi = -smooth;
  const float jump = fabsf(dm2 - dp2);
  const float conf_base = smoothstep01(clip01((jump - p.jump_lo) / p.jump_span));
  // shaped depth (-s)*(1 + 0.35*(1 - s)), plus the convergence offset
  const float shaped_conv =
      fmaf(-smooth, fmaf(0.35f, 1.0f - smooth, 1.0f), p.convergence);

  const float col = (float)x;
  const float cx5 = col + 0.5f;
  const float e1 = smoothstep01(clip01(edge_lo(cx5, p.margin_w)));
  const float e2 = smoothstep01(clip01(edge_hi(cx5, p.margin_w)));
  const float shift_base = shaped_conv * (p.depth_strength * (e1 * e2));

  // --- inpaint sweeps (shared by both eyes) ------------------------------
  const float thr = cdi + p.tol;
  const float pre_w = 1.0f - 10.0f * cdi;
  float fwd[3] = {0.0f, 0.0f, 0.0f}, fwd_w = 0.0f;
  float bwd[3] = {0.0f, 0.0f, 0.0f}, bwd_w = 0.0f;
#pragma unroll
  for (int t = 1; t <= kRadius; ++t) {
    const int xs = cx(x - t);  // forward sweep: direction -1, depth-weighted
    const float s_inv = 1.0f - row_d[xs];
    if (s_inv > thr && fwd_w <= 5.0f) {
      const float w = p.fwd_a[t - 1] * pre_w + p.fwd_b[t - 1] * s_inv;
#pragma unroll
      for (int c = 0; c < 3; ++c) fwd[c] = fwd[c] + row_r[c * plane + xs] * w;
      fwd_w = fwd_w + w;
    }
  }
#pragma unroll
  for (int t = 1; t <= kRadius; ++t) {
    const int xs = cx(x + t);  // backward sweep: direction +1, plain weights
    const float s_inv = 1.0f - row_d[xs];
    if (s_inv > thr && bwd_w <= 5.0f) {
      const float w = p.bwd_w[t - 1];
#pragma unroll
      for (int c = 0; c < 3; ++c) bwd[c] = bwd[c] + row_r[c * plane + xs] * w;
      bwd_w = bwd_w + w;
    }
  }

  // --- vertical blur taps (RAW depth rows at -+2) -------------------------
  float vadd[3] = {0.0f, 0.0f, 0.0f};
  float vert_w = 0.5f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yy = cy(k == 0 ? y - kVShift : y + kVShift);
    const float v_raw = dep[(size_t)yy * W + x];
    const float w = (1.0f - v_raw) > cdi + p.tol_half ? 0.25f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      vadd[c] = vadd[c] + rgb[c * plane + (size_t)yy * W + x] * w;
    vert_w = vert_w + w;
  }
  const float inv_vw = 1.0f / vert_w;

  const bool need_bwd = fwd_w < 2.0f;
  const float best_w = fwd_w + (need_bwd ? bwd_w : 0.0f);
  const bool found = best_w > 0.01f;
  const float scale = 0.5f / fmaxf(best_w, 1e-12f);
  float filled[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float best_c = fwd[c] + (need_bwd ? bwd[c] : 0.0f);
    filled[c] = found ? (best_c * scale + vadd[c]) * inv_vw : row_r[c * plane + x];
  }

  float fmask = 1.0f;
  if (p.feather) {
    const float cy5 = (float)y + 0.5f;
    const float fu = smoothstep01(clip01(edge_lo(cx5, p.feather_w)));
    const float fu1 = smoothstep01(clip01(edge_hi(cx5, p.feather_w)));
    const float fv = smoothstep01(clip01(edge_lo(cy5, p.feather_h)));
    const float fv1 = smoothstep01(clip01(edge_hi(cy5, p.feather_h)));
    fmask = powf(fu * fu1 * fv * fv1, 0.7f);
  }

  // --- per eye: warp + blend, written into the arranged HWC frame -------
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float px = fmaf(shift_base, -(e == 0 ? p.disp_l : p.disp_r), col);
    const bool oob = px < 0.0f || px > (float)(W - 1);
    const float pxc = fminf(fmaxf(px, 0.0f), (float)(W - 1));
    const float i0f = floorf(pxc);
    const float frac = pxc - i0f;
    const int i0 = (int)i0f;
    const int i1 = min(i0 + 1, W - 1);
    const float conf = oob ? 1.0f : conf_base;
    size_t o;
    if (kEyes) {
      o = (size_t)y * W + x;
    } else if (p.tab) {
      o = ((size_t)(e * H + y) * W + x) * 3;
    } else {
      o = ((size_t)y * (2 * W) + (size_t)e * W + x) * 3;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float g0 = row_r[c * plane + i0];
      const float g1 = row_r[c * plane + i1];
      const float color = g0 * (1.0f - frac) + g1 * frac;
      float val = color + conf * (filled[c] - color);
      if (p.feather) val = val * fmask;
      if (kEyes) {
        static_cast<float*>(e == 0 ? out0 : out1)[c * plane + o] = val;
      } else {
        static_cast<uint8_t*>(out0)[o + c] = quantize(val);
      }
    }
  }
}

DibrParams make_params(int height, int width, float ipd, float depth_strength,
                       float convergence, double feather, int tab) {
  DibrParams p;
  p.height = height;
  p.width = width;
  const float eye = fabsf(ipd / 2.0f);
  p.disp_l = -eye * (float)width;
  p.disp_r = eye * (float)width;
  p.depth_strength = depth_strength;
  p.convergence = convergence;
  p.tab = tab;
  // Constants rounded from double exactly as the TPU kernel's Python floats
  // are when they meet f32 arrays.
  p.tol = (float)0.012;
  p.tol_half = (float)(0.012 * 0.5);
  p.margin_w = edge_scale(width, 1.0f / (float)0.05);
  p.feather = feather > 0.0;
  const float fs = p.feather ? (float)(1.0 / feather) : 0.0f;
  p.feather_w = edge_scale(width, fs);
  p.feather_h = edge_scale(height, fs);
  p.jump_lo = (float)0.04;
  p.jump_span = (float)(0.10 - 0.04);
  for (int t = 1; t <= kRadius; ++t) {
    const double fw = exp(-(double)t * 0.15);
    p.fwd_a[t - 1] = (float)fw;
    p.fwd_b[t - 1] = (float)(10.0 * fw);
    p.bwd_w[t - 1] = (float)exp(-(double)t * 0.2);
  }
  return p;
}

template <bool kEyes>
int launch(const void* rgb, const void* dep, void* out0, void* out1,
           const DibrParams& p, void* stream) {
  const dim3 block(128);
  const dim3 grid((p.width + block.x - 1) / block.x, p.height);
  dibr_pair_kernel<kEyes><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(dep), out0,
      out1, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rgb: contiguous planar [3, height, width] f32 (0..255); dep: contiguous
// [height, width] f32 in [0, 1]; out: contiguous u8, [height, 2*width, 3]
// (tab = 0) or [2*height, width, 3] (tab = 1).
int d2s_dibr_pair_half(const void* rgb, const void* dep, void* out, int height,
                       int width, float ipd, float depth_strength,
                       float convergence, double feather, int tab,
                       void* stream) {
  return launch<false>(rgb, dep, out, nullptr,
                       make_params(height, width, ipd, depth_strength,
                                   convergence, feather, tab),
                       stream);
}

// rgb, dep as above; out_l, out_r: contiguous planar [3, height, width] f32,
// unfeathered (the generic tail feathers the eyes itself).
int d2s_dibr_pair_eyes(const void* rgb, const void* dep, void* out_l,
                       void* out_r, int height, int width, float ipd,
                       float depth_strength, float convergence, void* stream) {
  return launch<true>(rgb, dep, out_l, out_r,
                      make_params(height, width, ipd, depth_strength,
                                  convergence, 0.0, 0),
                      stream);
}

}  // extern "C"
