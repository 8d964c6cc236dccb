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
// of that is carried over: a block stages a segment of one row, each thread
// computes 4 consecutive eye pixels, clamp-to-edge indexing on the true
// eh x ew frame (edge padding replicated the last row/column, so the values
// are the same), and the thread writes its pixels of both eyes straight into
// the output frame.
//
// Semantics kept from the TPU kernel: only the centre depth is 3-tap
// smoothed; the inpaint sweep taps and the vertical taps read RAW depth.
// The two sweeps are shared by both eyes (the reference's direction signs
// cancel), so `filled` is computed once and only the warp and blend are per
// eye.  Float operations follow the TPU kernel's order; the file is built
// with -fmad=false so no multiply-add is contracted, which keeps the result
// within rounding of the plain PyTorch version (dibr_pair_half_ref).
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W): not HBM.  At the
// 4K eye (2160 x 1920) the kernel must read 4 f32 planes (~66 MB) and write
// 25 MB of u8 (27 us at 3.35 TB/s); the eyes mode at the full 4K frame (2160
// x 3840) reads 133 MB and writes two f32 eyes, 199 MB (99 us). A thread a
// pixel reading its taps from global memory (the previous design) issued
// ~120 scalar loads a pixel (24 sweep taps x 4 values, the centre, the
// vertical taps and the warp gathers), each shifted row straddling two
// 128-byte lines: ~2 L1 wavefronts a load, ~0.13 ms of L1 issue at the eye
// against the 0.157 ms it took.  This design cuts the wavefronts and the
// instructions: a block stages its row segment once in shared memory
// (dibr_tile.cuh), each thread walks the staged columns once per sweep for 4
// consecutive pixels (one conflict-free LDS.128 feeds up to 4 pixels), a
// warp leaves a sweep as soon as none of its pixels can take another tap (on
// depth maps after 4-5 of the forward sweep's 15 columns, and the backward
// sweep is almost never needed), the vertical taps and the stores are float4
// (u32 for the u8 frame) where the rows are aligned, and where the block
// holds the whole row (a 4K eye) the warp gathers read it too. Measured in
// one call with the thread-per-pixel kernel (kernel_ab.py, graph-timed): the
// Half eye 0.090 ms against 0.157, the eyes 0.201 against 0.304; what is
// left is issue and latency at 80 registers (24 warps an SM), 16 bytes of
// spill, and the 12 global gathers a pixel of the eyes mode (PERF.md).
//
// The launch geometry comes from the wrapper (ops/kernels/dibr.py:
// tile_geometry) and is checked here; a mismatch returns
// cudaErrorInvalidValue.
//
// Stream axis: both entry points take S frames at once, contiguous
// [S, 3, H, W] rgb and [S, H, W] depth, into S outputs (the batched
// multi-stream program's one launch a step, as jax.vmap gives the TPU
// kernel a batch grid axis).  The stream index is the grid's z axis and
// each block offsets its rgb, depth and output pointers by its stream's
// stride; nothing else changes, so row s of an S-frame launch is bit-equal
// to a one-frame launch on row s.  Every pixel's float operations are those of the
// earlier thread-per-pixel kernel in the same order, so the output is
// bit-identical to it; only where the operands come from changed.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dibr_tile.cuh"

namespace {

using namespace d2s_tile;

constexpr int kRadius = 12;  // inpaint search radius (taps per sweep)
constexpr int kVShift = 2;   // vertical blur tap distance (rows)

// Blocks of kMaxThreads an SM the compiler has to fit: 3 caps the kernel at
// 85 registers (24 warps an SM).  The kernel is latency-bound, and left
// alone the compiler takes 126-170 registers and runs 1.2-2x slower
// (PERF.md; kernel_ab.py --variant measures other values).
#ifndef D2S_DIBR_MIN_BLOCKS
#define D2S_DIBR_MIN_BLOCKS 3
#endif

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
  // per-stream strides in elements: rgb and depth (f32), the output (u8 for
  // the Half frame, f32 for each eye)
  long long s_rgb, s_dep, s_out;
  float disp_l, disp_r;   // eye offset * width, per eye (-|ipd/2|*W, +|ipd/2|*W)
  float depth_strength;
  float convergence;
  int feather;            // 0: off
  int tab;                // 0: Half-SBS [H, 2W, 3], 1: Half-TAB [2H, W, 3]
  int vec;                // rows and pointers 16-byte aligned: float4 / u32 access
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

__device__ __forceinline__ uint32_t quantize(float x) {
  return (uint32_t)(int)fminf(fmaxf(x + 0.5f, 0.0f), 255.0f);
}

// The kPix pixels x0 .. x0+3 of row y (thread-group i of the block whose
// segment starts at s0).  kEyes = false: out0 is the u8 Half-SBS/TAB frame
// (out1 unused); kEyes = true: out0 / out1 are the left / right planar f32
// [3, H, W] eyes.
template <bool kEyes>
__device__ __forceinline__ void pair_pixels(const Tile& t, const Geometry& g,
                                            const DibrParams& p,
                                            const float* __restrict__ rgb,
                                            const float* __restrict__ dep,
                                            void* __restrict__ out0,
                                            void* __restrict__ out1, int y, int s0,
                                            int i, bool row_in_smem) {
  const int W = p.width;
  const int H = p.height;
  const size_t plane = (size_t)H * W;
  const int x0 = s0 + kPix * i;
  const int q = i + g.halo / 4;
  const int q5 = 5 * q;
  const bool vec = p.vec;

  // --- eye-independent depth work (raw depth at x-2 .. x+2) ------------
  float win[12];
  depth_window(t, q, win);
  float cdi[kPix], thr[kPix], pre_w[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float d0 = win[4 + j];
    const float dm2 = win[2 + j], dm1 = win[3 + j];
    const float dp1 = win[5 + j], dp2 = win[6 + j];
    const float h_lo = dm2 * 0.5f + dm1 * 0.5f;  // tap at -1.5 px
    const float h_hi = dp1 * 0.5f + dp2 * 0.5f;  // tap at +1.5 px
    const float smooth = fmaf(h_hi, 0.15f, fmaf(d0, 0.7f, h_lo * 0.15f));
    cdi[j] = -smooth;
    thr[j] = cdi[j] + p.tol;
    pre_w[j] = 1.0f - 10.0f * cdi[j];
  }

  // --- inpaint sweeps over the staged columns (shared by both eyes) ------
  float fwd[kPix][3] = {}, fwd_w[kPix] = {};
  float bwd[kPix][3] = {}, bwd_w[kPix] = {};
  // forward sweep: direction -1, depth-weighted
  sweep<-1, kRadius>(t, q5, kRadius, [&](int j, int tap, float4 v) {
    if (v.w > thr[j] && fwd_w[j] <= 5.0f) {
      const float w = p.fwd_a[tap - 1] * pre_w[j] + p.fwd_b[tap - 1] * v.w;
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
  // backward sweep: direction +1, plain weights; read only where the
  // forward sweep found a weight below 2
  sweep<+1, kRadius>(t, q5, kRadius, [&](int j, int tap, float4 v) {
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

  // --- vertical blur taps (RAW depth rows at -+2) -------------------------
  float vadd[kPix][3] = {}, vert_w[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) vert_w[j] = 0.5f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int yy = min(max(k == 0 ? y - kVShift : y + kVShift, 0), H - 1);
    float v_raw[kPix], v_rgb[3][kPix];
    load_pix(dep + (size_t)yy * W, x0, W, vec, v_raw);
#pragma unroll
    for (int c = 0; c < 3; ++c) load_pix(rgb + c * plane + (size_t)yy * W, x0, W, vec, v_rgb[c]);
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float w = (1.0f - v_raw[j]) > cdi[j] + p.tol_half ? 0.25f : 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) vadd[j][c] = vadd[j][c] + v_rgb[c][j] * w;
      vert_w[j] = vert_w[j] + w;
    }
  }

  float filled[kPix][3], fmask[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float inv_vw = 1.0f / vert_w[j];
    const bool need_bwd = fwd_w[j] < 2.0f;
    const float best_w = fwd_w[j] + (need_bwd ? bwd_w[j] : 0.0f);
    const bool found = best_w > 0.01f;
    const float scale = 0.5f / fmaxf(best_w, 1e-12f);
    const float4 centre = column(t, q5, j);
    const float own[3] = {centre.x, centre.y, centre.z};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float best_c = fwd[j][c] + (need_bwd ? bwd[j][c] : 0.0f);
      filled[j][c] = found ? (best_c * scale + vadd[j][c]) * inv_vw : own[c];
    }
    fmask[j] = 1.0f;
    if (p.feather) {
      const float cx5 = (float)(x0 + j) + 0.5f;
      const float cy5 = (float)y + 0.5f;
      const float fu = smoothstep01(clip01(edge_lo(cx5, p.feather_w)));
      const float fu1 = smoothstep01(clip01(edge_hi(cx5, p.feather_w)));
      const float fv = smoothstep01(clip01(edge_lo(cy5, p.feather_h)));
      const float fv1 = smoothstep01(clip01(edge_hi(cy5, p.feather_h)));
      fmask[j] = powf(fu * fu1 * fv * fv1, 0.7f);
    }
  }

  // the disocclusion confidence and the warp shift, from the depth window
  // reloaded here rather than held in registers over the sweeps
  depth_window(t, q, win);
  float conf_base[kPix], shift_base[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const float jump = fabsf(win[2 + j] - win[6 + j]);
    conf_base[j] = smoothstep01(clip01((jump - p.jump_lo) / p.jump_span));
    // shaped depth (-s)*(1 + 0.35*(1 - s)), plus the convergence offset;
    // smooth = -cdi exactly
    const float shaped_conv =
        fmaf(cdi[j], fmaf(0.35f, 1.0f + cdi[j], 1.0f), p.convergence);
    const float cx5 = (float)(x0 + j) + 0.5f;
    const float e1 = smoothstep01(clip01(edge_lo(cx5, p.margin_w)));
    const float e2 = smoothstep01(clip01(edge_hi(cx5, p.margin_w)));
    shift_base[j] = shaped_conv * (p.depth_strength * (e1 * e2));
  }

  // --- per eye: warp + blend, then the stores ----------------------------
  const float* row_r = rgb + (size_t)y * W;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float val[kPix][3];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      const float col = (float)(x0 + j);
      const float px = fmaf(shift_base[j], -(e == 0 ? p.disp_l : p.disp_r), col);
      const bool oob = px < 0.0f || px > (float)(W - 1);
      const float pxc = fminf(fmaxf(px, 0.0f), (float)(W - 1));
      const float i0f = floorf(pxc);
      const float frac = pxc - i0f;
      const int i0 = (int)i0f;
      const int i1 = min(i0 + 1, W - 1);
      const float conf = oob ? 1.0f : conf_base[j];
      float g0[3], g1[3];
      if (row_in_smem) {  // the block staged the whole row: s0 = 0
        const float4 a = t.cols[slot(i0 + g.halo)];
        const float4 b = t.cols[slot(i1 + g.halo)];
        g0[0] = a.x; g0[1] = a.y; g0[2] = a.z;
        g1[0] = b.x; g1[1] = b.y; g1[2] = b.z;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          g0[c] = __ldg(row_r + c * plane + i0);
          g1[c] = __ldg(row_r + c * plane + i1);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float color = g0[c] * (1.0f - frac) + g1[c] * frac;
        float v = color + conf * (filled[j][c] - color);
        if (p.feather) v = v * fmask[j];
        val[j][c] = v;
      }
    }
    if (kEyes) {
      float* o = static_cast<float*>(e == 0 ? out0 : out1) + (size_t)y * W + x0;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (vec) {
          *reinterpret_cast<float4*>(o + c * plane) =
              make_float4(val[0][c], val[1][c], val[2][c], val[3][c]);
        } else {
#pragma unroll
          for (int j = 0; j < kPix; ++j)
            if (x0 + j < W) o[c * plane + j] = val[j][c];
        }
      }
    } else {
      const size_t o = p.tab ? ((size_t)(e * H + y) * W + x0) * 3
                             : ((size_t)y * (2 * W) + (size_t)e * W + x0) * 3;
      uint8_t* out = static_cast<uint8_t*>(out0) + o;
      if (vec) {  // 12 bytes, 4-byte aligned: three 32-bit stores
        uint32_t b[12];
#pragma unroll
        for (int j = 0; j < kPix; ++j)
#pragma unroll
          for (int c = 0; c < 3; ++c) b[3 * j + c] = quantize(val[j][c]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          reinterpret_cast<uint32_t*>(out)[k] =
              b[4 * k] | (b[4 * k + 1] << 8) | (b[4 * k + 2] << 16) | (b[4 * k + 3] << 24);
      } else {
#pragma unroll
        for (int j = 0; j < kPix; ++j)
          if (x0 + j < W)
#pragma unroll
            for (int c = 0; c < 3; ++c) out[3 * j + c] = (uint8_t)quantize(val[j][c]);
      }
    }
  }
}

template <bool kEyes>
__global__ void __launch_bounds__(kMaxThreads, D2S_DIBR_MIN_BLOCKS)
    dibr_pair_kernel(const float* __restrict__ rgb, const float* __restrict__ dep,
                     void* __restrict__ out0, void* __restrict__ out1,
                     const __grid_constant__ DibrParams p,
                     const __grid_constant__ Geometry g) {
  extern __shared__ float4 smem[];
  const Tile t = tile_of(smem, g);
  const long long z = blockIdx.z;  // the stream
  rgb += z * p.s_rgb;
  dep += z * p.s_dep;
  if (kEyes) {
    out0 = static_cast<float*>(out0) + z * p.s_out;
    out1 = static_cast<float*>(out1) + z * p.s_out;
  } else {
    out0 = static_cast<uint8_t*>(out0) + z * p.s_out;
  }
  const int W = p.width;
  const int y = blockIdx.y;
  const size_t plane = (size_t)p.height * W;
  const float* row_d = dep + (size_t)y * W;
  const float* row_r = rgb + (size_t)y * W;
  const int s0 = blockIdx.x * g.seg;
  stage(t, g, s0 - g.halo, W, [&](int x) {
    return make_float4(row_r[x], row_r[plane + x], row_r[2 * plane + x], row_d[x]);
  });
  __syncthreads();
  const bool row_in_smem = g.seg >= W;
  const int end = min(s0 + g.seg, W);
  for (int i = threadIdx.x; s0 + kPix * i < end; i += blockDim.x)
    pair_pixels<kEyes>(t, g, p, rgb, dep, out0, out1, y, s0, i, row_in_smem);
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
  p.vec = 0;
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

// `streams` frames at the per-stream strides of contiguous [S, ...] inputs
// and outputs (elements: 3HW rgb, HW depth, 6HW u8 Half frame or 3HW f32 eye).
template <bool kEyes>
int launch(const void* rgb, const void* dep, void* out0, void* out1, int streams,
           DibrParams p, const Geometry& g, int pix, void* stream) {
  if (streams < 1 || streams > 65535 || p.height < 1 || p.height > 65535 ||
      !geometry_ok(g, p.width, pix, kRadius))
    return (int)cudaErrorInvalidValue;
  const long long plane = (long long)p.height * p.width;
  p.s_rgb = 3 * plane;
  p.s_dep = plane;
  p.s_out = kEyes ? 3 * plane : 6 * plane;
  // width % 4 == 0 keeps every stream's rows as aligned as stream 0's
  p.vec = p.width % 4 == 0 && aligned16(rgb) && aligned16(dep) && aligned16(out0) &&
          (out1 == nullptr || aligned16(out1));
  static int allowed = 0;
  const cudaError_t err = allow_smem(dibr_pair_kernel<kEyes>, g.smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  dibr_pair_kernel<kEyes><<<dim3(g.grid_x, p.height, streams), g.threads, g.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rgb), static_cast<const float*>(dep), out0, out1, p, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rgb: contiguous planar [streams, 3, height, width] f32 (0..255); dep:
// contiguous [streams, height, width] f32 in [0, 1]; out: contiguous u8,
// [streams, height, 2*width, 3] (tab = 0) or [streams, 2*height, width, 3]
// (tab = 1).  seg .. grid_x: the launch geometry of ops/kernels/dibr.py:
// tile_geometry (pix = 4, halo >= 12).
int d2s_dibr_pair_half(const void* rgb, const void* dep, void* out, int streams,
                       int height, int width, float ipd, float depth_strength,
                       float convergence, double feather, int tab, int seg,
                       int halo, int pix, int threads, int smem, int grid_x,
                       void* stream) {
  return launch<false>(rgb, dep, out, nullptr, streams,
                       make_params(height, width, ipd, depth_strength,
                                   convergence, feather, tab),
                       Geometry{seg, halo, threads, smem, grid_x}, pix, stream);
}

// rgb, dep as above; out_l, out_r: contiguous planar [streams, 3, height,
// width] f32, unfeathered (the generic tail feathers the eyes itself).
int d2s_dibr_pair_eyes(const void* rgb, const void* dep, void* out_l,
                       void* out_r, int streams, int height, int width, float ipd,
                       float depth_strength, float convergence, int seg,
                       int halo, int pix, int threads, int smem, int grid_x,
                       void* stream) {
  return launch<true>(rgb, dep, out_l, out_r, streams,
                      make_params(height, width, ipd, depth_strength,
                                  convergence, 0.0, 0),
                      Geometry{seg, halo, threads, smem, grid_x}, pix, stream);
}

}  // extern "C"
