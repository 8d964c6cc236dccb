// Horizontal bilinear resample: out[y, x, c] = img[y, :, c] sampled at px[y, x]
// (clamp-to-edge), the warp gather of the fast stereo compositor.
//
// Replaces: desktop2stereo_tpu/ops/pallas/warp.py:horizontal_sample (kernel
// body _warp_kernel).  On the TPU a data-dependent gather scalarizes, so that
// kernel views a row as 128-lane groups and assembles each sample from
// (2K+1) masked lane shuffles over zero-padded, tile-padded rows.  On the GPU
// the gather is an ordinary indexed load, so none of that is carried over:
// one thread per output pixel reads px once and gathers the two source texels
// of every channel from the same row of the true H x W frame.  The TPU kernel
// reads its zero pad column only at px = W-1, where the weight on it is 0;
// clamping the second tap to W-1 gives the same values.
//
// What bounds it on the H100: bytes.  At 4K ([2160, 3840, 3] f32) it must
// read the image (100 MB) and px (33 MB) and write 100 MB: ~69 us at
// 3.35 TB/s.  The two gathers per channel land within a few pixels of the
// thread's own column, so neighbouring threads share cache lines and L1/L2
// serve the re-reads.  Built with -fmad=false so that the lerp rounds as its
// plain PyTorch version (horizontal_sample_ref) does.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ px,
                            float* __restrict__ out, int height, int width,
                            int channels) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= width) return;
  const size_t row = (size_t)y * width;
  const float p = px[row + x];
  const float x0 = floorf(p);
  const float frac = p - x0;
  const int i0 = min(max((int)x0, 0), width - 1);
  const int i1 = min(i0 + 1, width - 1);
  const float* src = img + row * channels;
  float* dst = out + (row + x) * channels;
  for (int c = 0; c < channels; ++c) {
    const float g0 = src[(size_t)i0 * channels + c];
    const float g1 = src[(size_t)i1 * channels + c];
    dst[c] = g0 * (1.0f - frac) + g1 * frac;
  }
}

}  // namespace

extern "C" {

const char* d2s_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// img: contiguous [height, width, channels] f32; px: contiguous [height,
// width] f32 in [0, width-1]; out: contiguous [height, width, channels] f32.
int d2s_horizontal_sample(const void* img, const void* px, void* out,
                          int height, int width, int channels, void* stream) {
  const dim3 block(128);
  const dim3 grid((width + block.x - 1) / block.x, height);
  warp_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(px),
      static_cast<float*>(out), height, width, channels);
  return (int)cudaGetLastError();
}

}  // extern "C"
