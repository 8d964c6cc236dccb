"""PyTorch + CUDA port of desktop2stereo_tpu's frame path.

Capture frame → monocular depth (Depth-Anything, DINOv2 + DPT) → depth post
and temporal EMA → DIBR stereo → Half-SBS / Half-TAB u8 frame, on one
NVIDIA GPU.  The two kernels of that path (the encoder's attention and the
fused both-eyes DIBR pass) are hand-written CUDA C++ under `csrc/`, built
with nvcc at first use; every other op is plain PyTorch.

This package imports torch and never jax, and nothing from
`desktop2stereo_tpu` (the JAX reference it is tested against).
"""
