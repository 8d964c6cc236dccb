"""Single-image depth debug harness.

Port of `desktop2stereo_tpu/tools/depth_visualize.py`: the full depth stack
on one image with a Spectral_r colormap view (the reference's
depth_visualize.py:21-56, 1459-1492), against the port's own modules:

  python -m desktop2stereo_tpu_torch.tools.depth_visualize assets/golden.png \\
      --model Depth-Anything-V2-Small --out /tmp/depth

Writes the colormapped depth (and with --sbs the Half-SBS frame) as PNGs
and prints min/max/mean, so runs are comparable across changes and with
the JAX tool.  It runs on CUDA device 0 unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# Spectral_r-style colormap control points (matplotlib's Spectral reversed),
# enough for visual comparison without a matplotlib dependency
_SPECTRAL_R = np.array([
    (94, 79, 162), (50, 136, 189), (102, 194, 165), (171, 221, 164),
    (230, 245, 152), (255, 255, 191), (254, 224, 139), (253, 174, 97),
    (244, 109, 67), (213, 62, 79), (158, 1, 66),
], np.float32)


def colormap_spectral_r(depth01: np.ndarray) -> np.ndarray:
    x = np.clip(depth01, 0.0, 1.0) * (len(_SPECTRAL_R) - 1)
    i0 = np.clip(x.astype(np.int32), 0, len(_SPECTRAL_R) - 2)
    f = (x - i0)[..., None]
    c = _SPECTRAL_R[i0] * (1 - f) + _SPECTRAL_R[i0 + 1] * f
    return c.astype(np.uint8)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="d2s-depth-visualize")
    p.add_argument("image", nargs="?", default=None,
                   help="input image; defaults to assets/golden.png "
                        "(or assets/cats.jpg if present, matching the "
                        "reference harness)")
    p.add_argument("--model", default="Depth-Anything-V2-Small")
    p.add_argument("--depth-res", type=int, default=518)
    p.add_argument("--out", default="out/depth_vis")
    p.add_argument("--sbs", action="store_true", help="also write Half-SBS")
    p.add_argument("--checkpoint")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (default): CUDA device 0; 'cpu': the "
                        "plain-PyTorch kernel versions")
    args = p.parse_args(argv)

    import torch
    from PIL import Image

    from desktop2stereo_tpu_torch.core.config import Settings
    from desktop2stereo_tpu_torch.core.registry import effective_compute_dtype, get_spec
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.pipeline.programs import ProgramCache, ProgramConfig

    if args.device == "cpu":
        device, dtype = torch.device("cpu"), torch.float32
    else:
        policy = cuda_policy(0)
        device, dtype = policy.device, policy.compute_dtype

    if args.image is None:
        root = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
        for cand in ("cats.jpg", "golden.png"):
            path = os.path.join(root, cand)
            if os.path.isfile(path):
                args.image = path
                break
        else:
            raise SystemExit("no input image given and assets/ has no golden")

    img = np.asarray(Image.open(args.image).convert("RGB"))
    frame_bgra = np.ascontiguousarray(img[..., ::-1])  # the capture's BGR(A) layout

    settings = Settings(model=args.model, depth_resolution=args.depth_res,
                        output_resolution=img.shape[0], temporal_smooth=False)
    # the production CLI's quirk table, so this tool's numbers stay
    # comparable with what the app computes
    compute_dtype = effective_compute_dtype(get_spec(args.model), dtype)
    model, spec = build_bound(args.model, device=device, dtype=compute_dtype,
                              checkpoint=args.checkpoint)
    cfg = ProgramConfig.from_settings(settings)
    program = ProgramCache(cfg, model, spec, compute_dtype=compute_dtype)

    sbs, depth = program(frame_bgra)
    depth_np = depth.float().cpu().numpy()
    print(f"[depth] {args.model} on {args.image}: shape={depth_np.shape} "
          f"min={depth_np.min():.4f} max={depth_np.max():.4f} "
          f"mean={depth_np.mean():.4f}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    Image.fromarray(colormap_spectral_r(depth_np)).save(args.out + "_depth.png")
    print(f"[depth] wrote {args.out}_depth.png")
    if args.sbs:
        Image.fromarray(sbs.cpu().numpy()).save(args.out + "_sbs.png")
        print(f"[depth] wrote {args.out}_sbs.png")


if __name__ == "__main__":
    main()
