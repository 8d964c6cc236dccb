"""Checkpoint tooling of the port: fetch, re-serialize, verify and gate weights.

Port of `desktop2stereo_tpu/tools/convert.py`, with its jobs, flags and JSON
verdict line:

  python -m desktop2stereo_tpu_torch.tools.convert --model Depth-Anything-V2-Small
      downloads the registry model's HF repo into the hub cache, where
      `models/factory.py:find_checkpoint` finds it.

  python -m desktop2stereo_tpu_torch.tools.convert --model-path ./SomeModel
      re-serializes a local torch checkpoint folder to safetensors.

  ... --verify  builds the model from the checkpoint the factory finds, on
      `--device`, and prints its parameter count (catches converter and
      naming drift).

  ... --verify-depth  the real-weight depth parity gate: `transformers`'
      AutoModelForDepthEstimation in f32 on the CPU (or the reference's own
      predict_depth numerics, where the reference tree is present) against
      the port's own pipeline in f32 on `--device` (`port_depth`; on the
      card with TF32 off, so K2 runs its f32 entries), on one image with the
      checkpoint's weights.  One JSON verdict line (the JAX tool's keys and
      `device`); exit 1 on failure.

  ... --make-random-snapshot DIR  a real-shape HF snapshot of --model with
      seeded random weights (the depth_anything family), to feed back with
      --checkpoint where no download is possible.

`--device cuda` (the default) runs on CUDA device 0 and exits 2 naming CUDA
without one, as the CLI does; `--device cpu` runs the plain versions.  Two
deviations from the JAX tool: `--skip-download` skips the hub pull for
every job (there, only with --verify-depth), and with HF_HUB_OFFLINE=1 the
verdict's egress probe reports the offline mode instead of looking the hub
up.  The module imports no `transformers`, `huggingface_hub`, PIL or JAX:
each job imports what it needs, and a job whose package is missing raises
an ImportError naming it (`main` exits 1 with it); there is no fallback.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from typing import Optional

# the registry families whose checkpoints `transformers`' AutoModel loads
GATE_FAMILIES = ("depth_anything", "dpt_dinov2", "dpt", "dpt_beit", "dpt_hybrid", "zoedepth")
# The upstream reference tree (its depth.py and assets/cats.jpg), where one
# is mounted: D2S_REFERENCE_DIR names it; unset, the gate uses the
# synthetic scene and the raw-forward oracle
REFERENCE_DIR: Optional[str] = os.environ.get("D2S_REFERENCE_DIR") or None


def _require(module: str, job: str):
    """`module`, imported for `job`; an ImportError naming it where it is
    missing."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{job} needs the `{module}` package, which this host does not "
                          f"have ({e})") from e


def pick_endpoint() -> str:
    """HF endpoint with the mirror as fallback (the JAX tool's order)."""
    import urllib.request

    if os.environ.get("HF_ENDPOINT"):
        return os.environ["HF_ENDPOINT"]
    try:
        urllib.request.urlopen("https://huggingface.co", timeout=3)
        return "https://huggingface.co"
    except Exception:
        return "https://hf-mirror.com"


def download(model_name: str) -> str:
    """The registry model's safetensors and json files into the hub cache."""
    hub = _require("huggingface_hub", "the download")
    from desktop2stereo_tpu_torch.core.registry import get_spec

    spec = get_spec(model_name)
    os.environ.setdefault("HF_ENDPOINT", pick_endpoint())
    path = hub.snapshot_download(spec.hf_repo, allow_patterns=["*.safetensors", "*.json"])
    print(f"[convert] {model_name}: {spec.hf_repo} -> {path}")
    return path


def reserialize(model_path: str) -> None:
    """Local torch checkpoint folder → safetensors."""
    import torch

    transformers = _require("transformers", "--model-path")
    model = transformers.AutoModelForDepthEstimation.from_pretrained(
        model_path, low_cpu_mem_usage=True, trust_remote_code=True,
        torch_dtype=torch.float32)
    model.save_pretrained(model_path, safe_serialization=True)
    print(f"[convert] re-serialized {model_path} to safetensors")


def verify(model_name: str, device=None) -> int:
    """Build the model from the checkpoint the factory finds, on `device`
    (the CUDA policy's when None); prints and returns its parameter count."""
    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models.convert_hf import param_count
    from desktop2stereo_tpu_torch.models.factory import build_bound, find_checkpoint

    spec = get_spec(model_name)
    ckpt = find_checkpoint(spec)
    if ckpt is None:
        raise SystemExit(f"no checkpoint found for {model_name}")
    model, _ = build_bound(model_name, device=device, checkpoint=ckpt)
    count = param_count(model)
    print(f"[convert] {model_name}: {ckpt} -> {count / 1e6:.1f}M params OK")
    return count


def make_random_snapshot(model_name: str, out_dir: str, seed: int = 7) -> str:
    """Full HF-format snapshot (config.json + model.safetensors) of the
    registry model at its real architecture with seeded random weights: every
    step of the --verify-depth gate (AutoModel load, weight conversion, both
    forward paths) runs at production geometry, so only the weight values
    are left unproven.  The depth_anything family only (AutoModel hosts it)."""
    import torch

    transformers = _require("transformers", "--make-random-snapshot")
    from desktop2stereo_tpu_torch.core.registry import get_spec

    spec = get_spec(model_name)
    if spec.family not in ("depth_anything",):
        raise NotImplementedError(
            f"--make-random-snapshot supports the depth_anything family "
            f"(AutoModel-hosted); got {spec.family!r}")
    hidden, layers, heads, mlp = spec.dims
    bb = transformers.Dinov2Config(
        hidden_size=hidden, num_hidden_layers=layers,
        num_attention_heads=heads, intermediate_size=mlp,
        patch_size=spec.patch_size, image_size=518,
        out_indices=[i + 1 for i in spec.dpt_layers], apply_layernorm=True,
        reshape_hidden_states=False,
    )
    cfg = transformers.DepthAnythingConfig(
        backbone_config=bb, fusion_hidden_size=spec.fusion_channels,
        patch_size=spec.patch_size, reassemble_hidden_size=hidden,
        neck_hidden_sizes=list(spec.neck_channels), head_hidden_size=32,
        depth_estimation_type="relative",
    )
    torch.manual_seed(seed)
    tmodel = transformers.DepthAnythingForDepthEstimation(cfg)
    tmodel.eval()
    out = os.path.join(out_dir, model_name)
    tmodel.save_pretrained(out, safe_serialization=True)
    n = sum(p.numel() for p in tmodel.parameters())
    print(f"[convert] random snapshot {model_name} ({n / 1e6:.1f}M params) -> {out}")
    return out


def probe_egress() -> dict:
    """Whether the HF hub resolves: the verdict's record of why weights are
    (not) real.  Under HF_HUB_OFFLINE=1 nothing is looked up."""
    import socket

    status = {}
    offline = os.environ.get("HF_HUB_OFFLINE", "").strip().lower() in ("1", "true", "yes", "on")
    for host in ("huggingface.co", "hf-mirror.com"):
        if offline:
            status[host] = "not probed (HF_HUB_OFFLINE)"
            continue
        try:
            socket.getaddrinfo(host, 443)
            status[host] = "dns-ok"
        except OSError as e:
            status[host] = f"dns-dead ({e.__class__.__name__})"
    return status


def _load_image(path: Optional[str]):
    """uint8 RGB [H, W, 3].  Explicit path > the reference's assets/cats.jpg
    > a deterministic synthetic 1080p scene."""
    import numpy as np

    if path is None and REFERENCE_DIR is not None:
        cats = os.path.join(REFERENCE_DIR, "assets", "cats.jpg")
        path = cats if os.path.exists(cats) else None
    if path is not None:
        Image = _require("PIL", "--image").Image
        return np.asarray(Image.open(path).convert("RGB"))
    # gradients and rectangles at distinct depths, so that a depth model
    # gives structured (not flat) output
    h, w = 1080, 1920
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], axis=-1)
    for i, (y0, x0, s, v) in enumerate(
            [(100, 200, 300, 0.9), (500, 900, 400, 0.2), (650, 300, 250, 0.6)]):
        img[y0:y0 + s, x0:x0 + s, i % 3] = v
    return (img * 255).astype(np.uint8)


def _reference_predict_depth_ns(metric: bool, fg: float, aa: float):
    """The reference's own numerics, extracted from its depth.py by the
    repository's test helper; None where no reference tree is mounted."""
    depth_py = os.path.join(REFERENCE_DIR, "depth.py") if REFERENCE_DIR else None
    if depth_py is None or not os.path.exists(depth_py):
        return None
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if repo_root not in sys.path:
        sys.path.insert(0, repo_root)
    import torch

    from tests.reference_loader import load_reference_functions

    return load_reference_functions(
        depth_py,  # absolute, so the helper's own root does not apply
        ["_resize_patch_aligned_t", "post_process_depth", "normalize",
         "apply_gamma", "apply_foreground_scale", "anti_alias",
         "_aa_kernel_cache", "_percentile_bounds_no_lerp",
         "_percentile_bounds_sort"],
        globals_extra={
            # IS_CUDA selects the reference's bicubic + antialias resize, the
            # preprocessing the port mirrors; the extracted code runs on CPU
            # tensors
            "IS_XPU": False, "IS_CUDA": True,
            "DEVICE": torch.device("cpu"),
            "is_metric": lambda: metric,
            "FOREGROUND_SCALE": fg, "AA_STRENGTH": aa,
        },
    )


def port_depth(model, spec, img, depth_resolution: int, device, post: bool = False,
               foreground_scale: float = 0.0, aa_strength: float = 1.0):
    """The port's side of the gate, as the JAX tool runs its own: the uint8
    RGB image [H, W, 3] on `device` in f32 → patch-aligned bicubic
    antialiased resize → /255 → the family's normalisation → `model` → its
    raw depth [h, w], or with `post` `post_process_depth` and the bilinear
    resize back to [H, W] (the reference oracle's output).  A numpy array."""
    import numpy as np
    import torch

    from desktop2stereo_tpu_torch.ops.depth_post import post_process_depth
    from desktop2stereo_tpu_torch.ops.normalize import normalize_for_model
    from desktop2stereo_tpu_torch.ops.resize import resize, resize_patch_aligned

    h, w = img.shape[:2]
    x = torch.from_numpy(np.array(img)).to(device=device, dtype=torch.float32)[None]
    x = resize_patch_aligned(x, depth_resolution, spec.patch_size) / 255.0
    x = normalize_for_model(x, spec.norm_family)
    with torch.inference_mode():
        d = model(x)[0]
        if post:
            d = post_process_depth(d, metric=spec.metric, foreground_scale=foreground_scale,
                                   aa_strength=aa_strength)
            d = resize(d[..., None], (h, w), mode="bilinear")[..., 0]
    return d.float().cpu().numpy()


def verify_depth(model_name: str, checkpoint: Optional[str] = None,
                 image: Optional[str] = None, tol: float = 1e-2,
                 depth_resolution: int = 518, foreground_scale: float = 0.0,
                 aa_strength: float = 1.0, device=None) -> dict:
    """Real-weight parity gate: the oracle against the port's pipeline.

    Patch-aligned resize → /255 → family normalisation → model (→
    post_process_depth → bilinear resize back, with the reference oracle),
    both sides in f32: the oracle on the CPU, the port on `device` (the
    CUDA policy's when None, TF32 off).  Oracle ladder: with the reference
    tree mounted, its own predict_depth numerics run `transformers`' model;
    without it, the raw `predicted_depth` of `transformers`' model, which
    still gates the converted weights.  Prints and returns the verdict."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    transformers = _require("transformers", "--verify-depth")
    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models import factory
    from desktop2stereo_tpu_torch.ops.normalize import norm_constants
    from desktop2stereo_tpu_torch.ops.resize import patch_aligned_size

    spec = get_spec(model_name)
    if spec.family not in GATE_FAMILIES:
        raise NotImplementedError(
            f"--verify-depth drives torch via transformers AutoModel; family "
            f"{spec.family!r} has no AutoModel loader (use the family parity "
            "tests instead)")
    device = torch.device(cuda_policy().device if device is None else device)
    if device.type == "cuda":
        cuda_policy(device.index or 0)  # TF32 off: a true f32 run

    ckpt = checkpoint or factory.find_checkpoint(spec)
    if ckpt is None:
        raise SystemExit(f"no checkpoint found for {model_name}")
    if os.path.isdir(ckpt):
        ckpt_dir = ckpt
        ckpt = os.path.join(ckpt_dir, "model.safetensors")
        if not os.path.exists(ckpt):
            raise SystemExit(f"{ckpt_dir} has no model.safetensors")
    else:
        ckpt_dir = os.path.dirname(ckpt)

    img = _load_image(image)
    h, w = img.shape[:2]

    # ---- the oracle: the checkpoint through transformers, f32 on the CPU ----
    tmodel = transformers.AutoModelForDepthEstimation.from_pretrained(
        ckpt_dir, trust_remote_code=False, torch_dtype=torch.float32)
    tmodel.eval()
    mean, std = norm_constants(spec.norm_family)
    ns = _reference_predict_depth_ns(spec.metric, foreground_scale, aa_strength)
    oracle = "reference-ast" if ns is not None else "raw-forward"
    t_in = torch.from_numpy(img.copy()).permute(2, 0, 1)[None]  # [1, 3, H, W] u8
    if ns is not None:
        t_res = ns["_resize_patch_aligned_t"](
            t_in, depth_resolution, spec.patch_size).to(torch.float32) / 255.0
    else:
        nh, nw = patch_aligned_size(h, w, depth_resolution, spec.patch_size)
        t_res = F.interpolate(t_in.float(), size=(nh, nw), mode="bicubic",
                              align_corners=False, antialias=True) / 255.0
    t_norm = (t_res - torch.tensor(mean).view(1, 3, 1, 1)) / torch.tensor(std).view(1, 3, 1, 1)
    with torch.no_grad():
        t_raw = tmodel(pixel_values=t_norm).predicted_depth  # [1, h, w]
    if ns is not None:
        t_depth = ns["post_process_depth"](t_raw)
        t_depth = F.interpolate(t_depth[None, None], size=(h, w), mode="bilinear",
                                align_corners=False)[0, 0]
        ref_out = t_depth.numpy()
    else:
        ref_out = t_raw[0].numpy()
    del tmodel

    # ---- the port: the same checkpoint through its own loader and pipeline ----
    model, _ = factory.build_bound(model_name, device=device, dtype=torch.float32,
                                   checkpoint=ckpt)
    got = port_depth(model, spec, img, depth_resolution, device, post=ns is not None,
                     foreground_scale=foreground_scale, aa_strength=aa_strength)

    rel_max = float(np.abs(got - ref_out).max() / max(float(np.abs(ref_out).max()), 1e-6))
    rel_mean = float(np.abs(got - ref_out).mean() / max(float(np.abs(ref_out).mean()), 1e-6))
    verdict = {
        "gate": "verify-depth",
        "model": model_name,
        "checkpoint": ckpt,
        "image": image or "auto",
        "oracle": oracle,
        "depth_resolution": depth_resolution,
        "shape": list(ref_out.shape),
        "rel_err_max": rel_max,
        "rel_err_mean": rel_mean,
        "tol": tol,
        "pass": bool(rel_max <= tol),
        "egress": probe_egress(),
        "device": str(device),
    }
    print(json.dumps(verdict))
    return verdict


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="d2s-convert")
    p.add_argument("--model", help="registry model name to download")
    p.add_argument("--model-path", help="local torch folder to re-serialize")
    p.add_argument("--verify", action="store_true",
                   help="build the model from its checkpoint and report params")
    p.add_argument("--verify-depth", action="store_true",
                   help="real-weight depth parity gate against transformers (JSON verdict; "
                        "exit 1 on fail)")
    p.add_argument("--checkpoint", help="explicit checkpoint file/dir for --verify-depth "
                                        "(else local caches)")
    p.add_argument("--image", help="test image for --verify-depth (default: the reference's "
                                   "cats.jpg, else synthetic)")
    p.add_argument("--tol", type=float, default=1e-2, help="--verify-depth max rel-err tolerance")
    p.add_argument("--depth-res", type=int, default=518,
                   help="--verify-depth model input resolution")
    p.add_argument("--skip-download", action="store_true",
                   help="use local caches, no hub pull")
    p.add_argument("--make-random-snapshot", metavar="DIR",
                   help="write a full HF-format snapshot of --model at its real architecture "
                        "with seeded random weights into DIR (a stand-in for the hub "
                        "download; feed it back via --checkpoint)")
    p.add_argument("--seed", type=int, default=7, help="--make-random-snapshot weight seed")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the port's side runs: cuda (the default; exits 2 without a "
                        "card) or cpu (the plain versions)")
    args = p.parse_args(argv)
    device = None
    if args.model and (args.verify or args.verify_depth):
        from desktop2stereo_tpu_torch.cli import device_policy

        device, _ = device_policy(args.device, fp32=True)
    try:
        if args.make_random_snapshot:
            if not args.model:
                raise SystemExit("--make-random-snapshot needs --model")
            path = make_random_snapshot(args.model, args.make_random_snapshot, seed=args.seed)
            if not args.verify_depth:
                return
            args.checkpoint = path
        if args.model_path:
            reserialize(args.model_path)
        if args.model:
            if not (args.skip_download or (args.verify_depth and args.checkpoint)):
                download(args.model)
            if args.verify:
                verify(args.model, device)
            if args.verify_depth:
                verdict = verify_depth(args.model, checkpoint=args.checkpoint,
                                       image=args.image, tol=args.tol,
                                       depth_resolution=args.depth_res, device=device)
                if not verdict["pass"]:
                    sys.exit(1)
    except ImportError as e:
        raise SystemExit(f"[convert] {e}")
    if not args.model and not args.model_path:
        p.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
