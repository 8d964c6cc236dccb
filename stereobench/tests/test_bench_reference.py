"""The frozen plain reference against the program's CPU path, on the same
seeded weights, before the card compares them at full size.

DA-V2-Large is held whole at a 126×224 input.  DepthPro-Large takes only
1536², so it is held part by part at its published widths (the patch
encoder on three tiles, the image encoder on one, the decoder and head on
small maps of their own) and whole at a small width and a small input
(tiles of 56 px at 224²), which exercises the tiling, merging and resizes.
The tests import the program; the reference does not.
"""

import pytest
import torch

from stereobench import manifest, traffic, weights
from stereobench.reference import depthpro as ref_depthpro
from stereobench.reference import frame as F
from stereobench.reference import vit
from stereobench.tests.bench_helpers import config

from desktop2stereo_tpu_torch.core.registry import get_spec
from desktop2stereo_tpu_torch.models import depthpro as port_depthpro
from desktop2stereo_tpu_torch.models.dinov2 import Dinov2Encoder
from desktop2stereo_tpu_torch.models.factory import FAMILIES

F_MEAN, F_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)  # DA-V2's normalisation


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _pair(ref_module, port_module, seed):
    """Seeded weights (f32, CPU) into the reference and the program."""
    state = weights.draw(ref_module, {"layer_scale": 1.0, "token_std": 0.02, "bias_std": 0.02},
                         seed, torch.device("cpu"), torch.float32)
    ref_module.load_state_dict(state, strict=True)
    port_module.load_state_dict(state, strict=True)
    return ref_module.eval(), port_module.eval()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@torch.no_grad()
def test_da2_large_whole_at_126x224():
    cfg = config("da2-large-518")
    spec = get_spec(cfg["model"])
    ref, port = _pair(manifest.family(cfg).build(cfg), FAMILIES[spec.family][0](spec), 11)
    x = torch.randn(2, 126, 224, 3, generator=torch.Generator().manual_seed(1))
    want = ref(x.permute(0, 3, 1, 2))
    got = port(x)
    assert got.shape == want.shape == (2, 126, 224)
    assert _rel(got, want) < 1e-4


@torch.no_grad()
def test_depthpro_patch_and_image_encoders_at_full_width():
    cfg = config("depthpro-large-1536")
    hooks = sorted({*cfg["intermediate_hook_ids"], 23})
    ref = vit.Dinov2(1024, 24, 16, 4096, 14, hooks, 27, 1e-6, (23,))
    port = Dinov2Encoder(1024, 24, 16, 4096, tuple(hooks), patch_size=14, pretrain_grid=27,
                         final_norm_indices=(23,))
    ref, port = _pair(ref, port, 12)
    tiles = torch.randn(3, 384, 384, 3, generator=torch.Generator().manual_seed(2))
    for got, want in zip(port(tiles), ref(tiles.permute(0, 3, 1, 2))):
        assert got.shape == want.shape == (3, 730, 1024)
        assert _rel(got, want) < 1e-4


@torch.no_grad()
def test_depthpro_decoder_and_head_at_full_width():
    """The decoder's 1024- to 256-channel blocks at their widths, on maps of
    a 6-pixel base instead of 48 (encoders of 12 layers: they do not run)."""
    cfg = dict(config("depthpro-large-1536"), num_hidden_layers=12)
    ref, port = _pair(ref_depthpro.build(cfg), port_depthpro.DepthPro(vit_layers=12), 13)
    g = torch.Generator().manual_seed(3)
    image = torch.randn(1, 6, 6, 1024, generator=g)
    feats = [torch.randn(1, s, s, 1024, generator=g) for s in (6, 12, 24, 24, 24)]
    port.encode = lambda pixels: (image, feats)
    ref.encode = lambda pixels: (image.permute(0, 3, 1, 2), [f.permute(0, 3, 1, 2) for f in feats])
    got, want = port(None), ref(None)
    assert got.shape == want.shape == (1, 384, 384)  # 64 × the base, as 3072 is of 48
    assert _rel(got, want) < 1e-4


@torch.no_grad()
def test_depthpro_whole_at_a_small_width():
    cfg = _small_depthproconfig()
    port = port_depthpro.DepthPro(patch_px=56, vit_hidden=64, vit_layers=12, vit_heads=4,
                                  vit_mlp=128, fusion=32, scaled_dims=(64, 64, 32),
                                  hook_dims=(32, 32))
    ref, port = _pair(ref_depthpro.build(cfg), port, 14)
    x = torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(4))
    got, want = port(x), ref(x.permute(0, 3, 1, 2))
    assert got.shape == want.shape
    assert _rel(got, want) < 1e-4


def test_frame_path_against_the_program_in_float32():
    """Capture → model input, display depth, the EMA and the Half-SBS tail
    of the reference against the program's stages in f32 on one frame."""
    from desktop2stereo_tpu_torch.ops.depth_post import ema, post_process_depth
    from desktop2stereo_tpu_torch.ops.kernels.dibr import dibr_pair_half
    from desktop2stereo_tpu_torch.ops.normalize import normalize_for_model
    from desktop2stereo_tpu_torch.ops.resize import resize, resize_halved

    frame = traffic.desktop_frames(1, 216, 384, 5)[0]
    x = torch.from_numpy(frame)
    planar = F.planar_rgb(x, (216, 384))
    # model input: bicubic with antialias to the patch-aligned size
    mi = F.model_input(planar, (126, 224), "bicubic", True, F_MEAN, F_STD)
    port_mi = normalize_for_model(
        resize(x[..., :3].flip(-1).float()[None], (126, 224), mode="bicubic",
               antialias=True) / 255.0)
    assert (mi.permute(0, 2, 3, 1) - port_mi).abs().max() < 1e-4
    raw = torch.rand(126, 224, generator=torch.Generator().manual_seed(6)) + 0.1
    for metric in (False, True):
        want = F.display_depth(raw, metric, 0.3, 2.0)
        got = post_process_depth(raw, metric=metric, foreground_scale=0.3, aa_strength=2.0)
        assert (want - got).abs().max() < 1e-5
    prev = torch.rand(126, 224)
    assert torch.allclose(F.ema_step(prev, raw, 0.9), ema(prev, raw, 0.9), atol=1e-6)
    depth = F.display_depth(raw, False, 0.0, 2.0)
    want = F.half_sbs(planar, depth, ipd=0.064, depth_strength=2.0, convergence=0.0)
    dep_h = resize_halved(depth[..., None], (216, 384), halve_axis=1)[..., 0]
    rgb_h = (planar[..., 0::2] + planar[..., 1::2]) * 0.5
    got = dibr_pair_half(rgb_h.contiguous(), dep_h.contiguous(), ipd=0.064, depth_strength=2.0,
                         convergence=0.0)
    diff = (got.int() - want.int()).abs()
    assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3



def _small_depthproconfig():
    return dict(config("depthpro-large-1536"), hidden_size=64, num_attention_heads=4,
                intermediate_size=128, patch_size=56, scaled_images_feature_dims=[64, 64, 32],
                intermediate_feature_dims=[32, 32], fusion_hidden_size=32, num_hidden_layers=12)


@pytest.mark.parametrize("family", ["depthpro", "depth_anything"])
@torch.no_grad()
def test_folded_arithmetic_is_the_plain_arithmetic_in_float64(family):
    """The yardstick's folded resizes and expansions (`reference/tables.py`)
    compute the same function as the plain layers: in float64 they agree to
    rounding, so in bfloat16 they differ by rounding alone."""
    from stereobench.reference import depth_anything as ref_da2
    from stereobench.reference import tables

    if family == "depthpro":
        model, size = ref_depthpro.build(_small_depthproconfig()), (224, 224)
    else:
        cfg = dict(config("da2-large-518"), hidden_size=64, num_attention_heads=4,
                   intermediate_size=128, num_hidden_layers=4, out_indices=[0, 1, 2, 3],
                   neck_hidden_sizes=[16, 32, 64, 64], fusion_hidden_size=32)
        model, size = ref_da2.build(cfg), (126, 224)
    g = torch.Generator().manual_seed(8)
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5)
    model = model.double()
    x = torch.randn(1, 3, *size, generator=g, dtype=torch.float64)
    plain = model(x)
    with tables.folded():
        folded = model(x)
    assert _rel(folded, plain) < 1e-12
    for n_in, n_out, corners in ((7, 13, False), (13, 7, False), (24, 48, True), (9, 4, True)):
        t = torch.randn(1, 2, n_in, n_in + 3, generator=g, dtype=torch.float64)
        want = torch.nn.functional.interpolate(t, size=(n_out, n_out + 1), mode="bilinear",
                                               align_corners=corners)
        with tables.folded():
            assert (tables.interpolate(t, (n_out, n_out + 1), corners) - want).abs().max() < 1e-12
