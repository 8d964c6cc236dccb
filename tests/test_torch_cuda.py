"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc, so they skip elsewhere (the CPU tests
cover the plain versions against the JAX package).  On a CUDA host:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from desktop2stereo_tpu_torch.ops.kernels import attention as K2
from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K5
from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
from desktop2stereo_tpu_torch.ops.kernels import warp as K3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(1, 778, 16, 64), (2, 130, 4, 64), (1, 1370, 12, 64), (3, 1, 2, 64)])
def test_attention_kernel_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
    before = K2.KERNEL.launches
    got = K2.attention(q, k, v)
    assert K2.KERNEL.launches == before + 1
    want = K2.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    # bf16 output rounding and bf16 probabilities vs an f32 softmax
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_attention_kernel_reads_qkv_views(dev):
    qkv = torch.randn(1, 778, 3 * 1024, device=dev).bfloat16()
    q, k, v = (t.unflatten(-1, (16, 64)) for t in qkv.split(1024, dim=-1))
    got = K2.attention(q, k, v)
    want = K2.attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def _qkv_layout(layout, B, N, H, gen, dev):
    """bf16 q/k/v [B, N, H, 64] as the encoder's qkv views, contiguous, or
    as transposed views of [B, H, N, 64] (tokens nearer than heads)."""
    if layout == "qkv views":
        qkv = torch.randn(B, N, 3 * H * 64, generator=gen, device=dev).bfloat16()
        return [t.unflatten(-1, (H, 64)) for t in qkv.split(H * 64, dim=-1)]
    if layout == "heads-major":
        return [torch.randn(B, H, N, 64, generator=gen, device=dev).bfloat16().transpose(1, 2)
                for _ in range(3)]
    return [torch.randn(B, N, H, 64, generator=gen, device=dev).bfloat16() for _ in range(3)]


@pytest.mark.parametrize("layout", ["contiguous", "qkv views", "heads-major"])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 778, 1370])
def test_attention_kernel_matches_plain_at_tile_edges(dev, N, layout):
    """Query tiles are 64 rows and K/V tiles 128 keys: N on either side of
    both, the flagship's 778 and a 1370-token family, batch 2."""
    gen = torch.Generator(device=dev).manual_seed(N)
    q, k, v = _qkv_layout(layout, 2, N, 3, gen, dev)
    before = K2.KERNEL.launches
    got = K2.attention(q, k, v)
    assert K2.KERNEL.launches == before + 1
    want = K2.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.shape == (2, N, 3, 64) and got.is_contiguous()
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_attention_kernel_refuses_other_head_dims(dev):
    q = torch.zeros(1, 8, 2, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 64"):
        K2.attention(q, q, q)


@pytest.mark.parametrize("eh,ew", [(2160, 1920), (50, 200), (96, 256)])
@pytest.mark.parametrize("feather", [0.0, 0.02])
@pytest.mark.parametrize("arrangement", ["sbs", "tab"])
def test_dibr_kernel_matches_plain(dev, eh, ew, feather, arrangement):
    rng = np.random.default_rng(eh + ew)
    rgb = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random((eh, ew), dtype=np.float32)).to(dev)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01, feather=feather,
              arrangement=arrangement)
    before = K1.KERNEL.launches
    got = K1.dibr_pair_half(rgb, dep, **kw)
    assert K1.KERNEL.launches == before + 1
    want = K1.dibr_pair_half_ref(rgb, dep, **kw)
    torch.cuda.synchronize()
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("eh,ew", [(2160, 1920), (50, 200), (9, 22)])
def test_dibr_stream_axis_equals_single_launches(dev, eh, ew):
    """K1 over a stream axis of 2 (one launch an entry) is bit-equal, row
    for row, to one-frame launches; the eyes at twice the width, as the
    generic tail runs them."""
    rng = np.random.default_rng(eh + 7 * ew)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    for w, eyes in ((ew, False), (2 * ew, True)):
        rgb = torch.from_numpy(rng.random((2, 3, eh, w), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((2, eh, w), dtype=np.float32)).to(dev)
        before = K1.KERNEL.launches
        if eyes:
            got = K1.dibr_pair_eyes(rgb, dep, **kw)
            assert K1.KERNEL.launches == before + 1
            for s in range(2):
                one = K1.dibr_pair_eyes(rgb[s], dep[s], **kw)
                assert all(torch.equal(g[s], o) for g, o in zip(got, one))
        else:
            for arrangement in ("sbs", "tab"):
                got = K1.dibr_pair_half(rgb, dep, feather=0.02, arrangement=arrangement, **kw)
                assert K1.KERNEL.launches == before + 1
                before = K1.KERNEL.launches
                for s in range(2):
                    one = K1.dibr_pair_half(rgb[s], dep[s], feather=0.02,
                                            arrangement=arrangement, **kw)
                    assert torch.equal(got[s], one)
                before = K1.KERNEL.launches


@pytest.mark.parametrize("eh,ew", [(2160, 3840), (50, 200), (96, 256)])
def test_dibr_eyes_kernel_matches_plain(dev, eh, ew):
    rng = np.random.default_rng(eh * ew)
    rgb = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random((eh, ew), dtype=np.float32)).to(dev)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    before = K1.KERNEL.launches
    got = K1.dibr_pair_eyes(rgb, dep, **kw)
    assert K1.KERNEL.launches == before + 1
    want = K1.dibr_pair_eyes_ref(rgb, dep, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == (3, eh, ew) and g.dtype == torch.float32
        diff = (K1.quantize_u8(g).int() - K1.quantize_u8(w).int()).abs()
        assert diff.max().item() <= 1
        assert (diff > 0).float().mean().item() <= 1e-3


# Widths 1-3 (below one 4-pixel group), 513 (one more than a 512-pixel
# segment: two blocks) and 7680 (8K full width, 15 blocks); heights 1-4, so
# the ±2-row taps clamp at both ends
_EDGE_W = (1, 2, 3, 513, 7680)
_EDGE_H = (1, 2, 3, 4)


def _dibr_frame(dev, h, w, seed):
    """Planar rgb and a depth of runs of levels plus noise (many edges)."""
    rng = np.random.default_rng(seed)
    rgb = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) * 255).to(dev)
    runs = np.repeat(rng.random((h, w // 3 + 1)), 3, axis=1)[:, :w]
    dep = np.clip(runs + rng.normal(0, 0.01, (h, w)), 0, 1).astype(np.float32)
    return rgb, torch.from_numpy(dep).to(dev)


def _assert_u8_close(got, want):
    """≤1 LSB on ≤0.1% of the values (one value where a frame holds fewer
    than 1000)."""
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3 or diff.numel() < 1000 and (
        (diff > 0).sum().item() <= 1)


@pytest.mark.parametrize("feather", [0.0, 0.02])
@pytest.mark.parametrize("arrangement", ["sbs", "tab"])
@pytest.mark.parametrize("eh", _EDGE_H)
@pytest.mark.parametrize("ew", _EDGE_W)
def test_dibr_kernel_matches_plain_at_edges(dev, ew, eh, arrangement, feather):
    rgb, dep = _dibr_frame(dev, eh, ew, seed=ew * 7 + eh)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01, feather=feather,
              arrangement=arrangement)
    got = K1.dibr_pair_half(rgb, dep, **kw)
    want = K1.dibr_pair_half_ref(rgb, dep, **kw)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.uint8
    _assert_u8_close(got, want)


@pytest.mark.parametrize("h", _EDGE_H)
@pytest.mark.parametrize("w", _EDGE_W)
def test_dibr_eyes_kernel_matches_plain_at_edges(dev, w, h):
    rgb, dep = _dibr_frame(dev, h, w, seed=w * 5 + h)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    got = K1.dibr_pair_eyes(rgb, dep, **kw)
    want = K1.dibr_pair_eyes_ref(rgb, dep, **kw)
    torch.cuda.synchronize()
    for g, wt in zip(got, want):
        assert g.shape == (3, h, w) and g.dtype == torch.float32
        _assert_u8_close(K1.quantize_u8(g), K1.quantize_u8(wt))


@pytest.mark.parametrize("w", [200, 1920, 3840, 7680, 16000])
def test_dibr_kernels_give_the_same_bits_with_segments_or_whole_rows(dev, w, monkeypatch):
    """Segment target 0 stages the whole row, and the warp gathers read it
    from shared memory, up to 9,660 columns (24 bytes a column); a wider row
    (16000) is split into blocks that gather from global memory.  Both K1
    entry points and K5 give the same bits with 512-pixel segments (K1's
    whole rows below WHOLE_ROW_SMEM turned off)."""
    rgb, dep = _dibr_frame(dev, 3, w, seed=w)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    rgb_hwc = rgb.permute(1, 2, 0).contiguous()
    conf = torch.rand(3, w, device=dev)
    px = _warp_px((3, w), dev, seed=3)
    runs = {}
    monkeypatch.setattr(K1, "WHOLE_ROW_SMEM", 0)
    for target in (512, 0):
        monkeypatch.setattr(K1, "SEG_TARGET", target)
        monkeypatch.setattr(K5, "SEG_TARGET", target)
        runs[target] = (K1.dibr_pair_half(rgb, dep, feather=0.02, **kw),
                        *K1.dibr_pair_eyes(rgb, dep, **kw),
                        K5.dibr_warp_fill_blend(rgb_hwc, dep, conf, px, sweep_sign=-1.0))
    assert K1.tile_geometry(w, 12, 0).grid_x == (2 if w == 16000 else 1)
    for a, b in zip(runs[512], runs[0]):
        assert torch.equal(a, b)
    _assert_u8_close(runs[0][0], K1.dibr_pair_half_ref(rgb, dep, feather=0.02, **kw))


def _warp_px(shape, dev, seed):
    H, W = shape
    rng = np.random.default_rng(seed)
    base = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    px = np.clip(base + rng.uniform(-60, 60, (H, W)), 0, W - 1).astype(np.float32)
    px[:, -1] = W - 1
    return torch.from_numpy(px).to(dev)


@pytest.mark.parametrize("shape", [(2160, 3840, 3), (50, 200, 3), (96, 256, 1), (9, 1, 3)])
def test_warp_kernel_matches_plain(dev, shape):
    rng = np.random.default_rng(sum(shape))
    img = torch.from_numpy(rng.random(shape, dtype=np.float32) * 255).to(dev)
    px = _warp_px(shape[:2], dev, seed=1)
    before = K3.KERNEL.launches
    got = K3.horizontal_sample(img, px)
    assert K3.KERNEL.launches == before + 1
    want = K3.horizontal_sample_ref(img, px)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("H,W", [(2160, 3840), (50, 200), (96, 256)])
def test_dibr_fill_kernel_matches_plain(dev, H, W, sign):
    rng = np.random.default_rng(H + W)
    rgb = torch.from_numpy(rng.random((H, W, 3), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    conf = torch.from_numpy(rng.random((H, W), dtype=np.float32)).to(dev)
    px = _warp_px((H, W), dev, seed=2)
    before = K5.KERNEL.launches
    got = K5.dibr_warp_fill_blend(rgb, dep, conf, px, sweep_sign=sign)
    assert K5.KERNEL.launches == before + 1
    want = K5.dibr_warp_fill_blend_ref(rgb, dep, conf, px, sweep_sign=sign)
    torch.cuda.synchronize()
    diff = (K1.quantize_u8(got).int() - K1.quantize_u8(want).int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("radius", [0, 1, 12, 32])
@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("W", _EDGE_W)
def test_dibr_fill_kernel_matches_plain_at_edges(dev, W, H, radius, sign):
    rgb, dep = _dibr_frame(dev, H, W, seed=W + H + radius)
    rgb = rgb.permute(1, 2, 0).contiguous()
    conf = torch.rand(H, W, device=dev)
    px = _warp_px((H, W), dev, seed=W)
    kw = dict(sweep_sign=sign, search_radius=radius)
    got = K5.dibr_warp_fill_blend(rgb, dep, conf, px, **kw)
    want = K5.dibr_warp_fill_blend_ref(rgb, dep, conf, px, **kw)
    torch.cuda.synchronize()
    assert got.shape == (H, W, 3)
    _assert_u8_close(K1.quantize_u8(got), K1.quantize_u8(want))


def _dense(dev, M, K, F, dtype, with_bias, seed):
    """Activations whose rows span four decades, an int8 weight [F, K] with
    its f32 scales, and a bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)) * 10.0 ** rng.uniform(-2, 2, (M, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (F, K)).astype(np.int8)).to(dev)
    scale = torch.from_numpy((rng.random(F) * 1e-3 + 1e-4).astype(np.float32)).to(dev)
    bias = (torch.from_numpy(rng.standard_normal(F).astype(np.float32)).to(dev)
            if with_bias else None)
    return x, wq, scale, bias


@pytest.mark.parametrize("M,K,F,dtype,with_bias", [
    (778, 1024, 3072, torch.bfloat16, True),   # ViT-L qkv at depth resolution 518
    (778, 4096, 1024, torch.bfloat16, True),   # ViT-L fc2
    (7, 64, 200, torch.float32, False),        # ragged rows and features
    (130, 96, 96, torch.float32, True),        # K an odd multiple of 32
])
def test_quant_dense_kernel_matches_plain_exactly(dev, M, K, F, dtype, with_bias):
    x, wq, scale, bias = _dense(dev, M, K, F, dtype, with_bias, seed=M + K + F)
    before = K4.KERNEL.launches
    got = K4.quant_dense(x, wq, scale, bias)
    assert K4.KERNEL.launches == before + 1
    want = K4.quant_dense_ref(x, wq, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, F)
    assert torch.equal(got, want)


# Both tile heights (64 and 128 rows) and their edges, feature counts below,
# across and at the 128-feature tile, and K from one 32-wide step to 32
# stages of 128; each case takes one of the four (dtype, bias) variants, in
# turn, so every variant meets every M, F and K.
_VARIANTS = ((torch.bfloat16, True), (torch.float32, False), (torch.bfloat16, False),
             (torch.float32, True))
_EDGE_M = (1, 63, 64, 65, 129, 778)
_EDGE_F = (96, 200, 1024, 3072)
_EDGE_K = (32, 96, 1024, 4096)


@pytest.mark.parametrize("K", _EDGE_K)
@pytest.mark.parametrize("F", _EDGE_F)
@pytest.mark.parametrize("M", _EDGE_M)
def test_quant_dense_kernel_exact_at_tile_edges(dev, M, F, K):
    dtype, with_bias = _VARIANTS[(_EDGE_M.index(M) + _EDGE_F.index(F) + _EDGE_K.index(K)) % 4]
    x, wq, scale, bias = _dense(dev, M, K, F, dtype, with_bias, seed=M * 7 + F * 3 + K)
    got = K4.quant_dense(x, wq, scale, bias)
    want = K4.quant_dense_ref(x, wq, scale, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (M, F)
    assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,F", [(1, 96, 200), (65, 4096, 1024), (778, 1024, 3072)])
def test_quant_dense_kernel_row_scale_and_int32_modes_at_edges(dev, M, K, F):
    x, wq, scale, bias = _dense(dev, M, K, F, torch.bfloat16, True, seed=M + K + F)
    rs = x.float().abs().amax(dim=-1, keepdim=True) / 100.0  # clips the largest values
    assert torch.equal(K4.quant_dense(x, wq, scale, bias, row_scale=rs),
                       K4.quant_dense_ref(x, wq, scale, bias, row_scale=rs))
    xi = x.float().clamp(-127, 127).round()  # integer-valued: with row_scale 1, q = x
    ones = torch.ones(M, 1, device=dev)
    acc = K4.quant_dense(xi, wq, scale, row_scale=ones, out_dtype=torch.int32)
    exact = (xi.double() @ wq.double().T).to(torch.int64)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and torch.equal(acc.to(torch.int64), exact)


def test_quant_dense_kernel_reads_strided_rows(dev):
    """x may be a view with a row stride (lda) wider than K."""
    x, wq, scale, bias = _dense(dev, 130, 1024, 200, torch.bfloat16, True, seed=8)
    wide = torch.zeros(130, 1024 + 64, device=dev, dtype=torch.bfloat16)
    wide[:, 32:32 + 1024] = x
    view = wide[:, 32:32 + 1024]
    assert view.stride(0) == 1088
    want = K4.quant_dense_ref(x, wq, scale, bias)
    assert torch.equal(K4.quant_dense(view, wq, scale, bias), want)


def test_quant_dense_kernel_row_scale_and_int32_modes(dev):
    x, wq, scale, bias = _dense(dev, 130, 256, 200, torch.float32, True, seed=5)
    rs = x.abs().amax(dim=-1, keepdim=True) / 200.0  # clips the largest values
    got = K4.quant_dense(x, wq, scale, bias, row_scale=rs)
    assert torch.equal(got, K4.quant_dense_ref(x, wq, scale, bias, row_scale=rs))
    xi = x.clamp(-100, 100).round()  # integer-valued: with row_scale 1, q = x
    ones = torch.ones(130, 1, device=dev)
    acc = K4.quant_dense(xi, wq, scale, row_scale=ones, out_dtype=torch.int32)
    want = (xi.double() @ wq.double().T).to(torch.int64)
    torch.cuda.synchronize()
    assert acc.dtype == torch.int32 and torch.equal(acc.to(torch.int64), want)


def test_quant_dense_kernel_refuses_what_it_does_not_take(dev):
    x, wq, scale, bias = _dense(dev, 16, 64, 32, torch.bfloat16, True, seed=6)
    with pytest.raises(ValueError, match="multiple of 32"):
        K4.quant_dense(x[:, :48], wq[:, :48].contiguous(), scale, bias)
    with pytest.raises(ValueError, match="bf16 or f32"):
        K4.quant_dense(x.half(), wq, scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        K4.quant_dense(x, torch.cat([wq, wq], dim=1)[:, ::2], scale, bias)


def test_reader_loads_a_checkpoint_onto_the_card(dev, tmp_path):
    from desktop2stereo_tpu_torch.models import safetensors_io

    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((64, 48)).astype(np.float16),
              "b": rng.standard_normal(48).astype(np.float32),
              "steps": np.arange(-4, 4, dtype=np.int32)}
    index = safetensors_io.save_sharded(arrays, tmp_path, shards=2)
    for path in (index, tmp_path / "model-00001-of-00002.safetensors"):
        got = safetensors_io.load_tensors(path, dev)
        assert set(got) == set(arrays)
        for k, a in arrays.items():
            assert got[k].device == dev and got[k].dtype == torch.from_numpy(a).dtype
            assert torch.equal(got[k].cpu(), torch.from_numpy(a)), k


def _moving_frames(n, h, w, seed):
    """Seeded BGRA frames: a smooth scene moving a few pixels a frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for t in range(n):
        base = 128 + 90 * np.sin((xx + 6 * t) / 23.0) * np.cos(yy / 17.0)
        rgb = base[..., None] + np.array([0.0, 25.0, -25.0]) + rng.normal(0, 8, (h, w, 3))
        bgra = np.full((h, w, 4), 255, np.uint8)
        bgra[..., :3] = np.clip(rgb[..., ::-1], 0, 255)
        out.append(bgra)
    return out


def test_vda_streams_on_the_card_like_the_cpu(dev):
    """Video-Depth-Anything-Small from one seed through ProgramCache, three
    frames (first, step, step): the card in bf16 with its kernels (12 K2 and
    one K1 a frame) against the CPU in f32 with the plain versions, each
    frame held to chip_smoke.py's reference thresholds (depth mean ≤ 0.03,
    SBS mean ≤ 3 LSB, ≤ 3% of values more than 32 LSB off)."""
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.pipeline import programs as P

    name = "Video-Depth-Anything-Small"
    card, spec = build_bound(name, device=dev, seed=0)
    cpu, _ = build_bound(name, device="cpu", seed=0)
    cfg = P.ProgramConfig(model_name=name, depth_resolution=196, output_height=216,
                          display_mode="Half-SBS", ipd=0.064, depth_strength=2.0,
                          convergence=0.0, foreground_scale=0.0, aa_strength=2.0,
                          ema_alpha=0.9, temporal_smooth=True, quality="high",
                          emit_depth="model")
    card_prog = P.ProgramCache(cfg, card, spec, compute_dtype=torch.bfloat16)
    cpu_prog = P.ProgramCache(cfg, cpu, spec, compute_dtype=torch.float32)
    k2, k1 = K2.KERNEL.launches, K1.KERNEL.launches
    for frame in _moving_frames(3, 216, 384, seed=1):
        sbs_c, depth_c = (t.cpu() for t in card_prog(frame))
        sbs_r, depth_r = cpu_prog(frame)
        assert sbs_c.shape == sbs_r.shape == (216, 384, 3) and torch.isfinite(depth_c).all()
        s_err = (sbs_c.int() - sbs_r.int()).abs().float()
        assert (depth_c - depth_r).abs().mean().item() <= 0.03
        assert s_err.mean().item() <= 3.0 and (s_err > 32).float().mean().item() <= 0.03
    assert K2.KERNEL.launches - k2 == 3 * 12 and K1.KERNEL.launches - k1 == 3
    (key,) = card_prog._states
    carry, carry_r = card_prog._states[key].model, cpu_prog._states[key].model
    assert len(carry) == 8
    for c, r in zip(carry, carry_r):
        assert c.shape == r.shape and c.shape[2] == 31 and c.dtype == torch.bfloat16
        assert torch.isfinite(c).all()


def test_attention_kernel_on_rope_qk_and_strided_v(dev):
    """DA3's inputs to K2: q and k through the per-head LayerNorm and the 2D
    RoPE rotation (fresh contiguous bf16 tensors), v still a strided view of
    the qkv product, at DA3-LARGE's 721 tokens."""
    import torch.nn.functional as F

    from desktop2stereo_tpu_torch.models import da3

    B, N, H = 1, 721, 16
    gen = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn(B, N, 3 * H * 64, generator=gen, device=dev).bfloat16()
    q, k, v = (t.unflatten(-1, (H, 64)) for t in qkv.split(H * 64, dim=-1))
    cos, sin = da3._rope(64, 20, 36, 1, True, dev, torch.bfloat16)
    q = da3._apply_rope(F.layer_norm(q, (64,), eps=1e-5), cos, sin)
    k = da3._apply_rope(F.layer_norm(k, (64,), eps=1e-5), cos, sin)
    assert q.is_contiguous() and k.is_contiguous() and not v.is_contiguous()
    before = K2.KERNEL.launches
    got = K2.attention(q, k, v)
    assert K2.KERNEL.launches == before + 1
    want = K2.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_tiny_da3_on_the_card_like_the_cpu(dev):
    """DA3-SMALL and DA3MONO-LARGE from one seed through ProgramCache, two
    frames each: the card in bf16 with its kernels (12 or 24 K2 and one K1 a
    frame) against the CPU in f32 with the plain versions, held to
    chip_smoke.py's reference thresholds.  The mono frame's depth is mostly
    the sky fill on random weights, so its raw depth over the CPU's non-sky
    pixels (normalised as the metric post does) and its sky mask are held
    too."""
    from desktop2stereo_tpu_torch.models import da3
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.ops.depth_post import normalize_depth
    from desktop2stereo_tpu_torch.pipeline import programs as P

    for name, layers in (("DA3-SMALL", 12), ("DA3MONO-LARGE", 24)):
        card, spec = build_bound(name, device=dev, seed=0)
        cpu, _ = build_bound(name, device="cpu", seed=0)
        cfg = P.ProgramConfig(model_name=name, depth_resolution=182, output_height=216,
                              display_mode="Half-SBS", ipd=0.064, depth_strength=2.0,
                              convergence=0.0, foreground_scale=0.0, aa_strength=2.0,
                              ema_alpha=0.9, temporal_smooth=True, quality="high",
                              emit_depth="model")
        card_prog = P.ProgramCache(cfg, card, spec, compute_dtype=torch.bfloat16)
        cpu_prog = P.ProgramCache(cfg, cpu, spec, compute_dtype=torch.float32)
        k2, k1 = K2.KERNEL.launches, K1.KERNEL.launches
        for frame in _moving_frames(2, 216, 384, seed=2):
            sbs_c, depth_c = (t.cpu() for t in card_prog(frame))
            sbs_r, depth_r = cpu_prog(frame)
            assert sbs_c.shape == sbs_r.shape == (216, 384, 3) and torch.isfinite(depth_c).all()
            s_err = (sbs_c.int() - sbs_r.int()).abs().float()
            assert (depth_c - depth_r).abs().mean().item() <= 0.03, name
            assert s_err.mean().item() <= 3.0 and (s_err > 32).float().mean().item() <= 0.03
        assert K2.KERNEL.launches - k2 == 2 * layers and K1.KERNEL.launches - k1 == 2
        if name == "DA3MONO-LARGE":
            _, model_in = cpu_prog.program.preprocess(torch.from_numpy(frame))
            with torch.inference_mode():
                c = card.predict(model_in.to(dev, torch.bfloat16), ("depth", "sky"))
                r = cpu.predict(model_in, ("depth", "sky"))
            dc, sc = c["depth"].float().cpu()[0, 0], c["sky"].float().cpu()[0, 0]
            dr, non_sky = r["depth"][0, 0], r["sky"][0, 0] < da3.SKY_THRESHOLD
            assert non_sky.any() and torch.isfinite(dc).all()
            err = (normalize_depth(torch.where(non_sky, dc, 0.0), metric=True)
                   - normalize_depth(torch.where(non_sky, dr, 0.0), metric=True)).abs()[non_sky]
            assert err.mean().item() <= 0.03
            assert ((sc < da3.SKY_THRESHOLD) != non_sky).float().mean().item() <= 0.03


# ---- K2 with an additive bias (DPT-BEiT's relative-position bias) --------------------------

@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129, 130, 577])
def test_biased_attention_kernel_matches_plain(dev, N, bias_dtype):
    """The biased entry at BEiT-L/16's 577 tokens (a 288x512 input) and on
    either side of the 64-row query and 128-key tiles: rows and columns of
    the bias past N are never read, and the bias moves the output."""
    gen = torch.Generator(device=dev).manual_seed(1000 + N)
    q, k, v = _qkv_layout("qkv views", 2, N, 4, gen, dev)
    bias = (2.0 * torch.randn(4, N, N, generator=gen, device=dev)).to(bias_dtype)
    before = dict(K2.KERNEL.entry_launches)
    got = K2.attention(q, k, v, bias)
    assert (K2.KERNEL.entry_launches.get("d2s_attention_bias_fwd", 0)
            == before.get("d2s_attention_bias_fwd", 0) + 1)
    want = K2.attention_ref(q.float(), k.float(), v.float(), bias.float())
    torch.cuda.synchronize()
    assert got.shape == (2, N, 4, 64) and got.is_contiguous() and got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 2e-2
    if N > 1:
        plain = K2.attention_ref(q.float(), k.float(), v.float())
        assert (plain - want).abs().max().item() > 0.1


def test_biased_attention_kernel_on_separate_projections(dev):
    """BEiT's own layout: q, k and v are three contiguous products (query,
    key and value), not views of one qkv, at BEiT-L's [1, 577, 16, 64] with
    its bf16 bias."""
    gen = torch.Generator(device=dev).manual_seed(577)
    q, k, v = _qkv_layout("contiguous", 1, 577, 16, gen, dev)
    bias = (2.0 * torch.randn(16, 577, 577, generator=gen, device=dev)).bfloat16()
    got = K2.attention(q, k, v, bias)
    want = K2.attention_ref(q.float(), k.float(), v.float(), bias.float())
    torch.cuda.synchronize()
    assert got.shape == (1, 577, 16, 64) and got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 2e-2
    plain = K2.attention_ref(q.float(), k.float(), v.float())
    assert (plain - want).abs().max().item() > 0.1


def test_biased_attention_kernel_refuses_a_bad_bias(dev):
    q = torch.zeros(1, 8, 2, 64, device=dev, dtype=torch.bfloat16)
    for bias, match in ((torch.zeros(2, 8, 9, device=dev), r"\[H, N, N\]"),
                        (torch.zeros(2, 8, 8, device=dev, dtype=torch.float16), "bf16 or f32"),
                        (torch.zeros(2, 8, 8, device="cpu"), "CUDA device")):
        with pytest.raises(ValueError, match=match):
            K2.attention(q, q, q, bias)


# ---- K2's table entry (DPT-BEiT's relative-position bias gathered from its table) ----------

RELPOS_GRIDS = [(18, 32), (24, 32), (32, 32), (1, 1), (3, 6), (7, 9), (8, 16)]


@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["contiguous", "qkv views"])
@pytest.mark.parametrize("grid", RELPOS_GRIDS, ids=[f"{h}x{w}" for h, w in RELPOS_GRIDS])
def test_relpos_attention_kernel_matches_plain_and_the_dense_entry(dev, grid, layout,
                                                                   table_dtype):
    """The table entry at BEiT-L @512's 18x32 grid (577 tokens), the 4:3
    capture's 24x32, the 32x32 pretraining window and ragged N = 2, 19, 64,
    129 (either side of the 64-row query and 128-key tiles): within 2e-2 of
    the plain version, equal bit for bit to the dense entry on the expanded
    bias, one launch of the table entry and none of the dense one, and the
    bias moves the output."""
    gh, gw = grid
    N = gh * gw + 1
    gen = torch.Generator(device=dev).manual_seed(2000 + N)
    q, k, v = _qkv_layout(layout, 2 if N < 200 else 1, N, 16 if N > 500 else 4, gen, dev)
    H = q.shape[2]
    table = (2.0 * torch.randn(H, K2.relative_position_count(gh, gw), generator=gen,
                               device=dev)).to(table_dtype)
    before = dict(K2.KERNEL.entry_launches)
    got = K2.attention_relpos(q, k, v, table, gh, gw)
    after = K2.KERNEL.entry_launches
    assert (after.get("d2s_attention_relpos_fwd", 0)
            == before.get("d2s_attention_relpos_fwd", 0) + 1)
    assert after.get("d2s_attention_bias_fwd", 0) == before.get("d2s_attention_bias_fwd", 0)
    dense = K2.expand_rel_pos(table, gh, gw)
    want = K2.attention_ref(q.float(), k.float(), v.float(), dense.float())
    same = K2.attention(q, k, v, dense)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.is_contiguous() and got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max().item() <= 2e-2
    assert torch.equal(got, same)
    if N > 1:
        plain = K2.attention_ref(q.float(), k.float(), v.float())
        assert (plain - want).abs().max().item() > 0.1


def test_relpos_attention_kernel_refuses_a_bad_table(dev):
    q = torch.zeros(1, 19, 2, 64, device=dev, dtype=torch.bfloat16)
    R = K2.relative_position_count(3, 6)
    for table, grid, match in ((torch.zeros(2, R - 1, device=dev), (3, 6), r"\[H, R\]"),
                               (torch.zeros(2, R, device=dev), (3, 5), "N = gh"),
                               (torch.zeros(2, R, device=dev, dtype=torch.float16), (3, 6),
                                "bf16 or f32"),
                               (torch.zeros(2, R), (3, 6), "CUDA device")):
        with pytest.raises(ValueError, match=match):
            K2.attention_relpos(q, q, q, table, *grid)


def test_relpos_attention_kernel_spills_nothing_and_keeps_two_blocks(dev):
    """At BEiT-L @512's 18x32 grid, bf16 and f32 tables: no local memory
    (spills) and at least two resident blocks an SM."""
    for f32 in (False, True):
        info = K2.kernel_info("attention_relpos", f32, 577, K2.relative_position_count(18, 32))
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, info
        assert info["smem_bytes"] == K2.relpos_smem_bytes(577, 2208)


def test_dpt_beit_streams_on_the_card_like_the_cpu(dev):
    """dpt-beit-base-384 from one seed through ProgramCache, three frames
    (first, then step twice with the carried tables): the card in bf16 (12
    K2 launches of the table entry, none of the dense one, and one K1 a
    frame) against the CPU in f32, each frame held to chip_smoke.py's
    reference thresholds; the carry is the 12 layers' bf16 [12, R] tables,
    built once."""
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.pipeline import programs as P

    name = "dpt-beit-base-384"
    card, spec = build_bound(name, device=dev, seed=0)
    cpu, _ = build_bound(name, device="cpu", seed=0)
    cfg = P.ProgramConfig(model_name=name, depth_resolution=256, output_height=216,
                          display_mode="Half-SBS", ipd=0.064, depth_strength=2.0,
                          convergence=0.0, foreground_scale=0.0, aa_strength=2.0,
                          ema_alpha=0.9, temporal_smooth=True, quality="high",
                          emit_depth="model")
    card_prog = P.ProgramCache(cfg, card, spec, compute_dtype=torch.bfloat16)
    cpu_prog = P.ProgramCache(cfg, cpu, spec, compute_dtype=torch.float32)
    relpos = K2.KERNEL.entry_launches.get("d2s_attention_relpos_fwd", 0)
    dense = K2.KERNEL.entry_launches.get("d2s_attention_bias_fwd", 0)
    k2, k1 = K2.KERNEL.launches, K1.KERNEL.launches
    for frame in _moving_frames(3, 216, 384, seed=2):
        sbs_c, depth_c = (t.cpu() for t in card_prog(frame))
        sbs_r, depth_r = cpu_prog(frame)
        assert sbs_c.shape == sbs_r.shape == (216, 384, 3) and torch.isfinite(depth_c).all()
        s_err = (sbs_c.int() - sbs_r.int()).abs().float()
        assert (depth_c - depth_r).abs().mean().item() <= 0.03
        assert s_err.mean().item() <= 3.0 and (s_err > 32).float().mean().item() <= 0.03
    assert K2.KERNEL.launches - k2 == 3 * 12 and K1.KERNEL.launches - k1 == 3
    assert K2.KERNEL.entry_launches["d2s_attention_relpos_fwd"] - relpos == 3 * 12
    assert K2.KERNEL.entry_launches.get("d2s_attention_bias_fwd", 0) == dense
    (key,) = card_prog._states
    carry = card_prog._states[key].model
    gh, gw = (d // 16 for d in P.ema_shape(cfg, spec, 216, 384))  # 9x16
    assert len(carry) == 12 and all(
        c.dtype == torch.bfloat16 and c.is_contiguous()
        and c.shape == (12, K2.relative_position_count(gh, gw)) for c in carry)


@pytest.mark.parametrize("name", ["zoedepth-nyu-kitti", "InfiniDepth-Small"])
def test_f32_parts_stay_on_the_card_through_a_dtype_cast(dev, name):
    """A model moved to the card, then cast by dtype alone: ZoeDepth's metric
    head and InfiniDepth's conv stem stay float32 on the card, the trunk is
    bf16, and a frame runs."""
    from desktop2stereo_tpu_torch.models.factory import build_bound

    model, _ = build_bound(name, device="cpu", seed=0)
    model = model.to("cuda").to(torch.bfloat16)
    f32 = model.metric_head if name.startswith("zoedepth") else model.basic_encoder
    assert {p.device for p in model.parameters()} == {dev}
    assert {p.dtype for p in f32.parameters()} == {torch.float32}
    assert torch.bfloat16 in {p.dtype for p in model.parameters()}
    x = torch.rand(1, 64, 112, 3, generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        depth = model(x)
    assert depth.device == dev and bool(torch.isfinite(depth.float()).all())


@pytest.mark.parametrize("roll", [0.0, 0.3])
def test_dibr_geometry_on_the_card_is_the_cpus_bit_for_bit(dev, roll):
    """The warp position and confidence `dibr_render` hands K5: a divisor
    left on the host made CUDA multiply by its reciprocal, px crossed W - 1
    at the right edge on the card only, and the confidence there flipped
    (up to 41 LSB in a 4K client frame)."""
    from desktop2stereo_tpu_torch.ops import stereo as S

    rng = np.random.default_rng(3)
    depth = torch.from_numpy(rng.random((64, 3840), dtype=np.float32))
    for eye in (-0.032, 0.032):
        card = S.dibr_geometry(depth.to(dev), eye, 2.0, 0.01, roll=roll)
        cpu = S.dibr_geometry(depth, eye, 2.0, 0.01, roll=roll)
        for got, want in zip(card, cpu):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("mode,w", [("Full-SBS", 384), ("Half-SBS", 384), ("Half-SBS", 383)])
def test_xr_client_render_on_the_card_like_the_cpu(dev, mode, w):
    """The XR client's frame: K5 once an eye at roll 0 (none with a roll),
    uint8 within 1 LSB of the same call on the CPU on at most 0.1% of values."""
    from desktop2stereo_tpu_torch.tools import xr_client as XC

    rng = np.random.default_rng(w)
    rgb = (rng.random((216, w, 3)) * 255).astype(np.uint8)
    depth = rng.random((63, 112)).astype(np.float32)
    for roll, k5 in ((0.0, 2), (0.2, 0)):
        before = K5.KERNEL.launches
        got = XC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, mode=mode, roll=roll, device=dev)
        torch.cuda.synchronize()
        assert K5.KERNEL.launches == before + k5
        assert got.device == dev and got.dtype == torch.uint8
        want = XC.render_stereo(rgb, depth, 0.064, 2.0, 0.01, mode=mode, roll=roll,
                                device="cpu")
        diff = (got.cpu().int() - want.int()).abs()
        assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3


# ---- the multi-GPU path's kernels at one rank's shapes (ViT-L @518, tp = 2) ------------

@pytest.mark.parametrize("name,role,K,F", [("qkv", "col", 1024, 1536), ("fc1", "col", 1024, 2048),
                                           ("proj", "row", 512, 1024), ("fc2", "row", 2048, 1024)])
def test_quant_dense_kernel_exact_on_tensor_parallel_shards(dev, name, role, K, F):
    """A column-parallel shard (bf16 out, bias) and a row-parallel one (the
    int32 entry with a row scale over the whole K) exactly as the plain
    version computes them."""
    from desktop2stereo_tpu_torch.ops.quant import quantize_weight

    gen = torch.Generator(device=dev).manual_seed(K + F)
    x = torch.randn(778, K, generator=gen, device=dev).bfloat16()
    wq, scale = quantize_weight(torch.randn(F, K, generator=gen, device=dev))
    bias = torch.randn(F, generator=gen, device=dev)
    if role == "col":
        args, kw = (x, wq, scale, bias), {}
    else:
        args = (x, wq, scale)
        kw = dict(row_scale=x.float().abs().amax(dim=-1, keepdim=True) / 127.0,
                  out_dtype=torch.int32)
    before = K4.KERNEL.launches
    got = K4.quant_dense(*args, **kw)
    assert K4.KERNEL.launches == before + 1
    want = K4.quant_dense_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_attention_kernel_on_one_ranks_heads(dev):
    """K2 at [1, 778, 8, 64]: the eight heads of one rank of ViT-L at tp = 2,
    as views of its [1, 778, 1536] qkv shard."""
    gen = torch.Generator(device=dev).manual_seed(52)
    qkv = torch.randn(1, 778, 3 * 512, generator=gen, device=dev).bfloat16()
    q, k, v = (t.unflatten(-1, (8, 64)) for t in qkv.split(512, dim=-1))
    got = K2.attention(q, k, v)
    want = K2.attention_ref(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert got.shape == (1, 778, 8, 64)
    assert (got.float() - want).abs().max().item() <= 2e-2


def test_tensor_parallel_run_on_the_card(dev):
    """Two ranks (NCCL with a card each, or gloo on card 0): DA-V2-Small at
    TP = 2 against the whole model on the card; 12 K2 a rank (and 48 K4 in
    int8, bit-equal to the whole int8 model)."""
    import torch_parallel_ranks as ranks
    from desktop2stereo_tpu_torch.parallel.launch import spawn

    out = spawn(ranks.card_tp, 1, 2, "cuda", deadline_s=300.0)
    for r in out:
        assert r["none"]["launches"] == {"d2s_attention_fwd": 12}, r
        assert r["none"]["finite"] and r["none"]["mean_rel"] < 0.03, r
        assert r["int8"]["launches"] == {"d2s_attention_fwd": 12, "d2s_quant_dense": 48}, r
        assert r["int8"]["equal"], r


# ---- K2's f32 body (`--fp32`, the converter's gate) ------------------------------------------

# f32 kernel against the f32 plain version: summation order and exp2f only
F32_ATTN_MAX_ABS = 1e-4
_F32_ENTRIES = ("d2s_attention_f32_fwd", "d2s_attention_bias_f32_fwd",
                "d2s_attention_relpos_f32_fwd")


def _entry_moves(before, entry):
    """Assert that exactly one launch of `entry`, and none of any other K2
    entry, was counted since `before`."""
    after = K2.KERNEL.entry_launches
    for name in set(after) | set(before):
        assert after.get(name, 0) - before.get(name, 0) == (name == entry), name


def _f32_layout(layout, B, N, H, gen, dev):
    return [t.float() for t in _qkv_layout(layout, B, N, H, gen, dev)]


@pytest.mark.parametrize("layout", ["contiguous", "qkv views", "heads-major"])
@pytest.mark.parametrize("B,N,H", [(1, 778, 16), (2, 1, 3), (2, 31, 3), (2, 33, 3), (2, 63, 3),
                                   (2, 64, 3), (2, 65, 3), (2, 129, 3), (2, 1370, 12)])
def test_f32_attention_kernel_matches_plain(dev, B, N, H, layout):
    """f32 q/k/v take the f32 body (one launch of its entry, none of the
    bf16 ones) at the flagship's [1, 778, 16, 64], on either side of its
    32-row query and 64-key tiles, and at 1370 tokens: within 1e-4 of the
    f32 plain version, f32 out."""
    gen = torch.Generator(device=dev).manual_seed(3000 + N)
    q, k, v = (_f32_layout(layout, B, N, H, gen, dev) if layout != "qkv views" else
               [t.unflatten(-1, (H, 64)) for t in torch.randn(
                   B, N, 3 * H * 64, generator=gen, device=dev).split(H * 64, dim=-1)])
    before = dict(K2.KERNEL.entry_launches)
    got = K2.attention(q, k, v)
    _entry_moves(before, "d2s_attention_f32_fwd")
    want = K2.attention_ref(q, k, v)
    torch.cuda.synchronize()
    assert got.shape == (B, N, H, 64) and got.is_contiguous() and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= F32_ATTN_MAX_ABS


def test_f32_attention_kernel_reads_a_zero_stride(dev):
    """No tensor map in the f32 body: a broadcast k/v (zero token stride)
    is read as it is."""
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(1, 50, 2, 64, generator=gen, device=dev)
    kv = torch.randn(1, 1, 2, 64, generator=gen, device=dev).expand(1, 50, 2, 64)
    got = K2.attention(q, kv, kv)
    torch.cuda.synchronize()
    assert (got - K2.attention_ref(q, kv.contiguous(), kv.contiguous())).abs().max() <= 1e-5


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("N", [1, 31, 33, 64, 65, 130, 577])
def test_f32_biased_attention_kernel_matches_plain(dev, N, bias_dtype):
    gen = torch.Generator(device=dev).manual_seed(4000 + N)
    q, k, v = _f32_layout("qkv views", 2, N, 4, gen, dev)
    bias = (2.0 * torch.randn(4, N, N, generator=gen, device=dev)).to(bias_dtype)
    before = dict(K2.KERNEL.entry_launches)
    got = K2.attention(q, k, v, bias)
    _entry_moves(before, "d2s_attention_bias_f32_fwd")
    want = K2.attention_ref(q, k, v, bias.float())
    torch.cuda.synchronize()
    assert got.shape == (2, N, 4, 64) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= F32_ATTN_MAX_ABS
    if N > 1:
        assert (K2.attention_ref(q, k, v) - want).abs().max().item() > 0.1


@pytest.mark.parametrize("table_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("grid", RELPOS_GRIDS, ids=[f"{h}x{w}" for h, w in RELPOS_GRIDS])
def test_f32_relpos_attention_kernel_matches_plain_and_the_dense_entry(dev, grid, table_dtype):
    """The f32 table entry: within 1e-4 of the plain version and equal bit
    for bit to the f32 dense entry on the expanded bias (the same f32
    operands and operations)."""
    gh, gw = grid
    N = gh * gw + 1
    gen = torch.Generator(device=dev).manual_seed(5000 + N)
    q, k, v = _f32_layout("contiguous", 2 if N < 200 else 1, N, 16 if N > 500 else 4, gen, dev)
    table = (2.0 * torch.randn(q.shape[2], K2.relative_position_count(gh, gw), generator=gen,
                               device=dev)).to(table_dtype)
    before = dict(K2.KERNEL.entry_launches)
    got = K2.attention_relpos(q, k, v, table, gh, gw)
    _entry_moves(before, "d2s_attention_relpos_f32_fwd")
    dense = K2.expand_rel_pos(table, gh, gw)
    want = K2.attention_ref(q, k, v, dense.float())
    same = K2.attention(q, k, v, dense)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= F32_ATTN_MAX_ABS
    assert torch.equal(got, same)


def test_f32_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 8, 2, 64, device=dev)
    for args, match in (((q, q.bfloat16(), q), "one dtype"),
                        ((q.half(),) * 3, "bf16 or f32"),
                        ((torch.zeros(1, 8, 2, 66, device=dev)[..., :64],) * 3, "aligned")):
        with pytest.raises(ValueError, match=match):
            K2.attention(*args)


def test_f32_attention_kernel_spills_nothing(dev):
    for entry, f32 in (("attention_f32", False), ("attention_bias_f32", False),
                       ("attention_bias_f32", True), ("attention_relpos_f32", False),
                       ("attention_relpos_f32", True)):
        info = K2.kernel_info(entry, f32, 577, K2.relative_position_count(18, 32))
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, (entry, f32, info)


@pytest.mark.parametrize("name,layers,table", [("Depth-Anything-V2-Small", 12, False),
                                               ("dpt-beit-base-384", 12, True)])
def test_f32_models_on_the_card_like_the_cpu(dev, name, layers, table):
    """`--fp32` on the card: a ViT-S DA-V2 and a BEiT-B from one seed through
    ProgramCache in f32, two frames, against the CPU f32 run: every K2
    launch is the f32 body's (the table entry's for BEiT), and depth and
    frame are far inside chip_smoke.py's bf16 thresholds."""
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.pipeline import programs as P

    cuda_policy(0)  # the CLI's device policy: TF32 off for products and convolutions
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    card, spec = build_bound(name, device=dev, dtype=torch.float32, seed=0)
    cpu, _ = build_bound(name, device="cpu", seed=0)
    cfg = P.ProgramConfig(model_name=name, depth_resolution=256 if table else 266,
                          output_height=216, display_mode="Half-SBS", ipd=0.064,
                          depth_strength=2.0, convergence=0.0, foreground_scale=0.0,
                          aa_strength=2.0, ema_alpha=0.9, temporal_smooth=True, quality="high",
                          emit_depth="model")
    card_prog = P.ProgramCache(cfg, card, spec, compute_dtype=torch.float32)
    cpu_prog = P.ProgramCache(cfg, cpu, spec, compute_dtype=torch.float32)
    before = dict(K2.KERNEL.entry_launches)
    for frame in _moving_frames(2, 216, 384, seed=3):
        sbs_c, depth_c = (t.cpu() for t in card_prog(frame))
        sbs_r, depth_r = cpu_prog(frame)
        assert sbs_c.shape == sbs_r.shape == (216, 384, 3) and torch.isfinite(depth_c).all()
        s_err = (sbs_c.int() - sbs_r.int()).abs().float()
        assert (depth_c - depth_r).abs().mean().item() <= 1e-3, name
        assert s_err.mean().item() <= 0.5 and (s_err > 32).float().mean().item() <= 1e-3
    entry = "d2s_attention_relpos_f32_fwd" if table else "d2s_attention_f32_fwd"
    moved = {n: c - before.get(n, 0) for n, c in K2.KERNEL.entry_launches.items()}
    assert {n: c for n, c in moved.items() if c} == {entry: 2 * layers}
