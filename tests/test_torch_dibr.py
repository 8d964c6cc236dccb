"""The port's both-eyes DIBR plain version against the JAX pair kernel.

The JAX side is `dibr_render_pair_planar` in Pallas interpret mode, on its
edge-padded planar input, as the JAX package's own kernel tests run it; the
port takes the true eye-size frame (clamp-to-edge reads equal the padded
reads).  50×200 is a shape the JAX code pads in both axes.
"""

import functools
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from desktop2stereo_tpu.ops.pallas.dibr import dibr_render_pair_planar, pair_tiling
from desktop2stereo_tpu_torch.ops.kernels import dibr as K
from torch_threads import one_torch_thread  # noqa: F401

# (H, W, depth_strength, convergence, feather)
CASES = [
    (96, 256, 2.0, 0.01, 0.0),
    (96, 256, 1.0, -0.1, 0.08),
    (50, 200, 2.0, 0.01, 0.0),
    (50, 200, 3.5, 0.05, 0.02),
]


def _inputs(H, W, seed):
    rng = np.random.default_rng(seed)
    rgb = (rng.random((3, H, W)) * 255.0).astype(np.float32)
    dep = rng.random((H, W)).astype(np.float32)
    return rgb, dep


@functools.lru_cache(maxsize=None)  # both arrangements share one JAX run
def _jax_case(H, W, seed, out_mode, strength, conv, feather):
    rgb, dep = _inputs(H, W, seed)
    return _jax_pair(rgb, dep, out_mode, strength, conv, feather)


def _jax_pair(rgb, dep, out_mode, strength, conv, feather):
    _, H, W = rgb.shape
    hp, wp, _ = pair_tiling(H, W)
    rgbp = jnp.pad(jnp.asarray(rgb), ((0, 0), (0, hp - H), (0, wp - W)), mode="edge")
    depp = jnp.pad(jnp.asarray(dep), ((0, hp - H), (0, wp - W)), mode="edge")[None]
    left, right = dibr_render_pair_planar(
        rgbp, depp, W, ipd=0.064, depth_strength=strength, convergence=conv,
        feather=feather, height=H, out_mode=out_mode, interpret=True)
    return np.asarray(left)[:, :H, :W], np.asarray(right)[:, :H, :W]


@pytest.mark.parametrize("H,W,strength,conv,feather", CASES)
def test_eyes_f32_match_jax_kernel(H, W, strength, conv, feather):
    rgb, dep = _inputs(H, W, seed=H + W)
    want_l, want_r = _jax_pair(rgb, dep, "eyes", strength, conv, feather)
    got_l, got_r = K.dibr_pair_eyes_ref(
        torch.from_numpy(rgb), torch.from_numpy(dep), ipd=0.064,
        depth_strength=strength, convergence=conv, feather=feather)
    # f32 on 0..255 values; the warp turns a one-ulp change of its position
    # into up to ~4e-3, which the matched rounding order keeps out
    np.testing.assert_allclose(got_l.numpy(), want_l, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_r.numpy(), want_r, atol=1e-3, rtol=0)


@pytest.mark.parametrize("arrangement", ["sbs", "tab"])
@pytest.mark.parametrize("H,W,strength,conv,feather", CASES[::2] + CASES[3:])
def test_half_u8_matches_jax_eyes_u8(H, W, strength, conv, feather, arrangement):
    """The finished frame ≡ JAX eyes_u8 + the program's concat/transpose."""
    rgb, dep = _inputs(H, W, seed=H * W)
    lq, rq = _jax_case(H, W, H * W, "eyes_u8", strength, conv, feather)
    want = np.concatenate([lq, rq], axis=2 if arrangement == "sbs" else 1).transpose(1, 2, 0)
    got = K.dibr_pair_half(torch.from_numpy(rgb), torch.from_numpy(dep), ipd=0.064,
                           depth_strength=strength, convergence=conv,
                           feather=feather, arrangement=arrangement).numpy()
    assert got.shape == ((H, 2 * W, 3) if arrangement == "sbs" else (2 * H, W, 3))
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_inpaint_taps_read_raw_depth():
    """Only the centre depth is smoothed; the sweep and vertical taps read
    raw depth.  A one-pixel near spike inside a far run, on a ramp image,
    makes the raw/smoothed distinction visible in the fill; the plain
    version must still match the JAX kernel there."""
    H, W = 8, 64
    rgb = torch.arange(W, dtype=torch.float32).expand(3, H, W).contiguous() * 3.0
    dep = torch.full((H, W), 0.2)
    dep[:, 30:] = 0.9
    dep[:, 28] = 0.95  # a near spike inside the far region
    left, _ = K.dibr_pair_eyes_ref(rgb, dep, ipd=0.064, depth_strength=2.0,
                                   convergence=0.0)
    jl, _ = _jax_pair(rgb.numpy(), dep.numpy(), "eyes", 2.0, 0.0, 0.0)
    np.testing.assert_allclose(left.numpy(), jl, atol=1e-3, rtol=0)


@pytest.mark.parametrize("rgb,dep,arr,match", [
    ((3, 8, 16), (8, 16), "side", "arrangement"),
    ((4, 8, 16), (8, 16), "sbs", r"\[3,eh,ew\]"),
    ((3, 8, 16), (8, 15), "sbs", r"\[3,eh,ew\]"),
    ((2, 3, 8, 16), (8, 16), "sbs", r"\[S,eh,ew\]"),
    ((2, 3, 8, 16), (3, 8, 16), "sbs", r"\[S,eh,ew\]"),
    ((2, 4, 8, 16), (2, 8, 16), "sbs", r"\[S,3,eh,ew\]"),
    ((1, 2, 3, 8, 16), (1, 2, 8, 16), "sbs", r"\[3,eh,ew\]"),
    ((0, 3, 8, 16), (0, 8, 16), "sbs", "stream count"),
])
def test_kernel_input_checks_raise(rgb, dep, arr, match):
    with pytest.raises(ValueError, match=match):
        K.check_inputs(torch.zeros(rgb), torch.zeros(dep), arr)


def test_kernel_input_checks_dtype_and_layout():
    with pytest.raises(ValueError, match="f32"):
        K.check_inputs(torch.zeros(3, 8, 16, dtype=torch.float64), torch.zeros(8, 16), "sbs")
    with pytest.raises(ValueError, match="contiguous"):
        K.check_inputs(torch.zeros(3, 16, 8).transpose(1, 2), torch.zeros(8, 16), "sbs")


# --- the kernels' launch geometry and their column walk, on the CPU ---------

PIX = K.PIX


def _cover(width, g):
    """How often the kernel's loops (a block a segment of a row, thread t
    taking the PIX-pixel groups t, t + threads, ...; stores masked at W)
    write each pixel of a row, and the last tile column a group reads."""
    s0 = g.seg * np.arange(g.grid_x)[:, None]
    rounds = math.ceil(g.seg / PIX / g.threads)
    i = (np.arange(g.threads)[None, :] + g.threads * np.arange(rounds)[:, None]).ravel()[None]
    active = s0 + PIX * i < np.minimum(s0 + g.seg, width)
    x = (s0 + PIX * i)[..., None] + np.arange(PIX)
    counts = np.bincount(x[active[..., None] & (x < width)], minlength=width)
    return counts, np.broadcast_to(PIX * i + PIX - 1 + 2 * g.halo, active.shape)[active].max()


@pytest.mark.parametrize("radius,seg_target,whole_row_smem", [
    (12, 512, 0), (12, 0, 0), (0, 512, 0), (1, 8, 0), (32, 512, 0), (32, 0, 0),
    (12, 512, K.WHOLE_ROW_SMEM)])
def test_tile_geometry_covers_every_pixel_once(radius, seg_target, whole_row_smem):
    """Widths 1..7680: every pixel is written exactly once, the halo holds
    the sweep radius and the ±2 centre taps, a block's shared memory stays
    within 227 KB and its threads within the kernels' launch bounds; every
    column a thread reads lies inside its block's staged tile."""
    for width in range(1, 7681):
        g = K.tile_geometry(width, radius, seg_target, whole_row_smem)
        assert g.pix == PIX and g.seg % PIX == 0 and g.halo % 4 == 0
        assert g.halo >= max(radius, 4)
        assert g.smem == K.tile_smem_bytes(g.seg, g.halo) <= K.MAX_SMEM
        assert 1 <= g.threads <= K.MAX_THREADS and g.threads * PIX <= g.seg
        assert (g.grid_x - 1) * g.seg < width <= g.grid_x * g.seg
        counts, last = _cover(width, g)
        assert (counts == 1).all(), width
        assert last < g.seg + 2 * g.halo, width


def test_tile_geometry_balances_blocks_and_stages_whole_rows():
    assert K.tile_geometry(1920, 12, 512) == K.TileGeometry(480, 12, 4, 120, 12096, 4)
    assert K.tile_geometry(3840, 12, 512).grid_x == 8
    assert K.tile_geometry(7680, 12, 512).seg == 512
    whole = K.tile_geometry(3840, 12, 0)
    assert (whole.seg, whole.grid_x, whole.threads) == (3840, 1, 256)
    # a row whose tile does not fit in shared memory is split
    assert K.tile_geometry(16000, 12, 0).grid_x == 2
    # K1's geometry: whole rows up to WHOLE_ROW_SMEM (a 4K eye), segments beyond
    k1 = lambda w: K.tile_geometry(w, K.SEARCH_RADIUS, K.SEG_TARGET, K.WHOLE_ROW_SMEM)  # noqa: E731
    assert (k1(1920).grid_x, k1(1920).smem) == (1, 46656)
    assert (k1(3840).grid_x, k1(3840).seg) == (8, 480)


def test_tile_slots_are_conflict_free():
    """Column c of thread-group q sits at float4 slot 5q + c + floor(c/4):
    eight consecutive groups (a quarter-warp's 16-byte loads) always land on
    eight distinct bank quads."""
    for c in range(-32, 36):
        for q0 in range(8, 40):
            assert len({(5 * q + c + c // 4) % 8 for q in range(q0, q0 + 8)}) == 8


def warp_of(i, threads):
    """The warp of thread-group i of a block: thread i % threads takes it in
    round i // threads."""
    return (i // threads) * math.ceil(threads / 32) + (i % threads) // 32


def _warp_all(ok, warp):
    """`ok` [H, G] reduced over the groups of each warp of a row."""
    idx = warp.expand_as(ok)
    red = torch.ones(ok.shape[0], int(warp.max()) + 1, dtype=torch.int64)
    return red.scatter_reduce(1, idx, ok.long(), "amin").gather(1, idx).bool()


def walk_sweep(inv, rgb, l0, radius, direction, gate, weight, warp, done):
    """One sweep of the kernels' column walk (csrc/dibr_tile.cuh:sweep), for
    every thread-group at once: `inv` [H, n] is the staged 1 - d, `rgb` the
    staged colours [3, H, n] (or [H, n, 3]), `l0` [G] each group's first
    pixel in the tile, `warp` [G] its warp.  The columns are visited once, in
    the sweep's direction, and pixel j takes column c at t = |c - j|
    (1 <= t <= radius), so each pixel's taps arrive in the order t = 1, 2,
    ...; `gate(j)` is its threshold, `weight(j, t, inv_col)` its tap weight.
    A warp stops when `done(wsum)` holds for all its groups: before the first
    column and after each column from the PIX-th on.  Returns the PIX
    per-pixel colour sums and weight sums."""
    chan_first = rgb.shape[0] == 3 and rgb.shape[1:] == inv.shape
    shape = (3, inv.shape[0], len(l0)) if chan_first else (inv.shape[0], len(l0), 3)
    acc, wsum = [torch.zeros(shape)] * PIX, [torch.zeros(inv.shape[0], len(l0))] * PIX
    stopped = _warp_all(done(wsum), warp)
    for k in range(1, radius + PIX):
        c = PIX - 1 - k if direction < 0 else k
        v = inv[:, l0 + c]
        col = rgb[:, :, l0 + c] if chan_first else rgb[:, l0 + c, :]
        for j in range(PIX):
            t = j - c if direction < 0 else c - j
            if not 1 <= t <= radius:
                continue
            take = (v > gate(j)) & (wsum[j] <= 5.0) & ~stopped
            w = weight(j, t, v)
            add = col * (w if chan_first else w[..., None])
            mask = take if chan_first else take[..., None]
            acc[j] = torch.where(mask, acc[j] + add, acc[j])
            wsum[j] = torch.where(take, wsum[j] + w, wsum[j])
        if k >= PIX:
            stopped = stopped | _warp_all(done(wsum), warp)
    return acc, wsum


def saturated(wsum):
    """No pixel of the group can take another tap (the forward sweep)."""
    return functools.reduce(torch.logical_and, [~(w <= 5.0) for w in wsum])


def unneeded(fwd_w):
    """No pixel of the group needs another tap of the opposite sweep: it is
    saturated, or the first sweep found a weight of 2 or more."""
    return lambda wsum: functools.reduce(
        torch.logical_and, [~(f < 2.0) | ~(w <= 5.0) for f, w in zip(fwd_w, wsum)])


def _emulate_pair_eyes(rgb, dep, *, ipd, depth_strength, convergence, seg_target):
    """Both eyes as the K1 kernel computes them: per block, the staged tile;
    per thread-group, PIX pixels whose sweeps walk the tile."""
    _, H, W = rgb.shape
    R = K.SEARCH_RADIUS
    g = K.tile_geometry(W, R, seg_target)
    eyes = [torch.full_like(rgb, float("nan")) for _ in range(2)]
    rows = torch.arange(H)
    for bx in range(g.grid_x):
        s0 = bx * g.seg
        cols = torch.arange(s0 - g.halo, s0 + g.seg + g.halo).clamp(0, W - 1)
        d_t, rgb_t = dep[:, cols], rgb[:, :, cols]
        inv_t = 1.0 - d_t
        i = torch.arange(math.ceil((min(s0 + g.seg, W) - s0) / PIX))
        l0 = PIX * i + g.halo
        d = lambda off: d_t[:, l0 + off]  # noqa: E731
        px = {}
        for j in range(PIX):
            h_lo = d(j - 2) * 0.5 + d(j - 1) * 0.5
            h_hi = d(j + 1) * 0.5 + d(j + 2) * 0.5
            smooth = K._fma(h_hi, 0.15, K._fma(d(j), 0.7, h_lo * 0.15))
            cdi = -smooth
            jump = (d(j - 2) - d(j + 2)).abs()
            col = (s0 + PIX * i + j).float().expand(H, -1)
            lo, hi = K._edge_coords(col, W, np.float32(1.0) / np.float32(K.EDGE_MARGIN))
            shaped = K._fma(-smooth, K._fma(0.35, 1.0 - smooth, 1.0), convergence)
            px[j] = dict(cdi=cdi, col=col, conf=K._smoothstep(((jump - 0.04) / (0.10 - 0.04))
                                                             .clamp(0.0, 1.0)),
                         shift=shaped * (depth_strength * (K._smoothstep(lo.clamp(0.0, 1.0))
                                                           * K._smoothstep(hi.clamp(0.0, 1.0)))),
                         thr=cdi + K.DEPTH_TOLERANCE, pre_w=1.0 - 10.0 * cdi)
        warp = warp_of(i, g.threads)
        fwd_c, fwd_w = walk_sweep(
            inv_t, rgb_t, l0, R, -1, lambda j: px[j]["thr"],
            lambda j, t, v: math.exp(-t * 0.15) * px[j]["pre_w"] + (10.0 * math.exp(-t * 0.15)) * v,
            warp, saturated)
        bwd_c, bwd_w = walk_sweep(inv_t, rgb_t, l0, R, +1, lambda j: px[j]["thr"],
                                  lambda j, t, v: torch.full_like(v, math.exp(-t * 0.2)),
                                  warp, unneeded(fwd_w))
        for j in range(PIX):
            p = px[j]
            x = s0 + PIX * i + j
            xc = x.clamp(max=W - 1)
            vadd, vert_w = 0.0, torch.full_like(p["cdi"], 0.5)
            for off in (-K.VSHIFT, K.VSHIFT):
                yy = (rows + off).clamp(0, H - 1)
                w = torch.where((1.0 - dep[yy][:, xc]) > p["cdi"] + K.DEPTH_TOLERANCE * 0.5,
                                0.25, 0.0)
                vadd = vadd + rgb[:, yy][:, :, xc] * w
                vert_w = vert_w + w
            need_bwd = fwd_w[j] < 2.0
            best_w = fwd_w[j] + torch.where(need_bwd, bwd_w[j], 0.0)
            best_c = fwd_c[j] + torch.where(need_bwd, bwd_c[j], 0.0)
            filled = torch.where(best_w > 0.01,
                                 (best_c * (0.5 / best_w.clamp_min(1e-12)) + vadd)
                                 * (1.0 / vert_w), rgb_t[:, :, l0 + j])
            keep = x < W
            for e, eye in enumerate((-abs(ipd / 2.0), abs(ipd / 2.0))):
                pos = K._fma(p["shift"], -float(np.float32(eye) * np.float32(W)), p["col"])
                oob = (pos < 0.0) | (pos > W - 1.0)
                pc = pos.clamp(0.0, W - 1.0)
                i0f = torch.floor(pc)
                frac = pc - i0f
                i0 = i0f.long()
                i1 = (i0 + 1).clamp(max=W - 1)
                color = (rgb[:, rows[:, None], i0] * (1.0 - frac)
                         + rgb[:, rows[:, None], i1] * frac)
                out = color + torch.where(oob, 1.0, p["conf"]) * (filled - color)
                eyes[e][:, :, x[keep]] = out[:, :, keep]
    return eyes


def _edgy_frame(H, W, seed):
    """Colours, and a depth of short runs of random levels plus noise: many
    depth edges, so the sweeps' gates and the ±2-row taps switch often."""
    rng = np.random.default_rng(seed)
    rgb = (rng.random((3, H, W)) * 255.0).astype(np.float32)
    runs = np.repeat(rng.random((H, W // 3 + 1)), 3, axis=1)[:, :W]
    dep = np.clip(runs + rng.normal(0, 0.01, (H, W)), 0, 1).astype(np.float32)
    return torch.from_numpy(rgb), torch.from_numpy(dep)


@pytest.mark.parametrize("H,W,seg_target", [(5, 61, 512), (6, 64, 8), (3, 130, 0),
                                            (4, 7, 512), (3, 1100, 512)])
def test_column_walk_matches_plain_version_bit_for_bit(H, W, seg_target):
    rgb, dep = _edgy_frame(H, W, seed=H * W)
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    got = _emulate_pair_eyes(rgb, dep, seg_target=seg_target, **kw)
    want = K.dibr_pair_eyes_ref(rgb, dep, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- the stream axis: S frames in one call ------------------------------------

@pytest.mark.parametrize("H,W", [(50, 200), (9, 22)])
@pytest.mark.parametrize("arrangement", ["sbs", "tab"])
def test_stream_axis_rows_equal_single_frames(H, W, arrangement):
    """[S, 3, eh, ew] through either entry equals each row on its own, bit
    for bit (the plain versions take the batch row by row; chip_smoke holds
    the kernel's stream axis to the same on the card)."""
    frames = [_edgy_frame(H, W, seed=s) for s in (1, 2, 3)]
    rgb = torch.stack([f[0] for f in frames])
    dep = torch.stack([f[1] for f in frames])
    kw = dict(ipd=0.064, depth_strength=2.0, convergence=0.01)
    half = K.dibr_pair_half(rgb, dep, feather=0.02, arrangement=arrangement, **kw)
    left, right = K.dibr_pair_eyes(rgb, dep, **kw)
    want_shape = (2 * H, W, 3) if arrangement == "tab" else (H, 2 * W, 3)
    assert half.shape == (3, *want_shape) and half.dtype == torch.uint8
    assert left.shape == right.shape == (3, 3, H, W)
    for s, (r, d) in enumerate(frames):
        assert torch.equal(half[s], K.dibr_pair_half(r, d, feather=0.02,
                                                     arrangement=arrangement, **kw))
        one_l, one_r = K.dibr_pair_eyes(r, d, **kw)
        assert torch.equal(left[s], one_l) and torch.equal(right[s], one_r)
