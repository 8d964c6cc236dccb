#!/usr/bin/env python3
"""Time two versions of the port's kernel sources side by side on one
NVIDIA GPU.

    python3 kernel_ab.py OTHER_CSRC [--variant NAME=FLAGS ...]   # from the repo root

OTHER_CSRC is a directory holding another version of any of the five
kernel sources (`dibr_pair.cu` K1, `attention.cu` K2, `warp.cu` K3,
`quant_matmul.cu` K4, `dibr_fill.cu` K5) and any header they include, for
example a `git show <commit>:desktop2stereo_tpu_torch/csrc/<name>` of an
earlier commit.  Each source present is built with nvcc beside this tree's,
checked against it and timed in turns, each callable device-only (10 calls
captured into a CUDA graph) and eager, at the shapes of `chip_smoke.py`:

- K1 (4K eye Half-SBS and Half-TAB, feather off and on; both f32 eyes at
  the full 4K frame) and K5 (full 4K frame, sweep sign -1 and +1) must be
  bit-identical (`torch.equal`).  Beside this tree's kernel run `alt`, the
  same kernel with the other segment mode at that width (whole rows staged
  in shared memory where the module uses 512-pixel segments, and the
  reverse), and each `--variant`: this tree's DIBR sources built with the
  extra comma-separated nvcc FLAGS (e.g. `mb3=-DD2S_DIBR_MIN_BLOCKS=3`,
  `nostop=-DD2S_DIBR_SWEEP_STOP=0`).
  The DIBR sources of each version also get a ptxas report (registers,
  shared memory, spills) and the count of shared and global loads and
  stores in each kernel's SASS (`cuobjdump -sass`, kept beside the report
  in chiprun_out/).
- K2 within 2e-2 of this tree's, with SDPA beside it; K4 exactly, with
  `torch._int_mm` beside it; K3 within 1e-3.
- K2's f32 body, where the other source has it (`d2s_attention_f32_fwd`):
  a ptxas report of both versions, and both versions each within
  `F32_ATTN_MAX_ABS` of the f32 plain version and timed beside f32 SDPA
  and the bound at the flagship's [1, 778, 16, 64] (qkv views), BEiT-L's
  [1, 577, 16, 64] with its 18x32 f32 table (SDPA with the expanded table
  as a float mask) and DepthPro's [35, 730, 16, 64].

The other DIBR sources may take the launch geometry as this tree's do, or
not (the earlier thread-per-pixel ones), as their source declares; the other `quant_matmul.cu` may
take the row pass's scratch pointers (xq, xs) or not.  Prints one JSON
object last and writes chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = ("dibr_pair.cu", "attention.cu", "warp.cu", "quant_matmul.cu", "dibr_fill.cu")


def build_report(lib, out_dir: Path, tag: str):
    """ptxas's registers / shared bytes / spills and the SASS's shared and
    global loads and stores, by kernel, for one CudaLibrary's source."""
    from desktop2stereo_tpu_torch.ops.kernels import build as B

    obj = out_dir / f"{tag}-{lib.source.stem}.o"
    cmd = [B.find_nvcc(), *B.ARCH_FLAGS, "-std=c++17", "-O3", *lib.extra_flags,
           "-Xptxas", "-v", "-c", "-o", str(obj), str(lib.source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    kernels, name = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = {}
        elif name and "Used" in line:
            k = kernels[name]
            k["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            k["static_smem"] = int(smem.group(1)) if smem else 0
        elif name and "stack frame" in line:
            nums = [int(v) for v in re.findall(r"(\d+) bytes (?:stack frame|spill stores|spill "
                                               r"loads)", line)]
            kernels[name].update(zip(("stack", "spill_stores", "spill_loads"), nums))
    sass = subprocess.run([str(Path(B.find_nvcc()).parent / "cuobjdump"), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    obj.with_suffix(".sass").write_text(sass)
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = block.split()[0]
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)(?:\.[\w.]+)?\s",
                         block)
        counts = {op: sum(o == op for o in ops) for op in ("LDS", "LDG", "STS", "STG")}
        counts["instructions"] = len(ops)
        kernels.setdefault(fname, {}).update(sass=counts)
    return kernels


# where the K1 entry points take their stream count (the wrappers' argument
# order)
STREAMS_ARG = {"d2s_dibr_pair_half": 3, "d2s_dibr_pair_eyes": 4}


def _one_stream_library():
    from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

    class OneStreamLibrary(CudaLibrary):
        """A K1 source from before the stream axis (segments, no stream
        count): the wrappers' calls with one stream, the count dropped."""

        def call(self, name, *args):
            i = STREAMS_ARG[name]
            if args[i] != 1:
                raise ValueError(f"{self.source.name} takes one stream a launch, not {args[i]}")
            super().call(name, *args[:i], *args[i + 1:])

    return OneStreamLibrary


def main(argv) -> int:
    args = argv[1:]
    other = Path(args.pop(0)).resolve() if args and not args[0].startswith("--") else None
    flags = {}
    while len(args) >= 2 and args[0] == "--variant" and "=" in args[1]:
        name, value = args[1].split("=", 1)
        flags[name] = tuple(value.split(","))
        args = args[2:]
    present = [s for s in SOURCES if other and (other / s).is_file()]
    if not present or args:
        print(__doc__, file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.ops import stereo as S
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
    from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K5
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.kernels import warp as K3
    from desktop2stereo_tpu_torch.ops.kernels.build import CudaLibrary

    OneStreamLibrary = _one_stream_library()
    policy = cuda_policy(0, allow_tf32=False)
    dev = policy.device
    card = cs.card_line()
    print(card, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    modules = {"dibr_pair.cu": K1, "attention.cu": K2, "warp.cu": K3,
               "quant_matmul.cu": K4, "dibr_fill.cu": K5}
    _P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    libs, new_style = {}, {}
    for name in present:
        mod = modules[name]
        text = (other / name).read_text()
        sigs = dict(mod.KERNEL.signatures)
        new_style[name] = "int seg" in text or name not in ("dibr_pair.cu", "dibr_fill.cu")
        if name == "dibr_pair.cu" and not new_style[name]:
            sigs = {"d2s_dibr_pair_half": [_P, _P, _P, _I, _I, _F, _F, _F, _D, _I, _P],
                    "d2s_dibr_pair_eyes": [_P, _P, _P, _P, _I, _I, _F, _F, _F, _P]}
        elif name == "dibr_pair.cu" and "int streams" not in text:
            # segments but no stream axis: the entries take no stream count
            sigs = {k: v[:STREAMS_ARG[k]] + v[STREAMS_ARG[k] + 1:] for k, v in sigs.items()}
            libs[name] = OneStreamLibrary(str(other / name), sigs,
                                          extra_flags=mod.KERNEL.extra_flags)
            continue
        elif name == "dibr_fill.cu" and not new_style[name]:
            sigs = {"d2s_dibr_warp_fill_blend": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _P]}
        elif name == "attention.cu":  # an older source has no biased entry point
            sigs = {k: v for k, v in sigs.items() if k in text}
        elif name == "quant_matmul.cu":
            scratch = "void* xq" in text
            new_style[name] = scratch
            sigs = {"d2s_quant_dense": [_P, _I, _I, _P, _P, _P, _P] + ([_P, _P] if scratch else [])
                    + [_P, _I, _I, _I, _I, _P]}
        libs[name] = CudaLibrary(str(other / name), sigs, extra_flags=mod.KERNEL.extra_flags)
    dibr = [name for name in ("dibr_pair.cu", "dibr_fill.cu") if name in present]
    built = {(name, v): CudaLibrary(modules[name].KERNEL.source.name,
                                    modules[name].KERNEL.signatures,
                                    extra_flags=modules[name].KERNEL.extra_flags + extra)
             for name in dibr for v, extra in flags.items()}

    @contextlib.contextmanager
    def using(mod, lib=None, **consts):
        """Run a wrapper of `mod` on library `lib` and/or with module
        constants (SEG_TARGET, WHOLE_ROW_SMEM) set."""
        saved = mod.KERNEL, {k: getattr(mod, k, 0) for k in consts}
        mod.KERNEL = lib or mod.KERNEL
        for k, v in consts.items():
            setattr(mod, k, v)
        try:
            yield
        finally:
            mod.KERNEL = saved[0]
            for k, v in saved[1].items():
                setattr(mod, k, v)

    def variants(mod, name, fn, width):
        """The this / alt / --variant callables of one wrapper call `fn` on
        rows of `width` pixels."""
        def run(**kw):
            def call():
                with using(mod, **kw):
                    return fn()
            return call
        whole = K1.tile_geometry(width, K1.SEARCH_RADIUS, mod.SEG_TARGET,
                                 getattr(mod, "WHOLE_ROW_SMEM", 0)).grid_x == 1
        alt = dict(SEG_TARGET=512, WHOLE_ROW_SMEM=0) if whole else dict(SEG_TARGET=0)
        fns = {"this": run(), "alt": run(**alt)}
        fns.update({v: run(lib=built[name, v]) for v in flags})
        return fns

    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    result = {"card": card, "other": str(other), "variants": flags, "rows": {}, "builds": {}}
    rows = result["rows"]

    # -- build reports of the DIBR sources ---------------------------------
    for name in dibr:
        for tag, lib in [("this", modules[name].KERNEL), ("other", libs[name])] + [
                (v, built[name, v]) for v in flags]:
            rep = build_report(lib, out_dir, tag)
            result["builds"][f"{tag}:{name}"] = rep
            for fn, k in rep.items():
                print(f"[build] {tag} {name} {fn}: {k}", flush=True)

    # -- K1 ------------------------------------------------------------------
    if "dibr_pair.cu" in present:
        other_k1 = libs["dibr_pair.cu"]
        eh, ew = cs.EYE
        rng = np.random.default_rng(1)
        rgb_e = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
        dep_e = torch.from_numpy(rng.random((eh, ew), dtype=np.float32)).to(dev)
        dkw = dict(ipd=cs.IPD, depth_strength=cs.STRENGTH, convergence=0.01)

        def other_half(rgb, dep, feather, arrangement):
            if new_style["dibr_pair.cu"]:
                with using(K1, other_k1):
                    return K1.dibr_pair_half(rgb, dep, feather=feather, arrangement=arrangement,
                                             **dkw)
            h, w = dep.shape
            tab = arrangement == "tab"
            out = torch.empty((2 * h, w, 3) if tab else (h, 2 * w, 3), dtype=torch.uint8,
                              device=dev)
            other_k1.call("d2s_dibr_pair_half", rgb.data_ptr(), dep.data_ptr(), out.data_ptr(),
                          h, w, dkw["ipd"], dkw["depth_strength"], dkw["convergence"],
                          float(feather), int(tab), stream())
            return out

        def other_eyes(rgb, dep):
            if new_style["dibr_pair.cu"]:
                with using(K1, other_k1):
                    return K1.dibr_pair_eyes(rgb, dep, **dkw)
            h, w = dep.shape
            left, right = torch.empty_like(rgb), torch.empty_like(rgb)
            other_k1.call("d2s_dibr_pair_eyes", rgb.data_ptr(), dep.data_ptr(), left.data_ptr(),
                          right.data_ptr(), h, w, dkw["ipd"], dkw["depth_strength"],
                          dkw["convergence"], stream())
            return left, right

        for feather in (0.0, S.FEATHER_WIDTH):
            for arrangement in ("sbs", "tab"):
                call = lambda: K1.dibr_pair_half(rgb_e, dep_e, feather=feather,  # noqa: E731
                                                 arrangement=arrangement, **dkw)
                fns = variants(K1, "dibr_pair.cu", call, ew)
                fns["other"] = lambda: other_half(rgb_e, dep_e, feather, arrangement)
                want = fns["other"]()
                for v, fn in fns.items():
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"dibr_pair_half {arrangement} feather={feather}: "
                                             f"{v} differs from the other version")
                print(f"[equal] dibr_pair_half eye {eh}x{ew} {arrangement} feather={feather}: "
                      f"{', '.join(fns)} bit-identical", flush=True)
                rows[f"dibr_pair_half_{arrangement}_f{feather}"] = dict(
                    cs.time_both(torch, fns), shape=f"eye {eh}x{ew} {arrangement} "
                    f"feather={feather}", bound=cs.bound_ms(
                        policy.name, 4 * 4 * eh * ew + 2 * 3 * eh * ew,
                        cs.OPS_PER_PX["dibr_pair"] * eh * ew, "f32"))
        del rgb_e, dep_e
        h, w = cs.FULL
        rgb_f = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) * 255).to(dev)
        dep_f = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        fns = variants(K1, "dibr_pair.cu", lambda: K1.dibr_pair_eyes(rgb_f, dep_f, **dkw), w)
        fns["other"] = lambda: other_eyes(rgb_f, dep_f)
        want = fns["other"]()
        for v, fn in fns.items():
            if not all(torch.equal(a, b) for a, b in zip(fn(), want)):
                raise AssertionError(f"dibr_pair_eyes: {v} differs from the other version")
        print(f"[equal] dibr_pair_eyes {h}x{w}: {', '.join(fns)} bit-identical", flush=True)
        rows["dibr_pair_eyes"] = dict(
            cs.time_both(torch, fns), shape=f"frame {h}x{w} eyes f32",
            bound=cs.bound_ms(policy.name, 4 * 4 * h * w + 2 * 3 * 4 * h * w,
                              cs.OPS_PER_PX["dibr_pair"] * h * w, "f32"))
        del rgb_f, dep_f, want
        torch.cuda.empty_cache()

    # -- K5 ------------------------------------------------------------------
    if "dibr_fill.cu" in present:
        other_k5 = libs["dibr_fill.cu"]
        h, w = cs.FULL
        rng = np.random.default_rng(3)
        rgb = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        _, px, _, conf = S.dibr_geometry(dep, -cs.IPD / 2, cs.STRENGTH, 0.01)
        args = (rgb, dep, conf.contiguous(), px.clamp(0.0, w - 1.0).contiguous())

        def other_fill(sign):
            if new_style["dibr_fill.cu"]:
                with using(K5, other_k5):
                    return K5.dibr_warp_fill_blend(*args, sweep_sign=sign)
            out = torch.empty_like(rgb)
            other_k5.call("d2s_dibr_warp_fill_blend", *(a.data_ptr() for a in args),
                          out.data_ptr(), h, w, int(sign), 12, 0.012, stream())
            return out

        for sign in (-1.0, 1.0):
            fns = variants(K5, "dibr_fill.cu",
                           lambda: K5.dibr_warp_fill_blend(*args, sweep_sign=sign), w)
            fns["other"] = lambda: other_fill(sign)
            want = fns["other"]()
            for v, fn in fns.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"dibr_fill sign {sign}: {v} differs from the other "
                                         f"version")
            print(f"[equal] dibr_fill {h}x{w} sweep {sign:+.0f}: {', '.join(fns)} "
                  f"bit-identical", flush=True)
            rows[f"dibr_fill_{sign:+.0f}"] = dict(
                cs.time_both(torch, fns), shape=f"frame {h}x{w} one eye, sweep {sign:+.0f}",
                bound=cs.bound_ms(policy.name, (3 * 4 * 2 + 3 * 4) * h * w,
                                  cs.OPS_PER_PX["dibr_fill"] * h * w, "f32"))
        del rgb, dep, px, conf, args, want
        torch.cuda.empty_cache()

    # -- K3 ------------------------------------------------------------------
    if "warp.cu" in present:
        h, w = cs.FULL
        rng = np.random.default_rng(2)
        img = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).to(dev)
        base = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        px = (base + torch.rand(h, w, device=dev) * 120 - 60).clamp(0, w - 1).contiguous()

        def other_warp():
            with using(K3, libs["warp.cu"]):
                return K3.horizontal_sample(img, px)
        err = (K3.horizontal_sample(img, px) - other_warp()).abs().max().item()
        if err > cs.WARP_MAX_ABS:
            raise AssertionError(f"warp: the two versions differ by {err}")
        rows["warp"] = dict(cs.time_both(torch, {"this": lambda: K3.horizontal_sample(img, px),
                                                 "other": other_warp}),
                            shape=f"[{h},{w},3] f32", max_abs_between=err)
        del img, px

    # -- K2's f32 body -------------------------------------------------------
    if "attention.cu" in present and "d2s_attention_f32_fwd" in libs["attention.cu"].signatures:
        for tag, lib in (("this", K2.KERNEL), ("other", libs["attention.cu"])):
            rep = build_report(lib, out_dir, tag)
            result["builds"][f"{tag}:attention.cu"] = rep
            for fn, k in rep.items():
                if "f32" in fn:
                    print(f"[build] {tag} attention.cu {fn}: {k}", flush=True)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 57)
        for key, shape, table in (("attention_f32", cs.ATTN_SHAPE, None),
                                  ("attention_relpos_f32", cs.BIAS_ATTN_SHAPE, (18, 32)),
                                  ("attention_f32_depthpro", cs.DEPTHPRO_ATTN_SHAPE, None)):
            B, N, H, D = shape
            if table is None:  # the encoder's q/k/v views of one qkv projection
                base = torch.randn(B, N, 3 * H * D, generator=gen, device=dev)
                q, k, v = (t.unflatten(-1, (H, D)) for t in base.split(H * D, dim=-1))
            else:
                q, k, v = (torch.randn(shape, generator=gen, device=dev) for _ in range(3))
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            nbytes = 4 * B * N * H * D * 4
            if table is None:
                def call(q=q, k=k, v=v):
                    return K2.attention(q, k, v)
                want = K2.attention_ref(q, k, v)
                library = lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
                label = f"{list(shape)} f32 qkv views"
            else:
                gh, gw = table
                tab = 2.0 * torch.randn(H, K2.relative_position_count(gh, gw), generator=gen,
                                        device=dev)
                dense = K2.expand_rel_pos(tab, gh, gw)

                def call(q=q, k=k, v=v, tab=tab, gh=gh, gw=gw):
                    return K2.attention_relpos(q, k, v, tab, gh, gw)
                want = K2.attention_ref(q, k, v, dense)
                library = lambda qh=qh, kh=kh, vh=vh, m=dense[None]: (  # noqa: E731
                    F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m))
                nbytes += tab.numel() * 4
                label = f"{list(shape)} f32 + f32 table [{H},{tab.shape[1]}] ({gh}x{gw})"

            def other(call=call):
                with using(K2, libs["attention.cu"]):
                    return call()
            errs = {name: (fn() - want).abs().max().item()
                    for name, fn in (("this", call), ("other", other))}
            if max(errs.values()) > cs.F32_ATTN_MAX_ABS:
                raise AssertionError(f"{key}: a version is off its plain version: {errs}")
            del want
            rows[key] = dict(cs.time_both(torch, {"this": call, "other": other,
                                                  "library": library}),
                             shape=label, max_abs_vs_plain=errs,
                             bound=cs.bound_ms(policy.name, nbytes, 4 * B * H * N * N * D,
                                               "f32"))
            del q, k, v, qh, kh, vh
            torch.cuda.empty_cache()

    # -- K2 ------------------------------------------------------------------
    B, N, H, D = cs.ATTN_SHAPE
    if "attention.cu" in present:
        def other_attention(q, k, v):
            with using(K2, libs["attention.cu"]):
                return K2.attention(q, k, v)
        gen = torch.Generator(device=dev).manual_seed(cs.SEED)
        qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        err = (K2.attention(q, k, v).float() - other_attention(q, k, v).float()).abs().max().item()
        if err > cs.ATTN_MAX_ABS:
            raise AssertionError(f"attention: the two versions differ by {err}")
        t = cs.time_both(torch, {"this": lambda: K2.attention(q, k, v),
                                 "other": lambda: other_attention(q, k, v),
                                 "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
        rows["attention"] = dict(t, shape=f"{list(cs.ATTN_SHAPE)} bf16 qkv views",
                                 max_abs_between=err)

    # -- K4 ------------------------------------------------------------------
    if "quant_matmul.cu" in present:
        def other_dense(x, wq, scale, bias):
            M, K = x.shape
            out = torch.empty((M, wq.shape[0]), dtype=x.dtype, device=dev)
            held = ([torch.empty((M, K), dtype=torch.int8, device=dev),
                     torch.empty((M,), dtype=torch.float32, device=dev)]
                    if new_style["quant_matmul.cu"] else [])
            libs["quant_matmul.cu"].call(
                "d2s_quant_dense", x.data_ptr(), int(x.dtype == torch.bfloat16), x.stride(0),
                wq.data_ptr(), scale.data_ptr(), bias.data_ptr(), None,
                *(t.data_ptr() for t in held), out.data_ptr(),
                1 if x.dtype == torch.bfloat16 else 0, M, K, wq.shape[0], stream())
            return out

        for name, kin, fout in cs.VIT_L_DENSE:
            x, wq, scale, bias = cs.dense_inputs(np, torch, dev, N, kin, fout, torch.bfloat16,
                                                 True, seed=kin + fout)
            if not torch.equal(K4.quant_dense(x, wq, scale, bias), other_dense(x, wq, scale, bias)):
                raise AssertionError(f"quant_matmul {name}: the two versions differ")
            xq8 = x.float().clamp(-127, 127).round().to(torch.int8)
            wt = wq.t()
            t = cs.time_both(torch, {"this": lambda: K4.quant_dense(x, wq, scale, bias),
                                     "other": lambda: other_dense(x, wq, scale, bias),
                                     "library": lambda: torch._int_mm(xq8, wt)})
            rows[f"quant_matmul_{name}"] = dict(
                t, shape=f"{name} [{N},{kin}] bf16 x [{fout},{kin}] int8 + bias")

    for name, row in rows.items():
        e = row["eager"]
        cols = [k for k in row if k not in ("eager", "shape", "bound", "max_abs_between",
                                            "max_abs_vs_plain")]
        bound = (f"; bound {row['bound'][0]:.4f} ({row['bound'][1]}), this at "
                 f"{row['bound'][0] / row['this']:.0%} of it" if "bound" in row else "")
        print(f"[ab] {name} {row['shape']}: " + ", ".join(
            f"{k} {row[k]:.4f} ms (eager {e[k]:.4f})" for k in cols)
            + f"{bound}; device-only = CUDA graphs of 10 calls, median of {cs.TIMED_RUNS}; "
            f"{card}", flush=True)
    (out_dir / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result["rows"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
