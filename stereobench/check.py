"""How `correct` is decided: the frames the window delivered, stage by
stage, against the plain reference.

For each sampled delivery the harness kept what the timed path computed
for it (`record.Recorder`): the outputs of the model's encoders (the
modules a configuration names under `check_encoders`), the model's raw
depth, the delivered depth (the display depth after the feed's EMA), the
depth of the program's previous call (the EMA it started from) and the u8
frame.  The reference checks each stage from the program's own input to
that stage, so that each number reads one stage's error alone:

- encoders: the reference's encoders on the ring frame the call held,
  computed in float32 and in bfloat16.  `encoder_error_ratio` is the
  program's mean |difference| from float32 over the bfloat16 reference's
  (a yardstick of each seed's sensitivity), summed over the sample;
- decoder: the reference's decoder and head on the program's encoder
  outputs, in float32 and in bfloat16: `decoder_error_ratio`, the same
  ratio on the raw depth, and `decoder_error_ratio.folded` with the
  bfloat16 yardstick's resizes and transposed convolutions folded into
  bfloat16 tables (`reference/tables.py`), as a bfloat16 program may run
  them;
- post: the reference's depth post and EMA on the program's raw depth and
  previous EMA: `depth_post_abs.worst`, the worst frame's mean |difference|;
- tail: the reference's Half-SBS frame of the ring frame and the delivered
  depth: `sbs_off_share.worst`, the worst frame's share of u8 values more
  than 1 apart (and its mean difference, `sbs_mean_lsb.worst`).

A stateful family (`STATEFUL` in `reference/<family>.py`) carries a window
from call to call, and its carry is one more stage.  Its decoder runs on
the program's encoder outputs and the carry the program's model was given
for that call (None on a first call), and also returns the entries it adds
to the window:

- `carry_error_ratio`: the program's entries' mean |difference| from the
  float32 reference's over the bfloat16 reference's, summed over the sample;
- `carry_shift_off`: the share of the carry out of the call, as the
  program holds it, whose values are not bit-equal to the carry in advanced
  by the family's `advance` with the program's entries.  The update is a
  copy, so a sound program reads 0;
- `carry_in_off`: the share of the carry into the call whose values are
  not bit-equal to the carry out of the row's previous call, as the
  program held it (a first call takes none; a later call given none, or
  another row's, is off).  Together with `carry_shift_off` it holds the
  carry the decoder was given to the program's own entries, call after
  call; a sound program reads 0.

Both are counted when the sample takes the frame (`record.Recorder.
carry_counts`), so that no whole carry is held for the check.

The cell's limits file names the numbers that decide `correct`.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from stereobench.reference import frame as F
from stereobench.reference import tables


class _Recorded(Exception):
    """Raised once every encoder has run: the rest of the model is not needed."""


@contextlib.contextmanager
def encoders_recorded(model: torch.nn.Module, paths: Sequence[str]):
    """→ a dict filled, as `model` runs, with each encoder's outputs (by
    path); the forward stops with `_Recorded` once all have run."""
    got: Dict[str, List[torch.Tensor]] = {}

    def hook(path):
        def record(module, args, out):
            got[path] = list(out)
            if len(got) == len(paths):
                raise _Recorded
        return record

    handles = [model.get_submodule(p).register_forward_hook(hook(p)) for p in paths]
    try:
        yield got
    except _Recorded:
        pass
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def encoders_replaced(model: torch.nn.Module, outputs: Dict[str, List[torch.Tensor]]):
    """Inside, each encoder of `model` named in `outputs` returns those
    tensors instead of computing."""
    mods = {p: model.get_submodule(p) for p in outputs}
    for p, m in mods.items():
        m.forward = (lambda outs: lambda *a, **k: list(outs))(outputs[p])
    try:
        yield
    finally:
        for m in mods.values():
            del m.forward


def _abs_sum(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    """Σ |a - b| over matching tensors, in float32, as a mean."""
    total = sum((x.float() - y.float()).abs().sum().item() for x, y in zip(a, b))
    return total / max(sum(x.numel() for x in a), 1)


def _flat(outputs: Dict[str, List[torch.Tensor]], paths: Sequence[str]) -> List[torch.Tensor]:
    return [t for p in paths for t in outputs[p]]


def producing_steps(steps, sample) -> List[int]:
    """For each sampled delivery (feed, t0, ...), the index of the call
    whose fresh row `feed` held the frame captured at t0."""
    where = {}
    for k, st in enumerate(steps):
        for r, ((_, _, t0), fresh) in enumerate(zip(st.rows, st.fresh)):
            if fresh:
                where.setdefault((r, t0), k)
    out = []
    for feed, t0, *_ in sample:
        if (feed, t0) not in where:
            raise RuntimeError(f"no program call produced feed {feed}'s frame captured at {t0}")
        out.append(where[(feed, t0)])
    return out


def aggregate(per_frame: List[Dict[str, float]]) -> Dict[str, float]:
    """The sample's numbers: each stage's ratio of sums, and the worst frame
    of the post and tail numbers."""
    s = {k: sum(f[k] for f in per_frame) for k in per_frame[0]}
    ratio = lambda a, b: s[a] / max(s[b], 1e-30)  # noqa: E731
    out = {"encoder_error_ratio": ratio("enc", "enc_bf16"),
           "decoder_error_ratio": ratio("dec", "dec_bf16"),
           "decoder_error_ratio.folded": ratio("dec", "dec_bf16_folded")}
    for name in ("depth_post_abs", "sbs_off_share", "sbs_mean_lsb"):
        out[f"{name}.worst"] = max(f[name] for f in per_frame)
    n = len(per_frame)
    out.update({"encoder_mean_abs": s["enc"] / n, "decoder_mean_abs": s["dec"] / n})
    if "carry" in s:  # a stateful family
        out["carry_error_ratio"] = ratio("carry", "carry_bf16")
        out["carry_shift_off"] = s["shift_off"] / max(s["shift_values"], 1)
        out["carry_in_off"] = s["chain_off"] / max(s["chain_values"], 1)
    return out


@torch.no_grad()
def reference_numbers(family, cfg: dict, display: dict, weights: Dict[str, torch.Tensor],
                      rings: Sequence[Sequence[np.ndarray]], steps, sample,
                      out_hw: Tuple[int, int], device: torch.device) -> Dict[str, float]:
    """The numbers of `aggregate` over the sample (see the module's doc).
    Each sample item is (feed, t0, u8 frame, stages) as `record.Recorder`
    keeps it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stateful = getattr(family, "STATEFUL", False)
    paths = list(cfg["check_encoders"])
    at = producing_steps(steps, sample)
    keys = [steps[k].rows[feed][:2] for k, (feed, *_) in zip(at, sample)]

    ref32 = family.build(cfg).to(device=device, dtype=torch.float32).eval()
    ref32.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True)
    ref16 = copy.deepcopy(ref32).to(torch.bfloat16)
    mean, std = cfg["image_mean"], cfg["image_std"]
    mode, antialias = family.RESIZE_MODE
    mh, mw = family.model_input_size(cfg, *out_hw)

    def planar(f: int, i: int) -> torch.Tensor:
        return F.planar_rgb(torch.from_numpy(rings[f][i]).to(device), out_hw)

    def encoders(model, x):
        with encoders_recorded(model, paths) as got:
            model(x)
        return _flat(got, paths)

    enc_ref = {}  # ring frame → (float32, bfloat16) encoder outputs
    for key in sorted(set(keys)):
        p = planar(*key)
        x32 = F.model_input(p, (mh, mw), mode, antialias, mean, std, torch.float32)
        x16 = F.model_input(p, (mh, mw), mode, antialias, mean, std, torch.bfloat16)
        enc_ref[key] = (encoders(ref32, x32), encoders(ref16, x16))

    pix32 = torch.zeros(1, 3, mh, mw, device=device)
    pix16 = pix32.to(torch.bfloat16)

    def decoder(model, st, pix, dtype, folded=False):
        """(raw depth, entries in float32 or None) from the program's encoder
        outputs and, of a stateful family, the carry its model was given."""
        outs = {p: [t.to(dtype) for t in st["enc"][p]] for p in paths}
        with contextlib.ExitStack() as stack:
            if folded:
                stack.enter_context(tables.folded())
            stack.enter_context(encoders_replaced(model, outs))
            if not stateful:
                return model(pix)[0].float(), None
            carry = None if st["carry_in"] is None else tuple(c.to(dtype) for c in st["carry_in"])
            raw, entries = model(pix, carry)
        return raw[0].float(), [e.float() for e in entries]

    per_frame: List[Dict[str, float]] = []
    for (feed, t0, got_sbs, st), key in zip(sample, keys):
        if st is None:
            raise RuntimeError(f"feed {feed}'s frame captured at {t0}: its stages were no "
                               f"longer held when it was delivered")
        e32, e16 = enc_ref[key]
        enc = _flat(st["enc"], paths)
        raw = st["raw"].float()
        r32, c32 = decoder(ref32, st, pix32, torch.float32)
        r16, c16 = decoder(ref16, st, pix16, torch.bfloat16)
        r16f, _ = decoder(ref16, st, pix16, torch.bfloat16, folded=True)
        carried = {}
        if stateful:
            if st["chain"] is None:
                raise RuntimeError(f"feed {feed}'s frame captured at {t0}: the previous "
                                   f"call's carry was no longer held")
            carried = {"carry": _abs_sum(st["entries"], c32), "carry_bf16": _abs_sum(c16, c32)}
            for name in ("shift", "chain"):
                off, values = st[name]
                carried.update({f"{name}_off": int(off), f"{name}_values": values})
        if raw.shape != r32.shape:
            raise RuntimeError(f"raw depth {tuple(raw.shape)}, the reference's "
                               f"{tuple(r32.shape)}")

        shown = F.display_depth(raw, cfg["metric_depth"], display["foreground_scale"],
                                display["aa_strength"])
        if display["temporal_smooth"] and not st["first"]:  # the first call has no EMA
            if st["prev"] is None:
                raise RuntimeError(f"feed {feed}'s frame captured at {t0}: the previous "
                                   f"call's depth was no longer held")
            shown = F.ema_step(st["prev"].float(), shown, display["ema_alpha"])
        depth = st["depth"].float()

        want = F.half_sbs(planar(*key), depth, ipd=display["ipd"],
                          depth_strength=display["depth_strength"],
                          convergence=display["convergence"])
        lsb = (torch.from_numpy(np.ascontiguousarray(got_sbs)).to(device).int()
               - want.int()).abs()
        per_frame.append({
            "enc": _abs_sum(enc, e32), "enc_bf16": _abs_sum(e16, e32),
            "dec": _abs_sum([raw], [r32]), "dec_bf16": _abs_sum([r16], [r32]),
            "dec_bf16_folded": _abs_sum([r16f], [r32]),
            "depth_post_abs": (depth - shown).abs().mean().item(),
            "sbs_off_share": (lsb > 1).float().mean().item(),
            "sbs_mean_lsb": lsb.float().mean().item(), **carried})
    return aggregate(per_frame)
