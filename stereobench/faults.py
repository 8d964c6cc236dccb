"""Faults planted in the timed path, for reading what the check makes of
them (`calibrate.py --control <fault>`, and the CPU tests).  Each patches
the program's classes for the length of a `with planted(name):` block:

- `state-unchanged`: every call returns the EMA state it was given;
- `half-batch`: on a batched call the second half of the rows' raw depth
  is replaced by the mean of the first half's;
- `answer-altered`: the top eighth of every Half-SBS frame's rows comes out
  inverted (255 - value) where the tail produces it;
- `carry-frozen`: the model stage of a stateful model returns the carry it
  was given, so the window built by the first frame never advances;
- `carry-reset`: the model stage of a stateful model starts every call as
  a first call, with no carry, so its window holds the one frame.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state-unchanged", "half-batch", "answer-altered", "carry-frozen", "carry-reset")


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def _state_unchanged(programs):
    call = programs.FrameProgram.__call__

    def stuck(self, frame, state, fresh=None):
        sbs, depth, _ = call(self, frame, state, fresh)
        return sbs, depth, state

    return _patched(programs.FrameProgram, "__call__", stuck)


def _half_batch(programs):
    stage = programs.FrameProgram.model_stage

    def half(self, model_in, carry=(), fresh=None):
        raw, carry = stage(self, model_in, carry, fresh)
        if raw.ndim == 3 and raw.shape[0] > 1:
            h = raw.shape[0] // 2
            raw = torch.cat([raw[:h], raw[:h].mean(0, keepdim=True).expand_as(raw[h:])])
        return raw, carry

    return _patched(programs.FrameProgram, "model_stage", half)


def _carry_frozen(programs):
    stage = programs.FrameProgram.model_stage

    def frozen(self, model_in, carry=(), fresh=None):
        raw, new = stage(self, model_in, carry, fresh)
        return raw, (carry if carry else new)

    return _patched(programs.FrameProgram, "model_stage", frozen)


def _carry_reset(programs):
    stage = programs.FrameProgram.model_stage

    def reset(self, model_in, carry=(), fresh=None):
        return stage(self, model_in, (), fresh)

    return _patched(programs.FrameProgram, "model_stage", reset)


def _answer_altered(programs):
    dibr = programs.dibr_pair_half

    def altered(*args, **kwargs):
        out = dibr(*args, **kwargs).clone()
        band = out.shape[-3] // 8
        out[..., :band, :, :] = 255 - out[..., :band, :, :]
        return out

    return _patched(programs, "dibr_pair_half", altered)


@contextlib.contextmanager
def planted(name: str):
    import desktop2stereo_tpu_torch.pipeline.programs as programs

    make = {"state-unchanged": _state_unchanged, "half-batch": _half_batch,
            "answer-altered": _answer_altered, "carry-frozen": _carry_frozen,
            "carry-reset": _carry_reset}[name]
    with make(programs):
        yield
