"""Seconds in the program's `d2s.setup.warmup` span: the warm-up of the
cell's frame shape (`pipeline/programs.py`), each stage's first call and
whole frames, from the process's span log."""

from stereobench.spans import setup_seconds


def read(run):
    return setup_seconds("d2s.setup.warmup")
