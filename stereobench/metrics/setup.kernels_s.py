"""Seconds in the program's `d2s.setup.kernels` span: the kernel libraries
built or loaded (`ops/kernels/build.py:build_all`), from the process's
span log."""

from stereobench.spans import setup_seconds


def read(run):
    return setup_seconds("d2s.setup.kernels")
