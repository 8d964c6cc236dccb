"""Shared helpers of the port's XR client tests: the two packages' modules
side by side, and a structural equality that looks through dataclasses,
enums and numpy arrays of either package."""

import dataclasses
import enum
import importlib

import numpy as np


def xr(pkg: str, name: str):
    """`desktop2stereo_tpu.xr.<name>` (pkg "jax") or the port's (pkg "port")."""
    root = "desktop2stereo_tpu" if pkg == "jax" else "desktop2stereo_tpu_torch"
    return importlib.import_module(f"{root}.xr.{name}")


def client(pkg: str):
    root = "desktop2stereo_tpu" if pkg == "jax" else "desktop2stereo_tpu_torch"
    return importlib.import_module(f"{root}.tools.xr_client")


def plain(x):
    """A value of either package as plain Python and numpy: dataclasses as
    (class name, fields), enums as (class name, member name)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def assert_same(a, b, path="value"):
    """Exact equality of two packages' values, arrays by dtype and bytes."""
    a, b = plain(a), plain(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
        return
    assert type(a) is type(b) and (a == b or a != a and b != b), (path, a, b)


def u8_share(got, want):
    """(max LSB, share of values off) of two uint8 arrays."""
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d > 0).mean())
