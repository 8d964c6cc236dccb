"""ctypes bindings for the native host runtime (the repository's
`native/d2s_native.cpp`).

Port of `desktop2stereo_tpu/native/__init__.py` for the classes the port's
sources use:

- ShmFrameRing: a seqlocked latest-frame-wins ring in POSIX shared memory
  (the host-IPC analog of the reference's PBO/pinned DMA rings, reference
  xr_viewer/frame.py:62-161); an external producer feeds the pipeline with
  one memcpy.  The layout is the C++ file's, so a ring written here is read
  by the JAX package's binding and the other way round.
- X11Capture: Linux screen grab through a dlopen'd libX11, with XFixes
  cursor snapshots and window lookup (reference capture.py:249-491).
- FramePacer: absolute-deadline pacing through clock_nanosleep.

The library is built with g++ at first use into
`desktop2stereo_tpu_torch/_build/`, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one loads at once.  A
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR.parent / "native" / "d2s_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _U32, _U64, _I = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
# exported function → (restype, argtypes)
SIGNATURES = {
    "d2s_ring_create": (_P, [ctypes.c_char_p, _U32, _U32]),
    "d2s_ring_open": (_P, [ctypes.c_char_p]),
    "d2s_ring_write": (_U64, [_P, _P, _U32, _U32, _U32, _U64]),
    "d2s_ring_read_latest": (_U64, [_P, _P, _U32, _PU32, _PU32, _PU32,
                                    ctypes.POINTER(ctypes.c_uint64), _U64]),
    "d2s_ring_latest_seq": (_U64, [_P]),
    "d2s_ring_max_bytes": (_U32, [_P]),
    "d2s_ring_close": (None, [_P]),
    "d2s_x11_open": (_P, [ctypes.c_char_p]),
    "d2s_x11_size": (_I, [_P, _PI, _PI]),
    "d2s_x11_grab": (_I, [_P, _P, _I, _I]),
    "d2s_x11_grab_rect": (_I, [_P, _P, _I, _I, _I, _I]),
    "d2s_x11_find_window": (_U64, [_P, ctypes.c_char_p]),
    "d2s_x11_window_rect": (_I, [_P, _U64, _PI, _PI, _PI, _PI]),
    "d2s_x11_cursor": (_I, [_P, _P, _U32, _PI, _PI, _PI, _PI, _PI, _PI]),
    "d2s_x11_close": (None, [_P]),
    "d2s_now_ns": (_U64, []),
    "d2s_pace": (_U32, [ctypes.POINTER(ctypes.c_uint64), _U64]),
}


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"d2s_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its hashed file is missing; returns its path.
    Raises RuntimeError without the source or g++, or when g++ fails."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native source {SOURCE} not found")
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on $PATH: the native host runtime is "
                           "built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")  # per process: builds may race
    cmd = [gxx, *FLAGS, "-o", str(tmp), str(SOURCE), "-ldl"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return out


def load() -> ctypes.CDLL:
    """Build (once) and load the native library; raises if it cannot."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


class ShmFrameRing:
    """Latest-frame-wins shared-memory ring."""

    def __init__(self, name: str, max_bytes: int = 0, slots: int = 3,
                 create: bool = True):
        lib = load()
        self._lib = lib
        self.name = name
        if create:
            self._h = lib.d2s_ring_create(name.encode(), max_bytes, slots)
        else:
            self._h = lib.d2s_ring_open(name.encode())
        if not self._h:
            raise RuntimeError(f"could not {'create' if create else 'open'} ring {name}")
        self._buf = np.empty(lib.d2s_ring_max_bytes(self._h), np.uint8)
        self.last_seq = 0

    def write(self, frame: np.ndarray, timestamp_ns: int = 0) -> int:
        f = np.ascontiguousarray(frame, np.uint8)
        h, w = f.shape[0], f.shape[1]
        c = 1 if f.ndim == 2 else f.shape[2]
        seq = self._lib.d2s_ring_write(
            self._h, f.ctypes.data_as(ctypes.c_void_p), w, h, c,
            timestamp_ns or self._lib.d2s_now_ns())
        if seq == 0:
            raise ValueError("frame larger than ring slot capacity")
        return seq

    def read_latest(self) -> Optional[Tuple[np.ndarray, int]]:
        """Newest frame newer than the last read, or None."""
        w, h, c = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        ts = ctypes.c_uint64()
        seq = self._lib.d2s_ring_read_latest(
            self._h, self._buf.ctypes.data_as(ctypes.c_void_p), self._buf.size,
            ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), ctypes.byref(ts),
            self.last_seq)
        if seq in (0, 2**64 - 1):
            return None
        self.last_seq = seq
        n = w.value * h.value * c.value
        frame = self._buf[:n].reshape(h.value, w.value, c.value).copy()
        return frame, ts.value

    def close(self) -> None:
        if self._h:
            self._lib.d2s_ring_close(self._h)
            self._h = None


class X11Capture:
    """Root-window screen grab (BGRA)."""

    _CURSOR_CAP = 256 * 256

    def __init__(self, display: str = ""):
        lib = load()
        self._lib = lib
        self._h = lib.d2s_x11_open(display.encode())
        if not self._h:
            raise RuntimeError("no X11 display available")
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.d2s_x11_size(self._h, ctypes.byref(w), ctypes.byref(h))
        self.size = (h.value, w.value)
        self._buf = np.empty((h.value, w.value, 4), np.uint8)

    def grab(self) -> Optional[np.ndarray]:
        h, w = self.size
        rc = self._lib.d2s_x11_grab(self._h, self._buf.ctypes.data_as(ctypes.c_void_p), w, h)
        if rc != 0:
            return None
        return self._buf  # BGRA; callers copy if they keep it

    def grab_rect(self, x: int, y: int, w: int, h: int) -> Optional[np.ndarray]:
        """Region-of-desktop grab (window mode), BGRA [h,w,4]."""
        sh, sw = self.size
        x = max(0, min(x, max(sw - w, 0)))
        y = max(0, min(y, max(sh - h, 0)))
        w, h = min(w, sw), min(h, sh)
        buf = np.empty((h, w, 4), np.uint8)
        rc = self._lib.d2s_x11_grab_rect(self._h, buf.ctypes.data_as(ctypes.c_void_p),
                                         x, y, w, h)
        if rc != 0:
            return None
        return buf

    def find_window(self, title_substr: str) -> int:
        """Case-insensitive title-substring window search; 0 = not found
        (the reference's window-title mode, reference capture.py:39-247)."""
        return int(self._lib.d2s_x11_find_window(self._h, title_substr.encode()))

    def window_rect(self, window: int) -> Optional[Tuple[int, int, int, int]]:
        """(x, y, w, h) of a window in root coordinates, or None."""
        x, y, w, h = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rc = self._lib.d2s_x11_window_rect(self._h, window, ctypes.byref(x), ctypes.byref(y),
                                           ctypes.byref(w), ctypes.byref(h))
        if rc != 0 or w.value <= 0 or h.value <= 0:
            return None
        return x.value, y.value, w.value, h.value

    def cursor(self) -> Optional[Tuple[np.ndarray, int, int]]:
        """XFixes cursor snapshot: (argb [h,w] u32, root_x, root_y) with the
        hotspot already subtracted, or None without XFixes (reference
        capture.py:864-1340, 1385-1501)."""
        buf = np.empty(self._CURSOR_CAP, np.uint32)
        x, y, xh, yh, w, h = (ctypes.c_int() for _ in range(6))
        rc = self._lib.d2s_x11_cursor(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), self._CURSOR_CAP,
            ctypes.byref(x), ctypes.byref(y), ctypes.byref(xh), ctypes.byref(yh),
            ctypes.byref(w), ctypes.byref(h))
        if rc != 0 or w.value <= 0 or h.value <= 0:
            return None
        img = buf[: w.value * h.value].reshape(h.value, w.value)
        return img, x.value - xh.value, y.value - yh.value

    def close(self) -> None:
        if self._h:
            self._lib.d2s_x11_close(self._h)
            self._h = None


class FramePacer:
    """Absolute-deadline frame pacing; `wait` returns the intervals skipped."""

    def __init__(self, fps: float):
        self._lib = load()
        self.interval_ns = int(1e9 / fps) if fps > 0 else 0
        self._deadline = ctypes.c_uint64(0)

    def wait(self) -> int:
        if self.interval_ns == 0:
            return 0
        return self._lib.d2s_pace(ctypes.byref(self._deadline), self.interval_ns)
