"""Build and load the port's CUDA C++ kernels.

Each kernel source in `desktop2stereo_tpu_torch/csrc/` has a plain C
interface.  At first use it is compiled with nvcc for `sm_90a` into its own
shared library under `desktop2stereo_tpu_torch/_build/` (git-ignored), named
by a hash of the source, the headers it includes with quotes (such as
`hopper.cuh`) and the flags, so an edited source or header rebuilds and an
unchanged one loads at once.  The library is loaded with ctypes; pointers
and the CUDA stream cross as `c_void_p`, and every entry point returns
`cudaGetLastError()`, which `CudaLibrary.call` turns into an exception.

Nothing here runs when a module is imported: the CPU tests import every
module, and a build needs nvcc, which only a CUDA host has.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from desktop2stereo_tpu_torch.pipeline.profiling import PROCESS_LOG, annotate

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
# $D2S_BUILD_DIR moves the built libraries (a cold build beside a warm one)
BUILD_DIR = Path(os.environ.get("D2S_BUILD_DIR") or PACKAGE_DIR / "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo")
_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    """nvcc from $PATH, $CUDA_HOME or /usr/local/cuda; raises if absent."""
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($PATH, $CUDA_HOME, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use and need the "
        "CUDA toolkit")


class CudaLibrary:
    """One kernel source → one lazily built, ctypes-loaded shared library.

    `signatures` maps each exported C function to its argument types; every
    function returns an int (a cudaError_t).  `entry_launches` counts kernel
    launches made through `call` by entry point (K2's biased and unbiased
    entries apart), and `captured_launches` those recorded into a CUDA
    graph capture instead, which run at each replay; a wrapper adds to
    `entry_launches` where it launches.  `launches` is the sum of
    `entry_launches`, and callers set it to 0 before a run they want to
    count, which clears both.
    """

    def __init__(self, source: str, signatures: Dict[str, Sequence],
                 extra_flags: Sequence[str] = ()) -> None:
        self.source = CSRC_DIR / source
        self.signatures = dict(signatures)
        self.extra_flags = tuple(extra_flags)
        self.entry_launches: Dict[str, int] = {}
        self.captured_launches: Dict[str, int] = {}
        self.build_seconds: Optional[float] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def launches(self) -> int:
        return sum(self.entry_launches.values())

    @launches.setter
    def launches(self, n: int) -> None:
        if n != 0:
            raise ValueError(f"launch counts can only be reset to 0, not {n}")
        self.entry_launches.clear()
        self.captured_launches.clear()

    def _flags(self) -> tuple:
        return ARCH_FLAGS + BASE_FLAGS + self.extra_flags

    def source_files(self) -> List[Path]:
        """The source and every header it includes with quotes, recursively
        (paths relative to the including file), each once."""
        files: List[Path] = []
        todo = [self.source]
        while todo:
            path = todo.pop(0)
            if path not in files:
                files.append(path)
                todo += [path.parent / name
                         for name in _QUOTED_INCLUDE.findall(path.read_text())]
        return files

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in self.source_files():
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(self._flags()).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile if the hashed library is missing; returns its path."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *self._flags(), "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source.name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        self.build_seconds = time.perf_counter() - t0
        return out

    @property
    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                lib.d2s_error_string.argtypes = [ctypes.c_int]
                lib.d2s_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib

    def call(self, name: str, *args) -> None:
        """Launch through entry `name`; raises on a non-zero cudaError_t."""
        lib = self.lib
        code = getattr(lib, name)(*args)
        if code != 0:
            msg = lib.d2s_error_string(code).decode()
            raise RuntimeError(f"{self.source.name}:{name} failed: "
                               f"cudaError {code} ({msg})")
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        counts = self.captured_launches if capturing else self.entry_launches
        counts[name] = counts.get(name, 0) + 1


def build_all() -> Dict[str, Optional[float]]:
    """Build (where missing) and load the five kernel sources' libraries
    (K2, K1, K3, K5, K4), one nvcc per source, all started together, in
    the span `d2s.setup.kernels` of the process's span log;
    → {source name: nvcc seconds, None where it was already built}."""
    from desktop2stereo_tpu_torch.ops.kernels import (
        attention, dibr, dibr_fill, quant_matmul, warp)

    libs = [attention.KERNEL, dibr.KERNEL, warp.KERNEL, dibr_fill.KERNEL, quant_matmul.KERNEL]
    with annotate("d2s.setup.kernels", log=PROCESS_LOG), ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda k: k.lib, libs))
    return {k.source.name: k.build_seconds for k in libs}
