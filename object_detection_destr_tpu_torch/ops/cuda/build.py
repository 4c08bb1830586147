"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and becomes its own shared
library, compiled with ``nvcc`` for ``sm_90a`` at first use into ``_build/``
beside the package sources (rebuilt when the source or a header it includes
is newer), then loaded with ctypes. :func:`build_all` starts one ``nvcc`` per
source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Iterable, Optional, Sequence

__all__ = ["CudaLibrary", "LaunchCounter", "build_all"]

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


class LaunchCounter:
    """A kernel wrapper's launch counts: ``launches``, and
    ``launches_by_stream``, the same by the handle of the CUDA stream each
    launch went to (ranks that share one card, each on a stream of its own,
    read their own launches there). The wrapper calls :meth:`count_launch`
    where it launches its kernel and nowhere else."""

    def __init__(self):
        self.launches = 0
        self.launches_by_stream: dict[int, int] = {}
        self._count_lock = threading.Lock()

    def count_launch(self, stream: int) -> None:
        with self._count_lock:
            self.launches += 1
            self.launches_by_stream[stream] = self.launches_by_stream.get(stream, 0) + 1


class CudaLibrary:
    """One ``csrc/<source>`` compiled into ``_build/lib<name>.so``.

    ``functions`` maps each exported C function to ``(restype, argtypes)``;
    ``abi`` names the function returning the source's ABI version and the
    version the binding expects.
    """

    def __init__(self, name: str, source: str, headers: Sequence[str] = (),
                 functions: Optional[dict] = None, abi: tuple[str, int] = ("", 0),
                 flags: Sequence[str] = ()):
        self.name = name
        self.source = os.path.join(CSRC, source)
        self.headers = [os.path.join(CSRC, h) for h in headers]
        self.path = os.path.join(BUILD_DIR, f"lib{name}.so")
        self.functions = functions or {}
        self.abi = abi
        self.flags = list(flags)
        self.build_log = ""
        self.build_seconds = 0.0
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def stale(self) -> bool:
        if not os.path.exists(self.path):
            return True
        built = os.path.getmtime(self.path)
        return any(os.path.getmtime(p) > built for p in [self.source, *self.headers])

    def _command(self, out: str) -> list[str]:
        # -split-compile=0 spreads one source's device-code optimisation over
        # every core: the heavily unrolled two-pass file sets the build's length
        return [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-split-compile=0",
            *self.flags, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", out, self.source,
        ]

    def start(self) -> Optional[tuple[subprocess.Popen, str, float]]:
        """Start nvcc if the library is stale; None when it is up to date."""
        if not self.stale():
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        proc = subprocess.Popen(self._command(tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, time.perf_counter()

    def finish(self, started) -> float:
        """Wait for a build begun by :meth:`start`; the seconds it took."""
        if started is None:
            return 0.0
        proc, tmp, t0 = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} ({proc.returncode}):\n{err}")
        os.replace(tmp, self.path)
        self.build_log = err
        self.build_seconds = time.perf_counter() - t0
        return self.build_seconds

    def build(self) -> float:
        return self.finish(self.start())

    def library(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(self.path)
                abi_fn, version = self.abi
                if abi_fn:
                    fn = getattr(lib, abi_fn)
                    fn.restype, fn.argtypes = ctypes.c_int, []
                    if fn() != version:
                        raise RuntimeError(f"{self.path} has a stale ABI; delete it to rebuild")
                for fname, (restype, argtypes) in self.functions.items():
                    fn = getattr(lib, fname)
                    fn.restype, fn.argtypes = restype, argtypes
                self._lib = lib
        return self._lib


def build_all(libraries: Iterable[CudaLibrary]) -> dict[str, float]:
    """Compile every stale library at once (one nvcc each); seconds per name."""
    libraries = list(libraries)
    started = [(lib, lib.start()) for lib in libraries]
    return {lib.name: lib.finish(s) for lib, s in started}
