"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point.  It is
compiled for ``sm_90a`` into the gitignored ``_build/`` at first use, under
a name keyed by the hash of its source, the headers it includes and the
flags, and loaded with ``ctypes``.  :func:`build_all` starts one nvcc per
missing library at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CudaLibrary", "build_all"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "kernels are built from csrc/ at first use"
    )


class CudaLibrary:
    """One ``csrc/<source>`` built into ``_build/lib<name>-<hash>.so``.

    ``bind(lib)`` sets the ctypes signatures of the loaded library;
    ``flags`` are nvcc flags of this library's own, after ``NVCC_FLAGS``.
    ``log`` holds nvcc's messages from this process's build (ptxas's
    per-kernel report when built verbose), empty when the library was
    built already."""

    def __init__(self, name: str, source: str, headers=(), bind=None, flags=()):
        self.name = name
        self.flags = tuple(flags)
        self.source = CSRC / source
        self.headers = tuple(CSRC / h for h in headers)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.log = ""

    def path(self) -> Path:
        h = hashlib.sha1(" ".join(NVCC_FLAGS + self.flags).encode())
        for p in (self.source, *self.headers):
            h.update(p.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def _start(self, verbose: bool):
        """Start nvcc for a missing library → ``(process, tmp, so)``, or
        None when the library is built already."""
        so = self.path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *self.flags]
        if verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        return proc, tmp, so

    def _finish(self, started, verbose: bool):
        proc, tmp, so = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} ({proc.returncode}):\n{err}"
            )
        self.log = err
        if verbose and err:
            print(err, end="", flush=True)
        os.replace(tmp, so)

    def load(self, verbose: bool = False) -> ctypes.CDLL:
        """Build (once per content) and load the library."""
        with self._lock:
            if self._lib is None:
                started = self._start(verbose)
                if started is not None:
                    self._finish(started, verbose)
                lib = ctypes.CDLL(str(self.path()))
                if self._bind is not None:
                    self._bind(lib)
                self._lib = lib
            return self._lib


def build_all(libraries, verbose: bool = False) -> None:
    """Start nvcc for every missing library together, wait for all, then
    load each."""
    started = [(lib, lib._start(verbose)) for lib in libraries]
    for lib, st in started:
        if st is not None:
            lib._finish(st, verbose)
    for lib in libraries:
        lib.load()
