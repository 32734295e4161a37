"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``*.cu`` source is compiled on first use into a shared library with
a plain C interface under ``build/kernels/`` at the repository root (a
directory ``.gitignore`` lists):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>.so <source>

Every C entry point returns ``cudaGetLastError()`` and the Python
wrapper raises on a non-zero code (:func:`check`).  Nothing here runs at
import time: the CPU tests import every module, and the CPU machine has
no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "KernelBuildError", "build_report", "check", "load",
           "nvcc_path"]

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# name -> (ctypes.CDLL, build report); one build per process
_LOADED: dict = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def load(name: str, source: Path, declare) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``source`` on first use.

    The library is written to a temporary name and renamed to
    ``BUILD_DIR/<name>.so``, so a concurrent builder never loads a
    half-written file.  ``declare(lib)`` sets ``argtypes``/``restype`` of
    its entry points.
    """
    if name not in _LOADED:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                               str(source)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelBuildError(f"{name}: nvcc exit {proc.returncode}\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, BUILD_DIR / f"{name}.so")
        lib = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
        declare(lib)
        _LOADED[name] = (lib, {"seconds": seconds,
                               "ptxas": proc.stdout + proc.stderr})
    return _LOADED[name][0]


def build_report(name: str) -> dict:
    """``{"seconds", "ptxas"}`` of the library ``name`` built by this
    process."""
    return _LOADED[name][1]


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")
