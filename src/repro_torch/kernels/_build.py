"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``*.cu`` source is compiled on first use into a shared library with
a plain C interface under ``build/kernels/`` at the repository root (a
directory ``.gitignore`` lists):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o <tmp>.so <source> [extra flags]

A source that needs more (an include path such as
``-I/usr/local/cutlass/include``, a library such as ``-lcuda``) names
its own ``extra_flags``; they follow the source, so link flags land
after it.  The library is renamed to
``build/kernels/<name>-<digest>.so``, the digest taken over the command
line, the source's bytes and those of the headers (``*.cuh``) beside it:
a changed source, header or flag set gets a new path, so the dynamic
loader, which returns the handle it already holds for a path it has
opened, never hands back a stale library.  A library
already at its digest's path (another process built it: the ranks of a
spawned group load what their parent built) is loaded without running
``nvcc``; ``ptxas``'s report is kept beside it.

Every C entry point returns ``cudaGetLastError()`` and the Python
wrapper raises on a non-zero code (:func:`check`).  Nothing here runs at
import time: the CPU tests import every module, and the CPU machine has
no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "KernelBuildError", "build_report", "check", "load",
           "nvcc_path", "raw_stream"]

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# (name, extra flags) -> ctypes.CDLL; one build per process
_LOADED: dict = {}
# name -> report of its latest build in this process
_REPORTS: dict = {}


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


def load(name: str, source: Path, declare, extra_flags=()) -> ctypes.CDLL:
    """The loaded library ``name``, built from ``source`` on first use.

    ``extra_flags`` are further ``nvcc`` arguments for this source only,
    placed after it.  The library is written to a temporary name and
    renamed to ``BUILD_DIR/<name>-<digest>.so`` (module docstring), so a
    process building the same source at once never loads a half-written
    file; a library already there is loaded as it is.  ``declare(lib)`` sets
    ``argtypes``/``restype`` of its entry points.
    """
    key = (name, tuple(extra_flags))
    if key not in _LOADED:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", "", str(source), *key[1]]
        text = Path(source).read_bytes() + b"".join(
            h.read_bytes() for h in sorted(Path(source).parent.glob("*.cuh")))
        digest = hashlib.sha256("\0".join(a for a in cmd if a).encode()
                                + text).hexdigest()[:16]
        path = BUILD_DIR / f"{name}-{digest}.so"
        report = path.with_suffix(".ptxas")
        seconds = 0.0
        if not path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd[cmd.index("-o") + 1] = tmp
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise KernelBuildError(f"{name}: nvcc exit "
                                       f"{proc.returncode}\n"
                                       f"{proc.stdout}{proc.stderr}")
            report.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        declare(lib)
        _LOADED[key] = lib
        _REPORTS[name] = {"seconds": seconds, "path": str(path),
                          "ptxas": report.read_text()
                          if report.exists() else ""}
    return _LOADED[key]


def build_report(name: str) -> dict:
    """``{"seconds", "path", "ptxas"}`` of the library ``name`` loaded by
    this process (``seconds`` 0 where it was built before)."""
    return _REPORTS[name]


def check(code: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code}")


def raw_stream(device) -> int:
    """The handle of ``device``'s current CUDA stream, for a launch.

    The same value as ``torch.cuda.current_stream(device).cuda_stream``
    without building a Stream object, which costs some 4 us a call: the
    node-blocked frontier level, one launch pair per BFS level, is bound
    by its host time on small graphs.
    """
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)
