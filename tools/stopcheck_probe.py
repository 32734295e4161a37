"""Where the stop-check kernel's (K3) device time goes, at V = 2^20.

Times one check, device time a launch (200 launches captured in one CUDA
graph and replayed, so no host time is counted), for variants of the
committed source (``src/repro_torch/kernels/stopcheck/csrc/stopcheck.cu``)
made by text edits:

* ``as built``, and the same with the grid cut to a half or a quarter
  of one wave (more vertices a thread);
* ``512 threads`` / ``256 threads`` a block (1,024 as built);
* ``acq_rel fences``: both ``__threadfence()`` (a sequentially
  consistent fence) replaced by ``fence.acq_rel.gpu``;
* ``a reader fence``: a ``__threadfence()`` in the last block before it
  reads the pairs;
* ``full occupancy``: ``__launch_bounds__(kThreads, 2)``, two blocks of
  1,024 threads an SM (32 registers a thread);
* ``no finish``: the blocks write their pairs and stop (no ticket, no
  last-block reduction): prices the finish;
* ``loads only``: f and g replaced by a max of the raw inputs: prices
  the arithmetic (six IEEE divisions and two square roots a vertex).

Then the wrapper a call, CUDA events over 1,000 back-to-back calls
(host and device time both), before any profiler session.  Every
variant but ``loads only`` is held bitwise against the plain version.
Needs a CUDA card and nvcc:

    PYTHONPATH=src python tools/stopcheck_probe.py
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.stopcheck import kernel as sk  # noqa: E402
from repro_torch.kernels.stopcheck import stopcheck_ref  # noqa: E402

V = 1 << 20
TAU = 17_408
ARITHMETIC = re.compile(r"  const float tiny = .*?(?=  mf = max_nan\(mf, f\);)",
                        re.S)
ACQ_REL = 'asm volatile("fence.acq_rel.gpu;" ::: "memory");'
FINISH = ("  block_max_store(mf, mg, partial + 2 * blockIdx.x);\n",
          "  block_max_store(mf, mg, partial + 2 * blockIdx.x);\n  return;\n")

VARIANTS = {
    "as built": ((), 1),
    "as built, half a wave": ((), 2),
    "as built, a quarter wave": ((), 4),
    "512 threads": ((("kThreads = 1024", "kThreads = 512"),), 1),
    "256 threads": ((("kThreads = 1024", "kThreads = 256"),), 1),
    "acq_rel fences": ((("__threadfence();", ACQ_REL),), 1),
    "a reader fence": ((("  mf = -INFINITY;\n  mg = -INFINITY;\n  for",
                         "  __threadfence();\n  mf = -INFINITY;\n"
                         "  mg = -INFINITY;\n  for"),), 1),
    "full occupancy": ((("__launch_bounds__(kThreads)\nstopcheck_kernel",
                         "__launch_bounds__(kThreads, 2)\nstopcheck_kernel"),),
                       1),
    "no finish": ((FINISH,), 1),
    "loads only": ((("ARITHMETIC", "  const float f = count + lil;\n"
                                   "  const float g = liu;\n"),), 1),
}


def variant_library(name: str, edits) -> ctypes.CDLL:
    text = sk.SOURCE.read_text()
    for old, new in edits:
        if old == "ARITHMETIC":
            text, count = ARITHMETIC.subn(new, text)
        else:
            count = text.count(old)
            text = text.replace(old, new)
        if count < 1:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
    stem = "stopcheck_probe_" + re.sub(r"\W+", "_", name)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{stem}.cu"
    path.write_text(text)
    return _build.load(stem, path, sk._declare)


def launcher(lib, args, shrink: int):
    """A function that launches ``lib``'s kernel once on ``args``, with
    the grid of one wave divided by ``shrink``, and the output it
    writes."""
    counts, tau, lil, liu, omega = args
    per_sm = ctypes.c_int(0)
    _build.check(lib.stopcheck_blocks_per_sm(ctypes.byref(per_sm)), "query")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_blocks = max(1, per_sm.value * sms // shrink)
    partial = torch.empty(2 * n_blocks, device="cuda")
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = torch.empty(2, device="cuda")

    def launch():
        _build.check(lib.stopcheck_launch(
            counts.data_ptr(), lil.data_ptr(), liu.data_ptr(), V, 1,
            float(tau), omega.data_ptr(), partial.data_ptr(),
            ticket.data_ptr(), n_blocks, out.data_ptr(),
            _build.raw_stream(counts.device)), "probe launch")
    return launch, out, n_blocks, per_sm.value


def graph_us(launch, calls: int = 200) -> float:
    """Device time a launch: ``calls`` launches in one CUDA graph."""
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        launch()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls * 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = torch.randint(0, 400, (V,), generator=gen, device="cuda").float()
    lil = torch.rand(V, generator=gen, device="cuda") * 20 + 1e-3
    liu = torch.rand(V, generator=gen, device="cuda") * 20 + 1e-3
    omega = torch.tensor(29978.7, device="cuda")
    args = (counts, TAU, lil, liu, omega)
    want = stopcheck_ref(*args)

    # the wrapper a call first: a profiler session would slow later calls
    for _ in range(10):
        sk.stopcheck_fused(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(1000):
        sk.stopcheck_fused(*args)
    stop.record()
    torch.cuda.synchronize()
    print(f"wrapper a call (1,000 back to back, host and device): "
          f"{start.elapsed_time(stop):.3f} us; bound "
          f"{12 * V / 3.35e12 * 1e6:.3f} us (bytes)", flush=True)
    for name, (edits, shrink) in VARIANTS.items():
        lib = variant_library(name, edits)
        launch, out, n_blocks, per_sm = launcher(lib, args, shrink)
        launch()
        torch.cuda.synchronize()
        same = torch.equal(out, want)
        us = graph_us(launch)
        check = ("" if name in ("loads only", "no finish") else
                 "; bitwise equal to the plain version" if same
                 else "; DIFFERS")
        print(f"  {name:26s} {us:7.3f} us a launch ({n_blocks} blocks, "
              f"{per_sm} an SM){check}", flush=True)


if __name__ == "__main__":
    main()
