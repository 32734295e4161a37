"""Wrapper of the hand-written CUDA stop-check kernel (K3).

The kernel lives in ``csrc/stopcheck.cu`` (its source note says which
TPU kernel it replaces, what bounds it on the card and how the design
answers that bound).  :func:`stopcheck_fused` launches it on CUDA
tensors and returns the (2,) ``[max f, max g]`` on the device; on CPU
tensors it runs the plain version in ``ref.py``, and only because the
tensors lie on the CPU.  Each launch adds one to
``launch_counts["stopcheck"]``, a plain int kept apart from the frontier
kernels' counts.

A check is one launch: one wave of blocks, each writing its pair of
maxima to scratch, the last of them (by an atomic ticket) reducing the
pairs.  The scratch pairs and the ticket are allocated and zeroed once
per (device, stream) (:func:`_scratch`) and reused by every later check
on that stream; the kernel leaves the ticket at 0.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import stopcheck_ref

__all__ = ["SOURCE", "STOPCHECK", "THREADS", "launch_counts", "library",
           "reset_launch_counts", "stopcheck_fused"]

STOPCHECK = "stopcheck"
SOURCE = Path(__file__).resolve().parent / "csrc" / "stopcheck.cu"
THREADS = 1024           # kThreads in stopcheck.cu
# vertices a thread takes in one pass of the grid (one float4 a stream)
PER_THREAD = 4

launch_counts = {STOPCHECK: 0}

# (device index, stream handle) -> (partial pairs, ticket); device index
# -> blocks in one wave
_SCRATCH: dict = {}
_WAVE: dict = {}


def reset_launch_counts() -> None:
    launch_counts[STOPCHECK] = 0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stopcheck_launch.argtypes = [p, p, p, i64, i32, ctypes.c_float, p,
                                     p, p, i32, p, p]
    lib.stopcheck_launch.restype = i32
    lib.stopcheck_blocks_per_sm.argtypes = [p]
    lib.stopcheck_blocks_per_sm.restype = i32


def library() -> ctypes.CDLL:
    """The built stop-check library (compiled with nvcc on first use)."""
    return _build.load(STOPCHECK, SOURCE, _declare)


def _host_tau(tau) -> float:
    """tau as a host float; a CUDA tensor would cost a device sync."""
    if isinstance(tau, torch.Tensor):
        if tau.is_cuda:
            raise TypeError("tau must be a host number: reading a CUDA "
                            "tensor would sync the device")
        tau = tau.item()
    return float(tau)


def _wave(device) -> int:
    """Blocks of the kernel that ``device`` holds at once (SMs times the
    occupancy query), asked once per device."""
    if device.index not in _WAVE:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(library().stopcheck_blocks_per_sm(
                ctypes.byref(per_sm)), "stopcheck occupancy query")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _WAVE[device.index] = max(1, per_sm.value) * sms
    return _WAVE[device.index]


def _scratch(device, stream: int, n_blocks: int):
    """The (partial pairs, ticket) of ``stream`` on ``device``: 2 x
    ``n_blocks`` float32 and one zeroed int32, allocated on first use and
    kept; every check on that stream reuses them."""
    key = (device.index, stream)
    held = _SCRATCH.get(key)
    if held is None or held[0].shape[0] < 2 * n_blocks:
        held = (torch.empty(2 * n_blocks, dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device))
        _SCRATCH[key] = held
    return held


def _device_omega(omega, device):
    """omega as a one-element float32 tensor on ``device``: taken as it
    is when it already is one, else copied there."""
    if not (isinstance(omega, torch.Tensor) and omega.dtype == torch.float32
            and omega.device == device and omega.is_contiguous()):
        omega = torch.as_tensor(omega, dtype=torch.float32,
                                device=device).contiguous()
    if omega.numel() != 1:
        raise ValueError(f"omega must be one value, got {tuple(omega.shape)}")
    return omega


def stopcheck_fused(counts, tau, log_inv_delta_l, log_inv_delta_u, omega):
    """``[max f, max g]`` (2,) float32 of the Bernstein bounds in one
    launch (one count a call).  ``omega`` is best a one-element float32
    device tensor: a host number is copied to the card first."""
    if not counts.is_cuda:
        return stopcheck_ref(counts, tau, log_inv_delta_l, log_inv_delta_u,
                             omega)
    n = counts.shape[0]
    dev = counts.device
    streams = (counts, log_inv_delta_l, log_inv_delta_u)
    for t in streams:
        if t.dtype != torch.float32 or t.shape != (n,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError("counts, ln(1/delta_L) and ln(1/delta_U) must "
                             "be contiguous (V,) float32 on one device")
    if n == 0:
        raise ValueError("the stop check needs at least one vertex")
    omega = _device_omega(omega, dev)
    ptrs = [t.data_ptr() for t in streams]
    vec4 = not (ptrs[0] | ptrs[1] | ptrs[2]) % 16
    wave = _wave(dev)
    n_blocks = max(1, min(wave, -(-n // (THREADS * PER_THREAD))))
    stream = _build.raw_stream(dev)
    partial, ticket = _scratch(dev, stream, wave)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    code = library().stopcheck_launch(
        ptrs[0], ptrs[1], ptrs[2], n, int(vec4), _host_tau(tau),
        omega.data_ptr(), partial.data_ptr(), ticket.data_ptr(), n_blocks,
        out.data_ptr(), stream)
    _build.check(code, "stopcheck kernel launch")
    launch_counts[STOPCHECK] += 1
    return out
