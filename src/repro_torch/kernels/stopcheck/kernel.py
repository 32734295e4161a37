"""Wrapper of the hand-written CUDA stop-check kernel (K3).

The kernel lives in ``csrc/stopcheck.cu`` (its source note says which
TPU kernel it replaces, what bounds it on the card and how the design
answers that bound).  :func:`stopcheck_fused` launches it on CUDA
tensors and returns the (2,) ``[max f, max g]`` on the device; on CPU
tensors it runs the plain version in ``ref.py``, and only because the
tensors lie on the CPU.  Each launch adds one to
``launch_counts["stopcheck"]``, a plain int kept apart from the frontier
kernels' counts.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import stopcheck_ref

__all__ = ["MAX_BLOCKS", "SOURCE", "STOPCHECK", "THREADS", "launch_counts",
           "library", "reset_launch_counts", "stopcheck_fused"]

STOPCHECK = "stopcheck"
SOURCE = Path(__file__).resolve().parent / "csrc" / "stopcheck.cu"
THREADS = 256            # kThreads in stopcheck.cu
MAX_BLOCKS = 132 * 8     # partial blocks: 8 resident per SM of an H100

launch_counts = {STOPCHECK: 0}


def reset_launch_counts() -> None:
    launch_counts[STOPCHECK] = 0


def _declare(lib) -> None:
    p = ctypes.c_void_p
    lib.stopcheck_launch.argtypes = [p, p, p, ctypes.c_longlong,
                                     ctypes.c_float, p, p, ctypes.c_int, p, p]
    lib.stopcheck_launch.restype = ctypes.c_int


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


def stopcheck_fused(counts, tau, log_inv_delta_l, log_inv_delta_u, omega):
    """``[max f, max g]`` (2,) float32 of the Bernstein bounds in one
    pass over the three streams: a grid-stride pass to per-block pairs,
    then a one-block finish (one count per call).  ``omega`` is best a
    device tensor: a host number is copied to the card first."""
    if not counts.is_cuda:
        return stopcheck_ref(counts, tau, log_inv_delta_l, log_inv_delta_u,
                             omega)
    n = counts.shape[0]
    streams = (counts, log_inv_delta_l, log_inv_delta_u)
    for t in streams:
        if t.dtype != torch.float32 or t.shape != (n,) \
                or not t.is_contiguous() or t.device != counts.device:
            raise ValueError("counts, ln(1/delta_L) and ln(1/delta_U) must "
                             "be contiguous (V,) float32 on one device")
    if n == 0:
        raise ValueError("the stop check needs at least one vertex")
    omega = torch.as_tensor(omega, dtype=torch.float32, device=counts.device)
    if omega.numel() != 1:
        raise ValueError(f"omega must be one value, got {tuple(omega.shape)}")
    omega = omega.contiguous()
    n_blocks = min(-(-n // THREADS), MAX_BLOCKS)
    partial = torch.empty(2 * n_blocks, dtype=torch.float32,
                          device=counts.device)
    out = torch.empty(2, dtype=torch.float32, device=counts.device)
    code = library().stopcheck_launch(
        counts.data_ptr(), log_inv_delta_l.data_ptr(),
        log_inv_delta_u.data_ptr(), n, _host_tau(tau), omega.data_ptr(),
        partial.data_ptr(), n_blocks, out.data_ptr(),
        torch.cuda.current_stream(counts.device).cuda_stream)
    _build.check(code, "stopcheck kernel launch")
    launch_counts[STOPCHECK] += 1
    return out
