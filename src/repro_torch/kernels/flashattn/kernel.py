"""Wrapper of the hand-written CUDA flash-attention kernel (K5).

The kernel lives in ``csrc/flashattn.cu`` (its source note says which
TPU kernel it replaces, what bounds it on the card and how the design
answers that bound).  It reads q (B, S, H, dh) and k, v (B, S, KV, dh)
in the model's layout through their strides, maps query head h to KV
head h // (H / KV), and writes a contiguous (B, S, H, dh) output.  The
bfloat16 route loads its tiles with TMA, whose tensor maps the C entry
point encodes with the driver's ``cuTensorMapEncodeTiled``: the library
links ``libcuda`` (``EXTRA_FLAGS``).

:func:`flash_attention_cuda` launches it and raises on CPU tensors; the
dispatcher in ``ops.py`` sends those to the plain version.  Each launch
adds one to ``launch_counts["flash_attention"]``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build

__all__ = ["EXTRA_FLAGS", "FLASHATTN", "HEAD_DIMS", "SOURCE", "check_inputs",
           "flash_attention_cuda", "launch_counts", "library",
           "reset_launch_counts"]

FLASHATTN = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flashattn.cu"
# head dims the kernel takes, by type: the float32 route is templated on
# dh (16 is every smoke config's); the bfloat16 route's 128-byte swizzle
# and wgmma shapes are written for 64 and 128 only
HEAD_DIMS = {torch.float32: (16, 64, 128), torch.bfloat16: (64, 128)}
# nvcc arguments of this source beyond the common ones: the driver API
EXTRA_FLAGS = ("-lcuda",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {FLASHATTN: 0}


def reset_launch_counts() -> None:
    launch_counts[FLASHATTN] = 0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i64] * 12 + [i32] * 7 + [ctypes.c_float, p])
    lib.flash_attention_launch.restype = i32


def library() -> ctypes.CDLL:
    """The built flash-attention library (compiled with nvcc on first
    use)."""
    return _build.load("flashattn", SOURCE, _declare, EXTRA_FLAGS)


def check_inputs(q, k, v) -> None:
    """Raise unless the kernel takes q, k and v (shapes, one type, a head
    dim of that type's, one device, 16-byte strides)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B, S, H, dh) and k, v one (B, S, KV, "
                         f"dh) shape, got {tuple(q.shape)}, {tuple(k.shape)}"
                         f", {tuple(v.shape)}")
    b, s, h, dh = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != dh \
            or h % k.shape[2] != 0:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one type, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {dh} is not one the {q.dtype} kernel "
                         f"takes: {HEAD_DIMS[q.dtype]}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    step = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 \
                or any(t.stride(i) % step for i in range(3)):
            raise ValueError(f"{name} needs a contiguous last axis, a "
                             "16-byte aligned start and strides of whole "
                             "16-byte chunks")


def flash_attention_cuda(q, k, v, *, causal: bool = True):
    """(B, S, H, dh) attention of q over k, v (B, S, KV, dh), one kernel
    launch; contiguous output in ``q.dtype``."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda launches the CUDA kernel but "
                         "q lies on the CPU; call flash_attention")
    check_inputs(q, k, v)
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    if s == 0 or b == 0 or h == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    code = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, s, h, k.shape[2], dh, _DTYPES[q.dtype], int(causal),
        1.0 / dh ** 0.5, stream)
    if code < 0:
        raise RuntimeError("flash_attention: the driver refused a TMA tensor "
                           f"map (CUresult {-code})")
    _build.check(code, "flash_attention kernel launch")
    launch_counts[FLASHATTN] += 1
    return out
