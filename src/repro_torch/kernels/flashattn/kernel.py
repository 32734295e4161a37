"""Wrapper of the hand-written CUDA flash-attention kernel (K5).

The kernel lives in ``csrc/flashattn.cu`` (its source note says which
TPU kernel it replaces, what bounds it on the card and how the design
answers that bound).  It reads q (B, S, H, dh) and k, v (B, S, KV, dh)
in the model's layout through their strides, maps query head h to KV
head h // (H / KV), and writes a contiguous (B, S, H, dh) output.  The
bfloat16 route runs on ``wgmma`` and loads its tiles with TMA, whose
tensor maps the C entry point encodes with the driver's
``cuTensorMapEncodeTiled``: the library links ``libcuda``
(``EXTRA_FLAGS``).  The float32 route runs on the tensor cores too
(``mma.sync``): each operand is split into two TF32 halves and each
product taken as three TF32 products, which keeps the route within the
float32 tolerance, 3e-5, of the plain version.

With a sliding ``window`` (causal only) each query tile's KV loop
starts at the first tile holding a key of its window, and the tiles
where a row's window begins are masked: the same kernels, the same
arithmetic, fewer tiles.

:func:`flash_attention_cuda` launches it and raises on CPU tensors; the
dispatcher in ``ops.py`` sends those to the plain version.  Each launch
adds one to ``launch_counts["flash_attention"]``, or, with a window, to
``launch_counts["flash_attention_window"]``.  With ``return_lse`` the
kernel also writes each row's logsumexp, float32 (B, H, S) (its kLse
instantiation; the serving path asks for none).

:func:`flash_attention_bwd_cuda` is the backward (K5 bwd,
``csrc/flashattn_bwd.cu``, its own library): from q, k, v, the output,
its logsumexp and the output's gradient, one C call of three launches
(the row pass D = rowsum(dO * O), the dK/dV kernel, the dQ kernel) gives
dq, dk and dv in the inputs' types, dk and dv already summed over each
KV head's query heads.  Its bfloat16 route is wgmma + TMA like the
forward's, so it links ``libcuda`` too.  Each call adds one to
``launch_counts["flash_attention_bwd"]`` (or ``..._bwd_window``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _build
from .ref import check_window

__all__ = ["BWD_SOURCE", "EXTRA_FLAGS", "FLASHATTN", "FLASHATTN_BWD",
           "FLASHATTN_BWD_WINDOW", "FLASHATTN_WINDOW", "HEAD_DIMS", "SOURCE",
           "bwd_library", "check_inputs", "flash_attention_bwd_cuda",
           "flash_attention_cuda", "launch_counts", "library",
           "reset_launch_counts"]

FLASHATTN = "flash_attention"
FLASHATTN_WINDOW = "flash_attention_window"    # K5's sliding-window mode
FLASHATTN_BWD = "flash_attention_bwd"          # K5's backward
FLASHATTN_BWD_WINDOW = "flash_attention_bwd_window"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flashattn.cu"
BWD_SOURCE = SOURCE.with_name("flashattn_bwd.cu")
# head dims the kernel takes, by type: the float32 route is templated on
# dh (16 is every smoke config's); the bfloat16 route's 128-byte swizzle
# and wgmma shapes are written for 64 and 128 only
HEAD_DIMS = {torch.float32: (16, 64, 128), torch.bfloat16: (64, 128)}
# nvcc arguments of this source beyond the common ones: the driver API
EXTRA_FLAGS = ("-lcuda",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {FLASHATTN: 0, FLASHATTN_WINDOW: 0, FLASHATTN_BWD: 0,
                 FLASHATTN_BWD_WINDOW: 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _declare(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p] * 4 + [i64] * 12 + [i32] * 8 + [ctypes.c_float, p, p])
    lib.flash_attention_launch.restype = i32


def _declare_bwd(lib) -> None:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = (
        [p] * 10 + [i64] * 9 + [i32] * 8 + [ctypes.c_float, p])
    lib.flash_attention_bwd_launch.restype = i32


def library() -> ctypes.CDLL:
    """The built flash-attention library (compiled with nvcc on first
    use)."""
    return _build.load("flashattn", SOURCE, _declare, EXTRA_FLAGS)


def bwd_library() -> ctypes.CDLL:
    """The built backward library (``flashattn_bwd.cu``)."""
    return _build.load("flashattn_bwd", BWD_SOURCE, _declare_bwd,
                       EXTRA_FLAGS)


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


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         return_lse: bool = False):
    """(B, S, H, dh) attention of q over k, v (B, S, KV, dh), one kernel
    launch; contiguous output in ``q.dtype`` (and, with ``return_lse``,
    the float32 (B, H, S) row logsumexp).  ``window`` (causal only): row
    r sees keys r - window < k <= r."""
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda launches the CUDA kernel but "
                         "q lies on the CPU; call flash_attention")
    check_window(causal, window)
    check_inputs(q, k, v)
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if s == 0 or b == 0 or h == 0:
        return (out, lse) if return_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(i) for t in (q, k, v, out) for i in range(3)]
    code = library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *strides,
        b, s, h, k.shape[2], dh, _DTYPES[q.dtype], int(causal),
        0 if window is None else min(int(window), s), 1.0 / dh ** 0.5,
        stream, None if lse is None else lse.data_ptr())
    if code < 0:
        raise RuntimeError("flash_attention: the driver refused a TMA tensor "
                           f"map (CUresult {-code})")
    _build.check(code, "flash_attention kernel launch")
    launch_counts[FLASHATTN if window is None else FLASHATTN_WINDOW] += 1
    return (out, lse) if return_lse else out


def _aligned(t):
    """``t`` itself when contiguous on a 16-byte boundary, else a
    contiguous copy (a fresh allocation is aligned)."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 \
        else t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True,
                             window=None):
    """The backward of :func:`flash_attention_cuda`: q, out, dout (B, S,
    H, dh), k, v (B, S, KV, dh), lse (B, H, S) float32 -> (dq, dk, dv)
    in q's type, contiguous; one C call of three launches."""
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda launches the CUDA kernel "
                         "but q lies on the CPU; call flash_attention")
    check_window(causal, window)
    check_inputs(q, k, v)
    b, s, h, dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape \
            or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"out and dout must be q's shape {tuple(q.shape)} "
                         f"and type {q.dtype}, got {tuple(out.shape)} "
                         f"{out.dtype}, {tuple(dout.shape)} {dout.dtype}")
    if lse.shape != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 ({b}, {h}, {s}), got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("q, out, lse and dout must lie on one device")
    out, lse, dout = _aligned(out), _aligned(lse), _aligned(dout)
    dq = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, k.shape[2], dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if s == 0 or b == 0 or h == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    code = bwd_library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *strides, b, s, h, k.shape[2], dh,
        _DTYPES[q.dtype], int(causal),
        0 if window is None else min(int(window), s), 1.0 / dh ** 0.5,
        stream)
    if code < 0:
        raise RuntimeError("flash_attention_bwd: the driver refused a TMA "
                           f"tensor map (CUresult {-code})")
    _build.check(code, "flash_attention_bwd kernel launch")
    launch_counts[FLASHATTN_BWD if window is None
                  else FLASHATTN_BWD_WINDOW] += 1
    return dq, dk, dv
