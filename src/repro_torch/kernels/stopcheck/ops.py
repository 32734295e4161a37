"""Dispatch of the fused stop check, and the stop-rule registry of the
estimator engine (``repro.kernels.stopcheck.ops``).

:func:`stopcheck` routes ``[max f, max g]`` to the CUDA kernel K3 for a
CUDA tensor and to the plain version for a CPU tensor, as the JAX
``stopcheck(..., use_pallas=)`` selects its backend.  A forced route
that cannot be honoured raises: the kernel on a CPU tensor, or the plain
version on a CUDA tensor.  Nothing falls back quietly.

A stop rule is ``fn(counts (V,), tau, params) -> (done, max_f, max_g)``,
evaluated on a consistent aggregated snapshot; estimators name theirs by
their ``stop_rule`` attribute.  ``"bernstein"`` is
:func:`repro_torch.core.kadabra.check_stop`, as in the JAX package.
Departure from the JAX engine, which evaluates that rule with XLA: the
port's ``check_stop`` takes its maxima from :func:`stopcheck`, so on the
card every stop check of every estimator runs K3.
"""
from __future__ import annotations

from .kernel import stopcheck_fused
from .ref import stopcheck_ref

__all__ = ["get_stop_rule", "register_stop_rule", "stopcheck"]

_STOP_RULES: dict = {}


def stopcheck(counts, tau, log_inv_delta_l, log_inv_delta_u, omega, *,
              use_kernel=None):
    """``[max f, max g]`` (2,) float32.  ``use_kernel=None`` routes by
    device; ``True`` forces K3 and ``False`` the plain version."""
    cuda = counts.is_cuda
    if use_kernel is None:
        use_kernel = cuda
    if use_kernel and not cuda:
        raise ValueError("the stop-check kernel is a CUDA kernel but counts "
                         "lie on the CPU; use use_kernel=None or False")
    if not use_kernel and cuda:
        raise ValueError("the plain stop check runs only on CPU tensors; "
                         "a CUDA tensor goes through the kernel")
    fn = stopcheck_fused if use_kernel else stopcheck_ref
    return fn(counts, tau, log_inv_delta_l, log_inv_delta_u, omega)


def register_stop_rule(name: str, fn) -> None:
    """Register ``fn`` under ``name``; a different callable under a taken
    name is an error."""
    prev = _STOP_RULES.get(name)
    if prev is not None and prev is not fn:
        raise ValueError(f"stop rule {name!r} already registered")
    _STOP_RULES[name] = fn


def get_stop_rule(name: str):
    try:
        return _STOP_RULES[name]
    except KeyError:
        raise KeyError(f"no stop rule {name!r} registered "
                       f"(have: {sorted(_STOP_RULES)})") from None


def _register_builtin():
    from ...core.kadabra import check_stop
    register_stop_rule("bernstein", check_stop)


_register_builtin()
