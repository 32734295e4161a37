"""Stop-rule registry of the estimator engine
(``repro.kernels.stopcheck.ops``).

A stop rule is ``fn(counts (V,), tau, params) -> (done, max_f, max_g)``,
evaluated on a consistent aggregated snapshot; estimators name theirs by
their ``stop_rule`` attribute.  ``"bernstein"`` is
:func:`repro_torch.core.kadabra.check_stop`, as in the JAX package,
whose engine calls it in place of the fused stop-check kernel.
"""
from __future__ import annotations

__all__ = ["get_stop_rule", "register_stop_rule"]

_STOP_RULES: dict = {}


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
