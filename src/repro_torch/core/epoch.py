"""Epoch length of the adaptive loop (``repro.core.epoch``)."""
from __future__ import annotations

__all__ = ["epoch_length"]


def epoch_length(n_devices: int, *, base: int = 1000,
                 exponent: float = 1.33, minimum: int = 1) -> int:
    """Samples per device per epoch: n0 = base / (P*T)^exponent, the
    paper's rule with one device as one thread; at least ``minimum``."""
    return max(minimum, round(base / (max(n_devices, 1) ** exponent)))
