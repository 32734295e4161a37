"""Optimizers of the port (``repro.optim``)."""
from .adamw import AdamWConfig, apply_updates, init_state

__all__ = ["AdamWConfig", "apply_updates", "init_state"]
