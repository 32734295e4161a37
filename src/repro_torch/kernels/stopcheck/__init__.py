"""Stop-rule registry (the fused stop-check kernel is not ported yet)."""
from .ops import get_stop_rule, register_stop_rule

__all__ = ["get_stop_rule", "register_stop_rule"]
