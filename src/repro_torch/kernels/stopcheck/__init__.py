"""The fused stop check (K3: CUDA kernel, plain version, dispatcher) and
the stop-rule registry."""
from .kernel import (STOPCHECK, launch_counts, reset_launch_counts,
                     stopcheck_fused)
from .ops import get_stop_rule, register_stop_rule, stopcheck
from .ref import stopcheck_ref

__all__ = ["STOPCHECK", "get_stop_rule", "launch_counts",
           "register_stop_rule", "reset_launch_counts", "stopcheck",
           "stopcheck_fused", "stopcheck_ref"]
