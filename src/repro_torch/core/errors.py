"""The failures an epoch's supervision hook raises, known to the engine
and to the runtime above it.

The runtime's fault harness (:mod:`repro_torch.runtime.faults`) raises
:class:`InjectedFault` and :class:`DeviceLoss`; its supervisor
(:mod:`repro_torch.runtime.supervisor`) raises :class:`InvariantViolation`
and :class:`EpochTimeoutError`.  They live here, below both, because the
engine must name them too: on the lanes of many processes the ranks
agree on a hook's outcome by a class's position in
:data:`HOOK_FAILURES` (``core/engine.py _agree_on_hook``), so that a rank
whose own hook passed raises the same class as the rank whose hook
failed.
"""
from __future__ import annotations

__all__ = ["InjectedFault", "DeviceLoss", "InvariantViolation",
           "EpochTimeoutError", "HOOK_FAILURES"]


class InjectedFault(RuntimeError):
    """A scheduled fault fired: as a process death, the current
    ``run_adaptive`` call is torn down and the supervisor retries from
    the last good checkpoint."""


class DeviceLoss(RuntimeError):
    """Part of the mesh is gone; ``survivors`` devices remain.  The
    supervisor answers with its ladder (re-partition onto the survivors,
    or a weaker lane)."""

    def __init__(self, survivors: int, message: str = ""):
        super().__init__(message or f"device loss: {survivors} survivors")
        self.survivors = int(survivors)


class InvariantViolation(RuntimeError):
    """The watchdog refused the lane state (a non-finite or negative
    count, or a falling tau): the epoch is rolled back."""


class EpochTimeoutError(RuntimeError):
    """An epoch took longer than ``epoch_timeout`` seconds: taken for a
    hung step (a stuck collective, a dead host) and retried."""


# The hook failures the ranks of a process lane tell each other by
# position in this tuple.
HOOK_FAILURES = (DeviceLoss, InjectedFault, InvariantViolation,
                 EpochTimeoutError)
