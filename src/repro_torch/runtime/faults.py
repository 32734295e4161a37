"""Deterministic fault injection for the adaptive-sampling runtime
(``repro.runtime.faults``).

A long run over many processes dies in a few known ways: a process or a
card drops out of the group (the paper's 16-node cluster loses a node),
a checkpoint is torn or bit-rotted on disk, a card computes NaNs into a
frame, a collective hangs.  This module turns each of them into a
seeded, replayable event, so that the supervisor
(:mod:`repro_torch.runtime.supervisor`) meets the same failures in the
same order on every run.

The fault kinds (the registry's keys):

  ``kill``      a process death mid-epoch: raises :class:`InjectedFault`;
                the run resumes from its last good checkpoint.
  ``shrink``    ``survivors`` devices (shards, ranks) remain: raises
                :class:`DeviceLoss`; the supervisor re-partitions onto
                the survivors or drops a rung of its ladder.
  ``corrupt``   flips bytes of the newest published step's first leaf,
                then kills: the restore must find the damage (the
                leaves' CRCs), quarantine the step and fall back.
  ``truncate``  cuts the newest step's ``manifest.json`` in half, then
                kills: the tear a power loss mid-write leaves.
  ``nan``       returns the state with its in-flight frame poisoned
                (NaN, Inf): the supervisor's watchdog must refuse it
                before the epoch reaches a snapshot or the disk.
  ``hang``      sleeps ``delay`` seconds in the epoch hook: the
                supervisor's ``epoch_timeout`` must flag the overrun.

Faults fire once: a schedule's entry fires at its epoch on the first
attempt that reaches it and never again, so a retried run replays the
rest of the run as it was, bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.errors import DeviceLoss, InjectedFault

__all__ = ["InjectedFault", "DeviceLoss", "FaultSpec", "FaultSchedule",
           "FaultContext", "available_faults", "apply_fault",
           "corrupt_newest_step", "truncate_newest_manifest",
           "poison_state"]


@dataclasses.dataclass(frozen=True)
class FaultContext:
    """What a firing fault may touch: the run's checkpoint directory
    (None: no disk fault lands, as on a rank that writes no step) and
    the current device count (the default of ``shrink``)."""
    checkpoint_root: Optional[str] = None
    n_devices: int = 1


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: ``kind`` (a registry key), the 1-based
    ``epoch`` it fires at (the engine's epoch count), and the kind's
    parameters (``survivors`` for shrink, ``delay`` seconds for
    hang)."""
    kind: str
    epoch: int
    survivors: Optional[int] = None
    delay: float = 0.0

    def __post_init__(self):
        if self.kind not in _FAULTS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(registered: {available_faults()})")


# ---------------------------------------------------------------------------
# Disk faults, on the port's store layout
# ---------------------------------------------------------------------------

def _newest_step_dir(root: Optional[str]) -> Optional[str]:
    from ..checkpoint.store import latest_step
    if not root or not os.path.isdir(root):
        return None
    s = latest_step(root)
    return None if s is None else os.path.join(root, f"step_{s:08d}")


def corrupt_newest_step(root: Optional[str]) -> Optional[str]:
    """Flip 8 bytes in the middle of the newest published step's first
    leaf file (``arr_000000.npy``): bit rot or a torn write.  Returns
    the damaged path, or None when there is no step to damage."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    path = os.path.join(d, "arr_000000.npy")
    if not os.path.exists(path):
        return None
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        chunk = f.read(8)
        f.seek(size // 2)
        f.write(bytes(b ^ 0xFF for b in chunk) or b"\xff")
    return path


def truncate_newest_manifest(root: Optional[str]) -> Optional[str]:
    """Cut the newest step's ``manifest.json`` in half.  Returns the
    torn path (None when there is no step)."""
    d = _newest_step_dir(root)
    if d is None:
        return None
    path = os.path.join(d, "manifest.json")
    if not os.path.exists(path):
        return None
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))
    return path


def poison_state(state) -> tuple:
    """``state`` with a copy of its in-flight frame (leaf 2) whose first
    two entries are NaN and Inf: what a faulting card writes.  The other
    leaves are the same objects.  Nothing is written in place: the
    single lane's first state holds one zero tensor as its aggregate,
    frame and surplus, and an in-place NaN would reach the aggregate and
    the next checkpoint."""
    state = list(state)
    fc = state[2]
    if isinstance(fc, torch.Tensor):
        fc = fc.clone()
    else:
        fc = np.array(fc, dtype=np.float32, copy=True)
    flat = fc.reshape(-1)
    flat[0] = float("nan")
    if flat.shape[0] > 1:
        flat[1] = float("inf")
    state[2] = fc
    return tuple(state)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def _fire_kill(spec: FaultSpec, ctx: FaultContext, state):
    raise InjectedFault(f"injected process kill at epoch {spec.epoch}")


def _fire_shrink(spec: FaultSpec, ctx: FaultContext, state):
    survivors = (spec.survivors if spec.survivors is not None
                 else max(1, ctx.n_devices // 2))
    raise DeviceLoss(survivors, f"injected device loss at epoch "
                                f"{spec.epoch}: {ctx.n_devices} -> "
                                f"{survivors}")


def _fire_corrupt(spec: FaultSpec, ctx: FaultContext, state):
    hit = corrupt_newest_step(ctx.checkpoint_root)
    raise InjectedFault(f"injected checkpoint corruption at epoch "
                        f"{spec.epoch} ({hit or 'no step on disk here'}), "
                        "then kill")


def _fire_truncate(spec: FaultSpec, ctx: FaultContext, state):
    hit = truncate_newest_manifest(ctx.checkpoint_root)
    raise InjectedFault(f"injected torn manifest at epoch {spec.epoch} "
                        f"({hit or 'no step on disk here'}), then kill")


def _fire_nan(spec: FaultSpec, ctx: FaultContext, state):
    return poison_state(state)


def _fire_hang(spec: FaultSpec, ctx: FaultContext, state):
    time.sleep(float(spec.delay))
    return state


_FAULTS = {
    "kill": _fire_kill,
    "shrink": _fire_shrink,
    "corrupt": _fire_corrupt,
    "truncate": _fire_truncate,
    "nan": _fire_nan,
    "hang": _fire_hang,
}


def available_faults() -> tuple:
    """The registered fault kinds, sorted."""
    return tuple(sorted(_FAULTS))


def apply_fault(spec: FaultSpec, ctx: FaultContext, state):
    """Fire one fault against the current engine state: the process and
    disk faults raise (:class:`InjectedFault`, :class:`DeviceLoss`); the
    state faults (``nan``, ``hang``) return the state, replaced or
    not."""
    return _FAULTS[spec.kind](spec, ctx, state)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

class FaultSchedule:
    """An ordered set of one-shot :class:`FaultSpec`.

    ``take(epoch)`` returns the specs at ``epoch`` not fired yet and
    marks them fired, so a retried run that passes the epoch again does
    not trip the same fault; ``exhausted`` says whether every spec
    fired; ``reset()`` re-arms them all.  :meth:`from_seed` draws a
    schedule from a seed, the JAX package's for the same arguments."""

    def __init__(self, specs):
        self.specs = tuple(specs)
        self._fired = [False] * len(self.specs)

    def __len__(self):
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def take(self, epoch: int) -> list:
        out = []
        for i, spec in enumerate(self.specs):
            if not self._fired[i] and spec.epoch == epoch:
                self._fired[i] = True
                out.append(spec)
        return out

    @property
    def exhausted(self) -> bool:
        return all(self._fired)

    def reset(self):
        self._fired = [False] * len(self.specs)

    @classmethod
    def from_seed(cls, seed: int, *, kinds=None, n_faults: int = 4,
                  max_epoch: int = 8, survivors: Optional[int] = None,
                  hang_delay: float = 0.05) -> "FaultSchedule":
        """``n_faults`` draws of (kind, epoch) from ``kinds`` (default:
        every registered kind) over epochs ``[1, max_epoch]``, from
        ``np.random.default_rng(seed)``, ordered by epoch (stable)."""
        rng = np.random.default_rng(seed)
        kinds = tuple(kinds) if kinds is not None else available_faults()
        for k in kinds:
            if k not in _FAULTS:
                raise ValueError(f"unknown fault kind {k!r}")
        specs = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            epoch = int(rng.integers(1, max_epoch + 1))
            specs.append(FaultSpec(kind, epoch, survivors=survivors,
                                   delay=hang_delay))
        specs.sort(key=lambda s: s.epoch)
        return cls(specs)
