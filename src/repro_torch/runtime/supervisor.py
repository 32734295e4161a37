"""The resilience layer: drive ``run_adaptive`` through faults
(``repro.runtime.supervisor``).

KADABRA's aggregate after any epoch is a valid intermediate state, and
the engine already publishes it atomically with the generator's state
taken after the epoch's draws (``_EngineCheckpointer`` and its lane
twins), so a resumed run continues the uninterrupted one bit for bit.
:class:`ResilientRunner` is the loop around that loop:

  * **bounded retry** with exponential backoff and seeded jitter: a
    failed ``run_adaptive`` call (injected or real) is re-entered from
    the last good checkpoint, up to ``RetryPolicy.max_retries`` times a
    rung of the ladder;
  * **the watchdog**: after every epoch (the engine's ``on_epoch``
    hook) the lane state is checked (finite counts, none negative, the
    aggregate's tau never falling); a violation raises before the epoch
    is saved, so the retry resumes from the last good step;
  * **the degradation ladder**: a device loss re-partitions onto the
    survivors (a sharded lane stays sharded, smaller); a rung that
    exhausts its retries drops a lane, sharded -> SPMD -> single, and
    only the single lane exhausting its own raises
    :class:`ResilienceExhausted`.

The lanes of the port's ladder: ``ShardMesh(S)`` in one process shrinks
to ``ShardMesh(survivors)`` on ``repartition`` and degrades to the single
lane (a one-process world has no SPMD rung: a ``SamplerMesh`` of one
rank is the single lane).  ``GroupShardMesh`` over W processes shrinks to
the subgroup of ranks ``[0, survivors)`` (every rank calls
``dist.new_group``; a rank at or above ``survivors`` is the lost device
and re-raises its :class:`DeviceLoss`), degrades to ``SamplerMesh`` over
its group and then to the single lane on every rank.  A ``SamplerMesh``
shrinks to one over the survivors and degrades to the single lane.
Every rank runs its own runner with the same arguments and schedule;
the engine makes the ranks agree on each epoch's hook, so they fail,
retry, shrink and degrade together.

A sample is never counted twice across a rung change: the migrated step
keeps the aggregate and the frozen snapshots (only whole epochs ever
enter them) and drops the in-flight frame and surplus, whose draws were
never counted; and no generator replays a draw already aggregated, nor
the draws of the calibration that set the new rung's parameters
(:func:`elastic_migrate_state`).  Recovery on the same lane (kill,
corruption, a poisoned frame, a hang) is bitwise the uninterrupted run;
a lane change re-calibrates on the new lane, so its result holds to the
same (eps, delta) guarantee, not to the same bits.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint.store import CheckpointError, restore_arrays
from ..checkpoint.store import save as checkpoint_save
from ..core.distributed import SamplerMesh
from ..core.engine import (AdaptiveRunResult, lane_state_shapes,
                           resolve_estimators, resolve_stream, run_adaptive)
from ..core.errors import (DeviceLoss, EpochTimeoutError, InjectedFault,
                           InvariantViolation)
from ..core.epoch import frame_schema_id
from ..core.partition import (PartitionedGraph, gather_graph,
                              partition_graph, repartition)
from ..core.shards import GroupShardMesh, ShardMesh
from ..device import DEFAULT_DEVICE, resolve_device
from .faults import FaultContext, FaultSchedule, apply_fault
from .telemetry import resolve_telemetry

__all__ = ["ResilientRunner", "ResilientRunResult", "RetryPolicy",
           "RunEvent", "InvariantViolation", "EpochTimeoutError",
           "ResilienceExhausted", "check_state_invariants",
           "elastic_migrate_state", "migration_generator", "LANE_LADDER"]

# The degradation ladder, strongest lane first: "sharded" is the
# cooperative vertex-sharded lane (a PartitionedGraph on a ShardMesh or
# GroupShardMesh), "spmd" the independent samplers of a SamplerMesh,
# "single" one device.
LANE_LADDER = ("sharded", "spmd", "single")


class ResilienceExhausted(RuntimeError):
    """Every rung of the ladder exhausted its retry budget."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and jitter:
    ``sleep(attempt) = min(cap, base * factor**(attempt-1)) * (1 + U *
    jitter)``, U ~ Uniform[0, 1) from the runner's seeded generator."""
    max_retries: int = 4
    backoff_base: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap: float = 2.0
    jitter: float = 0.25

    def sleep_seconds(self, attempt: int, u: float) -> float:
        base = min(self.backoff_cap, self.backoff_base
                   * self.backoff_factor ** max(0, attempt - 1))
        return base * (1.0 + float(u) * self.jitter)


class RunEvent(NamedTuple):
    """One entry of the runner's event log."""
    kind: str       # fault | failure | retry | shrink | degrade | migrate
    epoch: int      # engine epoch the event belongs to (0 = outside one)
    attempt: int    # failures seen at the current rung when it happened
    detail: str
    t: float = 0.0  # time.monotonic() when recorded


class ResilientRunResult(NamedTuple):
    result: AdaptiveRunResult   # the completing run's result
    events: tuple               # RunEvent log, in order
    attempts: int               # failed run_adaptive calls in all
    lane: str                   # the lane that completed the run
    n_devices: int              # its device (shard, rank) count


# ---------------------------------------------------------------------------
# The watchdog and the state migration
# ---------------------------------------------------------------------------

_STATE_NAMES = ("agg_counts", "agg_tau", "frame_counts", "frame_tau",
                "surplus_counts", "surplus_tau")


def _bad_and_min(x) -> tuple:
    """(whether ``x`` holds a non-finite value, its minimum), with one
    read from the device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.numel() == 0:
        return False, 0.0
    t = t.float()
    bad, low = torch.stack([(~torch.isfinite(t)).any().float(),
                            t.min()]).tolist()
    return bool(bad), low


def check_state_invariants(state, last_tau: Optional[int] = None) -> int:
    """Check one lane state ``(agg_c, agg_t, frame_c, frame_t, sur_c,
    sur_t)`` (tensors or numpy arrays; the taus ints or 0-d arrays) and
    return the aggregate's tau.  Every count finite and none negative,
    every tau non-negative, and the aggregate's tau not below
    ``last_tau``; else :class:`InvariantViolation` naming the leaf."""
    counts = {name: _bad_and_min(x)
              for name, x in zip(_STATE_NAMES[0::2], state[0::2])}
    for name in _STATE_NAMES:
        if name in counts and counts[name][0]:
            raise InvariantViolation(
                f"non-finite values in {name} (NaN/Inf-poisoned frame?)")
    for name, (_bad, low) in counts.items():
        if low < 0:
            raise InvariantViolation(f"negative entries in {name} (min "
                                     f"{low})")
    taus = [int(x) for x in state[1::2]]
    for name, tau in zip(_STATE_NAMES[1::2], taus):
        if tau < 0:
            raise InvariantViolation(f"negative sample counter {name}")
    if last_tau is not None and taus[0] < last_tau:
        raise InvariantViolation(
            f"aggregated tau went backwards: {taus[0]} < {last_tau}")
    return taus[0]


def migration_generator(seed: int, rank: int, rung: int,
                        device) -> torch.Generator:
    """The stream of an SPMD rank that a migration gives no generator row
    of its own: a child (spawn key ``rung``) of the rank's
    :func:`~repro_torch.core.distributed.sampler_generator` seed
    sequence.  The lane's calibration draws from that parent stream
    itself, and no earlier lane drew from the child, so the rung's
    epochs draw samples independent of both the calibration sample that
    picked their parameters (KADABRA's guarantee needs it) and the
    aggregate."""
    state = np.random.SeedSequence(
        [int(seed), int(rank)], spawn_key=(int(rung),)).generate_state(
            1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


def elastic_migrate_state(arrays, *, n_channels: int, v1: int,
                          lane_new: str, n_dev_new: int, seed: int = 0,
                          rung: int = 0, device="cpu") -> tuple:
    """The engine's 10 checkpoint leaves (host arrays, as
    :func:`~repro_torch.checkpoint.restore_arrays` gives them) refitted
    onto ``lane_new`` with ``n_dev_new`` devices: the counts to that
    lane's shapes (:func:`~repro_torch.core.engine.lane_state_shapes`;
    SPMD frames and surpluses stacked over its ranks), in the engine's
    leaf order.

    Kept: the aggregate and its tau, the frozen snapshots, their taus
    and the stop epochs (rows at or past V+1 are zero, so refitting them
    loses nothing).  Dropped: the in-flight frame and surplus, zeroed,
    whose draws were never counted.  The generator state goes on where
    the draws went on: a lane of one generator continues the old one
    (the old SPMD mesh's rank 0 stream); an SPMD rank continues its own
    row of an old SPMD step, and a rank with no row starts its
    :func:`migration_generator` stream for ``seed`` and rung ``rung`` on
    ``device``, which neither the new lane's calibration nor any earlier
    lane drew from.  (Where the old lane too drew from one generator, the
    new lane calibrates again from the start of the stream it continues,
    with no more samples than the old lane's calibration drew there: the
    ladder only ever lowers the shard count that calibration scales
    with, so the new calibration stays short of the aggregated draws.)"""
    (agg_c, agg_t, _fr_c, _fr_t, _sur_c, _sur_t,
     fro_c, fro_t, stop_e, gen) = arrays
    n_sam = n_dev_new if lane_new == "spmd" else 1
    agg_shape, frame_shape, sur_shape = lane_state_shapes(
        n_channels, v1 - 1, n_sam)

    def refit(a):
        out = np.zeros(agg_shape, np.float32)
        a = np.asarray(a, np.float32).reshape(n_channels, -1)
        m = min(a.shape[1], agg_shape[1])
        out[:, :m] = a[:, :m]
        return out

    gen = np.asarray(gen, np.uint8)
    if lane_new == "spmd":
        frame = np.zeros((n_sam, *frame_shape), np.float32)
        surplus = np.zeros((n_sam, *sur_shape), np.float32)
        gen_new = np.stack([
            gen[r] if gen.ndim == 2 and r < gen.shape[0]
            else migration_generator(seed, r, rung, device).get_state()
            .numpy() for r in range(n_sam)])
    else:
        frame = np.zeros(frame_shape, np.float32)
        surplus = np.zeros(sur_shape, np.float32)
        gen_new = gen if gen.ndim == 1 else gen[0]
    zero = np.int64(0)
    return (refit(agg_c), np.int64(agg_t), frame, zero, surplus, zero,
            refit(fro_c), np.asarray(fro_t, np.int64),
            np.asarray(stop_e, np.int64), gen_new)


def _broadcast_step(mesh, step: int) -> int:
    """Rank 0's ``step`` on every rank of the process ``mesh``."""
    t = torch.tensor([int(step)], dtype=torch.int64, device=mesh.comm_device)
    dist.broadcast(t, src=mesh.root, group=mesh.group)
    return int(t[0])


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

class ResilientRunner:
    """Run :func:`repro_torch.core.engine.run_adaptive` to its end
    through faults (see the module docstring).

    The run's arguments are ``run_adaptive``'s (``graph`` a ``Graph``,
    or a ``PartitionedGraph`` with its shard mesh; ``seed`` the run's
    seed), plus:

    ``checkpoint_dir``
        required: recovery rolls back to the last good step.  Rung ``k``
        of the ladder writes under ``<checkpoint_dir>/rung<k>``, rank 0
        alone on a lane of many processes; on the single lane that the
        ranks of such a lane end on, rank ``r > 0`` keeps its own steps
        under ``rung<k>-rank<r>``.
    ``schedule``
        a :class:`~repro_torch.runtime.faults.FaultSchedule` fired at
        epoch ends (every rank reads the same one); None runs clean but
        still supervises real failures.
    ``policy`` / ``epoch_timeout`` / ``watchdog`` / ``retry_seed``
        the retry policy; the hung-epoch threshold in seconds between
        two arrivals at the hook (the first epoch of each attempt is
        exempt: it absorbs phases 1-2 and any kernel build); the
        watchdog's switch; the seed of the backoff's jitter.
    ``telemetry``
        a bus, JSONL path or sink, handed to every attempt and to the
        store; each :class:`RunEvent` is also emitted on it as
        ``supervisor.<kind>``.
    """

    def __init__(self, graph, metrics=("betweenness",), *,
                 checkpoint_dir: str, mesh=None, device=None,
                 eps: Optional[float] = None, delta: Optional[float] = None,
                 seed: int = 0, config=None, stream: Optional[str] = None,
                 checkpoint_every: int = 1,
                 schedule: Optional[FaultSchedule] = None,
                 policy: Optional[RetryPolicy] = None,
                 epoch_timeout: Optional[float] = None,
                 watchdog: bool = True, retry_seed: int = 0,
                 telemetry=None):
        if not checkpoint_dir:
            raise ValueError("ResilientRunner needs checkpoint_dir: "
                             "recovery is a rollback to the last good "
                             "checkpoint")
        self.metrics = metrics
        self.eps, self.delta, self.seed = eps, delta, int(seed)
        self.config = config
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.schedule = schedule
        self.policy = policy if policy is not None else RetryPolicy()
        self.epoch_timeout = epoch_timeout
        self.watchdog = watchdog
        self._rng = np.random.default_rng(retry_seed)
        self.telemetry = resolve_telemetry(telemetry)

        self._graph, self._mesh = graph, mesh
        self._base_graph = None
        self._proc_rank = 0
        if isinstance(graph, PartitionedGraph):
            if not isinstance(mesh, (ShardMesh, GroupShardMesh)):
                raise ValueError("a PartitionedGraph needs its shard mesh")
            self._lane, self._n_dev = "sharded", mesh.n_shards
            if isinstance(mesh, GroupShardMesh):
                self._proc_rank = mesh.rank
        elif isinstance(mesh, SamplerMesh) and mesh.size > 1:
            self._lane, self._n_dev = "spmd", mesh.size
            self._proc_rank = mesh.rank
            self._base_graph = graph
        else:
            self._lane, self._n_dev = "single", 1
            self._base_graph = graph
        self._device = (mesh.device if mesh is not None else resolve_device(
            DEFAULT_DEVICE if device is None else device))
        if self._lane == "single":
            self._mesh = None
        self._ests = resolve_estimators(metrics)
        self._stream = resolve_stream(self._ests, stream, graph)
        self._C = sum(e.n_channels for e in self._ests)
        self._v1 = int(graph.n_nodes) + 1

        self._rung = 0
        self._attempt = 0
        self._events: list = []
        self._total_failures = 0
        self._last_tau: Optional[int] = None
        self._epoch_clock: Optional[float] = None

    # -- lane geometry ----------------------------------------------------

    def _rung_dir(self) -> str:
        d = os.path.join(self.checkpoint_dir, f"rung{self._rung}")
        if self._lane == "single" and self._proc_rank > 0:
            d += f"-rank{self._proc_rank}"
        return d

    def _writes_steps(self) -> bool:
        """Whether this process writes (and damages) its rung's steps."""
        return self._lane == "single" or self._proc_rank == 0

    def _schema(self) -> str:
        lane = (self._lane if self._lane == "single"
                else f"{self._lane}{self._n_dev}")
        return frame_schema_id(self._ests, lane=lane,
                               generator=self._device.type,
                               stream=self._stream)

    def _process_mesh(self):
        return (self._mesh if isinstance(self._mesh, (SamplerMesh,
                                                      GroupShardMesh))
                else None)

    def _base(self):
        if self._base_graph is None:
            self._base_graph = gather_graph(self._graph)
        return self._base_graph

    def _record(self, kind: str, epoch: int, attempt: int, detail: str):
        self._events.append(RunEvent(kind, epoch, attempt, detail,
                                     time.monotonic()))
        self.telemetry.emit("supervisor." + kind, epoch=epoch,
                            attempt=attempt, detail=detail)

    # -- the per-epoch hook -----------------------------------------------

    def _on_epoch(self, epoch: int, state):
        new_state = state
        if self.schedule is not None:
            ctx = FaultContext(
                checkpoint_root=(self._rung_dir() if self._writes_steps()
                                 else None),
                n_devices=self._n_dev)
            for spec in self.schedule.take(epoch):
                self._record("fault", epoch, self._attempt,
                             f"{spec.kind} injected")
                new_state = apply_fault(spec, ctx, new_state)
        now = time.monotonic()
        if (self.epoch_timeout is not None and self._epoch_clock is not None
                and now - self._epoch_clock > self.epoch_timeout):
            raise EpochTimeoutError(
                f"epoch {epoch} took {now - self._epoch_clock:.3f}s (> "
                f"epoch_timeout={self.epoch_timeout}s): taken for a hung "
                "step")
        self._epoch_clock = now
        if self.watchdog:
            self._last_tau = check_state_invariants(new_state,
                                                    self._last_tau)
        return new_state if new_state is not state else None

    # -- recovery transitions ---------------------------------------------

    def _read_old_step(self, old_dir: str, old_schema: str, sync):
        """(arrays, step, metadata) of the old rung's newest good step, or
        None.  With a process ``sync`` mesh its rank 0 reads (and
        quarantines) and broadcasts the step, which the others read."""
        arrays, step, meta = None, -1, None
        if sync is None or sync.rank == 0:
            try:
                arrays, step, meta = restore_arrays(
                    old_dir, expect_schema=old_schema,
                    telemetry=self.telemetry)
            except (FileNotFoundError, CheckpointError):
                arrays, step = None, -1
        if sync is not None:
            step = _broadcast_step(sync, step)
            if sync.rank != 0 and step >= 0:
                arrays, _, meta = restore_arrays(old_dir, step=step,
                                                 expect_schema=old_schema)
        return None if arrays is None else (arrays, step, meta)

    def _migrate_to(self, lane_new: str, n_dev_new: int, graph_new,
                    mesh_new, sync):
        """Move to the next rung: the old rung's newest good step, refitted
        onto the new lane, seeds the new rung's directory.  ``sync`` is
        the process mesh of the ranks that go on (None in one process)."""
        old_dir, old_schema = self._rung_dir(), self._schema()
        self._rung += 1
        self._lane, self._n_dev = lane_new, n_dev_new
        self._graph, self._mesh = graph_new, mesh_new
        self._last_tau = None           # the rollback may lower the tau
        with self.telemetry.span("supervisor.migrate", lane=lane_new,
                                 n_devices=n_dev_new):
            old = self._read_old_step(old_dir, old_schema, sync)
            if old is None:
                return                  # nothing trustworthy: start fresh
            arrays, step, meta = old
            migrated = elastic_migrate_state(
                arrays, n_channels=self._C, v1=self._v1, lane_new=lane_new,
                n_dev_new=n_dev_new, seed=self.seed, rung=self._rung,
                device=self._device)
            epoch = int(meta.get("epoch", step))
            if self._writes_steps():
                checkpoint_save(self._rung_dir(), epoch, migrated,
                                metadata={"epoch": epoch, "done": False},
                                keep=3, blocking=True,
                                schema=self._schema())
            self._record("migrate", epoch, self._attempt,
                         f"state re-entered on {lane_new}/{n_dev_new}dev at "
                         f"epoch {epoch} (agg tau {int(arrays[1])} kept, "
                         "in-flight frame discarded)")

    def _survivor_group(self, survivors: int):
        """The process group of the current mesh's ranks ``[0,
        survivors)``, made on every rank of that mesh (every rank of the
        default group when the mesh spans it)."""
        group = self._mesh.group
        ranks = [r if group is None else dist.get_global_rank(group, r)
                 for r in range(survivors)]
        return dist.new_group(ranks,
                              use_local_synchronization=group is not None)

    def _handle_shrink(self, loss: DeviceLoss):
        survivors = max(1, min(int(loss.survivors), self._n_dev))
        self._record("shrink", 0, self._attempt,
                     f"{self._n_dev} -> {survivors} devices")
        dev = self._device
        if self._lane == "single":
            self._migrate_to("single", 1, self._base(), None, None)
            return
        if isinstance(self._mesh, ShardMesh):
            if survivors == 1:
                self._migrate_to("single", 1, self._base(), None, None)
            else:
                self._migrate_to("sharded", survivors,
                                 repartition(self._graph, survivors),
                                 ShardMesh(survivors, dev), None)
            return
        # a lane of processes: the survivors' group, made on every rank
        sub = self._survivor_group(survivors)
        if self._proc_rank >= survivors:
            raise loss                  # this rank is the lost device
        if survivors == 1:
            self._migrate_to("single", 1, self._base(), None, None)
        elif self._lane == "sharded":
            mesh = GroupShardMesh(dev, group=sub)
            pg = partition_graph(
                self._base(), survivors, shard=mesh.rank,
                exchange_budget=("auto" if self._graph.exchange_budget_auto
                                 else None))
            self._migrate_to("sharded", survivors, pg, mesh, mesh)
        else:
            mesh = SamplerMesh((survivors,), ("data",), dev, group=sub)
            self._migrate_to("spmd", survivors, self._base(), mesh, mesh)

    def _degrade(self) -> bool:
        """Drop a rung after a retry budget ran out; False at the
        bottom.  One process has no SPMD rung: sharded -> single."""
        i = LANE_LADDER.index(self._lane)
        if i + 1 >= len(LANE_LADDER):
            return False
        procs = self._process_mesh()
        lane_new = LANE_LADDER[i + 1]
        if lane_new == "spmd" and procs is None:
            lane_new = "single"
        self._record("degrade", 0, self._attempt,
                     f"{self._lane} -> {lane_new} (retry budget exhausted)")
        if lane_new == "single":
            self._migrate_to("single", 1, self._base(), None, procs)
        else:                           # a GroupShardMesh's group samples
            mesh = SamplerMesh((self._n_dev,), ("data",), self._device,
                               group=procs.group)
            self._migrate_to("spmd", self._n_dev, self._base(), mesh, mesh)
        return True

    # -- the loop ---------------------------------------------------------

    def run(self) -> ResilientRunResult:
        self._attempt = 0               # failures at the current rung
        while True:
            self._epoch_clock = None    # the first epoch is exempt
            self._last_tau = None
            try:
                res = run_adaptive(
                    self._graph, self.metrics, eps=self.eps,
                    delta=self.delta, seed=self.seed, config=self.config,
                    stream=self._stream,
                    device=self._device if self._mesh is None else None,
                    mesh=self._mesh, checkpoint_dir=self._rung_dir(),
                    checkpoint_every=self.checkpoint_every,
                    on_epoch=self._on_epoch, telemetry=self.telemetry)
                return ResilientRunResult(res, tuple(self._events),
                                          self._total_failures, self._lane,
                                          self._n_dev)
            except DeviceLoss as e:
                self._total_failures += 1
                self._record("failure", 0, self._attempt, str(e))
                self._handle_shrink(e)
                self._attempt = 0
            except (InjectedFault, InvariantViolation, EpochTimeoutError,
                    CheckpointError) as e:
                self._total_failures += 1
                self._attempt += 1
                self._record("failure", 0, self._attempt,
                             f"{type(e).__name__}: {e}")
                if self._attempt > self.policy.max_retries:
                    if not self._degrade():
                        raise ResilienceExhausted(
                            f"retry budget exhausted on the final "
                            f"'{self._lane}' rung after "
                            f"{self._total_failures} failures in all "
                            f"({len(self._events)} events)") from e
                    self._attempt = 0
                else:
                    delay = self.policy.sleep_seconds(self._attempt,
                                                      self._rng.random())
                    self._record("retry", 0, self._attempt,
                                 f"backoff {delay * 1e3:.0f} ms, resume "
                                 "from the last good checkpoint")
                    time.sleep(delay)
