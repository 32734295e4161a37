"""The port's ``ResilientRunner`` (``repro_torch.runtime.supervisor``) on
the CPU, held against the port's own uninterrupted run at the same seed
(the JAX package's generator is not the port's): bitwise through the
five faults of one lane, each of which fires; the hang timeout; the
ladder's exhaustion; the engine's ``on_epoch`` contract; the
``ShardMesh(8)`` ladder within eps of exact Brandes; and, on one 4-rank
gloo group, the hook agreement and the ladder ``GroupShardMesh`` ->
``SamplerMesh`` -> single (``tests/_torch_runtime_ranks.py``)."""
import json
import os

import numpy as np
import pytest
import torch

import _torch_runtime_ranks as ranks
import repro_torch.core as tc
from repro_torch.checkpoint import latest_step, restore_arrays, save
from repro_torch.core import (AdaptiveConfig, ShardMesh, brandes_numpy,
                              partition_graph)
from repro_torch.core.distributed import sampler_generator
from repro_torch.core.epoch import frame_schema_id
from repro_torch.core.estimators import get_estimator
from repro_torch.core.sampler import sample_pairs
from repro_torch.launch import spawn_local
from repro_torch.runtime import (FaultSchedule, FaultSpec, InjectedFault,
                                 ResilienceExhausted, ResilientRunner,
                                 RetryPolicy, elastic_migrate_state)

CPU = "cpu"
# ER(80) at eps 0.05 runs 21 epochs of 60 samples: past every fault below
CFG = AdaptiveConfig(eps=0.05, delta=0.1, n0_base=60)
FAST = RetryPolicy(max_retries=8, backoff_base=1e-3, backoff_cap=1e-3)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _er80():
    return tc.erdos_renyi_graph(80, 5.0, seed=1, device=CPU)


@pytest.fixture(scope="module")
def clean():
    torch.set_num_threads(1)
    res = tc.run_adaptive(_er80(), config=CFG, seed=3, device=CPU)
    assert res.converged and res.n_epochs > 8
    return res


def _same(got, want):
    np.testing.assert_array_equal(got.reports[0].scores,
                                  want.reports[0].scores)
    assert (got.tau, got.n_epochs, got.converged) == (
        want.tau, want.n_epochs, want.converged)
    assert got.reports[0].stop_epoch == want.reports[0].stop_epoch


def _failures(out) -> list:
    return [e.detail.split(":")[0] for e in out.events
            if e.kind == "failure"]


def test_bitwise_through_every_fault_of_one_lane(tmp_path, clean):
    """kill, nan, hang, corrupt and truncate, one epoch each: every fault
    fires, each is a failure of its own kind, the damaged steps are
    quarantined, and the result is the clean run's bits."""
    sched = FaultSchedule([FaultSpec("kill", 2), FaultSpec("nan", 3),
                           FaultSpec("hang", 4, delay=1.5),
                           FaultSpec("corrupt", 5),
                           FaultSpec("truncate", 6)])
    root = str(tmp_path / "res")
    out = ResilientRunner(_er80(), checkpoint_dir=root, device=CPU,
                          config=CFG, seed=3, schedule=sched,
                          epoch_timeout=1.0, policy=FAST).run()
    assert sched.exhausted
    _same(out.result, clean)
    assert (out.lane, out.n_devices, out.attempts) == ("single", 1, 5)
    assert _failures(out) == ["InjectedFault", "InvariantViolation",
                              "EpochTimeoutError", "InjectedFault",
                              "InjectedFault"]
    assert [e.kind for e in out.events].count("retry") == 5
    rung = os.listdir(os.path.join(root, "rung0"))
    assert {"step_00000004.quarantined-0",
            "step_00000005.quarantined-0"} <= set(rung)
    # the last attempt resumed from step 4 (step 5 was torn) and drew
    # what the clean run drew from there
    assert [s.tau for s in out.result.stats] == [
        s.tau for s in clean.stats][4:]


def test_hang_timeout_spares_each_attempts_first_epoch(tmp_path, clean):
    """A hang in the first epoch of an attempt is exempt (it absorbs
    phases 1-2 and any build); one in a later epoch times out once."""
    sched = FaultSchedule([FaultSpec("hang", 1, delay=0.6),
                           FaultSpec("hang", 3, delay=0.6)])
    out = ResilientRunner(_er80(), checkpoint_dir=str(tmp_path / "ck"),
                          device=CPU, config=CFG, seed=3, schedule=sched,
                          epoch_timeout=0.3, policy=FAST).run()
    assert sched.exhausted
    assert _failures(out) == ["EpochTimeoutError"]
    _same(out.result, clean)


def test_exhaustion_raises_and_a_bug_raises_as_itself(tmp_path):
    sched = FaultSchedule([FaultSpec("kill", 1), FaultSpec("kill", 2)])
    runner = ResilientRunner(_er80(), checkpoint_dir=str(tmp_path / "a"),
                             device=CPU, config=CFG, seed=3, schedule=sched,
                             policy=RetryPolicy(max_retries=1,
                                                backoff_base=1e-3))
    with pytest.raises(ResilienceExhausted, match="'single' rung"):
        runner.run()
    assert sched.exhausted

    class Bug(Exception):
        pass

    def buggy(epoch, state):
        raise Bug("not a fault")

    with pytest.raises(Bug):
        tc.run_adaptive(_er80(), config=CFG, seed=3, device=CPU,
                        checkpoint_dir=str(tmp_path / "b"), on_epoch=buggy)
    runner = ResilientRunner(_er80(), checkpoint_dir=str(tmp_path / "c"),
                             device=CPU, config=CFG, seed=3)
    runner._on_epoch = buggy
    with pytest.raises(Bug):
        runner.run()
    assert runner._events == []


def test_on_epoch_contract(tmp_path, clean):
    """1-based epochs after the previous publish has landed; a refused
    epoch never reaches the disk; a returned tuple replaces the state."""
    root = str(tmp_path / "ck")
    seen = []

    def refuse(epoch, state):
        seen.append((epoch, latest_step(root)))
        assert len(state) == 6 and isinstance(state[1], int)
        if epoch == 2:
            raise InjectedFault("refused epoch 2")

    with pytest.raises(InjectedFault):
        tc.run_adaptive(_er80(), config=CFG, seed=3, device=CPU,
                        checkpoint_dir=root, on_epoch=refuse)
    assert seen == [(1, None), (2, 1)]
    assert latest_step(root) == 1

    def replace(epoch, state):
        return tuple(x.clone() if isinstance(x, torch.Tensor) else x
                     for x in state)

    _same(tc.run_adaptive(_er80(), config=CFG, seed=3, device=CPU,
                          checkpoint_dir=root, on_epoch=replace), clean)
    res = tc.run_kadabra(_er80(), config=CFG, seed=3, device=CPU,
                         on_epoch=replace)
    np.testing.assert_array_equal(res.btilde, clean.reports[0].scores)


def _hyper():
    return tc.hyperbolic_graph(300, seed=0, device=CPU)


HCFG = AdaptiveConfig(eps=0.05, delta=0.1, n0_base=200)


def test_shardmesh_ladder_within_eps(tmp_path):
    """ShardMesh(8) shrinks to ShardMesh(4) at epoch 3; two kills exhaust
    that rung and it degrades to the single lane (one process has no
    SPMD rung): within eps of exact Brandes, tau never falling."""
    g = _hyper()
    sched = FaultSchedule([FaultSpec("shrink", 3, survivors=4),
                           FaultSpec("kill", 4), FaultSpec("kill", 5)])
    out = ResilientRunner(
        partition_graph(g, 8, block_v=64), mesh=ShardMesh(8, CPU),
        checkpoint_dir=str(tmp_path / "ck"), config=HCFG, seed=3,
        schedule=sched, policy=RetryPolicy(max_retries=1,
                                           backoff_base=1e-3)).run()
    assert sched.exhausted and (out.lane, out.n_devices) == ("single", 1)
    assert [e.kind for e in out.events if e.kind in (
        "shrink", "degrade", "migrate")] == ["shrink", "migrate", "degrade",
                                             "migrate"]
    assert [e.detail for e in out.events if e.kind == "degrade"] == [
        "sharded -> single (retry budget exhausted)"]
    taus = [s.tau for s in out.result.stats]
    assert taus == sorted(taus) and out.result.converged
    err = np.abs(out.result.reports[0].scores - brandes_numpy(g)).max()
    assert err <= HCFG.eps


def test_a_migrated_rung_resumes_the_old_generator(tmp_path):
    """ShardMesh(4) degrades to the single lane from its step 2: the
    runner's result is bitwise a single-lane run resumed from that step
    refitted by hand, stamped with the single lane's schema, its
    generator the sharded run's."""
    g = _hyper()
    root = str(tmp_path / "ck")
    sched = FaultSchedule([FaultSpec("kill", 3)])
    out = ResilientRunner(
        partition_graph(g, 4, block_v=64), mesh=ShardMesh(4, CPU),
        checkpoint_dir=root, config=HCFG, seed=3, schedule=sched,
        policy=RetryPolicy(max_retries=0)).run()
    assert out.lane == "single" and sched.exhausted
    schema = {lane: frame_schema_id((get_estimator("betweenness"),),
                                    lane=lane, generator="cpu",
                                    stream="bidir")
              for lane in ("sharded4", "single")}
    arrays, step, meta = restore_arrays(os.path.join(root, "rung0"),
                                        expect_schema=schema["sharded4"])
    assert step == 2
    hand = str(tmp_path / "hand")
    save(hand, step, elastic_migrate_state(
        arrays, n_channels=1, v1=g.n_nodes + 1, lane_new="single",
        n_dev_new=1), metadata=meta, schema=schema["single"])
    want = tc.run_adaptive(g, config=HCFG, seed=3, device=CPU,
                           checkpoint_dir=hand)
    _same(out.result, want)
    with open(os.path.join(root, "rung1", f"step_{want.n_epochs:08d}",
                           "manifest.json")) as f:
        assert json.load(f)["schema"] == schema["single"]


def test_a_rank_migrated_to_spmd_draws_apart_from_its_calibration(
        tmp_path):
    """A sharded step (one generator) degraded onto an SPMD lane of 2
    ranks: each rank's first migrated epoch must not draw its lane's
    calibration sample again.  The SPMD lane calibrates from the rank's
    ``sampler_generator`` stream and only then restores the step's
    generator, so a migrated stream that began where that one begins
    would repeat the very pairs that picked the rung's parameters."""
    g = _hyper()
    root = str(tmp_path / "ck")
    tc.run_adaptive(partition_graph(g, 4, block_v=64),
                    config=AdaptiveConfig(eps=0.05, delta=0.1, n0_base=200,
                                          max_epochs=2),
                    seed=3, mesh=ShardMesh(4, CPU), checkpoint_dir=root)
    arrays, step, _ = restore_arrays(root)
    assert step == 2 and np.asarray(arrays[9]).ndim == 1
    out = elastic_migrate_state(arrays, n_channels=1, v1=g.n_nodes + 1,
                                lane_new="spmd", n_dev_new=2, seed=3,
                                rung=2, device=CPU)
    firsts = []
    for r in range(2):
        calibration = sampler_generator(3, r, CPU)
        migrated = torch.Generator(device=CPU)
        migrated.set_state(torch.as_tensor(out[9][r]))
        cal_s, cal_t = sample_pairs(calibration, g.n_nodes, 256)
        mig_s, mig_t = sample_pairs(migrated, g.n_nodes, 256)
        assert not (torch.equal(cal_s, mig_s) and torch.equal(cal_t, mig_t))
        assert (cal_s == mig_s).float().mean() < 0.1
        firsts.append(mig_s)
    assert not torch.equal(firsts[0], firsts[1])


# ---------------------------------------------------------------------------
# The lanes of many processes: one 4-rank gloo group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runtime_ranks"))
    return spawn_local(ranks.runtime_suite, 4, args=(root,),
                       backend="gloo", timeout=240)


def test_every_rank_raises_when_one_ranks_hook_does(group):
    """GroupShardMesh: rank 2's hook times out at epoch 2; every rank
    raises EpochTimeoutError (rank 2 its own) and epoch 2 never reaches
    rank 0's disk.  SamplerMesh: rank 1's hook raises a class the
    runtime does not know; rank 1 raises it, the others RuntimeError
    naming rank 1."""
    for out in group:
        cls, msg = out["group_hook"]
        assert cls == "EpochTimeoutError"
        assert msg == ("rank 2's own clock" if out["rank"] == 2 else
                       "rank 2 of the GroupShardMesh raised "
                       "EpochTimeoutError in its on_epoch hook at epoch 2")
        assert out["group_hook_step"] == 1
        cls, msg = out["spmd_hook"]
        if out["rank"] == 1:
            assert (cls, msg) == ("HookBug", "rank 1")
        else:
            assert cls == "RuntimeError" and msg.startswith(
                "rank 1 of the SamplerMesh raised an exception")


def test_telemetry_on_is_bitwise_off_on_the_process_lanes(group):
    """GroupShardMesh(4) and SamplerMesh((4,)) at 2 epochs: the same
    scores, tau and levels on every rank with the bus on as off; one
    epoch.stats an epoch, and an exchange.epoch on the sharded lane."""
    for out in group:
        assert out["telemetry_bitwise"] == {"group": (True, 2, 2, "sharded"),
                                            "spmd": (True, 2, 0, "spmd")}


def test_group_ladder_to_the_single_lane(group):
    """GroupShardMesh(4) -> GroupShardMesh(2) -> SamplerMesh(2) -> single:
    ranks 2-3 end in DeviceLoss, ranks 0-1 on the single lane bitwise
    alike, within eps of exact Brandes, tau never falling, every fault
    fired, the trace valid with every supervisor kind it saw."""
    assert [o["ladder"].get("lane", "lost") for o in group] == [
        "single", "single", "lost", "lost"]
    assert "device loss" in group[2]["ladder"]["device_loss"]
    a, b = group[0]["ladder"], group[1]["ladder"]
    np.testing.assert_array_equal(a["scores"], b["scores"])
    assert a["tau"] == b["tau"]
    assert a["exhausted"] and a["attempts"] == 5
    assert [d for k, d in a["events"] if k == "degrade"] == [
        "sharded -> spmd (retry budget exhausted)",
        "spmd -> single (retry budget exhausted)"]
    assert a["taus"] == sorted(a["taus"])
    g = tc.hyperbolic_graph(ranks.N_HYPER, seed=0, device=CPU)
    err = np.abs(a["scores"] - brandes_numpy(g)).max()
    assert err <= ranks.RUN["eps"]
    assert {"supervisor.shrink", "supervisor.degrade", "supervisor.migrate",
            "exchange.epoch", "checkpoint.publish"} <= set(
        group[0]["trace_kinds"])
    assert "checkpoint.publish" not in group[2]["trace_kinds"]
