"""The port's fault injection (``repro_torch.runtime.faults``) and the
supervisor's pure parts against the JAX package's: seeded schedules
spec for spec, the fault kinds, the disk faults on the port's store
layout, ``poison_state`` writing nothing in place, the watchdog's
verdict and tau on the same numpy states, and the state migration's
shapes, accounting and generators."""
import os

import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro_torch.checkpoint import (CheckpointIntegrityError, latest_step,
                                    restore, save)
from repro_torch.core.distributed import sampler_generator
from repro_torch.core.engine import lane_state_shapes
from repro_torch.runtime import (DeviceLoss, FaultContext, FaultSchedule,
                                 FaultSpec, InjectedFault,
                                 InvariantViolation, apply_fault,
                                 available_faults, check_state_invariants,
                                 elastic_migrate_state)
from repro_torch.runtime.faults import (corrupt_newest_step, poison_state,
                                        truncate_newest_manifest)
from repro_torch.runtime.supervisor import migration_generator

CPU = "cpu"


@pytest.mark.parametrize("seed, kwargs", [
    (0, {}), (1, {"n_faults": 6, "max_epoch": 10}), (7, {"survivors": 3}),
    (42, {"kinds": ("kill", "nan"), "n_faults": 5}),
    (1234, {"hang_delay": 0.5, "max_epoch": 3}),
    (2 ** 40, {"kinds": ("hang", "shrink", "corrupt"), "n_faults": 9})])
def test_from_seed_gives_the_references_specs(seed, kwargs):
    got = FaultSchedule.from_seed(seed, **kwargs)
    want = jrt.FaultSchedule.from_seed(seed, **kwargs)
    assert [(s.kind, s.epoch, s.survivors, s.delay) for s in got] == [
        (s.kind, s.epoch, s.survivors, s.delay) for s in want]
    assert got.specs == FaultSchedule.from_seed(seed, **kwargs).specs


def test_from_seed_refuses_an_unknown_kind():
    with pytest.raises(ValueError, match="meteor"):
        FaultSchedule.from_seed(0, kinds=("kill", "meteor"))


def test_take_fires_each_fault_once():
    sched = FaultSchedule([FaultSpec("kill", 2), FaultSpec("nan", 2),
                           FaultSpec("hang", 3)])
    assert [s.kind for s in sched.take(2)] == ["kill", "nan"]
    assert sched.take(2) == [] and not sched.exhausted
    assert [s.kind for s in sched.take(3)] == ["hang"]
    assert sched.exhausted and len(sched) == 3
    sched.reset()
    assert len(sched.take(2)) == 2


def test_apply_fault_kinds():
    ctx = FaultContext(n_devices=8)
    with pytest.raises(InjectedFault):
        apply_fault(FaultSpec("kill", 1), ctx, None)
    with pytest.raises(DeviceLoss) as e:
        apply_fault(FaultSpec("shrink", 1), ctx, None)
    assert e.value.survivors == 4
    with pytest.raises(DeviceLoss) as e:
        apply_fault(FaultSpec("shrink", 1, survivors=3), ctx, None)
    assert e.value.survivors == 3
    for kind in ("corrupt", "truncate"):     # no root: the kill still fires
        with pytest.raises(InjectedFault, match="no step"):
            apply_fault(FaultSpec(kind, 1), ctx, None)
    with pytest.raises(ValueError):
        FaultSpec("meteor", 1)
    state = (torch.ones(2, 4), 1) * 3
    assert apply_fault(FaultSpec("hang", 1, delay=0.0), ctx, state) is state
    out = apply_fault(FaultSpec("nan", 1), ctx, state)
    assert not bool(torch.isfinite(out[2]).all())
    assert available_faults() == ("corrupt", "hang", "kill", "nan",
                                  "shrink", "truncate")


def _leaves(v=5):
    return (torch.arange(v, dtype=torch.float32), np.int64(7))


def test_disk_faults_on_the_port_store(tmp_path):
    """corrupt and truncate damage the newest step of the port's layout;
    the restore quarantines it and falls back to the one before."""
    root = str(tmp_path / "ck")
    assert corrupt_newest_step(root) is None
    assert truncate_newest_manifest(str(tmp_path / "none")) is None
    for step in (1, 2, 3):
        save(root, step, _leaves(100 + step))
    hit = corrupt_newest_step(root)
    assert hit == os.path.join(root, "step_00000003", "arr_000000.npy")
    with pytest.raises(CheckpointIntegrityError):
        restore(root, _leaves(103), step=3, device=CPU)
    torn = truncate_newest_manifest(root)
    assert torn == os.path.join(root, "step_00000003", "manifest.json")
    _, step, _ = restore(root, _leaves(102), device=CPU)
    assert step == 2 and latest_step(root) == 2
    assert os.path.isdir(os.path.join(root, "step_00000003.quarantined-0"))
    ctx = FaultContext(checkpoint_root=root)
    with pytest.raises(InjectedFault, match="step_00000002"):
        apply_fault(FaultSpec("truncate", 4), ctx, None)


def test_poison_state_writes_nothing_in_place():
    """The single lane's first state holds one zero tensor as aggregate,
    frame and surplus: the poisoned frame is a copy, and the aggregate
    stays finite."""
    z = torch.zeros(3, 9)
    state = (z, 0, z, 0, z, 0)
    out = poison_state(state)
    assert bool(torch.isfinite(z).all()) and out[0] is z and out[4] is z
    assert torch.isnan(out[2].view(-1)[0]) and torch.isinf(
        out[2].view(-1)[1])
    assert check_state_invariants(state) == 0
    with pytest.raises(InvariantViolation, match="frame_counts"):
        check_state_invariants(out)
    a = np.zeros((2, 4), np.float32)
    out = poison_state((a, 0, a, 0, a, 0))
    assert np.isfinite(a).all() and np.isnan(out[2]).sum() == 1
    one = poison_state((a, 0, np.zeros(1, np.float32), 0, a, 0))
    assert np.isnan(one[2]).all()


def _state(tau=10, v=8):
    c = np.ones((2, v), np.float32)
    return [c.copy(), np.int32(tau), c.copy(), np.int32(3),
            np.ones((2, v + 1), np.float32), np.int32(1)]


def _variants():
    out = {"good": (_state(), None), "equal_tau": (_state(7), 7)}
    s = _state()
    s[2][0, 3] = np.nan
    out["nan_frame"] = (s, None)
    s = _state()
    s[4][1, 0] = np.inf
    out["inf_surplus"] = (s, None)
    s = _state()
    s[0][0, 0] = -1.0
    out["negative_agg"] = (s, None)
    s = _state()
    s[2][1, 1] = -0.5
    s[4][0, 0] = np.nan
    out["nan_after_negative"] = (s, None)
    s = _state()
    s[5] = np.int32(-2)
    out["negative_tau"] = (s, None)
    out["backwards"] = (_state(5), 7)
    s = _state()
    s[1] = np.int32(-1)
    out["negative_agg_tau"] = (s, 0)
    return out


@pytest.mark.parametrize("name", sorted(_variants()))
def test_watchdog_gives_the_references_verdict(name):
    state, last = _variants()[name]

    def verdict(fn, st):
        try:
            return "ok", fn(tuple(st), last)
        except Exception as e:  # noqa: BLE001 - compared by message
            return type(e).__name__, str(e).split(" (")[0]

    want = verdict(jrt.check_state_invariants, state)
    assert verdict(check_state_invariants, state) == want
    # the port's own state: tensors, and the taus Python ints
    port = [torch.from_numpy(x) if isinstance(x, np.ndarray) and x.ndim
            else int(x) for x in state]
    assert verdict(check_state_invariants, port) == want


def _arrays(c=2, v=10, w=None, rng=np.random.default_rng(0)):
    """An engine step's 10 leaves: one lane of one generator, or an SPMD
    lane of ``w`` ranks (frames and surpluses stacked, one generator
    state a rank)."""
    agg, frame, sur = lane_state_shapes(c, v, w or 1)
    stack = (lambda s: (w, *s)) if w else (lambda s: s)
    gen = rng.integers(0, 255, (w, 16) if w else 16).astype(np.uint8)
    return [rng.random(agg).astype(np.float32), np.int64(5000),
            np.ones(stack(frame), np.float32), np.int64(77),
            np.ones(stack(sur), np.float32), np.int64(3),
            (rng.random(agg) * 0.5).astype(np.float32),
            np.array([4000, 0], np.int64), np.array([3, -1], np.int64), gen]


def test_migration_keeps_the_aggregate_and_drops_the_frame():
    c, v = 2, 10
    arrays = _arrays(c, v)
    out = elastic_migrate_state(arrays, n_channels=c, v1=v + 1,
                                lane_new="spmd", n_dev_new=4)
    agg, frame, sur = lane_state_shapes(c, v, 4)
    assert (out[0].shape, out[2].shape, out[4].shape) == (
        agg, (4, *frame), (4, *sur))
    np.testing.assert_array_equal(out[0][:, :v + 1], arrays[0])
    assert not out[0][:, v + 1:].any() and int(out[1]) == 5000
    assert not out[2].any() and not out[4].any()
    assert int(out[3]) == int(out[5]) == 0
    np.testing.assert_array_equal(out[6][:, :v + 1], arrays[6])
    np.testing.assert_array_equal(out[7], arrays[7])
    np.testing.assert_array_equal(out[8], arrays[8])
    # back to one generator's lane: the SPMD rows refit to (C, V+1)
    back = elastic_migrate_state(out, n_channels=c, v1=v + 1,
                                 lane_new="single", n_dev_new=1)
    np.testing.assert_array_equal(back[0], arrays[0])
    assert back[2].shape == back[4].shape == (c, v + 1)


def test_migration_continues_every_generator():
    """One generator goes on as it was; an SPMD rank goes on with its own
    row, and a rank without one starts its own migration stream, which
    neither its lane's calibration (the rank's sampler stream) nor any
    earlier lane drew from, and which differs from rung to rung."""
    one = _arrays()
    out = elastic_migrate_state(one, n_channels=2, v1=11, lane_new="single",
                                n_dev_new=1)
    np.testing.assert_array_equal(out[9], one[9])
    spmd = _arrays(w=4)
    out = elastic_migrate_state(spmd, n_channels=2, v1=11, lane_new="spmd",
                                n_dev_new=2)
    np.testing.assert_array_equal(out[9], spmd[9][:2])
    out = elastic_migrate_state(spmd, n_channels=2, v1=11,
                                lane_new="sharded", n_dev_new=4)
    np.testing.assert_array_equal(out[9], spmd[9][0])
    g = torch.Generator().manual_seed(5)
    one[9] = g.get_state().numpy()
    out = elastic_migrate_state(one, n_channels=2, v1=11, lane_new="spmd",
                                n_dev_new=3, seed=5, rung=1, device=CPU)
    later = elastic_migrate_state(one, n_channels=2, v1=11,
                                  lane_new="spmd", n_dev_new=3, seed=5,
                                  rung=2, device=CPU)
    for r in range(3):
        np.testing.assert_array_equal(
            out[9][r],
            migration_generator(5, r, 1, CPU).get_state().numpy())
        assert not np.array_equal(
            out[9][r], sampler_generator(5, r, CPU).get_state().numpy())
        assert not np.array_equal(out[9][r], one[9])
        assert not np.array_equal(out[9][r], later[9][r])
    assert len({bytes(row) for row in out[9]}) == 3
