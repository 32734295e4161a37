"""The port's checkpoint store (``repro_torch.checkpoint``): integrity
(CRC32 per leaf, quarantine and fallback), crash consistency, publish
errors surfacing, GC contracts, the typed errors, restore onto a device,
and the on-disk format against the JAX package's store, which must read
the port's steps and whose steps the port must read."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
from repro.runtime.faults import corrupt_newest_step, truncate_newest_manifest
from repro_torch.checkpoint import (CheckpointError, CheckpointIntegrityError,
                                    CheckpointLayoutError, CheckpointManager,
                                    CheckpointSchemaError,
                                    install_publish_fault_hook, latest_step,
                                    restore, restore_arrays, save)
from repro_torch.checkpoint import store as store_mod

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """These cases are small: one intra-op thread keeps them from
    contending for the cores with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class InjectedFault(RuntimeError):
    """What the fault hook raises to kill a publish mid-write."""


def _tree():
    return {"a": torch.arange(8.0), "b": {"c": torch.ones((3, 3))}}


def _plus_one(tree):
    return {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] + 1}}


# ---------------------------------------------------------------------------
# Integrity: checksums, quarantine, fallback
# ---------------------------------------------------------------------------

def test_corrupt_leaf_quarantined_and_fallback(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    save(root, 1, tree)
    save(root, 2, _plus_one(tree))
    assert corrupt_newest_step(root) is not None
    restored, step, _ = restore(root, tree, device=CPU)
    assert step == 1
    assert torch.equal(restored["a"], tree["a"])
    names = sorted(os.listdir(root))
    assert any(n.startswith("step_00000002.quarantined") for n in names)
    assert latest_step(root) == 1


def test_explicit_step_corruption_raises_no_quarantine(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    save(root, 1, tree)
    corrupt_newest_step(root)
    with pytest.raises(CheckpointIntegrityError):
        restore(root, tree, step=1, device=CPU)
    assert latest_step(root) == 1


def test_torn_manifest_restore_or_none_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    mgr = CheckpointManager(root, save_every=1)
    mgr.maybe_save(1, tree)
    mgr.maybe_save(2, tree)
    mgr.wait()
    truncate_newest_manifest(root)
    out = mgr.restore_or_none(tree, device=CPU)
    assert out is not None and out[1] == 1
    root2 = str(tmp_path / "ck2")
    mgr2 = CheckpointManager(root2, save_every=1)
    mgr2.maybe_save(1, tree)
    mgr2.wait()
    truncate_newest_manifest(root2)
    assert mgr2.restore_or_none(tree, device=CPU) is None


def test_missing_leaf_file_quarantined(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    save(root, 1, tree)
    save(root, 2, tree)
    os.remove(str(tmp_path / "ck" / "step_00000002" / "arr_000001.npy"))
    _, step, _ = restore(root, tree, device=CPU)
    assert step == 1


def test_layout_and_schema_errors_are_typed(tmp_path):
    root = str(tmp_path / "ck")
    save(root, 1, _tree(), schema="schema-A")
    with pytest.raises(CheckpointLayoutError):
        restore(root, {"a": torch.arange(8.0)}, device=CPU)
    with pytest.raises(CheckpointLayoutError):
        restore(root, {"a": torch.arange(9.0),
                       "b": {"c": torch.ones((3, 3))}}, device=CPU)
    with pytest.raises(CheckpointSchemaError):
        restore(root, _tree(), expect_schema="schema-B", device=CPU)
    # the schema check comes before the leaf count
    with pytest.raises(CheckpointSchemaError):
        restore(root, {"a": torch.arange(8.0)}, expect_schema="schema-B",
                device=CPU)
    with pytest.raises(CheckpointLayoutError, match="align"):
        restore(root, _tree(), device=[CPU])
    assert issubclass(CheckpointLayoutError, CheckpointError)
    assert issubclass(CheckpointSchemaError, ValueError)
    assert latest_step(root) == 1


def test_restore_arrays_verifies_and_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    save(root, 1, _tree(), metadata={"epoch": 1})
    save(root, 2, _tree(), metadata={"epoch": 2})
    corrupt_newest_step(root)
    arrays, step, meta = restore_arrays(root)
    assert step == 1 and meta["epoch"] == 1
    assert len(arrays) == 2
    np.testing.assert_array_equal(arrays[0], np.arange(8.0))


def test_restore_places_each_leaf_and_keeps_dtypes(tmp_path):
    """Leaves come back as tensors on the device named for each, with
    the dtypes they were saved with (a generator's uint8 state, int64
    taus, numpy and scalar leaves among them)."""
    root = str(tmp_path / "ck")
    gen = torch.Generator().manual_seed(5)
    tree = (torch.arange(6, dtype=torch.float32).reshape(2, 3),
            np.int64(7), np.array([1, -1], np.int64), gen.get_state())
    save(root, 3, tree, metadata={"epoch": 3, "done": False})
    got, step, meta = restore(root, tree, device=[CPU, CPU, CPU, CPU])
    assert step == 3 and meta == {"epoch": 3, "done": False}
    assert isinstance(got, tuple) and len(got) == 4
    assert all(isinstance(x, torch.Tensor) and x.device.type == CPU
               for x in got)
    assert [x.dtype for x in got] == [torch.float32, torch.int64,
                                      torch.int64, torch.uint8]
    assert torch.equal(got[0], tree[0]) and int(got[1]) == 7
    assert torch.equal(got[3], gen.get_state())
    manifest = json.loads(
        (tmp_path / "ck" / "step_00000003" / "manifest.json").read_text())
    assert manifest["treedef"] == "tuple(*, *, *, *)"


def test_save_copies_leaves_before_returning(tmp_path):
    """An async save holds its own host copy: an in-place write to a
    leaf after ``maybe_save`` returns does not reach the published step,
    and the publish thread reports its seconds."""
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, save_every=1)
    tree = _tree()
    mgr.maybe_save(1, tree)
    thread = mgr._pending
    tree["a"].add_(100.0)
    mgr.wait()
    assert thread.seconds is not None and thread.seconds >= 0
    arrays, _, _ = restore_arrays(root)
    np.testing.assert_array_equal(arrays[0], np.arange(8.0))


# ---------------------------------------------------------------------------
# Publish errors, crash consistency, GC
# ---------------------------------------------------------------------------

def test_async_publish_error_surfaces_in_wait(tmp_path):
    def boom(kind, step, i):
        raise OSError(28, "No space left on device")

    mgr = CheckpointManager(str(tmp_path / "ck"), save_every=1)
    install_publish_fault_hook(boom)
    try:
        mgr.maybe_save(1, _tree())
        with pytest.raises(OSError):
            mgr.wait()
        mgr.maybe_save(2, _tree())
        with pytest.raises(OSError):
            mgr.maybe_save(3, _tree())
    finally:
        install_publish_fault_hook(None)
    assert latest_step(str(tmp_path / "ck")) is None


def test_unwritable_root_raises_from_save(tmp_path):
    f = tmp_path / "not_a_dir"
    f.write_text("x")
    with pytest.raises(OSError):
        save(str(f / "ck"), 1, _tree())


def test_crash_mid_publish_leaves_no_torn_step(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    save(root, 1, tree)

    def kill_on_second_leaf(kind, step, i):
        if kind == "leaf" and step == 2 and i == 1:
            raise InjectedFault("killed mid-publish")

    install_publish_fault_hook(kill_on_second_leaf)
    try:
        with pytest.raises(InjectedFault):
            save(root, 2, tree)
    finally:
        install_publish_fault_hook(None)
    assert os.path.isdir(os.path.join(root, "step_00000002.tmp"))
    assert latest_step(root) == 1
    _, step, _ = restore(root, tree, device=CPU)
    assert step == 1

    def kill_on_manifest(kind, step, i):
        if kind == "manifest" and step == 3:
            raise InjectedFault("killed before manifest")

    install_publish_fault_hook(kill_on_manifest)
    try:
        with pytest.raises(InjectedFault):
            save(root, 3, tree)
    finally:
        install_publish_fault_hook(None)
    assert latest_step(root) == 1


def test_keep_zero_disables_gc(tmp_path):
    root = str(tmp_path / "ck")
    for s in range(1, 6):
        save(root, s, _tree(), keep=0)
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert len(steps) == 5
    with pytest.raises(ValueError):
        save(root, 9, _tree(), keep=-1)
    with pytest.raises(ValueError):
        CheckpointManager(root, keep=-2)


def test_gc_skips_step_being_read(tmp_path):
    root = str(tmp_path / "ck")
    save(root, 1, _tree())
    d1 = os.path.join(root, "step_00000001")
    with store_mod._reading(d1):
        for s in range(2, 5):
            save(root, s, _tree(), keep=1)
        assert os.path.isdir(d1)
    save(root, 5, _tree(), keep=1)
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert steps == ["step_00000005"]


def test_checkpoint_atomic_and_keep_k(tmp_path):
    root = str(tmp_path / "ck")
    tree = _tree()
    for step in [10, 20, 30, 40]:
        save(root, step, tree, keep=2)
    assert latest_step(root) == 40
    kept = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    assert kept == ["step_00000030", "step_00000040"]
    restored, step, _ = restore(root, tree, device=CPU)
    assert step == 40
    assert torch.equal(restored["a"], tree["a"])
    os.makedirs(os.path.join(root, "step_00000099.tmp"))
    assert latest_step(root) == 40


# ---------------------------------------------------------------------------
# The on-disk format against the JAX package's store
# ---------------------------------------------------------------------------

def _jax_tree():
    return {"a": jnp.arange(8.0), "b": {"c": jnp.ones((3, 3))}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_format_matches_the_jax_store(tmp_path, writer):
    """A step one store publishes, the other restores: the same arrays
    and dtypes, the same per-leaf CRC32 stamps, metadata and schema,
    through the template restore and the raw one."""
    root = str(tmp_path / "ck")
    meta, schema = {"epoch": 4, "done": False}, "schema-parity"
    if writer == "port":
        save(root, 4, _tree(), metadata=meta, schema=schema)
    else:
        jstore.save(root, 4, _jax_tree(), metadata=meta, schema=schema)
    manifest = json.loads(
        (tmp_path / "ck" / "step_00000004" / "manifest.json").read_text())
    want = [np.arange(8.0, dtype=np.float32), np.ones((3, 3), np.float32)]
    assert manifest["checksums"] == [store_mod._crc(a) for a in want]
    assert manifest["checksums"] == [jstore._crc(a) for a in want]
    assert manifest["schema"] == schema and manifest["metadata"] == meta
    for read in (restore_arrays, jstore.restore_arrays):
        arrays, step, got_meta = read(root, expect_schema=schema)
        assert step == 4 and got_meta == meta
        for a, w in zip(arrays, want):
            assert a.dtype == w.dtype
            np.testing.assert_array_equal(a, w)
    tree, _, _ = restore(root, _tree(), device=CPU, expect_schema=schema)
    np.testing.assert_array_equal(tree["b"]["c"].numpy(), want[1])
    jtree, _, _ = jstore.restore(root, _jax_tree(), expect_schema=schema)
    np.testing.assert_array_equal(np.asarray(jtree["a"]), want[0])
    with pytest.raises(CheckpointSchemaError):
        restore_arrays(root, expect_schema="other")
    with pytest.raises(jstore.CheckpointSchemaError):
        jstore.restore_arrays(root, expect_schema="other")
