"""Fault-tolerant checkpointing (``repro.checkpoint.store``), on the same
on-disk format as the JAX package's store: either reads the other's
steps.

Layout: one directory per step, atomically published:

    <root>/step_00000123.tmp/...    (written)
    <root>/step_00000123/           (os.replace after fsync: atomic)
        manifest.json               {step, n_leaves, treedef, dtypes,
                                     shapes, checksums, metadata, schema}
        arr_000000.npy ...          one .npy per leaf (copied to host)
    <root>/step_00000123.quarantined-0/   (a step that failed verification)

A tree is a leaf, or a dict, list or tuple of trees (``repro_torch.tree``:
dict keys in sorted order, as JAX walks them); a leaf is a tensor on any
device, a numpy array or a scalar.  The manifest's ``treedef`` holds the
port's description of the leaf list (``tuple(*, *, ...)``); no reader
needs it.

Guarantees:
  * crash-consistent: a partially written step is never visible
    (readers only see directories without the .tmp suffix);
  * integrity-checked: every leaf's CRC32 is stamped into the manifest
    at publish time and verified on restore, before any array reaches
    the run;
  * quarantine and fallback: when the newest step fails verification
    (torn manifest, missing or corrupt leaf) and the caller pinned no
    step, it is renamed aside (``.quarantined-N``, invisible to
    ``latest_step``) and the restore falls back to the newest step that
    verifies;
  * keep-last-k garbage collection that never deletes a step a restore
    is reading (``keep=0`` keeps everything);
  * restore onto any device: leaves are stored as whole host arrays and
    come back as tensors on the ``device`` the restorer names, in the
    types they were saved with (bfloat16 included, stored as its bits);
  * async save: the copy to host runs on the caller's thread, the CRC,
    ``np.save``, fsync and rename on a background thread.  A publish
    failure is re-raised from the next ``CheckpointManager.wait()`` or
    ``maybe_save()``: an async save never fails silently.

Errors (all raise, never assert):

  * :class:`CheckpointError`: base of everything below;
  * :class:`CheckpointIntegrityError`: the step's bytes are damaged
    (torn manifest, missing leaf file, checksum mismatch); eligible for
    quarantine and fallback;
  * :class:`CheckpointLayoutError`: the step verifies but does not fit
    the restorer's tree (leaf count or shape); never quarantined;
  * :class:`CheckpointSchemaError`: the manifest's ``schema`` stamp is
    not the one the restorer expects; never quarantined.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..tree import tree_leaves, tree_unflatten

__all__ = ["save", "restore", "restore_arrays", "latest_step",
           "CheckpointManager", "CheckpointError",
           "CheckpointIntegrityError", "CheckpointLayoutError",
           "CheckpointSchemaError", "install_publish_fault_hook"]


class CheckpointError(RuntimeError):
    """Base class of every typed checkpoint failure."""


class CheckpointIntegrityError(CheckpointError):
    """The step's on-disk bytes are damaged (torn manifest, missing or
    corrupt leaf).  ``restore(step=None)`` quarantines such a step and
    falls back to the newest one that verifies."""


class CheckpointLayoutError(CheckpointError):
    """The step verifies but does not fit the restorer's tree (leaf
    count or shape).  The disk is fine, the caller is incompatible, so
    the step is never quarantined."""


class CheckpointSchemaError(CheckpointError, ValueError):
    """The checkpoint's logical layout does not match the restorer's
    (another metric set, another lane, another random generator, or the
    JAX engine's state).  Raised before any leaf-count or shape check,
    since the remedy (a fresh run, or a directory written with the same
    schema) differs from a shape bug's."""


# ---------------------------------------------------------------------------
# Fault hook (instrumentation of the publish pipeline)
# ---------------------------------------------------------------------------

# Called as hook(phase, step, leaf_index) from inside the background
# publish: phase is "leaf" (before each arr_*.npy write) or "manifest"
# (before the manifest write).  Raising from the hook aborts the publish
# mid-write, the torn state a process kill there would leave; the
# crash-consistency tests drive quarantine and fallback through it.
# None disables it (the default).
_publish_fault_hook: Optional[Callable[[str, int, int], None]] = None


def install_publish_fault_hook(hook) -> None:
    """Install (or, with ``None``, remove) the publish fault hook."""
    global _publish_fault_hook
    _publish_fault_hook = hook


# ---------------------------------------------------------------------------
# Read guard (GC never deletes the step a restore is reading)
# ---------------------------------------------------------------------------

_read_lock = threading.Lock()
_steps_being_read: dict = {}     # absolute step dir -> reader count


class _reading:
    """Registers a step directory as being read; ``_gc`` (on the publish
    thread) skips every registered directory."""

    def __init__(self, d: str):
        self.d = os.path.abspath(d)

    def __enter__(self):
        with _read_lock:
            _steps_being_read[self.d] = _steps_being_read.get(self.d, 0) + 1
        return self

    def __exit__(self, *exc):
        with _read_lock:
            n = _steps_being_read.get(self.d, 1) - 1
            if n <= 0:
                _steps_being_read.pop(self.d, None)
            else:
                _steps_being_read[self.d] = n
        return False


def _describe(tree) -> str:
    """The port's ``treedef``: the nesting with ``*`` for each leaf."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(t) for t in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"tuple({inner})"
    return "*"


def _to_host(x) -> tuple:
    """(a copy of the leaf on the host, its dtype's name): a later
    in-place write to the leaf cannot reach the pending publish.  numpy
    has no bfloat16: such a leaf is kept as its int16 bits under the
    name ``bfloat16``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy(), "bfloat16"
        x = x.numpy()
    else:
        x = np.array(x)
    return x, str(x.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A stored leaf back as a tensor on ``device``, a ``bfloat16`` one
    from its 2-byte bits."""
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _crc(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes (dtype and shape are checked apart,
    through the manifest)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def save(root: str, step: int, tree, *, metadata: Optional[dict] = None,
         keep: int = 3, blocking: bool = True,
         schema: Optional[str] = None, telemetry=None):
    """Write one checkpoint; returns the publish thread (joined if
    ``blocking``).

    The leaves are copied to the host here; the thread computes the
    CRCs, writes the files, fsyncs the manifest and renames the step
    into place, then prunes to the newest ``keep`` steps (``keep=0``
    keeps every step; a negative ``keep`` raises).  ``schema`` stamps
    the manifest with the caller's layout id, which a later
    :func:`restore` with ``expect_schema=`` must match.

    When ``blocking`` is true a publish failure raises here; otherwise
    it is kept on the returned thread (``_exc``) and re-raised by
    :meth:`CheckpointManager.wait`.  The thread's ``seconds`` holds the
    publish's wall seconds once it has ended.

    ``telemetry`` (a :class:`repro_torch.runtime.Telemetry`, or None)
    sees the publish from the background thread: a ``checkpoint.publish``
    span around the write, then a ``checkpoint.publish`` event with its
    seconds and ``ok`` (False with the error's type on a failure).
    """
    if keep < 0:
        raise ValueError(f"keep must be >= 0 (0 = keep everything), "
                         f"got {keep}")
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"step_{step:08d}.tmp")
    final = os.path.join(root, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    host = [_to_host(x) for x in tree_leaves(tree)]
    host_leaves, dtypes = [a for a, _ in host], [d for _, d in host]
    treedef = _describe(tree)

    def publish():
        hook = _publish_fault_hook
        for i, arr in enumerate(host_leaves):
            if hook is not None:
                hook("leaf", step, i)
            np.save(os.path.join(tmp, f"arr_{i:06d}.npy"), arr)
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": treedef,
            "dtypes": dtypes,
            "shapes": [list(a.shape) for a in host_leaves],
            "checksums": [_crc(a) for a in host_leaves],
            "metadata": metadata or {},
        }
        if schema is not None:
            manifest["schema"] = schema
        if hook is not None:
            hook("manifest", step, len(host_leaves))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)          # atomic publish
        _gc(root, keep)

    def run_publish():
        t0 = time.perf_counter()
        try:
            if telemetry:
                with telemetry.span("checkpoint.publish", step=step,
                                    n_leaves=len(host_leaves)):
                    publish()
            else:
                publish()
        except BaseException as e:      # noqa: BLE001 — surfaced by wait()
            t._exc = e
            if telemetry:
                telemetry.emit("checkpoint.publish", step=step,
                               seconds=time.perf_counter() - t0, ok=False,
                               error=type(e).__name__)
        else:
            if telemetry:
                telemetry.emit("checkpoint.publish", step=step,
                               seconds=time.perf_counter() - t0, ok=True)
        finally:
            t.seconds = time.perf_counter() - t0

    t = threading.Thread(target=run_publish, daemon=True)
    t._exc = None
    t.seconds = None
    t.start()
    if blocking:
        t.join()
        if t._exc is not None:
            raise t._exc
    return t


def _gc(root: str, keep: int):
    """Prune to the newest ``keep`` steps (``keep=0`` keeps all), after
    the new step's rename, skipping every step a restore is reading."""
    if keep == 0:
        return
    steps = sorted(_list_steps(root))
    with _read_lock:
        being_read = set(_steps_being_read)
    for s in steps[:-keep]:
        d = os.path.join(root, f"step_{s:08d}")
        if os.path.abspath(d) in being_read:
            continue
        shutil.rmtree(d, ignore_errors=True)


def _list_steps(root: str):
    out = []
    if not os.path.isdir(root):
        return out
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass                    # .quarantined-N
    return out


def latest_step(root: str) -> Optional[int]:
    steps = _list_steps(root)
    return max(steps) if steps else None


def _quarantine(root: str, step: int) -> Optional[str]:
    """Rename a damaged step aside, keeping its bytes; returns the new
    path (None if the rename failed, e.g. the step vanished)."""
    d = os.path.join(root, f"step_{step:08d}")
    for n in range(100):
        q = f"{d}.quarantined-{n}"
        if not os.path.exists(q):
            try:
                os.replace(d, q)
                return q
            except OSError:
                return None
    return None


def _load_manifest(d: str) -> dict:
    """A step's manifest; any damage (missing file, torn JSON, no leaf
    table) is an integrity failure."""
    path = os.path.join(d, "manifest.json")
    try:
        with open(path) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointIntegrityError(
            f"checkpoint {d} has no manifest.json (torn publish?)") from e
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointIntegrityError(
            f"checkpoint {d} has a torn/unreadable manifest.json: "
            f"{e}") from e
    if "n_leaves" not in manifest:
        raise CheckpointIntegrityError(
            f"checkpoint {d} manifest carries no leaf table")
    return manifest


def _load_verified_arrays(d: str, manifest: dict) -> list:
    """Every leaf of a step, each checked against its CRC stamp (a
    manifest without stamps skips the comparison, but a missing or
    unreadable file still fails)."""
    checksums = manifest.get("checksums")
    arrays = []
    for i in range(int(manifest["n_leaves"])):
        path = os.path.join(d, f"arr_{i:06d}.npy")
        try:
            a = np.load(path)
        except FileNotFoundError as e:
            raise CheckpointIntegrityError(
                f"checkpoint {d} is missing leaf file arr_{i:06d}.npy "
                f"(torn publish?)") from e
        except (ValueError, OSError) as e:
            raise CheckpointIntegrityError(
                f"checkpoint {d} leaf arr_{i:06d}.npy is unreadable: "
                f"{e}") from e
        if checksums is not None:
            got = _crc(a)
            if got != int(checksums[i]):
                raise CheckpointIntegrityError(
                    f"checkpoint {d} leaf arr_{i:06d}.npy fails its "
                    f"checksum (manifest {int(checksums[i]):#010x}, "
                    f"disk {got:#010x}): corrupt or tampered bytes")
        arrays.append(a)
    return arrays


def _check_schema(d: str, manifest: dict, expect_schema: Optional[str]):
    if expect_schema is None:
        return
    found = manifest.get("schema")
    if found != expect_schema:
        detail = (f"it is stamped {found!r}" if found is not None
                  else "it carries no schema stamp")
        raise CheckpointSchemaError(
            f"checkpoint {d} does not match the expected state layout: "
            f"restorer expects schema {expect_schema!r} but {detail}. The "
            "stored run state is incompatible: restart the run fresh (or "
            "point checkpoint_dir at a directory written with the same "
            "schema).")


def _leaf_devices(device, n_leaves: int) -> list:
    """One device per leaf: ``device`` alone (None: the port's default,
    ``"cuda"``), or a sequence aligned leaf for leaf."""
    if isinstance(device, (list, tuple)):
        if len(device) != n_leaves:
            raise CheckpointLayoutError(
                f"{len(device)} devices given for {n_leaves} leaves: the "
                "sequence must align leaf for leaf")
        return [resolve_device(d) for d in device]
    dev = resolve_device(DEFAULT_DEVICE if device is None else device)
    return [dev] * n_leaves


def _restore_step(root: str, step: int, tree_like, devices,
                  expect_schema: Optional[str]):
    """Verified restore of one step (no fallback)."""
    d = os.path.join(root, f"step_{step:08d}")
    leaves = tree_leaves(tree_like)
    with _reading(d):
        manifest = _load_manifest(d)
        _check_schema(d, manifest, expect_schema)
        if int(manifest["n_leaves"]) != len(leaves):
            raise CheckpointLayoutError(
                f"checkpoint {d} has {manifest['n_leaves']} leaves, "
                f"restorer expects {len(leaves)}")
        arrays = _load_verified_arrays(d, manifest)
    for i, (a, ref) in enumerate(zip(arrays, leaves)):
        want = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(a.shape) != want:
            raise CheckpointLayoutError(
                f"checkpoint {d} leaf {i} has shape {tuple(a.shape)}, "
                f"restorer expects {want}")
    placed = [_to_tensor(a, dt, dev)
              for a, dt, dev in zip(arrays, manifest["dtypes"], devices)]
    return tree_unflatten(tree_like, placed), step, manifest["metadata"]


def _attempt_restore(telemetry, step: int, load):
    """One restore attempt: ``load(step)``, under a ``checkpoint.restore``
    span with an outcome event when telemetry is on."""
    if not telemetry:
        return load(step)
    t0 = time.perf_counter()
    with telemetry.span("checkpoint.restore", step=step):
        try:
            out = load(step)
        except BaseException as e:
            telemetry.emit("checkpoint.restore", step=step,
                           seconds=time.perf_counter() - t0, ok=False,
                           error=type(e).__name__)
            raise
        telemetry.emit("checkpoint.restore", step=step,
                       seconds=time.perf_counter() - t0, ok=True)
        return out


def _fall_back(root: str, telemetry, load):
    """``load(step)`` of the newest step, quarantining each step that
    fails verification and trying the next newest."""
    while True:
        s = latest_step(root)
        if s is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
        try:
            return _attempt_restore(telemetry, s, load)
        except CheckpointIntegrityError:
            _quarantine(root, s)
            if telemetry:
                telemetry.emit("checkpoint.quarantine", step=s)


def restore(root: str, tree_like, *, step: Optional[int] = None,
            device=None, expect_schema: Optional[str] = None,
            telemetry=None):
    """Restore into the structure of ``tree_like`` (only its leaves'
    shapes are read) -> (tree of tensors, step, metadata).

    ``device``: where the leaves come back; one device, or a sequence
    aligned leaf for leaf (None: ``"cuda"``, which raises without a
    card).  The leaves keep the dtypes they were saved with.

    ``expect_schema``: the manifest's ``schema`` stamp must equal it; a
    mismatch, or no stamp, raises :class:`CheckpointSchemaError` before
    any leaf or shape check.

    With ``step=None`` the newest step is tried first, and every step
    that fails integrity verification is quarantined and the next
    newest tried.  Layout and schema mismatches propagate at once (the
    bytes are fine; falling back would resurrect an older run).  A
    pinned ``step`` is restored exactly or raises: no quarantine, no
    fallback.  Raises ``FileNotFoundError`` when no step verifies.

    ``telemetry`` sees each attempt as a ``checkpoint.restore`` span and
    event (``ok``), and each quarantined step as
    ``checkpoint.quarantine``.
    """
    devices = _leaf_devices(device, len(tree_leaves(tree_like)))

    def load(s: int):
        return _restore_step(root, s, tree_like, devices, expect_schema)

    if step is not None:
        return _attempt_restore(telemetry, step, load)
    return _fall_back(root, telemetry, load)


def restore_arrays(root: str, *, step: Optional[int] = None,
                   expect_schema: Optional[str] = None, telemetry=None):
    """Verified raw restore without a template: (list of host numpy
    arrays, step, metadata), for a caller that is about to change the
    shapes; a ``bfloat16`` leaf comes back as its int16 bits.
    Verification, quarantine, fallback and telemetry as in
    :func:`restore`."""
    def load_one(s: int):
        d = os.path.join(root, f"step_{s:08d}")
        with _reading(d):
            manifest = _load_manifest(d)
            _check_schema(d, manifest, expect_schema)
            return (_load_verified_arrays(d, manifest), s,
                    manifest["metadata"])

    if step is not None:
        return _attempt_restore(telemetry, step, load_one)
    return _fall_back(root, telemetry, load_one)


class CheckpointManager:
    """Keep-last-k manager with async publishing and restart recovery.

    ``keep=0`` keeps every step, as in :func:`save`.  An async publish
    failure is re-raised from the next :meth:`wait` or
    :meth:`maybe_save`.  ``telemetry`` goes to every save and restore.
    """

    def __init__(self, root: str, keep: int = 3, save_every: int = 100,
                 schema: Optional[str] = None, telemetry=None):
        if keep < 0:
            raise ValueError(f"keep must be >= 0 (0 = keep everything), "
                             f"got {keep}")
        self.root = root
        self.keep = keep
        self.save_every = save_every
        self.schema = schema
        self.telemetry = telemetry
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree, metadata=None) -> bool:
        if step % self.save_every:
            return False
        self.wait()                     # raises if the previous save died
        self._pending = save(self.root, step, tree, metadata=metadata,
                             keep=self.keep, blocking=False,
                             schema=self.schema, telemetry=self.telemetry)
        return True

    def wait(self):
        """Join the publish in flight; re-raises its failure, if any."""
        if self._pending is not None:
            t, self._pending = self._pending, None
            t.join()
            exc = getattr(t, "_exc", None)
            if exc is not None:
                raise exc

    def restore_or_none(self, tree_like, device=None):
        """The newest verifying step, or None when there is none.
        Integrity failures are handled inside :func:`restore`; a schema
        or layout mismatch propagates (never a silent fresh start)."""
        try:
            return restore(self.root, tree_like, device=device,
                           expect_schema=self.schema,
                           telemetry=self.telemetry)
        except FileNotFoundError:
            return None
