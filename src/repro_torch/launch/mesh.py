"""Local ranks of a ``torch.distributed`` group (``repro.launch.mesh``).

The JAX package builds its meshes over the devices of one process
(``make_mesh_compat``); the port's SPMD lane is one process a sampler,
so a mesh starts with its processes.  :func:`spawn_local` starts
``world_size`` ranks on this host with the ``spawn`` start method (a
process that has initialised CUDA cannot be forked), joins them into one
group over a ``FileStore``, calls ``fn(rank, *args)`` on each, and
returns the ranks' results in rank order.  Each rank then builds its
:class:`~repro_torch.core.distributed.SamplerMesh` over that group.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

__all__ = ["spawn_local"]


def _rank_main(rank: int, world_size: int, backend: str, store_path: str,
               timeout: float, fn, args, results) -> None:
    """A spawned rank: join the group, run ``fn``, report its result or
    its traceback, leave the group.  Its CPU threads are its share of
    the host's cores: W ranks of the host's default count each would
    oversubscribe it many times."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_local(fn: Callable, world_size: int, *, args: tuple = (),
                backend: str = "gloo", timeout: float = 600.0,
                store_dir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned local ranks of
    one ``backend`` group -> their results, in rank order.

    ``fn`` and ``args`` are pickled, so ``fn`` must be a top-level
    function of an importable module (or of the ``__main__`` script);
    the ranks inherit this process's ``sys.path``.  The group's
    ``FileStore`` lies in ``store_dir`` (a temporary directory, removed
    after, when None).  ``timeout`` bounds the whole run: the group's
    collectives and the wait for every rank.  A rank that raises or
    dies, or a run that outlasts ``timeout``, stops every rank and
    raises ``RuntimeError`` (with the rank's traceback) or
    ``TimeoutError``.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="spawn_local_") if own_dir \
        else store_dir
    store_path = os.path.join(store_dir, f"store-{os.getpid()}-"
                                         f"{time.monotonic_ns()}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, store_path, timeout,
                               fn, tuple(args), results))
             for r in range(world_size)]
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(world_size)) - set(out))} of "
                    f"{world_size} did not finish within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    try:    # its traceback may still be on the way
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]
