"""The port's aggregations (``repro_torch.core.distributed``) against the
JAX package's (``repro.core.distributed``) on the meshes of
``tests/test_distributed_agg.py``, the tier split (``sampler_axes``),
the frame padding (``_pad_len``) and the local launcher
(``repro_torch.launch.spawn_local``).

One JAX subprocess with 8 host devices runs ``hierarchical_allreduce``,
``flat_allreduce`` and ``reduce_to_root_and_broadcast`` inside
``shard_map`` on seeded frames and writes the sums to ``.npy`` files;
meanwhile an 8-rank gloo group runs the port's three on the same frames,
rank r holding device r's.  Integer-valued frames sum exactly in any
order: bitwise.  N(0, 1) frames: another order of summation moves a sum
by at most 7 u sum |x_i| (u = 2^-24), held at 1e-6 sum |x_i|.
"""
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core.distributed as jdist
from repro.core.engine import _pad_len as jax_pad_len
from repro.launch.mesh import make_mesh_compat
import _torch_spmd_ranks as ranks
from repro_torch.core.distributed import sampler_axes
from repro_torch.core.engine import _pad_len
from repro_torch.launch import spawn_local

W = 8
MESHES = [(("pod", "data", "model"), (2, 2, 2)),   # both tiers populated
          (("data", "model"), (2, 4)),             # no global tier
          (("pod", "data"), (4, 2)),               # thin local tier
          (("pod", "data"), (8, 1))]               # one-rank local tiers
C = 2                                               # channels of a frame
RTOL_SUM = 1e-6

_JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from functools import partial
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.compat import make_mesh_compat, shard_map
    from repro.core import distributed as dist

    out_dir, meshes = sys.argv[1], eval(sys.argv[2])
    for kind in ("int", "normal"):
        frames = np.load(os.path.join(out_dir, f"frames_{kind}.npy"))
        flat = frames.reshape(frames.shape[0], -1)   # _agg_channels
        for m, (axes, shape) in enumerate(meshes):
            mesh = make_mesh_compat(shape, axes)
            local_axes, global_axes = dist.sampler_axes(mesh)
            spec = P(axes, None)

            @partial(shard_map, mesh=mesh, in_specs=(spec,),
                     out_specs=(P(), P(), P()), check_vma=False)
            def reduce_all(fr):
                x = fr[0]
                return (dist.hierarchical_allreduce(x, local_axes,
                                                    global_axes),
                        dist.flat_allreduce(x, axes),
                        dist.reduce_to_root_and_broadcast(x, axes))

            outs = jax.jit(reduce_all)(
                jax.device_put(flat, NamedSharding(mesh, spec)))
            for mode, got in zip(("hierarchical", "flat", "root"), outs):
                np.save(os.path.join(out_dir, f"{m}_{kind}_{mode}.npy"),
                        np.asarray(got).reshape(frames.shape[1:]))
    print("OK")
""")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    v_pad = _pad_len(997, W)
    shape = (W, C, v_pad)
    return {"int": rng.integers(0, 1000, shape).astype(np.float32),
            "normal": rng.standard_normal(shape).astype(np.float32)}


@pytest.fixture(scope="module")
def both(frames, tmp_path_factory):
    """(JAX's sums by (mesh, kind, mode), the port's ranks' results)."""
    out_dir = tmp_path_factory.mktemp("agg")
    for kind, stack in frames.items():
        np.save(out_dir / f"frames_{kind}.npy", stack)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src")))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", _JAX_SCRIPT, str(out_dir), repr(MESHES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_local(ranks.aggregate_frames, W,
                           args=(MESHES, frames), timeout=300,
                           store_dir=str(out_dir))
        stdout, stderr = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.communicate()
    assert jax_run.returncode == 0 and "OK" in stdout, stderr
    want = {(m, kind, mode): np.load(out_dir / f"{m}_{kind}_{mode}.npy")
            for m in range(len(MESHES)) for kind in frames
            for mode in ranks.MODES}
    return want, port


CASES = [(m, mode) for m in range(len(MESHES)) for mode in ranks.MODES]
IDS = [f"{'x'.join(map(str, MESHES[m][1]))}-{mode}" for m, mode in CASES]


@pytest.mark.parametrize("m,mode", CASES, ids=IDS)
def test_integer_frames_bitwise_jax(both, frames, m, mode):
    want, port = both
    jax_sum = want[(m, "int", mode)]
    np.testing.assert_array_equal(jax_sum, frames["int"].sum(axis=0))
    for out, _tiers, _tau in port:
        np.testing.assert_array_equal(out[(m, "int", mode)], jax_sum)


@pytest.mark.parametrize("m,mode", CASES, ids=IDS)
def test_normal_frames_within_summation_order_of_jax(both, frames, m, mode):
    want, port = both
    scale = np.abs(frames["normal"]).astype(np.float64).sum(axis=0)
    for out, _tiers, _tau in port:
        gap = np.abs(out[(m, "normal", mode)].astype(np.float64)
                     - want[(m, "normal", mode)])
        assert (gap <= RTOL_SUM * scale).all(), float((gap / scale).max())


@pytest.mark.parametrize("m,mode", CASES, ids=IDS)
def test_every_rank_holds_the_same_bits(both, m, mode):
    _want, port = both
    for kind in ("int", "normal"):
        ref = port[0][0][(m, kind, mode)]
        for out, _tiers, _tau in port[1:]:
            assert np.array_equal(out[(m, kind, mode)], ref)


@pytest.mark.parametrize("m", range(len(MESHES)),
                         ids=["x".join(map(str, s)) for _, s in MESHES])
def test_tiers_split_as_jax(both, m):
    """Every rank's local and global tier sizes are those of JAX's
    sampler_axes on the same mesh."""
    axes, shape = MESHES[m]
    mesh = make_mesh_compat((1,) * len(axes), axes)
    local_axes, global_axes = jdist.sampler_axes(mesh)
    size = dict(zip(axes, shape))
    want = (int(np.prod([size[a] for a in local_axes])),
            int(np.prod([size[a] for a in global_axes])))
    for _out, tiers, tau in both[1]:
        assert tiers[m] == want
        assert tau == sum(range(W))


@pytest.mark.parametrize("axes", [("pod", "data", "model"),
                                  ("data", "model"), ("pod", "data"),
                                  ("data",), ("pod",), ("model", "pod")])
def test_sampler_axes_splits_as_jax(axes):
    mesh = make_mesh_compat((1,) * len(axes), axes)
    assert sampler_axes(SimpleNamespace(axis_names=axes)) == tuple(
        tuple(t) for t in jdist.sampler_axes(mesh))


@pytest.mark.parametrize("v", [60, 127, 4095, 70_000])
@pytest.mark.parametrize("n_dev", [1, 2, 8, 256])
def test_pad_len_is_jax(v, n_dev):
    assert _pad_len(v, n_dev) == jax_pad_len(v, n_dev)


def test_a_failing_rank_fails_the_launch_at_once(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank one fails"):
        spawn_local(ranks.fail_on_rank_one, 2, timeout=120,
                    store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_a_hung_group_fails_within_its_time_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        spawn_local(ranks.hang_on_rank_one, 2, timeout=8,
                    store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 30
