"""The port's fused stop check (K3's dispatcher and plain version) on the
CPU, against the JAX package's plain version and its Pallas kernel in
interpret mode at rtol 1e-5 (transcendentals round differently in the
two libraries), and the stop rule built on it.  The CUDA kernel itself
is held against the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kadabra as jk
import repro_torch.core.kadabra as tk
from repro.kernels.stopcheck import stopcheck_pallas
from repro.kernels.stopcheck import stopcheck_ref as j_stopcheck_ref
from repro_torch.kernels import stopcheck as ts
from _hypothesis_compat import given, settings, st
from _torch_parity import np_

RTOL = 1e-5


def _inputs(v, seed, tau):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max(tau // 10, 2), v).astype(np.float32)
    lil = (rng.random(v) * 10 + 0.1).astype(np.float32)
    liu = (rng.random(v) * 10 + 0.1).astype(np.float32)
    return counts, lil, liu


@pytest.mark.parametrize("v,block_v", [
    (100, 4096), (5000, 1024), (40000, 16384), (16384, 16384)])
def test_stopcheck_matches_jax_ref_and_pallas(v, block_v):
    counts, lil, liu = _inputs(v, v, 500)
    got = np_(ts.stopcheck(torch.from_numpy(counts), 500,
                           torch.from_numpy(lil), torch.from_numpy(liu),
                           torch.tensor(1e5)))
    jargs = (jnp.asarray(counts), 500, jnp.asarray(lil), jnp.asarray(liu),
             1e5)
    np.testing.assert_allclose(got, np.asarray(j_stopcheck_ref(*jargs)),
                               rtol=RTOL)
    np.testing.assert_allclose(
        got, np.asarray(stopcheck_pallas(*jargs, block_v=block_v,
                                         interpret=True)), rtol=RTOL)


@settings(max_examples=20, deadline=None)
@given(st.integers(8, 2000), st.integers(1, 10 ** 6),
       st.floats(1e3, 1e8), st.integers(0, 2 ** 31 - 1))
def test_stopcheck_property(v, tau, omega, seed):
    """Property: port == JAX oracle and both outputs are non-negative
    (f >= 0, g > 0 for any valid inputs)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, tau + 1, v).astype(np.float32)
    lil = (rng.random(v) * 20 + 1e-3).astype(np.float32)
    liu = (rng.random(v) * 20 + 1e-3).astype(np.float32)
    got = np_(ts.stopcheck(torch.from_numpy(counts), tau,
                           torch.from_numpy(lil), torch.from_numpy(liu),
                           torch.tensor(omega, dtype=torch.float32)))
    ref = np.asarray(j_stopcheck_ref(jnp.asarray(counts), tau,
                                     jnp.asarray(lil), jnp.asarray(liu),
                                     omega))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    assert got[0] >= 0.0
    assert got[1] > 0.0


def test_routes_and_forced_routes():
    counts, lil, liu = (torch.from_numpy(a) for a in _inputs(50, 1, 64))
    args = (counts, 64, lil, liu, torch.tensor(3000.0))
    before = dict(ts.launch_counts)
    want = ts.stopcheck_ref(*args)
    # on the CPU the dispatcher and the kernel's wrapper both take the
    # plain version, and neither counts a launch
    assert torch.equal(ts.stopcheck(*args), want)
    assert torch.equal(ts.stopcheck(*args, use_kernel=False), want)
    assert torch.equal(ts.stopcheck_fused(*args), want)
    assert ts.launch_counts == before
    with pytest.raises(ValueError, match="CUDA kernel"):
        ts.stopcheck(*args, use_kernel=True)


def test_nan_propagates_like_torch_max():
    counts, lil, liu = (torch.from_numpy(a) for a in _inputs(300, 2, 64))
    lil[17] = float("nan")
    out = ts.stopcheck(counts, 64, lil, liu, torch.tensor(3000.0))
    assert torch.isnan(out[0]) and not torch.isnan(out[1])
    counts[5] = float("nan")
    assert torch.isnan(ts.stopcheck(counts, 64, lil, liu,
                                    torch.tensor(3000.0))).all()


@pytest.mark.parametrize("tau", [64, 2000, 30000])
def test_check_stop_reads_the_same_bits_as_its_bounds(tau):
    """On the CPU the stop rule's maxima are bitwise those of the f/g
    bounds evaluated directly, and its done flag follows them."""
    rng = np.random.default_rng(tau)
    n = 400
    b0 = (rng.random(n) ** 4 * 0.2).astype(np.float32)
    omega = torch.tensor(30000.0)
    lil, liu, _ = tk.calibrate_deltas(torch.from_numpy(b0), 0.05, 0.1, omega)
    params = tk.KadabraParams(0.05, 0.1, omega, lil, liu)
    counts = torch.from_numpy(np.round(b0 * tau).astype(np.float32))
    done, max_f, max_g = tk.check_stop(counts, tau, params)
    tauf = torch.clamp(torch.tensor(float(tau)), min=1.0)
    want_f = tk.f_term(counts / tauf, lil, omega, tauf).max()
    want_g = tk.g_term(counts / tauf, liu, omega, tauf).max()
    assert torch.equal(max_f, want_f) and torch.equal(max_g, want_g)
    assert bool(done) == bool(((want_f < 0.05) & (want_g < 0.05))
                              | (tauf >= omega))
    jd, jf, jg = jk.check_stop(
        jnp.asarray(np_(counts)), jnp.int32(tau),
        jk.KadabraParams(0.05, 0.1, jnp.float32(30000.0),
                         jnp.asarray(np_(lil)), jnp.asarray(np_(liu))))
    assert bool(done) == bool(jd)
    assert float(max_f) == pytest.approx(float(jf), rel=RTOL)
    assert float(max_g) == pytest.approx(float(jg), rel=RTOL)

