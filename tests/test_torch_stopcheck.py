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


# float32 unit roundoff, and the multiple of it that bounds one evaluation
# of f or g (derivation in _f64_interval)
U32 = 2.0 ** -24
F32_ERR_UNITS = 12


def _f64_interval(counts, tau, lil, liu, omega):
    """The interval in which a float32 evaluation of ``[max f, max g]``
    must lie, from a float64 evaluation of the same f and g.

    With a = omega/tau - 1/3, b = omega/tau + 1/3, x = 2 b~ omega / l and
    s = sqrt(a^2 + x) (s_g = sqrt(b^2 + x) for g),

        f = (l/tau) (-a + s),        g = (l/tau) (b + s_g).

    Each float32 operation errs by at most u = 2^-24 relative.  The
    rounding of omega/tau and of the constant 1/3 moves a by about
    2u (omega/tau + 1/3); rounding x, a^2, their sum and the square root
    move s by about 4u s; the subtraction, and the product with l/tau,
    add about 3u (|a| + s).  So one evaluation of f, and the same way of
    g, is within

        t = k u (omega/tau + 1/3 + s) l / tau,        k = 12,

    of its exact value: k rounds the first-order sum of ~9 up for the
    second-order terms and for either library's order of evaluation (a
    sweep of random draws in this domain peaks near 4).  Where
    omega/tau >> |b~ omega/l| the term -a + s cancels catastrophically:
    f is then O(1) but t is a few times 1e-3 of it, which a fixed rtol
    cannot express.  A maximum over vertices of values that each lie
    within t_x of F_x lies in [max_x (F_x - t_x), max_x (F_x + t_x)], and
    that is the interval returned, for f and for g.
    """
    c, lo_l, lo_u = (np.asarray(a, np.float64) for a in (counts, lil, liu))
    tauf = max(float(tau), 1.0)
    om = float(np.float32(omega))
    bt = c / tauf
    rows = []
    for ell, sign in ((np.maximum(lo_l, 1e-8), -1.0),
                      (np.maximum(lo_u, 1e-8), 1.0)):
        a = om / tauf + sign / 3.0
        s = np.sqrt(a * a + 2.0 * bt * om / ell)
        val = (ell / tauf) * (sign * a + s)
        tol = F32_ERR_UNITS * U32 * (om / tauf + 1.0 / 3.0 + s) * ell / tauf
        rows.append(((val - tol).max(), (val + tol).max()))
    return np.array(rows)


def _check_against_f64(v, tau, omega, seed):
    """The port's and the JAX package's ``[max f, max g]`` each within
    the float32 interval of the float64 evaluation; both non-negative."""
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
    bounds = _f64_interval(counts, tau, lil, liu, omega)
    for name, out in (("port", got), ("jax", ref)):
        inside = (bounds[:, 0] <= out) & (out <= bounds[:, 1])
        assert inside.all(), (name, out, bounds)
    assert got[0] >= 0.0
    assert got[1] > 0.0


@settings(max_examples=20, deadline=None)
@given(st.integers(8, 2000), st.integers(1, 10 ** 6),
       st.floats(1e3, 1e8), st.integers(0, 2 ** 31 - 1))
def test_stopcheck_property(v, tau, omega, seed):
    """Property: port and JAX oracle each within float32 rounding of a
    float64 evaluation, and both outputs non-negative (f >= 0, g > 0 for
    any valid inputs)."""
    _check_against_f64(v, tau, omega, seed)


@pytest.mark.parametrize("v,tau,omega,seed", [
    # f cancels catastrophically (omega/tau ~ 9.65e4): the two libraries
    # gave 1.0000317 and 1.0005147 here
    (1375, 127, 12258587.0, 127),
    # omega/tau near 1/3: a itself cancels
    (500, 3000, 1000.0, 3),
    (8, 1, 1e8, 0),
])
def test_stopcheck_pinned_examples(v, tau, omega, seed):
    """Fixed cases of the property above, checked on every run."""
    _check_against_f64(v, tau, omega, seed)


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

