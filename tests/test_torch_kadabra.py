"""KADABRA statistics of the PyTorch port against the JAX package:
omega, the f/g bounds, the stopping check and the delta calibration in
float32 agree to rtol 1e-5 (transcendentals round differently in the two
libraries), with equal ``done`` flags.  Also the small pieces of the
engine around them: epoch length, batch-width rule, registries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as je
import repro.core.epoch as jep
import repro.core.kadabra as jk
import repro_torch.core.engine as te
import repro_torch.core.epoch as tep
import repro_torch.core.kadabra as tk
from repro_torch.core.estimators import BetweennessEstimator, get_estimator
from repro_torch.kernels.stopcheck import get_stop_rule, register_stop_rule
from _torch_parity import np_

RTOL = 1e-5


def _btilde(n, seed, zeros=0):
    rng = np.random.default_rng(seed)
    b = (rng.random(n) ** 4 * 0.2).astype(np.float32)
    b[:zeros] = 0.0
    return b


@pytest.mark.parametrize("vd,eps,delta", [(3, 0.05, 0.1), (17, 0.01, 0.1),
                                          (512, 0.02, 0.05)])
def test_compute_omega_matches_jax(vd, eps, delta):
    got = float(tk.compute_omega(vd, eps, delta))
    assert got == pytest.approx(float(jk.compute_omega(vd, eps, delta)),
                                rel=RTOL)


@pytest.mark.parametrize("tau", [1, 37, 5000])
def test_f_and_g_terms_match_jax(tau):
    b = _btilde(500, seed=tau, zeros=20)
    ell = (np.random.default_rng(1).random(500) * 20 + 1).astype(np.float32)
    omega = np.float32(4000.0)
    for tf, jf in ((tk.f_term, jk.f_term), (tk.g_term, jk.g_term)):
        got = np_(tf(torch.from_numpy(b), torch.from_numpy(ell),
                     torch.tensor(omega), tau))
        want = np_(jf(jnp.asarray(b), jnp.asarray(ell), omega,
                      jnp.int32(tau)))
        # f = (ell/tau) * (-a + sqrt(a^2 + ...)) cancels where b~ is
        # small: its absolute error is ulp(a) * ell / tau, ~4e-6 here
        atol = np.spacing(np.float32(omega / tau)) * ell.max() / tau
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=2 * atol)


@pytest.mark.parametrize("tau", [64, 2000, 30000])
def test_check_stop_matches_jax(tau):
    n = 400
    b0 = _btilde(n, seed=3, zeros=50)
    omega = 30000.0
    jl, ju, _ = jk.calibrate_deltas(jnp.asarray(b0), 0.05, 0.1,
                                    jnp.float32(omega))
    jp = jk.KadabraParams(0.05, 0.1, jnp.float32(omega), jl, ju)
    tp = tk.KadabraParams(0.05, 0.1, torch.tensor(omega),
                          torch.from_numpy(np.array(jl)),
                          torch.from_numpy(np.array(ju)))
    counts = np.round(b0 * tau).astype(np.float32)
    jd, jf, jg = jk.check_stop(jnp.asarray(counts), jnp.int32(tau), jp)
    td, tf, tg = tk.check_stop(torch.from_numpy(counts), tau, tp)
    assert bool(td) == bool(jd)
    assert float(tf) == pytest.approx(float(jf), rel=RTOL)
    assert float(tg) == pytest.approx(float(jg), rel=RTOL)


@pytest.mark.parametrize("zeros,eps,omega", [(0, 0.05, 2400.0),
                                             (300, 0.01, 35000.0),
                                             (1000, 0.05, 2400.0)])
def test_calibrate_deltas_matches_jax(zeros, eps, omega):
    b0 = _btilde(1000, seed=zeros, zeros=zeros)
    jl, ju, jt = jk.calibrate_deltas(jnp.asarray(b0), eps, 0.1,
                                     jnp.float32(omega))
    tl, tu, tt = tk.calibrate_deltas(torch.from_numpy(b0), eps, 0.1, omega)
    assert float(tt) == pytest.approx(float(jt), rel=RTOL)
    np.testing.assert_allclose(np_(tl), np_(jl), rtol=RTOL)
    np.testing.assert_allclose(np_(tu), np_(ju), rtol=RTOL)
    # the union bound is spent exactly
    used = np.exp(-np_(tl).astype(np.float64)).sum() + \
        np.exp(-np_(tu).astype(np.float64)).sum()
    assert used == pytest.approx(0.1, rel=1e-3)


def test_betweenness_params_match_jax():
    """The estimator's make_params: omega from the diameter bound, then
    the waterfilling on the calibration estimates."""
    from repro.core.estimators import get_estimator as j_get
    from repro.core.estimators.base import RunContext as JCtx
    from repro_torch.core.estimators.base import RunContext as TCtx
    counts = np.zeros((1, 201), np.float32)
    counts[0, :200] = np.round(_btilde(200, seed=5) * 32)
    jp = j_get("betweenness").make_params(None, JCtx(200, 9), 0.05, 0.1,
                                          jnp.asarray(counts),
                                          jnp.int32(32))
    tp = BetweennessEstimator().make_params(None, TCtx(200, 9), 0.05, 0.1,
                                            torch.from_numpy(counts), 32)
    assert float(tp.omega) == pytest.approx(float(jp.omega), rel=RTOL)
    np.testing.assert_allclose(np_(tp.log_inv_delta_l),
                               np_(jp.log_inv_delta_l), rtol=RTOL)
    np.testing.assert_allclose(np_(tp.log_inv_delta_u),
                               np_(jp.log_inv_delta_u), rtol=RTOL)


def test_epoch_length_and_batch_rule_match_jax():
    for p in (1, 2, 8, 64):
        for base in (64, 1000):
            assert tep.epoch_length(p, base=base) == \
                jep.epoch_length(p, base=base)
    for n, vd, req in ((1 << 20, 17, None), (65536, 511, None),
                       (1000, 40, None), (1000, 40, 5), (50, 3, None)):
        assert te.resolve_sample_batch_size(req, n, vd) == \
            je.resolve_sample_batch_size(req, n, vd)


def test_registries():
    assert get_stop_rule("bernstein") is tk.check_stop
    register_stop_rule("bernstein", tk.check_stop)      # same callable: ok
    with pytest.raises(ValueError):
        register_stop_rule("bernstein", lambda *a: None)
    with pytest.raises(KeyError):
        get_stop_rule("hoeffding")
    assert isinstance(get_estimator("kadabra"), BetweennessEstimator)
    with pytest.raises(KeyError):
        get_estimator("pagerank")
    with pytest.raises(NotImplementedError, match="item 9"):
        te.resolve_estimators(("betweenness", "closeness"))
