"""The port's irreps machinery (``repro_torch.models.gnn.irreps``) against
the JAX package's: the coupling tensors bitwise (the same numpy
arithmetic), the spherical harmonics and the channel-wise tensor product
within 1e-6, and the port's own rotation equivariance."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn.irreps as ji
from repro_torch.models.gnn import irreps as ti
from _torch_parity import np_

ALL_TRIPLES = list(itertools.product(range(3), repeat=3))


def _units(n, seed, dtype=np.float32):
    v = np.random.default_rng(seed).standard_normal((n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(dtype)


@pytest.mark.parametrize("l1,l2,l3", ALL_TRIPLES)
def test_coupling_is_bitwise_the_jax_packages(l1, l2, l3):
    want = ji.coupling(l1, l2, l3)
    got = ti.coupling(l1, l2, l3)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_paths_quadrature_and_rotations_match():
    assert ti.paths() == ji.paths() and len(ti.paths()) == 11
    for l_max in (0, 1):
        assert ti.paths(l_max) == ji.paths(l_max)
    for a, b in zip(ti._sphere_quadrature(), ji._sphere_quadrature()):
        assert a.tobytes() == b.tobytes()
    assert ti._random_units(64, 3).tobytes() == \
        ji._random_units(64, 3).tobytes()
    for seed in (0, 5, 7):
        rot = ti.random_rotation(seed)
        assert rot.tobytes() == ji.random_rotation(seed).tobytes()
        for l in range(3):
            assert ti.wigner_d(l, rot).tobytes() == \
                ji.wigner_d(l, rot).tobytes()
    r = _units(50, 1, np.float64)
    for l in range(3):
        assert ti._sh_np(l, r).tobytes() == ji._sh_np(l, r).tobytes()


def test_coupling_tensor_is_made_once_per_device_and_dtype():
    a = ti.coupling_tensor(1, 1, 2, "cpu")
    assert a is ti.coupling_tensor(1, 1, 2, torch.device("cpu"))
    b = ti.coupling_tensor(1, 1, 2, "cpu", torch.float64)
    assert a.dtype == torch.float32 and b.dtype == torch.float64
    assert b.numpy().tobytes() == ti.coupling(1, 1, 2).tobytes()
    with pytest.raises(ValueError, match="forbidden"):
        ti.coupling_tensor(1, 1, 1, "cpu")
    with pytest.raises(ValueError):
        ti.coupling(1, 1, 2)[0, 0, 0] = 1.0     # shared, read-only


def test_sh_all_matches_jax():
    r = _units(300, 2)
    want = ji.sh_all(jnp.asarray(r))
    got = ti.sh_all(torch.from_numpy(r))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for l in got:
        assert got[l].dtype == torch.float32
        np.testing.assert_allclose(np_(got[l]), np.asarray(want[l]),
                                   rtol=0, atol=1e-6)
    # a batch of unit vectors with leading axes
    r3 = r[:60].reshape(3, 20, 3)
    for l in range(3):
        np.testing.assert_allclose(np_(ti.sh(l, torch.from_numpy(r3))),
                                   np.asarray(ji.sh(l, jnp.asarray(r3))),
                                   rtol=0, atol=1e-6)


def _irrep_dict(rng, n, c, ls):
    return {l: rng.standard_normal((n, c, 2 * l + 1)).astype(np.float32)
            for l in ls}


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("weights", ["none", "per_edge", "per_channel"])
def test_tensor_product_matches_jax(shared, weights):
    """feats_b shared over the channels (N, 2l+1), as the messages' Y, or
    per channel (N, C, 2l+1), as MACE's A; path weights (N, C), (C,) or
    none.  Within 1e-6 of the largest output entry."""
    rng = np.random.default_rng(3)
    n, c = 40, 6
    a = _irrep_dict(rng, n, c, (0, 1, 2))
    if shared:
        b = {l: ti._sh_np(l, _units(n, 4)).astype(np.float32)
             for l in range(3)}
    else:
        b = _irrep_dict(rng, n, c, (0, 1, 2))
    w = {}
    if weights != "none":
        shape = (n, c) if weights == "per_edge" else (c,)
        # every path but one weighted: an unweighted path adds as is
        w = {p: rng.standard_normal(shape).astype(np.float32)
             for p in ji.paths()[1:]}
    want = ji.tensor_product({k: jnp.asarray(v) for k, v in a.items()},
                             {k: jnp.asarray(v) for k, v in b.items()},
                             {k: jnp.asarray(v) for k, v in w.items()})
    got = ti.tensor_product({k: torch.from_numpy(v) for k, v in a.items()},
                            {k: torch.from_numpy(v) for k, v in b.items()},
                            {k: torch.from_numpy(v) for k, v in w.items()})
    assert list(got) == list(want)
    for l in got:
        j = np.asarray(want[l])
        scale = np.abs(j).max()
        np.testing.assert_allclose(np_(got[l]) / scale, j / scale, rtol=0,
                                   atol=1e-6, err_msg=f"l={l}")


def test_tensor_product_skips_missing_inputs():
    """Only the paths whose l1 and l2 the inputs hold contribute, as in
    a first layer where the features hold l = 0 only."""
    rng = np.random.default_rng(5)
    a = _irrep_dict(rng, 10, 3, (0,))
    b = {l: ti._sh_np(l, _units(10, 6)).astype(np.float32) for l in (0, 2)}
    want = ji.tensor_product({k: jnp.asarray(v) for k, v in a.items()},
                             {k: jnp.asarray(v) for k, v in b.items()}, {})
    got = ti.tensor_product({k: torch.from_numpy(v) for k, v in a.items()},
                            {k: torch.from_numpy(v) for k, v in b.items()},
                            {})
    assert list(got) == list(want) == [0, 2]
    for l in got:
        np.testing.assert_allclose(np_(got[l]), np.asarray(want[l]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [5, 7])
def test_sh_and_tensor_product_are_equivariant(seed):
    """Y_l(R r) = D_l(R) Y_l(r), and the product of rotated inputs is the
    rotated product (float64, so to 1e-9)."""
    rot = ti.random_rotation(seed)
    r = _units(64, seed, np.float64)
    rr = r @ rot.T
    for l in range(3):
        d = ti.wigner_d(l, rot)
        np.testing.assert_allclose(np_(ti.sh(l, torch.from_numpy(rr))),
                                   np_(ti.sh(l, torch.from_numpy(r))) @ d.T,
                                   rtol=0, atol=1e-9)
    rng = np.random.default_rng(seed)
    a = {l: torch.from_numpy(rng.standard_normal((64, 4, 2 * l + 1)))
         for l in range(3)}
    a_rot = {l: torch.einsum("ncx,yx->ncy", a[l],
                             torch.from_numpy(ti.wigner_d(l, rot)))
             for l in range(3)}
    y = ti.sh_all(torch.from_numpy(r))
    y_rot = ti.sh_all(torch.from_numpy(rr))
    for shared in (True, False):
        b, b_rot = (y, y_rot) if shared else (a, a_rot)
        out = ti.tensor_product(a, b, {})
        out_rot = ti.tensor_product(a_rot, b_rot, {})
        for l in out:
            want = torch.einsum("ncx,yx->ncy", out[l],
                                torch.from_numpy(ti.wigner_d(l, rot)))
            np.testing.assert_allclose(np_(out_rot[l]), np_(want), rtol=0,
                                       atol=1e-9)
