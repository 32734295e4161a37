"""The port's MIND (``repro_torch.models.recsys``) on the CPU against the
JAX package's ``repro.models.recsys.mind``: the configs and recsys cell
shapes, ``recsys_batch_fn`` bitwise, the four functions (interest
capsules, serving, retrieval, the training loss) on full and partly
masked histories, gradients against ``jax.grad`` and three AdamW steps
against the reference's ``make_train_step``, the weights carried across
by ``mind_params_from_numpy``.

Tolerance, float32: 1e-5 of each array's largest entry (the packages
sum the routing einsums and the in-batch logits in other orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs._families as jfam
import repro.configs.mind as jcfg
import repro.data.pipeline as jpipe
import repro.models.recsys.mind as jmind
import repro.optim.adamw as jopt
import repro.train.step as jstep
import repro_torch.configs.mind as tcfg
import repro_torch.models.recsys as tmind
import repro_torch.optim as topt
import repro_torch.train as tstep
from repro_torch.configs._families import RECSYS_SHAPES
from repro_torch.data import recsys_batch_fn
from repro_torch.tree import tree_leaves
from _torch_parity import np_

REL = 1e-5


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np_(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _cfgs(**kw):
    return (dataclasses.replace(jcfg.make_smoke_config(), **kw),
            dataclasses.replace(tcfg.make_smoke_config(), **kw))


@functools.lru_cache(maxsize=None)
def _weights(seed=0, **kw):
    jc, _ = _cfgs(**kw)
    jp = jmind.init_params(jax.random.PRNGKey(seed), jc)
    tp = tmind.mind_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def _batch(batch=32, seed=0, step=0, masked=True, candidates=0):
    """A recsys_batch_fn batch of the smoke config (histories of 5 to 10
    items) as numpy, or every slot live when ``masked`` is False; with
    ``candidates``, one user's history and that many item ids."""
    cfg = jcfg.make_smoke_config()
    b = jpipe.recsys_batch_fn(cfg.n_items, batch, cfg.hist_len,
                              seed=seed)(step)
    if not masked:
        b["hist_mask"] = np.ones_like(b["hist_mask"])
    if candidates:
        rng = np.random.default_rng(seed + 100)
        b = {"hist": b["hist"][:1], "hist_mask": b["hist_mask"][:1],
             "candidates": rng.integers(0, cfg.n_items, candidates)
             .astype(np.int32)}
    return b


def _both(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in b.items()})


# ---------------------------------------------------------------------------
# configs, cells and the batch stream
# ---------------------------------------------------------------------------

def test_configs_and_cells_match_the_reference():
    for make in ("make_config", "make_smoke_config"):
        j, t = getattr(jcfg, make)(), getattr(tcfg, make)()
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert str(td.pop("dtype")).split(".")[-1] == \
            jnp.dtype(jd.pop("dtype")).name
        assert td == jd
    assert RECSYS_SHAPES == jfam.RECSYS_SHAPES
    assert tcfg.make_config().n_items == 2 ** 21


@pytest.mark.parametrize("n_items,batch,hist_len,seed,step", [
    (1024, 32, 10, 0, 0), (1024, 32, 10, 0, 7), (1024, 17, 10, 3, 2),
    (2 ** 21, 512, 50, 0, 0), (2 ** 21, 64, 50, 5, 11)])
def test_recsys_batch_fn_is_bitwise_the_reference(n_items, batch, hist_len,
                                                  seed, step):
    want = jpipe.recsys_batch_fn(n_items, batch, hist_len, seed=seed)(step)
    got = recsys_batch_fn(n_items, batch, hist_len, seed=seed,
                          device="cpu")(step)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == getattr(torch, v.dtype.name)
        np.testing.assert_array_equal(np_(got[k]), v)
    # a history of hist_len // 2 to hist_len live slots, then padding
    lengths = np_(got["hist_mask"]).sum(1)
    assert lengths.min() >= hist_len // 2 and lengths.max() <= hist_len


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_has_the_reference_tree():
    """Leaves, shapes, types, and each leaf's spread: the table's 0.02,
    ``s_matrix``'s 1 / sqrt(D), ``routing_init``'s 1 / sqrt(K) (fan in
    ``shape[0]``, as the reference draws it), float32."""
    cfg = dataclasses.replace(tcfg.make_smoke_config(), n_items=8192,
                              embed_dim=64)
    jc = dataclasses.replace(jcfg.make_smoke_config(), n_items=8192,
                             embed_dim=64)
    jp = jmind.init_params(jax.random.PRNGKey(0), jc)
    tp = tmind.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
        ratio = float(tp[k].std()) / float(np.asarray(jp[k]).std())
        assert abs(ratio - 1) < 0.1, (k, ratio)
    assert abs(float(tp["routing_init"].std()) - 4 ** -0.5) < 0.1


def test_params_from_numpy_checks_its_keys():
    jp, _ = _weights()
    host = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="MIND param tree"):
        tmind.mind_params_from_numpy({**host, "extra": host["s_matrix"]},
                                     device="cpu")


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_interest_capsules_and_serving(masked):
    jp, tp = _weights()
    jc, tc = _cfgs()
    jb, tb = _both(_batch(masked=masked))
    want = jmind.interest_capsules(jp, jb["hist"], jb["hist_mask"], jc)
    got = tmind.interest_capsules(tp, tb["hist"], tb["hist_mask"], tc)
    assert got.shape == (32, 4, 16) and got.dtype == torch.float32
    _close(got, want)
    _close(tmind.serve_interests(tp, tb, tc),
           jmind.serve_interests(jp, jb, jc))


def test_masked_slots_are_inert():
    """A masked slot's item id changes nothing (its routing logit is
    pushed to -1e30, its vector is 0), and nothing is NaN."""
    _, tp = _weights()
    _, tc = _cfgs()
    _, tb = _both(_batch())
    other = {**tb, "hist": torch.where(tb["hist_mask"] > 0, tb["hist"],
                                       (tb["hist"] + 1) % tc.n_items)}
    a = tmind.serve_interests(tp, tb, tc)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(tmind.serve_interests(tp, other, tc), a,
                               rtol=0, atol=0)


@pytest.mark.parametrize("pow_p", [1.0, 2.0, 3.0])
def test_label_aware_user_vector(pow_p):
    """Both branches of the reference's attention sharpness: att ** p at
    p == 1, sign(att) |att| ** p otherwise."""
    jc, tc = _cfgs(pow_p=pow_p)
    rng = np.random.default_rng(1)
    iv = rng.standard_normal((8, 4, 16)).astype(np.float32)
    tgt = rng.standard_normal((8, 16)).astype(np.float32)
    _close(tmind.label_aware_user_vector(torch.from_numpy(iv),
                                         torch.from_numpy(tgt), tc),
           jmind.label_aware_user_vector(jnp.asarray(iv), jnp.asarray(tgt),
                                         jc))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_train_loss_and_retrieval(masked):
    jp, tp = _weights()
    jc, tc = _cfgs()
    jb, tb = _both(_batch(masked=masked))
    got = tmind.train_loss(tp, tb, tc)
    want = jmind.train_loss(jp, jb, jc)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    jb, tb = _both(_batch(masked=masked, candidates=3000))
    got = tmind.retrieval_scores(tp, tb, tc)
    assert got.shape == (3000,)
    _close(got, jmind.retrieval_scores(jp, jb, jc))


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_gradients_match_jax_grad(masked):
    """Each parameter's gradient of the training loss within 1e-5 of its
    largest entry; the table's rows no batch item touches get exact
    zeros in both."""
    jp, tp = _weights()
    jc, tc = _cfgs()
    jb, tb = _both(_batch(masked=masked))
    want = jax.grad(lambda p: jmind.train_loss(p, jb, jc))(jp)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    grads = dict(zip(leaves, torch.autograd.grad(
        tmind.train_loss(leaves, tb, tc), list(leaves.values()))))
    for k in jp:
        _close(grads[k], want[k])
    touched = np.zeros(tc.n_items, bool)
    touched[np.concatenate([np.asarray(jb["hist"]).ravel(),
                            np.asarray(jb["target"])])] = True
    assert not np_(grads["item_embed"])[~touched].any()
    assert not np.asarray(want["item_embed"])[~touched].any()


def test_three_train_steps_match_jax():
    """Three AdamW steps through each package's ``make_train_step``, a
    new batch a step: the loss at rtol 1e-5, the parameters at atol
    1e-5."""
    jp, tp = _weights(seed=2)
    jc, tc = _cfgs()
    jfn = jax.jit(jstep.make_train_step(
        lambda p, b: jmind.train_loss(p, b, jc), jopt.AdamWConfig()))
    tfn = tstep.make_train_step(lambda p, b: tmind.train_loss(p, b, tc),
                                topt.AdamWConfig())
    jstate, tstate = jopt.init_state(jp), topt.init_state(tp)
    for step in range(3):
        jb, tb = _both(_batch(step=step))
        jp, jstate, jm = jfn(jp, jstate, jb)
        tp, tstate, tm = tfn(tp, tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        tl, jl = tree_leaves(tp), jax.tree.leaves(jp)
        assert len(tl) == len(jl) == 3
        for t, j in zip(tl, jl):
            np.testing.assert_allclose(np_(t), np.asarray(j), rtol=0,
                                       atol=1e-5)
