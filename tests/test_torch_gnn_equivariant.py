"""The port's equivariant GNNs (EGNN, NequIP, MACE) on the CPU against the
JAX package, with the JAX weights carried across by the converters: the
forward (features per l, energy, positions), the gradient of every leaf
in ``jax.tree.leaves`` order, 3 AdamW steps against ``repro.train.step``,
the bf16 EGNN route, the masked edge sums, configs, init and converters.
On the CPU every message sum runs the plain version of the
gather-segment-sum kernel.  The port's own properties are in
``test_torch_gnn_equivariant_props.py``.

Tolerances (float32; the two packages sum in their own orders):
forward outputs within 1e-5 of each tensor's largest entry (measured
gaps 2e-7 to 1.1e-6; MACE's cubic B3 makes an absolute bound
meaningless); gradients within 1e-5 of each leaf's largest entry
(measured up to 2.7e-6); 3 AdamW steps: loss rtol 1e-5, parameters atol
1e-5 (measured 1.4e-6), as GraphSAGE's test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.egnn as jcfg_egnn
import repro.configs.mace as jcfg_mace
import repro.configs.nequip as jcfg_nequip
import repro.models.gnn.irreps as ji
import repro.models.gnn.message_passing as jmp
import repro.models.gnn.models as jm
import repro.optim.adamw as jopt
import repro.train.step as jstep
import repro_torch.configs.egnn as tcfg_egnn
import repro_torch.configs.mace as tcfg_mace
import repro_torch.configs.nequip as tcfg_nequip
import repro_torch.models.gnn as tg
import repro_torch.optim as topt
import repro_torch.train as tstep
from repro_torch.configs._families import GNN_SHAPES
from repro_torch.kernels.segsum import ops as segsum_ops
from repro_torch.tree import tree_leaves, tree_unflatten
from _torch_gnn_models import MODELS, NAMES, carry as _carry, jbatch
from _torch_gnn_models import outputs as _outputs
from _torch_parity import batch_to_port, np_

FWD_REL = 1e-5
GRAD_REL = 1e-5
STEP_LOSS_RTOL = 1e-5
STEP_PARAM_ATOL = 1e-5


JB = jbatch()
_CACHE: dict = {}


def _jax_loss_and_forward(name, p, b, cfg):
    """The JAX loss (graph regression, n_classes 0) with the forward's
    outputs as its aux: one compile gives the forward and the gradients.
    The loss is ``*_loss``'s, from the same forward."""
    out = MODELS[name].j("forward")(p, b, cfg)
    energy = out[0].astype(jnp.float32) @ p["head"] if name == "egnn" \
        else out[1]
    return jmp.graph_regression_loss(energy[:, 0], b), out


def _jax(name: str) -> dict:
    """The JAX side of one model, computed once per module: params,
    forward, loss, its gradients and 3 AdamW steps through
    ``repro.train.step`` (two compiles)."""
    if name not in _CACHE:
        m = MODELS[name]
        jp = m.j("init")(jax.random.PRNGKey(1), m.jcfg)
        (loss, fwd), grads = jax.jit(jax.value_and_grad(
            lambda p, b: _jax_loss_and_forward(name, p, b, m.jcfg),
            has_aux=True))(jp, JB)
        step = jax.jit(jstep.make_train_step(
            lambda p, b: m.j("loss")(p, b, m.jcfg), jopt.AdamWConfig()))
        p, s, steps = jp, jopt.init_state(jp), []
        for _ in range(3):
            p, s, met = step(p, s, JB)
            steps.append((p, float(met["loss"])))
        # the first step's loss is *_loss's at the same params
        np.testing.assert_allclose(steps[0][1], float(loss), rtol=1e-6)
        _CACHE[name] = dict(params=jp, forward=fwd, loss=float(loss),
                            grads=grads, steps=steps)
    return _CACHE[name]


def _close_rel(got, want, rel, what):
    got = np_(got).astype(np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max())
    assert gap <= rel * scale, f"{what}: max |diff| {gap} > {rel} x {scale}"


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_with_carried_weights(name):
    ref = _jax(name)
    m = MODELS[name]
    got = m.t("forward")(_carry(name, ref["params"]), batch_to_port(JB),
                         m.tcfg)
    want = _outputs(name, ref["forward"])
    have = _outputs(name, got)
    assert [k for k, _ in have] == [k for k, _ in want]
    for (k, g), (_, w) in zip(have, want):
        _close_rel(g, w, FWD_REL, f"{name} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_loss_gradients_match_jax_on_every_leaf(name):
    """Every leaf, in ``jax.tree.leaves`` order; the leaves no path
    reaches (the first layer's radial MLPs of l1 > 0) are exactly zero
    in both."""
    ref = _jax(name)
    m = MODELS[name]
    tp = _carry(name, ref["params"])
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss = m.t("loss")(tree_unflatten(tp, leaves), batch_to_port(JB), m.tcfg)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree.leaves(ref["grads"])
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        w = np.asarray(w)
        if not np.abs(w).any():
            assert g is None or not bool(g.any()), f"{name} leaf {i}"
            continue
        _close_rel(g, w, GRAD_REL, f"{name} leaf {i} {w.shape}")


@pytest.mark.parametrize("name", NAMES)
def test_three_adamw_steps_match_jax(name):
    ref = _jax(name)
    m = MODELS[name]
    fn = tstep.make_train_step(lambda p, b: m.t("loss")(p, b, m.tcfg),
                               topt.AdamWConfig())
    tp = _carry(name, ref["params"])
    state = topt.init_state(tp)
    tb = batch_to_port(JB)
    for jp, jloss in ref["steps"]:
        tp, state, met = fn(tp, state, tb)
        np.testing.assert_allclose(float(met["loss"]), jloss,
                                   rtol=STEP_LOSS_RTOL)
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(np_(t), np.asarray(j), rtol=0,
                                       atol=STEP_PARAM_ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_classification_head_matches_jax(name):
    """n_classes > 0: the node-classification loss on the same weights."""
    m = MODELS[name]
    jc = dataclasses.replace(m.jcfg, n_classes=5)
    tc = dataclasses.replace(m.tcfg, n_classes=5)
    jp = m.j("init")(jax.random.PRNGKey(2), jc)
    want = float(jax.jit(lambda p, b: m.j("loss")(p, b, jc))(jp, JB))
    got = float(m.t("loss")(_carry(name, jp), batch_to_port(JB), tc))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# bf16 EGNN: JAX sums bf16 messages in bf16, K4 and its plain version in
# float32 rounded once, so neither route is held to the other's bits.
# Both are held to the float32 forward on the same weights: each output
# within BF16_REL of the float32 tensor's largest entry.  Two bf16
# layers of width 16 leave about 2^-8 (bf16's unit) times a few
# roundings a layer: the measured distances are 0.005-0.015 (h) and
# 0.003-0.009 (positions); 0.05 is ~3x the largest.
BF16_REL = 0.05


def test_bf16_egnn_routes_are_held_to_the_float32_forward():
    m = MODELS["egnn"]
    jc = dataclasses.replace(m.jcfg, agg_dtype="bf16")
    tc = dataclasses.replace(m.tcfg, agg_dtype="bf16")
    ref = _jax("egnn")
    tp = _carry("egnn", ref["params"])
    tb = batch_to_port(JB)
    dtypes = []
    real = segsum_ops._apply

    def spy(ids, seg, w, table, *args):
        dtypes.append(table.dtype)
        return real(ids, seg, w, table, *args)

    segsum_ops._apply = spy
    try:
        port = tg.egnn_forward(tp, tb, tc)
    finally:
        segsum_ops._apply = real
    # the message sums take the bf16 table, the coordinate means float32
    assert dtypes == [torch.bfloat16, torch.float32] * m.tcfg.n_layers
    jbf = jax.jit(lambda p, b: jm.egnn_forward(p, b, jc))(ref["params"], JB)
    assert port[0].dtype == torch.bfloat16 and port[1].dtype == torch.float32
    for k, (want, a, b) in enumerate(zip(ref["forward"], port, jbf)):
        _close_rel(a.float(), want, BF16_REL, f"port bf16 output {k}")
        _close_rel(np.asarray(b, np.float32), want, BF16_REL,
                   f"JAX bf16 output {k}")
    # and a step trains through the bf16 sums
    fn = tstep.make_train_step(lambda p, b: tg.egnn_loss(p, b, tc),
                               topt.AdamWConfig())
    _, _, met = fn(tp, topt.init_state(tp), tb)
    np.testing.assert_allclose(float(met["loss"]), ref["steps"][0][1],
                               rtol=BF16_REL)


def test_edge_sums_match_jax_masked_sums():
    """``scatter_edges`` and ``scatter_edges_mean`` against the JAX
    package's ``scatter_dst(m * mask)`` and ``scatter_mean`` on a mask
    with zeros, float32 and the bf16 table (float32 sum, one rounding)."""
    rng = np.random.default_rng(4)
    mask = (rng.random(160) < 0.7).astype(np.float32)
    jb = dataclasses.replace(JB, edge_mask=jnp.asarray(mask))
    tb = batch_to_port(jb)
    msgs = rng.standard_normal((160, 7)).astype(np.float32)
    want = np.asarray(jmp.scatter_dst(jnp.asarray(msgs) * mask[:, None],
                                      jb.dst, 40))
    got = tg.scatter_edges(torch.from_numpy(msgs), tb)
    np.testing.assert_allclose(np_(got), want, rtol=1e-6, atol=1e-6)
    want_mean = np.asarray(jmp.scatter_mean(jnp.asarray(msgs), jb.dst, 40,
                                            jb.edge_mask))
    np.testing.assert_allclose(np_(tg.scatter_edges_mean(
        torch.from_numpy(msgs), tb)), want_mean, rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(msgs).to(torch.bfloat16)
    got_bf = tg.scatter_edges(bf, tb)
    assert got_bf.dtype == torch.bfloat16
    exact = np.array(jmp.scatter_dst(
        jnp.asarray(np_(bf.float())) * mask[:, None], jb.dst, 40))
    assert torch.equal(got_bf, torch.from_numpy(exact).to(torch.bfloat16))


_JCFG = {"egnn": jcfg_egnn, "nequip": jcfg_nequip, "mace": jcfg_mace}
_TCFG = {"egnn": tcfg_egnn, "nequip": tcfg_nequip, "mace": tcfg_mace}


@pytest.mark.parametrize("name", NAMES)
def test_configs_match_jax(name):
    j, t = _JCFG[name], _TCFG[name]
    for make in ("make_config", "make_smoke_config"):
        assert dataclasses.asdict(getattr(t, make)()) == \
            dataclasses.asdict(getattr(j, make)())
    for shape in GNN_SHAPES.values():
        assert dataclasses.asdict(t.cfg_for_shape(t.make_config(), shape)) \
            == dataclasses.asdict(j.cfg_for_shape(j.make_config(), shape))


@pytest.mark.parametrize("name", NAMES)
def test_init_shapes_keys_and_scale_match_jax(name):
    """The port's init at full width: the JAX tree's keys (int and tuple
    keys kept), its leaves' shapes in ``jax.tree.leaves`` order, float32;
    the per-l mixers of a layer equal (one draw, as the JAX package's one
    key) but distinct tensors."""
    t = _TCFG[name]
    cfg = t.cfg_for_shape(t.make_config(), GNN_SHAPES["molecule"])
    params = getattr(tg, f"{name}_init")(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
    jcfg = _JCFG[name].cfg_for_shape(_JCFG[name].make_config(),
                                     GNN_SHAPES["molecule"])
    jshape = jax.eval_shape(lambda: MODELS[name].j("init")(
        jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(jshape) == jax.tree.structure(
        jax.tree.map(lambda t: 0, params, is_leaf=lambda x: isinstance(
            x, torch.Tensor)))
    assert [tuple(p.shape) for p in tree_leaves(params)] == \
        [tuple(s.shape) for s in jax.tree.leaves(jshape)]
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    for lp in params["layers"]:
        for key in ("mix", "mix_a", "mix_b2", "mix_b3"):
            if key in lp:
                mats = [lp[key][l] for l in sorted(lp[key])]
                assert all(torch.equal(mats[0], x) for x in mats)
                assert len({x.data_ptr() for x in mats}) == len(mats)


def test_converters_refuse_another_models_tree():
    jp = jm.nequip_init(jax.random.PRNGKey(0), MODELS["nequip"].jcfg)
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="MACE"):
        tg.mace_params_from_numpy(tree, device="cpu")
    with pytest.raises(ValueError, match="EGNN"):
        tg.egnn_params_from_numpy(tree, device="cpu")
    got = tg.nequip_params_from_numpy(tree, device="cpu")
    assert sorted(got["layers"][0]["radial"]) == ji.paths()
    assert sorted(got["layers"][0]["mix"]) == [0, 1, 2]
