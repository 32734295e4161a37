"""The port's GraphSAGE slice on the CPU against the JAX package: the
GraphBatch bridge, message passing, the model with its weights carried
across, AdamW and the train step.  On the CPU the neighbour sums run the
plain version of the gather-segment-sum kernel."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs._families as jfam
import repro.configs.graphsage_reddit as jcfg
import repro.core as jc
import repro.data.pipeline as jpipe
import repro.models.gnn.message_passing as jmp
import repro.models.gnn.models as jmod
import repro.optim.adamw as jopt
import repro.train.step as jstep
import repro_torch.configs.graphsage_reddit as tcfg
import repro_torch.models.gnn as tg
import repro_torch.optim as topt
import repro_torch.train as tstep
from repro_torch.configs._families import GNN_SHAPES
from repro_torch.data import graph_to_batch
from repro_torch.kernels import segsum
from repro_torch.models.common import dense_init
from repro_torch.tree import tree_leaves
from _torch_parity import batch_to_port, np_, to_port

CFG = jmod.SageConfig(d_in=16, d_hidden=32, n_classes=5)
TCFG = tg.SageConfig(d_in=16, d_hidden=32, n_classes=5)


def _jbatch(n=40, e=160, f=16, n_graphs=4, seed=0):
    """The batch of ``tests/test_gnn_models.py``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return jmp.GraphBatch(
        x=jnp.asarray(rng.standard_normal((n, f)), jnp.float32),
        z=jnp.asarray(rng.integers(0, 8, n), jnp.int32),
        pos=jnp.asarray(rng.standard_normal((n, 3)), jnp.float32),
        src=jnp.asarray(src), dst=jnp.asarray(dst),
        edge_mask=jnp.ones((e,), jnp.float32),
        node_mask=jnp.ones((n,), jnp.float32),
        labels=jnp.asarray(rng.integers(0, 5, n), jnp.int32),
        graph_id=jnp.asarray(rng.integers(0, n_graphs, n), jnp.int32),
        y=jnp.asarray(rng.standard_normal(n_graphs), jnp.float32),
        n_graphs=n_graphs,
    )


def _jparams(seed=0):
    return jmod.sage_init(jax.random.PRNGKey(seed), CFG)


def _carry(jparams):
    return tg.sage_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                     device="cpu")


def _assert_trees_close(tparams, jparams, **tol):
    tl, jl = tree_leaves(tparams), jax.tree.leaves(jparams)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        np.testing.assert_allclose(np_(t), np.asarray(j), **tol)


@pytest.mark.parametrize("pad", [None, (300, 2000)])
def test_graph_to_batch_is_bitwise_the_jax_batch(pad):
    jgraph = jc.rmat_graph(8, 4, seed=3)
    kw = {} if pad is None else dict(pad_nodes=pad[0], pad_edges=pad[1])
    want = jpipe.graph_to_batch(jgraph, d_feat=12, n_classes=7, seed=5, **kw)
    got = graph_to_batch(to_port(jgraph), d_feat=12, n_classes=7, seed=5,
                         device="cpu", **kw)
    assert got.n_graphs == want.n_graphs
    for name, t in got.tensors().items():
        j = np.asarray(getattr(want, name))
        assert np_(t).dtype == j.dtype, name
        np.testing.assert_array_equal(np_(t), j, err_msg=name)


def test_message_passing_ops_match_jax():
    jb = _jbatch()
    tb = batch_to_port(jb)
    h = np.random.default_rng(1).standard_normal((40, 24)).astype(np.float32)
    th = torch.from_numpy(h)
    np.testing.assert_array_equal(np_(tg.gather_src(th, tb.src)),
                                  np.asarray(jmp.gather_src(jnp.asarray(h),
                                                            jb.src)))
    msgs = np.random.default_rng(2).standard_normal((160, 6)).astype(
        np.float32)
    np.testing.assert_allclose(
        np_(tg.scatter_dst(torch.from_numpy(msgs), tb.dst, 40)),
        np.asarray(jmp.scatter_dst(jnp.asarray(msgs), jb.dst, 40)),
        rtol=1e-6, atol=1e-6)
    want = jmp.scatter_mean(jmp.gather_src(jnp.asarray(h), jb.src), jb.dst,
                            40, jb.edge_mask)
    np.testing.assert_allclose(np_(tg.scatter_mean(th, tb)), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    energy = np.random.default_rng(3).standard_normal(40).astype(np.float32)
    np.testing.assert_allclose(
        float(tg.graph_regression_loss(torch.from_numpy(energy), tb)),
        float(jmp.graph_regression_loss(jnp.asarray(energy), jb)), rtol=1e-6)
    logits = np.random.default_rng(4).standard_normal((40, 5)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(tg.node_classification_loss(torch.from_numpy(logits), tb)),
        float(jmp.node_classification_loss(jnp.asarray(logits), jb)),
        rtol=1e-6)


def test_batch_caches_its_plan_and_count():
    tb = batch_to_port(_jbatch())
    plan = tb.segment_plan()
    assert tb.segment_plan() is plan and tb.in_count() is tb.in_count()
    assert (plan.n_segments, plan.n_rows, plan.n_entries) == (40, 40, 160)
    assert plan.transpose.ids is tb.dst
    np.testing.assert_array_equal(
        np_(tb.in_count())[:, 0],
        np.bincount(np_(tb.dst), minlength=40).astype(np.float32))


def test_sage_forward_matches_jax_with_carried_weights():
    jb, jp = _jbatch(), _jparams()
    want = np.asarray(jmod.sage_forward(jp, jb, CFG))
    got = tg.sage_forward(_carry(jp), batch_to_port(jb), TCFG)
    assert got.shape == (40, 5)
    np.testing.assert_allclose(np_(got), want, rtol=1e-5, atol=1e-6)


def test_sage_loss_gradients_match_jax_grad():
    jb, jp = _jbatch(), _jparams(1)
    want = jax.grad(lambda p: jmod.sage_loss(p, jb, CFG))(jp)
    tp = _carry(jp)
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss = tg.sage_loss(tp, batch_to_port(jb), TCFG)
    np.testing.assert_allclose(float(loss.detach()),
                               float(jmod.sage_loss(jp, jb, CFG)), rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    for g, j in zip(grads, jax.tree.leaves(want)):
        np.testing.assert_allclose(np_(g), np.asarray(j), rtol=1e-4,
                                   atol=1e-6)


def test_padded_edges_are_inert():
    """Padded edges (node 0 to node 0, mask 0) change no logit, in the
    port or in the JAX package."""
    jb, jp = _jbatch(), _jparams(2)
    pad = 96
    padded = dataclasses.replace(
        jb, src=jnp.concatenate([jb.src, jnp.zeros(pad, jnp.int32)]),
        dst=jnp.concatenate([jb.dst, jnp.zeros(pad, jnp.int32)]),
        edge_mask=jnp.concatenate([jb.edge_mask, jnp.zeros(pad)]))
    tp = _carry(jp)
    plain = tg.sage_forward(tp, batch_to_port(jb), TCFG)
    got = tg.sage_forward(tp, batch_to_port(padded), TCFG)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(np_(got),
                               np.asarray(jmod.sage_forward(jp, padded, CFG)),
                               rtol=1e-5, atol=1e-6)


def _grad_tree(seed, params):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.3,
        params)


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_matches_jax_for_three_steps(clip):
    """The two packages sum the squared gradients in their own reduction
    orders, so the clip scale, and through the moment updates' cancelling
    terms every later number, differ by float32 rounding (rtol 1e-5)."""
    cfg = jopt.AdamWConfig(grad_clip=clip)
    tcfg_ = topt.AdamWConfig(grad_clip=clip)
    jp = _jparams(3)
    jstate = jopt.init_state(jp)
    tp = _carry(jp)
    tstate = topt.init_state(tp)
    for k in range(3):
        jg = _grad_tree(10 + k, jp)
        jp, jstate, jm = jopt.apply_updates(jp, jg, jstate, cfg)
        tp, tstate, tm = topt.apply_updates(tp, _carry(jg), tstate, tcfg_)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for key in ("m", "v"):
            _assert_trees_close(tstate[key], jstate[key], rtol=1e-5,
                                atol=1e-8)
        _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)
        assert int(tstate["step"]) == int(jstate["step"]) == k + 1


def test_int8_compression_raises():
    tp = _carry(_jparams())
    with pytest.raises(NotImplementedError, match="SPMD"):
        topt.init_state(tp, compress=True)
    with pytest.raises(NotImplementedError, match="SPMD"):
        topt.apply_updates(tp, tp, topt.init_state(tp),
                           topt.AdamWConfig(compress="int8"))


def test_three_train_steps_match_jax():
    """Three AdamW steps of GraphSAGE: loss at rtol 1e-4, parameters at
    atol 1e-5; the embed_z rows of types the batch never uses get exactly
    zero gradients in both, so weight decay alone moves them, bitwise
    alike."""
    jb, jp = _jbatch(), _jparams(4)
    jfn = jax.jit(jstep.make_train_step(
        lambda p, b: jmod.sage_loss(p, b, CFG), jopt.AdamWConfig()))
    tfn = tstep.make_train_step(lambda p, b: tg.sage_loss(p, b, TCFG),
                                topt.AdamWConfig())
    tb = batch_to_port(jb)
    tp = _carry(jp)
    tstate = topt.init_state(tp)
    jstate = jopt.init_state(jp)
    unused = np.setdiff1d(np.arange(CFG.n_types), np.asarray(jb.z))
    start = np_(tp["embed_z"])[unused]
    for _ in range(3):
        jp, jstate, jm = jfn(jp, jstate, jb)
        tp, tstate, tm = tfn(tp, tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        _assert_trees_close(tp, jp, rtol=0, atol=1e-5)
    got_rows = np_(tp["embed_z"])[unused]
    np.testing.assert_array_equal(got_rows, np.asarray(jp["embed_z"])[unused])
    assert (got_rows != start).any()


def test_microbatch_accumulation_matches_jax():
    """Gradient accumulation over 2 slices of a dict batch, in float32."""
    rng = np.random.default_rng(6)
    xs = rng.standard_normal((8, 5)).astype(np.float32)
    ys = rng.standard_normal(8).astype(np.float32)
    w0 = {"w": rng.standard_normal(5).astype(np.float32),
          "b": np.zeros((), np.float32)}

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2)

    jfn = jstep.make_train_step(jloss, jopt.AdamWConfig(), microbatch=2)
    tfn = tstep.make_train_step(tloss, topt.AdamWConfig(), microbatch=2)
    jp = jax.tree.map(jnp.asarray, w0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in w0.items()}
    jp, _, jm = jfn(jp, jopt.init_state(jp),
                    {"x": jnp.asarray(xs), "y": jnp.asarray(ys)})
    tp, _, tm = tfn(tp, topt.init_state(tp),
                    {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    _assert_trees_close(tp, jp, rtol=1e-6, atol=1e-7)


def test_eval_step_is_the_loss_without_autograd():
    jb, jp = _jbatch(), _jparams(5)
    tp = _carry(jp)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    loss = tstep.make_eval_step(lambda p, b: tg.sage_loss(p, b, TCFG))(
        tp, batch_to_port(jb))
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jmod.sage_loss(jp, jb, CFG)),
                               rtol=1e-5)


def test_configs_match_jax():
    assert dataclasses.asdict(tcfg.make_config()) == dataclasses.asdict(
        jcfg.make_config())
    assert dataclasses.asdict(tcfg.make_smoke_config()) == \
        dataclasses.asdict(jcfg.make_smoke_config())
    for name, shape in GNN_SHAPES.items():
        assert shape == jfam.GNN_SHAPES[name]
        assert dataclasses.asdict(tcfg.cfg_for_shape(
            tcfg.make_config(), shape)) == dataclasses.asdict(
            jcfg.cfg_for_shape(jcfg.make_config(), shape))


def test_sage_init_shapes_and_scale():
    cfg = tcfg.cfg_for_shape(tcfg.make_config(), GNN_SHAPES["ogb_products"])
    params = tg.sage_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda: jmod.sage_init(jax.random.PRNGKey(0),
                               jmod.SageConfig(**dataclasses.asdict(cfg)))))
    assert [tuple(p.shape) for p in tree_leaves(params)] == \
        [tuple(s) for s in jax.tree.leaves(
            jshapes, is_leaf=lambda x: isinstance(x, tuple))]
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))
    w = dense_init(torch.Generator().manual_seed(1), (400, 300))
    assert w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) * 20.0 - 1.0) < 0.02


def test_small_graphsage_path_through_the_dispatcher():
    """The slice's path at a small size: graph, batch, one forward and a
    train step, with every neighbour sum through the dispatcher's plain
    route (no kernel launch on the CPU)."""
    graph = to_port(jc.rmat_graph(7, 4, seed=1))
    cfg = tcfg.cfg_for_shape(tcfg.make_smoke_config(),
                             dict(d_feat=8, classes=3))
    batch = graph_to_batch(graph, d_feat=8, n_classes=3, device="cpu")
    params = tg.sage_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = dict(segsum.launch_counts)
    logits = tg.sage_forward(params, batch, cfg)
    assert logits.shape == (graph.n_nodes, 3)
    assert torch.isfinite(logits).all()
    fn = tstep.make_train_step(lambda p, b: tg.sage_loss(p, b, cfg),
                               topt.AdamWConfig())
    params, _, metrics = fn(params, topt.init_state(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert segsum.launch_counts == before
