"""The port's equivariant GNNs on the CPU, their own properties: rotation
equivariance (mirroring ``tests/test_gnn_models.py``), padded edges
inert, the edge plan the batch caches, the one-call-a-layer message sum
bitwise one call per l, the gather-segment-sum calls of a forward and a
training step, and the molecules example."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.models.gnn as tg
import repro_torch.models.gnn.models as tmodels
import repro_torch.optim as topt
import repro_torch.train as tstep
from repro_torch.kernels.segsum import ops as segsum_ops
from _torch_gnn_models import MODELS, NAMES, carry, jbatch, outputs
from _torch_parity import batch_to_port, np_

JB = jbatch()


def test_partitioned_egnn_raises():
    m = MODELS["egnn"]
    tc = dataclasses.replace(m.tcfg, partitioned=True)
    tp = tg.egnn_init(torch.Generator().manual_seed(0), tc, device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        tg.egnn_forward(tp, batch_to_port(JB), tc)


def _rotated(batch, rot, shift=None):
    fields = batch.tensors()
    pos = batch.pos.double() @ torch.from_numpy(rot.T)
    if shift is not None:
        pos = pos + torch.from_numpy(shift)
    fields["pos"] = pos.float()
    return tg.GraphBatch(**fields, n_graphs=batch.n_graphs)


def test_egnn_is_equivariant():
    """h invariant; updated coordinates equivariant under E(n) (the JAX
    test's rotation, shift and tolerances)."""
    cfg = tg.EgnnConfig(d_hidden=32, n_layers=2)
    params = tg.egnn_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    tb = batch_to_port(JB)
    rot = tg.irreps.random_rotation(5)
    shift = np.array([0.3, -1.2, 0.7])
    h1, pos1 = tg.egnn_forward(params, tb, cfg)
    h2, pos2 = tg.egnn_forward(params, _rotated(tb, rot, shift), cfg)
    np.testing.assert_allclose(np_(h2), np_(h1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np_(pos2), np_(pos1) @ rot.T + shift,
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["nequip", "mace"])
def test_tensor_product_models_are_equivariant(name):
    """Energy invariant; the l-features rotate with D_l(R) (the JAX
    test's tolerances: energy 5e-4, features rtol 5e-3 atol 5e-4)."""
    cfg = {"nequip": tg.NequipConfig, "mace": tg.MaceConfig}[name](
        d_hidden=8, n_layers=2)
    params = getattr(tg, f"{name}_init")(torch.Generator().manual_seed(1),
                                         cfg, device="cpu")
    fwd = getattr(tg, f"{name}_forward")
    tb = batch_to_port(JB)
    rot = tg.irreps.random_rotation(7)
    feats1, e1 = fwd(params, tb, cfg)
    feats2, e2 = fwd(params, _rotated(tb, rot), cfg)
    np.testing.assert_allclose(np_(e2), np_(e1), rtol=5e-4, atol=5e-4)
    assert sorted(feats1) == [0, 1, 2]
    for l in feats1:
        want = np.einsum("ncx,yx->ncy", np_(feats1[l]),
                         tg.irreps.wigner_d(l, rot))
        np.testing.assert_allclose(np_(feats2[l]), want, rtol=5e-3,
                                   atol=5e-4)


def _padded(jbatch, extra_src, extra_dst):
    k = len(extra_src)
    return dataclasses.replace(
        jbatch, src=jnp.concatenate([jbatch.src, jnp.asarray(extra_src,
                                                              jnp.int32)]),
        dst=jnp.concatenate([jbatch.dst, jnp.asarray(extra_dst, jnp.int32)]),
        edge_mask=jnp.concatenate([jbatch.edge_mask, jnp.zeros(k)]))


@pytest.mark.parametrize("pad", ["garbage", "self_loops_at_0"])
@pytest.mark.parametrize("name", NAMES)
def test_padded_edges_are_inert(name, pad):
    """Zero-mask edges change no output: 32 random ones (the JAX test's)
    and ``graph_to_batch``'s padding, 32 self-loops at node 0."""
    jb = jbatch(e=128)
    rng = np.random.default_rng(9)
    if pad == "garbage":
        extra = rng.integers(0, 40, 32), rng.integers(0, 40, 32)
    else:
        extra = np.zeros(32, np.int32), np.zeros(32, np.int32)
    m = MODELS[name]
    tp = carry(name, m.j("init")(jax.random.PRNGKey(3), m.jcfg))
    plain = outputs(name, m.t("forward")(tp, batch_to_port(jb), m.tcfg))
    padded = outputs(name, m.t("forward")(
        tp, batch_to_port(_padded(jb, *extra)), m.tcfg))
    for (k, a), (_, b) in zip(plain, padded):
        np.testing.assert_allclose(np_(b), np_(a), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {k}")


def test_batch_caches_its_edge_plan():
    tb = batch_to_port(JB)
    plan = tb.edge_plan()
    assert tb.edge_plan() is plan and tb.edge_ids() is plan.ids
    assert (plan.n_segments, plan.n_rows, plan.n_entries) == (40, 160, 160)
    assert plan.n_hot == 0 and plan.transpose.n_hot == 0
    assert torch.equal(tb.edge_ids(), torch.arange(160, dtype=torch.int32))
    # the transpose: every edge row its own segment of one entry
    t = plan.transpose
    assert (t.n_segments, t.n_rows) == (160, 40)
    assert torch.equal(torch.diff(t.offsets), torch.ones(160,
                                                         dtype=torch.int64))
    assert tb.segment_plan() is not plan


def test_one_call_a_layer_is_bitwise_three_calls():
    """The per-l messages concatenated column-wise and summed in one call
    give the bits of one plain-route call per l."""
    rng = np.random.default_rng(6)
    mask = (rng.random(160) < 0.8).astype(np.float32)
    tb = batch_to_port(dataclasses.replace(JB, edge_mask=jnp.asarray(mask)))
    msgs = {l: torch.from_numpy(rng.standard_normal(
        (160, 5, 2 * l + 1)).astype(np.float32)) for l in (2, 0, 1)}
    got = tmodels._edge_sums(msgs, tb, use_kernel=False)
    assert list(got) == [0, 1, 2]
    for l, m in msgs.items():
        want = tg.scatter_edges(m.reshape(160, -1), tb, use_kernel=False)
        assert torch.equal(got[l], want.reshape(40, 5, 2 * l + 1)), l


def segsum_calls(name: str, cfg) -> tuple:
    """(calls a forward, calls a training step) of the gather-segment-sum
    dispatcher, from the design.  EGNN: a layer's message sum and its
    coordinate mean forward; backward, every message sum's transposed
    call and the coordinate means' of all layers but the last (its
    positions reach no loss).  NequIP and MACE: one call a layer each
    way."""
    L = cfg.n_layers
    if name == "egnn":
        if cfg.update_pos:
            return 2 * L, 2 * L + L + (L - 1)
        return L, 2 * L
    return L, 2 * L


@pytest.mark.parametrize("name,update_pos", [("egnn", True),
                                             ("egnn", False),
                                             ("nequip", True),
                                             ("mace", True)])
def test_segsum_calls_of_a_forward_and_a_step(name, update_pos, monkeypatch):
    m = MODELS[name]
    cfg = m.tcfg
    if name == "egnn":
        cfg = dataclasses.replace(cfg, update_pos=update_pos)
    calls = []
    real = segsum_ops._apply

    def counting(ids, seg, *args):
        calls.append(int(ids.shape[0]))
        return real(ids, seg, *args)

    monkeypatch.setattr(segsum_ops, "_apply", counting)
    params = getattr(tg, f"{name}_init")(torch.Generator().manual_seed(0),
                                         cfg, device="cpu")
    tb = batch_to_port(JB)
    fwd, step = segsum_calls(name, cfg)
    with torch.no_grad():
        m.t("forward")(params, tb, cfg)
    assert len(calls) == fwd
    calls.clear()
    fn = tstep.make_train_step(lambda p, b: m.t("loss")(p, b, cfg),
                               topt.AdamWConfig())
    fn(params, topt.init_state(params), tb)
    assert len(calls) == step
    assert set(calls) == {160}       # every call over the E edge entries


def test_example_runs_three_steps_on_the_cpu():
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "gnn_molecules_torch.py"
    spec = importlib.util.spec_from_file_location("gnn_molecules_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--steps", "3", "--device", "cpu"])
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    assert out["rotation_err"] < 1e-3
    # the example's molecules are the JAX example's draws
    b = mod.make_molecules(5)
    rng = np.random.default_rng((0, 5))
    np.testing.assert_array_equal(
        np_(b.pos), (rng.standard_normal((128, 3)) * 1.5).astype(np.float32))
