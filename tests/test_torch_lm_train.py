"""The port's LM training slice on the CPU against the JAX package:
``lm_loss`` and its gradients (``jax.value_and_grad`` of
``repro.models.transformer.lm_loss``) on llama-, gemma3- (local layers of
window 8 over a 32-token prompt, 2 groups and a remainder) and granite-
smoke (MoE, its aux loss included), and on a narrow llama-shaped config
whose prompt spans 4 ``attn_chunk``s (the JAX side on
``masked_chunk_attention``, remat on); the sequence-chunked loss against
JAX's and against the unchunked one; ``lm_batch_fn`` bitwise; three
``make_train_step`` steps, plain and with ``microbatch=2``, against
JAX's; remat off, "full", "save_qkv" and "save_proj" bitwise alike; the
in-place (donating) AdamW bitwise the functional one; and
``launch/train.py --smoke`` resuming bitwise from its checkpoint.
Weights go across with ``lm_params_from_numpy``, inputs are seeded
numpy.

Tolerances, float32 throughout: losses within rtol 1e-5 (the same
float32 expressions summed in other orders); each gradient leaf within
GRAD_REL = 1e-4 of its own norm in L2 (a leaf's entries are sums over
every token, whose float32 order differs); parameters after 3 AdamW
steps within PARAM_ATOL = 1e-5 (lr 3e-4: Adam's g / (|g| + eps) turns a
gradient gap of 1e-4 of a leaf into at most ~lr x 1e-4 a step where |g|
is not near eps, and the gap seen is ~1e-7).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.gemma3_27b as jgemma
import repro.configs.granite_moe_3b_a800m as jgranite
import repro.configs.llama3_2_3b as jllama
import repro.data.pipeline as jpipe
import repro.models.transformer as jt
import repro.optim.adamw as jadam
import repro.train.step as jstep
import repro_torch.configs.gemma3_27b as tgemma
import repro_torch.configs.granite_moe_3b_a800m as tgranite
import repro_torch.configs.llama3_2_3b as tllama
import repro_torch.data as tdata
import repro_torch.models.transformer as tt
import repro_torch.optim as topt
import repro_torch.train as tstep
from repro_torch.checkpoint import restore_arrays
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.tree import tree_leaves, tree_unflatten
from _torch_parity import np_

LOSS_RTOL, GRAD_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
# the JAX side's compiles at XLA's lowest backend optimization: a third
# of the compile time, the same float32 operations (the losses move by
# ~1e-7 relative)
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _jit(fn, *args):
    """``fn`` compiled for ``args`` with FAST_COMPILE."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _narrow(mod, dtype):
    """llama-shaped and narrow: 2 layers, 6/2 heads of 32, vocab 300
    (padded to 512: the loss masks 212 columns), attn_chunk 32, remat
    on (the config's default)."""
    return mod.TransformerConfig(
        name="llama-narrow", n_layers=2, d_model=128, n_heads=6,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab=300,
        rope_theta=500_000.0, dtype=dtype, attn_impl="chunk", attn_chunk=32)


CONFIGS = {
    # (JAX config, port config, sequence length)
    "llama_smoke": (jllama.make_smoke_config(), tllama.make_smoke_config(),
                    32),
    "gemma3_smoke": (jgemma.make_smoke_config(), tgemma.make_smoke_config(),
                     32),
    "granite_smoke": (jgranite.make_smoke_config(),
                      tgranite.make_smoke_config(), 32),
    # S = 128 = 4 chunks of 32: the JAX side on masked_chunk_attention
    "narrow": (_narrow(jt, jnp.float32), _narrow(tt, torch.float32), 128),
}


@functools.lru_cache(maxsize=None)
def _setup(name, batch=2):
    """(JAX config, port config, JAX params, port params, batch).  The
    weights are drawn by the port's ``init_params`` on the CPU (JAX's
    jitted init would cost a compile a config), checked against the
    shapes and types of the reference's tree (``jax.eval_shape``: no
    compile), and carried across as numpy: to JAX as arrays, to the port
    through ``lm_params_from_numpy``."""
    jc, tc, s = CONFIGS[name]
    drawn = jax.tree.map(lambda t: t.numpy(), tt.init_params(
        torch.Generator().manual_seed(0), tc, device="cpu"))
    jp = jax.tree.map(jnp.asarray, drawn)
    want = jax.eval_shape(lambda k: jt.init_params(k, jc),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(jp) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(jp)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(want)]
    tp = lm_params_from_numpy(drawn, device="cpu")
    z = np.random.default_rng(1).integers(0, jc.vocab, (batch, s + 1))
    z = z.astype(np.int32)
    return jc, tc, jp, tp, {"tokens": z[:, :-1], "targets": z[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_value_and_grad(tp, batch, tc):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(tp)]
    loss = tt.lm_loss(tree_unflatten(tp, leaves), _tbatch(batch), tc)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(name, loss_chunk=0):
    jc, _, jp, _, batch = _setup(name)
    jc = dataclasses.replace(jc, loss_chunk=loss_chunk)
    args = jp, _jbatch(batch)
    loss, grads = _jit(jax.value_and_grad(
        lambda p, b: jt.lm_loss(p, b, jc)), *args)(*args)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _grad_gap(got, want):
    """The largest L2 gap of a leaf, relative to its norm."""
    gap = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np_(g).astype(np.float64) - w)
        gap = max(gap, d / max(np.linalg.norm(w), 1e-30))
    return gap


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_loss_and_gradients_match_jax(name):
    jc, tc, _, tp, batch = _setup(name)
    want, wgrads = _jax_value_and_grad(name)
    got, grads = _port_value_and_grad(tp, batch, tc)
    assert len(grads) == len(wgrads)
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    assert _grad_gap(grads, wgrads) <= GRAD_REL
    if tc.moe is not None:      # the aux loss is in the value
        _, aux = tt.forward(tp, _tbatch(batch)["tokens"], tc)
        assert float(aux) > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chunked_loss_matches_the_unchunked_loss(name):
    """``loss_chunk`` of a quarter of the sequence: the port's chunked
    loss and gradients against its unchunked ones (the same value and
    gradients up to the order of the sum over tokens); and, on the
    narrow config (212 padded vocab columns masked, remat on), against
    JAX's chunked loss."""
    _, tc, _, tp, batch = _setup(name)
    cs = batch["tokens"].shape[1] // 4
    got, grads = _port_value_and_grad(
        tp, batch, dataclasses.replace(tc, loss_chunk=cs))
    if name == "narrow":
        want, jgrads = _jax_value_and_grad(name, cs)
        assert abs(got - want) <= LOSS_RTOL * abs(want)
        assert _grad_gap(grads, jgrads) <= GRAD_REL
    whole, wgrads = _port_value_and_grad(tp, batch, tc)
    assert abs(got - whole) <= LOSS_RTOL * abs(whole)
    assert _grad_gap(grads, [np_(g) for g in wgrads]) <= GRAD_REL
    with pytest.raises(ValueError, match="does not divide"):
        tt.lm_loss(tp, _tbatch(batch),
                   dataclasses.replace(tc, loss_chunk=cs - 1))


def test_lm_batch_fn_is_the_reference_bitwise():
    for args in ((211, 3, 17, 0), (128256, 2, 64, 5)):
        mine, ref = tdata.lm_batch_fn(*args), jpipe.lm_batch_fn(*args)
        for step in (0, 1, 7):
            a, b = mine(step), ref(step)
            assert sorted(a) == sorted(b) == ["targets", "tokens"]
            for key in a:
                assert a[key].dtype == b[key].dtype == np.int32
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("microbatch", [None, 2])
def test_three_train_steps_match_jax(microbatch):
    """llama's smoke config, 3 AdamW steps on ``lm_batch_fn``'s batches
    (B = 4): each step's loss and the parameters after the third against
    ``repro.train.step.make_train_step``'s, plain and accumulating over 2
    microbatches; the donating step is bitwise the functional one."""
    jc, tc, jp, tp, _ = _setup("llama_smoke")
    make = jpipe.lm_batch_fn(jc.vocab, 4, 32, seed=3)
    jopt, topt_cfg = jadam.AdamWConfig(), topt.AdamWConfig()
    jstate = jadam.init_state(jp)
    jfn = _jit(jstep.make_train_step(lambda p, b: jt.lm_loss(p, b, jc),
                                     jopt, microbatch=microbatch),
               jp, jstate, _jbatch(make(0)))
    tfn = tstep.make_train_step(lambda p, b: tt.lm_loss(p, b, tc), topt_cfg,
                                microbatch=microbatch)
    dfn = tstep.make_train_step(lambda p, b: tt.lm_loss(p, b, tc), topt_cfg,
                                microbatch=microbatch, donate=True)
    params, state = tp, topt.init_state(tp)
    dparams = tree_unflatten(tp, [t.clone() for t in tree_leaves(tp)])
    dstate = topt.init_state(dparams)
    for step in range(3):
        batch = make(step)
        jp, jstate, jm = jfn(jp, jstate, _jbatch(batch))
        params, state, tm = tfn(params, state, _tbatch(batch))
        dparams, dstate, dm = dfn(dparams, dstate, _tbatch(batch))
        want = float(jm["loss"])
        assert abs(float(tm["loss"]) - want) <= LOSS_RTOL * abs(want)
        assert torch.equal(dm["loss"], tm["loss"])
    for t, d, j in zip(tree_leaves(params), tree_leaves(dparams),
                       jax.tree.leaves(jp)):
        np.testing.assert_allclose(np_(t), np.asarray(j), rtol=0,
                                   atol=PARAM_ATOL)
        assert torch.equal(t, d)


@pytest.mark.parametrize("policy", ["full", "save_qkv", "save_proj"])
@pytest.mark.parametrize("name", ["gemma3_smoke", "granite_smoke"])
def test_remat_policies_give_the_same_gradients(name, policy):
    """Remat changes memory, never values: each policy's loss and
    gradients bitwise remat off's (gemma3: groups of 3 under remat and a
    remainder layer outside; granite: MoE layers)."""
    _, tc, _, tp, batch = _setup(name)
    off = _port_value_and_grad(tp, batch, dataclasses.replace(
        tc, remat=False))
    on = _port_value_and_grad(tp, batch, dataclasses.replace(
        tc, remat=True, remat_policy=policy))
    assert on[0] == off[0]
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        dataclasses.replace(tllama.make_smoke_config(), remat_policy="some")


@pytest.mark.parametrize("clip", [1.0, None])
def test_inplace_adamw_is_the_functional_step_bitwise(clip):
    """``apply_updates_`` (in place, a slice of 1,000 elements at a time
    here) against ``apply_updates`` over 3 steps: float32 and bfloat16
    leaves, with and without clipping; every leaf bitwise, and the same
    tensors returned."""
    rng = np.random.default_rng(0)
    shapes = [(3, 700), (2, 41, 33), (5,)]

    def tensors(dtype):
        return [torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dtype) for s in shapes]

    params = {"a": tensors(torch.float32), "b": tensors(torch.bfloat16)}
    cfg = topt.AdamWConfig(grad_clip=clip)
    fparams, fstate = params, topt.init_state(params)
    iparams = tree_unflatten(params, [t.clone()
                                      for t in tree_leaves(params)])
    istate = topt.init_state(iparams)
    ileaves = tree_leaves(iparams)
    for _ in range(3):
        grads = tree_unflatten(params, [
            torch.from_numpy(3 * rng.standard_normal(t.shape).astype(
                np.float32)).to(t.dtype) for t in tree_leaves(params)])
        fparams, fstate, fm = topt.apply_updates(fparams, grads, fstate, cfg)
        out, istate, im = topt.apply_updates_(iparams, grads, istate, cfg,
                                              chunk=1000)
        assert out is iparams and torch.equal(fm["grad_norm"],
                                              im["grad_norm"])
    assert all(a is b for a, b in zip(tree_leaves(iparams), ileaves))
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(fstate[key]), tree_leaves(istate[key])):
            assert torch.equal(a, b)
    assert int(istate["step"]) == int(fstate["step"]) == 3
    for a, b in zip(tree_leaves(fparams), tree_leaves(iparams)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _final_step(root, step):
    arrays, got, _meta = restore_arrays(root, step=step)
    assert got == step
    return arrays


def test_train_launcher_resumes_bitwise(tmp_path, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``: 4
    steps in one run, and 2 then 2 more resumed from the step-2
    checkpoint, end on the same loss and the same checkpointed params
    and AdamW state, bitwise."""
    common = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "32",
              "--ckpt-every", "2", "--log-every", "1"]
    once = tlaunch.main(common + ["--steps", "4", "--ckpt",
                                  str(tmp_path / "a")])
    tlaunch.main(common + ["--steps", "2", "--ckpt", str(tmp_path / "b")])
    again = tlaunch.main(common + ["--steps", "4", "--ckpt",
                                   str(tmp_path / "b")])
    assert "resumed from step 2" in capsys.readouterr().out
    assert once == again and np.isfinite(once)
    a, b = _final_step(str(tmp_path / "a"), 4), _final_step(
        str(tmp_path / "b"), 4)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_train_launcher_refuses_what_one_gpu_cannot_do(monkeypatch):
    with pytest.raises(NotImplementedError, match="16.4"):
        tlaunch.main(["--smoke", "--device", "cpu", "--compress", "int8"])
    with pytest.raises(SystemExit):
        tlaunch.lm_config("graphsage-reddit")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="16.5"):
        tlaunch._check_one_device(torch.device("cuda"))
    assert tlaunch.lm_config("gemma3-27b").n_layers == 62


def test_train_launcher_stores_bfloat16_leaves_bitwise(tmp_path):
    """The launcher's checkpoints keep bfloat16 params (the full-width
    configs' type): saved and restored through the store's
    ``CheckpointManager``, every leaf comes back in its type, bitwise,
    and the manifest names the type."""
    import json
    from repro_torch.checkpoint import CheckpointManager
    tree = {"w": torch.randn(3, 5).bfloat16(), "m": torch.randn(3, 5),
            "step": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    mgr.maybe_save(1, tree)
    mgr.wait()
    got, step, _ = mgr.restore_or_none(tree, device="cpu")
    assert step == 1 and sorted(got) == sorted(tree)
    for key in tree:
        assert got[key].dtype == tree[key].dtype
        assert torch.equal(got[key], tree[key])
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        # the leaves in key order: m, step, w
        assert json.load(f)["dtypes"] == ["float32", "int32", "bfloat16"]
