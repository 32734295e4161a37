"""The port's LM serving slice on the CPU against the JAX package: the
model substrate (rms_norm, swiglu, RoPE), dense and decode attention,
``forward`` with its MoE aux loss, ``prefill_step`` with its cache,
``decode_step`` and the greedy loop of ``examples/serve_lm_torch.py``,
with the JAX weights carried across by ``lm_params_from_numpy``, on
llama-, qwen2- (QKV bias), gemma3- (5 local : 1 global; its smoke config
has a remainder of one group) and MoE-shaped (granite's smoke config and
a narrow one with several routing groups and drops) configs, and two
narrow sliding-window configs whose prompt spans 4 ``attn_chunk``s, on
``masked_chunk_attention`` and on ``trapezoid_attention``.  On the CPU
every full-attention layer runs the flash-attention dispatcher's plain
route, and a local layer the reference's dispatch.

Tolerance, float32 throughout: rtol 1e-5, and for entries near zero an
atol of 1e-5 of the array's largest magnitude.  Both packages compute
the same float32 expressions; attention and the matmuls sum in other
orders (XLA's chunked online softmax against PyTorch's dense one),
which leaves gaps of ~2e-6 of the largest logit after two layers.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.gemma3_27b as jgemma
import repro.configs.granite_moe_3b_a800m as jgranite
import repro.configs.llama3_2_3b as jcfg
import repro.configs.moonshot_v1_16b_a3b as jmoonshot
import repro.configs.qwen2_7b as jqwen
import repro.models.attention as jatt
import repro.models.common as jcom
import repro.models.moe as jmoe
import repro.models.transformer as jt
import repro_torch.configs.gemma3_27b as tgemma
import repro_torch.configs.granite_moe_3b_a800m as tgranite
import repro_torch.configs.llama3_2_3b as tcfg
import repro_torch.configs.moonshot_v1_16b_a3b as tmoonshot
import repro_torch.configs.qwen2_7b as tqwen
import repro_torch.models.attention as tatt
import repro_torch.models.common as tcom
import repro_torch.models.moe as tmoe
import repro_torch.models.transformer as tt
from repro.configs._families import LM_SHAPES as J_LM_SHAPES
from repro_torch.configs._families import LM_SHAPES
from repro_torch.kernels import flashattn
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.tree import tree_leaves
from _torch_parity import np_

EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / \
    "serve_lm_torch.py"


def _close(got, want, rtol=1e-5, rel_atol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np_(got), want, rtol=rtol,
                               atol=rel_atol * float(np.abs(want).max()))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _narrow(mod, dtype, **kw):
    """llama-shaped and narrow: 2 layers, d_model 128, 6/2 heads of 32,
    d_ff 256, vocab 300 (padded to 512), the chunked JAX schedule."""
    args = dict(name="llama-narrow", n_layers=2, d_model=128, n_heads=6,
                n_kv_heads=2, head_dim=32, d_ff=256, vocab=300,
                rope_theta=500_000.0, dtype=dtype, attn_impl="chunk",
                attn_chunk=64)
    return mod.TransformerConfig(**{**args, **kw})


def _moe_narrow(mod, moe_mod, dtype):
    """The narrow config with an MoE FFN: 8 experts of width 64, top-2,
    groups of 64 rows at capacity factor 1.0 (capacity 24 against a mean
    load of 16), so a 2 x 128 prefill routes 4 groups and drops some
    choices."""
    return _narrow(mod, dtype, name="moe-narrow", d_ff=0,
                   moe=moe_mod.MoEConfig(n_experts=8, top_k=2, d_model=128,
                                         d_ff=64, capacity_factor=1.0,
                                         group_size=64))


CONFIGS = {
    # (JAX config, port config, prompt length)
    "smoke": (jcfg.make_smoke_config(), tcfg.make_smoke_config(), 48),
    # S = 128 > attn_chunk: the JAX side runs masked_chunk_attention
    "narrow": (_narrow(jt, jnp.float32), _narrow(tt, torch.float32), 128),
    # a sliding-window layer inside one chunk, then a global one
    "local_global": (
        _narrow(jt, jnp.float32, layer_pattern=("local", "global"),
                window=16, attn_impl="dense"),
        _narrow(tt, torch.float32, layer_pattern=("local", "global"),
                window=16, attn_impl="dense"), 48),
    "granite_smoke": (jgranite.make_smoke_config(),
                      tgranite.make_smoke_config(), 48),
    "moe_narrow": (_moe_narrow(jt, jmoe, jnp.float32),
                   _moe_narrow(tt, tmoe, torch.float32), 128),
    "qwen_smoke": (jqwen.make_smoke_config(), tqwen.make_smoke_config(), 48),
    # 7 layers: 2 groups of (local, local, global) and a local remainder
    "gemma3_smoke": (jgemma.make_smoke_config(), tgemma.make_smoke_config(),
                     48),
    # a sliding-window layer over 4 chunks of 16, then a global one: the
    # chunked schedules of the plain route, each against the reference's
    **{name: tuple(
        [_narrow(mod, dt, name=name, layer_pattern=("local", "global"),
                 window=20, attn_chunk=16, attn_trapezoid=trap)
         for mod, dt in ((jt, jnp.float32), (tt, torch.float32))] + [64])
       for name, trap in (("window_chunk", False),
                          ("window_trapezoid", True))},
}
ALL = ["smoke", "narrow", "local_global", "granite_smoke", "moe_narrow",
       "qwen_smoke", "gemma3_smoke", "window_chunk", "window_trapezoid"]


@functools.lru_cache(maxsize=None)
def _setup(name, batch=2, seed=0):
    """Configs, the JAX weights, the port's copy of them and a prompt
    (shared by the tests: none writes to them)."""
    jc, tc, s = CONFIGS[name]
    jp = jt.init_params(jax.random.PRNGKey(seed), jc)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(seed).integers(
        0, jc.vocab, (batch, s)).astype(np.int32)
    return jc, tc, jp, tp, tokens


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

def test_configs_match_the_reference():
    assert LM_SHAPES == J_LM_SHAPES
    for make in ("make_config", "make_smoke_config"):
        j, t = getattr(jcfg, make)(), getattr(tcfg, make)()
        for field in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                      "d_ff", "vocab", "head_dim", "layer_pattern", "window",
                      "qkv_bias", "rope_theta", "tie_embeddings",
                      "attn_impl", "attn_chunk", "hd", "vocab_pad",
                      "n_groups", "n_remainder"):
            assert getattr(t, field) == getattr(j, field), field
        assert t.flops_per_token_fwd() == j.flops_per_token_fwd()
        assert t.active_params() == j.active_params()
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    assert abs(tcfg.make_config().active_params() - 3.61e9) < 0.01e9


_CONFIG_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab", "head_dim", "layer_pattern", "window",
                  "qkv_bias", "rope_theta", "tie_embeddings", "attn_impl",
                  "attn_chunk", "hd", "vocab_pad", "n_groups", "n_remainder")


@pytest.mark.parametrize("jmod,tmod,active", [
    (jgranite, tgranite, 0.956e9), (jmoonshot, tmoonshot, 3.968e9),
    (jqwen, tqwen, 7.615e9)], ids=["granite", "moonshot", "qwen2"])
def test_moe_and_qwen2_configs_match_the_reference(jmod, tmod, active):
    """Field for field, the MoE config's fields included, with the
    analytic FLOPs a token and active parameters (the k routed experts a
    token runs) equal to the reference's."""
    for make in ("make_config", "make_smoke_config"):
        j, t = getattr(jmod, make)(), getattr(tmod, make)()
        for field in _CONFIG_FIELDS:
            assert getattr(t, field) == getattr(j, field), field
        if j.moe is None:
            assert t.moe is None
        else:
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
        assert t.flops_per_token_fwd() == j.flops_per_token_fwd()
        assert t.active_params() == j.active_params()
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    assert abs(tmod.make_config().active_params() - active) < 0.001e9


def test_moe_param_tree_in_bfloat16():
    """A bfloat16 MoE model: the router float32, every other leaf
    bfloat16, the experts' spread 1 / sqrt(n_experts) per leaf (the
    reference's fan in) stacked over the groups; and
    ``lm_params_from_numpy`` carries the JAX tree across with the same
    types, also when asked for a dtype."""
    jc = _moe_narrow(jt, jmoe, jnp.bfloat16)
    tc = _moe_narrow(tt, tmoe, torch.bfloat16)
    jp = jt.init_params(jax.random.PRNGKey(0), jc)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    moe = tp["groups"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert tuple(moe["w_gate"].shape) == (2, 8, 128, 64)
    for leaf in ("w_gate", "w_up", "w_down"):
        assert moe[leaf].dtype == torch.bfloat16
        assert abs(float(moe[leaf].float().std()) - 8 ** -0.5) < 0.01
    assert abs(float(moe["router"].std()) - 128 ** -0.5) < 0.01
    host = jax.tree.map(np.asarray, jp)
    for dtype in (None, torch.bfloat16, torch.float32):
        carried = lm_params_from_numpy(host, dtype=dtype, device="cpu")
        cm = carried["groups"][0]["moe"]
        assert cm["router"].dtype == torch.float32
        assert cm["w_up"].dtype == (dtype or torch.bfloat16)
        assert carried["embed"].dtype == (dtype or torch.bfloat16)
        np.testing.assert_array_equal(
            np_(cm["w_up"].float()),
            np.asarray(jp["groups"][0]["moe"]["w_up"].astype(jnp.float32)))
        np.testing.assert_array_equal(np_(cm["router"]),
                                      np.asarray(jp["groups"][0]["moe"]
                                                 ["router"]))


def test_gemma3_configs_match_the_reference():
    """Both gemma3 configs field for field: 62 layers in 10 groups of 6
    (5 local, 1 global) and 2 remainder layers, window 1024, 2.842e10
    parameters; the smoke config's 7 layers in 2 groups and 1."""
    for make in ("make_config", "make_smoke_config"):
        j, t = getattr(jgemma, make)(), getattr(tgemma, make)()
        for field in _CONFIG_FIELDS + ("attn_trapezoid", "remat"):
            assert getattr(t, field) == getattr(j, field), field
        assert t.moe is None and j.moe is None
        assert t.flops_per_token_fwd() == j.flops_per_token_fwd()
        assert t.active_params() == j.active_params()
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
    full = tgemma.make_config()
    assert (full.n_groups, full.n_remainder, full.window) == (10, 2, 1024)
    assert full.layer_pattern == ("local",) * 5 + ("global",)
    assert abs(full.active_params() - 2.842e10) < 0.001e10
    smoke = tgemma.make_smoke_config()
    assert (smoke.n_groups, smoke.n_remainder) == (2, 1)


def test_local_layer_routes(monkeypatch):
    """The plain route of a local layer follows the reference's dispatch:
    dense within one chunk or with ``attn_impl="dense"``, else the
    trapezoid or the masked chunk schedule; a global layer takes the
    flash-attention dispatcher's plain version.  ``use_kernel=True`` on
    the CPU raises for a local layer too."""
    _, tc, _, tp, tokens = _setup("window_chunk")
    calls = []
    for name in ("dense_attention", "masked_chunk_attention",
                 "trapezoid_attention", "flash_attention"):
        monkeypatch.setattr(tt, name, lambda *a, _n=name,
                            _real=getattr(tt, name), **kw:
                            calls.append(_n) or _real(*a, **kw))
    for cfg, s, local in [
            (tc, 64, "masked_chunk_attention"),
            (dataclasses.replace(tc, attn_trapezoid=True), 64,
             "trapezoid_attention"),
            (dataclasses.replace(tc, attn_impl="dense"), 64,
             "dense_attention"),
            (tc, 16, "dense_attention")]:
        calls.clear()
        tt.prefill_step(tp, torch.from_numpy(tokens[:, :s]), cfg)
        assert calls == [local, "flash_attention"], (cfg, s)
    with pytest.raises(ValueError, match="CUDA kernel"):
        tt.prefill_step(tp, torch.from_numpy(tokens), tc, use_kernel=True)


@pytest.mark.parametrize("kw,item", [
    (dict(param_sharding="fsdp"), "fsdp")])
def test_unported_options_raise(kw, item):
    with pytest.raises(NotImplementedError, match=f"{item}.*ROADMAP"):
        _narrow(tt, torch.float32, **kw)


@pytest.mark.parametrize("name", ALL)
def test_init_params_has_the_reference_tree(name):
    """Same leaves in the same order, shapes and types; the per-leaf
    spread follows the JAX initializers' scales."""
    jc, tc, jp, _, _ = _setup(name)
    tp = tt.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    tl, jl = tree_leaves(tp), jax.tree.leaves(jp)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        j = np.asarray(j)
        if j.std() > 0:
            assert abs(float(t.std()) / j.std() - 1) < 0.2
        else:
            assert torch.equal(t, torch.from_numpy(np.array(j)))


# ---------------------------------------------------------------------------
# the substrate, each alone
# ---------------------------------------------------------------------------

def test_rms_norm_swiglu_alone():
    x, gamma = _normal((3, 5, 64), 1), _normal((64,), 2)
    _close(tcom.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma)),
           jcom.rms_norm(jnp.asarray(x), jnp.asarray(gamma)))
    a, b = _normal((4, 96), 3), _normal((4, 96), 4)
    _close(tcom.swiglu(torch.from_numpy(a), torch.from_numpy(b)),
           jcom.swiglu(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("dh,theta", [(128, 500_000.0), (32, 10_000.0)])
def test_rope_alone_up_to_32k(dh, theta):
    """Positions 0 .. 32767: the frequencies are the same float32 values,
    and the angles reach 3.3e4 rad, where cos and sin of the two
    libraries differ by ~6e-8."""
    x = _normal((1, 32768, 2, dh), 5)
    pos = np.arange(32768, dtype=np.int32)[None, :]
    np.testing.assert_array_equal(np_(tcom.rope_frequencies(dh, theta)),
                                  np.asarray(jcom.rope_frequencies(dh, theta)))
    _close(tcom.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jcom.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 7, 0), (False, None, 0), (True, 5, 9)])
def test_dense_attention(causal, window, q_offset):
    q = _normal((2, 20, 6, 32), 1)
    k, v = _normal((2, 29, 2, 32), 2), _normal((2, 29, 2, 32), 3)
    got = tatt.dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=window,
                               q_offset=q_offset)
    want = jatt.dense_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, window=window,
                                q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("pos,window", [(0, None), (37, None), (37, 8),
                                        (3, 8), (63, 8)])
def test_decode_attention(pos, window):
    q = _normal((2, 1, 6, 32), 1)
    kc, vc = _normal((2, 64, 2, 32), 2), _normal((2, 64, 2, 32), 3)
    got = tatt.decode_attention(*(torch.from_numpy(a) for a in (q, kc, vc)),
                                pos, window=window)
    want = jatt.decode_attention(*(jnp.asarray(a) for a in (q, kc, vc)),
                                 jnp.int32(pos), window=window)
    _close(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_forward_logits(name):
    """``forward`` returns (logits, aux) as the JAX function does: aux is
    the layers' MoE losses summed (within 1e-6), a float32 0 for a dense
    FFN."""
    jc, tc, jp, tp, tokens = _setup(name)
    want, want_aux = jax.jit(lambda p, t: jt.forward(p, t, jc))(
        jp, jnp.asarray(tokens))
    got, aux = tt.forward(tp, torch.from_numpy(tokens), tc)
    assert got.shape == (2, tokens.shape[1], tc.vocab_pad)
    _close(got, want)
    assert aux.shape == () and aux.dtype == torch.float32
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    assert (float(aux) > 0) == (tc.moe is not None)


@pytest.mark.parametrize("name", ALL)
def test_prefill_and_four_decode_steps(name):
    """prefill_step's logits and cache, then 4 decode_steps on a cache
    grown by 4 (as serve_lm.py grows it), logits at every step and the
    cache after the last."""
    jc, tc, jp, tp, tokens = _setup(name)
    want, jcache = jax.jit(lambda p, t: jt.prefill_step(p, t, jc))(
        jp, jnp.asarray(tokens))
    got, tcache = tt.prefill_step(tp, torch.from_numpy(tokens), tc)
    _close(got, want)
    assert tcache["len"] == int(jcache["len"]) == tokens.shape[1]
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    jcache = {"k": jnp.pad(jcache["k"], pad), "v": jnp.pad(jcache["v"], pad),
              "len": jcache["len"]}
    tcache = tt.grow_cache(tcache, 4)
    decode = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, jc))
    for i in range(4):
        tok = np.random.default_rng(10 + i).integers(
            0, jc.vocab, (2, 1)).astype(np.int32)
        want, jcache = decode(jp, jcache, jnp.asarray(tok))
        got, tcache = tt.decode_step(tp, tcache, torch.from_numpy(tok), tc)
        _close(got, want)
    assert tcache["len"] == int(jcache["len"]) == tokens.shape[1] + 4
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])
    with pytest.raises(ValueError, match="grow it"):
        tt.decode_step(tp, tcache, torch.from_numpy(tok), tc)


def _example():
    spec = importlib.util.spec_from_file_location("serve_lm_torch", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_greedy_loop_matches_jax():
    """The example's generate() against serve_lm.py's loop on the JAX
    package, same weights and prompt: the same token ids."""
    jc, tc, jp, tp, tokens = _setup("narrow")
    gen_len = 8
    prefill = jax.jit(lambda p, t: jt.prefill_step(p, t, jc))
    decode = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, jc))
    logits, cache = prefill(jp, jnp.asarray(tokens))
    pad = ((0, 0), (0, 0), (0, gen_len), (0, 0), (0, 0))
    cache = {"k": jnp.pad(cache["k"], pad), "v": jnp.pad(cache["v"], pad),
             "len": cache["len"]}
    tok = jnp.argmax(logits, -1)[:, None]
    want = [tok]
    for _ in range(gen_len - 1):
        logits, cache = decode(jp, cache, tok)
        tok = jnp.argmax(logits, -1)[:, None]
        want.append(tok)
    ids, last, _, _ = _example().generate(tp, torch.from_numpy(tokens), tc,
                                          gen_len)
    np.testing.assert_array_equal(np_(ids),
                                  np.asarray(jnp.concatenate(want, axis=1)))
    _close(last, logits)


def test_example_smoke_path_runs(capsys):
    flashattn.reset_launch_counts()
    ids = _example().main(["--smoke", "--device", "cpu", "--gen-len", "6"])
    assert ids.shape == (4, 6)
    assert "OK" in capsys.readouterr().out
    assert flashattn.launch_counts[flashattn.FLASHATTN] == 0
