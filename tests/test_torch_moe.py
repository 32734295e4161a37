"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the
JAX package's ``repro.models.moe``, on the same numpy-seeded inputs and
weights carried across.

Routing is held bitwise: the JAX function runs eagerly with
``jax.lax.top_k`` and ``jax.nn.one_hot`` wrapped to record what it
computes (the top-k experts, and each slot rank's ``where(keep, pos,
cap)``, the kept slots and their positions), so the reference's own
intermediates are read, not a copy of its code.  The two packages' router
logits differ by summation order (~1e-7): a token whose top-k+1
probabilities lie within 1e-6 of each other is a near tie, counted and
left out, and with it every token after it in its group (their
positions follow from its choice).  Outputs within 1e-5 of their
largest entry, aux within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jm
import repro_torch.models.moe as tm
from _torch_parity import np_

TIE = 1e-6


def _cfgs(**kw):
    return jm.MoEConfig(**kw), tm.MoEConfig(**kw)


CONFIGS = {
    # name: (MoEConfig fields, tokens T)
    "granite_smoke": (dict(n_experts=4, top_k=2, d_model=64, d_ff=32), 96),
    "moonshot_smoke": (dict(n_experts=8, top_k=2, d_model=64, d_ff=48), 96),
    # 4 groups of 64, capacity 8 against a mean load of 16: most drop
    "dropping": (dict(n_experts=8, top_k=3, d_model=32, d_ff=16,
                      capacity_factor=0.25, group_size=64), 256),
    # granite's E and k, several groups, at the reference's factor
    "granite_wide": (dict(n_experts=40, top_k=8, d_model=48, d_ff=16,
                          group_size=128), 384),
    # a decode step: T = B < group_size, one group
    "decode": (dict(n_experts=8, top_k=2, d_model=32, d_ff=16), 2),
}


def _setup(name, seed=0, dtype=jnp.float32):
    fields, t = CONFIGS[name]
    jc, tc = _cfgs(**fields)
    jp = jm.init_moe_params(jax.random.PRNGKey(seed), jc, dtype)
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" or dtype == jnp.float32
        else torch.bfloat16) for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (t, fields["d_model"])).astype(np.float32)
    return jc, tc, jp, tp, x


def _jax_routing(jp, x, jc, monkeypatch):
    """The JAX function's own top-k experts (G, S, k) and, for each slot
    rank j, where(keep, pos, cap) over (G, S, E): read by wrapping the
    two calls that compute them, with the function run eagerly."""
    seen = {"top_k": [], "slots": []}
    top_k, one_hot = jax.lax.top_k, jax.nn.one_hot
    cap = jm.capacity(min(jc.group_size, x.shape[0]), jc)

    def rec_top_k(operand, k):
        out = top_k(operand, k)
        seen["top_k"].append(np.asarray(out[1]))
        return out

    def rec_one_hot(a, n, **kw):
        # the slot one-hot: (G, S, E) positions over cap classes
        if n == cap and jnp.ndim(a) == 3:
            seen["slots"].append(np.asarray(a))
        return one_hot(a, n, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "top_k", rec_top_k)
        m.setattr(jax.nn, "one_hot", rec_one_hot)
        out, aux = jm.moe_ffn(jp, jnp.asarray(x, jp["w_gate"].dtype), jc)
    assert len(seen["top_k"]) == 1 and len(seen["slots"]) == jc.top_k
    return seen["top_k"][0], np.stack(seen["slots"], -1), out, aux, cap


def _near_ties(probs, k):
    """(G, S) mask of tokens whose k+1 largest probabilities hold two
    within TIE of each other."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return (np.diff(-top, axis=-1) < TIE).any(axis=-1)


def _port_routing(tp, x, tc):
    s = min(tc.group_size, x.shape[0])
    xg = torch.from_numpy(x).reshape(-1, s, x.shape[1])
    probs = tm.router_probs(tp["router"], xg)
    return tm.route(probs, tc), np_(probs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_routing_is_bitwise_the_reference(name, monkeypatch):
    jc, tc, jp, tp, x = _setup(name)
    ids_j, slots_j, _, _, cap = _jax_routing(jp, x, jc, monkeypatch)
    r, probs = _port_routing(tp, x, tc)
    assert cap == tm.capacity(probs.shape[1], tc)
    tie = _near_ties(probs, tc.top_k)
    # a near tie leaves out its token and every later token of its group
    skip = np.cumsum(tie, axis=1) > 0
    assert skip.mean() < 0.05, f"{int(tie.sum())} near ties"
    ids = np_(r.expert_ids)
    np.testing.assert_array_equal(ids[~tie], ids_j[~tie])
    # the port's (keep, pos) scattered into the reference's (G, S, E) form
    slots = np.full(slots_j.shape, cap, dtype=np.int64)
    keep, pos = np_(r.keep), np_(r.pos)
    g, s, k = ids.shape
    gi, si = np.meshgrid(np.arange(g), np.arange(s), indexing="ij")
    for j in range(k):
        slots[gi, si, ids[..., j], j] = np.where(keep[..., j], pos[..., j],
                                                 cap)
    np.testing.assert_array_equal(slots[~skip], slots_j[~skip])
    dropped = int((~keep).sum())
    if name == "dropping":
        assert dropped > keep.size // 3
    # kept slots are unique and below capacity, dropped ones at or above
    assert (pos[keep] < cap).all() and (pos[~keep] >= cap).all()
    flat = (ids * g + gi[..., None]) * cap + pos
    assert len(np.unique(flat[keep])) == int(keep.sum())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_ffn_matches_the_reference(name):
    jc, tc, jp, tp, x = _setup(name, seed=1)
    want, want_aux = jax.jit(lambda p, v: jm.moe_ffn(p, v, jc))(
        jp, jnp.asarray(x))
    got, aux = tm.moe_ffn(tp, torch.from_numpy(x), tc)
    assert got.shape == x.shape and got.dtype == torch.float32
    want = np.asarray(want)
    np.testing.assert_allclose(np_(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(want_aux)) <= 1e-6


def test_dropped_tokens_are_the_reference_s():
    """The dropping config: the tokens whose every choice dropped get a
    zero output in both packages, the same ones."""
    jc, tc, jp, tp, x = _setup("dropping", seed=2)
    want, _ = jm.moe_ffn(jp, jnp.asarray(x), jc)
    got, _ = tm.moe_ffn(tp, torch.from_numpy(x), tc)
    r, _ = _port_routing(tp, x, tc)
    none_kept = ~np_(r.keep).any(-1).reshape(-1)
    assert none_kept.sum() > 0
    np.testing.assert_array_equal(np.all(np.asarray(want) == 0, axis=-1),
                                  none_kept)
    np.testing.assert_array_equal(np.all(np_(got) == 0, axis=-1), none_kept)


def test_equal_router_columns_choose_the_lower_expert(monkeypatch):
    """Experts 1 and 3 (and 2 and 6) with one router column: equal
    probabilities, where the reference's top_k and the port's stable sort
    both rank the lower index first."""
    jc, tc, jp, tp, x = _setup("moonshot_smoke", seed=3)
    router = np.array(jp["router"])
    router[:, 3] = router[:, 1]
    router[:, 6] = router[:, 2]
    jp = {**jp, "router": jnp.asarray(router)}
    tp = {**tp, "router": torch.from_numpy(router)}
    ids_j, slots_j, want, _, cap = _jax_routing(jp, x, jc, monkeypatch)
    r, probs = _port_routing(tp, x, tc)
    np.testing.assert_array_equal(probs[..., 3], probs[..., 1])
    ids = np_(r.expert_ids)
    for lo, hi in ((1, 3), (2, 6)):
        has_lo, has_hi = (ids == lo).any(-1), (ids == hi).any(-1)
        assert (has_lo & ~has_hi).any(), "the tie never decided a choice"
        # the higher of the pair is never chosen without the lower, and
        # where both are chosen the lower ranks first
        assert not (has_hi & ~has_lo).any()
        both = has_lo & has_hi
        rank = np.argmax(ids == lo, -1) < np.argmax(ids == hi, -1)
        assert rank[both].all()
    # near ties among the distinct columns (the equal pairs tie exactly
    # in both packages, and both break them alike)
    tie = _near_ties(np.delete(probs, [3, 6], axis=-1), tc.top_k)
    np.testing.assert_array_equal(ids[~tie], ids_j[~tie])
    got, _ = tm.moe_ffn(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("group_size,t,raises", [
    (1024, 96, False), (64, 96, True), (32, 96, False), (64, 3, False)])
def test_group_rows(group_size, t, raises):
    """T < group_size is one group (a decode step); a T that groups of
    group_size do not divide raises where the reference asserts."""
    jc, tc = _cfgs(n_experts=4, top_k=2, d_model=8, d_ff=8,
                   group_size=group_size)
    jp = jm.init_moe_params(jax.random.PRNGKey(0), jc, jnp.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.ones((t, 8), np.float32)
    if raises:
        with pytest.raises(ValueError, match="do not divide"):
            tm.moe_ffn(tp, torch.from_numpy(x), tc)
        with pytest.raises(AssertionError):
            jm.moe_ffn(jp, jnp.asarray(x), jc)
    else:
        out, _ = tm.moe_ffn(tp, torch.from_numpy(x), tc)
        assert out.shape == (t, 8)
        jm.moe_ffn(jp, jnp.asarray(x), jc)


@pytest.mark.parametrize("group", [1, 2, 3, 7, 8, 31, 64, 100, 1000, 1024,
                                   4096])
@pytest.mark.parametrize("fields", [
    dict(n_experts=40, top_k=8, d_model=8, d_ff=8),
    dict(n_experts=64, top_k=6, d_model=8, d_ff=8),
    dict(n_experts=8, top_k=2, d_model=8, d_ff=8, capacity_factor=0.3),
    dict(n_experts=4, top_k=2, d_model=8, d_ff=8, capacity_factor=2.0),
])
def test_capacity_is_the_reference_s(group, fields):
    jc, tc = _cfgs(**fields)
    assert tm.capacity(group, tc) == jm.capacity(group, jc)


def test_init_moe_params_has_the_reference_tree():
    """Leaf names, shapes and types, and each leaf's spread: the router's
    1 / sqrt(d), the experts' 1 / sqrt(n_experts) (the reference's fan
    in, ``shape[0]``), also when stacked over groups."""
    jc, tc = _cfgs(n_experts=16, top_k=2, d_model=96, d_ff=80)
    jp = jm.init_moe_params(jax.random.PRNGKey(0), jc, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for lead in ((), (3,)):
        tp = tm.init_moe_params(gen, tc, torch.bfloat16, device="cpu",
                                lead=lead)
        assert sorted(tp) == sorted(jp)
        for k, j in jp.items():
            t = tp[k]
            assert tuple(t.shape) == lead + j.shape, k
            assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
            ratio = float(t.float().std()) / float(
                np.asarray(j.astype(jnp.float32)).std())
            assert abs(ratio - 1) < 0.05, (k, ratio)
    assert abs(float(tp["w_up"].float().std()) - 16 ** -0.5) < 0.01
    assert abs(float(tp["router"].std()) - 96 ** -0.5) < 0.01


def test_bfloat16_moe_ffn_is_near_the_reference():
    """Experts in bfloat16, the router in float32: within 2e-2 of the
    largest entry (every product, the hidden layer and the output round
    to bfloat16 on both sides; the gates round before the combine)."""
    jc, tc, jp, tp, x = _setup("granite_wide", seed=4, dtype=jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    want, want_aux = jm.moe_ffn(jp, jnp.asarray(x, jnp.bfloat16), jc)
    got, aux = tm.moe_ffn(tp, torch.from_numpy(x).to(torch.bfloat16), tc)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(np_(got.float()), want, rtol=0,
                               atol=2e-2 * float(np.abs(want).max()))
    assert abs(float(aux) - float(want_aux)) <= 1e-6
