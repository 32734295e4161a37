"""K4's segment plan on the CPU: its hot ranking, its order of additions
and the weights it keeps in plan order, replayed in numpy and held
against the JAX package's plain version and its Pallas kernel in
interpret mode; and the frontier pull's plan (K1), which comes from the
same ``build_plan``, left as it was.  The CUDA kernel that reads the plan is
held against these on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum import gather_segment_sum_pallas
from repro.kernels.segsum import gather_segment_sum_ref as j_ref
from repro_torch.kernels import segsum as ts
from repro_torch.kernels.frontier import kernel as fk
from repro_torch.kernels.segsum import kernel as sk
from _torch_parity import np_

MARK = np.int32(-(1 << 31))


def _np_plan(ids, seg, n_segments, n_rows, split, hot_rows):
    """The plan in numpy: a stable sort by segment, the offsets, items of
    at most ``split`` entries, the ``hot_rows`` ids of most entries (most
    first, ties by id) and bit 31 on their entries."""
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n_segments)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    heavy = np.flatnonzero(counts > split)
    begin, end, first = [], [], [0]
    for s in heavy:
        starts = np.arange(offsets[s], offsets[s + 1], split)
        begin += list(starts)
        end += list(np.minimum(starts + split, offsets[s + 1]))
        first.append(len(begin))
    hot = np.argsort(-np.bincount(ids, minlength=n_rows),
                     kind="stable")[:min(hot_rows, n_rows)]
    ids_sorted = ids[order].astype(np.int32)
    ids_sorted = np.where(np.isin(ids_sorted, hot), ids_sorted | MARK,
                          ids_sorted).astype(np.int32)
    return dict(order=order.astype(np.int32), ids_sorted=ids_sorted,
                offsets=offsets, item_begin=np.asarray(begin, np.int64),
                item_end=np.asarray(end, np.int64),
                split_seg=heavy.astype(np.int32),
                split_first=np.asarray(first, np.int64),
                hot=hot.astype(np.int32))


def _np_kernel_sum(plan, w, table, n_segments, split):
    """The kernel's order of additions in numpy, from the numpy plan: the
    weights in plan order, each id with its hot mark cleared; a segment
    of at most ``split`` entries summed in plan order, a split one item by
    item and its partials in item order; float32 throughout."""
    ids = plan["ids_sorted"] & ~MARK
    w_sorted = w[plan["order"]]
    offsets = plan["offsets"]
    out = np.zeros((n_segments, table.shape[1]), np.float32)

    def run(lo, hi):
        acc = np.zeros(table.shape[1], np.float32)
        for j in range(lo, hi):
            acc = acc + w_sorted[j] * table[ids[j]]
        return acc

    for s in range(n_segments):
        if offsets[s + 1] - offsets[s] <= split:
            out[s] = run(offsets[s], offsets[s + 1])
    for q, s in enumerate(plan["split_seg"]):
        acc = np.zeros(table.shape[1], np.float32)
        for h in range(plan["split_first"][q], plan["split_first"][q + 1]):
            acc = acc + run(plan["item_begin"][h], plan["item_end"][h])
        out[s] = acc
    return out


def _skewed(n, v, s, seed):
    """Zipf-skewed segments and ids: a few segments over the split, a
    few ids carrying most entries."""
    rng = np.random.default_rng(seed)
    seg = np.minimum(rng.zipf(1.5, n) - 1, s - 1).astype(np.int32)
    ids = np.minimum(rng.zipf(1.3, n) - 1, v - 1).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    table = rng.integers(-5, 6, (v, 8)).astype(np.float32)
    return ids, seg, w, table


CASES = {
    # a skewed segment over the split, three hot sources
    "skewed": dict(n=900, v=60, s=30, split=16, hot_rows=3),
    "no hot sources": dict(n=900, v=60, s=30, split=16, hot_rows=0),
    "every source hot": dict(n=900, v=60, s=30, split=512, hot_rows=10_000),
    "empty": dict(n=0, v=7, s=4, split=16, hot_rows=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_and_its_sum_are_the_numpy_replay(case):
    """The plan and its transpose array for array against the numpy
    replay; the replayed kernel sum bitwise equal to the plain version,
    the JAX plain version and the JAX Pallas kernel in interpret mode on
    integer-valued inputs (Pallas takes no empty input: there the JAX
    plain version only)."""
    c = CASES[case]
    n, v, s, split, hot_rows = (c[k] for k in ("n", "v", "s", "split",
                                               "hot_rows"))
    ids, seg, w, table = _skewed(n, v, s, seed=n + hot_rows)
    plan = ts.build_plan(torch.from_numpy(ids), torch.from_numpy(seg), s, v,
                         split=split, hot_rows=hot_rows)
    for got, want_plan in ((plan, _np_plan(ids, seg, s, v, split, hot_rows)),
                           (plan.transpose,
                            _np_plan(seg, ids, v, s, split, hot_rows))):
        for key, arr in want_plan.items():
            field = getattr(got, key)
            assert field.dtype == torch.from_numpy(arr).dtype, key
            np.testing.assert_array_equal(np_(field), arr, err_msg=key)
        assert got.n_hot == want_plan["hot"].shape[0]
    np_plan = _np_plan(ids, seg, s, v, split, hot_rows)
    if case == "skewed":
        assert plan.n_items > 0 and 0 < plan.n_hot < v
        assert (np_plan["ids_sorted"] < 0).any()
    if case == "every source hot":
        assert plan.n_hot == v and (np_(plan.ids_sorted) < 0).all()
    replay = _np_kernel_sum(np_plan, w, table, s, split)
    tt = (torch.from_numpy(ids), torch.from_numpy(seg), torch.from_numpy(w),
          torch.from_numpy(table))
    np.testing.assert_array_equal(replay,
                                  np_(ts.gather_segment_sum_ref(*tt, s)))
    np.testing.assert_array_equal(
        replay, np_(ts.gather_segment_sum(*tt, s, plan=plan)))
    jt = tuple(jnp.asarray(a) for a in (ids, seg, w, table))
    np.testing.assert_array_equal(replay, np.asarray(j_ref(*jt, s)))
    if n:
        np.testing.assert_array_equal(replay, np.asarray(
            gather_segment_sum_pallas(*jt, s, block_n=n, block_d=8)))


def test_weights_in_plan_order_follow_w():
    """The plan keeps ``w[order]`` for the tensor it last saw: the same
    tensor gets the kept copy back; a change in place (directly or
    through a view) and another tensor each get a fresh, right copy."""
    ids, seg, w, _ = _skewed(500, 40, 20, seed=3)
    plan = ts.build_plan(torch.from_numpy(ids), torch.from_numpy(seg), 20,
                         40)
    order = np_(plan.order)
    w = torch.from_numpy(w.copy())
    first = plan.weights_in_order(w)
    np.testing.assert_array_equal(np_(first), np_(w)[order])
    assert plan.weights_in_order(w) is first
    w.mul_(2.0)
    again = plan.weights_in_order(w)
    assert again is not first
    np.testing.assert_array_equal(np_(again), np_(w)[order])
    w[3:9].fill_(7.0)           # through a view: the version is shared
    np.testing.assert_array_equal(np_(plan.weights_in_order(w)),
                                  np_(w)[order])
    other = w.clone()
    other[0] = -1.0
    np.testing.assert_array_equal(np_(plan.weights_in_order(other)),
                                  np_(other)[order])
    np.testing.assert_array_equal(np_(plan.weights_in_order(w)),
                                  np_(w)[order])
    # a copy of the plan (its transpose set, say) keeps nothing of it
    assert not dataclasses.replace(plan, transpose=None)._w_sorted
    with torch.inference_mode():
        w_inf = torch.ones(500)
        np.testing.assert_array_equal(np_(plan.weights_in_order(w_inf)),
                                      np.ones(500, np.float32))
    with pytest.raises(ValueError, match="no order"):
        fk.build_pull_plan(torch.from_numpy(ids), torch.from_numpy(seg),
                           40).weights_in_order(w)


def test_hot_sources_are_the_ids_of_most_entries():
    """``hot`` lists ids by entry count, most first, ties by id; the mark
    is on exactly their entries, and clearing it gives ``ids[order]``."""
    ids = torch.tensor([5, 2, 2, 7, 5, 2, 9, 7, 0, 5, 1], dtype=torch.int32)
    seg = torch.tensor([0, 1, 1, 2, 0, 3, 3, 1, 2, 0, 1], dtype=torch.int32)
    plan = ts.build_plan(ids, seg, 4, 10, hot_rows=3)
    assert plan.hot.tolist() == [2, 5, 7]
    marked = np_(plan.ids_sorted) < 0
    clear = np_(plan.sorted_ids())
    np.testing.assert_array_equal(clear, np_(ids)[np_(plan.order)])
    np.testing.assert_array_equal(marked, np.isin(clear, [2, 5, 7]))
    assert ts.build_plan(ids, seg, 4, 10, hot_rows=0).n_hot == 0
    with pytest.raises(ValueError, match="hot_rows"):
        ts.build_plan(ids, seg, 4, 10, hot_rows=-1)


@pytest.mark.parametrize("split", [sk.SPLIT, 3])
def test_pull_plan_is_unchanged(split):
    """The frontier pull's plan (K1) comes from ``build_plan`` with no
    hot source: its fields hold what they held before the hot ranking
    came (the plain ids in destination order, the offsets, the items), in
    the same types, with no ``order`` and an empty ``hot``; and it equals
    the gather-segment-sum plan of the same edges built with no hot
    source, field for field."""
    rng = np.random.default_rng(split)
    src = torch.from_numpy(np.minimum(rng.zipf(1.4, 4000) - 1, 299)
                           .astype(np.int32))
    dst = torch.from_numpy(np.minimum(rng.zipf(1.4, 4000) - 1, 299)
                           .astype(np.int32))
    pull = fk.build_pull_plan(src, dst, 300, split=split)
    want = _np_plan(np_(src), np_(dst), 300, 300, split, 0)
    assert pull.order is None and pull.transpose is None and pull.n_hot == 0
    for key in ("ids_sorted", "offsets", "item_begin", "item_end",
                "split_seg", "split_first", "hot"):
        field = getattr(pull, key)
        assert field.dtype == torch.from_numpy(want[key]).dtype, key
        np.testing.assert_array_equal(np_(field), want[key], err_msg=key)
    segsum = ts.build_plan(src, dst, 300, 300, split=split, hot_rows=0,
                           transpose=False)
    for f in dataclasses.fields(pull):
        got, ref = getattr(pull, f.name), getattr(segsum, f.name)
        if f.name == "order":
            assert got is None and ref is not None
        elif isinstance(got, torch.Tensor):
            assert torch.equal(got, ref), f.name
        elif f.name != "_w_sorted":
            assert got == ref, f.name


def test_entry_limit_binds_only_a_plan_that_keeps_its_order(monkeypatch):
    """The int32 ``order`` caps a plan that keeps it at 2^31 - 1 entries;
    a plan built without it (the frontier pull's, whose offsets are
    64-bit) is not capped and goes on to the range check."""
    big = torch.zeros(1, dtype=torch.int32).expand(1 << 31)
    with pytest.raises(ValueError, match="2\\^31 entries"):
        ts.build_plan(big, big, 1, 1)

    def past_the_limit(*args):
        raise RuntimeError("past the limit check")

    monkeypatch.setattr(sk, "check_ranges", past_the_limit)
    with pytest.raises(RuntimeError, match="past the limit"):
        ts.build_plan(big, big, 1, 1, keep_order=False)
    with pytest.raises(RuntimeError, match="past the limit"):
        fk.build_pull_plan(big, big, 1)
