"""The port's fused gather + segment sum (K4's plain version, segment
plan and dispatcher with its gradient) on the CPU, against the JAX
package's plain version and its Pallas kernel in interpret mode.  The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum import gather_segment_sum_pallas
from repro.kernels.segsum import gather_segment_sum_ref as j_ref
from repro_torch.kernels import segsum as ts
from repro_torch.kernels.segsum.kernel import check_ranges
from _torch_parity import np_

# the four shapes of the JAX package's kernel sweep
SHAPES = [(512, 100, 128, 32, "float32"), (2048, 300, 256, 64, "float32"),
          (1024, 50, 128, 16, "bfloat16"), (4096, 1000, 384, 128, "float32")]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(n, v, d, s, seed, integer=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, n).astype(np.int32)
    seg = rng.integers(0, s, n).astype(np.int32)
    if integer:
        w = rng.integers(0, 4, n).astype(np.float32)
        table = rng.integers(-8, 9, (v, d)).astype(np.float32)
    else:
        w = rng.random(n).astype(np.float32)
        table = rng.standard_normal((v, d)).astype(np.float32)
    return ids, seg, w, table


def _torch(ids, seg, w, table, dtype="float32"):
    return (torch.from_numpy(ids), torch.from_numpy(seg), torch.from_numpy(w),
            torch.from_numpy(table).to(TORCH_DTYPE[dtype]))


def _f32(x):
    """A torch tensor or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("n,v,d,s,dtype", SHAPES)
def test_plain_and_dispatcher_match_jax_ref_and_pallas(n, v, d, s, dtype):
    ids, seg, w, table = _inputs(n, v, d, s, n + v)
    tt = _torch(ids, seg, w, table, dtype)
    jt = (jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(w),
          jnp.asarray(table, jnp.dtype(dtype)))
    want_ref = _f32(j_ref(*jt, s))
    want_pallas = _f32(gather_segment_sum_pallas(*jt, s, block_n=512,
                                                 block_d=128))
    for got in (ts.gather_segment_sum_ref(*tt, s),
                ts.gather_segment_sum(*tt, s)):
        assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (s, d)
        for want in (want_ref, want_pallas):
            np.testing.assert_allclose(_f32(got), want, rtol=TOL[dtype],
                                       atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bitwise_on_integer_inputs(dtype):
    """Small integers: every product and partial sum is exact in float32,
    so any summation order, chunking included, gives the same bits."""
    ids, seg, w, table = _inputs(3000, 200, 64, 40, 7, integer=True)
    tt = _torch(ids, seg, w, table, dtype)
    want = np.asarray(j_ref(jnp.asarray(ids), jnp.asarray(seg),
                            jnp.asarray(w), jnp.asarray(table,
                                                        jnp.dtype(dtype)),
                            40).astype(jnp.float32))
    for got in (ts.gather_segment_sum_ref(*tt, 40),
                ts.gather_segment_sum_ref(*tt, 40, chunk=77),
                ts.gather_segment_sum(*tt, 40)):
        np.testing.assert_array_equal(_f32(got), want)


def test_chunked_plain_version_keeps_the_index_order():
    """On the CPU ``index_add_`` adds in index order, so the chunked loop
    gives the unchunked bits on any input."""
    tt = _torch(*_inputs(5000, 300, 32, 50, 3))
    assert torch.equal(ts.gather_segment_sum_ref(*tt, 50, chunk=333),
                       ts.gather_segment_sum_ref(*tt, 50, chunk=1 << 22))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradient_matches_jax_grad(dtype):
    """The gradient with respect to the table against ``jax.grad`` of the
    JAX plain version.  For a bfloat16 table the port accumulates the
    gradient in float32 and rounds once, as its forward does; JAX's
    transpose of the gather scatters in bfloat16.  So the bfloat16 case
    takes ``jax.grad`` of the float32 function at the bfloat16 table's
    values, with the cotangent rounded to bfloat16 as the output's is, and
    rounds it once: the port's contract, at the bfloat16 tolerance."""
    n, v, d, s = 1024, 120, 48, 30
    ids, seg, w, table = _inputs(n, v, d, s, 11)
    cot = np.random.default_rng(12).standard_normal((s, d)).astype(np.float32)
    bf16 = dtype == "bfloat16"
    if bf16:
        table = np.asarray(jnp.asarray(table, jnp.bfloat16), np.float32)
        cot = np.asarray(jnp.asarray(cot, jnp.bfloat16), np.float32)

    def jloss(tab):
        out = j_ref(jnp.asarray(ids), jnp.asarray(seg), jnp.asarray(w), tab,
                    s)
        return jnp.sum(out * jnp.asarray(cot))

    want = jax.grad(jloss)(jnp.asarray(table))
    if bf16:
        want = want.astype(jnp.bfloat16)
    ti, tg, tw, tt = _torch(ids, seg, w, table, dtype)
    tt.requires_grad_(True)
    out = ts.gather_segment_sum(ti, tg, tw, tt, s)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert tt.grad.dtype == TORCH_DTYPE[dtype]
    tol = TOL[dtype] if bf16 else 1e-5
    np.testing.assert_allclose(_f32(tt.grad), _f32(want), rtol=tol, atol=tol)


def test_routes_and_forced_routes():
    ids, seg, w, table = _torch(*_inputs(400, 50, 16, 12, 5))
    plan = ts.build_plan(ids, seg, 12, 50)
    before = dict(ts.launch_counts)
    want = ts.gather_segment_sum_ref(ids, seg, w, table, 12)
    # on the CPU the dispatcher and the kernel's wrapper both take the
    # plain version, and neither counts a launch
    assert torch.equal(ts.gather_segment_sum(ids, seg, w, table, 12), want)
    assert torch.equal(ts.gather_segment_sum(ids, seg, w, table, 12,
                                             use_kernel=False), want)
    assert torch.equal(ts.gather_segment_sum(ids, seg, w, table, 12,
                                             plan=plan), want)
    assert torch.equal(ts.gather_segment_sum_cuda(ids, seg, w, table, 12,
                                                  plan), want)
    assert ts.launch_counts == before
    with pytest.raises(ValueError, match="CUDA kernel"):
        ts.gather_segment_sum(ids, seg, w, table, 12, use_kernel=True)
    with pytest.raises(ValueError, match="no gradient for w"):
        ts.gather_segment_sum(ids, seg, w.clone().requires_grad_(True),
                              table, 12)


@pytest.mark.parametrize("bad", ["ids_high", "ids_negative", "seg_high",
                                 "seg_negative"])
def test_out_of_range_indices_raise(bad):
    """The port's contract is ids in [0, V1) and seg in [0, S) (the JAX
    package clamps gathers and drops segments instead)."""
    ids, seg, w, table = _torch(*_inputs(100, 20, 8, 6, 2))
    field, how = bad.split("_")
    t = ids if field == "ids" else seg
    t[17] = -1 if how == "negative" else (20 if field == "ids" else 6)
    with pytest.raises(ValueError, match="outside"):
        ts.gather_segment_sum(ids, seg, w, table, 6)
    with pytest.raises(ValueError, match="outside"):
        ts.build_plan(ids, seg, 6, 20)


def _plan_order_sum(plan, w, table):
    """The kernel's arithmetic in numpy: each segment of at most
    ``split`` entries summed in plan order; a split segment summed item by
    item, then its item partials summed in item order; float32 products
    and sums throughout."""
    order, ids = np_(plan.order), np_(plan.ids_sorted)
    offsets, w, table = np_(plan.offsets), np_(w), np_(table)
    out = np.zeros((plan.n_segments, table.shape[1]), np.float32)

    def run(lo, hi):
        acc = np.zeros(table.shape[1], np.float32)
        for j in range(lo, hi):
            acc = acc + np.float32(w[order[j]]) * table[ids[j]]
        return acc

    for s in range(plan.n_segments):
        if offsets[s + 1] - offsets[s] <= plan.split:
            out[s] = run(offsets[s], offsets[s + 1])
    for q, s in enumerate(np_(plan.split_seg)):
        acc = np.zeros(table.shape[1], np.float32)
        for h in range(np_(plan.split_first)[q], np_(plan.split_first)[q + 1]):
            acc = acc + run(np_(plan.item_begin)[h], np_(plan.item_end)[h])
        out[s] = acc
    return out


@pytest.mark.parametrize("split", [1, 4, 512])
def test_segment_plan_covers_every_entry_once(split):
    """The plan the kernel reads: a stable sort by segment, offsets, and
    items that cut each segment longer than ``split`` into consecutive
    runs of at most ``split`` entries.  Summing in the plan's order (the
    kernel's arithmetic) gives the plain version's result, bitwise on
    integer-valued inputs.  Its transpose is the plan of (seg, ids)."""
    rng = np.random.default_rng(split)
    n, v, s, d = 600, 40, 25, 8
    seg = np.minimum(rng.zipf(1.6, n) - 1, s - 1).astype(np.int32)  # skewed
    ids = rng.integers(0, v, n).astype(np.int32)
    w = rng.integers(0, 3, n).astype(np.float32)
    table = rng.integers(-5, 6, (v, d)).astype(np.float32)
    ti, tg, tw, tt = _torch(ids, seg, w, table)
    plan = ts.build_plan(ti, tg, s, v, split=split)
    order, offsets = np_(plan.order), np_(plan.offsets)
    assert sorted(order) == list(range(n))
    np.testing.assert_array_equal(seg[order], np.sort(seg, kind="stable"))
    np.testing.assert_array_equal(order, np.argsort(seg, kind="stable"))
    np.testing.assert_array_equal(np_(plan.ids_sorted), ids[order])
    np.testing.assert_array_equal(np.diff(offsets), np.bincount(seg,
                                                                minlength=s))
    counts = np.diff(offsets)
    np.testing.assert_array_equal(np_(plan.split_seg),
                                  np.nonzero(counts > split)[0])
    first = np_(plan.split_first)
    for q, sg in enumerate(np_(plan.split_seg)):
        begins = np_(plan.item_begin)[first[q]:first[q + 1]]
        ends = np_(plan.item_end)[first[q]:first[q + 1]]
        assert begins[0] == offsets[sg] and ends[-1] == offsets[sg + 1]
        np.testing.assert_array_equal(begins[1:], ends[:-1])
        assert ((ends - begins) <= split).all() and (ends > begins).all()
    want = np_(ts.gather_segment_sum_ref(ti, tg, tw, tt, s))
    np.testing.assert_array_equal(_plan_order_sum(plan, tw, tt), want)
    pt = plan.transpose
    assert (pt.n_segments, pt.n_rows) == (v, s)
    np.testing.assert_array_equal(np_(pt.order), np.argsort(ids,
                                                            kind="stable"))
    np.testing.assert_array_equal(np_(pt.ids_sorted),
                                  seg[np.argsort(ids, kind="stable")])


def test_plan_order_sum_matches_on_gaussian_inputs():
    """On N(0, 1) inputs the plan's order differs from the plain
    version's only within float32 summation error."""
    ti, tg, tw, tt = _torch(*_inputs(2000, 60, 16, 9, 21))
    plan = ts.build_plan(ti, tg, 9, 60, split=16)
    np.testing.assert_allclose(
        _plan_order_sum(plan, tw, tt),
        np_(ts.gather_segment_sum_ref(ti, tg, tw, tt, 9)), rtol=2e-5,
        atol=2e-5)


def test_empty_input_and_range_check_of_nothing():
    ids = torch.zeros(0, dtype=torch.int32)
    w = torch.zeros(0)
    table = torch.ones(5, 4)
    check_ranges(ids, ids, 5, 3)
    out = ts.gather_segment_sum(ids, ids, w, table, 3)
    assert torch.equal(out, torch.zeros(3, 4))
    plan = ts.build_plan(ids, ids, 3, 5)
    assert plan.n_entries == 0 and plan.n_items == 0
