"""Port parity: ``paddle_sparse_tpu_torch.ops.segment`` against the JAX
``paddle_sparse_tpu.ops.segment`` on the same numpy inputs: every reduction,
empty segments (first and last too), trailing dims, integer values, ids
outside ``[0, num_segments)`` (negative ones too, which both drop), and the
dtype each returns.

Tolerances: f32 ``rtol=atol=1e-5`` (sums in another order); f64 ``1e-12``;
integer values and min/max exact; bf16/f16 ``2e-2``, because JAX and torch
round the sums of a bf16 ``scatter_reduce`` to bf16 at other steps, and the
mean of ``segment_csr`` rounds its f32 result once to the 8-bit mantissa."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import segment as jseg
from paddle_sparse_tpu_torch.ops import segment as tseg

TOL = {np.float32: dict(rtol=1e-5, atol=1e-5),
       np.float64: dict(rtol=1e-12, atol=1e-12),
       np.int32: dict(rtol=0, atol=0)}
HALF_TOL = dict(rtol=2e-2, atol=2e-2)
REDUCES = ["sum", "add", "mean", "min", "max"]
TRAILING = [(), (3,), (2, 3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(rng, E, trailing, dtype):
    if np.dtype(dtype).kind == "i":
        return rng.integers(-50, 50, (E,) + trailing).astype(dtype)
    return rng.standard_normal((E,) + trailing).astype(dtype)


def _ptr(rng, num_segments, max_len=6, empty=(0, 4)):
    """A CSR pointer with the segments ``empty`` (and the last) empty."""
    lens = rng.integers(1, max_len, num_segments)
    lens[list(empty)] = 0
    lens[-1] = 0
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _same(got, ref, tol):
    ref = np.asarray(ref)
    assert str(got.dtype)[6:] == str(ref.dtype), (got.dtype, ref.dtype)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.double().numpy(), ref.astype(np.float64),
                               **tol)


def test_reductions():
    assert tseg.REDUCTIONS == jseg.REDUCTIONS


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("trailing", TRAILING)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32])
def test_segment_csr(reduce, trailing, dtype):
    rng = np.random.default_rng(len(trailing) + len(reduce))
    ptr = _ptr(rng, 40)
    vals = _values(rng, int(ptr[-1]), trailing, dtype)
    got = tseg.segment_csr(_t(vals), _t(ptr), reduce)
    ref = jseg.segment_csr(jnp.asarray(vals), jnp.asarray(ptr), reduce)
    _same(got, ref, TOL[dtype])
    assert not got[[0, 4, 39]].any()        # empty segments give 0


@pytest.mark.parametrize("reduce", ["sum", "max"])
def test_segment_csr_past_the_pointer(reduce):
    """Values past ``ptr[-1]`` and a pointer not starting at 0: both
    packages put them where ``ptr2ind`` says (the last segment that starts
    at or before them; the pointer rebased)."""
    rng = np.random.default_rng(7)
    vals = rng.standard_normal((30, 2)).astype(np.float32)
    for ptr in (np.array([0, 4, 4, 9, 20], np.int32),
                np.array([3, 5, 5, 12], np.int32)):
        got = tseg.segment_csr(_t(vals), _t(ptr), reduce)
        ref = jseg.segment_csr(jnp.asarray(vals), jnp.asarray(ptr), reduce)
        _same(got, ref, TOL[np.float32])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("reduce", ["mean", "sum", "max"])
def test_segment_csr_half(dtype, reduce):
    """The mean of half-precision values sums in f32 and casts back."""
    rng = np.random.default_rng(3)
    ptr = _ptr(rng, 30, max_len=40)
    vals = torch.from_numpy(rng.standard_normal((int(ptr[-1]), 4))
                            .astype(np.float32)).to(dtype)
    got = tseg.segment_csr(vals, _t(ptr), reduce)
    ref = jseg.segment_csr(jnp.asarray(vals.float().numpy(),
                                       str(dtype)[6:]), jnp.asarray(ptr),
                           reduce)
    assert got.dtype == dtype
    _same(got, ref, HALF_TOL)
    if reduce == "mean":            # one rounding of the f32 mean
        exact = tseg.segment_csr(vals.double(), _t(ptr), "mean")
        torch.testing.assert_close(got.double(), exact,
                                   rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("out_len", [None, 17])
def test_gather_csr(out_len):
    rng = np.random.default_rng(1)
    ptr = _ptr(rng, 12)
    src = rng.standard_normal((12, 3)).astype(np.float32)
    got = tseg.gather_csr(_t(src), _t(ptr), out_len)
    ref = jseg.gather_csr(jnp.asarray(src), jnp.asarray(ptr), out_len)
    _same(got, ref, TOL[np.float32])


@pytest.mark.parametrize("ptr_dtype", [np.int32, np.int64])
def test_gather_segments(ptr_dtype):
    """Repeated, empty and out-of-order segments; every output equal,
    dtypes included."""
    rng = np.random.default_rng(2)
    ptr = _ptr(rng, 25).astype(ptr_dtype)
    idx = np.array([3, 0, 24, 3, 10, 4, 1, 1], np.int32)
    got = tseg.gather_segments(_t(ptr), _t(idx))
    ref = jseg.gather_segments(jnp.asarray(ptr), jnp.asarray(idx))
    for g, r in zip(got, ref):
        _same(g, r, TOL[np.int32])
    # perm names the source elements of each selected segment, in order
    want = np.concatenate([np.arange(ptr[i], ptr[i + 1]) for i in idx])
    np.testing.assert_array_equal(got[3].numpy(), want)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("trailing", TRAILING)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scatter_reduce(reduce, trailing, dtype):
    """Unsorted ids, among them ids below 0 and at or past num_segments
    (dropped), and empty segments."""
    rng = np.random.default_rng(len(reduce) * 10 + len(trailing))
    E, S = 300, 50
    ids = rng.integers(-4, S + 4, E).astype(np.int32)
    ids[np.isin(ids, [0, 17, S - 1])] = S + 1       # empty segments
    vals = _values(rng, E, trailing, dtype)
    if reduce == "mean" and dtype == np.int32:
        vals = vals.astype(np.float32)   # JAX's int mean dtype is its own
    got = tseg.scatter_reduce(_t(vals), _t(ids), S, reduce)
    ref = jseg.scatter_reduce(jnp.asarray(vals), jnp.asarray(ids), S, reduce)
    _same(got, ref, TOL[vals.dtype.type])
    assert not got[[0, 17, S - 1]].any()


def test_scatter_reduce_bf16_mean_keeps_dtype():
    """Unlike ``segment_csr``, the scatter mean sums in the value dtype."""
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 20, 200).astype(np.int64)
    vals = torch.from_numpy(rng.standard_normal(200).astype(np.float32)
                            ).bfloat16()
    got = tseg.scatter_reduce(vals, _t(ids), 20, "mean")
    ref = jseg.scatter_reduce(jnp.asarray(vals.float().numpy(), jnp.bfloat16),
                              jnp.asarray(ids), 20, "mean")
    assert got.dtype == torch.bfloat16
    _same(got, ref, HALF_TOL)


@pytest.mark.parametrize("reduce,vals", [
    ("max", [3., 3., 1., 2., 2., -1., 5.]),
    ("max", [0., 0., -1., 0., 0., 0., 5.]),
    ("min", [0., 0., 1., 2., 2., -1., 5.])])
def test_scatter_reduce_grad_splits_ties(reduce, vals):
    """The gradient of a segment max or min is split evenly among the tied
    entries alone in both packages, ties at 0 (an empty segment's value)
    too."""
    vals = np.array(vals, np.float64)
    ids = np.array([0, 0, 0, 1, 1, 3, 9])
    w = np.array([1., 2., 3., 4.])
    jg = jax.grad(lambda v: (jseg.scatter_reduce(v, jnp.asarray(ids), 4,
                                                 reduce) * w).sum())(
        jnp.asarray(vals))
    tv = _t(vals).requires_grad_()
    (tseg.scatter_reduce(tv, _t(ids), 4, reduce) * _t(w)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=0)
    assert tv.grad.tolist() == [0.5, 0.5, 0, 1, 1, 4, 0]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("length", [0, 1, 30])
def test_bincount(weighted, length):
    """Ids outside ``[0, length)`` are dropped, so the output always has
    ``length`` entries; ones in the index dtype without weights."""
    rng = np.random.default_rng(length)
    idx = rng.integers(-3, 34, 500).astype(np.int32)
    w = rng.standard_normal((500, 2)).astype(np.float32) if weighted else None
    got = tseg.bincount(_t(idx), None if w is None else _t(w), length)
    ref = jseg.bincount(jnp.asarray(idx), None if w is None else
                        jnp.asarray(w), length)
    _same(got, ref, TOL[np.float32 if weighted else np.int32])


def test_unknown_reduction():
    ptr, vals = torch.tensor([0, 2]), torch.ones(2)
    with pytest.raises(ValueError, match="unknown reduction"):
        tseg.segment_csr(vals, ptr, "prod")
    with pytest.raises(ValueError, match="unknown reduction"):
        tseg.scatter_reduce(vals, ptr[:2], 2, "prod")


def _hub_rows(rng, num_rows=12, hub=23):
    """A sorted row index with an empty first and last row and a hub row
    that spans several groups of 4."""
    lens = rng.integers(0, 6, num_rows)
    lens[[0, -1]] = 0
    lens[3] = hub
    return np.repeat(np.arange(num_rows), lens), num_rows


def test_row_groups(monkeypatch):
    """Groups never cross a row or an aligned block of ``GROUP`` entries
    (4 here), and ``group_row`` names each group's row."""
    monkeypatch.setattr(tseg, "GROUP", 4)
    rng = np.random.default_rng(0)
    row, M = _hub_rows(rng)
    g = tseg.row_groups(_t(row), M)
    eg, gr = g.entry_group.numpy(), g.group_row.numpy()
    assert (np.diff(eg) >= 0).all() and eg[0] == 0
    assert (gr[eg] == row).all()
    assert np.bincount(eg).max() <= 4
    assert gr.size == M + -(-row.size // 4)
    new = np.flatnonzero(np.diff(eg)) + 1
    assert set(new) == {i for i in range(1, row.size)
                        if row[i] != row[i - 1] or i % 4 == 0}


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_grouped_ops_match_plain(trailing, monkeypatch):
    """``grouped_sum``, ``grouped_max`` (``-inf`` for empty rows),
    ``grouped_gather`` and ``take_rows`` against ``index_add``,
    ``scatter_reduce`` and ``t[row]``, values and gradients, in f64, with
    groups of 4."""
    monkeypatch.setattr(tseg, "GROUP", 4)
    rng = np.random.default_rng(len(trailing))
    row, M = _hub_rows(rng)
    g = tseg.row_groups(_t(row), M)
    rt = _t(row)
    v = _t(rng.standard_normal((row.size,) + trailing)).requires_grad_()
    w = _t(rng.standard_normal((M,) + trailing))
    idx = rt.reshape((-1,) + (1,) * len(trailing)).expand_as(v)
    plain = [torch.zeros((M,) + trailing, dtype=v.dtype).index_add(0, rt, v),
             torch.full((M,) + trailing, float("-inf"), dtype=v.dtype)
             .scatter_reduce(0, idx, v, "amax", include_self=False)]
    grouped = [tseg.grouped_sum(v, g), tseg.grouped_max(v, g)]
    for a, b in zip(grouped, plain):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
        ga, = torch.autograd.grad(torch.where(torch.isfinite(a), a, 0).mul(w)
                                  .sum(), v)
        gb, = torch.autograd.grad(torch.where(torch.isfinite(b), b, 0).mul(w)
                                  .sum(), v)
        torch.testing.assert_close(ga, gb, rtol=1e-12, atol=1e-12)
    t = w.clone().requires_grad_()
    u = _t(rng.standard_normal((row.size,) + trailing))
    want = torch.zeros_like(w).index_add(0, rt, u)
    for out in (tseg.grouped_gather(t, g), tseg.take_rows(t, rt)):
        torch.testing.assert_close(out, w[rt], rtol=0, atol=0)
        gt, = torch.autograd.grad((out * u).sum(), t)
        torch.testing.assert_close(gt, want, rtol=1e-12, atol=1e-12)
