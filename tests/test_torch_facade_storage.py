"""Port parity: the eager facade's core, ``paddle_sparse_tpu_torch.storage``
and ``.tensor``, against the JAX ``SparseStorage``/``SparseTensor`` on the
same numpy inputs: the golden tables of ``tests/test_storage.py`` and
``tests/test_tensor.py`` over the dtype grid, and random seeded matrices
(unsorted input, duplicates, empty rows and columns, nnz = 0, trailing value
dims), field for field, caches and their presence included.

Tolerances: indices, structure and copied values exact; values summed by
``coalesce`` and ``to_symmetric`` ``rtol=atol=1e-6`` in f32 and ``1e-12``
in f64 (sums in another order), exact for integers.

Where torch differs from JAX on purpose: ``requires_grad()`` says whether
``value`` requires grad (JAX's shim answers ``has_value()``), and
``requires_grad_``/``detach`` act on the value tensor; ``eye`` without a
dtype gives torch's default float (JAX under x64: f64)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu.storage import SparseStorage as JStorage
from paddle_sparse_tpu_torch.ops.convert import ind2ptr, ptr2ind
from paddle_sparse_tpu_torch.storage import SparseStorage
from paddle_sparse_tpu_torch.utils import (index_sort, is_row_col_sorted,
                                           lexsort_rowcol, same_buffer)

DTYPES = [(torch.float16, jnp.float16), (torch.bfloat16, jnp.bfloat16),
          (torch.float32, jnp.float32), (torch.float64, jnp.float64),
          (torch.int32, jnp.int32), (torch.int64, jnp.int64)]
DT_IDS = ["f16", "bf16", "f32", "f64", "i32", "i64"]
SUM_TOL = {np.float32: dict(rtol=1e-6, atol=1e-6),
           np.float64: dict(rtol=1e-12, atol=1e-12)}
FIELDS = ("row", "rowptr", "col", "value", "rowcount", "colptr", "colcount",
          "csr2csc", "csc2csr")


def _np(a):
    """A torch or JAX array as numpy, floats widened to f64."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.double() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float64) if jnp.issubdtype(a.dtype, jnp.floating) \
        else a


def _same(t, j, tol=None):
    t, j = _np(t), _np(j)
    if t is None or j is None:
        assert t is None and j is None
        return
    assert t.shape == j.shape, (t.shape, j.shape)
    if tol is None:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **tol)


def _same_storage(ts, js, tol=None):
    """Sizes, every field (cached or not: presence too) and cached keys."""
    assert ts.sparse_sizes() == js.sparse_sizes()
    assert ts.cached_keys() == js.cached_keys()
    for name in FIELDS:
        _same(getattr(ts, f"_{name}"), getattr(js, f"_{name}"),
              tol if name == "value" else None)


def _rand(seed, M=12, N=9, nnz=40, trailing=(), dtype=np.float32,
          empty_rows=(0, 5), empty_cols=(2,)):
    """Unsorted COO with duplicates (a block of entries repeated), the
    given rows and cols empty, values of ``dtype``."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, M, nnz)
    col = rng.integers(0, N, nnz)
    keep = ~np.isin(row, empty_rows) & ~np.isin(col, empty_cols)
    row, col = row[keep], col[keep]
    k = len(row) // 4
    row, col = np.concatenate([row, row[:k]]), np.concatenate([col, col[:k]])
    perm = rng.permutation(len(row))
    row, col = row[perm], col[perm]
    value = rng.standard_normal((len(row),) + trailing).astype(dtype)
    return row, col, value, (M, N)


CASES = {
    "dups": dict(seed=0),
    "trailing": dict(seed=1, trailing=(3,)),
    "f64": dict(seed=2, dtype=np.float64),
    "nnz0": dict(seed=3, nnz=0),
    "one_row": dict(seed=4, M=1, N=30, empty_rows=()),
    "wide": dict(seed=5, M=40, N=3, nnz=120, empty_cols=()),
}


def _pair(row, col, value, sizes, **kw):
    J = jsp.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if value is None else jnp.asarray(value),
                         sparse_sizes=sizes, **kw)
    T = tsp.SparseTensor(row=torch.from_numpy(row), col=torch.from_numpy(col),
                         value=None if value is None
                         else torch.from_numpy(value), sparse_sizes=sizes,
                         **kw)
    return T, J


# ---------------------------------------------------------------------------
# golden tables of tests/test_storage.py, both packages
# ---------------------------------------------------------------------------
def test_ind2ptr():
    row = torch.tensor([2, 2, 4, 5, 5, 6])
    rowptr = ind2ptr(row, 8)
    assert rowptr.tolist() == [0, 0, 0, 2, 2, 3, 5, 6, 6]
    assert ptr2ind(rowptr, 6).tolist() == [2, 2, 4, 5, 5, 6]
    rowptr = ind2ptr(torch.tensor([], dtype=torch.long), 8)
    assert rowptr.tolist() == [0] * 9
    assert ptr2ind(rowptr, 0).tolist() == []


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_storage(dtype):
    td, jd = dtype
    idx = [[0, 0, 1, 1], [1, 0, 1, 0]]
    ts = SparseStorage(row=torch.tensor(idx[0]), col=torch.tensor(idx[1]),
                       value=torch.tensor([2, 1, 4, 3], dtype=td))
    js = JStorage(row=jnp.asarray(idx[0]), col=jnp.asarray(idx[1]),
                  value=jnp.asarray([2, 1, 4, 3], dtype=jd))
    assert ts.row().tolist() == [0, 0, 1, 1]
    assert ts.col().tolist() == [0, 1, 0, 1]
    assert ts.value().dtype == td
    assert _np(ts.value()).tolist() == [1, 2, 3, 4]
    assert ts.sparse_sizes() == (2, 2)
    _same_storage(ts, js)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_caching(dtype):
    row, col = torch.tensor([[0, 0, 1, 1], [0, 1, 0, 1]])
    ts = SparseStorage(row=row, col=col)
    js = JStorage(row=jnp.asarray(row.numpy()), col=jnp.asarray(col.numpy()))
    assert ts.num_cached_keys() == 0 and ts._value is None
    ts.fill_cache_()
    js.fill_cache_()
    assert ts._rowcount.tolist() == [2, 2]
    assert ts._rowptr.tolist() == [0, 2, 4]
    assert ts._colcount.tolist() == [2, 2]
    assert ts._colptr.tolist() == [0, 2, 4]
    assert ts._csr2csc.tolist() == [0, 2, 1, 3]
    assert ts._csc2csr.tolist() == [0, 2, 1, 3]
    assert ts.num_cached_keys() == 5
    _same_storage(ts, js)

    ts = SparseStorage(
        row=row, rowptr=ts._rowptr, col=col, value=ts._value,
        sparse_sizes=ts._sparse_sizes, rowcount=ts._rowcount,
        colptr=ts._colptr, colcount=ts._colcount, csr2csc=ts._csr2csc,
        csc2csr=ts._csc2csr)
    assert ts.num_cached_keys() == 5
    ts.clear_cache_()
    js.clear_cache_()
    assert ts._rowptr is not None and ts.num_cached_keys() == 0
    _same_storage(ts, js)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_utility(dtype):
    td, jd = dtype
    row, col = [0, 0, 1, 1], [1, 0, 1, 0]
    tv = torch.tensor([1, 2, 3, 4], dtype=td)
    jv = jnp.asarray([1, 2, 3, 4], dtype=jd)
    ts = SparseStorage(row=torch.tensor(row), col=torch.tensor(col), value=tv)
    js = JStorage(row=jnp.asarray(row), col=jnp.asarray(col), value=jv)
    assert ts.has_value()
    for layout, want in (("csc", [1, 3, 2, 4]), ("coo", [1, 2, 3, 4])):
        ts.set_value_(tv, layout=layout)
        js.set_value_(jv, layout=layout)
        assert _np(ts.value()).tolist() == want
        _same_storage(ts, js)
    for layout, want in (("csc", [1, 3, 2, 4]), ("coo", [1, 2, 3, 4])):
        ts = ts.set_value(tv, layout=layout)
        js = js.set_value(jv, layout=layout)
        assert _np(ts.value()).tolist() == want
        _same_storage(ts, js)

    ts, js = ts.sparse_resize((3, 3)), js.sparse_resize((3, 3))
    assert ts.sparse_sizes() == (3, 3)
    _same_storage(ts, js)
    new = ts.copy()
    assert new is not ts and same_buffer(new.col(), ts.col())
    new = ts.clone()
    assert new is not ts and not same_buffer(new.col(), ts.col())
    _same_storage(new, js)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_coalesce(dtype):
    td, jd = dtype
    row, col = [0, 0, 0, 1, 1], [0, 1, 1, 0, 1]
    ts = SparseStorage(row=torch.tensor(row), col=torch.tensor(col),
                       value=torch.tensor([1, 1, 1, 3, 4], dtype=td))
    js = JStorage(row=jnp.asarray(row), col=jnp.asarray(col),
                  value=jnp.asarray([1, 1, 1, 3, 4], dtype=jd))
    assert not ts.is_coalesced()
    ts, js = ts.coalesce(), js.coalesce()
    assert ts.is_coalesced()
    assert ts.row().tolist() == [0, 0, 1, 1]
    assert ts.col().tolist() == [0, 1, 0, 1]
    assert _np(ts.value()).tolist() == [1, 2, 3, 4]
    assert ts.value().dtype == td
    _same_storage(ts, js)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sparse_reshape(dtype):
    idx = [0, 1, 2, 3]
    ts = SparseStorage(row=torch.tensor(idx), col=torch.tensor(idx))
    js = JStorage(row=jnp.asarray(idx), col=jnp.asarray(idx))
    for shape, rows, cols in (((2, 8), [0, 0, 1, 1], [0, 5, 2, 7]),
                              ((-1, 4), [0, 1, 2, 3], [0, 1, 2, 3]),
                              ((2, -1), [0, 0, 1, 1], [0, 5, 2, 7])):
        ts, js = ts.sparse_reshape(*shape), js.sparse_reshape(*shape)
        assert ts.row().tolist() == rows and ts.col().tolist() == cols
        _same_storage(ts, js)
    with pytest.raises(ValueError):
        ts.sparse_reshape(3, 5)


# ---------------------------------------------------------------------------
# random matrices: construction, caches, coalesce, resize, reshape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_construct_and_fill_cache(case):
    row, col, value, sizes = _rand(**CASES[case])
    T, J = _pair(row, col, value, sizes)
    _same_storage(T.storage, J.storage)
    assert T.is_coalesced() == J.is_coalesced()
    T.fill_cache_()
    J.fill_cache_()
    _same_storage(T.storage, J.storage)
    for fmt in ("coo", "csr", "csc"):
        for a, b in zip(getattr(T, fmt)(), getattr(J, fmt)()):
            _same(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_from_rowptr_and_sizes_inferred(case):
    """A storage given ``rowptr`` alone expands ``row``; sizes left out
    are inferred from the indices."""
    row, col, value, sizes = _rand(**CASES[case])
    T, J = _pair(row, col, value, None)
    assert T.sparse_sizes() == J.sparse_sizes()
    rowptr, c, v = J.csr()
    for is_sorted in (True, False):
        ts = SparseStorage(rowptr=torch.from_numpy(np.array(rowptr)),
                           col=torch.from_numpy(np.array(c)),
                           value=torch.from_numpy(np.array(v)),
                           is_sorted=is_sorted)
        js = JStorage(rowptr=rowptr, col=c, value=v, is_sorted=is_sorted)
        assert ts.has_row() == js.has_row() == (not is_sorted and
                                                 len(row) > 1)
        _same(ts.row(), js.row())
        _same_storage(ts, js)


@pytest.mark.parametrize("reduce", ["sum", "add", "mean", "min", "max"])
@pytest.mark.parametrize("case", ["dups", "trailing", "f64", "nnz0"])
def test_coalesce_random(case, reduce):
    row, col, value, sizes = _rand(**CASES[case])
    T, J = _pair(row, col, value, sizes)
    tc, jc = T.storage.coalesce(reduce), J.storage.coalesce(reduce)
    _same_storage(tc, jc, SUM_TOL[value.dtype.type])
    assert tc.is_coalesced()


@pytest.mark.parametrize("case", ["dups", "trailing", "nnz0"])
@pytest.mark.parametrize("sizes", [(20, 15), (3, 4)])
def test_sparse_resize_random(case, sizes):
    row, col, value, shape = _rand(**CASES[case])
    keep = (row < sizes[0]) & (col < sizes[1])
    T, J = _pair(row[keep], col[keep], value[keep], shape)
    T.fill_cache_()
    J.fill_cache_()
    _same_storage(T.storage.sparse_resize(sizes),
                  J.storage.sparse_resize(sizes))


@pytest.mark.parametrize("case", ["dups", "nnz0", "one_row"])
def test_sparse_reshape_random(case):
    row, col, value, (M, N) = _rand(**CASES[case])
    T, J = _pair(row, col, value, (M, N))
    for shape in ((1, -1), (M * N // 3 if (M * N) % 3 == 0 else M * N, -1)):
        _same_storage(T.storage.sparse_reshape(*shape),
                      J.storage.sparse_reshape(*shape))


def test_validation_errors():
    col = torch.tensor([0, 1])
    with pytest.raises(ValueError, match="col index out of bounds"):
        SparseStorage(row=torch.tensor([0, 0]), col=col, sparse_sizes=(1, 1))
    with pytest.raises(ValueError, match="row index out of bounds"):
        SparseStorage(row=torch.tensor([0, 3]), col=col, sparse_sizes=(2, 2))
    with pytest.raises(ValueError, match="nnz"):
        SparseStorage(row=torch.tensor([0, 1]), col=col,
                      value=torch.ones(3))
    with pytest.raises(ValueError, match="integer"):
        SparseStorage(row=torch.tensor([0.0, 1.0]), col=col)
    with pytest.raises(ValueError, match="layout"):
        SparseStorage(row=torch.tensor([0, 1]), col=col).set_value(
            torch.ones(2), layout="bogus")
    with pytest.warns(UserWarning, match="layout"):
        SparseStorage(row=torch.tensor([0, 1]), col=col).set_value(
            torch.ones(2))


@pytest.mark.parametrize("seed", range(3))
def test_utils_match_jax(seed):
    from paddle_sparse_tpu import utils as jutils
    rng = np.random.default_rng(seed)
    row = rng.integers(0, 5, 30)
    col = rng.integers(0, 4, 30)
    perm = lexsort_rowcol(torch.from_numpy(row), torch.from_numpy(col))
    _same(perm, jutils.lexsort_rowcol(jnp.asarray(row), jnp.asarray(col)))
    assert is_row_col_sorted(torch.from_numpy(row[_np(perm)]),
                             torch.from_numpy(col[_np(perm)]))
    assert is_row_col_sorted(torch.from_numpy(row), torch.from_numpy(col)) \
        == jutils.is_row_col_sorted(jnp.asarray(row), jnp.asarray(col))
    for a, b in zip(index_sort(torch.from_numpy(row)),
                    jutils.index_sort(jnp.asarray(row))):
        _same(a, b)


# ---------------------------------------------------------------------------
# mutation rebinds: a copy never sees its source's in-place ops
# ---------------------------------------------------------------------------
def test_copy_unchanged_after_inplace_ops():
    row, col, value, sizes = _rand(seed=7, empty_rows=())
    T, _ = _pair(row, col, value, sizes)
    C = T.copy()
    before = C.storage.value().clone()
    T.storage.value().requires_grad_()      # a leaf: in-place writes raise
    M, N = sizes
    T.add_(torch.arange(M, dtype=torch.float32).view(-1, 1))
    T.mul_(torch.full((1, N), 2.0))
    T.add_nnz_(torch.ones(T.nnz()), layout="coo")
    T.mul_nnz_(torch.full((T.nnz(),), 3.0), layout="coo")
    T.set_value_(torch.zeros(T.nnz()), layout="coo")
    T.fill_value_(5.0)
    T.storage.apply_value_(lambda v: v + 1)
    T.detach_()
    T += torch.ones(M, 1)
    T *= torch.ones(1, N)
    assert torch.equal(C.storage.value(), before)
    assert C.storage.value().requires_grad
    assert same_buffer(C.storage.col(), T.storage.col())
    assert bool((T.storage.value() == 7.0).all())


def test_requires_grad_and_detach():
    """torch autograd on ``value``: ``requires_grad()`` is the value's flag
    (JAX's shim answers ``has_value()``); a value-less tensor gets ones."""
    T = tsp.SparseTensor(row=torch.tensor([0, 1]), col=torch.tensor([1, 0]))
    J = jsp.SparseTensor(row=jnp.asarray([0, 1]), col=jnp.asarray([1, 0]))
    assert not T.requires_grad() and J.requires_grad() == J.has_value()
    T.requires_grad_(dtype=torch.float64)
    assert T.requires_grad() and T.storage.value().dtype == torch.float64
    assert T.storage.value().tolist() == [1.0, 1.0]
    D = T.detach()
    assert not D.requires_grad() and T.requires_grad()
    T.requires_grad_(False)
    assert not T.requires_grad()
    v = torch.ones(2, requires_grad=True)
    T = T.set_value(v * 2, layout="coo")
    T.detach_()
    assert not T.requires_grad()


# ---------------------------------------------------------------------------
# tensor facade: golden tables of tests/test_tensor.py, both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [(torch.float32, jnp.float32),
                                   (torch.float64, jnp.float64)],
                         ids=["f32", "f64"])
def test_getitem(dtype):
    td, jd = dtype
    rng = np.random.default_rng(1234)
    m, n, k = 50, 40, 10
    dense = rng.standard_normal((m, n))
    dense[rng.random((m, n)) < 0.7] = 0
    T = tsp.SparseTensor.from_dense(torch.tensor(dense, dtype=td))
    J = jsp.SparseTensor.from_dense(jnp.asarray(dense, dtype=jd))
    idx1 = rng.integers(0, m, (k,))
    idx2 = rng.integers(0, n, (k,))
    bool1 = np.zeros(m, bool)
    bool1[idx1] = True
    bool2 = np.zeros(n, bool)
    bool2[idx2] = True
    keys = [(slice(None, k), slice(None, k)), (Ellipsis, slice(None, k)),
            (idx1, idx2), (idx1.tolist(), idx2.tolist()),
            (torch.from_numpy(idx1), torch.from_numpy(idx2)),
            (bool1, bool2), (bool1.tolist(), bool2.tolist()),
            (torch.from_numpy(bool1), torch.from_numpy(bool2)),
            idx1, bool1, 3, (slice(-5, None), -2), (slice(2, 9), 4)]
    sizes = [[k, k], [m, k], [k, k], [k, k], [k, k], [bool1.sum(), bool2.sum()],
             [bool1.sum(), bool2.sum()], [bool1.sum(), bool2.sum()],
             [k, n], [bool1.sum(), n], [1, n], [5, 1], [7, 1]]
    for key, size in zip(keys, sizes):
        jkey = key if not isinstance(key, tuple) else tuple(
            jnp.asarray(i.numpy()) if isinstance(i, torch.Tensor) else i
            for i in key)
        out = T[key]
        assert out.sizes() == size
        _same(out.to_dense(), J[jkey].to_dense())
        _same_storage(out.storage, J[jkey].storage)
    with pytest.raises(SyntaxError):
        T[..., ...]
    with pytest.raises(ValueError, match="step"):
        T[::2]


def test_to_symmetric():
    row, col = [0, 0, 0, 1, 1], [0, 1, 2, 0, 2]
    T, J = _pair(np.asarray(row), np.asarray(col), np.arange(1, 6), None)
    assert not T.is_symmetric() and not J.is_symmetric()
    S, JS = T.to_symmetric(), J.to_symmetric()
    assert S.is_symmetric() and JS.is_symmetric()
    assert S.to_dense().tolist() == [[2, 6, 3], [6, 0, 5], [3, 5, 0]]
    _same_storage(S.storage, JS.storage)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("case", ["dups", "trailing", "wide"])
def test_to_symmetric_random(case, reduce):
    row, col, value, (M, N) = _rand(**CASES[case])
    T, J = _pair(row, col, value, (M, N))
    S, JS = T.to_symmetric(reduce), J.to_symmetric(reduce)
    _same_storage(S.storage, JS.storage, SUM_TOL[np.float32])
    assert S.is_symmetric() == JS.is_symmetric()


def test_to_symmetric_empty():
    """nnz = 0 gives an empty square matrix. The JAX facade raises here
    (its keep mask starts with one entry even for no entries), a reference
    fault the port does not copy."""
    T, J = _pair(np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.float32), (3, 5))
    S = T.to_symmetric()
    assert S.sparse_sizes() == (5, 5) and S.nnz() == 0
    assert S.storage.value().shape == (0,)
    with pytest.raises(IndexError):
        J.to_symmetric()


def test_equal():
    row, col = torch.tensor([0, 0, 0, 1, 1]), torch.tensor([0, 1, 2, 0, 2])
    value = torch.arange(1, 6)
    A = tsp.SparseTensor(row=row, col=col, value=value)
    B = tsp.SparseTensor(row=row, col=col, value=value)
    C = tsp.SparseTensor(row=row, col=torch.tensor([0, 1, 2, 0, 1]),
                         value=value)
    assert id(A) != id(B) and A == B
    assert A != C and A != B.set_value(None) and A != "A"


def test_to():
    T = tsp.SparseTensor(row=torch.tensor([0, 0, 0, 1, 1]),
                         col=torch.tensor([0, 1, 2, 0, 2]),
                         value=torch.arange(1, 6))
    assert T.storage.value().dtype == torch.int64
    T = T.to(torch.float32)
    assert T.storage.value().dtype == torch.float32
    T = T.to("cpu", torch.float64)
    assert T.storage.value().dtype == torch.float64
    assert T.device() == torch.device("cpu")
    T = T.to(torch.zeros(1, dtype=torch.float16))
    assert T.dtype() == torch.float16
    T = T.to(device="cpu", dtype=torch.float32)
    assert T.dtype() == torch.float32 and not T.is_cuda()
    with pytest.raises(TypeError):
        T.to()


def test_dtype_helpers():
    T = tsp.SparseTensor.eye(3)
    assert T.dtype() == torch.float32 and T.is_floating_point()
    for name, dt in (("bfloat16", torch.bfloat16), ("bool", torch.bool),
                     ("byte", torch.uint8), ("char", torch.int8),
                     ("half", torch.float16), ("double", torch.float64),
                     ("short", torch.int16), ("int", torch.int32),
                     ("long", torch.int64), ("float", torch.float32)):
        assert getattr(T, name)().dtype() == dt
    assert T.type_as(torch.zeros(1, dtype=torch.int32)).dtype() == torch.int32
    assert T.with_index_dtype(torch.int32).index_dtype() == torch.int32
    assert T.set_value(None).dtype() == torch.float32


def test_from_dense_multi_dim():
    mat = np.zeros((3, 4, 2), np.float32)
    mat[0, 1] = [1.0, 2.0]
    mat[2, 3] = [3.0, 4.0]
    T = tsp.SparseTensor.from_dense(mat)
    assert T.sizes() == [3, 4, 2] and T.nnz() == 2
    np.testing.assert_array_equal(T.to_dense().numpy(), mat)
    _same_storage(T.storage, jsp.SparseTensor.from_dense(
        jnp.asarray(mat)).storage)
    assert not T.from_dense(mat, has_value=False).has_value()


def test_stats_and_repr():
    T = tsp.SparseTensor.eye(4, 6)
    J = jsp.SparseTensor.eye(4, 6)
    assert T.is_quadratic() is False
    assert T.density() == 4 / 24
    assert T.bandwidth() == 0 and T.avg_bandwidth() == 0.0
    row, col, value, sizes = _rand(seed=9)
    T, J = _pair(row, col, value, sizes)
    for name in ("density", "sparsity", "avg_row_length", "avg_col_length",
                 "bandwidth", "avg_bandwidth", "nnz", "numel", "dim",
                 "is_quadratic"):
        assert getattr(T, name)() == pytest.approx(getattr(J, name)())
    assert T.bandwidth_proportion(3) == J.bandwidth_proportion(3)
    assert T.sizes() == J.sizes() and T.size(1) == J.size(1)
    assert "SparseTensor" in repr(T) and "nnz=" in repr(T)


def test_padded_roundtrip():
    """``to_padded``/``from_padded`` (the JAX test's pytree round trip)."""
    P = tsp.SparseTensor.eye(5).to_padded(capacity=8)
    assert P.capacity == 8 and P.nnz == 5
    back = tsp.SparseTensor.from_padded(P)
    assert back == tsp.SparseTensor.eye(5)
    row, col, value, sizes = _rand(seed=3, trailing=(2,))
    T, J = _pair(row, col, value, sizes)
    TP, JP = T.to_padded(capacity=T.nnz() + 7), J.to_padded(
        capacity=J.nnz() + 7)
    for name in ("row", "col", "value"):
        _same(getattr(TP, name), getattr(JP, name))
    assert TP.nnz == int(JP.nnz) and TP.shape == JP.shape
    _same_storage(TP.to_eager().storage, JP.to_eager().storage)


def test_eye():
    for M, N, fill in ((3, None, False), (3, 4, True), (4, 3, True)):
        T = tsp.SparseTensor.eye(M, N, dtype=torch.float64,
                                 fill_cache=fill)
        J = jsp.SparseTensor.eye(M, N, dtype=jnp.float64, fill_cache=fill)
        _same_storage(T.storage, J.storage)
    assert tsp.SparseTensor.eye(3).dtype() == torch.get_default_dtype()
    assert not tsp.SparseTensor.eye(3, has_value=False).has_value()


def test_devices_cpu():
    T = tsp.SparseTensor.eye(3)
    assert T.cpu().device() == torch.device("cpu")
    assert T.device_as(torch.zeros(1)).device() == torch.device("cpu")
    assert not T.is_pinned()
    assert T.share_memory_().is_shared()
    assert T.storage.value().is_shared()


def test_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T = tsp.SparseTensor.eye(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.cuda()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.to("cuda")


def test_from_edge_index_and_empty():
    ei = np.asarray([[2, 0, 1, 0], [0, 1, 2, 1]])
    T = tsp.SparseTensor.from_edge_index(torch.from_numpy(ei),
                                         torch.arange(4.0), (3, 3))
    J = jsp.SparseTensor.from_edge_index(jnp.asarray(ei),
                                         jnp.arange(4.0), (3, 3))
    _same_storage(T.storage, J.storage)
    E = SparseStorage.empty()
    assert E.sparse_sizes() == (0, 0) and E.nnz() == 0
    assert E.row().dtype == torch.long


def test_jax_untouched_by_x64_casts():
    """The JAX facade keeps int64 indices under the tests' x64 mode; the
    port keeps the caller's dtype too, int32 or int64."""
    assert jax.config.jax_enable_x64
    for dt in (torch.int32, torch.int64):
        T = tsp.SparseTensor(row=torch.tensor([1, 0], dtype=dt),
                             col=torch.tensor([0, 1], dtype=dt))
        assert T.storage.row().dtype == dt and T.storage.rowptr().dtype == dt
        assert T.fill_cache_().storage.csr2csc().dtype == dt
