"""Port parity: the facade's ``matmul`` (``A @ x`` and ``A @ B``), ``spmm``
and ``spspmm`` against the JAX facade on the same numpy inputs: the golden
cases of ``tests/test_matmul.py``, random seeded matrices (unsorted input,
duplicates, empty rows and columns, nnz = 0) with every ``reduce`` and
``x`` of 1, 2 and 3 dims, the gradients with respect to ``value`` and ``x``
against ``jax.grad``, the SpGEMM values' gradients, and the slice end to
end: PyG's ``gcn_norm`` on a value-less ``SparseTensor`` and two
propagations, forward and gradients, against the same calls on the JAX
facade. Also: ``A @ x`` runs on the storage's cached int32 CSR and CSC view,
so a second forward+backward builds no CSC view (the ``csc_builds``
counter), and copies that keep the indices share that cache.

Tolerances: ``matmul`` and its ``value``/``x`` gradients ``rtol=atol=1e-5``
in f32 (sums in another order); ``1e-12`` in f64; structure exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu_torch.storage import SparseStorage

TOL = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)
REDUCES = ["sum", "mean", "min", "max"]


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.double() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float64) if jnp.issubdtype(a.dtype, jnp.floating) \
        else a


def _same(t, j, tol=None):
    if t is None or j is None:
        assert t is None and j is None
        return
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if tol is None:
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, **tol)


def _rand(seed, M=12, N=9, nnz=40, dtype=np.float32, empty_rows=(0, 5),
          empty_cols=(2,)):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, M, nnz)
    col = rng.integers(0, N, nnz)
    keep = ~np.isin(row, empty_rows) & ~np.isin(col, empty_cols)
    row, col = row[keep], col[keep]
    k = len(row) // 4
    row, col = np.concatenate([row, row[:k]]), np.concatenate([col, col[:k]])
    perm = rng.permutation(len(row))
    value = rng.standard_normal(len(row)).astype(dtype)
    return row[perm], col[perm], value, (M, N)


CASES = {
    "dups": dict(seed=0),
    "f64": dict(seed=2, dtype=np.float64),
    "nnz0": dict(seed=3, nnz=0),
    "square": dict(seed=4, M=10, N=10, nnz=45, empty_rows=(3,),
                   empty_cols=(7,)),
    "wide": dict(seed=5, M=6, N=40, nnz=90, empty_cols=()),
}


def _pair(row, col, value, sizes):
    J = jsp.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if value is None else jnp.asarray(value),
                         sparse_sizes=sizes)
    T = tsp.SparseTensor(row=torch.from_numpy(row), col=torch.from_numpy(col),
                         value=None if value is None
                         else torch.from_numpy(value), sparse_sizes=sizes)
    return T, J


def _case(case):
    row, col, value, sizes = _rand(**CASES[case])
    T, J = _pair(row, col, value, sizes)
    return T, J, value.dtype


def _rand_dense(m, n, density, seed):
    r = np.random.default_rng(seed)
    mask = r.random((m, n)) < density
    dense = np.where(mask, r.standard_normal((m, n)), 0.0).astype(np.float32)
    return (tsp.SparseTensor.from_dense(dense),
            jsp.SparseTensor.from_dense(jnp.asarray(dense)), dense)


# ---------------------------------------------------------------------------
# golden cases of tests/test_matmul.py, both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduce", REDUCES)
def test_spmm_dense_reduce(reduce):
    T, J, _ = _rand_dense(7, 5, 0.4, seed=1)
    X = np.random.default_rng(7).standard_normal((5, 3)).astype(np.float32)
    out = tsp.matmul(T, torch.from_numpy(X), reduce=reduce)
    row, col, val = map(_np, T.coo())
    expected = np.zeros((7, 3))
    for m in range(7):
        e = np.nonzero(row == m)[0]
        if len(e):
            prods = val[e, None] * X[col[e]]
            expected[m] = getattr(prods, {"sum": "sum", "mean": "mean",
                                          "min": "min", "max": "max"}[reduce]
                                  )(0)
    _same(out, expected, TOL)
    _same(out, jsp.matmul(J, jnp.asarray(X), reduce=reduce), TOL)


def test_spmm_matches_dense_and_no_value():
    T, J, dense = _rand_dense(10, 8, 0.3, seed=2)
    X = np.random.default_rng(8).standard_normal((8, 4)).astype(np.float32)
    _same(T @ torch.from_numpy(X), dense @ X, TOL)
    S = T.set_value(None)
    _same(S @ torch.from_numpy(X), (dense != 0).astype(np.float32) @ X, TOL)
    _same(S @ torch.from_numpy(X), J.set_value(None) @ jnp.asarray(X), TOL)
    _same(T @ X, dense @ X, TOL)          # a numpy operand
    with pytest.raises(ValueError, match="size mismatch"):
        T @ torch.ones(3, 2)


def test_spmm_grads_golden():
    T, J, _ = _rand_dense(6, 5, 0.4, seed=4)
    X = np.random.default_rng(9).standard_normal((5, 3)).astype(np.float32)
    row, col, val = T.coo()
    v = val.detach().clone().requires_grad_()
    x = torch.from_numpy(X).requires_grad_()
    tsp.matmul(T.set_value(v, layout="coo"), x).sum().backward()
    _same(v.grad, X[_np(col)].sum(1), TOL)
    gx = np.zeros((5, 3))
    np.add.at(gx, _np(col), _np(val)[:, None] * np.ones(3))
    _same(x.grad, gx, TOL)


def test_spmm_minmax_grads():
    T, J, _ = _rand_dense(6, 5, 0.5, seed=5)
    X = np.random.default_rng(10).standard_normal((5, 3)).astype(np.float32)
    jrow, jcol, jval = J.coo()
    for reduce in ("max", "min"):
        v = T.storage.value().detach().clone().requires_grad_()
        tsp.matmul(T.set_value(v, layout="coo"), torch.from_numpy(X),
                   reduce).sum().backward()

        def loss(value):
            A = jsp.SparseTensor(row=jrow, col=jcol, value=value,
                                 sparse_sizes=(6, 5), is_sorted=True,
                                 trust_data=True)
            return jsp.matmul(A, jnp.asarray(X), reduce).sum()
        _same(v.grad, jax.grad(loss)(jval), TOL)


def test_spspmm_matches_scipy_and_structural():
    TA, JA, dA = _rand_dense(6, 7, 0.3, seed=6)
    TB, JB, dB = _rand_dense(7, 5, 0.3, seed=7)
    C = tsp.matmul(TA, TB)
    _same(C.to_dense(), dA @ dB, dict(rtol=1e-4, atol=1e-5))
    assert C.is_coalesced()
    JC = jsp.matmul(JA, JB)
    for a, b in zip(C.coo(), JC.coo()):
        _same(a, b, TOL)
    TS, JS, dS = _rand_dense(4, 4, 0.4, seed=8)
    C = TS.set_value(None) @ TS.set_value(None)
    assert not C.has_value()
    m = (dS != 0).astype(np.float32)
    np.testing.assert_array_equal(C.to_dense().numpy() != 0, (m @ m) != 0)
    _same(C.storage.col(), (JS.set_value(None) @ JS.set_value(None)).storage
          .col())
    with pytest.raises(ValueError, match="reduce='sum'"):
        tsp.matmul(TA, TB, reduce="max")
    with pytest.raises(ValueError, match="size mismatch"):
        TA @ TA


def test_spspmm_tuple_api():
    indexA = np.asarray([[0, 0, 1, 2, 2], [1, 2, 0, 0, 1]])
    valueA = np.asarray([1., 2, 3, 4, 5], np.float32)
    indexB = np.asarray([[0, 2], [1, 0]])
    valueB = np.asarray([2., 4], np.float32)
    ti, tv = tsp.spspmm(torch.from_numpy(indexA), torch.from_numpy(valueA),
                        torch.from_numpy(indexB), torch.from_numpy(valueB),
                        3, 3, 2)
    ji, jv = jsp.spspmm(jnp.asarray(indexA), jnp.asarray(valueA),
                        jnp.asarray(indexB), jnp.asarray(valueB), 3, 3, 2)
    _same(ti, ji)
    _same(tv, jv, TOL)
    A = np.zeros((3, 3))
    A[indexA[0], indexA[1]] = valueA
    B = np.zeros((3, 2))
    B[indexB[0], indexB[1]] = valueB
    C = np.zeros((3, 2))
    C[_np(ti[0]), _np(ti[1])] = _np(tv)
    np.testing.assert_allclose(C, A @ B, rtol=1e-6)


def test_spmm_tuple_api():
    index = np.asarray([[0, 2, 1, 0, 2], [0, 1, 1, 2, 0]])
    value = np.asarray([1., 2, 3, 4, 5], np.float32)
    matrix = np.asarray([[1., 4], [2, 5], [3, 6]], np.float32)
    for reduce in REDUCES:
        out = tsp.spmm(torch.from_numpy(index), torch.from_numpy(value), 3, 3,
                       torch.from_numpy(matrix), reduce)
        _same(out, jsp.spmm(jnp.asarray(index), jnp.asarray(value), 3, 3,
                            jnp.asarray(matrix), reduce), TOL)
    A = np.zeros((3, 3))
    np.add.at(A, (index[0], index[1]), value)
    _same(tsp.spmm(index, None, 3, 3, matrix),
          (A != 0).astype(np.float32) @ matrix, TOL)


def test_spspmm_grads():
    TA, JA, _ = _rand_dense(5, 6, 0.4, seed=9)
    TB, JB, _ = _rand_dense(6, 4, 0.4, seed=10)
    va = TA.storage.value().detach().clone().requires_grad_()
    vb = TB.storage.value().detach().clone().requires_grad_()
    C = TA.set_value(va, layout="coo") @ TB.set_value(vb, layout="coo")
    (C.storage.value() ** 2).sum().backward()
    rowA, colA, valA = JA.coo()
    rowB, colB, valB = JB.coo()

    def loss(a, b):
        A2 = jsp.SparseTensor(row=rowA, col=colA, value=a,
                              sparse_sizes=(5, 6), is_sorted=True,
                              trust_data=True)
        B2 = jsp.SparseTensor(row=rowB, col=colB, value=b,
                              sparse_sizes=(6, 4), is_sorted=True,
                              trust_data=True)
        return (jsp.matmul(A2, B2).storage.value() ** 2).sum()
    ga, gb = jax.grad(loss, argnums=(0, 1))(valA, valB)
    _same(va.grad, ga, dict(rtol=1e-4, atol=1e-5))
    _same(vb.grad, gb, dict(rtol=1e-4, atol=1e-5))


# ---------------------------------------------------------------------------
# random matrices: every reduce, x of 1-3 dims, grads vs jax.grad
# ---------------------------------------------------------------------------
XSHAPES = {"vec": (), "mat": (5,), "3d": (2, 3)}


def _x(N, trailing, dtype, seed=21):
    return np.random.default_rng(seed).standard_normal(
        (N,) + trailing).astype(dtype)


@pytest.mark.parametrize("xs", list(XSHAPES))
@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("case", list(CASES))
def test_matmul_random(case, reduce, xs):
    T, J, dt = _case(case)
    X = _x(T.sparse_size(1), XSHAPES[xs], dt)
    tol = F64 if dt == np.float64 else TOL
    _same(T @ torch.from_numpy(X) if reduce == "sum"
          else T.matmul(torch.from_numpy(X), reduce),
          jsp.matmul(J, jnp.asarray(X), reduce), tol)
    _same(T.spmm(torch.from_numpy(X), reduce),
          jsp.matmul(J, jnp.asarray(X), reduce), tol)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("case", ["dups", "f64", "square", "wide"])
def test_matmul_grads_random(case, reduce):
    """``d value`` and ``d x`` of ``sum(w * (A @ x))`` against
    ``jax.grad`` of the JAX facade's ``matmul``."""
    T, J, dt = _case(case)
    tol = F64 if dt == np.float64 else TOL
    X = _x(T.sparse_size(1), (5,), dt)
    W = _x(T.sparse_size(0), (5,), dt, seed=22)
    row, col, val = T.coo()
    v = val.detach().clone().requires_grad_()
    x = torch.from_numpy(X).requires_grad_()
    out = tsp.matmul(T.set_value(v, layout="coo"), x, reduce)
    (out * torch.from_numpy(W)).sum().backward()

    jrow, jcol, jval = J.coo()

    def loss(value, xx):
        A = jsp.SparseTensor(row=jrow, col=jcol, value=value,
                             sparse_sizes=J.sparse_sizes(), is_sorted=True,
                             trust_data=True)
        return (jsp.matmul(A, xx, reduce) * jnp.asarray(W)).sum()
    gv, gx = jax.grad(loss, argnums=(0, 1))(jval, jnp.asarray(X))
    _same(v.grad, gv, tol)
    _same(x.grad, gx, tol)


@pytest.mark.parametrize("case", ["dups", "f64", "nnz0", "square"])
def test_spspmm_random(case):
    T, J, dt = _case(case)
    T2, J2, _ = _case("square" if case != "square" else "wide")
    if T.sparse_size(1) != T2.sparse_size(0):
        T2, J2 = T.t(), J.t()
    T2 = T2.type(T.dtype())
    J2 = J2.astype(J.dtype())
    tol = F64 if dt == np.float64 else TOL
    for a, b, ja, jb in ((T, T2, J, J2),
                         (T.set_value(None), T2, J.set_value(None), J2),
                         (T, T2.set_value(None), J, J2.set_value(None)),
                         (T.set_value(None), T2.set_value(None),
                          J.set_value(None), J2.set_value(None))):
        C, JC = a @ b, ja @ jb
        assert C.sparse_sizes() == JC.sparse_sizes()
        _same(C.storage.row(), JC.storage.row())
        _same(C.storage.col(), JC.storage.col())
        if C.has_value() and C.nnz():
            _same(C.storage.value(), JC.storage.value(), tol)
        assert C.has_value() == (a.has_value() or b.has_value())
        dense = scipy.sparse.csr_matrix(
            (np.ones(a.nnz()) if a.storage.value() is None
             else _np(a.storage.value()), _np(a.storage.col()),
             _np(a.storage.rowptr())), a.sparse_sizes()) @ \
            scipy.sparse.csr_matrix(
                (np.ones(b.nnz()) if b.storage.value() is None
                 else _np(b.storage.value()), _np(b.storage.col()),
                 _np(b.storage.rowptr())), b.sparse_sizes())
        if C.has_value():
            _same(C.to_dense(), dense.toarray(), tol)


# ---------------------------------------------------------------------------
# the storage's kernel caches
# ---------------------------------------------------------------------------
def test_second_backward_builds_no_csc_view():
    T, _, _ = _case("square")
    x = torch.from_numpy(_x(10, (4,), np.float32)).requires_grad_()
    T.requires_grad_()
    SparseStorage.csc_builds = 0
    (T @ x).sum().backward()
    assert SparseStorage.csc_builds == 1
    s = T.storage.spmm_structure()
    csr = T.storage.kernel_csr()
    g1 = (T.storage.value().grad.clone(), x.grad.clone())
    T.storage.value().grad = x.grad = None
    (T @ x).sum().backward()
    assert SparseStorage.csc_builds == 1
    assert T.storage.spmm_structure() is s and T.storage.kernel_csr() is csr
    assert torch.equal(T.storage.value().grad, g1[0])
    assert torch.equal(x.grad, g1[1])
    # the structure is the CSR of the transpose, from the cached csr2csc
    assert s.perm.dtype == torch.int32 and s.colptr.dtype == torch.int32
    assert torch.equal(s.perm.long(), T.storage.csr2csc())
    assert torch.equal(s.colptr.long(), T.storage.colptr())
    assert torch.equal(s.col_t.long(), T.t().storage.col())
    assert s.row_split is None and s.col_split is None


def test_kernel_cache_shared_by_value_copies():
    """``copy``, ``set_value``, ``mul`` by a dense operand and
    ``requires_grad_`` keep the indices, so they share the int32 CSR and
    the CSC view; index-changing ops and ``clear_cache_`` start anew."""
    adj, x = tsp.facade_entry("cpu")
    x = x[:, :4]
    rowptr, col, split = adj.storage.kernel_csr()
    assert rowptr.dtype == col.dtype == torch.int32
    assert adj.storage.col().dtype == torch.int64
    assert adj.storage.kernel_csr()[0] is rowptr
    SparseStorage.csc_builds = 0
    norm = tsp.gcn_norm(adj)
    norm @ x
    norm.storage.spmm_structure()
    for other in (norm.copy(),
                  norm.set_value(norm.storage.value() * 2, layout="coo"),
                  norm * torch.ones(1, 256), norm.detach()):
        assert other.storage.kernel_csr() is norm.storage.kernel_csr()
        assert other.storage.spmm_structure() is norm.storage.spmm_structure()
    assert SparseStorage.csc_builds == 1
    assert norm.t().storage._kernel == {}
    norm.clear_cache_()
    assert norm.storage._kernel == {} and norm.storage.num_cached_keys() == 0
    i32 = tsp.SparseTensor(row=torch.tensor([0, 1], dtype=torch.int32),
                           col=torch.tensor([1, 0], dtype=torch.int32))
    assert i32.storage.kernel_csr()[1] is i32.storage.col()


def test_kernel_csr_refuses_int32_overflow():
    T = tsp.SparseTensor(row=torch.tensor([0]), col=torch.tensor([1]),
                         sparse_sizes=(1, 2 ** 31))
    with pytest.raises(ValueError, match="int32"):
        T.storage.kernel_csr()


def test_matmul_under_inference_mode_then_train():
    """Kernel caches built under ``torch.inference_mode()`` still serve a
    later forward+backward."""
    T, _, _ = _case("dups")
    x = torch.from_numpy(_x(9, (3,), np.float32))
    with torch.inference_mode():
        T @ x
        T.storage.spmm_structure()
    v = T.storage.value().clone().requires_grad_()
    xx = x.clone().requires_grad_()
    (T.set_value(v, layout="coo") @ xx).sum().backward()
    assert v.grad is not None and xx.grad is not None


# ---------------------------------------------------------------------------
# the slice end to end: PyG's gcn_norm and two propagations
# ---------------------------------------------------------------------------
def _jax_gcn_norm(adj_t):
    adj_t = jsp.fill_diag(adj_t, 1.0)
    deg = jsp.sum(adj_t, dim=1)
    dis = deg ** -0.5
    dis = jnp.where(jnp.isinf(dis), 0.0, dis)
    adj_t = jsp.mul(adj_t, dis.reshape(-1, 1))
    return jsp.mul(adj_t, dis.reshape(1, -1))


def test_gcn_norm_two_propagations_vs_jax():
    adj, x = tsp.facade_entry("cpu")
    row, col, _ = adj.coo()
    jadj = jsp.SparseTensor(row=jnp.asarray(_np(row)),
                            col=jnp.asarray(_np(col)), sparse_sizes=(256, 256))
    norm, jnorm = tsp.gcn_norm(adj), _jax_gcn_norm(jadj)
    for a, b in zip(norm.coo(), jnorm.coo()):
        _same(a, b, dict(rtol=1e-6, atol=1e-7))
    norm.requires_grad_()
    xx = x.clone().requires_grad_()
    out = norm @ (norm @ xx)
    w = torch.from_numpy(_x(256, (32,), np.float32, seed=23))
    (out * w).sum().backward()

    jrow, jcol, jval = jnorm.coo()

    def loss(value, h):
        A = jsp.SparseTensor(row=jrow, col=jcol, value=value,
                             sparse_sizes=(256, 256), is_sorted=True,
                             trust_data=True)
        return (A @ (A @ h) * jnp.asarray(w.numpy())).sum()
    jx = jnp.asarray(x.numpy())
    jout = jnorm @ (jnorm @ jx)
    _same(out, jout, TOL)
    gv, gx = jax.grad(loss, argnums=(0, 1))(jval, jx)
    _same(norm.storage.value().grad, gv, TOL)
    _same(xx.grad, gx, TOL)
    # the row sums of D^-1/2 (A + I) D^-1/2 against a dense f64 build
    dense = np.zeros((256, 256))
    r, c = _np(row), _np(col)
    off = r != c
    np.add.at(dense, (r[off], c[off]), 1.0)
    dense[np.arange(256), np.arange(256)] = 1.0
    d = dense.sum(1) ** -0.5
    _same(norm.to_dense(), d[:, None] * dense * d[None, :],
          dict(rtol=1e-6, atol=1e-7))


def test_facade_entry_needs_the_card_by_default(monkeypatch):
    import inspect
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert inspect.signature(tsp.facade_entry).parameters[
        "device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.facade_entry()
