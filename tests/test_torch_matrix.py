"""Port parity: paddle_sparse_tpu_torch.PaddedCOO against the JAX
paddle_sparse_tpu.core.PaddedCOO, with padding, on the same numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.ops.spmm import _spmm_structure
from paddle_sparse_tpu_torch import PaddedCOO, padded_coo_from_jax
from paddle_sparse_tpu_torch.ops.convert import ptr2ind_capped

M, N = 120, 90


def _coo(nnz=700, seed=11):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, M - 1, nnz))    # the last row stays empty
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    return (row[order].astype(np.int32), col[order].astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32), rng)


def _pair(capacity, with_value=True):
    row, col, val, rng = _coo()
    v = val if with_value else None
    t = PaddedCOO.from_arrays(row, col, v, (M, N), capacity=capacity)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               None if v is None else jnp.asarray(v),
                               (M, N), capacity=capacity)
    return t, j, rng


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("capacity", [None, 700, 1000])
@pytest.mark.parametrize("with_value", [True, False])
def test_from_arrays_layout(capacity, with_value):
    t, j, _ = _pair(capacity, with_value)
    assert t.shape == j.shape and t.capacity == j.capacity
    assert t.nnz == int(j.nnz)
    _eq(t.row, j.row)
    _eq(t.col, j.col)
    assert (t.value is None) == (j.value is None)
    if with_value:
        _eq(t.value, j.value)
    _eq(t.valid_mask(), j.valid_mask())
    _eq(t.rowptr(), j.rowptr())
    _eq(t.degree(), j.degree())
    assert int(t.rowptr()[-1]) == t.nnz    # padding lies past rowptr[M]


@pytest.mark.parametrize("capacity", [None, 1000])
def test_with_value_zeroes_padding(capacity):
    t, j, rng = _pair(capacity)
    new = rng.standard_normal(t.capacity).astype(np.float32)
    tv = t.with_value(torch.from_numpy(new))
    jv = j.with_value(jnp.asarray(new))
    _eq(tv.value, jv.value)
    assert not tv.value[t.nnz:].any()
    assert t.with_value(None).value is None


@pytest.mark.parametrize("capacity", [None, 1000])
@pytest.mark.parametrize("with_value", [True, False])
@pytest.mark.parametrize("K", [1, 33])
def test_spmm(capacity, with_value, K):
    t, j, rng = _pair(capacity, with_value)
    x = rng.standard_normal((N, K)).astype(np.float32)
    with torch.no_grad():
        out = t.spmm(torch.from_numpy(x))
    ref = j.spmm(jnp.asarray(x))
    assert out.shape == (M, K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_spmm_never_reads_padding():
    """Padding col set far outside x: the result is unchanged, because the
    row pointer ends before the padding."""
    t, j, rng = _pair(1000)
    x = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32))
    poisoned = dataclasses.replace(t, col=torch.where(
        t.valid_mask(), t.col, torch.full_like(t.col, 1 << 30)))
    with torch.no_grad():
        np.testing.assert_array_equal(poisoned.spmm(x).numpy(),
                                      t.spmm(x).numpy())


def test_to_device_roundtrip():
    t, _, _ = _pair(1000)
    u = t.to("cpu")
    assert u.row.device == u.col.device == torch.device("cpu")
    assert u.shape == t.shape
    assert torch.equal(u.row, t.row) and torch.equal(u.value, t.value)


@pytest.mark.parametrize("bad", ["unsorted", "row_range", "col_range",
                                 "capacity"])
def test_from_arrays_rejects_bad_input(bad):
    row, col, val, _ = _coo(nnz=50)
    shape, cap = (M, N), None
    if bad == "unsorted":
        row = row[::-1].copy()
    elif bad == "row_range":
        row[-1] = M
    elif bad == "col_range":
        col[0] = N
    else:
        cap = 10
    with pytest.raises(ValueError):
        PaddedCOO.from_arrays(row, col, val, shape, capacity=cap)


@pytest.mark.parametrize("capacity", [None, 1000])
@pytest.mark.parametrize("with_value", [True, False])
def test_transpose(capacity, with_value):
    """Array for array the JAX transpose: stable (col, row) order, padding
    (M, N) -> (N, M) last; its spmm agrees too."""
    t, j, rng = _pair(capacity, with_value)
    tt, jt = t.transpose(), j.transpose()
    assert tt.shape == jt.shape == (N, M) and tt.nnz == int(jt.nnz)
    _eq(tt.row, jt.row)
    _eq(tt.col, jt.col)
    if with_value:
        _eq(tt.value, jt.value)
    _eq(tt.rowptr(), jt.rowptr())
    x = rng.standard_normal((M, 5)).astype(np.float32)
    with torch.no_grad():
        out = tt.spmm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jt.spmm(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    back = tt.transpose()
    _eq(back.row, j.row)
    _eq(back.col, j.col)


@pytest.mark.parametrize("capacity", [None, 1000])
def test_structure_matches_jax(capacity):
    """The cached CSR + CSC view equals the reference's ``_spmm_structure``
    array for array (``row_t``, not cached, is expanded from ``colptr``);
    padding lies past ``colptr[N]``."""
    t, j, _ = _pair(capacity)
    s = t.structure()
    rowptr, perm, row_t, col_t, colptr = _spmm_structure(
        j.row, j.col, num_rows=M, num_cols=N)
    for a, b in ((s.rowptr, rowptr), (s.perm, perm),
                 (ptr2ind_capped(s.colptr, t.capacity), row_t),
                 (s.col_t, col_t), (s.colptr, colptr)):
        _eq(a, b)
    assert s.perm.dtype == torch.int32
    assert int(s.colptr[-1]) == t.nnz


def test_structure_cache():
    """Built once; ``with_value`` keeps it (same structure); ``to`` and
    ``dataclasses.replace`` start a copy with none, built on the copy's own
    device."""
    t, _, rng = _pair(1000)
    s = t.structure()
    assert t.structure() is s and t.rowptr() is s.rowptr
    v = t.with_value(torch.from_numpy(
        rng.standard_normal(t.capacity).astype(np.float32)))
    assert v.structure() is s
    for copy in (t.to("cpu"), dataclasses.replace(t)):
        assert not copy._cache
        s2 = copy.structure()
        assert s2 is not s and s2.perm.device == copy.row.device
        _eq(s2.perm, s.perm.numpy())


def test_structure_ignores_padding_cols():
    """Poisoned padding cols still sort last: the CSC view is built from
    the real entries."""
    t, _, _ = _pair(1000)
    poisoned = dataclasses.replace(t, col=torch.where(
        t.valid_mask(), t.col, torch.full_like(t.col, 1 << 30)))
    a, b = t.structure(), poisoned.structure()
    for f in ("rowptr", "perm", "col_t", "colptr"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("row_split", "col_split"):     # no row or column is long
        assert getattr(a, f) is None and getattr(b, f) is None, f


def _unsorted(seed, nnz=300, capacity=400, dups=60, with_value=True):
    """A JAX PaddedCOO with entries in random order, duplicate coordinates
    and interleaved pads (rows M, cols N), and its port copy."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, M, nnz)
    col = rng.integers(0, N, nnz)
    pick = rng.integers(0, nnz, dups)              # repeated coordinates
    row, col = np.concatenate([row, row[pick]]), np.concatenate([col,
                                                                 col[pick]])
    pad = capacity - row.size
    row = np.concatenate([row, np.full(pad, M)])
    col = np.concatenate([col, np.full(pad, N)])
    order = rng.permutation(capacity)
    val = rng.standard_normal(capacity).astype(np.float32)
    val[row[order] == M] = 0
    j = JPaddedCOO(row=jnp.asarray(row[order].astype(np.int32)),
                   col=jnp.asarray(col[order].astype(np.int32)),
                   value=jnp.asarray(val) if with_value else None,
                   nnz=jnp.asarray(nnz + dups, jnp.int32), shape=(M, N))
    return padded_coo_from_jax(j), j


def _same_coo(t, j, **tol):
    assert t.shape == j.shape and t.capacity == j.capacity
    assert t.nnz == int(j.nnz)
    _eq(t.row, j.row)
    _eq(t.col, j.col)
    assert (t.value is None) == (j.value is None)
    if t.value is not None:
        if tol:
            np.testing.assert_allclose(t.value.detach().numpy(),
                                       np.asarray(j.value), **tol)
        else:
            _eq(t.value, j.value)


def test_padded_coo_from_jax_round_trips():
    """JAX -> port -> JAX gives the arrays back, padding and nnz kept."""
    for with_value in (True, False):
        t, j = _unsorted(1, with_value=with_value)
        _same_coo(t, j)
        back = JPaddedCOO(row=jnp.asarray(t.row.numpy()),
                          col=jnp.asarray(t.col.numpy()),
                          value=None if t.value is None
                          else jnp.asarray(t.value.numpy()),
                          nnz=jnp.asarray(t.nnz, jnp.int32), shape=t.shape)
        _same_coo(padded_coo_from_jax(back), j)
    assert t.row.dtype == torch.int32


@pytest.mark.parametrize("with_value", [True, False])
def test_sort_matches_jax(with_value):
    t, j = _unsorted(2, with_value=with_value)
    _same_coo(t.sort(), j.sort())


@pytest.mark.parametrize("with_value", [True, False])
@pytest.mark.parametrize("assume_sorted", [True, False])
def test_coalesce_matches_jax(with_value, assume_sorted):
    """Duplicates summed, capacity kept, pads (M, N, 0), nnz the unique
    count; sorting first or not (then only adjacent duplicates merge).
    Values ``rtol=1e-6``: f32 sums of at most a few terms."""
    t, j = _unsorted(3, with_value=with_value)
    if assume_sorted:
        t, j = t.sort(), j.sort()
    tc, jc = t.coalesce(assume_sorted), j.coalesce(assume_sorted)
    _same_coo(tc, jc, rtol=1e-6, atol=1e-6)
    if with_value:
        assert not tc.value[tc.nnz:].any()
    assert tc.nnz < t.nnz


def test_coalesce_of_from_arrays():
    """A row-sorted ``from_arrays`` matrix: JAX's coalesce array for array,
    and coalescing again changes nothing."""
    t, j, _ = _pair(900)
    c = t.coalesce()
    _same_coo(c, j.coalesce(), rtol=1e-6, atol=1e-6)
    again = c.coalesce()
    assert again.nnz == c.nnz and torch.equal(again.row, c.row)
    assert torch.equal(again.col, c.col) and torch.equal(again.value,
                                                         c.value)


def test_coalesce_trailing_dims_and_grad():
    """A (capacity, 3) value coalesces row by row (plain version); d value
    of a 1-D coalesce equals ``jax.grad`` of the JAX coalesce."""
    t, j = _unsorted(4)
    t, j = t.sort(), j.sort()
    rng = np.random.default_rng(5)
    wide = rng.standard_normal((t.capacity, 3)).astype(np.float32)
    wide[t.row.numpy() == M] = 0
    tw = dataclasses.replace(t, value=torch.from_numpy(wide)).coalesce()
    jw = dataclasses.replace(j, value=jnp.asarray(wide)).coalesce()
    np.testing.assert_allclose(tw.value.numpy(), np.asarray(jw.value),
                               rtol=1e-6, atol=1e-6)
    weight = rng.standard_normal(t.capacity).astype(np.float32)

    def j_loss(v):
        return (dataclasses.replace(j, value=v).coalesce().value
                * jnp.asarray(weight)).sum()

    g_ref = jax.grad(j_loss)(j.value)
    v = t.value.clone().requires_grad_()
    (dataclasses.replace(t, value=v).coalesce().value
     * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)
