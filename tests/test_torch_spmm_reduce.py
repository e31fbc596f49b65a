"""Port parity: SpMM with ``reduce`` in sum, mean, min and max against the
JAX package, forward and both grads (``d value``, ``d x``) against
``jax.grad`` of ``backend="xla"``, on the same numpy inputs: a padded
``PaddedCOO`` with empty rows (the first and the last too), a row whose
products are all negative (a padding product of 0 leaking into the max would
win) and one whose products are all positive (for the min), duplicate
entries and small-integer inputs (tied products, whose gradient both
packages split evenly), trailing dims, and a row of more than ``CAP`` edges
run through the plain versions that follow the piece table (pieces, then
the fold), as the kernels do on the card.

Tolerance: f32 ``rtol=atol=1e-5`` (sums in another order); small-integer
inputs are exact in f32, so the ties are compared with ``1e-6``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.ops.spmm import spmm_csr as jspmm_csr
from paddle_sparse_tpu_torch import CAP, PaddedCOO, spmm_coo, spmm_csr
from paddle_sparse_tpu_torch.ops import spmm as tspmm
from paddle_sparse_tpu_torch.ops.kernels.row_split import (
    AUTO, resolve_split, sddmm_spans_piecewise, spmm_spans_piecewise)

TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=1e-6, atol=1e-6)
REDUCES = ["sum", "mean", "min", "max"]
M, N = 60, 50
EMPTY = (0, 7, M - 1)
NEG_ROW, POS_ROW = 3, 5


def _graph(seed, nnz=500, long_row=None, ints=False, pad=40):
    """Row-sorted COO with the ``EMPTY`` rows empty, duplicate entries, row
    ``NEG_ROW``'s values negative and ``POS_ROW``'s positive over an x
    that is positive everywhere; with ``long_row`` one row of that many
    edges; with ``ints`` small-integer values and x (many tied products).
    Returns numpy ``row, col, val, x`` and the capacity."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(M), EMPTY)
    row = rng.choice(keep, nnz)
    if long_row is not None:
        row = np.concatenate([row, np.full(long_row, 11)])
    col = rng.integers(0, N, row.size)
    dup = rng.choice(row.size, 40, replace=False)            # duplicates
    row, col = np.concatenate([row, row[dup]]), np.concatenate([col, col[dup]])
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    if ints:
        val = rng.integers(1, 3, row.size).astype(np.float32)
        x = rng.integers(0, 3, (N, 6)).astype(np.float32)
    else:
        val = rng.standard_normal(row.size).astype(np.float32)
        x = (np.abs(rng.standard_normal((N, 6))) + 0.1).astype(np.float32)
    val[row == NEG_ROW] = -np.abs(val[row == NEG_ROW]) - 0.1
    val[row == POS_ROW] = np.abs(val[row == POS_ROW]) + 0.1
    return row, col, val, x, row.size + pad


def _pair(row, col, val, capacity):
    t = PaddedCOO.from_arrays(row, col, val, (M, N), capacity=capacity)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               None if val is None else jnp.asarray(val),
                               (M, N), capacity=capacity)
    return t, j


def _jax_value_and_grads(j, x, w, reduce):
    """JAX's output and, for ``sum(out * w)``, its grads w.r.t. the values
    (None without values) and x."""
    def loss(v, xx):
        adj = dataclasses.replace(j, value=v)
        return (adj.spmm(xx, reduce, backend="xla") * w).sum()
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    out = j.spmm(xj, reduce, backend="xla")
    if j.value is None:
        return out, None, jax.grad(lambda xx: loss(None, xx))(xj)
    dv, dx = jax.grad(loss, argnums=(0, 1))(j.value, xj)
    return out, dv, dx


def _torch_value_and_grads(t, x, w, reduce):
    v = None if t.value is None else t.value.clone().requires_grad_()
    adj = t.with_value(v)
    xt = torch.from_numpy(x).requires_grad_()
    out = adj.spmm(xt, reduce)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), None if v is None else v.grad, xt.grad


def _check(t, j, x, reduce, tol, seed=0):
    w = np.random.default_rng(seed).standard_normal(
        (M,) + x.shape[1:]).astype(np.float32)
    got = _torch_value_and_grads(t, x, w, reduce)
    ref = _jax_value_and_grads(j, x, w, reduce)
    for name, g, r in zip(("out", "d value", "d x"), got, ref):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **tol)
    if got[1] is not None:
        assert not got[1][t.nnz:].any()       # padding gets no grad
    return got


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("with_value", [True, False])
def test_reduce_matches_jax(reduce, with_value):
    row, col, val, x, cap = _graph(len(reduce))
    t, j = _pair(row, col, val if with_value else None, cap)
    out, _, _ = _check(t, j, x, reduce, TOL)
    assert not out[list(EMPTY)].any()
    if with_value and reduce == "max":
        assert (out[NEG_ROW] < 0).all()
    if with_value and reduce == "min":
        assert (out[POS_ROW] > 0).all()


@pytest.mark.parametrize("reduce", REDUCES)
def test_entry_points_agree(reduce):
    """``spmm_csr``, ``spmm_coo`` (padding rows dropped) and
    ``PaddedCOO.spmm`` give JAX's ``spmm_csr``."""
    row, col, val, x, cap = _graph(9)
    t, _ = _pair(row, col, val, cap)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    ref = jspmm_csr(jnp.asarray(rowptr), jnp.asarray(col), jnp.asarray(val),
                    jnp.asarray(x), reduce, backend="xla")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        outs = (spmm_csr(torch.from_numpy(rowptr), torch.from_numpy(col),
                         torch.from_numpy(val), xt, reduce),
                spmm_coo(t.row, t.col, t.value, xt, M, reduce),
                t.spmm(xt, reduce))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("reduce", ["mean", "min", "max"])
def test_ties(reduce):
    """Small-integer values and x, and duplicate entries: most rows tie
    their extreme products, and both packages split the gradient evenly
    among the tied entries."""
    row, col, val, x, cap = _graph(21, ints=True)
    t, j = _pair(row, col, val, cap)
    _check(t, j, x, reduce, EXACT)


@pytest.mark.parametrize("reduce", REDUCES)
def test_trailing_dims(reduce):
    row, col, val, x, cap = _graph(4)
    x = np.repeat(x[:, :, None], 2, axis=2) * np.array([1, -1], np.float32)
    t, j = _pair(row, col, val, cap)
    out, _, dx = _check(t, j, x, reduce, TOL)
    assert out.shape == (M, 6, 2) and dx.shape == (N, 6, 2)


def _piecewise_kernels(monkeypatch, seen):
    """Replace the kernel wrappers that ``ops/spmm.py`` calls by the plain
    versions that follow the piece table, as the kernels do (the fused
    backward: its d x as K1's pieces over the CSC view, its d value as the
    SDDMM's over the same pieces, read back through ``inv_perm``, as the
    wrapper relays it)."""
    def spmm(rowptr, col, value, x, split=AUTO):
        start, end = rowptr[None, :-1], rowptr[None, 1:]
        split = resolve_split(split, start, end)
        seen.append(split)
        return spmm_spans_piecewise(start, end, col, value, None, x, split)

    def sddmm(rowptr, col, g, x, out_dtype=torch.float32, split=AUTO):
        start, end = rowptr[None, :-1], rowptr[None, 1:]
        split = resolve_split(split, start, end)
        seen.append(split)
        return sddmm_spans_piecewise(start, end, col, None, g, x, split,
                                     out_dtype)
    def fused(colptr, col_t, perm, value, g, x, out_dtype=torch.float32,
              split=AUTO, inv_perm=None, value_t=None):
        start, end = colptr[None, :-1], colptr[None, 1:]
        split = resolve_split(split, start, end)
        seen.append(split)
        if value_t is None and value is not None:
            value_t = value.index_select(0, perm)
        d_x = spmm_spans_piecewise(start, end, col_t, value_t, None, g,
                                   split)
        dv_t = sddmm_spans_piecewise(start, end, col_t, None, x, g, split,
                                     out_dtype)
        return d_x, dv_t.index_select(0, inv_perm)
    monkeypatch.setattr(tspmm, "spmm_csr_cuda", spmm)
    monkeypatch.setattr(tspmm, "sddmm_csr_cuda", sddmm)
    monkeypatch.setattr(tspmm, "spmm_sddmm_csc_cuda", fused)


@pytest.mark.parametrize("reduce", REDUCES)
def test_long_row_through_the_pieces(monkeypatch, reduce):
    """A row of ``2 * CAP + 300`` edges: sum and mean run the forward over
    its pieces and the fold, and the fused backward over the CSC view
    (whose columns stay short); every reduction gives JAX's output and
    grads."""
    seen = []
    _piecewise_kernels(monkeypatch, seen)
    row, col, val, x, cap = _graph(5, long_row=2 * CAP + 300)
    t, j = _pair(row, col, val, cap)
    assert t.row_split() is not None
    assert t.row_split().fold_row.tolist() == [11]
    _check(t, j, x, reduce, TOL)
    if reduce in ("sum", "mean"):
        assert len(seen) == 2 and seen[0] is t.row_split()
        assert seen[1] is None


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_extremes_read_only_the_real_entries(reduce):
    """Padding cols poisoned with an index far outside x: min and max never
    gather them (they reduce the first ``rowptr[M]`` entries)."""
    row, col, val, x, cap = _graph(6)
    t, _ = _pair(row, col, val, cap)
    poisoned = dataclasses.replace(t, col=torch.where(
        t.valid_mask(), t.col, torch.full_like(t.col, 1 << 30)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        torch.testing.assert_close(poisoned.spmm(xt, reduce),
                                   t.spmm(xt, reduce), rtol=0, atol=0)


@pytest.mark.parametrize("reduce", ["mean", "min", "max"])
def test_dtype_promotion(reduce):
    """The output has the promoted dtype of value and x, as in JAX."""
    row, col, val, x, cap = _graph(8)
    t, _ = _pair(row, col, val, cap)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        assert t.spmm(xb, reduce).dtype == torch.float32
        assert t.with_value(None).spmm(xb, reduce).dtype == torch.bfloat16
        out = t.spmm(xb, reduce)
    ref = t.spmm(xb.float(), reduce)
    torch.testing.assert_close(out, ref, **TOL)


def test_unknown_reduction():
    row, col, val, x, cap = _graph(1)
    t, _ = _pair(row, col, val, cap)
    with pytest.raises(ValueError, match="unknown reduction"):
        t.spmm(torch.from_numpy(x), "prod")
