"""The long-row split table of paddle_sparse_tpu_torch
(``ops/kernels/row_split.py``) on the CPU: at one span per row against the
JAX package's ``ops/spmm.py::_split_long_rows``; at many spans, the pieces
cover each row's flat edges once and in order; and the plain piecewise
SpMM and SDDMM, which follow the table as the kernels do, against the plain
versions and the JAX functions (``spmm_csr``, and ``spmm_seg2`` with its
Pallas kernels in interpret mode, as ``test_torch_seg2.py`` runs it).

Tolerances: against the plain versions and JAX's ``spmm_csr`` (XLA, f32)
``rtol=atol=1e-5``: the same f32 products summed in another order (per
piece, then the pieces). Against JAX's ``spmm_seg2`` ``rtol=atol=1e-4``,
because its f32 path sums bf16 hi/lo halves (about 2**-16 relative per
term), as in ``test_torch_seg2.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu.ops import spmm_seg2 as J
from paddle_sparse_tpu_torch import (PaddedCOO, make_seg2_plan, pack_values,
                                     sddmm_csr_reference,
                                     sddmm_spans_reference,
                                     spmm_csr_reference,
                                     spmm_spans_reference)
from paddle_sparse_tpu_torch.ops.kernels import row_split as R
from paddle_sparse_tpu_torch.ops.kernels.row_split import (
    AUTO, RowSplit, resolve_split, sddmm_spans_piecewise, split_long_rows,
    split_rows, spmm_spans_piecewise)

F32 = dict(rtol=1e-5, atol=1e-5)
JAX_SEG2 = dict(rtol=1e-4, atol=1e-4)
DEGREES = (0, 7, 8, 9, 200, 3, 0, 17, 1, 8)   # cap = 8 sits among them
N = 60


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ptr(deg):
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)


def _pointers():
    rng = np.random.default_rng(0)
    w = rng.zipf(1.5, 400).astype(np.float64)
    power_law = np.maximum(1, np.floor(w * (4000 / w.sum()))).astype(np.int64)
    empty = rng.integers(0, 30, 300)
    empty[rng.integers(0, 300, 80)] = 0
    return {"random": rng.integers(0, 50, 300), "empty_rows": empty,
            "power_law": power_law, "all_empty": np.zeros(5, np.int64),
            "degrees": np.asarray(DEGREES)}


@pytest.mark.parametrize("cap", [1, 3, 8, 64, 4096])
@pytest.mark.parametrize("kind", ["random", "empty_rows", "power_law",
                                  "all_empty", "degrees"])
def test_split_long_rows_matches_jax(kind, cap):
    """``split_long_rows`` equals ``_split_long_rows`` array for array,
    ``None`` fold (nothing splits) included; the table's rows are the
    fold and its pieces the pseudo-row offsets."""
    rowptr = _ptr(_pointers()[kind])
    want_ptr, want_fold = jspmm._split_long_rows(rowptr, cap)
    ptr, fold = split_long_rows(_t(rowptr), cap)
    np.testing.assert_array_equal(ptr.numpy(), want_ptr)
    t = split_rows(_t(rowptr)[None, :-1], _t(rowptr)[None, 1:], cap)
    if want_fold is None:
        assert fold is None and t is None
        return
    assert fold.dtype == torch.int32
    np.testing.assert_array_equal(fold.numpy(), want_fold)
    np.testing.assert_array_equal(t.row.numpy(), want_fold)
    first = rowptr[want_fold] + t.piece.numpy().astype(np.int64) * cap
    np.testing.assert_array_equal(first, want_ptr[:-1])


def _span_bounds(rng, S, M, max_len, long_rows=()):
    """(S, M+1) span-major pointers with empty spans and rows, and rows
    ``long_rows`` given many edges in every span."""
    lens = rng.integers(0, max_len + 1, (S, M))
    lens[:, 0] = 0
    lens[rng.random((S, M)) < 0.3] = 0
    for r in long_rows:
        lens[:, r] = rng.integers(20, 60, S)
    ptr = np.concatenate([[0], np.cumsum(lens.reshape(-1))])
    rp = ptr[(np.arange(S) * M)[:, None] + np.arange(M + 1)[None, :]]
    return _t(rp[:, :-1].astype(np.int32)), _t(rp[:, 1:].astype(np.int32))


@pytest.mark.parametrize("S,cap", [(1, 5), (3, 7), (38, 16), (40, 33),
                                   (38, 4096)])
def test_pieces_cover_rows_once_in_order(S, cap):
    """At many spans each row's pieces, walked as the kernels walk them
    (``_piece_edges``), give the row's edges in (span, position) order,
    each edge once; every piece holds at most ``cap`` edges; slots number
    the split rows' pieces consecutively, as ``fold_ptr`` says."""
    rng = np.random.default_rng(S)
    M = 50
    start, end = _span_bounds(rng, S, M, 4, long_rows=(5, 6, M - 1))
    t = split_rows(start, end, cap)
    lens = (end.long() - start.long()).clamp_min(0)
    if int(lens.sum(0).max()) <= cap:
        assert t is None
        return
    assert isinstance(t, RowSplit) and t.num_rows == M and t.cap == cap
    piece, s, e = R._piece_edges(start, end, t)
    for m in range(M):
        want = [(si, p) for si in range(S)
                for p in range(int(start[si, m]), int(end[si, m]))]
        mine = (t.row[piece] == m).nonzero().squeeze(1)
        assert list(zip(s[mine].tolist(), e[mine].tolist())) == want, m
    counts = torch.bincount(piece, minlength=t.row.numel())
    assert int(counts.max()) <= cap
    n_pieces = torch.bincount(t.row.long(), minlength=M)
    assert torch.equal(n_pieces, torch.div(lens.sum(0) + cap - 1, cap,
                                           rounding_mode="floor")
                       .clamp_min(1))
    assert torch.equal(t.row.long(), torch.sort(t.row.long()).values)
    split = t.slot >= 0
    assert torch.equal(t.slot[split], torch.arange(t.num_slots,
                                                   dtype=torch.int32))
    assert torch.equal(t.fold_row, torch.nonzero(n_pieces > 1).squeeze(1)
                       .int())
    assert torch.equal(torch.diff(t.fold_ptr).long(), n_pieces[n_pieces > 1])


def _degree_graph(rng):
    deg = np.asarray(DEGREES)
    row = np.repeat(np.arange(deg.size), deg).astype(np.int32)
    col = rng.integers(0, N, row.size).astype(np.int32)
    return row, col, _ptr(deg)


@pytest.mark.parametrize("K", [1, 5, 33])
def test_piecewise_csr_matches_plain_and_jax(K):
    """At one span per row and cap 8 (rows of 0, 7, 8, 9 and 200 edges),
    the piecewise SpMM and SDDMM equal the plain versions and JAX's
    ``spmm_csr`` forward and ``d value``."""
    rng = np.random.default_rng(K)
    row, col, rowptr = _degree_graph(rng)
    M = rowptr.size - 1
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    rp = _t(rowptr.astype(np.int32))
    start, end = rp[None, :-1], rp[None, 1:]
    t = split_rows(start, end, cap=8)
    assert t.fold_row.tolist() == [3, 4, 7]
    out = spmm_spans_piecewise(start, end, _t(col), _t(val), None, _t(x), t)
    torch.testing.assert_close(
        out, spmm_csr_reference(rp, _t(col), _t(val), _t(x)), **F32)
    dv = sddmm_spans_piecewise(start, end, _t(col), None, _t(g), _t(x), t)
    torch.testing.assert_close(
        dv, sddmm_csr_reference(rp, _t(col), _t(g), _t(x)), **F32)

    def f(v, xx):
        return (jspmm.spmm_csr(jnp.asarray(rowptr), jnp.asarray(col), v, xx,
                               backend="xla") * jnp.asarray(g)).sum()
    jout = jspmm.spmm_csr(jnp.asarray(rowptr), jnp.asarray(col),
                          jnp.asarray(val), jnp.asarray(x), backend="xla")
    jdv = jax.grad(f)(jnp.asarray(val), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **F32)


@pytest.mark.parametrize("sr", [16, 64])
def test_piecewise_seg2_matches_plain_and_jax(sr):
    """Over seg2's forward layout (rows spread over S segments) at cap 8,
    the piecewise SpMM and SDDMM equal the plain span versions and JAX's
    ``spmm_seg2`` forward and ``d packed`` (Pallas interpret mode)."""
    K = 16
    rng = np.random.default_rng(sr)
    row, col, _ = _degree_graph(rng)
    M = len(DEGREES)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=K, sr=sr)
    assert ts.split_f is None and ts.split_t is None    # CAP is far above
    start, end = ts.rp_f[:, :M], ts.rp_f[:, 1:M + 1]
    t = split_rows(start, end, cap=8)
    pv = pack_values(ts, _t(val))
    args = (start, end, ts.col_f)
    out = spmm_spans_piecewise(*args, pv, ts.sbase_f, _t(x), t)
    torch.testing.assert_close(out, spmm_spans_reference(
        *args, pv, ts.sbase_f, _t(x)), **F32)
    dv = sddmm_spans_piecewise(*args, ts.sbase_f, _t(g), _t(x), t)
    torch.testing.assert_close(dv, sddmm_spans_reference(
        *args, ts.sbase_f, _t(g), _t(x)), **F32)

    jp, js = J.make_seg2_plan(row, col, M, N, feat_dim=K, sr=sr,
                              chunk_edges=256)
    jpv = J.pack_values(js, jnp.asarray(val))
    jout = J.spmm_seg2(jp, js, jpv, jnp.asarray(x))
    jdv = jax.grad(lambda v: (J.spmm_seg2(jp, js, v, jnp.asarray(x))
                              * jnp.asarray(g)).sum())(jpv)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **JAX_SEG2)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **JAX_SEG2)


def _hub_graph(rng, hub_edges=R.CAP + 900):
    """A hub row and a hub column of more than ``CAP`` edges each among
    short rows: both layouts split."""
    M = 40
    row = np.concatenate([np.full(hub_edges, 3), rng.integers(0, M, 300),
                          np.arange(hub_edges) % M])
    col = np.concatenate([rng.integers(0, N, hub_edges),
                          rng.integers(0, N, 300), np.full(hub_edges, 11)])
    order = np.argsort(row, kind="stable")
    return row[order].astype(np.int32), col[order].astype(np.int32), M


def test_plan_tables_are_tables_of_the_bounds():
    """A seg2 plan's tables (from the degrees) equal the tables of its own
    span bounds, for the forward rows and the transpose's ``x`` rows."""
    row, col, M = _hub_graph(np.random.default_rng(1))
    tp, ts = make_seg2_plan(_t(row), _t(col), M, N, feat_dim=8, sr=16)
    for table, rp, rows in ((ts.split_f, ts.rp_f, M), (ts.split_t, ts.rp_t,
                                                       N)):
        want = split_rows(rp[:, :rows], rp[:, 1:rows + 1])
        assert table is not None and table.num_slots == want.num_slots
        for f in ("row", "piece", "slot", "fold_row", "fold_ptr"):
            assert torch.equal(getattr(table, f), getattr(want, f)), f


def test_padded_coo_caches_tables():
    """``PaddedCOO`` builds the row table once, the structure carries both
    pointers' tables, and the transpose starts with the column table."""
    row, col, M = _hub_graph(np.random.default_rng(2))
    adj = PaddedCOO.from_arrays(row, col, None, (M, N), capacity=row.size + 9)
    t = adj.row_split()
    assert t is not None and adj.row_split() is t
    assert t.fold_row.tolist() == [3]
    s = adj.structure()
    assert s.row_split is t and s.col_split.fold_row.tolist() == [11]
    assert adj.transpose().row_split() is s.col_split
    x = torch.randn(N, 6, dtype=torch.float64)
    torch.testing.assert_close(adj.spmm(x), spmm_csr_reference(
        adj.rowptr(), adj.col, None, x))


def test_resolve_split_checks():
    rp = torch.tensor([0, 3, 3, 20], dtype=torch.int32)
    start, end = rp[None, :-1], rp[None, 1:]
    assert resolve_split(None, start, end) is None
    assert resolve_split(AUTO, start, end) is None        # 17 <= CAP
    t = split_rows(start, end, cap=4)
    assert resolve_split(t, start, end) is t
    with pytest.raises(ValueError):
        resolve_split("always", start, end)
    with pytest.raises(TypeError):
        resolve_split((t.row, t.piece), start, end)
    with pytest.raises(ValueError):
        resolve_split(t, start[:, :2], end[:, :2])
    with pytest.raises(ValueError):
        resolve_split(t._replace(row=t.row.long()), start, end)
    with pytest.raises(ValueError):
        split_rows(start, end, cap=0)
