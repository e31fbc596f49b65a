"""Port parity of the fused CSC backward of the SpMM on the CPU:
``spmm_sddmm_csc_reference`` (the plain version of
``ops/kernels/spmm_sddmm_cuda.py::spmm_sddmm_csc_cuda``, which a CPU tensor
runs) against the JAX package's ``spmm_sddmm_chunked`` in Pallas interpret
mode and against the grads of its ``spmm_chunked``, at the sizes of
``tests/test_pallas_kernel.py::test_fused_backward_multiblock`` (a plan
forced to several blocks both ways); with padding entries, empty columns,
long columns split into pieces (the piecewise plain SpMM following the
table, as the kernel's pieces and fold do), other K and ``value`` None. And
the dispatch of ``_SpmmSum.backward``: the fused pass exactly when both
grads are needed, K2 or K1 over the CSC view alone otherwise.

Tolerances, compared in f64: f32 inputs ``rtol=atol=1e-5`` against JAX's
XLA path, and against the exact sums ``atol=1e-5`` plus ``1e-5`` of each
entry's sum of |terms| (f32 sums in another order: a hub column sums 2,500
terms, whose rounding grows with their count); against JAX's
Pallas functions within ``2**-15`` of each entry's sum of |terms|, because
their f32 path sums each product as bf16 hi/lo halves, which keep about 16
bits of it (up to 4.6e-5 apart on entries near 3.8 here: beyond
``rtol=atol=1e-5``); f64 inputs ``rtol=atol=1e-10`` against JAX's XLA path
in f64 (the Pallas path computes in f32 whatever its inputs), as tier-1
runs JAX with x64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu.ops.kernels.spmm_pallas import spmm_sddmm_chunked
from paddle_sparse_tpu_torch import (PaddedCOO, sddmm_csr_cuda, spmm_coo,
                                     spmm_csr_cuda, spmm_sddmm_csc_cuda,
                                     spmm_sddmm_csc_reference)
from paddle_sparse_tpu_torch.ops import spmm as tspmm
from paddle_sparse_tpu_torch.ops.kernels.row_split import (
    split_rows, spmm_spans_piecewise)

F32 = dict(rtol=1e-5, atol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-10)
HI_LO = 2.0 ** -15       # JAX's Pallas f32 path, of the sum of |terms|
M, N, K, NNZ = 520, 410, 64, 4200       # test_fused_backward_multiblock
TARGET_BYTES = 48 * 1024                 # several blocks both ways
EMPTY_COLS = (0, 17, 409)                # the last column too


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _graph(seed=0, nnz=NNZ, hub=0, dtype=np.float32, k=K):
    """Row-sorted COO indices over (M, N) with ``EMPTY_COLS`` empty (and,
    with ``hub``, column 5 holding ``hub`` more edges), values, ``x`` and
    ``g`` from ``seed``."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(N), EMPTY_COLS)
    row = rng.integers(0, M, nnz + hub)
    col = np.concatenate([rng.choice(keep, nnz), np.full(hub, 5)])
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.standard_normal(row.size).astype(dtype)
    x = rng.standard_normal((N, k)).astype(dtype)
    g = rng.standard_normal((M, k)).astype(dtype)
    return row, col, val, x, g


def _port(row, col, val, x, g, pad=0, with_value=True):
    """The port's ``(d x, d value)`` through the fused plain version on a
    ``PaddedCOO`` with ``pad`` padding entries; ``d value`` over the real
    entries, and the padding's."""
    A = PaddedCOO.from_arrays(row, col, _t(val), (M, N),
                              capacity=row.size + pad)
    s = A.structure()
    dx, dv = spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm,
                                 A.value if with_value else None, _t(g),
                                 _t(x), out_dtype=A.value.dtype,
                                 split=s.col_split)
    return dx.numpy(), dv[:row.size].numpy(), dv[row.size:]


def _jax_fused(row, col, val, x, g):
    """JAX's ``spmm_sddmm_chunked`` (Pallas, interpret mode) over the CSC
    structure of its own plan: ``(d x, d value)``, ``d value`` back in COO
    order."""
    k = x.shape[1]        # the byte target scaled to K: blocks as at K=64
    plan, s = jspmm.make_spmm_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                                   k, target_bytes=TARGET_BYTES * k // K)
    assert plan.interpret and plan.nblocks_t > 1
    d_x, dv_t = spmm_sddmm_chunked(
        s.rowptr_t, s.row_t, s.col_t, jnp.take(jnp.asarray(val), s.perm),
        jnp.asarray(g), jnp.asarray(x),
        num_rows=jspmm._pseudo_rows(plan, True),
        rows_per_chunk=plan.rows_per_chunk_t,
        edge_capacity=plan.edge_capacity_t, interpret=True,
        block_starts=s.bs_t, out_scatter=s.pos_t, nblocks=plan.nblocks_t,
        stream=plan.stream)
    d_x = jspmm._fold_rows(d_x, s.fold_t, N)
    dv = np.zeros(row.size, np.float64)
    dv[np.asarray(s.perm)] = np.asarray(dv_t)
    return np.asarray(d_x, np.float64), dv


def _jax_grads(row, col, val, x, g, backend="chunked"):
    """``(d value, d x)`` of ``sum(spmm(value, x) * g)`` in JAX:
    ``spmm_chunked`` on a plan forced to several blocks, or the XLA
    ``spmm_coo``; ``d value`` None when ``val`` is None."""
    r, c = jnp.asarray(row), jnp.asarray(col)
    if backend == "chunked":
        plan, s = jspmm.make_spmm_plan(r, c, M, N, x.shape[1],
                                       target_bytes=TARGET_BYTES)

        def f(v, xx):
            return jspmm.spmm_chunked(plan, s, v, xx)
    else:
        def f(v, xx):
            return jspmm.spmm_coo(r, c, v, xx, M, backend="xla")
    if val is None:
        dx = jax.grad(lambda xx: (f(None, xx) * g).sum())(jnp.asarray(x))
        return None, np.asarray(dx, np.float64)
    dv, dx = jax.grad(lambda v, xx: (f(v, xx) * g).sum(), argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x))
    return np.asarray(dv, np.float64), np.asarray(dx, np.float64)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), want, **tol)


def _exact(row, col, val, x, g):
    """``(d x, d value)`` in f64 numpy, and each entry's sum of |terms|."""
    out = []
    for f in (lambda a: np.asarray(a, np.float64),
              lambda a: np.abs(np.asarray(a, np.float64))):
        v, xx, gg = f(val), f(x), f(g)
        dx = np.zeros_like(xx)
        np.add.at(dx, col, v[:, None] * gg[row])
        out.append((dx, (gg[row] * xx[col]).sum(1)))
    return out


def _close_to_pallas(got, want, scale):
    """``got`` within ``HI_LO`` of each entry's sum of |terms| of JAX's
    Pallas result ``want``."""
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= HI_LO * scale + 1e-30).all(), float(
        (err - HI_LO * scale).max())


def _close_to_exact(got, want, scale):
    """``got`` within ``1e-5 + 1e-5 * scale`` of the exact ``want``."""
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= 1e-5 + 1e-5 * scale).all(), float(
        (err - 1e-5 * scale).max())


def _check_vs_pallas(dx, dv, row, col, val, x, g, jdx, jdv):
    """The port's f32 outputs against the exact sums and against JAX's
    Pallas outputs (``HI_LO`` of the sum of |terms|)."""
    (ex, ev), (sx, sv) = _exact(row, col, val, x, g)
    _close_to_exact(dx, ex, sx)
    _close_to_exact(dv, ev, sv)
    _close_to_pallas(dx, jdx, sx)
    _close_to_pallas(dv, jdv, sv)


def test_reference_vs_jax_fused_kernel():
    """The plain version against JAX's ``spmm_sddmm_chunked``, Pallas in
    interpret mode, several blocks both ways."""
    row, col, val, x, g = _graph()
    dx, dv, _ = _port(row, col, val, x, g)
    jdx, jdv = _jax_fused(row, col, val, x, g)
    _check_vs_pallas(dx, dv, row, col, val, x, g, jdx, jdv)


@pytest.mark.parametrize("backend", ["chunked", "xla"])
def test_reference_vs_jax_grads(backend):
    """The plain version against ``jax.grad`` of JAX's ``spmm_chunked``
    (Pallas, interpret mode, through its fused backward) and of the XLA
    ``spmm_coo``."""
    row, col, val, x, g = _graph(seed=1)
    dx, dv, _ = _port(row, col, val, x, g)
    jdv, jdx = _jax_grads(row, col, val, x, g, backend)
    if backend == "xla":
        _close(dx, jdx, F32)
        _close(dv, jdv, F32)
    else:
        _check_vs_pallas(dx, dv, row, col, val, x, g, jdx, jdv)


def test_reference_f64_vs_jax_xla():
    """f64 end to end against JAX's XLA grads in f64 (x64 is on)."""
    assert jax.config.jax_enable_x64
    row, col, val, x, g = _graph(seed=2, dtype=np.float64)
    dx, dv, _ = _port(row, col, val, x, g)
    assert dx.dtype == dv.dtype == np.float64
    jdv, jdx = _jax_grads(row, col, val, x, g, "xla")
    _close(dx, jdx, F64)
    _close(dv, jdv, F64)


@pytest.mark.parametrize("k", [1, 3, 47])
def test_reference_other_k_with_padding(k):
    """K 1, 3 and 47, 100 padding entries (``d value`` 0 there) and empty
    columns (``d x`` 0 there), against JAX's fused kernel."""
    row, col, val, x, g = _graph(seed=3, k=k)
    dx, dv, pad_dv = _port(row, col, val, x, g, pad=100)
    assert pad_dv.numel() == 100 and not pad_dv.any()
    assert not dx[list(EMPTY_COLS)].any()
    jdx, jdv = _jax_fused(row, col, val, x, g)
    _check_vs_pallas(dx, dv, row, col, val, x, g, jdx, jdv)


def test_reference_value_none():
    """``value`` None: ``d x = A^T @ g`` with ones, against ``jax.grad`` of
    ``spmm_chunked(plan, s, None, x)``; ``d value`` (the same dots, which do
    not read the values) against JAX's fused kernel."""
    row, col, val, x, g = _graph(seed=4)
    dx, dv, _ = _port(row, col, val, x, g, with_value=False)
    _, jdx = _jax_grads(row, col, None, x, g)
    _, jdv = _jax_fused(row, col, val, x, g)
    _check_vs_pallas(dx, dv, row, col, np.ones_like(val), x, g, jdx, jdv)


@pytest.mark.parametrize("cap", [3, 8, 64])
def test_split_columns_follow_the_table(cap):
    """Long columns cut into pieces of ``cap`` edges: the plain SpMM that
    follows the piece table (each piece's partial, then the fold, as the
    kernel's pieces and ``fold_pieces`` do) gives the reference's ``d x``;
    a hub column of 2,500 edges is split by JAX's plan too (its cap is
    2,048), and both agree with JAX's fused kernel."""
    row, col, val, x, g = _graph(seed=5, hub=2500)
    A = PaddedCOO.from_arrays(row, col, _t(val), (M, N))
    s = A.structure()
    start, end = s.colptr[None, :-1], s.colptr[None, 1:]
    table = split_rows(start, end, cap)
    assert table is not None and 5 in table.fold_row.tolist()   # the hub
    value_t = A.value.index_select(0, s.perm)
    piecewise = spmm_spans_piecewise(start, end, s.col_t, value_t, None,
                                     _t(g), table)
    dx, dv = spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, A.value, _t(g),
                                 _t(x), split=table)
    _close_to_exact(piecewise.numpy(), dx.numpy().astype(np.float64),
                    _exact(row, col, val, x, g)[1][0])
    jdx, jdv = _jax_fused(row, col, val, x, g)
    _check_vs_pallas(dx.numpy(), dv.numpy(), row, col, val, x, g, jdx, jdv)


def test_reference_equals_the_pair():
    """On the CPU the fused plain version gives the pair's plain outputs
    bit for bit: K2's (``sddmm_csr_reference``) d value and K1's
    (``spmm_csr_reference`` over the CSC view) d x, in f32 and bf16."""
    row, col, val, x, g = _graph(seed=6)
    A = PaddedCOO.from_arrays(row, col, _t(val), (M, N),
                              capacity=row.size + 50)
    s = A.structure()
    for dt in (torch.float32, torch.bfloat16):
        v, xx, gg = A.value.to(dt), _t(x).to(dt), _t(g).to(dt)
        dx, dv = spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, v, gg, xx,
                                     out_dtype=dt)
        want_dv = sddmm_csr_cuda(A.rowptr(), A.col, gg, xx, out_dtype=dt)
        want_dx = spmm_csr_cuda(s.colptr, s.col_t, v.index_select(0, s.perm),
                                gg)
        assert dx.dtype == want_dx.dtype and dv.dtype == want_dv.dtype == dt
        assert torch.equal(dx, want_dx) and torch.equal(dv, want_dv)


class _Spy:
    """Counts the calls of the three backward kernels' wrappers as
    ``ops/spmm.py`` reaches them."""

    def __init__(self, monkeypatch):
        self.calls = {"fused": 0, "k2": 0, "k1": 0}
        for name, key in (("spmm_sddmm_csc_cuda", "fused"),
                          ("sddmm_csr_cuda", "k2"), ("spmm_csr_cuda", "k1")):
            fn = getattr(tspmm, name)
            monkeypatch.setattr(tspmm, name, self._wrap(fn, key))

    def _wrap(self, fn, key):
        def call(*args, **kw):
            self.calls[key] += 1
            return fn(*args, **kw)
        return call


@pytest.mark.parametrize("wrt", ["both", "value", "x", "x_value_none"])
def test_backward_dispatch(monkeypatch, wrt):
    """``_SpmmSum.backward`` runs the fused pass exactly when both ``d
    value`` and ``d x`` are needed; K2 over the CSR for ``d value`` alone;
    K1 over the CSC view for ``d x`` alone or with ``value`` None. The
    forward is one K1 in every case; the grads match JAX's."""
    row, col, val, x, g = _graph(seed=7)
    spy = _Spy(monkeypatch)
    v = None if wrt == "x_value_none" else _t(val).requires_grad_(
        wrt in ("both", "value"))
    xt = _t(x).requires_grad_(wrt != "value")
    (spmm_coo(_t(row), _t(col), v, xt, M) * _t(g)).sum().backward()
    want = {"both": {"fused": 1, "k2": 0, "k1": 1},
            "value": {"fused": 0, "k2": 1, "k1": 1},
            "x": {"fused": 0, "k2": 0, "k1": 2},
            "x_value_none": {"fused": 0, "k2": 0, "k1": 2}}[wrt]
    assert spy.calls == want
    jdv, jdx = _jax_grads(row, col, None if v is None else val, x, g, "xla")
    if wrt != "value":
        _close(xt.grad.numpy(), jdx, F32)
    if wrt in ("both", "value"):
        _close(v.grad.numpy(), jdv, F32)


# (dtype of value, x and g, tolerance against JAX in f64 from the same
# rounded inputs): each entry within ``rel`` of its sum of |terms| plus
# ``out`` of |itself| (the output's one rounding) and ``tiny``
VJP_DTYPES = {torch.float16: dict(rel=1e-5, out=2.0 ** -11, tiny=2.0 ** -25),
              torch.bfloat16: dict(rel=1e-5, out=2.0 ** -8, tiny=0.0),
              torch.float32: dict(rel=1e-5, out=0.0, tiny=1e-30),
              torch.float64: dict(rel=1e-12, out=0.0, tiny=1e-300)}
JAX_DT = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16,
          torch.float32: jnp.float32, torch.float64: jnp.float64}
HUB = 1100                                # column 5: past CAP, in pieces
PAD = 37                                  # padding entries (row = M)


def _jax_vjp(row, col, val, x, g):
    """``(d value, d x)`` by ``jax.vjp`` of JAX's ``spmm_coo`` (the XLA
    path) at ``g``, all f64; entries with ``row >= M`` are padding."""
    r, c = jnp.asarray(row), jnp.asarray(col)
    _, vjp = jax.vjp(lambda v, xx: jspmm.spmm_coo(r, c, v, xx, M),
                     jnp.asarray(val), jnp.asarray(x))
    return [np.asarray(t, np.float64) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("k", [1, 5, 47, 256, 300])
@pytest.mark.parametrize("dtype", list(VJP_DTYPES), ids=lambda d: str(d)[6:])
def test_sum_grads_vs_jax_vjp(monkeypatch, dtype, k):
    """Both grads of ``spmm_coo`` (``_SumGrads``: the fused pass once, the
    values relayed into CSC order and ``d value`` read back through
    ``inv_perm``) against ``jax.vjp`` of JAX's ``spmm_coo`` from the same
    seeded inputs rounded to ``dtype``, in f64: padding entries (``d
    value`` 0), empty columns (``d x`` 0), a hub column of 1,100 edges past
    ``CAP`` (its piece table built), K past ``32 * V * NV`` (300)."""
    from paddle_sparse_tpu_torch import CAP
    row, col, val, x, g = _graph(seed=8, hub=HUB, dtype=np.float64, k=k)
    row = np.concatenate([row, np.full(PAD, M, np.int32)])   # padding
    col = np.concatenate([col, np.arange(PAD, dtype=np.int32)])
    val = np.concatenate([val, np.random.default_rng(9).standard_normal(
        PAD)])
    tv, tx, tg = (_t(a).to(dtype) for a in (val, x, g))
    rounded = [t.double().numpy() for t in (tv, tx, tg)]
    spy = _Spy(monkeypatch)
    tv.requires_grad_()
    tx.requires_grad_()
    out = spmm_coo(_t(row), _t(col), tv, tx, M)
    (out * tg).sum().backward()
    assert spy.calls == {"fused": 1, "k2": 0, "k1": 1}
    assert tv.grad.dtype == tx.grad.dtype == dtype
    rowptr = tspmm.ind2ptr(_t(row), M)
    s = tspmm.spmm_structure(rowptr, _t(row), _t(col), N)
    assert s.col_split is not None and HUB > CAP
    assert 5 in s.col_split.fold_row.tolist()
    want = _jax_vjp(row, col, *rounded)
    scale = _jax_vjp(row, col, *(np.abs(a) for a in rounded))
    tol = VJP_DTYPES[dtype]
    for got, ref, sc in zip((tv.grad, tx.grad), want, scale):
        err = np.abs(got.double().numpy() - ref)
        bound = tol["rel"] * sc + tol["out"] * np.abs(ref) + tol["tiny"]
        assert (err <= bound).all(), float((err - bound).max())
    assert not tv.grad[-PAD:].any()                    # padding
    assert not tx.grad[list(EMPTY_COLS)].any()         # empty columns


def test_relay_inverts_perm():
    """The relay's ``inv_perm`` is the inverse of ``perm`` for a padded
    ``PaddedCOO``'s structure, the facade's and the transpose's (whose
    ``perm`` and ``inv_perm`` are A's, swapped); the wrapper builds the
    same one when none is given; the launch alone (``csc_order_cuda``,
    values and ``d value`` in CSC order) gives the routed call's outputs
    read in CSC order, 0 past ``colptr[N]``."""
    from paddle_sparse_tpu_torch import SparseTensor
    from paddle_sparse_tpu_torch.ops.convert import invert_perm
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        csc_order_cuda)
    row, col, val, x, g = _graph(seed=10, hub=40)
    A = PaddedCOO.from_arrays(row, col, _t(val), (M, N),
                              capacity=row.size + PAD)
    s = A.structure()
    T = SparseTensor(row=_t(row).long(), col=_t(col).long(), value=_t(val),
                     sparse_sizes=(M, N))
    st = tspmm.transpose_structure(s, A.col)
    for perm, inv in ((s.perm, s.inv_perm), (st.perm, st.inv_perm),
                      (T.storage.spmm_structure().perm,
                       T.storage.spmm_structure().inv_perm)):
        ids = torch.arange(perm.numel(), dtype=perm.dtype)
        assert inv.dtype == perm.dtype == torch.int32
        assert torch.equal(inv[perm.long()], ids)
        assert torch.equal(perm[inv.long()], ids)
        assert torch.equal(invert_perm(perm), inv)
    assert torch.equal(st.perm, s.inv_perm) and torch.equal(st.inv_perm,
                                                            s.perm)
    routed = spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, A.value, _t(g),
                                 _t(x), split=s.col_split,
                                 inv_perm=s.inv_perm)
    built = spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, A.value, _t(g),
                                _t(x), split=s.col_split)
    d_x, dv_t = csc_order_cuda(s.colptr, s.col_t,
                               A.value.index_select(0, s.perm), _t(g), _t(x))
    assert all(torch.equal(a, b) for a, b in zip(routed, built))
    assert torch.equal(d_x, routed[0])
    assert torch.equal(dv_t, routed[1].index_select(0, s.perm))
    assert not dv_t[int(s.colptr[-1]):].any() and not routed[1][-PAD:].any()


class _CountingDict(dict):
    """A ``dict`` that counts its stores: the relays ``csc_values`` made."""

    def __init__(self, *args):
        super().__init__(*args)
        self.stores = 0

    def __setitem__(self, key, value):
        if key == "csc_values":
            self.stores += 1
        super().__setitem__(key, value)


def test_csc_values_cache_and_invalidation():
    """``csc_values`` serves ``value[perm]`` again from the caller's dict
    for the same unwritten tensor and ``perm``; an in-place write (its
    version counter) or another ``perm`` relays again; nothing is kept
    without a dict or where autograd records the gather. Through a
    ``PaddedCOO`` (its cache dict is the one passed): a backward through
    two layers on one value (``A @ (A @ x)``, both grads) relays once, the
    next forward empties the entry, and a write through ``.data`` between
    steps (no version bump) is seen."""
    row, col, val, x, g = _graph(seed=11)
    A = PaddedCOO.from_arrays(row, col, _t(val), (M, N))
    s = A.structure()
    relays = _CountingDict()
    v = _t(val).clone()
    first = tspmm.csc_values(v, s.perm, relays)
    assert tspmm.csc_values(v, s.perm, relays) is first
    assert relays.stores == 1
    other = s.perm.flip(0)
    assert torch.equal(tspmm.csc_values(v, other, relays), v[other.long()])
    assert tspmm.csc_values(v, s.perm, relays) is not first  # perm changed
    kept = tspmm.csc_values(v, s.perm, relays)
    v.mul_(2)                                             # version bump
    again = tspmm.csc_values(v, s.perm, relays)
    assert again is not kept and torch.equal(again, v[s.perm.long()])
    assert tspmm.csc_values(v, s.perm, None) is not again  # no dict
    w = _t(val).clone().requires_grad_()
    before = relays.stores
    with torch.enable_grad():
        t = tspmm.csc_values(w, s.perm, relays)
    assert t.requires_grad and relays.stores == before    # recorded
    # two layers on one value through a PaddedCOO: one relay a backward
    keep = row < N                      # A @ (A @ x): a square A
    r2, c2 = _t(row[keep]).long(), _t(col[keep]).long()
    adj = PaddedCOO.from_arrays(r2, c2, _t(val[keep]), (N, N))
    adj.value.requires_grad_()
    counting = _CountingDict(adj._cache)
    object.__setattr__(adj, "_cache", counting)
    xx = _t(x).requires_grad_()
    w = _t(x[:, :1])
    for step in range(2):
        if step:
            adj.value.data.mul_(3)                        # no version bump
        adj.value.grad = xx.grad = None
        before = counting.stores
        out = adj.spmm(adj.spmm(xx))
        assert "csc_values" not in counting               # the forward
        (out * w).sum().backward()
        assert counting.stores - before == 1
        dense = torch.zeros(N, N).index_put((r2, c2), adj.value.detach(),
                                            accumulate=True)
        want = dense.t() @ dense.t() @ w.expand(-1, x.shape[1])
        assert torch.allclose(xx.grad, want, rtol=1e-5, atol=1e-4)


def test_set_testing_device():
    """``testing.set_testing_device`` makes new tensors land on the device
    given, as the reference's sets JAX's default device; ``None`` puts the
    CPU default back."""
    from paddle_sparse_tpu_torch.testing import set_testing_device
    try:
        set_testing_device("meta")
        assert torch.empty(3).device.type == "meta"
    finally:
        set_testing_device(None)
    assert torch.empty(3).device.type == "cpu"
