"""Port parity: SpGEMM of paddle_sparse_tpu_torch (``spspmm_padded``,
``spspmm_rowsorted``, ``spspmm_rowblocked``, ``spspmm_eager``, the planners)
against the JAX functions of the same names, on the same operands: built
from a seed with numpy, coalesced by the JAX ``PaddedCOO`` and carried
across with ``padded_coo_from_jax``.

Tolerances: ``nnz``, ``overflowed``, the planners' tuples and the row and
col arrays (pads included) exact. Values ``rtol=1e-5, atol=1e-6``: f32
sums, in another order where JAX's segment sums differ from the port's
stream order. Against the JAX rowsorted path with the Pallas compress
(interpret mode): ``5e-5 * max(1, max|v|)``, its Dekker bf16 value split.
Value gradients ``rtol=1e-4, atol=1e-5`` against ``jax.grad``, as
``tests/test_core_spgemm.py``; one f64 ``gradcheck``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.core import spgemm as jsp
from paddle_sparse_tpu.ops import spspmm as jplan
from paddle_sparse_tpu_torch import (PaddedCOO, matmul_padded,
                                     padded_coo_from_jax, plan_spgemm,
                                     plan_spgemm_blocked, plan_spgemm_rows,
                                     spgemm_entry, spgemm_flops,
                                     spspmm_eager, spspmm_padded,
                                     spspmm_rowblocked, spspmm_rowsorted)

VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _jax_operand(rng, m, k, nnz, pads=5, empty_rows=(), value=True):
    """A coalesced JAX PaddedCOO (m, k) with ``pads`` extra capacity; rows
    in ``empty_rows`` hold no entry."""
    rows = np.setdiff1d(np.arange(m), np.asarray(empty_rows, np.int64))
    row = np.sort(rng.choice(rows, nnz))
    col = rng.integers(0, k, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    return JPaddedCOO.from_arrays(
        jnp.asarray(row[order].astype(np.int32)),
        jnp.asarray(col[order].astype(np.int32)),
        jnp.asarray(val) if value else None, (m, k),
        capacity=nnz + pads).coalesce()


def _pair(seed, M=70, K=60, N=50, nnzA=500, nnzB=400, values=("A", "B")):
    """JAX and port operands A (M, K), B (K, N). B has empty rows, so some
    A-entries fan out to nothing."""
    rng = np.random.default_rng(seed)
    jA = _jax_operand(rng, M, K, nnzA, value="A" in values)
    jB = _jax_operand(rng, K, N, nnzB, empty_rows=range(0, K, 7),
                      value="B" in values)
    return jA, jB, padded_coo_from_jax(jA), padded_coo_from_jax(jB)


def _same(res, jres, val_tol=VAL_TOL):
    """Port ``SpGEMMResult`` == JAX one: nnz, flag, arrays (pads too)."""
    C, jC = res.matrix, jres.matrix
    assert C.shape == jC.shape and C.capacity == jC.capacity
    assert C.nnz == int(jC.nnz)
    assert res.overflowed == bool(jres.overflowed)
    np.testing.assert_array_equal(C.row.numpy(), np.asarray(jC.row))
    np.testing.assert_array_equal(C.col.numpy(), np.asarray(jC.col))
    assert (C.value is None) == (jC.value is None)
    if C.value is not None:
        np.testing.assert_allclose(C.value.detach().double().numpy(),
                                   np.asarray(jC.value, np.float64),
                                   **val_tol)


def _dense(mat):
    """f64 dense of a port PaddedCOO's real entries."""
    d = torch.zeros(mat.shape, dtype=torch.float64)
    n = mat.nnz
    v = (torch.ones(n, dtype=torch.float64) if mat.value is None
         else mat.value[:n].detach().double())
    d.index_put_((mat.row[:n].long(), mat.col[:n].long()), v,
                 accumulate=True)
    return d


SHAPES = [
    dict(M=70, K=60, N=50, nnzA=500, nnzB=400),     # rectangular
    dict(M=40, K=40, N=40, nnzA=240, nnzB=240),
    dict(M=9, K=300, N=7, nnzA=60, nnzB=200),       # wide K, few columns
]
VALUES = [("A", "B"), ("A",), ("B",), ()]


@pytest.mark.parametrize("shape", range(len(SHAPES)))
@pytest.mark.parametrize("values", VALUES, ids="AB A B none".split())
def test_rowsorted_and_padded_match_jax(shape, values):
    """Both variants and the planners, on the same operands and plans;
    one-sided and two-sided ``value=None``."""
    jA, jB, A, B = _pair(shape, values=values, **SHAPES[shape])
    F, oc = plan_spgemm_rows(A, B)
    assert (F, oc) == jplan.plan_spgemm_rows(jA, jB) and F is not None
    _same(spspmm_rowsorted(A, B, F, oc), jsp.spspmm_rowsorted(jA, jB, F, oc))
    fc, oc2 = plan_spgemm(A, B)
    assert (fc, oc2) == jplan.plan_spgemm(jA, jB)
    assert plan_spgemm(A, B, exact_out=False) == jplan.plan_spgemm(
        jA, jB, exact_out=False)
    res = spspmm_padded(A, B, fc, oc2)
    _same(res, jsp.spspmm_padded(jA, jB, fc, oc2))
    assert not res.overflowed
    want = _dense(A) @ _dense(B)
    if values:
        torch.testing.assert_close(_dense(res.matrix), want, rtol=1e-5,
                                   atol=1e-5)
    else:                               # structural: the pattern only
        assert res.matrix.value is None
        assert torch.equal(_dense(res.matrix) == 1, want > 0)


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_rowblocked_matches_jax(shape):
    """Forced to several row blocks, as ``tests/test_core_spgemm.py``; the
    blocked planner's tuple equals JAX's."""
    jA, jB, A, B = _pair(10 + shape, **SHAPES[shape])
    plan = plan_spgemm_blocked(A, B)
    assert plan == jplan.plan_spgemm_blocked(jA, jB)
    F, oc, _, _, BOC = plan
    M, MB = A.shape[0], 4
    eptr = A.rowptr().long()
    starts = torch.arange(0, M, MB)
    EB = int((eptr[torch.clamp(starts + MB, max=M)] - eptr[starts]).max()) + 8
    res = spspmm_rowblocked(A, B, F, oc, MB, EB, BOC)
    assert not res.overflowed
    _same(res, jsp.spspmm_rowblocked(jA, jB, F, oc, MB, EB, BOC))
    _same(spspmm_rowsorted(A, B, F, oc), jsp.spspmm_rowblocked(
        jA, jB, F, oc, MB, EB, BOC))


@pytest.fixture
def kernel_compress(monkeypatch):
    """The JAX rowsorted path with its Pallas compress: the switch is read
    while tracing, so the jit caches are cleared on the way in and out."""
    monkeypatch.setenv("PSP_SPGEMM_COMPRESS", "kernel")
    jax.clear_caches()
    yield
    monkeypatch.delenv("PSP_SPGEMM_COMPRESS")
    jax.clear_caches()


@pytest.mark.parametrize("cap_cut", [0, 40])
def test_rowsorted_matches_jax_pallas_compress(kernel_compress, cap_cut):
    """Against the JAX kernel path (K5 in interpret mode), also with
    ``out_capacity`` below the unique count."""
    jA, jB, A, B = _pair(0)
    F, oc = plan_spgemm_rows(A, B)
    res = spspmm_rowsorted(A, B, F, oc)
    cap = res.matrix.nnz - cap_cut if cap_cut else oc
    res = spspmm_rowsorted(A, B, F, cap)
    assert res.overflowed == bool(cap_cut)
    jres = jsp.spspmm_rowsorted(jA, jB, F, cap)
    scale = max(1.0, float(np.abs(np.asarray(jres.matrix.value)).max()))
    _same(res, jres, dict(rtol=0, atol=5e-5 * scale))


def test_overflow_flop_capacity():
    """``flop_capacity`` below the product count keeps the first flops in
    A-entry order, as JAX does; the flag is set."""
    jA, jB, A, B = _pair(3)
    fc, oc = plan_spgemm(A, B)
    flops = spgemm_flops(A.rowptr(), A.col[:A.nnz], B.rowptr())
    for cap in (flops - 1, flops // 3):
        res = spspmm_padded(A, B, cap, oc)
        assert res.overflowed
        _same(res, jsp.spspmm_padded(jA, jB, cap, oc))


@pytest.mark.parametrize("variant", ["padded", "rowsorted", "rowblocked"])
def test_overflow_out_capacity(variant):
    """``out_capacity`` below the unique count: the first entries kept,
    ``nnz`` saturates, ``overflowed`` set. JAX's rowblocked keeps the same
    entries but does not set its flag; the port does."""
    jA, jB, A, B = _pair(4)
    F, _ = plan_spgemm_rows(A, B)
    fc, oc = plan_spgemm(A, B)
    cap = spspmm_padded(A, B, fc, oc).matrix.nnz - 37
    if variant == "padded":
        res, jres = (spspmm_padded(A, B, fc, cap),
                     jsp.spspmm_padded(jA, jB, fc, cap))
    elif variant == "rowsorted":
        res, jres = (spspmm_rowsorted(A, B, F, cap),
                     jsp.spspmm_rowsorted(jA, jB, F, cap))
    else:
        M = A.shape[0]
        args = (F, cap, 16, A.capacity, 16 * F)
        res = spspmm_rowblocked(A, B, *args)
        jres = jsp.spspmm_rowblocked(jA, jB, *args)
        assert not bool(jres.overflowed)
        jres = jres._replace(overflowed=True)
        assert M > 16
    assert res.overflowed and res.matrix.nnz == cap
    _same(res, jres)


def test_overflow_row_flop_capacity():
    """A row with more than F flops keeps its first F (A-entry order) in
    both the rowsorted and, per block, the rowblocked variant."""
    jA, jB, A, B = _pair(5)
    F, oc = plan_spgemm_rows(A, B)
    small = F // 2
    res = spspmm_rowsorted(A, B, small, oc)
    assert res.overflowed
    _same(res, jsp.spspmm_rowsorted(jA, jB, small, oc))
    args = (small, oc, 8, A.capacity, oc)
    res = spspmm_rowblocked(A, B, *args)
    assert res.overflowed
    _same(res, jsp.spspmm_rowblocked(jA, jB, *args))


def test_overflow_block_out():
    """A block with more unique entries than ``block_out`` keeps its first
    ``block_out``; the blocks after it follow at the carried offset."""
    jA, jB, A, B = _pair(6)
    F, oc = plan_spgemm_rows(A, B)
    args = (F, oc, 10, A.capacity, 60)
    res = spspmm_rowblocked(A, B, *args)
    assert res.overflowed
    _same(res, jsp.spspmm_rowblocked(jA, jB, *args))


def test_overflow_block_edges():
    """A-entries past ``block_edges`` in a block are dropped (C is the
    product without them) and reported. The JAX version writes their
    products at wrong coordinates, so this holds the port to the exact
    product instead."""
    jA, jB, A, B = _pair(7)
    F, oc = plan_spgemm_rows(A, B)
    MB, EB = 10, 30
    res = spspmm_rowblocked(A, B, F, oc, MB, EB, oc)
    assert res.overflowed
    eptr = A.rowptr().long()
    keep = torch.zeros(A.capacity, dtype=torch.bool)
    for r0 in range(0, A.shape[0], MB):
        lo = int(eptr[r0])
        keep[lo:min(lo + EB, int(eptr[min(r0 + MB, A.shape[0])]))] = True
    kept = A.with_value(torch.where(keep, A.value, 0.0))
    want = _dense(kept) @ _dense(B)
    torch.testing.assert_close(_dense(res.matrix), want, rtol=1e-5,
                               atol=1e-5)


def test_poisoned_pads_do_not_change_c():
    """Pads' cols set far outside B (and negative) in A and B: every
    variant gives the same C."""
    jA, jB, A, B = _pair(8)

    def poison(m, bad):
        return dataclasses.replace(m, col=torch.where(
            m.valid_mask(), m.col, torch.full_like(m.col, bad)))

    pA, pB = poison(A, 1 << 30), poison(B, -3)
    F, oc = plan_spgemm_rows(A, B)
    assert plan_spgemm_rows(pA, pB) == (F, oc)
    fc, oc2 = plan_spgemm(A, B)
    assert plan_spgemm(pA, pB) == (fc, oc2)
    pairs = [(spspmm_rowsorted(pA, pB, F, oc),
              jsp.spspmm_rowsorted(jA, jB, F, oc)),
             (spspmm_padded(pA, pB, fc, oc2),
              jsp.spspmm_padded(jA, jB, fc, oc2)),
             (spspmm_rowblocked(pA, pB, F, oc, 16, pA.capacity, oc),
              jsp.spspmm_rowblocked(jA, jB, F, oc, 16, pA.capacity, oc))]
    for res, jres in pairs:
        _same(res, jres)


def test_empty_a():
    """An A with no entries: nnz 0, C all pads, no overflow; the planners
    agree with JAX."""
    rng = np.random.default_rng(2)
    jA = JPaddedCOO.from_arrays(jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0,), jnp.int32),
                                jnp.zeros((0,), jnp.float32), (12, 9),
                                capacity=8)
    jB = _jax_operand(rng, 9, 11, 30)
    A, B = padded_coo_from_jax(jA), padded_coo_from_jax(jB)
    assert plan_spgemm_rows(A, B) == jplan.plan_spgemm_rows(jA, jB)
    assert plan_spgemm(A, B) == jplan.plan_spgemm(jA, jB)
    assert plan_spgemm_blocked(A, B) is None
    assert jplan.plan_spgemm_blocked(jA, jB) is None
    _same(spspmm_padded(A, B, 8, 8), jsp.spspmm_padded(jA, jB, 8, 8))
    _same(spspmm_rowsorted(A, B, 8, 8), jsp.spspmm_rowsorted(jA, jB, 8, 8))
    _same(spspmm_rowblocked(A, B, 8, 8, 4, 8, 8),
          jsp.spspmm_rowblocked(jA, jB, 8, 8, 4, 8, 8))
    assert spspmm_rowsorted(A, B, 8, 8).matrix.nnz == 0


def test_skew_falls_back_to_the_global_sort():
    """A hot row (1000 entries, every other row 1): both grid planners
    refuse, as JAX's do; the global sort computes C."""
    M = 3000
    row = np.concatenate([np.zeros(1000, np.int32),
                          np.arange(1, M, dtype=np.int32)])
    col = np.concatenate([np.arange(1000, dtype=np.int32) % M,
                          np.arange(1, M, dtype=np.int32)])
    jA = JPaddedCOO.from_arrays(jnp.asarray(np.sort(row)), jnp.asarray(col),
                                jnp.ones((row.size,), jnp.float32),
                                (M, M)).coalesce()
    A = padded_coo_from_jax(jA)
    F, oc = plan_spgemm_rows(A, A)
    assert F is None and (F, oc) == jplan.plan_spgemm_rows(jA, jA)
    assert plan_spgemm_blocked(A, A) is None
    assert jplan.plan_spgemm_blocked(jA, jA) is None
    fc, oc = plan_spgemm(A, A, exact_out=False)
    _same(spspmm_padded(A, A, fc, oc), jsp.spspmm_padded(jA, jA, fc, oc))


def test_int64_indices():
    """int64 operand indices give int64 C indices with the same values."""
    _, _, A, B = _pair(9)
    A64 = dataclasses.replace(A, row=A.row.long(), col=A.col.long())
    B64 = dataclasses.replace(B, row=B.row.long(), col=B.col.long())
    F, oc = plan_spgemm_rows(A, B)
    C, C64 = (spspmm_rowsorted(A, B, F, oc).matrix,
              spspmm_rowsorted(A64, B64, F, oc).matrix)
    assert C64.row.dtype == torch.int64
    assert torch.equal(C64.row, C.row.long()) and torch.equal(C64.value,
                                                              C.value)


def test_shape_mismatch_raises():
    _, _, A, B = _pair(1)
    with pytest.raises(ValueError, match="size mismatch"):
        spspmm_padded(A, A, 64, 64)


def _grad_case(variant, same):
    """Value grads of ``sum(G * C.value)`` (G random, fixed) through one
    variant, port and JAX, for A @ B or A @ A."""
    jA, jB, A, B = _pair(20, M=40, K=40, N=40, nnzA=240, nnzB=240)
    if same:
        jB, B = jA, A
    F, oc = plan_spgemm_rows(A, B)
    fc, oc2 = plan_spgemm(A, B)
    G = np.random.default_rng(1).standard_normal(
        max(oc, oc2)).astype(np.float32)
    calls = {
        "rowsorted": (spspmm_rowsorted, jsp.spspmm_rowsorted, (F, oc)),
        "padded": (spspmm_padded, jsp.spspmm_padded, (fc, oc2)),
        "rowblocked": (spspmm_rowblocked, jsp.spspmm_rowblocked,
                       (F, oc, 8, A.capacity, oc)),
    }
    fn, jfn, args = calls[variant]

    def j_loss(va, vb):
        Ai = dataclasses.replace(jA, value=va)
        Bi = Ai if same else dataclasses.replace(jB, value=vb)
        v = jfn(Ai, Bi, *args).matrix.value
        return (v * jnp.asarray(G[:v.shape[0]])).sum()

    jga, jgb = jax.grad(j_loss, argnums=(0, 1))(jA.value, jB.value)
    va = A.value.clone().requires_grad_()
    vb = va if same else B.value.clone().requires_grad_()
    Ai = A.with_value(va)
    Bi = Ai if same else B.with_value(vb)
    v = fn(Ai, Bi, *args).matrix.value
    (v * torch.from_numpy(G[:v.shape[0]])).sum().backward()
    np.testing.assert_allclose(va.grad.numpy(), np.asarray(jga), **GRAD_TOL)
    if not same:
        np.testing.assert_allclose(vb.grad.numpy(), np.asarray(jgb),
                                   **GRAD_TOL)
    assert not va.grad[A.nnz:].any()


@pytest.mark.parametrize("variant", ["rowsorted", "padded", "rowblocked"])
@pytest.mark.parametrize("same", [False, True], ids=["A@B", "A@A"])
def test_value_grads_match_jax(variant, same):
    _grad_case(variant, same)


def test_gradcheck_f64():
    _, _, A, B = _pair(21, M=8, K=7, N=6, nnzA=20, nnzB=18)
    F, oc = plan_spgemm_rows(A, B)
    va = A.value.double().requires_grad_()
    vb = B.value.double().requires_grad_()

    def f(a, b):
        return spspmm_rowsorted(A.with_value(a), B.with_value(b), F,
                                oc).matrix.value

    assert torch.autograd.gradcheck(f, (va, vb))


@pytest.mark.parametrize("values", VALUES, ids="AB A B none".split())
def test_eager_matches_jax(values):
    jA, jB, A, B = _pair(30, values=values)
    n, nb = A.nnz, B.nnz
    args = (A.row[:n], A.col[:n], None if A.value is None else A.value[:n],
            B.rowptr(), B.col[:nb], None if B.value is None else B.value[:nb],
            A.shape[0], B.shape[1])
    r, c, v = spspmm_eager(*args)
    jr, jc, jv = jplan.spspmm_eager(*[None if a is None else (
        a if isinstance(a, int) else jnp.asarray(a.numpy())) for a in args])
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert (v is None) == (jv is None)
    if v is not None:
        np.testing.assert_allclose(v.double().numpy(),
                                   np.asarray(jv, np.float64), **VAL_TOL)
    empty = spspmm_eager(A.row[:0], A.col[:0], None, B.rowptr(), B.col[:nb],
                         None, A.shape[0], B.shape[1])
    assert all(t is None or t.numel() == 0 for t in empty)
    assert spgemm_flops(A.rowptr(), A.col[:n], B.rowptr()) == \
        jplan.spgemm_flops(jnp.asarray(A.rowptr().numpy()),
                           jnp.asarray(A.col[:n].numpy()),
                           jnp.asarray(B.rowptr().numpy()))


def test_matmul_padded():
    _, _, A, B = _pair(31)
    fc, oc = plan_spgemm(A, B)
    C = matmul_padded(A, B, fc, oc)
    assert isinstance(C, PaddedCOO)
    torch.testing.assert_close(_dense(C), _dense(A) @ _dense(B), rtol=1e-5,
                               atol=1e-5)


def test_spgemm_entry_a_at_a_matches_dense():
    """The toy adjacency's A @ A equals the dense product, as
    ``__graft_entry__.dryrun_multichip`` checks the JAX one; all three
    variants agree."""
    A = spgemm_entry("cpu")
    assert A.shape == (256, 256) and A.capacity == 2304
    dense_a = _dense(A)
    F, oc = plan_spgemm_rows(A, A)
    res = spspmm_rowsorted(A, A, F, oc)
    assert not res.overflowed
    torch.testing.assert_close(_dense(res.matrix), dense_a @ dense_a,
                               rtol=1e-4, atol=1e-4)
    fc, oc2 = plan_spgemm(A, A)
    blocked = plan_spgemm_blocked(A, A)
    for other in (spspmm_padded(A, A, fc, oc2),
                  spspmm_rowblocked(A, A, *blocked)):
        assert other.matrix.nnz == res.matrix.nnz and not other.overflowed
        n = res.matrix.nnz
        assert torch.equal(other.matrix.row[:n], res.matrix.row[:n])
        assert torch.equal(other.matrix.col[:n], res.matrix.col[:n])
