"""Port parity in every float dtype the JAX package computes: f16, bf16, f32,
f64 and their mixed pairs through ``spmm_coo``, ``PaddedCOO.spmm`` and the
facade's ``matmul`` (sum and mean: forward, ``d value`` and ``d x``), the
integer and float values of ``PaddedCOO.coalesce`` with and without a
trailing dim, ``spspmm_padded``/``spspmm_rowsorted`` with bf16 and f16
values, and a 2-layer GCN train step in f16 and in f64, params carried across
by ``gcn_params_from_jax``. The same numpy inputs, made from a seed, go
through the JAX function (x64 on, as ``tests/conftest.py`` sets it) and the
port on the CPU, where the port runs its kernels' plain versions, which take
the dtypes the CUDA kernels take and sum as they do. Also the dtype rules of
the CUDA wrappers, which hold on any device: what each kernel takes, and
that a mixed pair casts ``g`` up, never ``x``.

Output dtypes equal JAX's: ``promote_types(value, x)`` forward, ``d value``
in ``value``'s dtype and ``d x`` in ``x``'s; a coalesced or SpGEMM value in
its operands' dtype.

Tolerances:

* f64: ``rtol = atol = 1e-12`` against JAX (sums in another order);
* f32: ``rtol = atol = 1e-5`` (sums in another order);
* f16 and bf16 outputs against JAX's result from the same inputs promoted to
  f64: within the output dtype's rounding, ``rtol`` half an ulp (2**-11 for
  f16, 2**-8 for bf16) and ``atol = 1e-4`` (the port sums in f32 and rounds
  once; the atol covers the f32 sum and f16's subnormals); for
  ``reduce="mean"``, whose division by the degree rounds each term and the
  output again, two ulps of the output plus one of each entry's sum of
  |terms|;
* JAX's own f16/bf16 results, which it accumulates in f16/bf16: ``rtol =
  atol = 2e-2`` (f16) and ``1e-1`` (bf16), its rounding at every add;
* ints exact;
* the GCN step, where every layer rounds its activations to the working
  dtype in both packages: f64 ``1e-12``; f16 against JAX in f64 from the
  same f16 state within 5e-2 of each tensor's max, and against JAX in f16
  within 1e-1 of it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu.ops.spmm as jspmm
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.core import spgemm as jspgemm
from paddle_sparse_tpu.models import GCN as jGCN
from paddle_sparse_tpu.models import init_gcn as j_init
from paddle_sparse_tpu.ops import spspmm as jplan
from paddle_sparse_tpu_torch import (GCN, PaddedCOO, gcn_loss,
                                     gcn_params_from_jax,
                                     padded_coo_from_jax, plan_spgemm,
                                     plan_spgemm_rows, spmm_coo,
                                     spspmm_padded, spspmm_rowsorted)
from paddle_sparse_tpu_torch.ops.kernels import segcompact_cuda
from paddle_sparse_tpu_torch.ops.kernels._build import FLOAT_DTYPES
from paddle_sparse_tpu_torch.ops.kernels.sddmm_cuda import sddmm_operands
from paddle_sparse_tpu_torch.ops.kernels.spmm_cuda import check_spmm_dtypes
from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
    fused_operands)

F16, BF16 = torch.float16, torch.bfloat16
F32, F64 = torch.float32, torch.float64
JAX_DTYPE = {F16: jnp.float16, BF16: jnp.bfloat16, F32: jnp.float32,
             F64: jnp.float64, torch.int32: jnp.int32,
             torch.int64: jnp.int64}
# against JAX in f64 from the same inputs: one rounding of the output
ROUNDING = {F16: dict(rtol=2.0 ** -11, atol=1e-4),
            BF16: dict(rtol=2.0 ** -8, atol=1e-4),
            F32: dict(rtol=1e-5, atol=1e-5),
            F64: dict(rtol=1e-12, atol=1e-12)}
# against JAX in its own narrow dtype, which rounds at every add
JAX_NARROW = {F16: dict(rtol=2e-2, atol=2e-2), BF16: dict(rtol=1e-1, atol=1e-1)}
M, N, K = 60, 50, 8
EMPTY_ROWS = (0, 17, 59)


def _np64(a):
    """A torch or JAX array as f64 numpy (ints as int64)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.double() if a.is_floating_point() else a.long()).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float64 if jnp.issubdtype(
        a.dtype, jnp.floating) else jnp.int64))


def _pair(a, dtype):
    """numpy ``a`` in ``dtype`` on both sides (each rounds to nearest
    even): ``(torch, jax)``."""
    if dtype is None:
        return None, None
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t, jnp.asarray(a).astype(JAX_DTYPE[dtype])


def _wide(j):
    """A JAX array promoted to f64 (None stays None)."""
    return None if j is None else j.astype(jnp.float64)


def _close(got, jref, tol):
    np.testing.assert_allclose(_np64(got), _np64(jref), **tol)


def _graph(seed=3, nnz=400):
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(M), EMPTY_ROWS)
    row = np.sort(rng.choice(keep, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.standard_normal(nnz)
    x = rng.standard_normal((N, K))
    w = rng.standard_normal((M, K))
    return row, col, val, x, w


# (x dtype, value dtype): the four dtypes alone and the mixed pairs
PAIRS = [(F16, F16), (BF16, BF16), (F32, F32), (F64, F64), (F16, F32),
         (F32, F16), (BF16, F32), (F32, BF16), (F16, BF16), (BF16, F16),
         (F64, F32), (F32, F64), (F16, F64), (F64, F16), (F16, None),
         (F64, None)]


def _ids(pairs):
    return ["-".join("none" if d is None else str(d)[6:] for d in p)
            for p in pairs]


def _jax_spmm(row, col, v, x, w, reduce):
    """``(out, d value, d x)`` of ``sum(spmm_coo(v, x) * w)`` in JAX (the
    XLA path, which JAX takes for f16 and f64, and on the CPU for all)."""
    r, c = jnp.asarray(row), jnp.asarray(col)

    def f(vv, xx):
        return jspmm.spmm_coo(r, c, vv, xx, M, reduce)
    out = f(v, x)
    wj = jnp.asarray(w).astype(out.dtype)
    if v is None:
        dx = jax.grad(lambda xx: (f(None, xx) * wj).sum())(x)
        return out, None, dx
    dv, dx = jax.grad(lambda vv, xx: (f(vv, xx) * wj).sum(),
                      argnums=(0, 1))(v, x)
    return out, dv, dx


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("xdt,vdt", PAIRS, ids=_ids(PAIRS))
def test_spmm_coo_dtypes_vs_jax(xdt, vdt, reduce):
    """Forward, ``d value`` and ``d x`` in JAX's dtypes; each within its
    dtype's rounding of JAX run in f64 on the same inputs, and of JAX in
    the same dtypes at the narrow tolerance."""
    row, col, val, x, w = _graph()
    tv, jv = _pair(val, vdt)
    tx, jx = _pair(x, xdt)
    out_dt = xdt if vdt is None else torch.promote_types(vdt, xdt)
    if tv is not None:
        tv.requires_grad_()
    tx.requires_grad_()
    out = spmm_coo(torch.from_numpy(row), torch.from_numpy(col), tv, tx, M,
                   reduce)
    tw = torch.from_numpy(w).to(out_dt)
    (out * tw).sum().backward()
    assert out.dtype == out_dt and tx.grad.dtype == xdt
    assert tv is None or tv.grad.dtype == vdt
    jw = jnp.asarray(_np64(tw))
    ref = _jax_spmm(row, col, _wide(jv), _wide(jx), jw, reduce)
    scale = _jax_spmm(row, col, None if jv is None else abs(_wide(jv)),
                      abs(_wide(jx)), abs(jw), reduce)
    native = _jax_spmm(row, col, jv, jx, w, reduce)
    assert JAX_DTYPE[out_dt] == native[0].dtype
    for got, want, s, own in zip((out, tv, tx), ref, scale, native):
        if got is None:
            continue
        got = got if got is out else got.grad
        if reduce == "mean" and got.dtype in (F16, BF16):
            # each term's 1/deg rounds too, then the sum: within 2 ulps of
            # the output and one of each entry's sum of |terms| (``s``)
            u = ROUNDING[got.dtype]["rtol"]
            err = np.abs(_np64(got) - _np64(want))
            assert (err <= 2 * u * np.abs(_np64(want)) + u * _np64(s)
                    + 1e-4).all(), float(err.max())
        else:
            _close(got, want, ROUNDING[got.dtype])
        _close(got, own, JAX_NARROW.get(got.dtype, ROUNDING[got.dtype]))


FACADE_PAIRS = [(F16, F16), (F64, F64), (F16, F32), (BF16, BF16)]


@pytest.mark.parametrize("api", ["padded", "facade"])
@pytest.mark.parametrize("xdt,vdt", FACADE_PAIRS, ids=_ids(FACADE_PAIRS))
def test_padded_and_facade_spmm_dtypes(api, xdt, vdt):
    """``PaddedCOO.spmm`` (with padding) and the facade's ``matmul``:
    output and grads in JAX's dtypes, within rounding of JAX in f64."""
    row, col, val, x, w = _graph(seed=5)
    tv, jv = _pair(val, vdt)
    tx, jx = _pair(x, xdt)
    out_dt = torch.promote_types(vdt, xdt)
    tv.requires_grad_()
    tx.requires_grad_()
    if api == "padded":
        cap = row.size + 7
        A = PaddedCOO.from_arrays(torch.from_numpy(row),
                                  torch.from_numpy(col), tv, (M, N),
                                  capacity=cap)
        out = A.spmm(tx)

        def jf(vv, xx):
            jA = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                                        vv, (M, N), capacity=cap)
            return jA.spmm(xx)
    else:
        out = tsp.matmul(tsp.SparseTensor(
            row=torch.from_numpy(row).long(), col=torch.from_numpy(col).long(),
            value=tv, sparse_sizes=(M, N)), tx)

        def jf(vv, xx):
            return jsp.matmul(jsp.SparseTensor(
                row=jnp.asarray(row), col=jnp.asarray(col), value=vv,
                sparse_sizes=(M, N)), xx)
    tw = torch.from_numpy(w).to(out_dt)
    (out * tw).sum().backward()
    assert (out.dtype, tv.grad.dtype, tx.grad.dtype) == (out_dt, vdt, xdt)
    wj = jnp.asarray(_np64(tw))
    jout = jf(_wide(jv), _wide(jx))
    jdv, jdx = jax.grad(lambda vv, xx: (jf(vv, xx) * wj).sum(),
                        argnums=(0, 1))(_wide(jv), _wide(jx))
    _close(out, jout, ROUNDING[out_dt])
    _close(tv.grad, jdv, ROUNDING[vdt])
    _close(tx.grad, jdx, ROUNDING[xdt])


COALESCE_DTYPES = [F16, BF16, F32, F64, torch.int32, torch.int64]


@pytest.mark.parametrize("trail", [(), (3,)], ids=["flat", "D3"])
@pytest.mark.parametrize("dtype", COALESCE_DTYPES,
                         ids=[str(d)[6:] for d in COALESCE_DTYPES])
def test_coalesce_dtypes_vs_jax(dtype, trail):
    """``PaddedCOO.coalesce`` with (capacity,) and (capacity, 3) values:
    structure exact, values in their dtype; ints exact, floats within
    rounding of JAX's sum of the same values in f64 (and of JAX's own
    narrow sums at the narrow tolerance)."""
    rng = np.random.default_rng(11)
    nnz, cap = 300, 320
    row = np.sort(rng.integers(0, 20, nnz))
    col = rng.integers(0, 6, nnz)                  # many duplicates
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    if dtype.is_floating_point:
        val = rng.standard_normal((nnz,) + trail)
    else:
        val = rng.integers(-1000, 1000, (nnz,) + trail)
    tv, jv = _pair(val, dtype)
    A = PaddedCOO.from_arrays(torch.from_numpy(row), torch.from_numpy(col),
                              tv, (20, 6), capacity=cap)
    jA = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col), jv,
                                (20, 6), capacity=cap)
    C, jC = A.coalesce(), jA.coalesce()
    assert C.nnz == int(jC.nnz) < nnz
    np.testing.assert_array_equal(C.row.numpy(), np.asarray(jC.row))
    np.testing.assert_array_equal(C.col.numpy(), np.asarray(jC.col))
    assert C.value.dtype == dtype and C.value.shape == (cap,) + trail
    if not dtype.is_floating_point:
        np.testing.assert_array_equal(_np64(C.value), _np64(jC.value))
        return
    jwide = dataclasses.replace(jA, value=_wide(jA.value)).coalesce()
    _close(C.value, jwide.value, ROUNDING[dtype])
    _close(C.value, jC.value, JAX_NARROW.get(dtype, ROUNDING[dtype]))


def _spgemm_operands(seed, dtype):
    rng = np.random.default_rng(seed)

    def one(m, k, nnz):
        row = np.sort(rng.integers(0, m, nnz))
        col = rng.integers(0, k, nnz)
        order = np.lexsort((col, row))
        val = rng.standard_normal(nnz)
        j = JPaddedCOO.from_arrays(
            jnp.asarray(row[order].astype(np.int32)),
            jnp.asarray(col[order].astype(np.int32)),
            jnp.asarray(val[order]), (m, k), capacity=nnz + 5).coalesce()
        j = dataclasses.replace(j, value=j.value.astype(JAX_DTYPE[dtype]))
        return j, padded_coo_from_jax(
            dataclasses.replace(j, value=j.value.astype(jnp.float64)))

    jA, A = one(40, 30, 260)
    jB, B = one(30, 35, 220)
    A = dataclasses.replace(A, value=A.value.to(dtype))
    B = dataclasses.replace(B, value=B.value.to(dtype))
    return jA, jB, A, B


@pytest.mark.parametrize("variant", ["padded", "rowsorted"])
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bfloat16", "float16"])
def test_spspmm_narrow_values_vs_jax(dtype, variant):
    """bf16 and f16 SpGEMM: C's structure equal to JAX's, its values in
    the operands' dtype, within rounding of JAX's C from the same values in
    f64 (products and sums in f64) and of JAX's own narrow C."""
    jA, jB, A, B = _spgemm_operands(7, dtype)
    if variant == "padded":
        fc, oc = plan_spgemm(A, B)
        assert (fc, oc) == jplan.plan_spgemm(jA, jB)
        res = spspmm_padded(A, B, fc, oc)

        def jrun(a, b):
            return jspgemm.spspmm_padded(a, b, fc, oc)
    else:
        F, oc = plan_spgemm_rows(A, B)
        assert (F, oc) == jplan.plan_spgemm_rows(jA, jB)
        res = spspmm_rowsorted(A, B, F, oc)

        def jrun(a, b):
            return jspgemm.spspmm_rowsorted(a, b, F, oc)
    jres = jrun(jA, jB)
    jwide, jscale = (jrun(*(dataclasses.replace(j, value=f(_wide(j.value)))
                            for j in (jA, jB))) for f in (lambda a: a, abs))
    C = res.matrix
    assert C.nnz == int(jres.matrix.nnz) and not res.overflowed
    np.testing.assert_array_equal(C.row.numpy(), np.asarray(jres.matrix.row))
    np.testing.assert_array_equal(C.col.numpy(), np.asarray(jres.matrix.col))
    assert C.value.dtype == dtype
    # each product of two narrow values is rounded once (in both packages)
    # before the sum, and the sum once: within an ulp of the sum of
    # |products| of each entry
    err = np.abs(_np64(C.value) - _np64(jwide.matrix.value))
    assert (err <= 2 * ROUNDING[dtype]["rtol"] * _np64(jscale.matrix.value)
            + 1e-6).all()
    _close(C.value, jres.matrix.value, JAX_NARROW[dtype])


def _gcn_step(dtype, params, row, col, val, x, y, cap):
    """Loss and grads (weights, biases, value) of one port GCN step in
    ``dtype`` with JAX's params loaded."""
    L = len(params["layers"])
    model = GCN(*params["layers"][0]["w"].shape,
                params["layers"][-1]["w"].shape[1], L).to(dtype)
    model.load_state_dict(gcn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    tv = torch.from_numpy(val).to(dtype).requires_grad_()
    adj = PaddedCOO.from_arrays(torch.from_numpy(row), torch.from_numpy(col),
                                tv, (x.shape[0],) * 2, capacity=cap)
    loss = gcn_loss(model, adj, torch.from_numpy(x).to(dtype),
                    torch.from_numpy(y))
    loss.backward()
    return loss, [p.grad for p in model.weight] + [
        p.grad for p in model.bias] + [tv.grad]


def _jax_step(jdtype, params, row, col, val, x, y, cap):
    p = jax.tree_util.tree_map(lambda a: a.astype(jdtype), params)

    def loss(pp, v):
        adj = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col), v,
                                     (x.shape[0],) * 2, capacity=cap)
        logp = jax.nn.log_softmax(jGCN(pp, adj, jnp.asarray(x, jdtype)))
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    axis=1).mean()
    jl, (gp, gv) = jax.value_and_grad(loss, argnums=(0, 1))(
        p, jnp.asarray(val, jdtype))
    return jl, ([layer["w"] for layer in gp["layers"]]
                + [layer["b"] for layer in gp["layers"]] + [gv])


@pytest.mark.parametrize("dtype", [F16, F64], ids=["float16", "float64"])
def test_gcn_train_step_dtypes(dtype):
    """A 2-layer GCN step with every parameter and feature in ``dtype``:
    loss and every grad (weights, biases, ``d value``) in ``dtype``; f64
    against JAX in f64 at 1e-12; f16 against JAX in f64 from the same f16
    state (params, features and values rounded to f16 first) within 5e-2
    of each tensor's max, and against JAX in f16 within 1e-1 of it."""
    rng = np.random.default_rng(21)
    n, nnz, cap = 80, 500, 520
    row = np.sort(rng.integers(0, n, nnz)).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = rng.random(nnz) * 0.3
    x = rng.standard_normal((n, 12))
    y = rng.integers(0, 5, n)
    params = j_init(jax.random.PRNGKey(3), 12, 16, 5, num_layers=2)
    if dtype == F16:   # the f16 state, which JAX in f64 then starts from
        params = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float16).astype(jnp.float32), params)
        val, x = (a.astype(np.float16).astype(np.float64) for a in (val, x))
    loss, grads = _gcn_step(dtype, params, row, col, val, x, y, cap)
    assert loss.dtype == dtype and all(g.dtype == dtype for g in grads)
    checks = [(jnp.float64, 5e-2 if dtype == F16 else 1e-12)]
    if dtype == F16:
        checks.append((jnp.float16, 1e-1))
    for jdtype, rel in checks:
        jl, jgrads = _jax_step(jdtype, params, row, col, val, x, y, cap)
        np.testing.assert_allclose(float(loss), float(jl), rtol=rel)
        for g, jg in zip(grads, jgrads):
            jg = _np64(jg)
            np.testing.assert_allclose(_np64(g), jg, rtol=0,
                                       atol=rel * np.abs(jg).max())


# ---- the CUDA wrappers' dtype rules, which hold on any device ------------

@pytest.mark.parametrize("src,value,out,ok", [
    (F16, F16, F16, True), (F16, F32, F32, True), (F16, None, F16, True),
    (BF16, F16, F32, True), (F64, F32, F64, True), (F16, F64, F64, True),
    (F32, None, F32, True), (BF16, BF16, BF16, True),
    (F32, F32, BF16, False), (F32, F16, F16, False), (F64, F64, F32, False),
    (F32, F64, F32, False), (torch.int32, F32, F32, False)])
def test_spmm_kernel_dtypes(src, value, out, ok):
    """K1 takes every float src and value, and writes f64, f32 (from a src
    narrower than f64) or src's own dtype; an f64 value sums in f64."""
    if ok:
        check_spmm_dtypes("k1", src, value, out)
    else:
        with pytest.raises(TypeError):
            check_spmm_dtypes("k1", src, value, out)


@pytest.mark.parametrize("gdt,xdt,wide", [
    (F16, F16, F16), (F32, F16, F32), (F16, F32, F32), (BF16, F16, F32),
    (F64, F16, F64), (F32, F64, F64), (BF16, F32, F32), (F32, BF16, F32)])
def test_sddmm_operands_cast_g_never_x(gdt, xdt, wide):
    """K2 takes g as wide as x or wider: a narrower g is cast up to their
    promoted dtype, and x is passed as it is (no copy)."""
    g, x = torch.ones(3, 4, dtype=gdt), torch.ones(5, 4, dtype=xdt)
    g2, x2 = sddmm_operands("k2", g, x, F32)
    assert g2.dtype == wide and x2 is x
    assert (g2 is g) == (gdt == wide)


@pytest.mark.parametrize("vdt,gdt,xdt,g_wide,dx_kernel", [
    (F16, F16, F16, F16, F16), (F32, F32, F16, F32, F32),
    (F16, F32, F32, F32, F32), (BF16, F32, F16, F32, F32),
    (F32, BF16, BF16, BF16, F32), (F64, F64, F16, F64, F64),
    (F64, F16, F16, F64, F64), (F16, F64, F64, F64, F64),
    (BF16, BF16, BF16, BF16, BF16), (F32, F16, F16, F16, F32)])
def test_fused_operands(vdt, gdt, xdt, g_wide, dx_kernel):
    """The fused CSC backward: g cast up to the promoted dtype of g and x
    (to f64 when any input is f64), x never copied; d x written in the
    sum's type from an f32 or f64 g, else in g's dtype or f32."""
    v = torch.ones(6, dtype=vdt)
    g, x = torch.ones(3, 4, dtype=gdt), torch.ones(5, 4, dtype=xdt)
    dx_dtype = torch.promote_types(vdt, gdt)
    g2, kdx = fused_operands("k2'", v, g, x, FLOAT_DTYPES, dx_dtype, vdt)
    assert (g2.dtype, kdx) == (g_wide, dx_kernel)


def test_segcompact_sum_dtypes():
    """K5 sums f16 and bf16 in f32 and every other value dtype in its own;
    the plain version's (capacity, D) f16 sums round once, so they equal the
    f32 sums rounded."""
    assert [segcompact_cuda.sum_dtype(d) for d in COALESCE_DTYPES] == [
        F32, F32, F32, F64, torch.int32, torch.int64]
    rng = np.random.default_rng(2)
    col = torch.tensor([0, 0, 0, 1, 2, 2], dtype=torch.int32)
    rows = torch.zeros(6, dtype=torch.int32)
    v = torch.from_numpy(rng.standard_normal((6, 4))).half()
    out = segcompact_cuda.compact_runs_reference(col, rows, v, (1, 3), 4)
    want = segcompact_cuda.compact_runs_reference(col, rows, v.float(),
                                                  (1, 3), 4)
    assert out.value.dtype == F16
    assert torch.equal(out.value, want.value.half())


# ---- integer operands: exact, as JAX's wrapped integer sums -----------------

INT_DTYPES = {torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.uint8: np.uint8, torch.bool: np.bool_}
# (value dtype, x dtype): each int alone, the pairs, None and bool values
INT_PAIRS = [(torch.int8, torch.int8), (torch.int16, torch.int16),
             (torch.int32, torch.int32), (torch.int64, torch.int64),
             (torch.uint8, torch.uint8), (None, torch.int32),
             (None, torch.int64), (None, torch.int8), (None, torch.uint8),
             (torch.int32, torch.int64), (torch.int64, torch.int32),
             (torch.uint8, torch.int8), (torch.int8, torch.uint8),
             (torch.int16, torch.int32), (torch.uint8, torch.int64),
             (torch.int8, torch.int64), (torch.bool, torch.int32),
             (torch.int16, torch.bool), (torch.bool, torch.uint8)]


def _ints(rng, dtype, shape):
    """Integers over the dtype's range (int32: +-2**30, int64: +-2**40, so
    that products and sums pass 2**31 and 2**24)."""
    if dtype == torch.bool:
        return rng.integers(0, 2, shape).astype(np.bool_)
    info = np.iinfo(INT_DTYPES[dtype])
    lo, hi = max(info.min, -2 ** 40), min(info.max, 2 ** 40)
    if dtype == torch.int32:
        lo, hi = -2 ** 30, 2 ** 30
    return rng.integers(lo, hi, shape, endpoint=True).astype(
        INT_DTYPES[dtype])


def _int_case(vdt, xdt, seed=0, m=30, n=20, nnz=200, k=5):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, m, nnz)).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    v = None if vdt is None else _ints(rng, vdt, nnz)
    x = _ints(rng, xdt, (n, k))
    return row, col, v, x


def _int_ids(pairs):
    return ["-".join("none" if d is None else str(d)[6:] for d in p)
            for p in pairs]


@pytest.mark.parametrize("reduce", ["sum", "min", "max", "mean"])
@pytest.mark.parametrize("vdt,xdt", INT_PAIRS, ids=_int_ids(INT_PAIRS))
def test_int_spmm_exact_vs_jax(vdt, xdt, reduce):
    """Every int dtype and pair (and bool beside an int) through
    ``spmm_coo``: the dtype and every entry equal to JAX's, whose sums wrap
    at every add (int32 operands of +-2**30: products and sums past 2**31;
    int64 past 2**24, where an f32 sum rounds). ``mean`` is a float in both
    (the wrapped sum over the degree)."""
    row, col, v, x = _int_case(vdt, xdt)
    got = spmm_coo(torch.from_numpy(row), torch.from_numpy(col),
                   None if v is None else torch.from_numpy(v),
                   torch.from_numpy(x), 30, reduce)
    want = jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                          None if v is None else jnp.asarray(v),
                          jnp.asarray(x), 30, reduce)
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("vdt,xdt", [(torch.bool, torch.bool),
                                     (None, torch.bool)])
def test_bool_sum_refused_as_in_jax(vdt, xdt):
    row, col, v, x = _int_case(vdt, xdt)
    with pytest.raises(TypeError):
        jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                       None if v is None else jnp.asarray(v),
                       jnp.asarray(x), 30)
    with pytest.raises(TypeError, match="bool"):
        spmm_coo(torch.from_numpy(row), torch.from_numpy(col),
                 None if v is None else torch.from_numpy(v),
                 torch.from_numpy(x), 30)


def test_int32_sums_wrap_past_2_31_and_int64_past_2_24():
    """Rows of 2**30 (int32) and of 2**25 + 1 (int64, no value): the int32
    sums wrap mod 2**32 and the int64 sums are exact, as in JAX; an f32
    sum would round both."""
    row = np.repeat(np.arange(4), [3, 5, 0, 9]).astype(np.int32)
    col = (np.arange(row.size) % 6).astype(np.int32)
    for dt, val in ((np.int32, 2 ** 30), (np.int64, 2 ** 25 + 1)):
        x = np.full((6, 3), val, dt)
        x[::2] -= 1
        got = spmm_coo(torch.from_numpy(row), torch.from_numpy(col), None,
                       torch.from_numpy(x), 4).numpy()
        want = np.asarray(jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                                         None, jnp.asarray(x), 4))
        assert got.dtype == want.dtype == dt
        np.testing.assert_array_equal(got, want)
    assert (got[1] > 2 ** 24).all()


@pytest.mark.parametrize("vdt,xdt", [(torch.int32, torch.int32),
                                     (None, torch.int64),
                                     (torch.int64, torch.int32),
                                     (torch.uint8, torch.int8)],
                         ids=_int_ids([(torch.int32, torch.int32),
                                       (None, torch.int64),
                                       (torch.int64, torch.int32),
                                       (torch.uint8, torch.int8)]))
def test_int_cut_rows_exact_vs_jax(vdt, xdt):
    """A hub row cut into pieces (degree past ``row_split.CAP``, and the
    same graph cut at cap 8): the plain version that follows the piece
    table, its partials summed in int64 in piece order, equals JAX's sum
    exactly, as does K1's plain version."""
    from paddle_sparse_tpu_torch.ops.kernels.row_split import (
        CAP, spmm_spans_piecewise, split_rows)
    from paddle_sparse_tpu_torch.ops.kernels.spmm_cuda import (
        kernel_operands, spmm_csr_reference)
    rng = np.random.default_rng(3)
    m, n = 12, 40
    hub = np.full(CAP + 77, 5)
    row = np.sort(np.concatenate([hub, rng.integers(0, m, 300)])
                  ).astype(np.int32)
    col = rng.integers(0, n, row.size).astype(np.int32)
    v = None if vdt is None else _ints(rng, vdt, row.size)
    x = _ints(rng, xdt, (n, 7))
    want = np.asarray(jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                                     None if v is None else jnp.asarray(v),
                                     jnp.asarray(x), m))
    tv = None if v is None else torch.from_numpy(v)
    tx = torch.from_numpy(x)
    rowptr = torch.zeros(m + 1, dtype=torch.int32)
    rowptr[1:] = torch.bincount(torch.from_numpy(row), minlength=m).cumsum(0)
    kv, kx, out_dtype = kernel_operands(tv, tx)
    start, end = rowptr[None, :-1], rowptr[None, 1:]
    col_t = torch.from_numpy(col)
    for cap in (CAP, 8):
        split = split_rows(start, end, cap)
        assert split is not None and split.num_slots > 0
        got = spmm_spans_piecewise(start, end, col_t, kv, None, kx, split)
        assert got.dtype == kx.dtype if kv is None else \
            torch.promote_types(kv.dtype, kx.dtype)
        np.testing.assert_array_equal(got.to(out_dtype).numpy(), want)
    ref = spmm_csr_reference(rowptr, col_t, tv, tx)
    assert ref.numpy().dtype == want.dtype
    np.testing.assert_array_equal(ref.numpy(), want)


@pytest.mark.parametrize("src,value,out,ok", [
    (torch.int32, torch.int32, torch.int32, True),
    (torch.int32, None, torch.int32, True),
    (torch.int64, None, torch.int64, True),
    (torch.int32, torch.int64, torch.int64, True),
    (torch.int64, torch.int32, torch.int64, True),
    (torch.int32, torch.int64, torch.int32, False),
    (torch.int64, torch.int64, torch.int32, False),
    (torch.int16, torch.int32, torch.int32, False),
    (torch.int32, F32, F32, False), (F32, torch.int32, F32, False),
    (torch.int32, torch.int32, F32, False)])
def test_spmm_kernel_int_dtypes(src, value, out, ok):
    """K1 sums int32 and int64 src and value into their promoted int (in
    int64); it never mixes an int with a float and takes no narrower int."""
    if ok:
        check_spmm_dtypes("k1", src, value, out)
    else:
        with pytest.raises(TypeError):
            check_spmm_dtypes("k1", src, value, out)


@pytest.mark.parametrize("vdt,xdt,kv,kx,out", [
    (torch.int8, torch.int16, torch.int32, torch.int32, torch.int16),
    (torch.uint8, torch.uint8, torch.int32, torch.int32, torch.uint8),
    (torch.bool, torch.int64, torch.int32, torch.int64, torch.int64),
    (None, torch.int16, None, torch.int32, torch.int16),
    (torch.int64, torch.int32, torch.int64, torch.int32, torch.int64),
    (torch.int32, F16, torch.int32, F16, F16),
    (F32, torch.int64, F32, torch.int64, F32),
    (torch.int64, BF16, torch.int64, BF16, BF16)])
def test_kernel_operands(vdt, xdt, kv, kx, out):
    """What K1's wrapper hands the kernel: narrower ints and bool as int32,
    int32/int64 as they are; a mixed pair as it is (the entry casts it to
    the float, the kernel's check refuses it); ``out`` the promoted
    dtype."""
    from paddle_sparse_tpu_torch.ops.kernels.spmm_cuda import kernel_operands
    v = None if vdt is None else torch.zeros(4, dtype=vdt)
    x = torch.zeros(3, 2, dtype=xdt)
    v2, x2, o = kernel_operands(v, x)
    assert (None if v2 is None else v2.dtype, x2.dtype, o) == (kv, kx, out)
    assert (x2 is x) == (kx == xdt)
