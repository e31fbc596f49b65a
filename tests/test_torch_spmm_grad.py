"""Port parity: the SpMM gradients of paddle_sparse_tpu_torch on the CPU (the
plain versions of the CUDA kernels) against JAX, on the same numpy inputs.

The JAX side is ``jax.grad`` of ``spmm_coo(..., backend="xla")`` and of the
Pallas ``spmm_chunked`` (interpret mode) with a plan forced to several blocks
both ways, as ``tests/test_pallas_kernel.py`` runs it. The port's ``d x`` runs
K1's plain version over the CSC view, its ``d value`` the SDDMM's.

Tolerances: f32 ``rtol=atol=1e-4`` (sums in another order; the Pallas
kernel's hi/lo bf16 split is about f32-accurate), as in
``test_pallas_kernel.py``; ``gradcheck`` in f64 with its defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu_torch import PaddedCOO, spmm_coo, spmm_csr

F32 = dict(rtol=1e-4, atol=1e-4)
M, N, K = 300, 200, 16
EMPTY_ROWS = (0, 7, 150, 299)   # the last row too


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _graph(nnz=3000, seed=9):
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(M), EMPTY_ROWS)
    row = np.sort(rng.choice(keep, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((M, K)).astype(np.float32)
    return row, col, val, x, w


def _jax_grads(ref, row, col, val, x, w):
    """``(d value, d x)`` of ``sum(spmm(value, x) * w)`` in JAX; ``d value``
    is None when ``val`` is None."""
    r, c = jnp.asarray(row), jnp.asarray(col)
    if ref == "xla":
        def f(v, xx):
            return jspmm.spmm_coo(r, c, v, xx, M, backend="xla")
    else:
        plan, s = jspmm.make_spmm_plan(r, c, M, N, K,
                                       target_bytes=48 * 1024)
        assert plan.interpret and plan.nblocks > 1 and plan.nblocks_t > 1

        def f(v, xx):
            return jspmm.spmm_chunked(plan, s, v, xx)
    if val is None:
        dx = jax.grad(lambda xx: (f(None, xx) * w).sum())(jnp.asarray(x))
        return None, np.asarray(dx)
    dv, dx = jax.grad(lambda v, xx: (f(v, xx) * w).sum(), argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x))
    return np.asarray(dv), np.asarray(dx)


@pytest.mark.parametrize("ref", ["xla", "chunked"])
@pytest.mark.parametrize("wrt", ["value", "x", "both"])
def test_grads_vs_jax(ref, wrt):
    row, col, val, x, w = _graph()
    jdv, jdx = _jax_grads(ref, row, col, val, x, w)
    v = _t(val).requires_grad_(wrt in ("value", "both"))
    xt = _t(x).requires_grad_(wrt in ("x", "both"))
    out = spmm_coo(_t(row), _t(col), v, xt, M)
    (out * _t(w)).sum().backward()
    if wrt == "x":
        assert v.grad is None
    else:
        assert v.grad.dtype == torch.float32
        np.testing.assert_allclose(v.grad.numpy(), jdv, **F32)
    if wrt == "value":
        assert xt.grad is None
    else:
        assert xt.grad.dtype == torch.float32
        np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)


@pytest.mark.parametrize("ref", ["xla", "chunked"])
def test_grad_x_without_value(ref):
    row, col, _, x, w = _graph()
    _, jdx = _jax_grads(ref, row, col, None, x, w)
    xt = _t(x).requires_grad_()
    (spmm_coo(_t(row), _t(col), None, xt, M) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)


def test_spmm_coo_padding_rows_get_zero_grad():
    """Entries with row == num_rows are dropped: their d value is 0 and
    they add nothing to d x, whatever their col, as in JAX."""
    row, col, val, x, w = _graph(nnz=1000)
    pad = 60
    row_p = np.concatenate([row, np.full(pad, M, np.int32)])
    col_p = np.concatenate([col, np.arange(pad, dtype=np.int32) % N])
    val_p = np.concatenate([val, np.ones(pad, np.float32)])
    jdv, jdx = _jax_grads("xla", row_p, col_p, val_p, x, w)
    v, xt = _t(val_p).requires_grad_(), _t(x).requires_grad_()
    (spmm_coo(_t(row_p), _t(col_p), v, xt, M) * _t(w)).sum().backward()
    assert not v.grad[-pad:].any()
    np.testing.assert_allclose(v.grad.numpy(), jdv, **F32)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)


def test_padded_coo_poisoned_pads():
    """A PaddedCOO whose padding cols point far outside x: gradients as JAX's
    PaddedCOO gives them, zero at the padding."""
    row, col, val, x, w = _graph(nnz=1500)
    cap = row.size + 400
    t = PaddedCOO.from_arrays(row, col, val, (M, N), capacity=cap)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(val), (M, N), capacity=cap)
    jdv, jdx = jax.grad(
        lambda v, xx: (dataclasses.replace(j, value=v).spmm(xx) * w).sum(),
        argnums=(0, 1))(j.value, jnp.asarray(x))
    v = t.value.clone().requires_grad_()
    poisoned = dataclasses.replace(t, value=v, col=torch.where(
        t.valid_mask(), t.col, torch.full_like(t.col, 1 << 30)))
    xt = _t(x).requires_grad_()
    (poisoned.spmm(xt) * _t(w)).sum().backward()
    assert not v.grad[row.size:].any()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jdv), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **F32)


def test_trailing_dims():
    row, col, val, _, _ = _graph(nnz=800)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((N, 3, 5)).astype(np.float32)
    w = rng.standard_normal((M, 3, 5)).astype(np.float32)
    r, c = jnp.asarray(row), jnp.asarray(col)
    jdv, jdx = jax.grad(
        lambda v, xx: (jspmm.spmm_coo(r, c, v, xx, M, backend="xla")
                       * w).sum(), argnums=(0, 1))(jnp.asarray(val),
                                                   jnp.asarray(x))
    v, xt = _t(val).requires_grad_(), _t(x).requires_grad_()
    out = spmm_coo(_t(row), _t(col), v, xt, M)
    assert out.shape == (M, 3, 5)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jdv), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **F32)


def test_stride0_upstream_grad():
    """``out.sum()`` sends an expanded (stride-0) gradient into the
    backward."""
    row, col, val, x, _ = _graph()
    r, c = jnp.asarray(row), jnp.asarray(col)
    jdv, jdx = jax.grad(
        lambda v, xx: jspmm.spmm_coo(r, c, v, xx, M, backend="xla").sum(),
        argnums=(0, 1))(jnp.asarray(val), jnp.asarray(x))
    v, xt = _t(val).requires_grad_(), _t(x).requires_grad_()
    spmm_coo(_t(row), _t(col), v, xt, M).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jdv), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **F32)


@pytest.mark.parametrize("padded", [False, True])
def test_gradcheck_f64(padded):
    rng = np.random.default_rng(4)
    m, n, nnz = 12, 9, 40
    row = np.sort(rng.integers(0, m - 1, nnz)).astype(np.int32)
    col = rng.integers(0, n, nnz).astype(np.int32)
    v = torch.from_numpy(rng.standard_normal(nnz)).requires_grad_()
    x = torch.from_numpy(rng.standard_normal((n, 3))).requires_grad_()
    if padded:
        adj = PaddedCOO.from_arrays(row, col, None, (m, n), capacity=nnz + 7)
        v = torch.cat([v.detach(), torch.zeros(7, dtype=torch.float64)]
                      ).requires_grad_()

        def fn(vv, xx):
            return adj.with_value(vv).spmm(xx)
    else:
        def fn(vv, xx):
            return spmm_coo(_t(row), _t(col), vv, xx, m)
    assert torch.autograd.gradcheck(fn, (v, x))


def test_double_backward_raises():
    """What raised on a double backward of ``spmm_coo`` now runs: the grad
    of ``sum(d x)`` equals ``jax.grad`` of ``jax.grad`` (XLA path), f32
    within ``F32``. Only the packed SpMMs raise, as the JAX package's
    Pallas backward does (``tests/test_torch_double_backward.py``)."""
    row, col, val, x, _ = _graph(nnz=200)
    xt = _t(x).requires_grad_()
    out = spmm_coo(_t(row), _t(col), _t(val), xt, M)
    gx, = torch.autograd.grad((out ** 2).sum(), xt, create_graph=True)
    gx.sum().backward()
    r, c = jnp.asarray(row), jnp.asarray(col)

    def f(xx):
        return (jspmm.spmm_coo(r, c, jnp.asarray(val), xx, M,
                               backend="xla") ** 2).sum()
    want = jax.grad(lambda xx: jax.grad(f)(xx).sum())(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **F32)


def test_spmm_csr_backward_builds_csc_view_per_call():
    """spmm_csr without a PaddedCOO: the same grads as through a PaddedCOO,
    whose CSC view is cached."""
    row, col, val, x, w = _graph(nnz=900)
    adj = PaddedCOO.from_arrays(row, col, val, (M, N))
    grads = []
    for use_adj in (False, True):
        v, xt = adj.value.clone().requires_grad_(), _t(x).requires_grad_()
        out = (dataclasses.replace(adj, value=v).spmm(xt) if use_adj
               else spmm_csr(adj.rowptr(), adj.col, v, xt))
        (out * _t(w)).sum().backward()
        grads.append((v.grad, xt.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
