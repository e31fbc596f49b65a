"""Port parity of second (and higher) derivatives on the CPU: the same numpy
inputs, made from a seed, through ``jax.grad(jax.grad(...))`` of the JAX
package (x64 on, as ``tests/conftest.py`` sets it) and ``create_graph``
autograd of the port, which runs its kernels' plain versions here.

* ``spmm_coo`` (sum, mean, min, max), ``backend="sell"``,
  ``PaddedCOO.spmm`` (with padding) and the facade's ``adj_t @ x``: the grad
  of the gradient penalty ``|d f / d value|^2 + |d f / d x|^2`` of ``f =
  sum(w * out ** 3)`` in f64, within ``1e-10`` of each entry or of the
  largest; ``gradgradcheck`` of ``_SpmmSum``, ``_SumGrads`` and ``_Sddmm``
  in f64, on a graph with padding, empty rows and columns; which kernels
  each pass of a double backward reaches;
* the five model families with an input-gradient penalty, ``loss = CE +
  lam * |d CE / d x|^2``: loss and every parameter's grad (weights carried
  by the ``*_params_from_jax`` functions), f32 within ``1e-4`` of the
  largest entry of each tensor (f32 sums in another order, through two
  backward passes);
* the SpGEMM variants (``spspmm_rowsorted``, ``_padded``, ``_rowblocked``):
  the Hessian-vector product in the values of ``sum(G * C.value ** 2)``
  against ``jax.jvp`` of ``jax.grad``, f64 within ``1e-10``;
* the mixed second derivative of ``<G, A(v) x>`` along ``(dv, dx)``, which
  is ``<G, A(dv) dx>``: one forward SpMM (the bilinear identity);
* the packed-layout SpMMs (seg2, seg3, split, ``spmm_seg``) refuse a double
  backward with ``NotImplementedError``, as the JAX package's Pallas
  backward does;
* ``parallel/`` at 2 gloo ranks (one spawn for the module): the row-sharded
  GCN step with the input-gradient penalty against JAX's ``shard_map`` step
  on the virtual CPU mesh (loss, summed grads, new params: within 1e-5 of
  each tensor's largest entry), and every collective's grad of grad against
  numpy (exact).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_parallel_ref as ref
import paddle_sparse_tpu as jsp
import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu.core import spgemm as jspgemm
from _torch_parallel_cases import run_cases
from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.models import APPNP as jAPPNP
from paddle_sparse_tpu.models import GAT as jGAT
from paddle_sparse_tpu.models import GCN as jGCN
from paddle_sparse_tpu.models import GIN as jGIN
from paddle_sparse_tpu.models import GraphSAGE as jSAGE
from paddle_sparse_tpu.models import gcn_normalize as j_normalize
from paddle_sparse_tpu.models import (init_appnp, init_gat, init_gcn,
                                      init_gin, init_sage)
from paddle_sparse_tpu.ops import spmm_seg as jseg
from paddle_sparse_tpu.ops import spmm_seg2 as jseg2
from paddle_sparse_tpu.ops import spmm_seg3 as jseg3
from paddle_sparse_tpu.ops import spmm_split as jsplit
from paddle_sparse_tpu_torch import (APPNP, GAT, GCN, GIN, GraphSAGE,
                                     PaddedCOO, SparseTensor,
                                     appnp_params_from_jax,
                                     gat_params_from_jax, gcn_normalize,
                                     gcn_params_from_jax, gin_params_from_jax,
                                     make_seg2_plan, make_seg3_plan,
                                     make_split_plan, pack_values,
                                     pack_values_split, padded_coo_from_jax,
                                     plan_spgemm, plan_spgemm_rows,
                                     sage_params_from_jax, spmm_coo,
                                     spmm_seg2, spmm_seg3, spmm_split,
                                     spspmm_padded, spspmm_rowblocked,
                                     spspmm_rowsorted)
from paddle_sparse_tpu_torch import matmul as tmatmul
from paddle_sparse_tpu_torch import parallel as tpar
from paddle_sparse_tpu_torch.entry import _toy_graph
from paddle_sparse_tpu_torch.ops import spmm_seg as tseg
from paddle_sparse_tpu_torch.ops import spmm as tspmm
from paddle_sparse_tpu_torch.ops.spmm import (_Csr, _Sddmm, _SpmmSum,
                                              _SumGrads, spmm_structure)
from paddle_sparse_tpu_torch.ops.spmm_seg2 import DOUBLE_BACKWARD_REFUSAL

F64_TOL = 1e-10       # f64 sums in another order, through two passes
F32_TOL = 1e-4        # f32, of each tensor's largest entry
M, N, K = 40, 30, 5
EMPTY_ROWS = (0, 17, 39)


def _graph(seed=0, nnz=240, m=M, n=N):
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(m), EMPTY_ROWS)
    row = np.sort(rng.choice(keep, nnz))
    col = rng.integers(0, n - 2, nnz)          # the last 2 columns empty
    order = np.lexsort((col, row))
    return (row[order].astype(np.int32), col[order].astype(np.int32),
            rng.standard_normal(nnz), rng.standard_normal((n, K)),
            rng.standard_normal((m, K)))


def _close(got, want, tol):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _port_penalty_grads(spmm, v, x, w):
    """``d h / d (v, x)`` of ``h = |d f/d v|^2 + |d f/d x|^2``, ``f =
    sum(w * spmm(v, x) ** 3)``, through ``create_graph``."""
    tv = torch.tensor(v, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    f = (torch.from_numpy(w) * spmm(tv, tx) ** 3).sum()
    gv, gx = torch.autograd.grad(f, (tv, tx), create_graph=True)
    ((gv ** 2).sum() + (gx ** 2).sum()).backward()
    return tv.grad, tx.grad


def _jax_penalty_grads(spmm, v, x, w):
    def f(vv, xx):
        return (jnp.asarray(w) * spmm(vv, xx) ** 3).sum()

    def h(vv, xx):
        gv, gx = jax.grad(f, argnums=(0, 1))(vv, xx)
        return (gv ** 2).sum() + (gx ** 2).sum()
    return jax.grad(h, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(x))


@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max"])
def test_spmm_coo_grad_of_grad(reduce):
    row, col, v, x, w = _graph()
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    got = _port_penalty_grads(
        lambda vv, xx: spmm_coo(tr, tc, vv, xx, M, reduce), v, x, w)
    want = _jax_penalty_grads(
        lambda vv, xx: jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                                      vv, xx, M, reduce), v, x, w)
    for a, b in zip(got, want):
        _close(a, b, F64_TOL)


def test_min_max_ties_grad_of_grad():
    """Small integer values tie within rows: JAX splits the gradient among
    the tied entries, and so does the port, at the second order too."""
    row, col, _, _, w = _graph(seed=4)
    rng = np.random.default_rng(5)
    v = rng.integers(-2, 3, row.size).astype(np.float64)
    x = rng.integers(-2, 3, (N, K)).astype(np.float64)
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    for reduce in ("min", "max"):
        got = _port_penalty_grads(
            lambda vv, xx: spmm_coo(tr, tc, vv, xx, M, reduce), v, x, w)
        want = _jax_penalty_grads(
            lambda vv, xx: jspmm.spmm_coo(jnp.asarray(row),
                                          jnp.asarray(col), vv, xx, M,
                                          reduce), v, x, w)
        for a, b in zip(got, want):
            _close(a, b, F64_TOL)


def test_sell_grad_of_grad():
    """``backend="sell"`` in f32, as JAX's sell sums (``F32_TOL``)."""
    row, col, v, x, w = _graph(seed=1)
    v, x, w = v.astype(np.float32), x.astype(np.float32), w.astype(np.float32)
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    got = _port_penalty_grads(
        lambda vv, xx: spmm_coo(tr, tc, vv, xx, M, backend="sell"), v, x, w)
    want = _jax_penalty_grads(
        lambda vv, xx: jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                                      vv, xx, M, backend="sell"), v, x, w)
    for a, b in zip(got, want):
        _close(a, b, F32_TOL)


def test_padded_coo_grad_of_grad():
    """``PaddedCOO.spmm`` with 9 padding entries: their value grads stay 0
    at the second order too."""
    row, col, v, x, w = _graph(seed=2)
    cap = row.size + 9
    vp = np.concatenate([v, np.zeros(9)])
    A = PaddedCOO.from_arrays(torch.from_numpy(row), torch.from_numpy(col),
                              None, (M, N), capacity=cap)
    got = _port_penalty_grads(lambda vv, xx: A.with_value(vv).spmm(xx), vp,
                              x, w)

    jA = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col), None,
                                (M, N), capacity=cap)

    def jf(vv, xx):
        return dataclasses.replace(jA, value=vv).spmm(xx)
    want = _jax_penalty_grads(jf, vp, x, w)
    for a, b in zip(got, want):
        _close(a, b, F64_TOL)
    assert not got[0][row.size:].any()


def test_facade_adj_t_matmul_grad_of_grad():
    row, col, v, x, w = _graph(seed=3)

    def tf(vv, xx):
        return tmatmul(SparseTensor(row=torch.from_numpy(row).long(),
                                    col=torch.from_numpy(col).long(),
                                    value=vv, sparse_sizes=(M, N)), xx)

    def jf(vv, xx):
        return jsp.matmul(jsp.SparseTensor(
            row=jnp.asarray(row), col=jnp.asarray(col), value=vv,
            sparse_sizes=(M, N)), xx)
    for a, b in zip(_port_penalty_grads(tf, v, x, w),
                    _jax_penalty_grads(jf, v, x, w)):
        _close(a, b, F64_TOL)


def _structure_fn(row, col):
    rowptr = torch.zeros(M + 1, dtype=torch.int64)
    rowptr[1:] = torch.bincount(row[row < M].long(), minlength=M).cumsum(0)
    s = spmm_structure(rowptr, row, col, N)
    return rowptr, (lambda: s)


def test_gradgradcheck_spmm_sum_and_sddmm():
    """f64 ``gradgradcheck`` of the two Functions, on a padded structure
    (entries with ``row = M`` past the pointer's end)."""
    row, col, v, x, w = _graph(seed=6, nnz=60)
    row = torch.from_numpy(np.concatenate([row, [M, M]]).astype(np.int32))
    col = torch.from_numpy(np.concatenate([col, [0, 3]]).astype(np.int32))
    rowptr, sfn = _structure_fn(row, col)
    tv = torch.tensor(np.concatenate([v, [0.5, -1.5]]), requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tg = torch.tensor(w, requires_grad=True)

    def spmm(vv, xx):
        return _SpmmSum.apply(vv, xx, rowptr, col, sfn, None)

    def sddmm(gg, xx):
        return _Sddmm.apply(gg, xx, rowptr, col, sfn, None, torch.float64)

    def both_grads(vv, gg, xx):
        return _SumGrads.apply(vv, gg, xx, _Csr(rowptr, col, sfn, None))

    assert torch.autograd.gradgradcheck(spmm, (tv, tx))
    assert torch.autograd.gradgradcheck(sddmm, (tg, tx))
    assert torch.autograd.gradgradcheck(both_grads, (tv, tg, tx))
    # the padding's d value is 0 at every order
    gv, = torch.autograd.grad(spmm(tv, tx).square().sum(), tv,
                              create_graph=True)
    assert not gv[-2:].any()
    dv, = torch.autograd.grad(gv.square().sum(), tv)
    assert not dv[-2:].any()


class _Spy:
    """Counts the calls of the three kernels' wrappers as ``ops/spmm.py``
    reaches them."""

    def __init__(self, monkeypatch):
        self.calls = {"fused": 0, "k2": 0, "k1": 0}
        for name, key in (("spmm_sddmm_csc_cuda", "fused"),
                          ("sddmm_csr_cuda", "k2"), ("spmm_csr_cuda", "k1")):
            monkeypatch.setattr(tspmm, name, self._wrap(getattr(tspmm, name),
                                                        key))

    def _wrap(self, fn, key):
        def call(*args, **kw):
            self.calls[key] += 1
            return fn(*args, **kw)
        return call

    def take(self):
        calls, self.calls = self.calls, dict.fromkeys(self.calls, 0)
        return calls


@pytest.mark.parametrize("wrt", ["both", "value", "x"])
def test_double_backward_dispatch(monkeypatch, wrt):
    """The first-order grads under ``create_graph`` reach the kernels they
    reach without it (the fused pass for both grads, K2 for ``d value``
    alone, K1 over the CSC view for ``d x`` alone). The backward of the
    penalty on them reaches, with both: K2 and K1 along the fused pass's
    ``d x``, K1 twice along its ``d value``, the fused pass for the
    forward; with ``value`` alone: K1 along K2's output (``d g``), K2 for
    the forward; with ``x`` alone: K1 over A's CSR along the transpose's
    output, K1 over the CSC view for the forward. The values match JAX's
    grad of grad."""
    row, col, v, x, w = _graph(seed=9)
    spy = _Spy(monkeypatch)
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    tv = torch.tensor(v, requires_grad=wrt != "x")
    tx = torch.tensor(x, requires_grad=wrt != "value")
    f = (torch.from_numpy(w) * spmm_coo(tr, tc, tv, tx, M) ** 3).sum()
    assert spy.take() == {"fused": 0, "k2": 0, "k1": 1}
    wrt_t = {"both": (tv, tx), "value": (tv,), "x": (tx,)}[wrt]
    grads = torch.autograd.grad(f, wrt_t, create_graph=True)
    assert spy.take() == {"both": {"fused": 1, "k2": 0, "k1": 0},
                          "value": {"fused": 0, "k2": 1, "k1": 0},
                          "x": {"fused": 0, "k2": 0, "k1": 1}}[wrt]
    sum(g.square().sum() for g in grads).backward()
    assert spy.take() == {"both": {"fused": 1, "k2": 1, "k1": 3},
                          "value": {"fused": 0, "k2": 1, "k1": 1},
                          "x": {"fused": 0, "k2": 0, "k1": 2}}[wrt]

    def jf(vv, xx):
        return (jnp.asarray(w) * jspmm.spmm_coo(
            jnp.asarray(row), jnp.asarray(col), vv, xx, M) ** 3).sum()

    argnums = {"both": (0, 1), "value": (0,), "x": (1,)}[wrt]

    def h(vv, xx):
        gs = jax.grad(jf, argnums=argnums)(vv, xx)
        return sum((g ** 2).sum() for g in gs)
    want = jax.grad(h, argnums=argnums)(jnp.asarray(v), jnp.asarray(x))
    for got, ref_ in zip(wrt_t, want):
        _close(got.grad, ref_, F64_TOL)


def test_third_order_matches_jax():
    """``d/dx`` of ``sum(d^2 f / dx^2 . u)`` (three backward passes) of ``f
    = sum(w * (A(v) x) ** 3)``, against JAX."""
    row, col, v, x, w = _graph(seed=7)
    u = np.random.default_rng(8).standard_normal(x.shape)
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    tv, tx = torch.tensor(v), torch.tensor(x, requires_grad=True)
    f = (torch.from_numpy(w) * spmm_coo(tr, tc, tv, tx, M) ** 3).sum()
    gx, = torch.autograd.grad(f, tx, create_graph=True)
    hu, = torch.autograd.grad((gx * torch.from_numpy(u)).sum(), tx,
                              create_graph=True)
    t3, = torch.autograd.grad(hu.square().sum(), tx)

    def jf(xx):
        return (jnp.asarray(w) * jspmm.spmm_coo(
            jnp.asarray(row), jnp.asarray(col), jnp.asarray(v), xx,
            M) ** 3).sum()

    def jhu(xx):
        return jax.grad(lambda y: (jax.grad(jf)(y) * jnp.asarray(u)).sum())(
            xx)
    want = jax.grad(lambda xx: (jhu(xx) ** 2).sum())(jnp.asarray(x))
    _close(t3, want, F64_TOL)


def test_bilinear_identity():
    """The mixed second derivative of ``<G, A(v) x>`` along ``(dv, dx)`` is
    ``<G, A(dv) dx>``: an HVP through both backward passes equals one
    forward SpMM."""
    row, col, v, x, w = _graph(seed=9)
    rng = np.random.default_rng(10)
    dv, dx = rng.standard_normal(v.shape), rng.standard_normal(x.shape)
    tr, tc = torch.from_numpy(row), torch.from_numpy(col)
    tv = torch.tensor(v, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    f = (torch.from_numpy(w) * spmm_coo(tr, tc, tv, tx, M)).sum()
    gv, = torch.autograd.grad(f, tv, create_graph=True)
    hx, = torch.autograd.grad((gv * torch.from_numpy(dv)).sum(), tx)
    mixed = float((hx * torch.from_numpy(dx)).sum())
    once = float((torch.from_numpy(w) * spmm_coo(
        tr, tc, torch.from_numpy(dv), torch.from_numpy(dx), M)).sum())
    assert abs(mixed - once) <= F64_TOL * abs(once)


# ---- the model families with an input-gradient penalty --------------------

LAM = 20.0


def _families():
    row, col, val, x, y = _toy_graph(num_nodes=64, avg_deg=6, feat=12,
                                     classes=5)
    key = jax.random.PRNGKey(2)
    return row, col, val, x, y, {
        "gcn": (init_gcn(key, 12, 16, 5), jGCN, GCN(12, 16, 5),
                gcn_params_from_jax, True),
        "sage": (init_sage(key, 12, 16, 5), jSAGE, GraphSAGE(12, 16, 5),
                 sage_params_from_jax, False),
        "gin": (init_gin(key, 12, 16, 5), jGIN, GIN(12, 16, 5),
                gin_params_from_jax, False),
        "appnp": (init_appnp(key, 12, 16, 5),
                  lambda p, a, xx: jAPPNP(p, a, xx, k=3),
                  APPNP(12, 16, 5, k=3), appnp_params_from_jax, True),
        "gat": (init_gat(key, 12, 8, 5, heads=2), jGAT,
                GAT(12, 8, 5, heads=2), gat_params_from_jax, False)}


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin", "appnp", "gat"])
def test_model_input_gradient_penalty(kind):
    """``CE + LAM * |d CE / d x|^2``: loss and every parameter's grad of
    the port against JAX's ``jax.grad`` of the same penalty."""
    row, col, val, x, y, fams = _families()
    params, jfn, model, conv, norm = fams[kind]
    n = x.shape[0]
    model.load_state_dict(conv(jax.tree_util.tree_map(np.asarray, params)))
    t = PaddedCOO.from_arrays(torch.from_numpy(row), torch.from_numpy(col),
                              torch.from_numpy(val), (n, n),
                              capacity=row.size + 5)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(val), (n, n),
                               capacity=row.size + 5)
    if norm:
        t, j = gcn_normalize(t), j_normalize(j)
    tx = torch.from_numpy(x).requires_grad_()
    ty = torch.from_numpy(y)
    logp = torch.log_softmax(model(t, tx), dim=-1)
    ce = -logp.gather(1, ty[:, None]).mean()
    gx, = torch.autograd.grad(ce, tx, create_graph=True)
    loss = ce + LAM * gx.square().sum()
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))

    def jce(p, xx):
        lp = jax.nn.log_softmax(jfn(p, j, xx))
        return -jnp.take_along_axis(lp, jnp.asarray(y)[:, None],
                                    axis=1).mean()

    def jloss(p):
        xx = jnp.asarray(x)
        return jce(p, xx) + LAM * (jax.grad(jce, argnums=1)(p, xx) ** 2
                                   ).sum()
    jl, jg = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = conv(jax.tree_util.tree_map(np.asarray, jg))
    assert float(LAM * gx.square().sum()) > 1e-3 * float(ce)
    for name, g in zip(names, grads):
        _close(g, want[name], F32_TOL)


# ---- SpGEMM values ----------------------------------------------------------

def _jax_operand(rng, m, k, nnz):
    row = np.sort(rng.integers(0, m, nnz))
    col = rng.integers(0, k, nnz)
    order = np.lexsort((col, row))
    return JPaddedCOO.from_arrays(
        jnp.asarray(row[order].astype(np.int32)),
        jnp.asarray(col[order].astype(np.int32)),
        jnp.asarray(rng.standard_normal(nnz)), (m, k),
        capacity=nnz + 4).coalesce()


@pytest.mark.parametrize("variant", ["rowsorted", "padded", "rowblocked"])
def test_spgemm_value_hvp(variant):
    """Hessian-vector product in ``(value A, value B)`` of ``sum(G *
    C.value ** 2)``: the port's double backward against ``jax.jvp`` of
    ``jax.grad`` (f64)."""
    rng = np.random.default_rng(11)
    jA, jB = _jax_operand(rng, 24, 20, 90), _jax_operand(rng, 20, 18, 80)
    A, B = padded_coo_from_jax(jA), padded_coo_from_jax(jB)
    F, oc = plan_spgemm_rows(A, B)
    fc, oc2 = plan_spgemm(A, B)
    fn, jfn, args = {
        "rowsorted": (spspmm_rowsorted, jspgemm.spspmm_rowsorted, (F, oc)),
        "padded": (spspmm_padded, jspgemm.spspmm_padded, (fc, oc2)),
        "rowblocked": (spspmm_rowblocked, jspgemm.spspmm_rowblocked,
                       (F, oc, 8, A.capacity, oc))}[variant]
    G = rng.standard_normal(max(oc, oc2))
    ua, ub = (rng.standard_normal(A.capacity),
              rng.standard_normal(B.capacity))

    def jloss(va, vb):
        v = jfn(dataclasses.replace(jA, value=va),
                dataclasses.replace(jB, value=vb), *args).matrix.value
        return (jnp.asarray(G[:v.shape[0]]) * v ** 2).sum()

    _, (ha, hb) = jax.jvp(jax.grad(jloss, argnums=(0, 1)),
                          (jA.value, jB.value),
                          (jnp.asarray(ua), jnp.asarray(ub)))
    va = A.value.clone().requires_grad_()
    vb = B.value.clone().requires_grad_()
    v = fn(A.with_value(va), B.with_value(vb), *args).matrix.value
    ga, gb = torch.autograd.grad(
        (torch.from_numpy(G[:v.shape[0]]) * v ** 2).sum(), (va, vb),
        create_graph=True)
    ta, tb = torch.autograd.grad(
        (ga * torch.from_numpy(ua)).sum() + (gb * torch.from_numpy(ub)).sum(),
        (va, vb))
    _close(ta, ha, F64_TOL)
    _close(tb, hb, F64_TOL)


# ---- the packed SpMMs refuse, as the JAX package's do -----------------------

def _packed(kind, row, col, val, n):
    """``(port fn(v, x), port packed values, JAX fn(v, x), JAX packed)``."""
    r32, c32 = row.astype(np.int32), col.astype(np.int32)
    tr, tc = torch.from_numpy(r32), torch.from_numpy(c32)
    if kind == "seg2":
        jp, js = jseg2.make_seg2_plan(r32, c32, n, n, feat_dim=8, sr=8,
                                      chunk_edges=256)
        tp, ts = make_seg2_plan(tr, tc, n, n, feat_dim=8, sr=8)
        return (lambda v, x: spmm_seg2(tp, ts, v, x),
                pack_values(ts, torch.from_numpy(val)),
                lambda v, x: jseg2.spmm_seg2(jp, js, v, x),
                jseg2.pack_values(js, jnp.asarray(val)))
    if kind == "seg3":
        jp, js = jseg3.make_seg3_plan(r32, c32, n, n, feat_dim=8, sr=8,
                                      band_rows=16)
        tp, ts = make_seg3_plan(tr, tc, n, n, feat_dim=8, sr=8, band_rows=16)
        return (lambda v, x: spmm_seg3(tp, ts, v, x),
                pack_values(ts, torch.from_numpy(val)),
                lambda v, x: jseg3.spmm_seg3(jp, js, v, x),
                jseg3.pack_values(js, jnp.asarray(val)))
    if kind == "split":
        jp, js = jsplit.make_split_plan(jnp.asarray(r32), jnp.asarray(c32), n,
                                        n, feat_dim=8, block=16, sr=8,
                                        chunk_edges=256)
        tp, ts = make_split_plan(tr, tc, n, n, feat_dim=8, block=16, sr=8)
        return (lambda v, x: spmm_split(tp, ts, v, x),
                pack_values_split(ts, torch.from_numpy(val)),
                lambda v, x: jsplit.spmm_split(jp, js, v, x),
                jsplit.pack_values_split(js, jnp.asarray(val)))
    kw = dict(feat_dim=8, target_bytes=4 * 1024, seg_rows=16)
    jp, js = jseg.make_seg_plan(jnp.asarray(r32), jnp.asarray(c32), n, n, **kw)
    tp, ts = tseg.make_seg_plan(tr, tc, n, n, **kw)
    return (lambda v, x: tseg.spmm_seg(tp, ts, v, x),
            tseg.pack_values(ts, torch.from_numpy(val)),
            lambda v, x: jseg.spmm_seg(jp, js, v, x),
            jseg.pack_values(js, jnp.asarray(val)))


@pytest.mark.parametrize("kind", ["seg2", "seg3", "split", "spmm_seg"])
def test_packed_double_backward_refused_as_in_jax(kind):
    rng = np.random.default_rng(12)
    n, nnz = 48, 300
    row = np.sort(rng.integers(0, n, nnz))
    col = rng.integers(0, n, nnz)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = rng.random(nnz).astype(np.float32)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    fn, pv, jfn, jpv = _packed(kind, row, col, val, n)

    def jf(xx):
        return (jfn(jpv, xx).astype(jnp.float32) ** 2).sum()
    with pytest.raises(NotImplementedError):
        jax.grad(lambda xx: jax.grad(jf)(xx).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    pv = tuple(p.requires_grad_() for p in pv) if isinstance(pv, tuple) \
        else pv.requires_grad_()
    leaves = (tx,) + (pv if isinstance(pv, tuple) else (pv,))
    grads = torch.autograd.grad((fn(pv, tx) ** 2).sum(), leaves,
                                create_graph=True)
    for g in grads:
        with pytest.raises(NotImplementedError, match="JAX package"):
            torch.autograd.grad(g.sum(), leaves, allow_unused=True)
    assert "differentiate at any order" in DOUBLE_BACKWARD_REFUSAL
    # first order without create_graph gives the same grads
    again = torch.autograd.grad((fn(pv, tx) ** 2).sum(), leaves)
    for a, b in zip(again, grads):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


# ---- parallel/ at 2 gloo ranks ----------------------------------------------

WORLD = 2
NODES = 64
PEN_LAM = 50.0


@pytest.fixture(scope="module")
def ranks():
    """The penalty step and the collectives' grad of grad, one spawn."""
    params = jax.tree_util.tree_map(np.asarray, init_gcn(
        jax.random.PRNGKey(0), 16, 32, 4))
    jobs = {"penalty": ("penalty_step", {
        "num_nodes": NODES, "lam": PEN_LAM,
        "params": gcn_params_from_jax(params)}),
        "collectives": ("collectives_grad_of_grad", {})}
    return params, tpar.spawn(run_cases, WORLD, jobs, device="cpu")


def test_sharded_penalty_step_vs_jax_shard_map(ranks):
    params, res = ranks
    want = ref.penalty_step(WORLD, NODES, PEN_LAM, params)
    for r in range(WORLD):
        got = res[r]["penalty"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert got["penalty"] > 1e-2 * got["loss"]
        conv = gcn_params_from_jax
        for part in ("grads", "params"):
            w = conv(want[part])
            for k, g in got[part].items():
                ref.close(g, w[k], f"{part} {k} rank {r}")


def test_collectives_grad_of_grad(ranks):
    """Each collective's second derivative at 2 ranks: ``d/dx`` of ``sum(
    (d <c, op(x)^2> / d x) * u)``, exact against numpy (small integers)."""
    _, res = ranks
    xs = [res[r]["collectives"]["x"] for r in range(WORLD)]
    cs = [res[r]["collectives"]["c"] for r in range(WORLD)]
    u = [res[r]["collectives"]["u"] for r in range(WORLD)]
    fwd = {
        "all_gather": lambda a: [np.concatenate(a)] * WORLD,
        "reduce_scatter": lambda a: np.split(sum(a), WORLD),
        "all_to_all": lambda a: [np.stack([a[s][j] for s in range(WORLD)])
                                 for j in range(WORLD)],
        "ring_shift": lambda a: [a[(j - 1) % WORLD] for j in range(WORLD)]}
    for name, op in fwd.items():
        x = [xi[name] for xi in xs]
        c = [ci[name] for ci in cs]
        uu = [ui[name] for ui in u]
        # h(x) = sum_r <c_r, op(x)_r ** 2>; grad_r = d h / d x_r; the test
        # function is sum_r <grad_r, u_r>, linear in op: its grad in x is
        # 2 op^T(c * op(u))
        y_u = op(uu)
        cy = [2 * c[j] * y_u[j] for j in range(WORLD)]
        want = _transpose(name, cy)
        for r in range(WORLD):
            np.testing.assert_array_equal(res[r]["collectives"]["ggx"][name],
                                          want[r], err_msg=name)


def _transpose(name, cot):
    if name == "all_gather":
        return np.split(sum(cot), WORLD)
    if name == "reduce_scatter":
        return [np.concatenate(cot)] * WORLD
    if name == "all_to_all":
        return [np.stack([cot[s][j] for s in range(WORLD)])
                for j in range(WORLD)]
    return [cot[(j + 1) % WORLD] for j in range(WORLD)]
