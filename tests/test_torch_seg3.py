"""``spmm_seg3`` of paddle_sparse_tpu_torch against the JAX package's
(``ops/spmm_seg3.py``, Pallas in interpret mode) on the CPU: plans and the
structure's index arrays, packed values, forward and grads over the cases of
``tests/test_spmm_seg3.py``, the skew refusal, and bf16.

Tolerances as in ``test_torch_seg2.py``: ``rtol=atol=1e-4`` against JAX (its
f32 path sums bf16 hi/lo halves), ``rtol=atol=1e-5`` against an f64 numpy
oracle, and the bf16 stream within 2e-2 of each output's sum of |terms|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import spmm_seg3 as J
from paddle_sparse_tpu_torch import (Seg3Infeasible, make_seg3_plan,
                                     pack_values, spmm_seg3, unpack_values)

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLE = dict(rtol=1e-5, atol=1e-5)
PLAN_FIELDS = ("num_rows", "num_cols", "S", "SR", "BAND", "cap", "CAP_TS",
               "S_t", "SR_t", "BAND_t", "cap_t", "CAP_TS_t", "stream")
STRUCT_FIELDS = ("col_f", "rp_f", "perm_f", "sbase_f", "col_t", "rp_t",
                 "sbase_t", "relay_ft")


def _graph(rng, M, N, nnz):
    row = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    return row, rng.integers(0, N, nnz).astype(np.int32)


def _oracle(row, col, val, x, g):
    out = np.zeros((g.shape[0], x.shape[1]))
    np.add.at(out, row, val[:, None].astype(np.float64) * x[col])
    dx = np.zeros(x.shape)
    np.add.at(dx, col, val[:, None].astype(np.float64) * g[row])
    return out, dx, (g[row].astype(np.float64) * x[col]).sum(1)


def _plans(row, col, M, N, K, sr, band, stream="f32"):
    jp, js = J.make_seg3_plan(row, col, M, N, feat_dim=K, sr=sr,
                              band_rows=band, stream=stream)
    tp, ts = make_seg3_plan(torch.as_tensor(row), torch.as_tensor(col), M, N,
                            feat_dim=K, sr=sr, band_rows=band, stream=stream)
    for f in PLAN_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f
    for f in STRUCT_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    return jp, js, tp, ts


def _runs(jp, js, tp, ts, val, x, g, jdt=jnp.float32, tdt=torch.float32):
    pv = pack_values(ts, torch.as_tensor(val)).requires_grad_()
    xt = torch.as_tensor(x).to(tdt).requires_grad_()
    out = spmm_seg3(tp, ts, pv, xt)
    assert out.dtype == tdt
    (out.float() * torch.as_tensor(g)).sum().backward()

    def loss(p, xx):
        return (J.spmm_seg3(jp, js, p, xx).astype(jnp.float32)
                * jnp.asarray(g)).sum()

    jpv = J.pack_values(js, jnp.asarray(val))
    assert np.array_equal(np.asarray(jpv), pv.detach().numpy())
    xj = jnp.asarray(x, jdt)
    j_out = np.asarray(J.spmm_seg3(jp, js, jpv, xj).astype(jnp.float32))
    j_dpv, j_dx = jax.grad(loss, argnums=(0, 1))(jpv, xj)
    return ((out.float().detach(), pv.grad, xt.grad.float()),
            (j_out, np.array(j_dpv), np.array(j_dx.astype(jnp.float32))))


@pytest.mark.parametrize("M,N,nnz,K,sr,band", [
    (300, 200, 2500, 128, 64, 128),    # several segments + bands
    (130, 500, 1800, 128, 512, 256),   # S=1-ish
    (220, 180, 2100, 128, 64, 128),    # the grads case
])
def test_seg3_matches_jax(M, N, nnz, K, sr, band):
    rng = np.random.default_rng(M + nnz)
    row, col = _graph(rng, M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, sr, band)
    (out, d_pv, d_x), (j_out, j_dpv, j_dx) = _runs(jp, js, tp, ts, val, x, g)
    np.testing.assert_allclose(out.numpy(), j_out, **JAX_TOL)
    np.testing.assert_allclose(d_pv.numpy(), j_dpv, **JAX_TOL)
    np.testing.assert_allclose(d_x.numpy(), j_dx, **JAX_TOL)
    w_out, w_dx, w_dv = _oracle(row, col, val, x, g)
    np.testing.assert_allclose(out.numpy(), w_out, **ORACLE)
    np.testing.assert_allclose(d_x.numpy(), w_dx, **ORACLE)
    np.testing.assert_allclose(unpack_values(ts, d_pv).numpy(), w_dv,
                               **ORACLE)
    assert torch.equal(unpack_values(ts, pack_values(ts, torch.as_tensor(
        val))), torch.as_tensor(val))


def test_seg3_bf16_matches_jax():
    rng = np.random.default_rng(11)
    M, N, K = 220, 180, 64
    row, col = _graph(rng, M, N, 2100)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = np.array(jnp.asarray(rng.standard_normal((N, K)), jnp.bfloat16)
                 .astype(jnp.float32))
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, 64, 128, stream="bf16")
    (out, d_pv, d_x), (j_out, j_dpv, j_dx) = _runs(
        jp, js, tp, ts, val, x, g, jdt=jnp.bfloat16, tdt=torch.bfloat16)
    abs_v, abs_x, abs_g = np.abs(val), np.abs(x), np.abs(g)
    s_out, s_dx, s_dv = _oracle(row, col, abs_v, abs_x, abs_g)
    perm = ts.perm_f.long().numpy()
    for got, jax_, scale in ((out, j_out, s_out), (d_x, j_dx, s_dx),
                             (d_pv, j_dpv, s_dv[perm])):
        assert (np.abs(got.numpy() - jax_) <= 2e-2 * scale).all()


def test_seg3_skew_infeasible():
    """A hot tile trips the staging-budget rule, as in JAX, so callers fall
    back to seg2; a bigger budget plans it."""
    rng = np.random.default_rng(5)
    M = 1024
    row = np.concatenate([np.zeros(200_000, np.int32),
                          np.arange(M, dtype=np.int32)])
    col = np.concatenate([rng.integers(0, M, 200_000).astype(np.int32),
                          rng.integers(0, M, M).astype(np.int32)])
    order = np.argsort(row, kind="stable")
    row, col = torch.as_tensor(row[order]), torch.as_tensor(col[order])
    kw = dict(feat_dim=256, sr=128, band_rows=128)
    with pytest.raises(Seg3Infeasible, match="use seg2"):
        make_seg3_plan(row, col, M, M, staging_budget=4 << 20, **kw)
    assert issubclass(Seg3Infeasible, ValueError)
    plan, _ = make_seg3_plan(row, col, M, M, staging_budget=1 << 40, **kw)
    assert plan.CAP_TS >= 200_000 // (M // 128)


def test_seg3_unsorted_rows_rejected():
    row = torch.tensor([3, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted ascending"):
        make_seg3_plan(row, row, 4, 4, feat_dim=8)
