"""``spmm_split`` of paddle_sparse_tpu_torch against the JAX package's
(``ops/spmm_split.py``, Pallas in interpret mode) on the CPU: the partition
and both sides' plans array for array, packed values, forward and grads;
the one-sided refusal on either side; a skewed graph and bf16.

Tolerances as in ``test_torch_seg2.py``: ``rtol=atol=1e-4`` against JAX,
``rtol=atol=1e-5`` against an f64 numpy oracle, the bf16 stream within 2e-2
of each output's sum of |terms|."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import spmm_split as J
from paddle_sparse_tpu_torch import (make_split_plan, pack_values_split,
                                     spmm_split, unpack_values_split)

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLE = dict(rtol=1e-5, atol=1e-5)
SIDE_FIELDS = ("col_f", "rp_f", "perm_f", "sbase_f", "col_t", "rp_t",
               "sbase_t", "relay_ft")


def _clustered(M, deg, block, p_in, seed=0):
    """``tests/test_spmm_split.py::_clustered``."""
    rng = np.random.default_rng(seed)
    nnz = M * deg
    row = np.repeat(np.arange(M), deg)
    cu = row // block
    v_in = np.minimum(cu * block + rng.integers(0, block, nnz), M - 1)
    v_out = rng.integers(0, M, nnz)
    col = np.where(rng.random(nnz) < p_in, v_in, v_out)
    order = np.lexsort((col, row))
    return row[order].astype(np.int32), col[order].astype(np.int32)


def _plans(row, col, M, K, block, sr, stream="f32"):
    jp, js = J.make_split_plan(jnp.asarray(row), jnp.asarray(col), M, M,
                               feat_dim=K, block=block, sr=sr,
                               chunk_edges=256, stream=stream)
    tp, ts = make_split_plan(torch.as_tensor(row), torch.as_tensor(col), M,
                             M, feat_dim=K, block=block, sr=sr, stream=stream)
    assert tp.block == jp.block
    for f in ("idx_local", "idx_resid"):
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy())
    for side in ("local", "resid"):
        jps, tps = getattr(jp, side), getattr(tp, side)
        for f in ("S", "SR", "S_t", "SR_t", "stream"):
            assert getattr(tps, f) == getattr(jps, f), (side, f)
        for f in SIDE_FIELDS:
            a = np.asarray(getattr(getattr(js, side), f))
            b = getattr(getattr(ts, side), f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (side, f)
        # the port keeps no row_f: JAX's is the side's rows at perm_f
        rows = row[getattr(ts, f"idx_{side}").numpy()]
        row_f = rows[getattr(ts, side).perm_f.numpy()]
        assert np.array_equal(np.asarray(getattr(js, side).row_f),
                              row_f), (side, "row_f")
    return jp, js, tp, ts


def _runs(jp, js, tp, ts, val, x, jdt=jnp.float32, tdt=torch.float32):
    """Forward and grads of ``sum(out ** 2)`` (the JAX test's loss) on both
    sides; packed grads unpacked to COO order."""
    pv = tuple(t.requires_grad_() for t in pack_values_split(
        ts, torch.as_tensor(val)))
    xt = torch.as_tensor(x).to(tdt).requires_grad_()
    out = spmm_split(tp, ts, pv, xt)
    assert out.dtype == tdt
    out.float().square().sum().backward()
    jpv = J.pack_values_split(js, jnp.asarray(val))
    for a, b in zip(jpv, pv):
        assert np.array_equal(np.asarray(a), b.detach().numpy())
    xj = jnp.asarray(x, jdt)

    def loss(p, xx):
        return (J.spmm_split(jp, js, p, xx).astype(jnp.float32) ** 2).sum()

    j_out = np.asarray(J.spmm_split(jp, js, jpv, xj).astype(jnp.float32))
    j_dpv, j_dx = jax.grad(loss, argnums=(0, 1))(jpv, xj)
    return ((out.float().detach(),
             unpack_values_split(ts, tuple(t.grad for t in pv)),
             xt.grad.float()),
            (j_out, np.asarray(J.unpack_values_split(js, j_dpv)),
             np.asarray(j_dx.astype(jnp.float32))))


@pytest.mark.parametrize("M,deg,block,p_in,sr", [
    (256, 6, 32, 0.8, 32),      # the JAX test's graph
    (300, 9, 64, 0.5, 64),      # half local, a ragged last block
])
def test_split_matches_jax_and_dense(M, deg, block, p_in, sr):
    K = 64
    row, col = _clustered(M, deg, block, p_in, seed=M)
    rng = np.random.default_rng(1)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, K, block, sr)
    assert torch.equal(unpack_values_split(ts, pack_values_split(
        ts, torch.as_tensor(val))), torch.as_tensor(val))
    (out, dv, dx), (j_out, j_dv, j_dx) = _runs(jp, js, tp, ts, val, x)
    dense = np.zeros((M, M))
    np.add.at(dense, (row, col), val.astype(np.float64))
    want = dense @ x
    g = 2.0 * want
    np.testing.assert_allclose(out.numpy(), j_out, **JAX_TOL)
    np.testing.assert_allclose(out.numpy(), want, **ORACLE)
    # the loss's grads are 2 * out-scaled: compare at the outputs' scale
    scale = np.abs(g).max()
    np.testing.assert_allclose(dx.numpy(), j_dx, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(dx.numpy(), dense.T @ g, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(dv.numpy(), j_dv, rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(dv.numpy(), (g[row] * x[col]).sum(1),
                               rtol=1e-5, atol=1e-5 * scale)


def test_split_skewed_and_bf16():
    """A hub row inside its own block plus a clustered graph, bf16 stream
    and bf16 x, against JAX within 2e-2 of each output's sum of |terms|."""
    M, K, block = 256, 32, 32
    row, col = _clustered(M, 4, block, 0.7, seed=3)
    hub = np.full(1500, 40, np.int32)
    hub_col = np.random.default_rng(4).integers(0, M, 1500).astype(np.int32)
    row = np.concatenate([row, hub])
    col = np.concatenate([col, hub_col])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    rng = np.random.default_rng(5)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = np.array(jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
                 .astype(jnp.float32))
    jp, js, tp, ts = _plans(row, col, M, K, block, 32, stream="bf16")
    (out, dv, dx), (j_out, j_dv, j_dx) = _runs(
        jp, js, tp, ts, val, x, jdt=jnp.bfloat16, tdt=torch.bfloat16)
    dense = np.zeros((M, M))
    np.add.at(dense, (row, col), np.abs(val).astype(np.float64))
    s_out = dense @ np.abs(x)
    s_g = 2 * s_out                       # bounds |g| = |2 out|
    for got, jax_, scale in (
            (out, j_out, s_out), (dx, j_dx, dense.T @ s_g),
            (dv, j_dv, (s_g[row] * np.abs(x[col])).sum(1))):
        assert (np.abs(got.numpy() - jax_) <= 2e-2 * scale + 1e-3).all()


@pytest.mark.parametrize("side", ["local", "resid"])
def test_split_rejects_one_sided(side):
    if side == "local":         # every edge inside its block
        row = col = torch.tensor([0, 1, 2], dtype=torch.int32)
    else:                       # no edge inside its block
        row = torch.tensor([0, 1, 2], dtype=torch.int32)
        col = torch.tensor([2, 3, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match="BOTH sides"):
        make_split_plan(row, col, 4, 4, feat_dim=8, block=4 if side ==
                        "local" else 2)
