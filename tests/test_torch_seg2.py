"""``spmm_seg2`` of paddle_sparse_tpu_torch against the JAX package's
(``ops/spmm_seg2.py``, Pallas in interpret mode) on the CPU: plans and
structures array for array, packed values, the forward and the grads of the
packed values and of ``x``, over the cases of ``tests/test_spmm_seg2.py``
plus a skewed graph and the bf16 stream.

Tolerances: against JAX ``rtol=atol=1e-4``, because JAX's f32 path sums bf16
hi/lo halves (about 2**-16 relative per term); against an f64 numpy oracle
``rtol=atol=1e-5`` (f32 sums); the bf16 stream against JAX within 2e-2 of
the sum of |terms| of each output (JAX rounds every product to bf16, the
port multiplies in f32; a bf16 ``x`` also rounds the output)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops import spmm_seg2 as J
from paddle_sparse_tpu_torch import (make_seg2_plan, pack_values,
                                     spmm_seg2, unpack_values)

JAX_TOL = dict(rtol=1e-4, atol=1e-4)
ORACLE = dict(rtol=1e-5, atol=1e-5)
BF16_REL = 2e-2     # of the sum of |terms| of each output
STRUCT_FIELDS = ("col_f", "rp_f", "perm_f", "sbase_f", "col_t", "rp_t",
                 "sbase_t", "relay_ft")


def _graph(rng, M, N, nnz):
    row = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    col = rng.integers(0, N, nnz).astype(np.int32)
    return row, col


def _skewed(rng, M, N, hub_edges, rest):
    """One hub row of ``hub_edges`` edges among ``rest`` scattered ones."""
    row = np.sort(np.concatenate([np.full(hub_edges, M // 3),
                                  rng.integers(0, M, rest)])).astype(np.int32)
    return row, rng.integers(0, N, row.size).astype(np.int32)


def _plans(row, col, M, N, K, sr, stream="f32"):
    jp, js = J.make_seg2_plan(row, col, M, N, feat_dim=K, sr=sr,
                              chunk_edges=256, stream=stream)
    tp, ts = make_seg2_plan(torch.as_tensor(row), torch.as_tensor(col), M, N,
                            feat_dim=K, sr=sr, stream=stream)
    return jp, js, tp, ts


def _assert_same_structure(jp, js, tp, ts, row):
    for f in ("num_rows", "num_cols", "S", "SR", "S_t", "SR_t", "stream"):
        assert getattr(tp, f) == getattr(jp, f), f
    for f in STRUCT_FIELDS:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # the port keeps no row_f (no kernel reads it): JAX's is row[perm_f]
    row_f = np.asarray(row)[ts.perm_f.numpy()]
    assert np.array_equal(np.asarray(js.row_f), row_f), "row_f"


def _oracle(row, col, val, x, g):
    M, N = g.shape[0], x.shape[0]
    v = np.ones(row.size) if val is None else val.astype(np.float64)
    out = np.zeros((M, x.shape[1]))
    np.add.at(out, row, v[:, None] * x[col])
    dx = np.zeros((N, x.shape[1]))
    np.add.at(dx, col, v[:, None] * g[row])
    dv = (g[row].astype(np.float64) * x[col]).sum(1)
    return out, dx, dv


def _port_run(tp, ts, val, x, g):
    """Forward, then d packed and d x of ``sum(out * g)``."""
    pv = (None if val is None
          else pack_values(ts, torch.as_tensor(val)).requires_grad_())
    xt = torch.as_tensor(x).requires_grad_()
    out = spmm_seg2(tp, ts, pv, xt)
    (out * torch.as_tensor(g)).sum().backward()
    return out.detach(), (None if pv is None else pv.grad), xt.grad


def _jax_run(jp, js, val, x, g, xdt=jnp.float32):
    xj = jnp.asarray(x, xdt)

    def loss(pv, xx):
        return (J.spmm_seg2(jp, js, pv, xx).astype(jnp.float32)
                * jnp.asarray(g)).sum()

    if val is None:
        out = J.spmm_seg2(jp, js, None, xj)
        d_x = jax.grad(lambda xx: loss(None, xx))(xj)
        return np.asarray(out.astype(jnp.float32)), None, np.asarray(
            d_x.astype(jnp.float32))
    pv = J.pack_values(js, jnp.asarray(val))
    out = J.spmm_seg2(jp, js, pv, xj)
    d_pv, d_x = jax.grad(loss, argnums=(0, 1))(pv, xj)
    return (np.asarray(out.astype(jnp.float32)), np.asarray(d_pv),
            np.asarray(d_x.astype(jnp.float32)))


CASES = [
    (300, 200, 2500, 128, 64),     # many segments
    (130, 500, 1800, 128, 512),    # S=1 boundary-ish
    (257, 129, 900, 128, 32),      # non-pow2 dims, tiny segments
    (220, 180, 2100, 128, 64),     # the grads case
    (200, 300, 2000, 128, 128),    # the no-values case
]


@pytest.mark.parametrize("M,N,nnz,K,sr", CASES)
@pytest.mark.parametrize("with_value", [True, False])
def test_seg2_matches_jax(M, N, nnz, K, sr, with_value):
    rng = np.random.default_rng(M + nnz)
    row, col = _graph(rng, M, N, nnz)
    val = rng.standard_normal(nnz).astype(np.float32) if with_value else None
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, sr)
    _assert_same_structure(jp, js, tp, ts, row)
    out, d_pv, d_x = _port_run(tp, ts, val, x, g)
    j_out, j_dpv, j_dx = _jax_run(jp, js, val, x, g)
    np.testing.assert_allclose(out.numpy(), j_out, **JAX_TOL)
    np.testing.assert_allclose(d_x.numpy(), j_dx, **JAX_TOL)
    w_out, w_dx, w_dv = _oracle(row, col, val, x, g)
    np.testing.assert_allclose(out.numpy(), w_out, **ORACLE)
    np.testing.assert_allclose(d_x.numpy(), w_dx, **ORACLE)
    if with_value:
        np.testing.assert_allclose(d_pv.numpy(), j_dpv, **JAX_TOL)
        np.testing.assert_allclose(unpack_values(ts, d_pv).numpy(), w_dv,
                                   **ORACLE)


def test_packed_values_match_jax_and_round_trip():
    rng = np.random.default_rng(2)
    row, col = _graph(rng, 300, 200, 2500)
    val = rng.standard_normal(2500).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, 300, 200, 64, 64)
    packed = pack_values(ts, torch.as_tensor(val))
    assert np.array_equal(packed.numpy(),
                          np.asarray(J.pack_values(js, jnp.asarray(val))))
    assert torch.equal(unpack_values(ts, packed), torch.as_tensor(val))


def test_seg2_empty_rows_and_tail():
    """Rows with no edges and a lone last row stay exact."""
    rng = np.random.default_rng(3)
    M, N, K = 140, 90, 128
    row = np.array([0, 0, 5, 5, 5, 139], np.int32)
    col = np.array([1, 89, 0, 44, 44, 7], np.int32)
    val = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, 32)
    _assert_same_structure(jp, js, tp, ts, row)
    out, d_pv, d_x = _port_run(tp, ts, val, x, g)
    w_out, w_dx, w_dv = _oracle(row, col, val, x, g)
    np.testing.assert_allclose(out.numpy(), w_out, **ORACLE)
    np.testing.assert_allclose(d_x.numpy(), w_dx, **ORACLE)
    np.testing.assert_allclose(unpack_values(ts, d_pv).numpy(), w_dv,
                               **ORACLE)
    np.testing.assert_allclose(out.numpy(), _jax_run(jp, js, val, x, g)[0],
                               **JAX_TOL)


def test_seg2_skewed_graph_matches_jax():
    """A hub row holding most edges, spread over every segment. The hub
    row sums 3000 terms, so the error bounds scale with the sum of |terms|
    of each output: 2**-16 of it against JAX (its bf16 hi/lo halves), 1e-5
    against the oracle (f32 sums)."""
    rng = np.random.default_rng(4)
    M, N, K = 300, 260, 64
    row, col = _skewed(rng, M, N, 3000, 600)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, 64)
    _assert_same_structure(jp, js, tp, ts, row)
    out, d_pv, d_x = _port_run(tp, ts, val, x, g)
    w_out, w_dx, w_dv = _oracle(row, col, val, x, g)
    s_out, s_dx, s_dv = _oracle(row, col, np.abs(val), np.abs(x), np.abs(g))
    j_out, j_dpv, j_dx = _jax_run(jp, js, val, x, g)
    j_dv = unpack_values(ts, torch.from_numpy(j_dpv.copy())).numpy()
    for got, jax_, want, scale in (
            (out, j_out, w_out, s_out), (d_x, j_dx, w_dx, s_dx),
            (unpack_values(ts, d_pv), j_dv, w_dv, s_dv)):
        err_j = np.abs(got.numpy() - jax_)
        err_o = np.abs(got.numpy() - want)
        assert (err_j <= 1e-4 + 2.0 ** -16 * scale).all()
        assert (err_o <= 1e-5 + 1e-5 * scale).all()


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
def test_seg2_bf16_stream_matches_jax(xdt):
    """``stream="bf16"`` (f32 x gathered in bf16) and a bf16 x: the same
    product dtype as JAX; the output keeps x's dtype."""
    rng = np.random.default_rng(5)
    M, N, K = 220, 180, 64
    row, col = _graph(rng, M, N, 2100)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    g = rng.standard_normal((M, K)).astype(np.float32)
    jp, js, tp, ts = _plans(row, col, M, N, K, 64, stream="bf16")
    assert (tp.SR, tp.stream) == (jp.SR, "bf16")
    _assert_same_structure(jp, js, tp, ts, row)
    tdt, jdt = ((torch.float32, jnp.float32) if xdt == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    xb = np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    pv = pack_values(ts, torch.as_tensor(val)).requires_grad_()
    xt = torch.as_tensor(xb).to(tdt).requires_grad_()
    out = spmm_seg2(tp, ts, pv, xt)
    assert out.dtype == tdt
    (out.float() * torch.as_tensor(g)).sum().backward()
    j_out, j_dpv, j_dx = _jax_run(jp, js, val, xb, g, xdt=jdt)
    s_out, s_dx, s_dv = _oracle(row, col, np.abs(val), np.abs(xb),
                                np.abs(g))
    j_dv = unpack_values(ts, torch.from_numpy(j_dpv.copy())).numpy()
    for got, jax_, scale in (
            (out.float().detach(), j_out, s_out),
            (xt.grad.float(), j_dx, s_dx),
            (unpack_values(ts, pv.grad), j_dv, s_dv)):
        assert (np.abs(got.numpy() - jax_) <= BF16_REL * scale).all()


def test_seg2_default_segment_size_matches_jax():
    """No ``sr``: the same SR rule as JAX, for both streams."""
    rng = np.random.default_rng(6)
    row, col = _graph(rng, 3000, 5000, 4000)
    for stream in ("f32", "bf16"):
        jp, js = J.make_seg2_plan(row, col, 3000, 5000, feat_dim=256,
                                  stream=stream)
        tp, ts = make_seg2_plan(torch.as_tensor(row), torch.as_tensor(col),
                                3000, 5000, feat_dim=256, stream=stream)
        _assert_same_structure(jp, js, tp, ts, row)


def test_seg2_unsorted_rows_rejected():
    row = torch.tensor([3, 1, 2], dtype=torch.int32)
    col = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted ascending"):
        make_seg2_plan(row, col, 4, 4, feat_dim=64)


@pytest.mark.parametrize("bad", ["sr", "stream", "range", "shape"])
def test_seg2_plan_rejects(bad):
    row = torch.tensor([0, 1, 2], dtype=torch.int32)
    col = torch.tensor([0, 1, 2], dtype=torch.int32)
    kw = dict(feat_dim=8)
    if bad == "sr":
        kw["sr"] = 48
    elif bad == "stream":
        kw["stream"] = "f16"
    elif bad == "range":
        col = torch.tensor([0, 1, 4], dtype=torch.int32)
    else:
        col = col[:2]
    with pytest.raises(ValueError):
        make_seg2_plan(row, col, 4, 4, **kw)


def test_seg2_empty_matrix():
    row = torch.zeros(0, dtype=torch.int32)
    plan, s = make_seg2_plan(row, row, 8, 8, feat_dim=16, sr=8)
    x = torch.ones(8, 16, requires_grad=True)
    out = spmm_seg2(plan, s, None, x)
    assert out.shape == (8, 16) and not out.any()
    out.sum().backward()
    assert not x.grad.any()


def test_seg2_double_backward_raises_and_wrong_x():
    rng = np.random.default_rng(7)
    row, col = _graph(rng, 50, 40, 300)
    plan, s = make_seg2_plan(torch.as_tensor(row), torch.as_tensor(col), 50,
                             40, feat_dim=8, sr=8)
    pv = pack_values(s, torch.rand(300)).requires_grad_()
    x = torch.randn(40, 8, requires_grad=True)
    (gx,) = torch.autograd.grad(spmm_seg2(plan, s, pv, x).square().sum(), x,
                                create_graph=True)
    with pytest.raises(RuntimeError):
        gx.sum().backward()
    with pytest.raises(ValueError):
        spmm_seg2(plan, s, pv, torch.randn(41, 8))
    with pytest.raises(ValueError):
        spmm_seg2(plan, s, pv[:-1], x)
