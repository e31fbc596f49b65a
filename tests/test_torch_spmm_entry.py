"""Port parity: the SpMM entry points that hold a plan, ``spmm_chunked``,
``spmm_seg`` and ``spmm_sell``, and ``backend="sell"`` of ``spmm_coo``,
``spmm_csr`` and ``PaddedCOO.spmm``, against the JAX functions on the same
numpy inputs (the JAX Pallas paths in interpret mode on the CPU, as its own
tests run them).

* forward, ``d value`` and ``d x`` (``jax.grad`` of a weighted sum): within
  1e-5 of the largest sum of |terms| of each result (f32 sums of up to 3000
  terms taken in another order); elsewhere ``rtol=1e-5, atol=1e-4``;
* the seg and sell plans and structures array for array, and the pack /
  unpack and pad / unpad round trips: exact;
* ``backend="sell"`` equals ``"auto"`` bit for bit through all three calls,
  and JAX's sell within the f32 tolerance;
* the sell plan cache is reused per index structure, dropped with it and
  planned again after an in-place write to it;
* ``_pick_group`` against JAX's, and ``group="auto"`` on a CPU tensor is 8.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu.core.matrix import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.ops import spmm as jspmm
from paddle_sparse_tpu.ops import spmm_seg as jseg
from paddle_sparse_tpu.ops import spmm_sell as jsell
from paddle_sparse_tpu_torch.ops import spmm as tspmm
from paddle_sparse_tpu_torch.ops import spmm_seg as tseg
from paddle_sparse_tpu_torch.ops import spmm_sell as tsell

F32 = dict(rtol=1e-5, atol=1e-4)


def _graph(M, N, nnz, seed=0, hub=0):
    """Row-sorted COO with empty rows, duplicates and, with ``hub``, one row
    of ``hub`` extra edges (longer than the split cap when large)."""
    rng = np.random.default_rng(seed)
    row = rng.integers(0, M, nnz)
    row[row % 7 == 3] = 0                  # rows 3, 10, ... stay empty
    col = rng.integers(0, N, nnz)
    if hub:
        row = np.concatenate([row, np.full(hub, M // 2)])
        col = np.concatenate([col, rng.integers(0, N, hub)])
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.standard_normal(len(row)).astype(np.float32)
    x = rng.standard_normal((N, 16)).astype(np.float32)
    w = rng.standard_normal((M, 16)).astype(np.float32)
    return row, col, val, x, w


def _jax_grads(fn, val, x, w):
    def loss(v, xx):
        return (fn(v, xx) * w).sum()
    out = fn(jnp.asarray(val), jnp.asarray(x))
    dv, dx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(val), jnp.asarray(x))
    return [np.asarray(a) for a in (out, dv, dx)]


def _torch_grads(fn, val, x, w):
    v = torch.from_numpy(val).requires_grad_()
    xx = torch.from_numpy(x).requires_grad_()
    out = fn(v, xx)
    (out * torch.from_numpy(w)).sum().backward()
    return [a.detach().numpy() for a in (out, v.grad, xx.grad)]


def _scales(row, col, val, x, w, M, N):
    """The largest sum of |terms| of the output, ``d value`` and ``d x``:
    each result is held within ``REL`` of it (f32 sums of many terms in
    another order, a hub row's 3000 among them)."""
    A = np.zeros((M, N))
    np.add.at(A, (row, col), np.abs(val))
    ax, aw = np.abs(x), np.abs(w)
    return [(A @ ax).max(), (aw[row] * ax[col]).sum(1).max(),
            (A.T @ aw).max()]


REL = 1e-5


def _close(got, want, scales=None):
    for g, j, sc in zip(got, want, scales or [None] * 3):
        if sc is None:
            np.testing.assert_allclose(g, j, **F32)
        else:
            np.testing.assert_allclose(g, j, rtol=0, atol=REL * sc)


GRAPHS = pytest.mark.parametrize("M,N,nnz,hub", [
    (300, 200, 2000, 0), (120, 260, 1500, 3000)], ids=["uniform", "hub"])


@GRAPHS
def test_spmm_chunked_equal(M, N, nnz, hub):
    row, col, val, x, w = _graph(M, N, nnz, hub=hub)
    jplan, js = jspmm.make_spmm_plan(jnp.asarray(row), jnp.asarray(col), M,
                                     N, 16, target_bytes=32 * 1024)
    want = _jax_grads(lambda v, xx: jspmm.spmm_chunked(jplan, js, v, xx),
                      val, x, w)
    plan, s = tsp.make_spmm_plan(torch.from_numpy(row), torch.from_numpy(col),
                                 M, N, 16)
    assert plan == tsp.SpmmPlan(M, N)
    assert (s.csr.row_split is not None) == (hub > tsp.CAP)
    got = _torch_grads(lambda v, xx: tsp.spmm_chunked(plan, s, v, xx),
                       val, x, w)
    _close(got, want, _scales(row, col, val, x, w, M, N))


@pytest.mark.parametrize("M,N,nnz,hub", [
    (300, 200, 3000, 0), (300, 260, 2000, 3000)], ids=["uniform", "hub"])
def test_spmm_seg_equal(M, N, nnz, hub):
    row, col, val, x, w = _graph(M, N, nnz, seed=1, hub=hub)
    kw = dict(feat_dim=16, target_bytes=16 * 1024, seg_rows=64)
    jplan, js = jseg.make_seg_plan(jnp.asarray(row), jnp.asarray(col), M, N,
                                   **kw)
    plan, s = tseg.make_seg_plan(torch.from_numpy(row),
                                 torch.from_numpy(col), M, N, **kw)
    assert tuple(plan) == tuple(jplan)[:len(plan) - 1] + (jplan.seg_rows,)
    assert plan.num_segments > 1 and plan.rows_per_block < M
    for name in jseg.SegStructure._fields:
        np.testing.assert_array_equal(getattr(s, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    packed = tseg.pack_values(s, torch.from_numpy(val))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jseg.pack_values(js, jnp.asarray(val))))
    np.testing.assert_array_equal(tseg.unpack_values(s, packed).numpy(), val)
    pv = packed.numpy()
    want = _jax_grads(lambda v, xx: jseg.spmm_seg(jplan, js, v, xx), pv, x,
                      w)
    got = _torch_grads(lambda v, xx: tseg.spmm_seg(plan, s, v, xx), pv, x, w)
    _close(got, want, _scales(row, col, val, x, w, M, N))


def test_spmm_seg_no_value_and_checks():
    row, col, _, x, _ = _graph(200, 150, 1200, seed=2)
    plan, s = tseg.make_seg_plan(torch.from_numpy(row), torch.from_numpy(col),
                                 200, 150, feat_dim=16, seg_rows=64)
    jplan, js = jseg.make_seg_plan(jnp.asarray(row), jnp.asarray(col), 200,
                                   150, feat_dim=16, seg_rows=64)
    np.testing.assert_allclose(
        tseg.spmm_seg(plan, s, None, torch.from_numpy(x)).numpy(),
        np.asarray(jseg.spmm_seg(jplan, js, None, jnp.asarray(x))), **F32)
    with pytest.raises(ValueError, match="sorted"):
        tseg.make_seg_plan(torch.from_numpy(row[::-1].copy()),
                           torch.from_numpy(col), 200, 150)
    with pytest.raises(ValueError, match="x must be"):
        tseg.spmm_seg(plan, s, None, torch.ones(3, 4))


@GRAPHS
@pytest.mark.parametrize("G", [4, 32])
def test_sell_plan_equal(M, N, nnz, hub, G):
    row, col, val, _, _ = _graph(M, N, nnz, seed=3, hub=hub)
    jplan, js = jsell.make_sell_plan(row, col, M, N, group=G, feat_dim=16)
    plan, s = tsell.make_sell_plan(torch.from_numpy(row),
                                   torch.from_numpy(col), M, N, group=G)
    assert plan == tsell.SellPlan(M, N, G) and jplan.group == G
    arrays = tsell.jax_arrays(plan, s)
    assert set(arrays) == set(jsell.SellStructure._fields)
    for name in jsell.SellStructure._fields:
        np.testing.assert_array_equal(arrays[name].numpy(),
                                      np.asarray(getattr(js, name)), name)
    assert s.eid is arrays["eid"]
    grid = tsell.pad_values(s, torch.from_numpy(val), group=G)
    jgrid = jsell.pad_values(js, jnp.asarray(val), group=G)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(
        tsell.unpad_values(s, grid, group=G).numpy(),
        np.asarray(jsell.unpad_values(js, jgrid, group=G)))
    np.testing.assert_array_equal(tsell.unpad_values(s, grid, group=G)
                                  .numpy(), val)


@GRAPHS
@pytest.mark.parametrize("layout", ["grid", "coo", "none"])
def test_spmm_sell_equal(M, N, nnz, hub, layout):
    row, col, val, x, w = _graph(M, N, nnz, seed=4, hub=hub)
    G = 8
    jplan, js = jsell.make_sell_plan(row, col, M, N, group=G, feat_dim=16)
    plan, s = tsell.make_sell_plan(torch.from_numpy(row),
                                   torch.from_numpy(col), M, N, group=G)
    if layout == "none":
        out = tsell.spmm_sell(plan, s, None, torch.from_numpy(x))
        want = jsell.spmm_sell(jplan, js, None, jnp.asarray(x))
        ones = np.ones_like(val)
        _close([out.numpy()], [np.asarray(want)],
               _scales(row, col, ones, x, w, M, N)[:1])
        return
    scales = _scales(row, col, val, x, w, M, N)
    if layout == "grid":
        val = np.asarray(jsell.pad_values(js, jnp.asarray(val), group=G))
    want = _jax_grads(lambda v, xx: jsell.spmm_sell(jplan, js, v, xx), val,
                      x, w)
    got = _torch_grads(lambda v, xx: tsell.spmm_sell(plan, s, v, xx), val,
                       x, w)
    _close(got, want, scales)
    if layout == "grid":      # d value in the grid, 0 at the pads
        assert (got[1].T.reshape(-1)[s.eid.numpy() < 0] == 0).all()


def _sell_calls(row, col, rowptr, val, x, M, N, backend):
    adj = tsp.PaddedCOO.from_arrays(row, col, val, (M, N),
                                    capacity=len(row) + 37)
    v = adj.value.detach().clone().requires_grad_()
    adj = adj.with_value(v)
    outs = []
    for call in (lambda vv, xx: tsp.spmm_csr(rowptr, adj.col[:len(row)],
                                             vv[:len(row)], xx,
                                             backend=backend),
                 lambda vv, xx: tsp.spmm_coo(adj.row, adj.col, vv, xx, M,
                                             backend=backend),
                 lambda vv, xx: adj.with_value(vv).spmm(xx,
                                                        backend=backend)):
        xx = torch.from_numpy(x).requires_grad_()
        vv = v.detach().clone().requires_grad_()
        out = call(vv, xx)
        (out * torch.linspace(-1, 1, out.numel()).view(out.shape)).sum() \
            .backward()
        outs.append([out.detach(), vv.grad, xx.grad])
    return outs


def test_backend_sell_through_the_three_calls():
    """``backend="sell"`` through ``spmm_csr``, ``spmm_coo`` and
    ``PaddedCOO.spmm`` (padded, so padding rows are in the plan) equals
    ``"auto"`` bit for bit, forward and both grads, and JAX's
    ``spmm_coo(backend="sell")`` within the f32 tolerance."""
    M, N = 300, 200
    row, col, val, x, _ = _graph(M, N, 2000, seed=5)
    rowptr = tsp.ind2ptr(torch.from_numpy(row), M)
    sell = _sell_calls(row, col, rowptr, val, x, M, N, "sell")
    auto = _sell_calls(row, col, rowptr, val, x, M, N, "auto")
    for s_call, a_call in zip(sell, auto):
        for a, b in zip(s_call, a_call):
            assert torch.equal(a, b)
    want = jspmm.spmm_coo(jnp.asarray(row), jnp.asarray(col),
                          jnp.asarray(val), jnp.asarray(x), M,
                          backend="sell")
    for call in sell:
        np.testing.assert_allclose(call[0].numpy(), np.asarray(want), **F32)
    padded = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                                    jnp.asarray(val), (M, N),
                                    capacity=len(row) + 37)
    np.testing.assert_allclose(
        sell[2][0].numpy(),
        np.asarray(padded.spmm(jnp.asarray(x), backend="sell")), **F32)
    with pytest.raises(ValueError, match="reduce='sum'"):
        tsp.spmm_coo(torch.from_numpy(row), torch.from_numpy(col),
                     torch.from_numpy(val), torch.from_numpy(x), M,
                     reduce="max", backend="sell")


@pytest.mark.parametrize("call", ["coo", "csr", "padded"])
def test_backend_sell_replans_after_an_in_place_write(call):
    """The sell plan is cached per index tensor: a second call reuses it,
    and a write into ``col`` (or ``row``) in place replans, so the result
    follows the new structure (held against ``spmm_coo``'s one path on the
    indices as they are now)."""
    M, N = 300, 200
    row, col, val, x, _ = _graph(M, N, 2000, seed=6)
    r, c = torch.from_numpy(row.copy()), torch.from_numpy(col.copy())
    v, xx = torch.from_numpy(val), torch.from_numpy(x)
    rowptr = tsp.ind2ptr(r, M)
    adj = tsp.PaddedCOO.from_arrays(r.clone(), c.clone(), v, (M, N),
                                    capacity=len(row) + 5)
    rows, cols = (adj.row, adj.col) if call == "padded" else (r, c)

    def sell():
        if call == "coo":
            return tsp.spmm_coo(r, c, v, xx, M, backend="sell")
        if call == "csr":
            return tsp.spmm_csr(rowptr, c, v, xx, backend="sell")
        return adj.spmm(xx, backend="sell")

    def plain():
        return tsp.spmm_coo(rows, cols, adj.value if call == "padded" else v,
                            xx, M)

    tspmm._SELL_CACHE.clear()
    first = sell()
    assert torch.equal(first, plain()) and len(tspmm._SELL_CACHE) == 1
    structure = next(iter(tspmm._SELL_CACHE.values()))[4]
    sell()
    assert next(iter(tspmm._SELL_CACHE.values()))[4] is structure
    real = slice(0, len(row))
    cols[real] = (cols[real] + 7) % N          # same tensor, new structure
    after = sell()
    assert next(iter(tspmm._SELL_CACHE.values()))[4] is not structure
    assert torch.equal(after, plain()) and not torch.equal(after, first)
    if call != "csr":                          # the rows as well
        rows[len(row) - 50:len(row)] = M - 1   # still sorted
        assert torch.equal(sell(), plain())


@pytest.mark.parametrize("key", ["same", "new_col", "shape"])
def test_plan_caches_are_reused(key):
    row, col, _, _, _ = _graph(100, 80, 500, seed=7)
    r, c = torch.from_numpy(row), torch.from_numpy(col)
    tspmm._SELL_CACHE.clear()
    p1, s1 = tspmm._cached_sell_plan(r, c, 100, 80, 16)
    if key == "same":                          # feat_dim is not part of it
        p2, s2 = tspmm._cached_sell_plan(r, c, 100, 80, 32)
        assert p1 is p2 and s1 is s2 and len(tspmm._SELL_CACHE) == 1
    elif key == "new_col":
        c2 = c.clone()
        _, s3 = tspmm._cached_sell_plan(r, c2, 100, 80, 16)
        assert s3 is not s1 and len(tspmm._SELL_CACHE) == 2
        del c2, s3
        gc.collect()
        assert len(tspmm._SELL_CACHE) == 1     # dropped with its col
    else:
        _, s4 = tspmm._cached_sell_plan(r, c, 100, 81, 16)
        assert s4 is not s1


@pytest.mark.parametrize("kind", ["uniform", "regular", "skewed", "tiny"])
def test_pick_group_equal(kind):
    rng = np.random.default_rng(8)
    M = 400
    if kind == "uniform":
        deg = rng.integers(0, 60, M)
    elif kind == "regular":
        deg = np.full(M, 50)
    elif kind == "skewed":
        deg = np.minimum(rng.zipf(1.6, M), 3000)
    else:
        deg = np.ones(M, int)
    row = np.repeat(np.arange(M), deg).astype(np.int32)
    got = tsell._pick_group(torch.from_numpy(row), M, len(row))
    assert got == jsell._pick_group(jnp.asarray(row), M, len(row))
    plan, _ = tsell.make_sell_plan(torch.from_numpy(row),
                                   torch.from_numpy(row % M), M, M)
    assert plan.group == 8                     # group="auto" on the CPU


def test_sell_padding_below_n_is_left_out():
    """Padding entries (``row >= num_rows``) whose column is below N: the
    port's sell plan leaves them out of the transpose, so ``d x`` equals the
    one path's. The JAX package's sell turns them into real slots of A^T
    reading the grid's slot 0 (a reference fault the port does not copy):
    its ``d x`` differs from its own XLA path there."""
    M, N = 6, 5
    row = np.array([0, 0, 1, 3, 5, 6, 6], np.int32)
    col = np.array([1, 2, 0, 4, 3, 2, 0], np.int32)
    val = np.array([1., 2, 3, 4, 5, 7, 9], np.float32)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 3)).astype(np.float32)
    g = rng.standard_normal((M, 3)).astype(np.float32)

    def t_grad(backend):
        xx = torch.from_numpy(x).requires_grad_()
        out = tsp.spmm_coo(torch.from_numpy(row), torch.from_numpy(col),
                           torch.from_numpy(val), xx, M, backend=backend)
        (out * torch.from_numpy(g)).sum().backward()
        return xx.grad.numpy()

    def j_grad(backend):
        return np.asarray(jax.grad(lambda xx: (jspmm.spmm_coo(
            jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), xx, M,
            backend=backend) * g).sum())(jnp.asarray(x)))

    np.testing.assert_array_equal(t_grad("sell"), t_grad("auto"))
    np.testing.assert_allclose(t_grad("sell"), j_grad("xla"), **F32)
    assert np.abs(j_grad("sell") - j_grad("xla")).max() > 0.1
