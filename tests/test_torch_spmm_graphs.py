"""``PaddedCOO.spmm`` of paddle_sparse_tpu_torch (the port's path: K1's
register walk on the card, its plain version here) on four graph families
against the JAX package's ``spmm_coo`` (XLA): a clustered graph (rows
whose edges mostly fall inside their row's community of columns), uniform
columns, many empty rows and power-law degrees. Each case checks the
output, ``d value`` and ``d x`` under ``sum`` and ``mean``, at K = 1 and
at every width a benchmark cell runs K1 at, with padding entries whose
``d value`` must be 0.

Tolerances: f32 ``rtol=atol=1e-5``: the same f32 products summed in
another order (per row in JAX's segment sum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu_torch import PaddedCOO

F32 = dict(rtol=1e-5, atol=1e-5)
N = 280     # the columns of every graph
PAD = 5     # padding entries past the last edge


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clustered(M, N, deg, block, p_in=0.85, seed=0):
    """Rows of ``deg`` edges (0 for a few), each inside the row's
    ``block``-row community with probability ``p_in``, else uniform."""
    rng = np.random.default_rng(seed)
    d = np.full(M, deg)
    d[[0, M // 3, M - 1]] = 0
    row = np.repeat(np.arange(M), d)
    home = np.minimum(row * N // M // block * block
                      + rng.integers(0, block, row.size), N - 1)
    col = np.where(rng.random(row.size) < p_in, home,
                   rng.integers(0, N, row.size))
    return d, col


def _graphs():
    """Each family's row degrees and, for the clustered one, its columns
    (``None``: uniform over N, drawn by the caller)."""
    rng = np.random.default_rng(1)
    w = rng.zipf(1.5, 300).astype(np.float64)
    zdeg = np.maximum(1, np.floor(w * (3000 / w.sum()))).astype(np.int64)
    empty = rng.integers(0, 12, 250)
    empty[rng.integers(0, 250, 60)] = 0
    return {"clustered": _clustered(300, N, 10, 32),
            "uniform": (rng.integers(0, 15, 300), None),
            "empty_rows": (empty, None),
            "power_law": (zdeg, None)}


def _jax_spmm_grads(row, col, val, x, w, M):
    r, c = jnp.asarray(row), jnp.asarray(col)

    def f(v, xx):
        return (jspmm.spmm_coo(r, c, v, xx, M, backend="xla") * w).sum()

    out = jspmm.spmm_coo(r, c, jnp.asarray(val), jnp.asarray(x), M,
                         backend="xla")
    dv, dx = jax.grad(f, argnums=(0, 1))(jnp.asarray(val), jnp.asarray(x))
    return np.asarray(out), np.asarray(dv), np.asarray(dx)


def _problem(kind, K):
    """The ``kind`` graph in seeded numpy: degrees, rows, columns, values,
    x of width K and the cotangent ``w``."""
    deg, col = _graphs()[kind]
    if col is None:
        col = np.random.default_rng(2).integers(0, N, int(np.sum(deg)))
    M = deg.size
    rng = np.random.default_rng(6)
    row = np.repeat(np.arange(M), deg).astype(np.int32)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((M, K)).astype(np.float32)
    return deg, row, col.astype(np.int32), val, x, w


@pytest.mark.parametrize("K", [1, 47, 100, 128, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["clustered", "uniform", "empty_rows",
                                  "power_law"])
def test_padded_coo_spmm_graphs_vs_jax(kind, reduce, K):
    """``PaddedCOO.spmm`` with padding: output, ``d value`` and ``d x``
    equal the JAX package's; the padding's ``d value`` is 0."""
    deg, row, col, val, x, w = _problem(kind, K)
    M = deg.size
    adj = PaddedCOO.from_arrays(row, col, None, (M, N),
                                capacity=row.size + PAD)
    v = torch.zeros(adj.capacity)
    v[:row.size] = _t(val)
    v.requires_grad_()
    xt = _t(x).requires_grad_()
    out = adj.with_value(v).spmm(xt, reduce)
    (out * _t(w)).sum().backward()
    if reduce == "mean":
        d = np.maximum(deg, 1).astype(np.float32)[:, None]
        ww = w / d
    else:
        d, ww = 1.0, w
    jout, jdv, jdx = _jax_spmm_grads(row, col, val, x, ww, M)
    np.testing.assert_allclose(out.detach().numpy(), jout / d, **F32)
    np.testing.assert_allclose(v.grad[:row.size].numpy(), jdv, **F32)
    assert not bool(v.grad[row.size:].any())
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)
