"""Port parity: the GCN of paddle_sparse_tpu_torch against the JAX
paddle_sparse_tpu.models on the same numpy graph and the same (JAX-initialised)
params, at f32 with ``rtol=atol=1e-5``.

Both run their matrix products in full f32 on the CPU. On a CUDA card the
port's ``h @ w`` is full f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
``chip_smoke.py`` sets it so."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.models import GCN as jGCN
from paddle_sparse_tpu.models import gcn_normalize as j_normalize
from paddle_sparse_tpu.models import init_gcn as j_init
from paddle_sparse_tpu_torch import (GCN, PaddedCOO, entry, gcn_normalize,
                                     gcn_params_from_jax, init_gcn)
from paddle_sparse_tpu_torch.entry import _toy_graph

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = Path(__file__).resolve().parents[1]


def _graph(n=150, nnz=900, feat=12, capacity=1100, seed=3, with_value=True):
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, n, nnz))
    col = rng.integers(0, n, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.random(nnz).astype(np.float32) if with_value else None
    x = rng.standard_normal((n, feat)).astype(np.float32)
    t = PaddedCOO.from_arrays(row, col, val, (n, n), capacity=capacity)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               None if val is None else jnp.asarray(val),
                               (n, n), capacity=capacity)
    return t, j, x


@pytest.mark.parametrize("with_value", [True, False])
def test_gcn_normalize(with_value):
    t, j, _ = _graph(with_value=with_value)
    tn, jn = gcn_normalize(t), j_normalize(j)
    np.testing.assert_allclose(tn.value.numpy(), np.asarray(jn.value), **TOL)
    assert not tn.value[t.nnz:].any()


def _load_jax_params(params, num_layers):
    in_dim, hidden = params["layers"][0]["w"].shape
    out_dim = params["layers"][-1]["w"].shape[1]
    model = GCN(in_dim, hidden, out_dim, num_layers)
    model.load_state_dict(gcn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("with_value", [True, False])
def test_gcn_forward(num_layers, with_value):
    t, j, x = _graph(with_value=with_value)
    tn, jn = gcn_normalize(t), j_normalize(j)
    params = j_init(jax.random.PRNGKey(num_layers), 12, 16, 5,
                    num_layers=num_layers)
    model = _load_jax_params(params, num_layers)
    with torch.inference_mode():
        out = model(tn, torch.from_numpy(x))
    ref = jGCN(params, jn, jnp.asarray(x))
    assert out.shape == (150, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_gcn_forward_under_grad_raises():
    """Training is not ported: the second layer's SpMM sees an input that
    requires grad and refuses rather than detaching."""
    t, _, x = _graph()
    model = init_gcn(torch.Generator().manual_seed(0), 12, 16, 5)
    with pytest.raises(NotImplementedError, match="backward"):
        model(gcn_normalize(t), torch.from_numpy(x))


def test_init_gcn():
    a = init_gcn(torch.Generator().manual_seed(4), 64, 128, 10, num_layers=3)
    b = init_gcn(torch.Generator().manual_seed(4), 64, 128, 10, num_layers=3)
    assert [tuple(w.shape) for w in a.weight] == [(64, 128), (128, 128),
                                                  (128, 10)]
    for wa, wb, bias in zip(a.weight, b.weight, a.bias):
        assert torch.equal(wa, wb) and not bias.any()
    # He-normal: std sqrt(2 / d_in), as the JAX _dense
    for w in a.weight[:2]:
        std = float(w.detach().std())
        assert abs(std / (2.0 / w.shape[0]) ** 0.5 - 1) < 0.1


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_graft_entry_for_port_test", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_toy_graph_matches_graft_entry():
    graft = _graft_entry()
    for a, b in zip(_toy_graph(), graft._toy_graph()):
        np.testing.assert_array_equal(a, b)


def test_entry_matches_graft_entry():
    """The toy slice: same normalized adjacency and features as the JAX
    ``entry()``, and with JAX's params loaded, the same forward."""
    fn, (params, jadj, jx) = _graft_entry().entry()
    model, adj, x = entry("cpu")
    assert adj.shape == jadj.shape == (256, 256)
    assert adj.capacity == jadj.capacity == 2304
    np.testing.assert_array_equal(adj.row.numpy(), np.asarray(jadj.row))
    np.testing.assert_array_equal(adj.col.numpy(), np.asarray(jadj.col))
    np.testing.assert_allclose(adj.value.numpy(), np.asarray(jadj.value),
                               **TOL)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert [tuple(w.shape) for w in model.weight] == [(32, 64), (64, 8)]
    model.load_state_dict(gcn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    with torch.inference_mode():
        out = model(adj, x)
    np.testing.assert_allclose(out.numpy(), np.asarray(fn(params, jadj, jx)),
                               **TOL)
