"""Port parity: the GCN of paddle_sparse_tpu_torch against the JAX
paddle_sparse_tpu.models on the same numpy graph and the same (JAX-initialised)
params: forward at f32 with ``rtol=atol=1e-5``; loss and gradients (every
param and ``adj.value``) against ``jax.value_and_grad`` with
``rtol=atol=1e-5``, and SGD trajectories, where f32 rounding compounds over
the steps, with ``rtol=atol=1e-4``. The port runs a layer whose weight
narrows as ``A @ (h @ W)`` where JAX runs ``(A @ h) @ W``: the same
tolerances hold with layers that narrow, widen and keep their width.

Both run their matrix products in full f32 on the CPU. On a CUDA card the
port's ``h @ w`` is full f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default);
``chip_smoke.py`` sets it so."""
import dataclasses
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
from paddle_sparse_tpu_torch import (GCN, PaddedCOO, entry, gcn_loss,
                                     gcn_normalize, gcn_params_from_jax,
                                     init_gcn, train_entry, train_step)
from paddle_sparse_tpu_torch.entry import _toy_graph

TOL = dict(rtol=1e-5, atol=1e-5)
SGD_TOL = dict(rtol=1e-4, atol=1e-4)
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


@pytest.mark.parametrize("add_self_loops", [True, False])
def test_gcn_normalize_add_self_loops_flag(add_self_loops):
    """The flag only says the caller added the loops: both packages give
    what they give without it."""
    t, j, _ = _graph()
    tn = gcn_normalize(t, add_self_loops=add_self_loops)
    jn = j_normalize(j, add_self_loops=add_self_loops)
    np.testing.assert_allclose(tn.value.numpy(), np.asarray(jn.value), **TOL)
    assert torch.equal(tn.value, gcn_normalize(t).value)


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


def _jax_loss(params, adj, x, y):
    logp = jax.nn.log_softmax(jGCN(params, adj, x))
    return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()


def _jax_value_and_grad(params, jadj, x, y):
    """Loss and grads w.r.t. the params and the adjacency's values."""
    return jax.value_and_grad(
        lambda p, v: _jax_loss(p, dataclasses.replace(jadj, value=v), x, y),
        argnums=(0, 1))(params, jadj.value)


def _check_grads(model, adj, jgrads):
    jp, jv = jgrads
    for i, layer in enumerate(jp["layers"]):
        np.testing.assert_allclose(model.weight[i].grad.numpy(),
                                   np.asarray(layer["w"]), **TOL)
        np.testing.assert_allclose(model.bias[i].grad.numpy(),
                                   np.asarray(layer["b"]), **TOL)
    np.testing.assert_allclose(adj.value.grad.numpy(), np.asarray(jv), **TOL)
    assert not adj.value.grad[adj.nnz:].any()


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("with_value", [True, False])
def test_gcn_loss_and_grads(num_layers, with_value):
    t, j, x = _graph(with_value=with_value)
    tn, jn = gcn_normalize(t), j_normalize(j)
    y = np.random.default_rng(num_layers).integers(0, 5, 150)
    params = j_init(jax.random.PRNGKey(num_layers), 12, 16, 5,
                    num_layers=num_layers)
    jloss, jgrads = _jax_value_and_grad(params, jn, jnp.asarray(x),
                                        jnp.asarray(y))
    model = _load_jax_params(params, num_layers)
    tn.value.requires_grad_()
    loss = gcn_loss(model, tn, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    _check_grads(model, tn, jgrads)


@pytest.mark.parametrize("in_dim,hidden,out_dim", [(12, 16, 5),
                                                    (16, 12, 20)])
def test_gcn_each_layer_order(in_dim, hidden, out_dim):
    """Layers that widen, keep and narrow (12-16-16-5: the last narrows;
    16-12-12-20: the first): the port runs a narrowing layer as ``A @ (h @
    W)`` where JAX runs ``(A @ h) @ W``. Forward, loss and every grad,
    ``adj.value`` included, agree as in the tests above."""
    t, j, x = _graph(feat=in_dim)
    tn, jn = gcn_normalize(t), j_normalize(j)
    y = np.random.default_rng(in_dim).integers(0, out_dim, 150)
    params = j_init(jax.random.PRNGKey(in_dim), in_dim, hidden, out_dim,
                    num_layers=3)
    model = _load_jax_params(params, 3)
    with torch.inference_mode():
        out = model(tn, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jGCN(params, jn, jnp.asarray(x))), **TOL)
    jloss, jgrads = _jax_value_and_grad(params, jn, jnp.asarray(x),
                                        jnp.asarray(y))
    tn.value.requires_grad_()
    loss = gcn_loss(model, tn, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    _check_grads(model, tn, jgrads)


def test_gcn_grad_reaches_raw_value_through_normalize():
    """``requires_grad`` on the raw values: the grad flows back through
    ``gcn_normalize``, as ``jax.grad`` through the JAX ``gcn_normalize``."""
    t, j, x = _graph()
    y = np.random.default_rng(0).integers(0, 5, 150)
    params = j_init(jax.random.PRNGKey(0), 12, 16, 5)
    jv = jax.grad(lambda v: _jax_loss(
        params, j_normalize(dataclasses.replace(j, value=v)), jnp.asarray(x),
        jnp.asarray(y)))(j.value)
    model = _load_jax_params(params, 2)
    t.value.requires_grad_()
    gcn_loss(model, gcn_normalize(t), torch.from_numpy(x),
             torch.from_numpy(y)).backward()
    np.testing.assert_allclose(t.value.grad.numpy(), np.asarray(jv), **TOL)


def test_sgd_tracks_jax():
    """20 SGD steps (lr 0.1): the port's losses follow JAX's step by step,
    and the loss decreases, as ``tests/test_models.py`` asserts."""
    t, j, x = _graph()
    tn, jn = gcn_normalize(t), j_normalize(j)
    y = np.random.default_rng(5).integers(0, 5, 150)
    params = j_init(jax.random.PRNGKey(5), 12, 16, 5)
    model = _load_jax_params(params, 2)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(p, jn, jnp.asarray(x), jnp.asarray(y))))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(20):
        jloss, grads = grad_fn(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params,
                                        grads)
        loss = train_step(model, tn, xt, yt, 0.1)
        np.testing.assert_allclose(float(loss), float(jloss), **SGD_TOL)
        losses.append(float(loss))
    for i, layer in enumerate(params["layers"]):
        np.testing.assert_allclose(model.weight[i].detach().numpy(),
                                   np.asarray(layer["w"]), **SGD_TOL)
    assert losses[-1] < losses[0]


def test_toy_train_step_matches_graft_entry():
    """``train_entry('cpu')`` with the JAX entry's params: one
    ``train_step`` gives JAX's loss, grads (params and ``adj.value``) and
    updated params on ``__graft_entry__._toy_graph``."""
    _, (params, jadj, jx) = _graft_entry().entry()
    y = _toy_graph()[4]
    jloss, jgrads = _jax_value_and_grad(params, jadj, jx, jnp.asarray(y))
    model, adj, x, yt = train_entry("cpu")
    np.testing.assert_array_equal(yt.numpy(), y)
    assert yt.dtype == torch.int64
    model.load_state_dict(gcn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    adj.value.requires_grad_()
    loss = train_step(model, adj, x, yt, 0.1)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _check_grads(model, adj, jgrads)
    for i, (layer, grad) in enumerate(zip(params["layers"],
                                          jgrads[0]["layers"])):
        np.testing.assert_allclose(model.weight[i].detach().numpy(),
                                   np.asarray(layer["w"] - 0.1 * grad["w"]),
                                   **TOL)
        np.testing.assert_allclose(model.bias[i].detach().numpy(),
                                   np.asarray(layer["b"] - 0.1 * grad["b"]),
                                   **TOL)
