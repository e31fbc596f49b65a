"""Port parity: GraphSAGE, GIN, APPNP and GAT (multi-head) of
paddle_sparse_tpu_torch against the JAX paddle_sparse_tpu.models on the same
numpy graph, with the JAX ``init_*`` params carried over by the
``*_params_from_jax`` functions: forward, loss and every gradient (each
parameter, GIN's ``eps`` included, and ``adj.value`` where the model reads
it) against ``jax.value_and_grad``, SGD steps, ``edge_softmax`` and its
gradient, GAT's refusal of a rectangular adjacency, and the toy set-ups of
``model_entry``. GraphSAGE also where a layer narrows, widens or keeps its
width (the port aggregates a narrowing layer after ``h @ W_neigh``), and
GCN's and GraphSAGE's SpMMs each at min(d_in, d_out) columns.

Tolerances: forward, loss and gradients ``rtol=atol=1e-5`` in f32, as
``tests/test_torch_gcn.py``; SGD trajectories, where f32 rounding compounds
over the steps, ``rtol=atol=1e-4``. Both packages run their matrix products
in full f32 on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.core import PaddedCOO as JPaddedCOO
from paddle_sparse_tpu.models import APPNP as jAPPNP
from paddle_sparse_tpu.models import GAT as jGAT
from paddle_sparse_tpu.models import GIN as jGIN
from paddle_sparse_tpu.models import GraphSAGE as jSAGE
from paddle_sparse_tpu.models import edge_softmax as j_edge_softmax
from paddle_sparse_tpu.models import gcn_normalize as j_normalize
from paddle_sparse_tpu.models import (init_appnp, init_gat, init_gcn,
                                      init_gin, init_sage)
from paddle_sparse_tpu_torch import (APPNP, GAT, GCN, GIN, MODELS, GraphSAGE,
                                     PaddedCOO, appnp_params_from_jax,
                                     edge_softmax, gat_params_from_jax,
                                     gcn_loss, gcn_normalize,
                                     gcn_params_from_jax, gin_params_from_jax,
                                     model_entry, sage_params_from_jax,
                                     train_step)
from paddle_sparse_tpu_torch import init_appnp as t_init_appnp
from paddle_sparse_tpu_torch import init_gat as t_init_gat
from paddle_sparse_tpu_torch import init_gcn as t_init_gcn
from paddle_sparse_tpu_torch import init_gin as t_init_gin
from paddle_sparse_tpu_torch import init_sage as t_init_sage
from paddle_sparse_tpu_torch.core import matrix as tmatrix
from paddle_sparse_tpu_torch.entry import _toy_graph
from paddle_sparse_tpu_torch.ops import segment as tseg

TOL = dict(rtol=1e-5, atol=1e-5)
SGD_TOL = dict(rtol=1e-4, atol=1e-4)
IN, HID, OUT, HEADS = 12, 16, 5, 3
KINDS = ["sage", "gin", "appnp", "gat"]


def _graph(n=150, nnz=900, capacity=1100, seed=3, feat=IN):
    """A random row-sorted graph with duplicate entries and empty rows,
    padded, in both packages; and features."""
    rng = np.random.default_rng(seed)
    row = np.sort(rng.integers(0, n, nnz))
    col = rng.integers(0, n, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    val = rng.random(nnz).astype(np.float32)
    x = rng.standard_normal((n, feat)).astype(np.float32)
    t = PaddedCOO.from_arrays(row, col, val, (n, n), capacity=capacity)
    j = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                               jnp.asarray(val), (n, n), capacity=capacity)
    return t, j, x


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(kind, num_layers, seed=0):
    """JAX params, the JAX apply ``fn(params, adj, x)``, the port's model
    with those params, its params-from-JAX function, and whether the model
    runs on the ``gcn_normalize``-d adjacency (APPNP, as
    ``tests/test_models.py``)."""
    key = jax.random.PRNGKey(seed)
    if kind == "sage":
        params = init_sage(key, IN, HID, OUT, num_layers=num_layers)
        fn, model, conv = jSAGE, GraphSAGE(IN, HID, OUT, num_layers), \
            sage_params_from_jax
    elif kind == "gin":
        params = init_gin(key, IN, HID, OUT, num_layers=num_layers)
        # a trained eps, so that its gradient and its use both show
        params["eps"] = jnp.asarray([0.3, -0.2, 0.1][:num_layers],
                                    jnp.float32)
        fn, model, conv = jGIN, GIN(IN, HID, OUT, num_layers), \
            gin_params_from_jax
    elif kind == "appnp":
        params = init_appnp(key, IN, HID, OUT)
        fn = (lambda p, a, x: jAPPNP(p, a, x, k=5, alpha=0.1))
        model, conv = APPNP(IN, HID, OUT, k=5, alpha=0.1), \
            appnp_params_from_jax
    else:
        params = init_gat(key, IN, 8, OUT, heads=HEADS,
                          num_layers=num_layers)
        fn, model, conv = jGAT, GAT(IN, 8, OUT, heads=HEADS,
                                    num_layers=num_layers), \
            gat_params_from_jax
    model.load_state_dict(conv(_np(params)))
    return params, fn, model, conv, kind == "appnp"


def _adjs(normalize, seed=3):
    t, j, x = _graph(seed=seed)
    if normalize:
        t, j = gcn_normalize(t), j_normalize(j)
    return t, j, x


def _jax_loss(fn, params, adj, x, y):
    logp = jax.nn.log_softmax(fn(params, adj, x))
    return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()


def _jax_value_and_grad(fn, params, jadj, x, y):
    """Loss and grads w.r.t. the params and the adjacency's values."""
    return jax.value_and_grad(
        lambda p, v: _jax_loss(fn, p, dataclasses.replace(jadj, value=v),
                               jnp.asarray(x), jnp.asarray(y)),
        argnums=(0, 1))(params, jadj.value)


@pytest.mark.parametrize("kind,num_layers", [
    ("sage", 2), ("sage", 3), ("gin", 2), ("gin", 3), ("appnp", 2),
    ("gat", 2), ("gat", 3)])
def test_forward(kind, num_layers):
    params, fn, model, _, norm = _setup(kind, num_layers)
    t, j, x = _adjs(norm)
    with torch.inference_mode():
        out = model(t, torch.from_numpy(x))
    ref = fn(params, j, jnp.asarray(x))
    assert out.shape == (150, OUT)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kind,num_layers", [
    ("sage", 2), ("sage", 3), ("gin", 2), ("gin", 3), ("appnp", 2),
    ("gat", 2), ("gat", 3)])
def test_loss_and_grads(kind, num_layers):
    """Loss, every parameter's grad (by state-dict name) and ``d value``:
    GAT reads no adjacency values, so JAX's grad there is 0 and the port's
    is never made."""
    _check_loss_and_grads(kind, num_layers)


def test_gat_grads_through_small_row_groups(monkeypatch):
    """GAT's row reductions and gathers through groups of 4 entries (rows
    cut into many groups, as a hub row is at ``GROUP`` = 1024): the same
    loss and grads as JAX."""
    monkeypatch.setattr(tseg, "GROUP", 4)
    _check_loss_and_grads("gat", 2)


def _check_loss_and_grads(kind, num_layers):
    params, fn, model, conv, norm = _setup(kind, num_layers)
    t, j, x = _adjs(norm)
    y = np.random.default_rng(num_layers).integers(0, OUT, 150)
    jloss, (jp, jv) = _jax_value_and_grad(fn, params, j, x, y)
    t.value.requires_grad_()
    loss = gcn_loss(model, t, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = conv(_np(jp))
    got = dict(model.named_parameters())
    assert sorted(want) == sorted(got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **TOL)
    if kind == "gat":
        assert t.value.grad is None and not np.asarray(jv).any()
    else:
        np.testing.assert_allclose(t.value.grad.numpy(), np.asarray(jv),
                                   **TOL)
        assert not t.value.grad[t.nnz:].any()


@pytest.mark.parametrize("in_dim,hidden,out_dim", [(12, 16, 5),
                                                    (16, 12, 20)])
def test_sage_each_layer_order(in_dim, hidden, out_dim):
    """Layers that widen, keep and narrow (12-16-16-5: the last narrows;
    16-12-12-20: the first): the port takes a narrowing layer's mean of
    ``h @ W_neigh`` where JAX takes ``mean(h) @ W_neigh``. Forward, loss
    and every grad, ``adj.value`` included, agree as in the tests above."""
    params = init_sage(jax.random.PRNGKey(in_dim), in_dim, hidden, out_dim,
                       num_layers=3)
    model = GraphSAGE(in_dim, hidden, out_dim, 3)
    model.load_state_dict(sage_params_from_jax(_np(params)))
    t, j, x = _graph(feat=in_dim)
    with torch.inference_mode():
        out = model(t, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jSAGE(params, j, jnp.asarray(x))), **TOL)
    y = np.random.default_rng(in_dim).integers(0, out_dim, 150)
    jloss, (jp, jv) = _jax_value_and_grad(jSAGE, params, j, x, y)
    t.value.requires_grad_()
    loss = gcn_loss(model, t, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    got = dict(model.named_parameters())
    for name, g in sage_params_from_jax(_np(jp)).items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(t.value.grad.numpy(), np.asarray(jv), **TOL)


class _WidthRecorder:
    """An adjacency for ``GCN``/``GraphSAGE.forward`` that records the
    width of each dense operand ``spmm`` receives."""

    def __init__(self, adj):
        self.adj, self.widths = adj, []

    def spmm(self, x, **reduce):
        self.widths.append(x.shape[-1])
        return self.adj.spmm(x, **reduce)


@pytest.mark.parametrize("model", [GCN, GraphSAGE])
@pytest.mark.parametrize("dims", [(12, 16, 16, 5), (16, 12, 12, 20),
                                  (12, 16, 16, 16), (16, 16, 16, 16)])
def test_each_layer_aggregates_at_its_narrower_width(model, dims):
    """Each layer's SpMM gets ``min(d_in, d_out)`` columns, ties at
    ``d_in``, and the forward equals the aggregate-first order's."""
    t, _, x = _graph(feat=dims[0])
    init = t_init_gcn if model is GCN else t_init_sage
    m = init(torch.Generator().manual_seed(0), dims[0], dims[1], dims[-1],
             len(dims) - 1)
    if model is GCN:
        t = gcn_normalize(t)
    adj = _WidthRecorder(t)
    with torch.inference_mode():
        out = m(adj, torch.from_numpy(x))
        h = torch.from_numpy(x)
        for i in range(len(dims) - 1):       # aggregate first throughout
            if model is GCN:
                h = t.spmm(h) @ m.weight[i] + m.bias[i]
            else:
                h = (h @ m.self_weight[i] + m.self_bias[i]
                     + t.spmm(h, reduce="mean") @ m.neigh_weight[i]
                     + m.neigh_bias[i])
            h = torch.relu(h) if i < len(dims) - 2 else h
    assert adj.widths == [min(a, b) for a, b in zip(dims, dims[1:])]
    torch.testing.assert_close(out, h, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_sgd_tracks_jax(kind):
    """8 SGD steps (lr 0.05): the port's losses follow JAX's step by step,
    the parameters end equal, and the loss decreases."""
    params, fn, model, conv, norm = _setup(kind, 2, seed=5)
    t, j, x = _adjs(norm)
    y = np.random.default_rng(5).integers(0, OUT, 150)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: _jax_loss(fn, p, j, jnp.asarray(x), jnp.asarray(y))))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(8):
        jloss, grads = grad_fn(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.05 * g, params,
                                        grads)
        loss = train_step(model, t, xt, yt, 0.05)
        np.testing.assert_allclose(float(loss), float(jloss), **SGD_TOL)
        losses.append(float(loss))
    got = dict(model.named_parameters())
    for name, p in conv(_np(params)).items():
        np.testing.assert_allclose(got[name].detach().numpy(), p.numpy(),
                                   err_msg=name, **SGD_TOL)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("heads", [None, 1, 3])
@pytest.mark.parametrize("group", [None, 4])
def test_edge_softmax(monkeypatch, heads, group):
    """Against JAX, values and the gradient of ``sum(att * w)``; rows sum to
    1 (0 for an empty row) and padding gets 0, as
    ``tests/test_models.py`` asserts; also with rows cut into groups of 4
    entries."""
    if group:
        monkeypatch.setattr(tseg, "GROUP", group)
    t, j, _ = _graph()
    rng = np.random.default_rng(8)
    shape = (t.capacity,) if heads is None else (t.capacity, heads)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    ref = j_edge_softmax(j, jnp.asarray(logits))
    jg = jax.grad(lambda lg: (j_edge_softmax(j, lg) * w).sum())(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    att = edge_softmax(t, lt)
    (att * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(att.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), **TOL)
    att = att.detach().reshape(t.capacity, -1).double()
    assert not att[t.nnz:].any()
    sums = torch.zeros(150, att.shape[1], dtype=torch.float64).index_add_(
        0, t.row[:t.nnz].long(), att[:t.nnz])
    nonempty = t.degree() > 0
    torch.testing.assert_close(sums[nonempty], torch.ones_like(
        sums[nonempty]), rtol=0, atol=1e-5)
    assert not sums[~nonempty].any()


def test_gat_refuses_rectangular_adjacency():
    rng = np.random.default_rng(0)
    row = np.sort(rng.integers(0, 40, 100)).astype(np.int32)
    col = rng.integers(0, 30, 100).astype(np.int32)
    adj = PaddedCOO.from_arrays(row, col, None, (40, 30))
    jadj = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col), None,
                                  (40, 30))
    params = init_gat(jax.random.PRNGKey(0), IN, 8, OUT, heads=2)
    x = rng.standard_normal((30, IN)).astype(np.float32)
    with pytest.raises(AssertionError, match="square"):
        jGAT(params, jadj, jnp.asarray(x))
    model = GAT(IN, 8, OUT, heads=2)
    with pytest.raises(ValueError, match="square"):
        model(adj, torch.from_numpy(x))


def test_gat_builds_the_csc_view_once(monkeypatch):
    """Every head aggregates over the adjacency itself (``adj.spmm(hw,
    value=att)``), whose cache keeps the CSC view: one per graph for all
    layers and heads."""
    calls = []
    real = tmatrix.spmm_structure
    monkeypatch.setattr(tmatrix, "spmm_structure",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, _, model, _, _ = _setup("gat", 3)
    t, _, x = _graph()
    y = torch.from_numpy(np.random.default_rng(1).integers(0, OUT, 150))
    gcn_loss(model, t, torch.from_numpy(x), y).backward()
    gcn_loss(model, t, torch.from_numpy(x), y).backward()
    assert len(calls) == 1 and "structure" in t._cache


@pytest.mark.parametrize("kind", KINDS)
def test_inference_forward_then_train_step(kind):
    """A forward under ``torch.inference_mode()`` builds the adjacency's
    caches (GAT's row groups too); a train step after it still works and
    gives the loss of a fresh adjacency."""
    _, _, model, _, norm = _setup(kind, 2)
    t, _, x = _adjs(norm)
    fresh, _, _ = _adjs(norm)
    xt = torch.from_numpy(x)
    y = torch.from_numpy(np.random.default_rng(2).integers(0, OUT, 150))
    with torch.inference_mode():
        model(t, xt)
    loss = gcn_loss(model, t, xt, y)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()),
                               float(gcn_loss(model, fresh, xt, y).detach()),
                               **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_init(kind):
    """Same generator seed, same model; He-normal scale sqrt(2 / d_in) on
    the widest weight; zero biases and eps; the shapes of the JAX
    ``init_*`` (so its params load)."""
    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        if kind == "sage":
            return t_init_sage(gen, 64, 128, 10, num_layers=3)
        if kind == "gin":
            return t_init_gin(gen, 64, 128, 10, num_layers=3)
        if kind == "appnp":
            return t_init_appnp(gen, 64, 128, 10)
        return t_init_gat(gen, 64, 32, 10, heads=4, num_layers=3)
    a, b = make(4), make(4)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if "bias" in name or name == "eps":
            assert not pa.any(), name
    w = dict(a.named_parameters())[{"sage": "self_weight.1",
                                    "gin": "mlp1_weight.1",
                                    "appnp": "weight.0",
                                    "gat": "weight.1"}[kind]]
    std = float(w.detach().std())
    assert abs(std / (2.0 / w.shape[0]) ** 0.5 - 1) < 0.1
    key = jax.random.PRNGKey(0)
    jp = {"sage": lambda: init_sage(key, 64, 128, 10, num_layers=3),
          "gin": lambda: init_gin(key, 64, 128, 10, num_layers=3),
          "appnp": lambda: init_appnp(key, 64, 128, 10),
          "gat": lambda: init_gat(key, 64, 32, 10, heads=4,
                                  num_layers=3)}[kind]()
    conv = {"sage": sage_params_from_jax, "gin": gin_params_from_jax,
            "appnp": appnp_params_from_jax, "gat": gat_params_from_jax}[kind]
    a.load_state_dict(conv(_np(jp)))


def _jax_toy(kind):
    """``tests/test_models.py``'s set-up of ``kind`` on the toy graph: JAX
    params (32 -> 64 -> 8; GAT 2 heads of 16), apply and adjacency."""
    row, col, val, _, _ = _toy_graph()
    jadj = JPaddedCOO.from_arrays(jnp.asarray(row), jnp.asarray(col),
                                  jnp.asarray(val), (256, 256), capacity=2304)
    key = jax.random.PRNGKey(1)
    if kind in ("gcn", "appnp"):
        jadj = j_normalize(jadj)
    if kind == "gcn":
        from paddle_sparse_tpu.models import GCN as jGCN
        return init_gcn(key, 32, 64, 8), jGCN, jadj, gcn_params_from_jax
    if kind == "sage":
        return init_sage(key, 32, 64, 8), jSAGE, jadj, sage_params_from_jax
    if kind == "gin":
        return init_gin(key, 32, 64, 8), jGIN, jadj, gin_params_from_jax
    if kind == "appnp":
        return (init_appnp(key, 32, 64, 8),
                lambda p, a, x: jAPPNP(p, a, x, k=5), jadj,
                appnp_params_from_jax)
    return (init_gat(key, 32, 16, 8, heads=2), jGAT, jadj,
            gat_params_from_jax)


@pytest.mark.parametrize("kind", MODELS)
def test_model_entry_matches_jax(kind):
    """``model_entry(kind, "cpu")`` holds the JAX set-up's adjacency and
    features; with JAX's params loaded, its forward is JAX's."""
    params, fn, jadj, conv = _jax_toy(kind)
    model, adj, x, y = model_entry(kind, "cpu")
    np.testing.assert_array_equal(adj.col.numpy(), np.asarray(jadj.col))
    np.testing.assert_allclose(adj.value.numpy(), np.asarray(jadj.value),
                               **TOL)
    assert y.dtype == torch.int64 and y.shape == (256,)
    model.load_state_dict(conv(_np(params)))
    with torch.inference_mode():
        out = model(adj, x)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(fn(params, jadj, jnp.asarray(
                                   x.numpy()))), **TOL)


def test_model_entry_unknown():
    with pytest.raises(ValueError, match="unknown model"):
        model_entry("gcnii", "cpu")
