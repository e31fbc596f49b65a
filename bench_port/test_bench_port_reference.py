"""The blocked plain reference against a dense float64 step by autograd at
a tiny size: losses, first gradients, ``d value`` and the change over three
SGD steps, for GCN and GraphSAGE, with and without edge-value grads, in
blocks much smaller than the graph."""
import pytest
import torch

from bench_port import graphs
from bench_port.models import gcn as gcn_model
from bench_port.models import sage as sage_model
from bench_port.reference import gcn, sage, sparse
from bench_port.reference.train import sgd_steps

CFG = {"num_layers": 3, "in_channels": 6, "hidden_channels": 9,
       "out_channels": 4}
N, DEG, LR = 40, 5, 0.3


def _inputs(kind, seed):
    gen = graphs.generator(seed, "cpu")
    g = graphs.graph(gen, kind, N, DEG, community=16)
    x = graphs.features(gen, N, CFG["in_channels"]).double()
    y = graphs.labels(gen, N, CFG["out_channels"])
    return g, x, y, gen


def _dense_step(model, dense_a, x, y, p, deg=None):
    """Loss of ``model`` by autograd on a dense adjacency."""
    h = x
    L = CFG["num_layers"]
    for i in range(L):
        if model == "gcn":
            z = (dense_a @ h) @ p[f"weight.{i}"] + p[f"bias.{i}"]
        else:
            agg = (dense_a @ h) / deg[:, None]
            z = (h @ p[f"self_weight.{i}"] + p[f"self_bias.{i}"]
                 + agg @ p[f"neigh_weight.{i}"] + p[f"neigh_bias.{i}"])
        h = torch.relu(z) if i < L - 1 else z
    return torch.nn.functional.cross_entropy(h, y)


@pytest.mark.parametrize("model", ["gcn", "sage"])
@pytest.mark.parametrize("value_grad", [False, True])
@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_blocked_reference_is_the_dense_step(model, value_grad, kind):
    mod, ref = ((gcn_model, gcn) if model == "gcn" else (sage_model, sage))
    g, x, y, gen = _inputs(kind, 3)
    params = {k: v.double() for k, v in graphs.weights(
        gen, mod.param_shapes(CFG)).items()}
    for k in params:             # non-zero biases, so their path counts
        if params[k].dim() == 1:
            params[k] = torch.randn(params[k].shape, generator=gen,
                                    dtype=torch.float64)
    adj = sparse.adjacency(g.row, g.col, g.value, N, torch.float64,
                           normalize=mod.NORMALIZE, block_bytes=100)
    got = sgd_steps(ref, adj, x, y, params, torch.matmul, LR, 3, value_grad)

    value = adj.value.clone().requires_grad_(value_grad)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    deg = torch.bincount(g.row.long(), minlength=N).double().clamp(min=1)
    losses = []
    for t in range(3):
        dense_a = torch.zeros(N, N, dtype=torch.float64).index_put(
            (g.row.long(), g.col.long()), value, accumulate=True)
        loss = _dense_step(model, dense_a, x, y, p, deg)
        leaves = list(p.values()) + ([value] if value_grad else [])
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if t == 0:
            g1 = dict(zip(p, grads))
            if value_grad:
                assert torch.allclose(got["d_value1"], grads[-1],
                                      rtol=1e-10, atol=1e-14)
            else:
                assert got["d_value1"] is None
            for k in p:
                assert torch.allclose(got["grad1"][k], g1[k], rtol=1e-10,
                                      atol=1e-14), k
        with torch.no_grad():
            for k, gk in zip(p, grads):
                p[k] -= LR * gk
    assert got["losses"] == pytest.approx(losses, rel=1e-12)
    for k in p:
        assert torch.allclose(got["change"][k], (p[k] - params[k]).detach(),
                              rtol=1e-9, atol=1e-13), k


def test_forward_is_the_dense_forward():
    g, x, y, gen = _inputs("uniform", 8)
    params = {k: v.double() for k, v in graphs.weights(
        gen, gcn_model.param_shapes(CFG)).items()}
    adj = sparse.adjacency(g.row, g.col, g.value, N, torch.float64,
                           normalize=True, block_bytes=64)
    dense_a = torch.zeros(N, N, dtype=torch.float64).index_put(
        (g.row.long(), g.col.long()), adj.value, accumulate=True)
    h = x
    for i in range(3):
        h = (dense_a @ h) @ params[f"weight.{i}"] + params[f"bias.{i}"]
        h = torch.relu(h) if i < 2 else h
    assert torch.allclose(gcn.forward(adj, x, params, torch.matmul), h,
                          rtol=1e-12, atol=1e-12)


def test_gcn_normalization_is_row_count_based():
    row = torch.tensor([0, 0, 1, 2, 2, 2])
    col = torch.tensor([1, 2, 0, 0, 1, 2])
    val = torch.ones(6)
    a = sparse.adjacency(row, col, val, 3, torch.float64, normalize=True)
    deg = torch.tensor([2.0, 1.0, 3.0], dtype=torch.float64)
    want = 1 / (deg[row].sqrt() * deg[col].sqrt())
    assert torch.allclose(a.value, want)


def test_tf32_rounding():
    one = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-12, -(1 + 2**-11),
                        1 + 3 * 2**-11], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2**-10, 1.0, -(1 + 2**-10),
                         1 + 2 * 2**-10], dtype=torch.float32)
    assert torch.equal(sparse.tf32_round(one), want)
    mm = sparse.matmul_for(True)
    a = torch.full((1, 1), 1 + 2**-12)
    assert float(mm(a, torch.ones(1, 1))) == 1.0
    assert float(sparse.matmul_for(False)(a, torch.ones(1, 1))) == \
        1 + 2**-12
