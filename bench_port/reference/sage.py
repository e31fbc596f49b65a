"""Plain PyTorch GraphSAGE with the mean aggregator (Hamilton et al.,
arXiv:1706.02216; PyG's ``SAGEConv`` as OGB's products example runs it),
forward, loss, gradients and SGD, every sparse product
through ``sparse.Adjacency``.

A layer is ``H' = relu(H @ W_self + b_self + mean_N(H) @ W_neigh +
b_neigh)``, no relu after the last layer; ``mean_N(H)[r]`` is the sum of
``value[e] H[col[e]]`` over row r's entries divided by the row's entry
count (at least 1), the port's ``reduce="mean"``. Parameters are named as
the port's ``GraphSAGE`` names them (``self_weight.i``, ``self_bias.i``,
``neigh_weight.i``, ``neigh_bias.i``).
"""
from typing import Dict

import torch

from .sparse import Adjacency, cross_entropy


def _layers(params):
    return sum(1 for k in params if k.startswith("self_weight."))


def forward(adj: Adjacency, x, params: Dict[str, torch.Tensor], mm,
            keep: bool = False):
    """Logits; with ``keep`` also each layer's input ``h``, its mean
    ``agg`` and the row counts."""
    L = _layers(params)
    deg = adj.degree().clamp(min=1)[:, None]
    hs, aggs, h = [], [], x
    for i in range(L):
        agg = adj.spmm(h) / deg
        z = (mm(h, params[f"self_weight.{i}"]) + params[f"self_bias.{i}"]
             + mm(agg, params[f"neigh_weight.{i}"])
             + params[f"neigh_bias.{i}"])
        if keep:
            hs.append(h)
            aggs.append(agg)
        del agg
        h = torch.relu(z) if i < L - 1 else z
    return (h, hs, aggs, deg) if keep else h


def gradients(adj: Adjacency, x, y, params, mm, value_grad: bool):
    """``(loss, grads by name, d value or None)`` of the mean NLL."""
    L = _layers(params)
    z, hs, aggs, deg = forward(adj, x, params, mm, keep=True)
    loss, dz = cross_entropy(z, y)
    del z
    grads, dv = {}, None
    for i in reversed(range(L)):
        grads[f"self_weight.{i}"] = mm(hs[i].t(), dz)
        grads[f"neigh_weight.{i}"] = mm(aggs[i].t(), dz)
        grads[f"self_bias.{i}"] = grads[f"neigh_bias.{i}"] = dz.sum(0)
        aggs[i] = None
        if i == 0 and not value_grad:
            break
        # the gradient of the row sums under the mean
        dsum = mm(dz, params[f"neigh_weight.{i}"].t()) / deg
        if i == 0:
            dv0 = adj.sddmm(dsum, hs[0])
            dv = dv0 if dv is None else dv + dv0
            continue
        if value_grad:
            dvi = adj.sddmm(dsum, hs[i])
            dv = dvi if dv is None else dv + dvi
        dh = adj.spmm_t(dsum)
        del dsum
        dh += mm(dz, params[f"self_weight.{i}"].t())
        dz = dh * (hs[i] > 0)
        hs[i] = None
        del dh
    return float(loss), grads, dv
