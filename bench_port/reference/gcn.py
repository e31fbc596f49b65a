"""Plain PyTorch GCN (Kipf and Welling, arXiv:1609.02907), forward, loss,
gradients and SGD, written out by hand so that every sparse product runs
through ``sparse.Adjacency``.

A layer is ``H' = relu(A_hat @ H @ W + b)``, evaluated as ``(A_hat @ H) @
W`` (the published order), with no relu after the last layer; ``A_hat``
is the normalized adjacency the caller passes. Parameters are named as the
port's ``GCN`` names them (``weight.i`` of shape ``(d_in, d_out)``,
``bias.i``), so the harness hands both sides one dict. No dropout: the
configuration assumes none.
"""
from typing import Dict

import torch

from .sparse import Adjacency, cross_entropy


def _layers(params):
    return sum(1 for k in params if k.startswith("weight."))


def forward(adj: Adjacency, x, params: Dict[str, torch.Tensor], mm,
            keep: bool = False):
    """Logits; with ``keep`` also each layer's input ``h`` and aggregate
    ``s = A_hat @ h``."""
    L = _layers(params)
    hs, ss, h = [], [], x
    for i in range(L):
        s = adj.spmm(h)
        z = mm(s, params[f"weight.{i}"]) + params[f"bias.{i}"]
        if keep:
            hs.append(h)
            ss.append(s)
        else:
            del s
        h = torch.relu(z) if i < L - 1 else z
    return (h, hs, ss) if keep else h


def gradients(adj: Adjacency, x, y, params, mm, value_grad: bool):
    """``(loss, grads by name, d value or None)`` of the mean NLL."""
    L = _layers(params)
    z, hs, ss = forward(adj, x, params, mm, keep=True)
    loss, dz = cross_entropy(z, y)
    del z
    grads, dv = {}, None
    for i in reversed(range(L)):
        w = params[f"weight.{i}"]
        grads[f"weight.{i}"] = mm(ss[i].t(), dz)
        grads[f"bias.{i}"] = dz.sum(0)
        ss[i] = None
        if i == 0 and not value_grad:
            break
        ds = mm(dz, w.t())
        if i == 0:
            dv0 = adj.sddmm(ds, hs[0])
            dv = dv0 if dv is None else dv + dv0
            continue
        if value_grad:
            dvi = adj.sddmm(ds, hs[i])
            dv = dvi if dv is None else dv + dvi
        dh = adj.spmm_t(ds)
        del ds
        dz = dh * (hs[i] > 0)
        hs[i] = None
        del dh
    return float(loss), grads, dv
