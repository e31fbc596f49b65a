"""A float64 plain-torch GAT forward for the tests, written from the
layer's equations (PyG's ``GATConv``; Velickovic et al., arXiv:1710.10903)
and independent of the code under test: it imports neither JAX nor
``paddle_sparse_tpu_torch``.

For each layer of ``H`` heads of ``C`` channels: ``hw = h @ W`` viewed as
``(N, H, C)``; per head ``s_src = sum_c hw a_src`` and ``s_dst = sum_c hw
a_dst``; for each entry ``(i, j)`` (``row[e] = i`` the destination) the
logit ``leaky_relu(s_dst[i] + s_src[j])``, its softmax over row ``i``'s
entries ``alpha``, and the messages ``alpha[e, k] hw[j, k]`` summed into row
``i``: an ``(E, H, C)`` tensor, which only a small graph affords. Hidden
layers concatenate the heads, the last averages them; then the optional
bias and skip (``h @ S + s``), and ``elu`` on hidden layers. Parameters by
the port's names (``weight.i``, ``a_src.i`` and ``a_dst.i`` of shape ``(H,
C)``, ``bias.i``, ``skip_weight.i``, ``skip_bias.i``); differentiable, so
autograd gives the reference's gradients.
"""
from typing import Dict

import torch
from torch.nn import functional as F


def gat_forward(row: torch.Tensor, col: torch.Tensor, num_nodes: int,
                x: torch.Tensor, params: Dict[str, torch.Tensor],
                negative_slope: float = 0.2) -> torch.Tensor:
    """The logits of the GAT that ``params`` describe, over the entries
    ``(row[e], col[e])`` of an ``num_nodes``-square graph (duplicates kept,
    each its own entry)."""
    L = sum(1 for k in params if k.startswith("weight."))
    row, col, n = row.long(), col.long(), num_nodes
    h = x
    for i in range(L):
        a_src, a_dst = params[f"a_src.{i}"], params[f"a_dst.{i}"]
        H, C = a_src.shape
        hw = (h @ params[f"weight.{i}"]).view(n, H, C)
        s_src = (hw * a_src).sum(-1)                     # (N, H)
        s_dst = (hw * a_dst).sum(-1)
        e = F.leaky_relu(s_dst[row] + s_src[col], negative_slope)
        top = torch.full((n, H), float("-inf"), dtype=e.dtype).scatter_reduce(
            0, row[:, None].expand(-1, H), e.detach(), "amax")
        ex = torch.exp(e - top[row])
        den = torch.zeros(n, H, dtype=e.dtype).index_add(0, row, ex)
        alpha = ex / den[row]                            # (E, H)
        o = torch.zeros(n, H, C, dtype=e.dtype).index_add(
            0, row, alpha[..., None] * hw[col])
        z = o.reshape(n, H * C) if i < L - 1 else o.mean(1)
        if f"bias.{i}" in params:
            z = z + params[f"bias.{i}"]
        if f"skip_weight.{i}" in params:
            z = z + h @ params[f"skip_weight.{i}"] + params[f"skip_bias.{i}"]
        h = F.elu(z) if i < L - 1 else z
    return h
