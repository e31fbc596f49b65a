"""Plain PyTorch GAT forward (Velickovic et al., arXiv:1710.10903) as PyG's
ogbn-products example stacks ``GATConv``: every hidden layer's heads
concatenated, the last layer's averaged, a bias after each layer's heads
and a linear skip from its input (``bench_port/models/gat.py`` gives the
equations and the parameters' names).

The edge work runs in the CSR order of the reference's adjacency
(``sparse.Adjacency.csr``), over blocks of entries so that no gathered
``(entries, H)`` temporary exceeds ``adj.block_bytes``: the logits, each
row's max (``scatter_reduce``), ``exp`` of the shifted logits, each row's
sum (``index_add``) and the division, kept as one ``(nnz, H)`` tensor. Each
head then aggregates as ``torch.sparse.mm`` over a CSR with A's structure
whose values are that head's attention weights. Sums run in the dtype of
the operands (float64 for the reference, float32 for the control); the
GEMMs through ``mm``. Nothing here imports the program.
"""
from typing import Dict

import torch
from torch.nn import functional as F

from .sparse import Adjacency

SLOPE = 0.2               # leaky_relu's negative slope (PyG's default)


def _layers(params):
    return sum(1 for k in params if k.startswith("weight."))


def _blocks(nnz: int, width: int, itemsize: int, block_bytes: int):
    step = max(1, block_bytes // max(1, width * itemsize))
    return [slice(a, min(a + step, nnz)) for a in range(0, nnz, step)]


def attention(adj: Adjacency, s_src: torch.Tensor, s_dst: torch.Tensor
              ) -> torch.Tensor:
    """``(nnz, H)`` attention weights in ``adj.csr``'s entry order: the
    softmax over each row's entries of ``leaky_relu(s_dst[row] +
    s_src[col])``."""
    crow, col = adj.csr.crow_indices(), adj.csr.col_indices()
    n, H = s_src.shape
    row = torch.repeat_interleave(
        torch.arange(n, device=crow.device), crow.diff())
    nnz = row.numel()
    blocks = _blocks(nnz, H, s_src.element_size(), adj.block_bytes)
    e = torch.empty(nnz, H, dtype=s_src.dtype, device=s_src.device)
    top = torch.full((n, H), float("-inf"), dtype=s_src.dtype,
                     device=s_src.device)
    for b in blocks:
        e[b] = F.leaky_relu(s_dst[row[b]] + s_src[col[b]], SLOPE)
        top.scatter_reduce_(0, row[b, None].expand(-1, H), e[b], "amax")
    den = torch.zeros_like(top)
    for b in blocks:
        e[b] = torch.exp(e[b] - top[row[b]])
        den.index_add_(0, row[b], e[b])
    for b in blocks:
        e[b] /= den[row[b]]
    return e


def forward(adj: Adjacency, x, params: Dict[str, torch.Tensor], mm):
    """The logits (the last layer's output, before ``log_softmax``)."""
    L = _layers(params)
    n = adj.num_nodes
    crow, col = adj.csr.crow_indices(), adj.csr.col_indices()
    h = x
    for i in range(L):
        a_src = params[f"att_src.{i}"].t()               # (H, C)
        a_dst = params[f"att_dst.{i}"].t()
        H, C = a_src.shape
        hw = mm(h, params[f"weight.{i}"]).view(n, H, C)
        att = attention(adj, (hw * a_src).sum(-1), (hw * a_dst).sum(-1))
        z = mm(h, params[f"skip_weight.{i}"])
        z += params[f"skip_bias.{i}"] + params[f"bias.{i}"]
        del h
        for k in range(H):
            a_k = torch.sparse_csr_tensor(crow, col, att[:, k].contiguous(),
                                          (n, n), check_invariants=False)
            o = torch.sparse.mm(a_k, hw[:, k].contiguous())
            if i < L - 1:
                z[:, k * C:(k + 1) * C] += o
            else:
                z += o / H
            del a_k, o
        del att, hw
        h = F.elu(z) if i < L - 1 else z
        del z
    return h
