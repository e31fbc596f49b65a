"""Toy GCN forward of the port: the counterpart of ``__graft_entry__.entry``.

``entry(device)`` returns ``(model, adj, x)`` for a 2-layer GCN (32 -> 64 -> 8)
on a 256-node synthetic graph; ``model(adj, x)`` under
``torch.inference_mode()`` runs the forward.
"""
import numpy as np
import torch

from .core.matrix import PaddedCOO
from .models.gcn import gcn_normalize, init_gcn


def _toy_graph(num_nodes=256, avg_deg=8, feat=32, classes=8, seed=0):
    """Synthetic row-sorted graph + features (host-side numpy); the same
    arrays as ``__graft_entry__._toy_graph`` for the same arguments."""
    rng = np.random.default_rng(seed)
    nnz = num_nodes * avg_deg
    row = np.sort(rng.integers(0, num_nodes, nnz))
    col = rng.integers(0, num_nodes, nnz)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = rng.random(nnz).astype(np.float32)
    x = rng.standard_normal((num_nodes, feat)).astype(np.float32)
    y = rng.integers(0, classes, num_nodes)
    return row, col, val, x, y


def entry(device="cpu"):
    """``(model, adj, x)`` for the toy GCN on ``device``. The weights come
    from a CPU ``torch.Generator`` seeded with 0, so every device gets the
    same model."""
    row, col, val, x, _ = _toy_graph()
    adj = PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                device=device)
    adj = gcn_normalize(adj)
    model = init_gcn(torch.Generator().manual_seed(0), 32, 64, 8,
                     device=device)
    return model, adj, torch.as_tensor(x, device=device)
