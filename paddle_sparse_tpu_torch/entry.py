"""Toy models of the port: the counterpart of ``__graft_entry__.entry`` and of
the JAX models' train steps (``tests/test_models.py``, ``__graft_entry__.py``).

``entry(device)`` returns ``(model, adj, x)`` for a 2-layer GCN (32 -> 64 -> 8)
on a 256-node synthetic graph; ``model(adj, x)`` under
``torch.inference_mode()`` runs the forward. ``train_entry(device)`` adds the
labels ``y``, and ``train_step(model, adj, x, y, lr)`` takes one SGD step.
``model_entry(kind, device)`` gives ``(model, adj, x, y)`` for any of
``MODELS`` (GCN, GraphSAGE, GIN, APPNP, GAT) on the same graph, set up as
``tests/test_models.py`` sets each up; ``gcn_loss`` and ``train_step`` take
any of them.
``spgemm_entry(device)`` returns the toy adjacency for ``A @ A`` (the
SpGEMM cross-check of ``__graft_entry__.dryrun_multichip``).
``spmm_entry(backend, device)`` plans the toy graph for an SpMM entry point
that holds a plan (``seg2``, ``seg3``, ``seg2split``, ``seg``, ``sell``,
``chunked``), as ``bench.py`` plans its graphs.
``facade_entry(device)`` gives the toy graph as a value-less ``SparseTensor``
with int64 indices, as PyG hands ``adj_t`` over, and its features;
``gcn_norm`` is PyG's normalization of such a tensor on the facade.
``sample_entry(device)`` gives the same graph with its values, and seed
nodes, for neighbour sampling, walks and partitioning.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises instead of carrying on on the
CPU.
"""
import numpy as np
import torch

from .core.matrix import PaddedCOO
from torch import nn

from .models.gcn import (gcn_normalize, init_appnp, init_gat, init_gcn,
                         init_gin, init_sage)
from .ops import spmm_seg
from .ops.spmm import make_spmm_plan
from .ops.spmm_seg2 import make_seg2_plan, pack_values
from .ops.spmm_seg3 import make_seg3_plan
from .ops.spmm_sell import make_sell_plan, pad_values
from .ops.spmm_split import make_split_plan, pack_values_split
from .diag import fill_diag
from .mul import mul
from .reduce import sum as sparsesum
from .tensor import SparseTensor
from .utils import as_device

SPMM_BACKENDS = ("seg2", "seg3", "seg2split", "seg", "sell", "chunked")
MODELS = ("gcn", "sage", "gin", "appnp", "gat")


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


def model_entry(kind: str, device="cuda"):
    """``(model, adj, x, y)`` for the toy ``kind`` model (one of ``MODELS``)
    on ``device``: ``_toy_graph``'s adjacency (256 nodes, 2048 entries,
    values in [0, 1), capacity 2304), features (256, 32) and int64 labels
    of 8 classes, and a 2-layer model 32 -> 64 -> 8 as
    ``tests/test_models.py`` sets each family up: GCN and APPNP (``k=5``,
    ``alpha=0.1``) on the ``gcn_normalize``-d adjacency, GraphSAGE, GIN and
    GAT (2 heads of 16) on the raw one. The weights come from a CPU
    ``torch.Generator`` seeded with 0, so every device gets the same
    model."""
    if kind not in MODELS:
        raise ValueError(f"unknown model {kind!r}; one of {MODELS}")
    device = as_device(device)
    row, col, val, x, y = _toy_graph()
    adj = PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                device=device)
    if kind in ("gcn", "appnp"):
        adj = gcn_normalize(adj)
    gen = torch.Generator().manual_seed(0)
    if kind == "gat":
        model = init_gat(gen, 32, 16, 8, heads=2, device=device)
    elif kind == "appnp":
        model = init_appnp(gen, 32, 64, 8, k=5, device=device)
    else:
        init = {"gcn": init_gcn, "sage": init_sage, "gin": init_gin}[kind]
        model = init(gen, 32, 64, 8, device=device)
    return (model, adj, torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))


def train_entry(device="cuda"):
    """``(model, adj, x, y)`` for the toy GCN on ``device``, ``y`` the int64
    class labels of ``_toy_graph``: ``model_entry("gcn", device)``."""
    return model_entry("gcn", device)


def entry(device="cuda"):
    """``(model, adj, x)`` for the toy GCN on ``device``: ``train_entry``
    without the labels."""
    return train_entry(device)[:3]


def spgemm_entry(device="cuda") -> PaddedCOO:
    """The adjacency of ``_toy_graph`` (256 nodes, 2048 entries, values in
    [0, 1)) on ``device``, padded to capacity 2304 and coalesced, ready for
    ``A @ A``::

        F, cap = plan_spgemm_rows(A, A)
        C = spspmm_rowsorted(A, A, F, cap).matrix
    """
    row, col, val, _, _ = _toy_graph()
    return PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                 device=as_device(device)).coalesce()


def spmm_entry(backend: str, device="cuda"):
    """``(plan, structure, packed, x)`` of the toy graph (256 nodes, 2048
    edges, values in [0, 1), x (256, 32) f32) for ``backend`` in
    ``SPMM_BACKENDS``, on ``device``, as ``bench.py`` builds its operands:
    plan, then lay the values out once (``packed``: the packed vector of
    seg2/seg3/split/seg, the (G, ng) grid of sell, the COO values of
    chunked). Segments of 64 rows give each row 4 spans (the default size
    would give the toy one); the split uses blocks of 64 so that both sides
    hold edges; sell groups 8 slots. Then::

        out = spmm_seg2(plan, structure, packed, x)    # or the backend's
    """
    dev = as_device(device)
    row, col, val, x, _ = _toy_graph()
    row, col = torch.as_tensor(row, device=dev), torch.as_tensor(col,
                                                                 device=dev)
    val, x = torch.as_tensor(val, device=dev), torch.as_tensor(x, device=dev)
    kw = dict(feat_dim=x.shape[1], sr=64)
    if backend == "seg2":
        plan, s = make_seg2_plan(row, col, 256, 256, **kw)
        return plan, s, pack_values(s, val), x
    if backend == "seg3":
        plan, s = make_seg3_plan(row, col, 256, 256, **kw)
        return plan, s, pack_values(s, val), x
    if backend == "seg2split":
        plan, s = make_split_plan(row, col, 256, 256, block=64, **kw)
        return plan, s, pack_values_split(s, val), x
    if backend == "seg":
        plan, s = spmm_seg.make_seg_plan(row, col, 256, 256,
                                         feat_dim=x.shape[1], seg_rows=64)
        return plan, s, spmm_seg.pack_values(s, val), x
    if backend == "sell":
        plan, s = make_sell_plan(row, col, 256, 256, group=8,
                                 feat_dim=x.shape[1])
        return plan, s, pad_values(s, val, group=8), x
    if backend == "chunked":
        plan, s = make_spmm_plan(row, col, 256, 256, x.shape[1])
        return plan, s, val, x
    raise ValueError(f"unknown SpMM backend {backend!r}; one of "
                     f"{SPMM_BACKENDS}")


def facade_entry(device="cuda"):
    """``(adj_t, x)`` on ``device``: ``_toy_graph``'s structure (256 nodes,
    2048 entries, duplicates and self loops included) as a
    ``SparseTensor(row=..., col=..., sparse_sizes=(256, 256))`` with int64
    indices and no value, and its features (256, 32) f32. Then::

        out = gcn_norm(adj_t) @ x
    """
    dev = as_device(device)
    row, col, _, x, _ = _toy_graph()
    adj_t = SparseTensor(row=torch.as_tensor(row, device=dev),
                         col=torch.as_tensor(col, device=dev),
                         sparse_sizes=(256, 256))
    return adj_t, torch.as_tensor(x, device=dev)


def sample_entry(device="cuda"):
    """``(adj, seeds)`` on ``device``: ``_toy_graph``'s structure (256
    nodes, 2048 entries, duplicates and self loops included) as a
    ``SparseTensor`` with int64 indices and its values in [0, 1), and 16
    seed nodes (int64, every 16th node). Then, as PyG's samplers use it::

        sub, n_id = sample_adj(adj, seeds, 5)        # one hop, fanout 5
        walks = random_walk(adj, seeds, 4)
        out, partptr, perm = partition(adj, 4)
    """
    dev = as_device(device)
    row, col, val, _, _ = _toy_graph()
    adj = SparseTensor(row=torch.as_tensor(row, device=dev),
                       col=torch.as_tensor(col, device=dev),
                       value=torch.as_tensor(val, device=dev),
                       sparse_sizes=(256, 256))
    return adj, torch.arange(0, 256, 16, device=dev)


def gcn_norm(adj_t: SparseTensor) -> SparseTensor:
    """PyG's ``gcn_norm`` of a ``SparseTensor`` with self loops of weight 1:
    ``D^-1/2 (A + I) D^-1/2`` with ``D`` the row sums of ``A + I`` (existing
    diagonal entries replaced), 0 where a degree is 0."""
    adj_t = fill_diag(adj_t, 1.0)
    deg = sparsesum(adj_t, dim=1)
    dis = deg.pow(-0.5)
    dis = dis.masked_fill(torch.isinf(dis), 0.0)
    adj_t = mul(adj_t, dis.view(-1, 1))
    return mul(adj_t, dis.view(1, -1))


def gcn_loss(model: nn.Module, adj: PaddedCOO, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax(model(adj, x))`` at the
    labels ``y``, over all nodes, for any model of ``MODELS``."""
    logp = torch.log_softmax(model(adj, x), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def train_step(model: nn.Module, adj: PaddedCOO, x: torch.Tensor,
               y: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGD step of :func:`gcn_loss` in place, ``p -= lr * grad`` for
    every parameter of ``model`` (any of ``MODELS``); returns the loss
    before the step (detached). Gradients of ``adj.value``, if it requires
    them, accumulate in ``adj.value.grad``."""
    model.zero_grad(set_to_none=True)
    loss = gcn_loss(model, adj, x, y)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    return loss.detach()
