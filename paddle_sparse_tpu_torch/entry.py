"""Toy GCN of the port: the counterpart of ``__graft_entry__.entry`` and of
the JAX GCN train step (``tests/test_models.py``, ``__graft_entry__.py``).

``entry(device)`` returns ``(model, adj, x)`` for a 2-layer GCN (32 -> 64 -> 8)
on a 256-node synthetic graph; ``model(adj, x)`` under
``torch.inference_mode()`` runs the forward. ``train_entry(device)`` adds the
labels ``y``, and ``train_step(model, adj, x, y, lr)`` takes one SGD step.
``spgemm_entry(device)`` returns the toy adjacency for ``A @ A`` (the
SpGEMM cross-check of ``__graft_entry__.dryrun_multichip``).
``spmm_entry(backend, device)`` plans the toy graph for a packed-layout SpMM
backend (``seg2``, ``seg3``, ``seg2split``), as ``bench.py`` plans its graphs.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises instead of carrying on on the
CPU.
"""
import numpy as np
import torch

from .core.matrix import PaddedCOO
from .models.gcn import GCN, gcn_normalize, init_gcn
from .ops.spmm_seg2 import make_seg2_plan, pack_values
from .ops.spmm_seg3 import make_seg3_plan
from .ops.spmm_split import make_split_plan, pack_values_split

SPMM_BACKENDS = ("seg2", "seg3", "seg2split")


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


def _device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            f"(torch.cuda.is_available() is False); pass device='cpu' to run "
            f"the plain path on the CPU")
    return dev


def train_entry(device="cuda"):
    """``(model, adj, x, y)`` for the toy GCN on ``device``, ``y`` the int64
    class labels of ``_toy_graph``. The weights come from a CPU
    ``torch.Generator`` seeded with 0, so every device gets the same model."""
    device = _device(device)
    row, col, val, x, y = _toy_graph()
    adj = PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                device=device)
    adj = gcn_normalize(adj)
    model = init_gcn(torch.Generator().manual_seed(0), 32, 64, 8,
                     device=device)
    return (model, adj, torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))


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
                                 device=_device(device)).coalesce()


def spmm_entry(backend: str, device="cuda"):
    """``(plan, structure, packed, x)`` of the toy graph (256 nodes, 2048
    edges, values in [0, 1), x (256, 32) f32) for ``backend`` in
    ``SPMM_BACKENDS``, on ``device``, as ``bench.py`` builds its operands:
    plan, then pack the values once. Segments of 64 rows give each row 4
    spans (the default size would give the toy one); the split uses blocks
    of 64 so that both sides hold edges. Then::

        out = spmm_seg2(plan, structure, packed, x)    # or seg3 / split
    """
    dev = _device(device)
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
    raise ValueError(f"unknown SpMM backend {backend!r}; one of "
                     f"{SPMM_BACKENDS}")


def gcn_loss(model: GCN, adj: PaddedCOO, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax(model(adj, x))`` at the
    labels ``y``, over all nodes."""
    logp = torch.log_softmax(model(adj, x), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def train_step(model: GCN, adj: PaddedCOO, x: torch.Tensor, y: torch.Tensor,
               lr: float) -> torch.Tensor:
    """One SGD step in place, ``p -= lr * grad`` for every parameter of
    ``model``; returns the loss before the step (detached). Gradients of
    ``adj.value``, if it requires them, accumulate in ``adj.value.grad``."""
    model.zero_grad(set_to_none=True)
    loss = gcn_loss(model, adj, x, y)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    return loss.detach()
