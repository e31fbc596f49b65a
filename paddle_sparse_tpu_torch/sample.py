"""Neighbour sampling on the facade (port of ``paddle_sparse_tpu/sample.py``,
the reference's ``paddle_sparse/sample.py`` plus upstream's
``saint_subgraph``).

* :func:`sample`: the vectorized uniform draw with replacement, on the
  tensor's device.
* :func:`sample_adj`: the host sampler of minibatch GNN training (PyG's
  ``NeighborSampler``): the C++ host runtime (:mod:`.runtime`) by default,
  seeded from the facade's CPU generator; the pure-Python sampler, the plain
  reference, when an ``rng`` (``numpy.random.Generator``) is given. Both keep
  the reference C++ sampler's contract: ``n_id`` in first-seen order, each
  row's local columns sorted. The host copy of ``rowptr``/``col`` is cached
  on the storage (``SparseStorage.host_csr``), once per structure.
* :func:`saint_subgraph`: the induced subgraph on a node set (GraphSAINT).

The fixed-fanout sampler on the device is ``ops.sample.sample_adj_padded``.
"""
from typing import Optional, Tuple

import numpy as np
import torch

from . import random as _random
from . import runtime
from .ops.sample import _sample_neighbors, _uniform
from .tensor import SparseTensor


def sample(src: SparseTensor, num_neighbors: int, subset=None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform with-replacement neighbour draw: (rows, num_neighbors) cols,
    from ``generator`` (default: the facade's generator on ``src``'s
    device). A row of degree 0 returns ``col[rowptr[r]]``, clamped into
    ``col`` as JAX's gather clamps it."""
    rowptr, col, _ = src.csr()
    n = src.sparse_size(0) if subset is None else len(subset)
    u = _uniform((n, num_neighbors), generator, col.device)
    return _sample_neighbors(rowptr, col, u, subset)


def _seed_from(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator))


def _sample_python(rowptr_np, col_np, subset_np, num_neighbors, replace,
                   rng: np.random.Generator):
    """The pure-Python sampler (the JAX package's, unchanged): ``(rowptr,
    col, e_id, n_id)`` int64 arrays."""
    n_id_map = {int(n): i for i, n in enumerate(subset_np)}
    n_ids = list(subset_np.tolist())
    out_rowptr = [0]
    out_cols: list = []
    out_eids: list = []

    for n in subset_np:
        lo, hi = int(rowptr_np[n]), int(rowptr_np[n + 1])
        deg = hi - lo
        if num_neighbors < 0:                      # full neighborhood
            picks = range(lo, hi)
        elif deg == 0:
            picks = ()
        elif replace:
            picks = (lo + rng.integers(0, deg, size=num_neighbors)).tolist()
        else:
            k = min(deg, num_neighbors)
            picks = (lo + rng.choice(deg, size=k, replace=False)).tolist()

        local = []
        for e in picks:
            c = int(col_np[e])
            if c not in n_id_map:
                n_id_map[c] = len(n_ids)
                n_ids.append(c)
            local.append((n_id_map[c], int(e)))
        local.sort()                                # per-row sorted cols
        out_cols.extend(c for c, _ in local)
        out_eids.extend(e for _, e in local)
        out_rowptr.append(len(out_cols))

    return (np.asarray(out_rowptr, np.int64),
            np.asarray(out_cols, np.int64), np.asarray(out_eids, np.int64),
            np.asarray(n_ids, np.int64))


def sample_adj(src: SparseTensor, subset, num_neighbors: int,
               replace: bool = False,
               rng: Optional[np.random.Generator] = None,
               ) -> Tuple[SparseTensor, torch.Tensor]:
    """GraphSAGE-style sampled subgraph around the ``subset`` seed rows:
    ``num_neighbors`` per row (all of them when negative), with or without
    ``replace``.

    Returns ``(adj, n_id)`` on ``src``'s device: ``adj`` is (len(subset),
    len(n_id)) with the sampled edges' values, and ``n_id`` maps local ->
    global node ids (seeds first, then neighbours in first-seen order).
    Without ``rng`` the C++ host runtime samples, seeded from the facade's
    generator (a failed build raises); with one, the pure-Python sampler."""
    rowptr_np, col_np = src.storage.host_csr()
    subset_np = np.asarray(torch.as_tensor(subset).cpu(), np.int64)
    if rng is None:
        out = runtime.sample_adj(rowptr_np, col_np, subset_np,
                                 num_neighbors, replace,
                                 _seed_from(_random.generator()))
    else:
        out = _sample_python(rowptr_np, col_np, subset_np, num_neighbors,
                             replace, rng)
    col = src.storage.col()
    r_ptr, r_col, r_eid, r_nid = (torch.from_numpy(a).to(col.device,
                                                         col.dtype)
                                  for a in out)
    value = src.storage.value()
    if value is not None:
        value = value[r_eid.long()]
    adj = SparseTensor(rowptr=r_ptr, col=r_col, value=value,
                       sparse_sizes=(len(subset_np), len(r_nid)),
                       is_sorted=True, trust_data=True)
    return adj, r_nid


def saint_subgraph(src: SparseTensor, node_idx
                   ) -> Tuple[SparseTensor, torch.Tensor]:
    """Induced subgraph on ``node_idx`` (GraphSAINT; upstream-only API).
    Returns ``(adj, e_id)`` with the original edge values and the source
    positions of the kept edges."""
    col = src.storage.col()
    node_idx = torch.as_tensor(node_idx, device=col.device)
    tracker = src.set_value(
        torch.arange(src.nnz(), dtype=col.dtype, device=col.device),
        layout="coo")
    sub = tracker.index_select(0, node_idx).index_select(1, node_idx)
    e_id = sub.storage.value()
    value = src.storage.value()
    if value is not None:
        sub = sub.set_value(value[e_id.long()], layout="coo")
    else:
        sub = sub.set_value(None, layout="coo")
    return sub, e_id


SparseTensor.sample = sample
SparseTensor.sample_adj = sample_adj
SparseTensor.saint_subgraph = saint_subgraph
