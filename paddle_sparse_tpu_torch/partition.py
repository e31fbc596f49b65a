"""Graph partitioning and bandwidth-reducing reordering (port of
``paddle_sparse_tpu/partition.py``; upstream-only APIs, METIS-bound there).

Both are structural preprocessing, run once per graph on the host: the C++
host runtime (:mod:`.runtime`) computes them from the storage's cached host
CSR (``SparseStorage.host_csr``), and a failed build raises. The numpy
versions of the JAX package are kept as the plain references,
:func:`partition_clusters_reference` and
:func:`reverse_cuthill_mckee_reference`: the same algorithms, though numpy's
unstable ``argsort`` may take partition seeds of equal degree in another
order than the native stable sort.

* :func:`partition`: BFS region growing seeded from high-degree nodes and
  one greedy refinement sweep, with upstream's METIS contract
  ``(permuted_adj, partptr, perm)``.
* :func:`reverse_cuthill_mckee`: BFS from low-degree roots, neighbours in
  increasing-degree order, order reversed.
"""
from collections import deque
from typing import Optional, Tuple

import numpy as np
import torch

from . import runtime
from .tensor import SparseTensor


def _square(src: SparseTensor) -> int:
    if not src.is_quadratic():
        raise ValueError(f"expects a square matrix, got {src.sparse_sizes()}")
    return src.sparse_size(0)


def _host(a) -> np.ndarray:
    return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)


def partition_clusters(src: SparseTensor, num_parts: int,
                       rng: Optional[np.random.Generator] = None
                       ) -> np.ndarray:
    """A cluster id in ``[0, num_parts)`` per node (int64 numpy), near-equal
    sizes with locality, from the C++ host runtime. ``rng`` is accepted for
    the JAX package's signature: the partitioner draws nothing."""
    N = _square(src)
    if num_parts <= 1:
        return np.zeros(N, dtype=np.int64)
    rowptr, col = src.storage.host_csr()
    return runtime.partition_clusters(rowptr, col, num_parts)


def partition_clusters_reference(src: SparseTensor,
                                 num_parts: int) -> np.ndarray:
    """The plain numpy version of :func:`partition_clusters` (the JAX
    package's, unchanged)."""
    N = _square(src)
    if num_parts <= 1:
        return np.zeros(N, dtype=np.int64)
    rowptr, col = src.storage.host_csr()
    deg = rowptr[1:] - rowptr[:-1]

    target = (N + num_parts - 1) // num_parts
    cluster = np.full(N, -1, dtype=np.int64)
    sizes = np.zeros(num_parts, dtype=np.int64)

    order = np.argsort(-deg)                     # seed from hubs outward
    seed_iter = iter(order)
    for p in range(num_parts):
        seed = next((s for s in seed_iter if cluster[s] < 0), None)
        if seed is None:
            break
        frontier = deque([seed])
        while frontier and sizes[p] < target:
            v = frontier.popleft()
            if cluster[v] >= 0:
                continue
            cluster[v] = p
            sizes[p] += 1
            for e in range(rowptr[v], rowptr[v + 1]):
                u = col[e]
                if cluster[u] < 0:
                    frontier.append(u)

    # leftover nodes -> smallest cluster (disconnected components etc.)
    for v in np.nonzero(cluster < 0)[0]:
        p = int(np.argmin(sizes))
        cluster[v] = p
        sizes[p] += 1

    # one greedy refinement sweep: move boundary nodes to the neighbour-
    # majority cluster when it does not unbalance (> target + 1)
    for v in range(N):
        if rowptr[v] == rowptr[v + 1]:
            continue
        neigh = cluster[col[rowptr[v]:rowptr[v + 1]]]
        counts = np.bincount(neigh, minlength=num_parts)
        best = int(np.argmax(counts))
        cur = cluster[v]
        if best != cur and counts[best] > counts[cur] and \
                sizes[best] < target + 1:
            cluster[v] = best
            sizes[best] += 1
            sizes[cur] -= 1
    return cluster


def partition(src: SparseTensor, num_parts: int, recursive: bool = False,
              ) -> Tuple[SparseTensor, torch.Tensor, torch.Tensor]:
    """Cluster and permute ``src`` so each part's rows are contiguous.

    Returns ``(out, partptr, perm)`` on ``src``'s device, upstream's METIS
    contract: ``out = src.permute(perm)``, ``partptr`` delimits the parts in
    the permuted order. ``recursive`` is accepted for the signature (the
    region grower is not recursive)."""
    cluster = partition_clusters(src, num_parts)
    perm_np = np.argsort(cluster, kind="stable")
    sizes = np.bincount(cluster, minlength=max(num_parts, 1))
    partptr_np = np.concatenate([[0], np.cumsum(sizes)])
    col = src.storage.col()
    perm = torch.from_numpy(perm_np).to(col.device, col.dtype)
    partptr = torch.from_numpy(partptr_np).to(col.device, col.dtype)
    return src.permute(perm), partptr, perm


def edge_cut_fraction(src: SparseTensor, cluster) -> float:
    """Fraction of edges crossing parts under ``cluster`` (one id per node,
    numpy or tensor): the METIS objective. A random assignment's expected
    cut is :func:`random_cut_fraction`. Counted on ``src``'s device."""
    row, col, _ = src.coo()
    if row.numel() == 0:
        return 0.0
    c = torch.as_tensor(_host(cluster)).to(row.device)
    return int((c[row] != c[col]).sum()) / row.numel()


def random_cut_fraction(cluster) -> float:
    """Expected edge cut of a size-matched uniformly random partition."""
    cluster = _host(cluster)
    sizes = np.bincount(cluster).astype(np.float64)
    frac = sizes / max(1, cluster.size)
    return float(1.0 - (frac ** 2).sum())


def _symmetric(src: SparseTensor, symmetric: Optional[bool]) -> SparseTensor:
    _square(src)
    return src if (symmetric or src.is_symmetric()) else src.to_symmetric()


def reverse_cuthill_mckee(src: SparseTensor,
                          symmetric: Optional[bool] = None) -> torch.Tensor:
    """RCM permutation minimizing bandwidth, on ``src``'s device:
    ``src.permute(perm)`` has a small bandwidth. The structure is made
    symmetric first unless ``symmetric`` says it is."""
    adj = _symmetric(src, symmetric)
    rowptr, col = adj.storage.host_csr()
    perm = runtime.rcm(rowptr, col)
    idx = src.storage.col()
    return torch.from_numpy(perm).to(idx.device, idx.dtype)


def reverse_cuthill_mckee_reference(src: SparseTensor,
                                    symmetric: Optional[bool] = None
                                    ) -> torch.Tensor:
    """The plain numpy version of :func:`reverse_cuthill_mckee` (the JAX
    package's, unchanged)."""
    adj = _symmetric(src, symmetric)
    rowptr, col = adj.storage.host_csr()
    N = adj.sparse_size(0)
    deg = rowptr[1:] - rowptr[:-1]

    visited = np.zeros(N, dtype=bool)
    order = np.empty(N, dtype=np.int64)
    pos = 0
    # components from lowest-degree roots (pseudo-peripheral heuristic)
    for root in np.argsort(deg, kind="stable"):
        if visited[root]:
            continue
        visited[root] = True
        queue = deque([root])
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            neigh = col[rowptr[v]:rowptr[v + 1]]
            neigh = neigh[~visited[neigh]]
            neigh = neigh[np.argsort(deg[neigh], kind="stable")]
            visited[neigh] = True
            queue.extend(neigh.tolist())
    idx = src.storage.col()
    return torch.from_numpy(order[::-1].copy()).to(idx.device, idx.dtype)


SparseTensor.partition = partition
SparseTensor.reverse_cuthill_mckee = reverse_cuthill_mckee
