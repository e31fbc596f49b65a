"""Neighbour sampling and random walks on a CSR structure, on its device.

Port of ``paddle_sparse_tpu/ops/sample.py``. Plain torch: the JAX package
leaves these to XLA, and so the port leaves them to PyTorch's own ops on the
card.

* :func:`sample_neighbors`: ``num_neighbors`` uniform draws per row, with
  replacement.
* :func:`sample_adj_padded`: a GraphSAGE-style sampled subgraph of static
  capacity ``len(subset) * num_neighbors``, with or without replacement,
  relabelled by sorting (``n_id`` is the seeds, then the other nodes in
  ascending order, padded with ``2**31 - 1``).
* :func:`random_walk`: uniform walks; a node of degree 0 repeats itself.

Each public function draws its uniforms from the ``generator`` it is given
(by default the facade's generator on the structure's device,
:func:`~..random.generator`) and hands them to a private function that takes
the uniforms. Fed the uniforms ``jax.random.uniform`` draws from a key, the
private functions give the JAX functions' outputs exactly.

Where the port differs, on purpose:

* without replacement, JAX draws one priority per edge of the whole graph and
  lexsorts all of them; the port draws priorities only for the edges of the
  subset's rows and sorts those (the same uniform draw without replacement;
  ties break by edge position in both);
* the draw offset ``floor(u * deg)`` is clamped to ``deg - 1``: JAX converts
  ``deg`` to f32, which rounds some degrees above ``2**24`` up, so an offset
  could reach ``deg`` and read the next row's edge (:func:`draw_offsets`);
* JAX's out-of-range gathers clamp and its ``mode="drop"`` scatter drops; on
  the card an out-of-range index is a fault, so every gather here is clamped
  or masked first.
"""
from typing import NamedTuple, Optional

import torch

from .. import random as _random

# n_id's padding, as the JAX function's int32 sentinel
SENTINEL = 2 ** 31 - 1


def _uniform(shape, generator, device) -> torch.Tensor:
    """f32 uniforms in [0, 1) from ``generator`` (default: the facade's
    generator on ``device``)."""
    if generator is None:
        generator = _random.generator(device)
    return torch.rand(shape, generator=generator, device=device)


def draw_offsets(u: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """``floor(u * deg)`` in ``deg``'s dtype, ``deg`` converted to ``u``'s
    dtype, clamped to ``deg - 1`` where ``deg > 0`` (0 where it is 0). ``u``
    broadcasts against ``deg``."""
    off = torch.floor(u * deg.to(u.dtype)).to(deg.dtype)
    return torch.minimum(off, (deg - 1).clamp_min(0))


def _gather_clamped(col: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``col[clip(pos, 0, nnz - 1)]``, as JAX's clamped gather reads it."""
    if col.numel() == 0:
        raise ValueError("the structure has no entries to draw from")
    return col[pos.clamp(0, col.numel() - 1)]


def _rows(rowptr, subset):
    if subset is None:
        return rowptr[:-1], rowptr[1:] - rowptr[:-1]
    subset = torch.as_tensor(subset, device=rowptr.device).long()
    starts = rowptr[subset]
    return starts, rowptr[subset + 1] - starts


def _sample_neighbors(rowptr: torch.Tensor, col: torch.Tensor,
                      u: torch.Tensor, subset=None) -> torch.Tensor:
    """:func:`sample_neighbors` given its uniforms ``u`` (rows, F)."""
    starts, deg = _rows(rowptr, subset)
    offs = draw_offsets(u, deg[:, None])
    return _gather_clamped(col, starts[:, None] + offs)


def sample_neighbors(rowptr: torch.Tensor, col: torch.Tensor,
                     generator: Optional[torch.Generator],
                     num_neighbors: int, subset=None) -> torch.Tensor:
    """For each row (of ``subset``, or every row), ``num_neighbors`` uniform
    neighbours drawn with replacement: (rows, num_neighbors) cols. A row of
    degree 0 returns ``col[rowptr[r]]`` (clamped into ``col``), as the
    reference does: callers mask by the row count."""
    n = rowptr.numel() - 1 if subset is None else len(subset)
    u = _uniform((n, num_neighbors), generator, rowptr.device)
    return _sample_neighbors(rowptr, col, u, subset)


class PaddedAdj(NamedTuple):
    """Static-shape sampled subgraph (capacity = num_seeds * fanout)."""
    rowptr: torch.Tensor     # (num_seeds + 1,)
    col: torch.Tensor        # (capacity,) local node ids; -1 on padding
    e_id: torch.Tensor       # (capacity,) source edge positions; 0 on padding
    n_id: torch.Tensor       # (num_seeds + capacity,) global ids; SENTINEL
    num_nodes: torch.Tensor  # () valid prefix length of n_id
    num_edges: torch.Tensor  # () number of valid edges
    edge_mask: torch.Tensor  # (capacity,) bool validity


def _subset_edges(rowptr, subset):
    """The edges of the subset's rows, row after row: ``(seed, edge, ptr)``
    with ``seed[k]`` the subset index of edge ``edge[k]`` and ``ptr`` (S+1)
    the pointer of each seed's run."""
    starts = rowptr[subset]
    deg = rowptr[subset + 1] - starts
    ptr = torch.zeros(subset.numel() + 1, dtype=torch.int64,
                      device=rowptr.device)
    torch.cumsum(deg, 0, out=ptr[1:])
    total = int(ptr[-1])
    seed = torch.repeat_interleave(
        torch.arange(subset.numel(), device=rowptr.device), deg.long(),
        output_size=total)
    edge = starts[seed].long() + torch.arange(total, device=rowptr.device) \
        - ptr[seed]
    return seed, edge, ptr


def _lookup_in_sorted(table: torch.Tensor,
                      queries: torch.Tensor) -> torch.Tensor:
    """Position of each query in ``table`` (unique entries), else -1."""
    order = torch.argsort(table, stable=True)
    sorted_t = table[order]
    pos = torch.searchsorted(sorted_t, queries.to(sorted_t.dtype))
    pos = pos.clamp(0, table.numel() - 1)
    return torch.where(sorted_t[pos] == queries, order[pos], -1)


def _sample_adj_padded(rowptr: torch.Tensor, col: torch.Tensor,
                       subset: torch.Tensor, num_neighbors: int,
                       replace: bool, u: torch.Tensor) -> PaddedAdj:
    """:func:`sample_adj_padded` given its uniforms: (S, F) draws with
    ``replace``, else one priority per edge of the subset's rows, row after
    row in subset order (``sum(deg)``,)."""
    dev = col.device
    subset = torch.as_tensor(subset, device=dev).long()
    S, F = subset.numel(), int(num_neighbors)
    cap = S * F
    idx_dtype = col.dtype
    starts = rowptr[subset].long()
    deg = rowptr[subset + 1].long() - starts
    slot = torch.arange(F, device=dev)

    if replace:
        counts = torch.where(deg > 0, F, 0)
        gather_pos = starts[:, None] + draw_offsets(u, deg[:, None])
    else:
        # the first min(deg, F) edges of each row by priority; a stable sort
        # by priority, then by seed, breaks ties by edge position
        seed, edge, ptr = _subset_edges(rowptr, subset)
        order = torch.argsort(u, stable=True)
        order = order[torch.argsort(seed[order], stable=True)]
        by_prio = edge[order]
        counts = deg.clamp(max=F)
        pos = (ptr[:-1, None] + slot[None, :]).clamp(
            max=max(by_prio.numel() - 1, 0))
        gather_pos = (by_prio[pos] if by_prio.numel()
                      else torch.zeros_like(pos))

    valid = slot[None, :] < counts[:, None]
    flat_valid = valid.reshape(-1)
    e_id = torch.where(flat_valid, gather_pos.reshape(-1), 0)
    src = col if col.numel() else col.new_zeros(1)    # no valid entry then
    flat_nodes = torch.where(
        flat_valid, src[e_id.clamp(0, src.numel() - 1)].long(), -1)
    seed_of = torch.arange(S, device=dev).repeat_interleave(F)

    # ---- sort-based relabel -------------------------------------------
    in_subset_pos = _lookup_in_sorted(subset, flat_nodes)
    is_seed = in_subset_pos >= 0
    cand = torch.where(flat_valid & ~is_seed, flat_nodes, SENTINEL)
    sorted_cand = torch.sort(cand).values
    uniq = torch.cat([sorted_cand[:1] != SENTINEL,
                      (sorted_cand[1:] != sorted_cand[:-1])
                      & (sorted_cand[1:] != SENTINEL)])
    new_nodes = sorted_cand[uniq]          # masked select: JAX's drop scatter
    num_new = new_nodes.numel()
    compact = torch.full((cap,), SENTINEL, dtype=torch.int64, device=dev)
    compact[:num_new] = new_nodes

    n_id = torch.cat([subset, compact])
    pos_in_compact = torch.searchsorted(compact, flat_nodes)
    local = torch.where(is_seed, in_subset_pos, S + pos_in_compact)
    local = torch.where(flat_valid, local, -1)

    # ---- valid entries to the front, sorted by (seed, local) ----------
    big = 2 * (cap + S) + 2
    sort_key = torch.where(flat_valid, seed_of * big + local, big * (S + 1))
    order = torch.argsort(sort_key, stable=True)
    edge_mask = flat_valid[order]
    e_id = torch.where(edge_mask, e_id[order], 0)
    out_rowptr = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=out_rowptr[1:])
    return PaddedAdj(rowptr=out_rowptr.to(idx_dtype),
                     col=local[order].to(idx_dtype),
                     e_id=e_id.to(idx_dtype), n_id=n_id.to(idx_dtype),
                     num_nodes=torch.tensor(S + num_new, dtype=idx_dtype,
                                            device=dev),
                     num_edges=out_rowptr[-1].to(idx_dtype),
                     edge_mask=edge_mask)


def sample_adj_padded(rowptr: torch.Tensor, col: torch.Tensor,
                      subset: torch.Tensor, num_neighbors: int,
                      replace: bool,
                      generator: Optional[torch.Generator]) -> PaddedAdj:
    """Sampled subgraph of the ``subset`` rows, ``num_neighbors`` per row:
    with ``replace`` that many uniform draws (none on a row of degree 0),
    else ``min(deg, num_neighbors)`` distinct edges, uniformly. The output
    rows are the subset's, in order, each row's local ids ascending; see
    :class:`PaddedAdj`. ``subset`` must hold distinct rows."""
    subset = torch.as_tensor(subset, device=col.device).long()
    if replace:
        shape = (subset.numel(), int(num_neighbors))
    else:
        shape = (int((rowptr[subset + 1] - rowptr[subset]).sum()),)
    u = _uniform(shape, generator, col.device)
    return _sample_adj_padded(rowptr, col, subset, num_neighbors, replace, u)


def _random_walk(rowptr: torch.Tensor, col: torch.Tensor,
                 start: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`random_walk` given its uniforms ``u`` (walk_length, n)."""
    start = torch.as_tensor(start, device=col.device)
    cur = start.long()
    steps = [cur]
    for u_t in u:
        lo = rowptr[cur].long()
        deg = rowptr[cur + 1].long() - lo
        nxt = _gather_clamped(col, lo + draw_offsets(u_t, deg)).long()
        cur = torch.where(deg > 0, nxt, cur)
        steps.append(cur)
    return torch.stack(steps, dim=1).to(start.dtype)


def random_walk(rowptr: torch.Tensor, col: torch.Tensor, start: torch.Tensor,
                walk_length: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """Uniform random walks: (num_start, walk_length + 1) node ids, starting
    with ``start``. A node of degree 0 repeats itself (upstream
    ``torch_sparse.random_walk`` semantics)."""
    start = torch.as_tensor(start, device=col.device)
    u = _uniform((walk_length, start.numel()), generator, col.device)
    return _random_walk(rowptr, col, start, u)
