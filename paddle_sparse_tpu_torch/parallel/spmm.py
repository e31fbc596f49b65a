"""Row-partitioned distributed SpMM over ``torch.distributed``.

Port of ``paddle_sparse_tpu/parallel/spmm.py``. The sparse operand is 1-D
row-sharded: each rank owns a contiguous block of output rows and the
entries that produce them; the dense operand is row-sharded the same way
(its rows are A's columns). The interchanges:

* :func:`spmm_allgather`: one all-gather of ``x``, then the local SpMM;
  :class:`RowShardedAdjacency` is the same as an adjacency whose ``spmm``
  a model calls;
* :func:`spmm_ring`: ``x`` blocks travel around a ring of ranks while each
  rank sums the partial product of the block it holds (masked);
  :func:`spmm_ring_bucketed` reads only the bucket of that block;
* :func:`spmm_halo`: an all-to-all of exactly the ``x`` rows each rank needs.

The ``shard_*`` functions run once, on the tensors' device, in O(nnz)
torch ops, and return the JAX package's stacked ``(D, ...)`` layouts array
for array; ``device_put_*`` takes one rank's block of them to its device. The
kernels take a rank's block, its ``x`` block and a mesh, and return its
output block. Every local SpMM is ``ops/spmm.py::spmm_coo`` with ``num_rows
= rows_per_shard``: padding entries (row ``rows_per_shard``, col ``N`` or 0,
value 0) are left out, never read, and get ``d value`` 0. Differentiable in
``value`` and ``x``: each collective's backward is its transpose
(``parallel/collectives.py``).
"""
from typing import NamedTuple, Tuple

import torch

from ..core.matrix import PaddedCOO
from ..ops.spmm import spmm_coo
from .collectives import all_gather, all_to_all, ring_shift
from .mesh import axis_rank


class RowShardedMatrix(NamedTuple):
    """Stacked per-rank row blocks of a global (M, N) sparse matrix.

    Leading axis = rank. ``row`` holds *local* row ids in [0, rows_per_shard]
    (padding = rows_per_shard); ``col`` holds *global* column ids. A rank's
    block (:func:`device_put_sharded_matrix`) has the same fields without the
    leading axis.
    """
    row: torch.Tensor     # (D, C) local row ids
    col: torch.Tensor     # (D, C) global col ids; padding = N
    value: torch.Tensor   # (D, C)
    nnz: torch.Tensor     # (D,)
    shape: Tuple[int, int]          # global (M, N)
    rows_per_shard: int


def _coo(tensor):
    """``(M, N, row, col, value)`` of an eager ``SparseTensor``: int64
    indices, and ones (f32) for a value-less tensor, as JAX's ``shard_*``."""
    M, N = tensor.sparse_sizes()
    row, col = tensor.storage.row().long(), tensor.storage.col().long()
    value = tensor.storage.value()
    if value is None:
        value = torch.ones(row.shape, dtype=torch.float32, device=row.device)
    return M, N, row, col, value


def _divide(n: int, parts: int, what: str) -> int:
    if parts <= 0 or n % parts:
        raise ValueError(f"{what}={n} must divide into {parts} shards")
    return n // parts


def _bucket_fill(arrays, bucket, counts, cap, fills):
    """Scatter bucket-contiguous streams into ``(nbuckets, cap)`` padded
    arrays in one O(nnz) pass: an element's slot is its position minus its
    bucket's start. ``bucket``: the bucket id of each element (equal ids
    contiguous, in id order); ``counts``: elements per bucket; ``fills``:
    the pad value of each array."""
    nb = counts.numel()
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(bucket.numel(), device=bucket.device) - starts[bucket]
    flat = bucket * cap + pos
    outs = []
    for a, fill in zip(arrays, fills):
        out = torch.full((nb * cap,), fill, dtype=a.dtype, device=a.device)
        out[flat] = a
        outs.append(out.reshape(nb, cap))
    return outs


def _row_bounds(row, n_shards, rows_per):
    """Entries per shard of row-sorted ``row``, and the largest (at least
    1)."""
    cuts = torch.arange(n_shards + 1, device=row.device) * rows_per
    bounds = torch.searchsorted(row, cuts)
    counts = bounds[1:] - bounds[:-1]
    return counts, max(1, int(counts.max())) if row.numel() else 1


def shard_padded_coo(tensor, n_shards: int, index_dtype=torch.int32,
                     ) -> RowShardedMatrix:
    """Split an eager SparseTensor into equal contiguous row blocks with a
    common padded capacity (O(nnz), on the tensor's device)."""
    M, N, row, col, value = _coo(tensor)
    rows_per = _divide(M, n_shards, "M")
    counts, cap = _row_bounds(row, n_shards, rows_per)
    dev = row // rows_per
    rows, cols, vals = _bucket_fill([row - dev * rows_per, col, value], dev,
                                    counts, cap, [rows_per, N, 0])
    return RowShardedMatrix(row=rows.to(index_dtype),
                            col=cols.to(index_dtype), value=vals,
                            nnz=counts.to(torch.int32), shape=(M, N),
                            rows_per_shard=rows_per)


def _take(stacked: NamedTuple, rank: int, device):
    """Rank ``rank``'s slice of every tensor field of ``stacked``, on
    ``device``; other fields as they are."""
    return type(stacked)(*(v[rank].to(device) if isinstance(v, torch.Tensor)
                           else v for v in stacked))


def device_put_sharded_matrix(mat: RowShardedMatrix, rank: int,
                              device=None) -> RowShardedMatrix:
    """Rank ``rank``'s row block on ``device``: the fields without the
    leading axis."""
    return _take(mat, rank, device)


def block_coo(block: RowShardedMatrix) -> PaddedCOO:
    """A rank's row block as a ``PaddedCOO`` of shape (rows_per_shard, N):
    its padding is already ``(rows_per_shard, N, 0)``. Reads ``nnz`` back
    to the host."""
    return PaddedCOO(row=block.row, col=block.col, value=block.value,
                     nnz=int(block.nnz),
                     shape=(block.rows_per_shard, block.shape[1]))


class RowShardedAdjacency:
    """One rank's row block of a row-sharded adjacency and the group it is
    sharded over, for models that aggregate with ``adj.spmm(h)``
    (``models/gcn.py::GCN``): :meth:`spmm` all-gathers the rank's rows of
    ``h`` and runs the local SpMM over the block, a ``PaddedCOO`` that
    caches its CSC view as any other. ``block.value`` is the rank's values
    (set ``requires_grad`` on it for ``d value``)."""

    def __init__(self, block: PaddedCOO, group):
        self.block, self.group = block, group

    def spmm(self, x_local: torch.Tensor, reduce: str = "sum"):
        """This rank's rows of ``A @ x`` from its rows of ``x``."""
        return self.block.spmm(all_gather(x_local, self.group), reduce)


def spmm_allgather(mesh, mat: RowShardedMatrix, x: torch.Tensor,
                   axis_name: str = "x", reduce: str = "sum") -> torch.Tensor:
    """``mat``: this rank's block; ``x``: its (N/D, K) rows. Returns its
    (M/D, K) output rows: one all-gather of ``x``, then the local SpMM."""
    group, _, _ = axis_rank(mesh, axis_name)
    return spmm_coo(mat.row, mat.col, mat.value, all_gather(x, group),
                    mat.rows_per_shard, reduce)


def _ring_sum(mesh, axis_name, x, part):
    """The sum over the ring's steps of ``part(src, x_blk)``: at step ``s``
    this rank holds the ``x`` block of rank ``src = r - s``; the blocks
    move one rank on between steps (the last step sends nothing)."""
    group, rank, D = axis_rank(mesh, axis_name)
    acc = None
    for s in range(D):
        p = part((rank - s) % D, x)
        acc = p if acc is None else acc + p
        if s < D - 1:
            x = ring_shift(x, group)
    return acc


def spmm_ring(mesh, mat: RowShardedMatrix, x: torch.Tensor,
              axis_name: str = "x") -> torch.Tensor:
    """Ring-pipelined SpMM: the ``x`` blocks go around the ring of ranks;
    with the block of rank ``src`` this rank adds the partial product of its
    entries in that block's columns (the others masked to 0). Memory O(N *
    K / D)."""
    blk = _divide(mat.shape[1], mesh.get_group(axis_name).size(), "N")

    def part(src, x_blk):
        start = src * blk
        in_blk = (mat.col >= start) & (mat.col < start + blk)
        v = torch.where(in_blk, mat.value, mat.value.new_zeros(()))
        c = (mat.col - start).clamp(0, blk - 1)
        return spmm_coo(mat.row, c, v, x_blk, mat.rows_per_shard)
    return _ring_sum(mesh, axis_name, x, part)


class RingShardedMatrix(NamedTuple):
    """Row blocks with entries bucketed by source (column) shard.

    Leading axis = rank; second = source shard; third = padded bucket
    slots. ``row`` local in [0, rows_per_shard] (pad = rows_per_shard);
    ``col`` local to the source shard's ``x`` block in [0, N/D) (pad = 0,
    value 0). Rows ascending within each bucket, pads last.
    """
    row: torch.Tensor     # (D, D, BC) local row ids
    col: torch.Tensor     # (D, D, BC) source-block-local col ids
    value: torch.Tensor   # (D, D, BC)
    shape: Tuple[int, int]
    rows_per_shard: int


def block_grid(tensor, nr: int, nc: int, index_dtype=torch.int32):
    """The (nr, nc, C) grid of an eager SparseTensor's blocks of M/nr rows
    and N/nc columns: block-local rows and cols, values; each block's
    entries by row, stably, then its padding (row M/nr, col 0, value 0) to
    the largest block's count C (at least 1). Returns ``(row, col, value,
    (M, N))``."""
    M, N, row, col, value = _coo(tensor)
    rb, cb = _divide(M, nr, "M"), _divide(N, nc, "N")
    bucket = (row // rb) * nc + col // cb
    # order by (block row, block col, row), stably
    order = torch.argsort(bucket * M + row, stable=True)
    row, col, value, bucket = row[order], col[order], value[order], \
        bucket[order]
    counts = torch.bincount(bucket, minlength=nr * nc)
    C = max(1, int(counts.max()))
    out = _bucket_fill(
        [row - (bucket // nc) * rb, col - (bucket % nc) * cb, value],
        bucket, counts, C, [rb, 0, 0])
    rows, cols, vals = (a.reshape(nr, nc, C) for a in out)
    return rows.to(index_dtype), cols.to(index_dtype), vals, (M, N)


def shard_ring_buckets(tensor, n_shards: int, index_dtype=torch.int32,
                       ) -> RingShardedMatrix:
    """Row-shard and bucket each shard's entries by source shard (the
    (D, D) :func:`block_grid`). The bucket capacity is the largest (rank,
    source) bucket, so skewed column distributions pad more (permute
    power-law graphs first)."""
    row, col, value, shape = block_grid(tensor, n_shards, n_shards,
                                        index_dtype)
    return RingShardedMatrix(row=row, col=col, value=value, shape=shape,
                             rows_per_shard=shape[0] // n_shards)


def device_put_ring(mat: RingShardedMatrix, rank: int,
                    device=None) -> RingShardedMatrix:
    """Rank ``rank``'s (D, BC) buckets on ``device``."""
    return _take(mat, rank, device)


def spmm_ring_bucketed(mesh, mat: RingShardedMatrix, x: torch.Tensor,
                       axis_name: str = "x") -> torch.Tensor:
    """The ring of :func:`spmm_ring` over pre-bucketed entries: with the
    block of rank ``src`` this rank reads only bucket ``src``, not every
    local entry."""
    return _ring_sum(mesh, axis_name, x, lambda src, x_blk: spmm_coo(
        mat.row[src], mat.col[src], mat.value[src], x_blk,
        mat.rows_per_shard))


class HaloShardedMatrix(NamedTuple):
    """Row blocks and a static halo-exchange plan.

    ``send_idx[d, j]``: the local ``x`` rows rank ``d`` sends to rank ``j``
    (block-local ids, padded with 0). ``col`` is remapped into the received
    halo buffer: entry e of rank d reads row ``col[d, e]`` of the (D*H, K)
    buffer the all-to-all assembles (slot ``s*H + i`` = the i-th row asked
    of source s).
    """
    row: torch.Tensor       # (D, C) local row ids
    col: torch.Tensor       # (D, C) halo-buffer positions; pad = 0 (value 0)
    value: torch.Tensor     # (D, C)
    send_idx: torch.Tensor  # (D, D, H) block-local x-row ids to send
    shape: Tuple[int, int]
    rows_per_shard: int
    halo_per_src: int       # H


def shard_halo(tensor, n_shards: int, index_dtype=torch.int32,
               ) -> HaloShardedMatrix:
    """Row-shard and build the static halo plan: H = the most DISTINCT
    ``x`` rows any rank needs from any one source; each rank pulls exactly
    the union of the rows its entries reference, deduplicated."""
    M, N, row, col, value = _coo(tensor)
    D = n_shards
    rows_per, blk = _divide(M, D, "M"), _divide(N, D, "N")
    nnz = row.numel()
    counts, C = _row_bounds(row, D, rows_per)
    dev = row // rows_per

    # the unique (rank, col) pairs, in (rank, col) order
    order2 = torch.argsort(dev * N + col, stable=True)
    dev2, col2 = dev[order2], col[order2]
    first = torch.ones(nnz, dtype=torch.bool, device=row.device)
    first[1:] = (dev2[1:] != dev2[:-1]) | (col2[1:] != col2[:-1])
    uid = torch.cumsum(first, 0) - 1      # unique id of each sorted entry
    u_dev, u_col = dev2[first], col2[first]
    u_src = u_col // blk
    u_bucket = u_dev * D + u_src          # (rank, source)-contiguous
    ucounts = torch.bincount(u_bucket, minlength=D * D)
    H = max(1, int(ucounts.max()))
    u_pos = (torch.arange(u_dev.numel(), device=row.device)
             - (torch.cumsum(ucounts, 0) - ucounts)[u_bucket])

    # send_idx[source, requester, pos] = block-local x row of the source
    send = torch.zeros(D * D * H, dtype=torch.int64, device=row.device)
    send[(u_src * D + u_dev) * H + u_pos] = u_col - u_src * blk
    # each entry's halo-buffer slot: its unique pair's position + src * H
    halo_pos = torch.empty(nnz, dtype=torch.int64, device=row.device)
    halo_pos[order2] = (u_pos + u_src * H)[uid]

    rows, cols, vals = _bucket_fill([row - dev * rows_per, halo_pos, value],
                                    dev, counts, C, [rows_per, 0, 0])
    return HaloShardedMatrix(row=rows.to(index_dtype),
                             col=cols.to(index_dtype), value=vals,
                             send_idx=send.reshape(D, D, H).to(index_dtype),
                             shape=(M, N), rows_per_shard=rows_per,
                             halo_per_src=H)


def device_put_halo(mat: HaloShardedMatrix, rank: int,
                    device=None) -> HaloShardedMatrix:
    """Rank ``rank``'s block and its (D, H) send rows, on ``device``."""
    return _take(mat, rank, device)


def halo_exchange(group, send_idx: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The (D*H, ...) halo buffer of one rank: the rows of ``x`` that each
    rank asks of it (``send_idx``, (D, H), taken with ids clamped into the
    block, as JAX's ``take(mode="clip")``) go out in one all-to-all; slab
    ``s`` of the buffer holds the rows from rank ``s``."""
    idx = send_idx.reshape(-1).long().clamp(0, x.shape[0] - 1)
    x_send = x.index_select(0, idx).reshape(tuple(send_idx.shape)
                                            + tuple(x.shape[1:]))
    return all_to_all(x_send, group).flatten(0, 1)


def spmm_halo(mesh, mat: HaloShardedMatrix, x: torch.Tensor,
              axis_name: str = "x", reduce: str = "sum") -> torch.Tensor:
    """SpMM with an all-to-all of exactly the (deduplicated) ``x`` rows each
    rank needs: O(unique cols * K) interchange against the all-gather's
    O(N * K). ``mat``: this rank's block; ``x``: its (N/D, K) rows."""
    group, _, _ = axis_rank(mesh, axis_name)
    halo = halo_exchange(group, mat.send_idx, x)
    return spmm_coo(mat.row, mat.col, mat.value, halo, mat.rows_per_shard,
                    reduce)

