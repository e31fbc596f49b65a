"""Row-partitioned distributed SpGEMM (sparse @ sparse) over
``torch.distributed``.

Port of ``paddle_sparse_tpu/parallel/spgemm.py``. C = A @ B with A 1-D
row-sharded: each rank owns a contiguous block of A's rows and computes the
matching block of C's rows locally through ``core/spgemm.py::spspmm_padded``
(expand, sort, and the run compaction kernel K5). With B replicated the
product needs no communication: rows of C are independent. A row-sharded B
is first gathered whole by :func:`allgather_padded`: one tiled all-gather of
its (row, col, value) triple, then a stable sort that moves every block's
padding behind the real entries, which the concatenation leaves in row
order.
"""
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.matrix import PaddedCOO
from ..core.spgemm import spspmm_padded
from .collectives import all_gather
from .mesh import axis_rank
from .spmm import _bucket_fill, _divide, _row_bounds


class RowBlocks(NamedTuple):
    """Stacked (D, capacity) row blocks of a padded COO matrix: *local* row
    ids (padding ``rows_per``), global cols (padding N), values 0 at
    padding (or None), ``nnz`` per block; ``shape`` is one block's
    ``(rows_per, N)``."""
    row: torch.Tensor
    col: torch.Tensor
    value: Optional[torch.Tensor]
    nnz: torch.Tensor       # (D,) int32
    shape: Tuple[int, int]


def shard_padded_rows(tensor, n_shards: int) -> Tuple[RowBlocks, int]:
    """Split an eager SparseTensor into ``n_shards`` contiguous row blocks
    with local row ids and a common capacity, on its device, its index and
    value dtypes kept. Returns ``(blocks, rows_per_shard)``."""
    M, N = tensor.sparse_sizes()
    rows_per = _divide(M, n_shards, "M")
    row, col = tensor.storage.row(), tensor.storage.col()
    value = tensor.storage.value()
    counts, cap = _row_bounds(row.long(), n_shards, rows_per)
    dev = row.long() // rows_per
    arrays = [(row.long() - dev * rows_per).to(row.dtype), col]
    fills = [rows_per, N]
    if value is not None:
        arrays.append(value)
        fills.append(0)
    out = _bucket_fill(arrays, dev, counts, cap, fills)
    return RowBlocks(row=out[0], col=out[1],
                     value=out[2] if value is not None else None,
                     nnz=counts.to(torch.int32), shape=(rows_per, N)), \
        rows_per


def device_put_blocks(blocks: RowBlocks, rank: int,
                      device=None) -> PaddedCOO:
    """Rank ``rank``'s block on ``device`` as a ``PaddedCOO`` of shape
    ``(rows_per, N)`` (reads its ``nnz`` to the host)."""
    return PaddedCOO(
        row=blocks.row[rank].to(device), col=blocks.col[rank].to(device),
        value=(None if blocks.value is None
               else blocks.value[rank].to(device)),
        nnz=int(blocks.nnz[rank]), shape=blocks.shape)


def spgemm_rowsharded(mesh, A_block: PaddedCOO, B: PaddedCOO,
                      flop_capacity: int, out_capacity: int,
                      axis_name: str = "x"):
    """C = A @ B with A row-sharded and B replicated.

    ``A_block``: this rank's (rows_per, K) block (:func:`device_put_blocks`);
    ``B``: the whole (K, N) matrix on every rank. Capacities are per-rank
    bounds (size them from the worst block, ``ops.spspmm.plan_spgemm``).

    Returns ``(C_block, overflowed)``: this rank's (rows_per, N) block of C
    (local rows: global row = local + rank * rows_per) and every rank's
    overflow flag, a (D,) bool tensor, the same on every rank."""
    rows_per, K = A_block.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"size mismatch {A_block.shape} @ {B.shape}")
    res = spspmm_padded(A_block, B, flop_capacity, out_capacity)
    group, _, _ = axis_rank(mesh, axis_name)
    flag = torch.tensor([res.overflowed], dtype=torch.int32,
                        device=A_block.row.device)
    return res.matrix, all_gather(flag, group).bool()


def allgather_padded(mesh, block: PaddedCOO,
                     axis_name: str = "x") -> PaddedCOO:
    """The whole row-sharded matrix on every rank, from each rank's
    (rows_per, N) block of one common capacity: a tiled all-gather of row,
    col and value (differentiable in the values), rows made global, and
    every block's padding moved behind the real entries by a stable sort,
    so the result is row-sorted with padding ``(D * rows_per, N, 0)``."""
    group, _, D = axis_rank(mesh, axis_name)
    rows_per, N = block.shape
    cap = block.capacity
    dev = block.row.device
    row = all_gather(block.row, group).long()
    real = row < rows_per
    offset = torch.arange(D, device=dev).repeat_interleave(cap) * rows_per
    order = torch.argsort((~real).to(torch.int8), stable=True)
    M = D * rows_per
    row = torch.where(real, row + offset, M)[order]
    col = torch.where(real, all_gather(block.col, group).long(), N)[order]
    value = (None if block.value is None
             else all_gather(block.value, group)[order])
    counts = all_gather(torch.tensor([block.nnz], device=dev), group)
    return PaddedCOO(row=row.to(block.row.dtype), col=col.to(block.col.dtype),
                     value=value, nnz=int(counts.sum()), shape=(M, N))


def stack_blocks(mesh, C_block: PaddedCOO, axis_name: str = "x") -> RowBlocks:
    """Every rank's block of one common capacity, stacked on every rank as
    (D, capacity) :class:`RowBlocks` (for :func:`gather_blocks`)."""
    group, _, D = axis_rank(mesh, axis_name)
    dev = C_block.row.device

    def stacked(a):
        return all_gather(a, group).reshape(D, -1)

    counts = all_gather(torch.tensor([C_block.nnz], dtype=torch.int32,
                                     device=dev), group)
    return RowBlocks(row=stacked(C_block.row), col=stacked(C_block.col),
                     value=(None if C_block.value is None
                            else stacked(C_block.value)),
                     nnz=counts, shape=C_block.shape)


def gather_blocks(C_blocks: RowBlocks, rows_per: int, num_rows: int,
                  num_cols: int):
    """Merge stacked local-row output blocks into one row-sorted global COO
    triple ``(row, col, value)`` (value None for structural blocks): each
    block's first ``nnz`` entries, rows made global, in block order."""
    D, cap = C_blocks.row.shape
    dev = C_blocks.row.device
    keep = (torch.arange(cap, device=dev)[None, :]
            < C_blocks.nnz.to(dev).long()[:, None])
    offset = (torch.arange(D, device=dev) * rows_per)[:, None]
    row = (C_blocks.row + offset.to(C_blocks.row.dtype))[keep]
    col = C_blocks.col[keep]
    value = None if C_blocks.value is None else C_blocks.value[keep]
    return row, col, value
