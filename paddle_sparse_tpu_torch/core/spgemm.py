"""Sparse @ sparse product (SpGEMM) on ``PaddedCOO`` operands, ``C = A @ B``,
differentiable in ``A.value`` and ``B.value``.

Port of ``paddle_sparse_tpu/core/spgemm.py``: expand-sort-compress (ESC) with
static capacities (``ops/spspmm.py`` plans them on the host).

* Expand: A-entry e fans out to the ``degB[e]`` entries of B's row
  ``col[e]``; flop t belongs to A-entry ``a_id = max{e : ptrE[e] <= t}``
  (``ptrE`` the exclusive scan of ``degB``) and to B-entry
  ``b_pos = rowptrB[colA[a_id]] + t - ptrE[a_id]``. Its product is
  ``valA[a_id] * valB[b_pos]``, which autograd differentiates (the JAX
  package's custom VJPs return the same).
* Sort: ``torch.sort``, stable: one int64 key ``row * (N + 1) + col`` over
  the flat stream (:func:`spspmm_padded`), or the columns within each row of
  an (M, F) grid (:func:`spspmm_rowsorted`, :func:`spspmm_rowblocked`).
* Compress: the run-compaction kernel (``ops/kernels/segcompact_cuda.py``),
  the port's one compress.

Padding: inputs carry pads ``(M, N, 0)`` and their cols are never read;
outputs hold ``nnz`` entries sorted by ``(row, col)``, then pads. Overflow is
reported, not raised: a capacity below what the product needs keeps the first
entries (of the flop stream in A-entry order, of a row's flops, or of the
output), and sets ``overflowed``. ``nnz`` is a Python int, so each call reads
the unique count from the device, and ``overflowed`` is a bool read in that
same host sync.

Values: ``value=None`` on both sides gives a structural C (``value=None``);
one-sided None means implicit ones of the other side's dtype. The kernel sums
f32 or f64 products; other dtypes raise on CUDA tensors. Coordinates are
int32 (M and N below 2**31) with 64-bit element offsets.
"""
from typing import List, NamedTuple, Tuple

import torch

from ..ops.kernels.segcompact_cuda import Compacted, compact_runs
from .matrix import PaddedCOO


class SpGEMMResult(NamedTuple):
    matrix: PaddedCOO
    overflowed: bool    # True if any capacity was exceeded


class Fanout(NamedTuple):
    """Per A-entry fan-out into B (pads of A fan out to nothing)."""
    colA: torch.Tensor      # (capA,) int64, 0 at pads
    ptrE: torch.Tensor      # (capA + 1,) int64 exclusive scan of degB
    rowptrB: torch.Tensor   # (K + 1,) int64
    rowE: torch.Tensor      # (M + 1,) int64 flops before each row of A

    def row_flops(self) -> torch.Tensor:
        return self.rowE[1:] - self.rowE[:-1]


def _check_shapes(A: PaddedCOO, B: PaddedCOO) -> Tuple[int, int]:
    M, K = A.shape
    K2, N = B.shape
    if K != K2:
        raise ValueError(f"size mismatch {A.shape} @ {B.shape}")
    if M >= 2 ** 31 - 1 or N >= 2 ** 31 - 1:
        raise ValueError(f"C's shape ({M}, {N}) needs M, N < 2**31 - 1 "
                         f"(int32 coordinates and pads)")
    return M, N


def fanout(A: PaddedCOO, B: PaddedCOO) -> Fanout:
    rowptrB = B.rowptr().long()
    validA = A.valid_mask()
    colA = torch.where(validA, A.col.long(), 0)
    degB = torch.where(validA, rowptrB[colA + 1] - rowptrB[colA], 0)
    ptrE = torch.cat([degB.new_zeros(1), degB.cumsum(0)])
    return Fanout(colA, ptrE, rowptrB, ptrE[A.rowptr().long()])


def _operand_values(A: PaddedCOO, B: PaddedCOO):
    """``(valA, valB)`` in their promoted dtype, implicit ones (0 at pads)
    for a None side; ``(None, None)`` when both are None."""
    if A.value is None and B.value is None:
        return None, None
    valA = (A.value if A.value is not None
            else A.valid_mask().to(B.value.dtype))
    valB = (B.value if B.value is not None
            else B.valid_mask().to(A.value.dtype))
    common = torch.promote_types(valA.dtype, valB.dtype)
    return valA.to(common), valB.to(common)


def _expand(A: PaddedCOO, B: PaddedCOO, fan: Fanout, flop: torch.Tensor,
            valid: torch.Tensor, valA, valB):
    """Column (N where not ``valid``), product (0 there, or None) and A-entry
    of each flop index in ``flop`` (any shape)."""
    N = B.shape[1]
    total = fan.ptrE[-1]
    flop = torch.minimum(flop, (total - 1).clamp(min=0))
    a_id = (torch.searchsorted(fan.ptrE, flop, right=True) - 1).clamp_(
        0, A.capacity - 1)
    b_pos = (fan.rowptrB[fan.colA[a_id]] + flop - fan.ptrE[a_id]).clamp_(
        0, B.capacity - 1)
    col = torch.where(valid, B.col[b_pos].int(), N)
    prod = None
    if valA is not None:
        prod = torch.where(valid, valA[a_id] * valB[b_pos],
                           valA.new_zeros(()))
    return col, prod, a_id


def _sorted_row_grid(A, B, fan, rowE_b, rf_b, F, valA, valB,
                     edge_limit=None):
    """The expansion of rows with flop offsets ``rowE_b`` and counts
    ``rf_b`` laid on an (R, F) grid, the first ``F`` flops of each row, each
    grid row sorted by column (pads N last). Flops of A-entries at or past
    ``edge_limit`` are dropped."""
    f = torch.arange(F, device=rowE_b.device)
    valid = f < rf_b[:, None]
    key, prod, a_id = _expand(A, B, fan, rowE_b[:, None] + f, valid, valA,
                              valB)
    if edge_limit is not None:
        keep = a_id < edge_limit
        key = torch.where(keep, key, B.shape[1])
        if prod is not None:
            prod = torch.where(keep, prod, prod.new_zeros(()))
    key, perm = torch.sort(key, dim=1, stable=True)
    return key, None if prod is None else prod.gather(1, perm)


def _padded_result(out: Compacted, flags: torch.Tensor, out_capacity: int,
                   shape, idx_dtype) -> SpGEMMResult:
    count, over = torch.stack([out.count, flags.long()]).tolist()
    C = PaddedCOO(row=out.row.to(idx_dtype), col=out.col.to(idx_dtype),
                  value=out.value, nnz=min(count, out_capacity), shape=shape)
    return SpGEMMResult(C, bool(over) or count > out_capacity)


def spspmm_padded(A: PaddedCOO, B: PaddedCOO, flop_capacity: int,
                  out_capacity: int) -> SpGEMMResult:
    """C = A @ B with A (M, K) and B (K, N) padded and row-sorted, through
    one global sort of a flat stream of ``flop_capacity`` flops: the ESC
    fallback for skewed rows. Flops past ``flop_capacity`` (in A-entry
    order) and entries past ``out_capacity`` are dropped and reported."""
    M, N = _check_shapes(A, B)
    fan = fanout(A, B)
    valA, valB = _operand_values(A, B)
    t = torch.arange(flop_capacity, device=A.row.device)
    valid = t < fan.ptrE[-1]
    col, prod, a_id = _expand(A, B, fan, t, valid, valA, valB)
    row = torch.where(valid, A.row[a_id].int(), M)
    key, perm = torch.sort(row.long() * (N + 1) + col, stable=True)
    row, col = (key // (N + 1)).int(), (key % (N + 1)).int()
    out = compact_runs(col, row, None if prod is None else prod[perm],
                       (M, N), out_capacity)
    return _padded_result(out, fan.ptrE[-1] > flop_capacity, out_capacity,
                          (M, N), A.row.dtype)


def matmul_padded(A: PaddedCOO, B: PaddedCOO, flop_capacity: int,
                  out_capacity: int) -> PaddedCOO:
    """:func:`spspmm_padded` without the overflow flag."""
    return spspmm_padded(A, B, flop_capacity, out_capacity).matrix


def spspmm_rowsorted(A: PaddedCOO, B: PaddedCOO, row_flop_capacity: int,
                     out_capacity: int) -> SpGEMMResult:
    """C = A @ B through a per-row sort: the flops laid out as an (M, F)
    grid, ``F = row_flop_capacity``, each row's columns sorted. A's row order
    is C's, so no global sort is needed. Memory is O(M * F);
    ``ops.spspmm.plan_spgemm_rows`` plans F and returns None when row skew
    makes the grid too large. A row's flops past F, and entries past
    ``out_capacity``, are dropped and reported."""
    M, N = _check_shapes(A, B)
    fan = fanout(A, B)
    valA, valB = _operand_values(A, B)
    rf = fan.row_flops()
    key, prod = _sorted_row_grid(A, B, fan, fan.rowE[:-1], rf,
                                 int(row_flop_capacity), valA, valB)
    rows = torch.arange(M, dtype=torch.int32, device=A.row.device)
    out = compact_runs(key, rows, prod, (M, N), out_capacity)
    return _padded_result(out, (rf > row_flop_capacity).any(), out_capacity,
                          (M, N), A.row.dtype)


def spspmm_rowblocked(A: PaddedCOO, B: PaddedCOO, row_flop_capacity: int,
                      out_capacity: int, block_rows: int, block_edges: int,
                      block_out: int) -> SpGEMMResult:
    """:func:`spspmm_rowsorted` over blocks of ``block_rows`` rows: one
    (block_rows, F) grid at a time, each compressed into ``block_out`` slots;
    the blocks' entries follow each other in row order. Caps from
    ``ops.spspmm.plan_spgemm_blocked``: per block, A-entries past
    ``block_edges``, a row's flops past F and entries past ``block_out`` are
    dropped; then entries past ``out_capacity``. Each is reported.

    The JAX version writes products of the A-entries past ``block_edges`` at
    wrong coordinates and does not report ``out_capacity`` overflow; this
    port drops those entries and reports both."""
    M, N = _check_shapes(A, B)
    F, MB, EB, BOC = (int(row_flop_capacity), int(block_rows),
                      int(block_edges), int(block_out))
    fan = fanout(A, B)
    valA, valB = _operand_values(A, B)
    rf = fan.row_flops()
    eptrA = A.rowptr().long()
    dev = A.row.device
    blocks: List[Compacted] = []
    flags = [(rf > F).any()]
    for r0 in range(0, M, max(MB, 1)):
        r1 = min(r0 + MB, M)
        flags.append(eptrA[r1] - eptrA[r0] > EB)
        key, prod = _sorted_row_grid(A, B, fan, fan.rowE[r0:r1], rf[r0:r1],
                                     F, valA, valB, eptrA[r0] + EB)
        rows = torch.arange(r0, r1, dtype=torch.int32, device=dev)
        blocks.append(compact_runs(key, rows, prod, (M, N), BOC))
    counts = torch.stack([b.count for b in blocks] + [
        torch.stack(flags).any().long()]).tolist()
    over = bool(counts.pop())
    kept = [min(c, BOC) for c in counts]
    over |= any(c > BOC for c in counts) or sum(kept) > out_capacity
    nnz = min(sum(kept), out_capacity)

    def stitch(field, fill):
        parts = [getattr(b, field)[:k] for b, k in zip(blocks, kept)]
        return torch.cat(parts + [fill(out_capacity - nnz)])[:out_capacity]

    row = stitch("row", lambda n: torch.full((n,), M, dtype=torch.int32,
                                             device=dev))
    col = stitch("col", lambda n: torch.full((n,), N, dtype=torch.int32,
                                             device=dev))
    value = None if valA is None else stitch("value", valA.new_zeros)
    idx = A.row.dtype
    return SpGEMMResult(PaddedCOO(row=row.to(idx), col=col.to(idx),
                                  value=value, nnz=nnz, shape=(M, N)), over)
