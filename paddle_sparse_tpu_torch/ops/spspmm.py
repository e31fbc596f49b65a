"""SpGEMM on exact shapes, and the host-side capacity planners of the padded
variants in ``core/spgemm.py``.

Port of ``paddle_sparse_tpu/ops/spspmm.py``: the same returns, defaults and
``None`` on row skew. The planners read their statistics from the device
(``int(...)``), as the JAX ones do; a plan depends only on the structure, so
a caller reuses it across calls.
"""
from typing import Optional, Tuple

import torch

from ..core.matrix import PaddedCOO
from ..core.spgemm import fanout, spspmm_padded
from .convert import ptr2ind


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rnd(v, align: int) -> int:
    return max(align, _cdiv(int(v), align) * align)


def spspmm_eager(rowA, colA, valA: Optional[torch.Tensor], rowptrB, colB,
                 valB: Optional[torch.Tensor], M: int, N: int
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """SpGEMM on exact shapes: A (M, K) in row-sorted COO, B (K, N) in CSR.

    Returns the coalesced, ``(row, col)``-sorted ``(rowC, colC, valC)`` of
    ``A @ B``: :func:`~..core.spgemm.spspmm_padded` with both capacities the
    flop count, cut to the unique count (two host reads). ``valC`` is None
    iff both values are; a one-sided None is implicit ones of the other
    side's dtype. Differentiable in the values."""
    rowA = torch.as_tensor(rowA)
    dev = rowA.device
    rowptrB = torch.as_tensor(rowptrB, device=dev)
    colB = torch.as_tensor(colB, device=dev)
    K = rowptrB.numel() - 1
    A = PaddedCOO.from_arrays(rowA, colA, valA, (M, K), device=dev)
    B = PaddedCOO.from_arrays(ptr2ind(rowptrB, colB.numel()), colB, valB,
                              (K, N), device=dev)
    flops = int(fanout(A, B).ptrE[-1])
    C = spspmm_padded(A, B, flops, flops).matrix
    n = C.nnz
    return (C.row[:n].to(rowA.dtype), C.col[:n].to(rowA.dtype),
            None if C.value is None else C.value[:n])


def spgemm_flops(rowptrA, colA, rowptrB) -> int:
    """Multiplication count of A @ B (the length of the ESC stream)."""
    rowptrB = torch.as_tensor(rowptrB)
    degB = rowptrB[1:] - rowptrB[:-1]
    return int(degB[torch.as_tensor(colA, device=degB.device).long()].sum())


def _row_flop_stats(A: PaddedCOO, B: PaddedCOO):
    """``(row_flops, max row flops, total flops)``, the two read in one
    host sync."""
    rf = fanout(A, B).row_flops()
    top = rf.max() if rf.numel() else rf.new_zeros(())
    max_rf, flops = torch.stack([top, rf.sum()]).tolist()
    return rf, max_rf, flops


def plan_spgemm(A: PaddedCOO, B: PaddedCOO, slack: float = 1.1,
                exact_out: bool = True, align: int = 8) -> Tuple[int, int]:
    """Capacities ``(flop_capacity, out_capacity)`` for
    :func:`~..core.spgemm.spspmm_padded`: the flop count times ``slack``, and
    the exact unique count (a structural product) times ``slack``, or the
    flop capacity again when not ``exact_out``; rounded up to ``align``."""
    flops = _row_flop_stats(A, B)[2]
    flop_capacity = _rnd(max(1, flops) * slack, align)
    if not exact_out or flops == 0:
        return flop_capacity, flop_capacity
    res = spspmm_padded(A.with_value(None), B.with_value(None),
                        flop_capacity, flop_capacity)
    return flop_capacity, _rnd(res.matrix.nnz * slack, align)


def plan_spgemm_rows(A: PaddedCOO, B: PaddedCOO, slack: float = 1.1,
                     align: int = 8, grid_budget: float = 4.0
                     ) -> Tuple[Optional[int], int]:
    """``(row_flop_capacity, out_capacity)`` for
    :func:`~..core.spgemm.spspmm_rowsorted`, or ``(None, out_capacity)``
    when row skew makes the (M, F) grid more than ``grid_budget`` times the
    flop count (use :func:`~..core.spgemm.spspmm_padded` then)."""
    M = A.shape[0]
    _, max_rf, flops = _row_flop_stats(A, B)
    if flops == 0:
        return None, align
    F = _rnd(max_rf, align)
    if M * F > grid_budget * flops + (1 << 22):
        return None, _rnd(flops * slack, align)
    return F, _rnd(min(flops, M * F) * slack, align)


def plan_spgemm_blocked(A: PaddedCOO, B: PaddedCOO, slack: float = 1.15,
                        align: int = 8, grid_elems: int = 48_000_000
                        ) -> Optional[Tuple[int, int, int, int, int]]:
    """``(F, out_capacity, block_rows, block_edges, block_out)`` for
    :func:`~..core.spgemm.spspmm_rowblocked`, or None when row skew makes
    the per-row grid infeasible. ``grid_elems`` bounds one block's
    (block_rows, F) grid."""
    M = A.shape[0]
    rf, max_rf, flops = _row_flop_stats(A, B)
    if flops == 0:
        return None
    F = _rnd(max_rf, align)
    MB = min(M, max(128, grid_elems // F))
    NB = _cdiv(M, MB)
    if NB * MB * F > 4.0 * flops + (1 << 22) or F > grid_elems // 128:
        return None
    blk_flops = torch.cat([rf, rf.new_zeros(NB * MB - M)]).reshape(
        NB, MB).sum(1).max()
    bounds = A.rowptr().long()[torch.clamp(
        torch.arange(NB + 1, device=rf.device) * MB, max=M)]
    mbf, mbe = torch.stack([blk_flops,
                            (bounds[1:] - bounds[:-1]).max()]).tolist()
    EB = _rnd(mbe * 1.02 + 8, align)
    BOC = _rnd(min(mbf, MB * F) * slack, align)
    out_capacity = _rnd(min(flops, M * F) * slack, align)
    return F, out_capacity, MB, EB, BOC
