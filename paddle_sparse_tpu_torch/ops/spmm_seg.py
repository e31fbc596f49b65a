"""Source-blocked SpMM (``seg``): ``A @ x`` (sum) over edges ordered by (row
block, source segment, row), differentiable in the packed values and ``x``.

Port of ``paddle_sparse_tpu/ops/spmm_seg.py``. Users plan once per static
graph (:func:`make_seg_plan`), convert the values once into the packed order
(:func:`pack_values`) and call :func:`spmm_seg`; :func:`unpack_values` maps
packed values (and their gradients) back to COO order.

The packed layout is what users hold, so the JAX structure's arrays are
kept array for array: ``perm`` (packed position -> COO position), ``col``
(source-segment-local columns, ``col - seg * seg_rows``), ``row``
(block-local rows, ``row % rows_per_block``), the window pointer ``wptr``
over the (block, segment) windows, the same for the transpose
(``col_t``, ``row_t``, ``wptr_t``, ``perm_t``) and the value relay
``perm_ft`` (transpose position -> forward packed position). The geometry
(``rows_per_block``, ``window_cap``) comes from the JAX rule, because the
block size fixes the packed order.

What runs on the card: the forward is one multi-span SpMM launch
(:func:`~.kernels.spmm_spans_cuda.spmm_spans_cuda`) over the (block,
segment) windows: row ``m`` of block ``b`` sums, for each segment ``s``, its
run inside window ``(b, s)``, reading ``x[s * seg_rows + col[e]]``. The
backward is seg2's (``spmm_seg2._PackedSpmm``, given this layout's span
bounds): ``d x`` and ``d value`` together in one launch of the fused span
backward over the transpose's windows, on the values relayed through
``perm_ft``, ``d value`` read back into the packed order through
``perm_tf``; either alone through the spans launch over the transpose or
the span SDDMM over the forward windows. The span
bounds ``(start, end)`` of both orientations and their piece tables are
built once by the planner and kept on the structure beside JAX's arrays.
``x`` is not padded to whole segments: every read is inside ``x``.

Not ported, because it is TPU scheduling: the per-window Pallas passes,
``lax.map`` over blocks, the padded source slices and ``interpret``. Gathers
run in f32 (bf16 when the inputs are bf16), summed in f32.
"""
from typing import NamedTuple, Optional

import torch

from .kernels.row_split import RowSplit, split_lengths
from .spmm_seg2 import (SpanLayout, _PackedSpmm, _check_indices,
                        check_operands, relays)

SEG_ROWS = 1 << 17     # the JAX package's fast-gather source rows (TPU v5e)


class SegStructure(NamedTuple):
    """The packed index structure (and its transpose), int32 tensors on the
    plan's device: the JAX package's nine arrays, then the span bounds
    ``(2, S, rows)`` (start, end) and piece tables the kernels read, and
    the inverse of ``perm_ft`` (the backward reads ``d value`` back through
    it)."""
    col: torch.Tensor      # (nnz,) segment-local cols, packed order
    row: torch.Tensor      # (nnz,) block-local rows, packed order
    wptr: torch.Tensor     # (nblocks * S + 1,) window start per (block, seg)
    perm: torch.Tensor     # (nnz,) packed position -> COO position
    col_t: torch.Tensor
    row_t: torch.Tensor
    wptr_t: torch.Tensor
    perm_t: torch.Tensor   # transpose position -> COO position
    perm_ft: torch.Tensor  # transpose position -> forward packed position
    bounds_f: torch.Tensor  # (2, S, M) span start/end, forward
    bounds_t: torch.Tensor  # (2, S_t, N) span start/end, transpose
    split_f: Optional[RowSplit]
    split_t: Optional[RowSplit]
    perm_tf: torch.Tensor  # forward packed position -> transpose position


class SegPlan(NamedTuple):
    """Static geometry for :func:`spmm_seg` (the JAX plan's, less
    ``interpret``)."""
    num_rows: int
    num_cols: int
    rows_per_block: int      # CR
    window_cap: int          # EC: the largest window, 2048-aligned
    num_segments: int
    rows_per_block_t: int
    window_cap_t: int
    num_segments_t: int
    seg_rows: int = SEG_ROWS


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _seg_order(row, col, num_rows: int, num_cols: int, CR: int,
               seg_rows: int):
    """The (block, segment, row) order of row-sorted ``row``/``col`` (a
    stable sort by (block, segment) keeps rows sorted inside a window) and
    its window pointer: ``(perm, local_col, local_row, wptr, max_window,
    seg, S)``, ``seg`` the segment of each packed edge."""
    S = _cdiv(num_cols, seg_rows)
    nblocks = _cdiv(num_rows, CR)
    seg = col // seg_rows
    bucket = (row // CR).long() * S + seg
    counts = torch.bincount(bucket, minlength=nblocks * S)
    wptr = torch.zeros(nblocks * S + 1, dtype=torch.int32, device=row.device)
    torch.cumsum(counts, 0, out=wptr[1:])
    perm = torch.argsort(bucket, stable=True)
    seg_p = seg[perm]
    local_col = (col[perm] - seg_p * seg_rows).to(torch.int32)
    local_row = (row[perm] % CR).to(torch.int32)
    wmax = int(counts.max()) if counts.numel() else 0
    return perm.to(torch.int32), local_col, local_row, wptr, wmax, seg_p, S


def _span_bounds(seg_p, row_p, wptr, S: int, M: int, CR: int):
    """(2, S, M) int32 span bounds of a packed layout: row ``m`` (block
    ``b``) in segment ``s`` is the run of its edges inside window ``(b,
    s)``, from ``wptr[b * S + s]`` plus the window's edges of earlier rows.
    ``seg_p``/``row_p``: the segment and global row of each packed edge."""
    dev = wptr.device
    cnt = torch.bincount(seg_p.long() * M + row_p.long(),
                         minlength=S * M).view(S, M)
    before = torch.cumsum(cnt, 1) - cnt          # the segment's earlier rows
    rows = torch.arange(M, device=dev)
    blk = rows // CR
    first = (blk * CR).expand(S, M)
    win = wptr[:-1].view(-1, S).T[:, blk].long()  # (S, M) window starts
    start = win + before - before.gather(1, first)
    bounds = torch.stack([start, start + cnt]).to(torch.int32)
    return bounds


def make_seg_plan(row, col, num_rows: int, num_cols: int, *,
                  feat_dim: int = 256,
                  target_bytes: int = 1024 * 1024 * 1024,
                  seg_rows: int = SEG_ROWS):
    """``(plan, structure)`` for :func:`spmm_seg`, built on ``row``'s
    device. ``row`` must be sorted ascending (canonical COO order);
    ``feat_dim`` and ``target_bytes`` size the row blocks, as in the JAX
    package (their product streams bounded on a TPU), and so fix the packed
    order."""
    M, N = num_rows, num_cols
    row, col = _check_indices(row, col, M, N, "make_seg_plan")
    nnz = row.numel()

    def geometry(num_r):
        mean_edges_per_row = max(1, nnz // max(num_r, 1))
        budget_edges = max(2048, target_bytes // (feat_dim * 4))
        return max(128, min(num_r, _cdiv(budget_edges // mean_edges_per_row,
                                         128) * 128))

    CR = geometry(M)
    perm, lcol, lrow, wptr, wmax, seg_p, S = _seg_order(row, col, M, N, CR,
                                                        seg_rows)
    EC = max(2048, _cdiv(wmax, 2048) * 2048)
    bounds_f = _span_bounds(seg_p, row[perm.long()], wptr, S, M, CR)

    CRT = geometry(N)
    # the transpose stream is sorted by col first, then reordered
    perm_c = torch.argsort(col, stable=True)
    row_t_s, col_t_s = col[perm_c], row[perm_c]
    perm_t2, lcol_t, lrow_t, wptr_t, wmax_t, seg_t, S_t = _seg_order(
        row_t_s, col_t_s, N, M, CRT, seg_rows)
    ECT = max(2048, _cdiv(wmax_t, 2048) * 2048)
    bounds_t = _span_bounds(seg_t, row_t_s[perm_t2.long()], wptr_t, S_t, N,
                            CRT)
    perm_t = perm_c[perm_t2.long()].to(torch.int32)
    perm_ft, perm_tf = relays(perm, perm_t)

    plan = SegPlan(M, N, CR, EC, S, CRT, ECT, S_t, seg_rows=seg_rows)
    structure = SegStructure(
        lcol, lrow, wptr, perm, lcol_t, lrow_t, wptr_t, perm_t, perm_ft,
        bounds_f, bounds_t,
        split_f=split_lengths(torch.bincount(row, minlength=M)),
        split_t=split_lengths(torch.bincount(col, minlength=N)),
        perm_tf=perm_tf)
    return plan, structure


def pack_values(s: SegStructure, value: torch.Tensor) -> torch.Tensor:
    """COO-ordered (nnz,) values -> the packed layout (once per operand;
    the packed vector is the autograd leaf)."""
    return value.index_select(0, s.perm)


def unpack_values(s: SegStructure, packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_values` (packed layout -> COO order)."""
    return packed.new_zeros(packed.shape).index_copy(0, s.perm.long(),
                                                     packed)


def _layout(bounds, col, seg_rows: int, split) -> SpanLayout:
    S = bounds.shape[1]
    base = torch.arange(S, dtype=torch.int32, device=col.device) * seg_rows
    return SpanLayout(bounds[0], bounds[1], col, base, split)


def spmm_seg(plan: SegPlan, s: SegStructure,
             packed_value: Optional[torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (sum reduction) over a source-segmented plan,
    differentiable in ``(packed_value, x)``.

    ``packed_value``: values in the packed layout (:func:`pack_values`), or
    None for structural ones; ``x`` (N, K). The output (M, K) has ``x``'s
    dtype. Double backward raises ``NotImplementedError``, as the JAX
    package's does."""
    check_operands(plan.num_cols, s.col.numel(), packed_value, x)
    fwd = _layout(s.bounds_f, s.col, plan.seg_rows, s.split_f)
    t = _layout(s.bounds_t, s.col_t, plan.seg_rows, s.split_t)
    return _PackedSpmm.apply(packed_value, x.contiguous(), fwd, t, s.perm_ft,
                             s.perm_tf, "f32")
