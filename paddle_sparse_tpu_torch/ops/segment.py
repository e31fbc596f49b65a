"""Segment / gather primitives over CSR pointers and COO segment ids.

Port of ``paddle_sparse_tpu/ops/segment.py``, which leaves all of them to XLA
segment ops; here they are plain torch (``index_add``, ``scatter_reduce``,
gathers), on the device of their inputs.

The JAX segment ops' rules are kept:

* ids outside ``[0, num_segments)``, negative ones included, are dropped
  (``torch.bincount`` would grow its output and ``scatter_reduce`` would
  raise, so such ids are sent to a dead extra segment first);
* empty segments give 0 for every reduction, min and max too;
* sums, min and max accumulate in the value dtype, except the mean of
  :func:`segment_csr`, which sums f16/bf16 in f32 and casts back;
  :func:`scatter_reduce`'s mean does not widen.

:func:`row_groups` with :func:`grouped_sum`, :func:`grouped_max` and
:func:`grouped_gather` reduce and gather over a sorted row index in two
steps, through groups of at most ``GROUP`` entries of one row: a hub row of
10M entries would otherwise send 10M atomic updates (or reads) to one
address, which the card serializes (GAT's edge softmax on a power-law
graph).
"""
import math
from typing import NamedTuple, Optional

import torch

from .convert import ptr2ind

REDUCTIONS = ("sum", "add", "mean", "min", "max")
_SCATTER = {"min": "amin", "max": "amax"}


def _bcast(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.reshape((-1,) + (1,) * (ndim - 1))


def _dead_slot(values: torch.Tensor, ids: torch.Tensor, num_segments: int):
    """Zeros of ``num_segments + 1`` rows, and ``ids`` (int64) with those
    outside ``[0, num_segments)`` sent to the extra, dead row: the caller
    reduces into it and slices it off, which drops them as the JAX segment
    ops do, with no host read."""
    ids = ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    return values.new_zeros((num_segments + 1,) + tuple(values.shape[1:])), ids


def _segment_sum(values, ids, num_segments):
    out, ids = _dead_slot(values, ids, num_segments)
    return out.index_add(0, ids, values)[:num_segments]


def _identity(dtype: torch.dtype, reduce: str):
    """The start of a segment min/max: a value no entry ties with (torch's
    backward would count a tie with it and split the gradient with it)."""
    if dtype.is_floating_point:
        return float("inf") if reduce == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def _segment_extreme(values, ids, num_segments, reduce):
    """Segment min or max; empty segments hold the reduction's identity
    until :func:`_fill_empty` zeroes them, as in the JAX code."""
    out, ids = _dead_slot(values, ids, num_segments)
    out = out.fill_(_identity(values.dtype, reduce))
    index = _bcast(ids, values.dim()).expand_as(values)
    return out.scatter_reduce(0, index, values, _SCATTER[reduce],
                              include_self=False)[:num_segments]


def _seg_reduce(values, ids, num_segments, reduce):
    if reduce in ("sum", "add"):
        return _segment_sum(values, ids, num_segments)
    if reduce in _SCATTER:
        return _segment_extreme(values, ids, num_segments, reduce)
    if reduce == "mean":
        acc = (values.float()
               if values.dtype in (torch.float16, torch.bfloat16) else values)
        return _segment_mean(acc, ids, num_segments).to(values.dtype)
    raise ValueError(f"unknown reduction {reduce!r}")


def _segment_mean(values, ids, num_segments):
    """Segment sum over the segment's entry count (at least 1), both in the
    value dtype."""
    total = _segment_sum(values, ids, num_segments)
    ones = torch.ones(values.shape[:1], dtype=total.dtype,
                      device=values.device)
    count = _segment_sum(ones, ids, num_segments).clamp(min=1)
    return total / _bcast(count, values.dim())


def _fill_empty(out, counts, reduce):
    """Empty segments: sum and mean give 0 already; min and max give 0."""
    if reduce in _SCATTER:
        out = torch.where(_bcast(counts == 0, out.dim()),
                          torch.zeros((), dtype=out.dtype, device=out.device),
                          out)
    return out


def segment_csr(values: torch.Tensor, ptr: torch.Tensor,
                reduce: str = "sum") -> torch.Tensor:
    """Reduce ``values`` over the segments of the CSR-style ``ptr``:
    ``out[i] = reduce(values[ptr[i]:ptr[i+1]])``, 0 for an empty segment.
    As in JAX, positions past ``ptr[-1]`` fall into the last segment that
    starts at or before them (:func:`~.convert.ptr2ind`)."""
    num_segments = ptr.numel() - 1
    ids = ptr2ind(ptr, values.shape[0])
    out = _seg_reduce(values, ids, num_segments, reduce)
    return _fill_empty(out, ptr[1:] - ptr[:-1], reduce)


def gather_csr(src: torch.Tensor, ptr: torch.Tensor,
               out_len: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`segment_csr`: each segment's entry of ``src``
    broadcast to every element of that segment (``out_len`` elements,
    default ``ptr[-1]``: one host read)."""
    if out_len is None:
        out_len = int(ptr[-1])
    return src[ptr2ind(ptr, out_len).long()]


def gather_segments(ptr: torch.Tensor, idx: torch.Tensor):
    """The CSR segments ``[ptr[i], ptr[i+1])`` for every ``i`` in ``idx``,
    concatenated in ``idx`` order: ``(new_ptr, counts, seg_ids, perm)``, with
    ``perm`` indexing the source element arrays, ``seg_ids[k]`` the output
    segment of element ``k`` and ``new_ptr``/``counts`` the output
    segmentation, all in ``ptr``'s dtype. Eager: the output length is read
    from the device."""
    idx = idx.long()
    counts = ptr[idx + 1] - ptr[idx]
    new_ptr = torch.cat([ptr.new_zeros(1), counts.cumsum(0).to(ptr.dtype)])
    total = int(new_ptr[-1])
    seg_ids = torch.repeat_interleave(
        torch.arange(idx.numel(), dtype=ptr.dtype, device=ptr.device),
        counts.long(), output_size=total)
    # element k sits at offset (k - new_ptr[seg]) inside its segment; add
    # the source segment's start to get the source position
    perm = (torch.arange(total, dtype=ptr.dtype, device=ptr.device)
            + (ptr[idx] - new_ptr[:-1])[seg_ids.long()])
    return new_ptr, counts, seg_ids, perm


def scatter_reduce(values: torch.Tensor, index: torch.Tensor,
                   num_segments: int, reduce: str = "sum",
                   indices_are_sorted: bool = False) -> torch.Tensor:
    """COO-style scatter-reduce over unsorted segment ids (``index``);
    ``indices_are_sorted`` is accepted for the JAX signature and changes
    nothing. The mean sums in the value dtype."""
    if reduce in ("sum", "add"):
        return _segment_sum(values, index, num_segments)
    if reduce == "mean":
        return _segment_mean(values, index, num_segments)
    if reduce not in _SCATTER:
        raise ValueError(f"unknown reduction {reduce!r}")
    out = _segment_extreme(values, index, num_segments, reduce)
    counts = _segment_sum(torch.ones(index.shape, dtype=torch.int32,
                                     device=index.device), index,
                          num_segments)
    return _fill_empty(out, counts, reduce)


def bincount(index: torch.Tensor, weights: Optional[torch.Tensor] = None,
             length: int = 0) -> torch.Tensor:
    """``out[i] = sum of weights[k] with index[k] == i`` for ``i <
    length`` (ones, in ``index``'s dtype, when ``weights`` is None); ids
    outside ``[0, length)`` are dropped, so the output always has
    ``length`` entries."""
    if weights is None:
        weights = torch.ones(index.shape, dtype=index.dtype,
                             device=index.device)
    return _segment_sum(weights, index, length)


# ---- sorted rows in groups: reductions and gathers without a hot spot -----

# entries per group: a hub row's entries reach one output address through
# at most GROUP updates, then ceil(len / GROUP) group partials
GROUP = 1024


class RowGroups(NamedTuple):
    """The entries of a sorted row index cut into groups of at most
    ``GROUP`` consecutive entries of one row (a group never crosses a row or
    an aligned block of ``GROUP`` entries). ``group_row`` has room for every
    possible group, ``num_rows + ceil(E / GROUP)``; the unused tail points
    at row 0 and is reached by no entry."""
    entry_group: torch.Tensor   # (E,) int64: each entry's group
    group_row: torch.Tensor     # (G,) int64: each group's row
    num_rows: int


def row_groups(row: torch.Tensor, num_rows: int) -> RowGroups:
    """:class:`RowGroups` of the sorted ``row`` (every id in ``[0,
    num_rows)``), on its device with no host read."""
    E = row.numel()
    row = row.long()
    pos = torch.arange(E, device=row.device)
    start = torch.ones(E, dtype=torch.bool, device=row.device)
    start[1:] = (row[1:] != row[:-1]) | (pos[1:] % GROUP == 0)
    entry_group = torch.cumsum(start, 0) - 1
    group_row = torch.zeros(num_rows + -(-E // GROUP), dtype=torch.long,
                            device=row.device)
    group_row.scatter_(0, entry_group, row)      # a group's entries agree
    return RowGroups(entry_group, group_row, num_rows)


def grouped_sum(values: torch.Tensor, groups: RowGroups) -> torch.Tensor:
    """Per-row sum of ``values`` (one per entry, any trailing dims) in two
    ``index_add`` passes, entries into groups and groups into rows; the
    backward gathers the same two ways (:func:`take_rows`)."""
    part = _AddRows.apply(values, groups.entry_group,
                          groups.group_row.numel())
    return _AddRows.apply(part, groups.group_row, groups.num_rows)


def grouped_max(values: torch.Tensor, groups: RowGroups) -> torch.Tensor:
    """Per-row max of float ``values`` in two ``scatter_reduce`` passes,
    ``-inf`` for an empty row; the gradient is split evenly among tied
    groups, then among tied entries of a group."""
    def amax(src, index, rows):
        out = src.new_full((rows,) + tuple(src.shape[1:]), float("-inf"))
        return out.scatter_reduce(0, _bcast(index, src.dim()).expand_as(src),
                                  src, "amax", include_self=False)
    part = amax(values, groups.entry_group, groups.group_row.numel())
    return amax(part, groups.group_row, groups.num_rows)


def _flat_gather(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` as a gather of single elements by a flat index, built
    here and not kept."""
    width = math.prod(t.shape[1:])
    flat = (index[:, None] * width + torch.arange(
        width, device=index.device)).reshape(-1)
    out = torch.gather(t.reshape(-1), 0, flat)
    return out.reshape((index.numel(),) + tuple(t.shape[1:]))


class _TakeRows(torch.autograd.Function):
    """``t[index]`` by :func:`_flat_gather`, with an ``index_add``
    (:class:`_AddRows`) for its backward; the two are each other's
    backward, so both differentiate at any order."""

    @staticmethod
    def forward(ctx, t, index):
        ctx.save_for_backward(index)
        ctx.rows = t.shape[0]
        return _flat_gather(t, index)

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        return _AddRows.apply(g, index, ctx.rows), None


class _AddRows(torch.autograd.Function):
    """``zeros(rows).index_add(0, index, v)``, with :func:`_flat_gather`
    for its backward (``index_add``'s own is an ``index_select``)."""

    @staticmethod
    def forward(ctx, v, index, rows):
        ctx.save_for_backward(index)
        out = v.new_zeros((rows,) + tuple(v.shape[1:]))
        return out.index_add_(0, index, v)

    @staticmethod
    def backward(ctx, g):
        index, = ctx.saved_tensors
        return _TakeRows.apply(g, index), None, None


def take_rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``t[index]`` for a 1-D int64 ``index`` and narrow rows (a few
    elements): a gather of single elements by a flat index (one thread and
    one int64 per output element; built per call, not saved), and an
    ``index_add`` for the backward. On the card, ``index_select``,
    ``t[index]`` and ``torch.gather`` over rows all launch one block per
    index: 9.49 ms for 15.76M rows of 4 floats against 0.60 ms this way
    (``chip_probe.py gat``); and the backward of ``t[index]`` sorts the
    indices and walks each row's duplicates serially (seconds per GAT step
    on a hub row)."""
    return _TakeRows.apply(t, index)


def grouped_gather(t: torch.Tensor, groups: RowGroups) -> torch.Tensor:
    """``t[row]``, one row of ``t`` per entry, gathered through the groups
    so that no row is read once per entry; the backward sums as
    :func:`grouped_sum` does, in two steps."""
    return take_rows(take_rows(t, groups.group_row), groups.entry_group)
