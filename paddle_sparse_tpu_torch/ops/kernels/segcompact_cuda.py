"""Run compaction on the card: the compress step of SpGEMM and of
``PaddedCOO.coalesce``.

Port of ``paddle_sparse_tpu/ops/kernels/segcompact.py`` (``compact_runs`` ->
``compact_sorted_stream`` -> ``segcompact_call`` -> the Pallas kernel
``_segcompact_kernel``), and the one compress of the port: it also stands for
the XLA segment-op compresses of the JAX ``spspmm_padded``,
``spspmm_rowsorted``, ``spspmm_rowblocked`` and ``PaddedCOO.coalesce``, which
compute the same function, and for the per-row sort before the grid ones.

The input is a sequence of ``(row, col, value)``; an element is valid when
``0 <= row < M`` and ``0 <= col < N``. Each run of equal valid coordinates
becomes one output entry at slot s, the run's index among all runs in
``(row, col)`` order: ``(row, col, sum of its values)``, written for
``s < out_capacity``. The input comes in one of two layouts:

* flat: ``col`` and ``rows`` are (L,), the row of each element, sorted by
  ``(row, col)`` so that equal coordinates are adjacent;
* grid: ``col`` is (R, F) and ``rows`` is (R,), the output row of each grid
  row, distinct from its neighbours' (runs never cross grid rows). With
  ``rows_sorted=True`` each grid row is sorted by col, pads (``col == N``)
  last; with ``rows_sorted=False`` the grid rows come in any order and the
  compaction orders each one itself, stably, as ``torch.sort(stable=True)``
  would.

Dtype contract: ``col`` and ``rows`` int32; values f32, bf16, f16, f64,
int32 or int64, on the card and in the plain version alike: f16 and bf16
summed in f32 and rounded once per run, the others in their own type (ints
exact, wrapping as torch's do). Each run in position order (stream order, or
a grid row's stable sorted order; the stream kernel's scalar path sums runs
of more than 8 elements in a fixed tree). On a flat stream the values may
have trailing dims, ``(L, D...)``: each run sums its D-vectors lane by lane,
in position order, in the kernel (``coalesce``'s vector values); the grid
layouts (SpGEMM) take one value per element. Slots past the unique count
hold the pad ``(M, N, 0)``. ``count`` is the unique count, which may exceed
``out_capacity``; it stays on the device. ``seg`` gives each element's slot
in the input's own order.
"""
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_INT32_LIMIT = 2 ** 31 - 1
# the value dtypes the kernels sum (csrc/segcompact.cuh's value codes)
VALUE_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
                torch.int32, torch.int64)
# the longest grid row the kernel sorts itself (kFMax in csrc/segcompact.cu):
# 32 keys a lane of one warp, in registers
F_MAX = 1024


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a run of ``dtype`` values is summed in: f32 for f16 and
    bf16, the dtype itself otherwise."""
    return (torch.float32 if dtype in (torch.float16, torch.bfloat16)
            else dtype)


class Compacted(NamedTuple):
    row: torch.Tensor               # (out_capacity,) int32, M past the count
    col: torch.Tensor               # (out_capacity,) int32, N past the count
    value: Optional[torch.Tensor]   # (out_capacity, ...), 0 past the count
    count: torch.Tensor             # () int64 unique count, on the device
    seg: Optional[torch.Tensor]     # (L,) int32 slot of each element, or -1


def _check_mode(col: torch.Tensor, rows_sorted: bool) -> None:
    if not rows_sorted and col.dim() != 2:
        raise ValueError("rows_sorted=False orders the rows of an (R, F) "
                         f"grid; a flat stream ({tuple(col.shape)}) must come "
                         f"sorted")


def compact_runs_reference(col: torch.Tensor, rows: torch.Tensor,
                           value: Optional[torch.Tensor],
                           shape: Tuple[int, int], out_capacity: int,
                           seg: bool = False,
                           rows_sorted: bool = True) -> Compacted:
    """Plain PyTorch version of :func:`compact_runs_cuda`, on any device.

    With ``rows_sorted=False``, a stable sort of each grid row by col (pads
    last) first. Then the run-head mask, ``seg = cumsum(first) - 1``, and
    ``index_add`` of the values into their slots, in :func:`sum_dtype`,
    rounded once; ``seg`` is mapped back to the input's order. ``value`` may
    have trailing dims."""
    _check_mode(col, rows_sorted)
    M, N = int(shape[0]), int(shape[1])
    cap = int(out_capacity)
    grid = col.dim() == 2
    c, r = col.long(), rows.long()
    if grid:                                        # a row per grid row
        r = r[:, None].expand(col.shape)
    valid = (c >= 0) & (c < N) & (r >= 0) & (r < M)
    perm = None
    if not rows_sorted:
        c, perm = torch.sort(torch.where(valid, c, N), dim=1, stable=True)
        valid = valid.gather(1, perm)
        if value is not None:
            idx = perm.reshape(perm.shape + (1,) * (value.dim() - 2))
            value = value.gather(1, idx.expand(value.shape))
    c, r, valid = c.reshape(-1), r.reshape(-1), valid.reshape(-1)
    first = valid.clone()
    first[1:] &= (c[1:] != c[:-1]) | (r[1:] != r[:-1])
    if grid and col.shape[1]:                       # runs end with the row
        first.view(col.shape)[:, 0] = valid.view(col.shape)[:, 0]
    s = first.cumsum(0) - 1
    keep = valid & (s < cap)
    heads = first & keep
    out_row = torch.full((cap,), M, dtype=torch.int32, device=c.device)
    out_col = torch.full((cap,), N, dtype=torch.int32, device=c.device)
    out_row[s[heads]] = r[heads].int()
    out_col[s[heads]] = c[heads].int()
    out_val = None
    if value is not None:
        v = value.reshape((c.numel(),) + tuple(value.shape[col.dim():]))
        mask = keep.reshape((-1,) + (1,) * (v.dim() - 1))
        slot = torch.where(keep, s, cap)            # cap: a dump slot
        acc = sum_dtype(v.dtype)
        out_val = torch.zeros((cap + 1,) + tuple(v.shape[1:]), dtype=acc,
                              device=v.device).index_add_(
            0, slot, torch.where(mask, v, v.new_zeros(())).to(acc))
        out_val = out_val[:cap].to(v.dtype)
    seg_t = None
    if seg:
        seg_t = torch.where(keep, s, -1).int()
        if perm is not None:                        # back to input order
            seg_t = torch.empty_like(seg_t).view(col.shape).scatter_(
                1, perm, seg_t.view(col.shape)).reshape(-1)
    return Compacted(out_row, out_col, out_val, first.sum(), seg_t)


def _check_cuda_args(col, rows, value, M, N, out_capacity, rows_sorted):
    dev = col.device
    for name, t in (("col", col), ("rows", rows)):
        if t.dtype != torch.int32:
            raise TypeError(f"compact_runs_cuda takes int32 {name}, got "
                            f"{t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    if col.dim() not in (1, 2) or rows.dim() != 1:
        raise ValueError(f"col must be 1-D (flat) or 2-D (grid) and rows "
                         f"1-D, got {tuple(col.shape)} and "
                         f"{tuple(rows.shape)}")
    want = col.shape[0]
    if rows.shape[0] != want:
        raise ValueError(f"rows has {rows.shape[0]} entries, col's layout "
                         f"{tuple(col.shape)} needs {want}")
    if not rows_sorted and col.shape[1] > F_MAX:
        raise ValueError(f"the kernel sorts grid rows of at most F_MAX = "
                         f"{F_MAX} slots, not {col.shape[1]}: sort them first "
                         f"and pass rows_sorted=True")
    if value is not None:
        if value.dtype not in VALUE_DTYPES:
            raise TypeError(f"compact_runs_cuda sums values in {VALUE_DTYPES}"
                            f", not {value.dtype}")
        lead = tuple(value.shape[:col.dim()])
        if lead != tuple(col.shape) or (col.dim() == 2
                                        and value.dim() != 2):
            raise ValueError(f"value {tuple(value.shape)} must have col's "
                             f"shape {tuple(col.shape)}, or on a flat stream "
                             f"(L, D...)")
        if value.device != dev or not value.is_contiguous():
            raise ValueError(f"value must be contiguous and on {dev}")
    if not (0 <= M <= _INT32_LIMIT and 0 <= N <= _INT32_LIMIT):
        raise ValueError(f"shape ({M}, {N}): M and N must lie in "
                         f"[0, 2**31) (int32 coordinates, pads M and N)")
    if not 0 <= out_capacity < 2 ** 31:
        raise ValueError(f"out_capacity {out_capacity} must lie in "
                         f"[0, 2**31): slots are int32")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def compact_runs_cuda(col: torch.Tensor, rows: torch.Tensor,
                      value: Optional[torch.Tensor], shape: Tuple[int, int],
                      out_capacity: int, seg: bool = False,
                      rows_sorted: bool = True) -> Compacted:
    """Run compaction through the CUDA kernels of ``csrc/segcompact.cu``.

    ``col`` is (L,) with ``rows`` (L,) (flat) or (R, F) with ``rows`` (R,)
    (grid), both contiguous int32; ``value`` is None or contiguous, of
    ``VALUE_DTYPES``, of ``col``'s shape or (flat only) ``(L, D...)``: each
    run's D-vectors summed lane by lane by the trailing-dim pass after the
    structure pass. ``rows_sorted=False`` (grids of ``F <= F_MAX`` only)
    lets the kernel sort each grid row. With ``seg`` the kernel also writes
    each element's slot, in input order (-1 for pads and for slots past
    ``out_capacity``), which the value gradient gathers through.

    Which kernel runs is a matter of shape: a grid of ``F <= F_MAX``, sorted
    or not, goes to the row kernel (a warp a grid row, sorted in
    registers); a flat stream, or a sorted grid wider than ``F_MAX``, to the
    stream kernel. A CPU tensor runs :func:`compact_runs_reference`; a CUDA
    tensor launches a kernel or raises. ``compact_runs_cuda.launches``
    counts calls that launched a kernel, ``launches_row_sorted`` those in
    which the kernel sorted the grid rows itself."""
    if col.device.type == "cpu":
        return compact_runs_reference(col, rows, value, shape, out_capacity,
                                      seg, rows_sorted)
    if col.device.type != "cuda":
        raise ValueError(f"compact_runs_cuda runs on cpu or cuda, not "
                         f"{col.device}")
    _check_mode(col, rows_sorted)
    M, N, cap = int(shape[0]), int(shape[1]), int(out_capacity)
    _check_cuda_args(col, rows, value, M, N, cap, rows_sorted)
    dev = col.device
    L = col.numel()
    out_row = torch.empty(cap, dtype=torch.int32, device=dev)
    out_col = torch.empty(cap, dtype=torch.int32, device=dev)
    trail = () if value is None else tuple(value.shape[col.dim():])
    D = math.prod(trail)
    out_val = (None if value is None
               else torch.empty((cap,) + trail, dtype=value.dtype,
                                device=dev))
    seg_t = torch.empty(L, dtype=torch.int32, device=dev) if seg else None
    if D == 0:                      # (L, 0) values: the structure alone
        out = compact_runs_cuda(col, rows, None, shape, cap, seg,
                                rows_sorted)
        return out._replace(value=out_val)
    if L == 0:
        out_row.fill_(M)
        out_col.fill_(N)
        if out_val is not None:
            out_val.zero_()
        return Compacted(out_row, out_col, out_val,
                         torch.zeros((), dtype=torch.int64, device=dev), seg_t)
    lib = _build.load_library()
    rows_kernel = col.dim() == 2 and col.shape[1] <= F_MAX
    R, F = (col.shape[0], col.shape[1]) if col.dim() == 2 else (L, 1)
    tiles = lib.psp_segcompact_tiles(R, F, L, int(rows_kernel))
    count = torch.empty((), dtype=torch.int64, device=dev)
    code = 0 if value is None else _build.dtype_code(value.dtype)
    ws = torch.zeros(tiles + 1, dtype=torch.int64, device=dev)
    if rows_kernel:
        _build.launch("segcompact", lib.psp_segcompact_rows, dev,
                      col.data_ptr(), rows.data_ptr(), R, F, M, N,
                      _ptr(value), code, int(not rows_sorted), cap,
                      out_row.data_ptr(), out_col.data_ptr(), _ptr(out_val),
                      _ptr(seg_t), count.data_ptr(), ws.data_ptr())
    else:
        meta = part = None
        seg_ws = seg_t
        if value is not None and D == 1:
            meta = torch.empty(tiles, dtype=torch.int64, device=dev)
            part = torch.empty(2 * tiles, dtype=sum_dtype(value.dtype),
                               device=dev)
        elif value is not None and seg_ws is None:  # the vector pass reads it
            seg_ws = torch.empty(L, dtype=torch.int32, device=dev)
        _build.launch("segcompact", lib.psp_segcompact_stream, dev,
                      col.data_ptr(), rows.data_ptr(), F, L, M, N,
                      _ptr(value), code, D, cap, out_row.data_ptr(),
                      out_col.data_ptr(), _ptr(out_val), _ptr(seg_ws),
                      count.data_ptr(), ws.data_ptr(), _ptr(meta),
                      _ptr(part))
    compact_runs_cuda.launches += 1
    if not rows_sorted:
        compact_runs_cuda.launches_row_sorted += 1
    return Compacted(out_row, out_col, out_val, count, seg_t)


compact_runs_cuda.launches = 0
compact_runs_cuda.launches_row_sorted = 0


def _bcast_hit(hit: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return hit.reshape((-1,) + (1,) * (d.dim() - 1))


class _SlotGather(torch.autograd.Function):
    """``d[e] = g[seg[e]]`` where ``seg[e]`` is a slot (``>= 0``), else 0:
    the backward of the run compaction. Its own backward is
    :class:`_SlotScatter`, so the compaction differentiates at any order."""

    @staticmethod
    def forward(ctx, g, seg):
        ctx.save_for_backward(seg)
        ctx.slots = g.shape[0]
        if g.shape[0] == 0:                 # out_capacity 0: nothing kept
            return g.new_zeros((seg.numel(),) + tuple(g.shape[1:]))
        d = g.index_select(0, seg.clamp(min=0).long())
        return torch.where(_bcast_hit(seg >= 0, d), d,
                           torch.zeros((), dtype=d.dtype, device=d.device))

    @staticmethod
    def backward(ctx, gg):
        seg, = ctx.saved_tensors
        return _SlotScatter.apply(gg.contiguous(), seg, ctx.slots), None


class _SlotScatter(torch.autograd.Function):
    """The transpose of :class:`_SlotGather`: ``out[j] = sum over e with
    seg[e] = j of gg[e]``, into ``slots`` rows (an ``index_add_``; the JAX
    package leaves this transpose to XLA)."""

    @staticmethod
    def forward(ctx, gg, seg, slots):
        ctx.save_for_backward(seg)
        hit = seg >= 0
        out = gg.new_zeros((slots,) + tuple(gg.shape[1:]))
        return out.index_add_(0, seg[hit].long(), gg[hit])

    @staticmethod
    def backward(ctx, g):
        seg, = ctx.saved_tensors
        return _SlotGather.apply(g.contiguous(), seg), None, None


class _CompactRuns(torch.autograd.Function):
    """:func:`compact_runs_cuda` over ``value``. The JAX VJP
    (``segcompact.py::_compact_runs_bwd``) is one gather,
    ``d value[e] = d out[seg[e]]`` where ``seg[e]`` is a slot, else 0; it is
    plain PyTorch here as it is XLA there (:class:`_SlotGather`, which
    differentiates again). ``seg`` comes from the forward
    kernel, which writes it for 4 bytes an element, instead of being
    recomputed from the keys (a compare, a cumsum and a mask over the whole
    stream, several times those bytes)."""

    @staticmethod
    def forward(ctx, value, col, rows, shape, out_capacity, rows_sorted):
        out = compact_runs_cuda(col, rows, value, shape, out_capacity,
                                seg=True, rows_sorted=rows_sorted)
        ctx.save_for_backward(out.seg)
        ctx.value_shape = value.shape
        ctx.mark_non_differentiable(out.row, out.col, out.count)
        return out.row, out.col, out.value, out.count

    @staticmethod
    def backward(ctx, g_row, g_col, g_value, g_count):
        seg, = ctx.saved_tensors
        d = _SlotGather.apply(g_value.contiguous(), seg)
        return d.reshape(ctx.value_shape), None, None, None, None, None


def compact_runs(col: torch.Tensor, rows: torch.Tensor,
                 value: Optional[torch.Tensor], shape: Tuple[int, int],
                 out_capacity: int, rows_sorted: bool = True) -> Compacted:
    """:func:`compact_runs_cuda`, differentiable in ``value`` at any
    order; ``seg`` of the result is None."""
    if value is None or not (torch.is_grad_enabled() and value.requires_grad):
        return compact_runs_cuda(col, rows, value, shape, out_capacity,
                                 rows_sorted=rows_sorted)
    row, col_out, val, count = _CompactRuns.apply(value, col, rows, shape,
                                                  out_capacity, rows_sorted)
    return Compacted(row, col_out, val, count, None)
