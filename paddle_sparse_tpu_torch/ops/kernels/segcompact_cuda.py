"""Run compaction on the card: the compress step of SpGEMM and of
``PaddedCOO.coalesce``.

Port of ``paddle_sparse_tpu/ops/kernels/segcompact.py`` (``compact_runs`` ->
``compact_sorted_stream`` -> ``segcompact_call`` -> the Pallas kernel
``_segcompact_kernel``), and the one compress of the port: it also stands for
the XLA segment-op compresses of the JAX ``spspmm_padded``,
``spspmm_rowsorted``, ``spspmm_rowblocked`` and ``PaddedCOO.coalesce``, which
compute the same function.

The stream is a sequence of ``(row, col, value)`` sorted so that equal
coordinates are adjacent; an element is valid when ``0 <= row < M`` and
``0 <= col < N``. Each run of equal valid coordinates becomes one output
entry at slot s, the run's index among all runs: ``(row, col, sum of its
values)``, written for ``s < out_capacity``. The stream comes in one of two
layouts:

* flat: ``col`` and ``rows`` are (L,), the row of each element;
* grid: ``col`` is (R, F), each grid row sorted with pads (``col == N``) at
  its end, and ``rows`` is (R,), the output row of each grid row.

Dtype contract: ``col`` and ``rows`` int32; values f32 or f64 on the card
(any float in the plain version), summed in their own type, in stream order.
Slots past the unique count hold the pad ``(M, N, 0)``. ``count`` is the
unique count, which may exceed ``out_capacity``; it stays on the device.
"""
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

_INT32_LIMIT = 2 ** 31 - 1


class Compacted(NamedTuple):
    row: torch.Tensor               # (out_capacity,) int32, M past the count
    col: torch.Tensor               # (out_capacity,) int32, N past the count
    value: Optional[torch.Tensor]   # (out_capacity, ...), 0 past the count
    count: torch.Tensor             # () int64 unique count, on the device
    seg: Optional[torch.Tensor]     # (L,) int32 slot of each element, or -1


def compact_runs_reference(col: torch.Tensor, rows: torch.Tensor,
                           value: Optional[torch.Tensor],
                           shape: Tuple[int, int], out_capacity: int,
                           seg: bool = False) -> Compacted:
    """Plain PyTorch version of :func:`compact_runs_cuda`, on any device.

    The run-head mask, ``seg = cumsum(first) - 1``, then ``index_add`` of the
    values into their slots. ``value`` may have trailing dims here (the
    kernel takes one value per element)."""
    M, N = int(shape[0]), int(shape[1])
    cap = int(out_capacity)
    c, r = col.reshape(-1).long(), rows.long()
    if col.dim() == 2:                              # grid: a row per grid row
        r = r.repeat_interleave(col.shape[1])
    valid = (c >= 0) & (c < N) & (r >= 0) & (r < M)
    first = valid.clone()
    first[1:] &= (c[1:] != c[:-1]) | (r[1:] != r[:-1])
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
        out_val = torch.zeros((cap + 1,) + tuple(v.shape[1:]), dtype=v.dtype,
                              device=v.device).index_add_(
            0, slot, torch.where(mask, v, v.new_zeros(())))
        out_val = out_val[:cap]
    return Compacted(out_row, out_col, out_val, first.sum(),
                     torch.where(keep, s, -1).int() if seg else None)


def _check_cuda_args(col, rows, value, M, N, out_capacity):
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
    if value is not None:
        if value.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"compact_runs_cuda sums f32 or f64 values, not "
                            f"{value.dtype}")
        if value.shape != col.shape:
            raise ValueError(f"value {tuple(value.shape)} must have col's "
                             f"shape {tuple(col.shape)}")
        if value.device != dev or not value.is_contiguous():
            raise ValueError(f"value must be contiguous and on {dev}")
    if not (0 <= M <= _INT32_LIMIT and 0 <= N <= _INT32_LIMIT):
        raise ValueError(f"shape ({M}, {N}): M and N must lie in "
                         f"[0, 2**31) (int32 coordinates, pads M and N)")
    if not 0 <= out_capacity < 2 ** 31:
        raise ValueError(f"out_capacity {out_capacity} must lie in "
                         f"[0, 2**31): slots are int32")


def compact_runs_cuda(col: torch.Tensor, rows: torch.Tensor,
                      value: Optional[torch.Tensor], shape: Tuple[int, int],
                      out_capacity: int, seg: bool = False) -> Compacted:
    """Run compaction through the CUDA kernel ``csrc/segcompact.cu``.

    ``col`` is (L,) with ``rows`` (L,) (flat) or (R, F) with ``rows`` (R,)
    (grid), both contiguous int32; ``value`` is None or contiguous f32/f64 of
    ``col``'s shape. With ``seg`` the kernel also writes each element's slot
    (-1 for pads and for slots past ``out_capacity``), which the value
    gradient gathers through. On a CPU tensor this runs
    :func:`compact_runs_reference`; on a CUDA tensor it launches the kernel
    or raises. ``compact_runs_cuda.launches`` counts calls that launched the
    kernel (its two passes are one launch here)."""
    if col.device.type == "cpu":
        return compact_runs_reference(col, rows, value, shape, out_capacity,
                                      seg)
    if col.device.type != "cuda":
        raise ValueError(f"compact_runs_cuda runs on cpu or cuda, not "
                         f"{col.device}")
    M, N, cap = int(shape[0]), int(shape[1]), int(out_capacity)
    _check_cuda_args(col, rows, value, M, N, cap)
    dev = col.device
    L = col.numel()
    out_row = torch.full((cap,), M, dtype=torch.int32, device=dev)
    out_col = torch.full((cap,), N, dtype=torch.int32, device=dev)
    out_val = (None if value is None
               else torch.zeros(cap, dtype=value.dtype, device=dev))
    seg_t = torch.empty(L, dtype=torch.int32, device=dev) if seg else None
    if L == 0:
        return Compacted(out_row, out_col, out_val,
                         torch.zeros((), dtype=torch.int64, device=dev), seg_t)
    row_div = col.shape[1] if col.dim() == 2 else 1
    lib = _build.load_library()
    tiles = -(-L // lib.psp_segcompact_tile())
    counts = torch.empty(tiles, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.psp_segcompact_count(col.data_ptr(), rows.data_ptr(),
                                       row_div, L, M, N, counts.data_ptr(),
                                       stream)
        if err != 0:
            raise RuntimeError(f"segcompact count kernel launch failed: CUDA "
                               f"error {err}")
        ends = counts.cumsum(0)
        err = lib.psp_segcompact_write(
            col.data_ptr(), rows.data_ptr(), row_div, L, M, N,
            0 if value is None else value.data_ptr(),
            int(value is not None and value.dtype == torch.float64),
            ends.data_ptr(), cap, out_row.data_ptr(), out_col.data_ptr(),
            0 if out_val is None else out_val.data_ptr(),
            0 if seg_t is None else seg_t.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"segcompact write kernel launch failed: CUDA "
                           f"error {err}")
    compact_runs_cuda.launches += 1
    return Compacted(out_row, out_col, out_val, ends[-1], seg_t)


compact_runs_cuda.launches = 0


class _CompactRuns(torch.autograd.Function):
    """:func:`compact_runs_cuda` over ``value``. The JAX VJP
    (``segcompact.py::_compact_runs_bwd``) is one gather,
    ``d value[e] = d out[seg[e]]`` where ``seg[e]`` is a slot, else 0; it is
    plain PyTorch here as it is XLA there. ``seg`` comes from the forward
    kernel, which writes it for 4 bytes an element, instead of being
    recomputed from the keys (a compare, a cumsum and a mask over the whole
    stream, several times those bytes)."""

    @staticmethod
    def forward(ctx, value, col, rows, shape, out_capacity):
        out = compact_runs_cuda(col, rows, value, shape, out_capacity,
                                seg=True)
        ctx.save_for_backward(out.seg)
        ctx.value_shape = value.shape
        ctx.mark_non_differentiable(out.row, out.col, out.count)
        return out.row, out.col, out.value, out.count

    @staticmethod
    @once_differentiable
    def backward(ctx, g_row, g_col, g_value, g_count):
        seg, = ctx.saved_tensors
        hit = seg >= 0
        g = g_value.contiguous()
        if g.shape[0] == 0:                 # out_capacity 0: nothing kept
            d = g.new_zeros((seg.numel(),) + tuple(g.shape[1:]))
        else:
            d = g.index_select(0, seg.clamp(min=0).long())
            d = torch.where(hit.reshape((-1,) + (1,) * (d.dim() - 1)), d,
                            torch.zeros((), dtype=d.dtype, device=d.device))
        return d.reshape(ctx.value_shape), None, None, None, None


def compact_runs(col: torch.Tensor, rows: torch.Tensor,
                 value: Optional[torch.Tensor], shape: Tuple[int, int],
                 out_capacity: int) -> Compacted:
    """:func:`compact_runs_cuda`, differentiable in ``value`` (double
    backward raises); ``seg`` of the result is None."""
    if value is None or not (torch.is_grad_enabled() and value.requires_grad):
        return compact_runs_cuda(col, rows, value, shape, out_capacity)
    row, col_out, val, count = _CompactRuns.apply(value, col, rows, shape,
                                                  out_capacity)
    return Compacted(row, col_out, val, count, None)
