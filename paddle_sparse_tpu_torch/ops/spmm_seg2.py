"""Packed-layout SpMM (``seg2``): ``A @ x`` (sum) over edges sorted by
(source segment, row), differentiable in the packed values and ``x``.

Port of ``paddle_sparse_tpu/ops/spmm_seg2.py``, the JAX package's flagship
SpMM. Users plan once per static graph (:func:`make_seg2_plan`), convert the
values once into the packed order (:func:`pack_values`) and call
:func:`spmm_seg2` for every forward and backward.

The layouts are the JAX package's, array for array. Forward: edges stably
bucketed by the segment ``col >> lg2(SR)`` of their source row (rows stay
sorted inside a segment), columns made local to the segment's slice base
``sbase_f`` and per-segment absolute row pointers ``rp_f`` (S, M+1).
Transpose: edges in (segment of ``row``, ``col``) order with ``rp_t``
(S_t, N+1) over ``x``'s rows, and the relay ``relay_ft`` that carries packed
values into that order. ``SR`` comes from the same rule (:func:`_pick_sr`,
kept identical), because it fixes the packed order.

What runs on the card:

* forward: one multi-span SpMM launch
  (:func:`~.kernels.spmm_spans_cuda.spmm_spans_cuda`) over
  ``(rp_f, col_f, sbase_f)``;
* ``d x``: one multi-span launch over ``(rp_t, col_t, sbase_t)`` with
  ``packed[relay_ft]``;
* ``d value``: one span-SDDMM launch
  (:func:`~.kernels.sddmm_cuda.sddmm_spans_cuda`) over the forward layout,
  written in the packed order.

The planner also builds the piece tables of both layouts
(:class:`~.kernels.row_split.RowSplit`: a row, or an ``x`` row of the
transpose, of more than ``row_split.CAP`` edges is cut across warps), so a
power-law graph's hub rows do not each hold up a whole launch; ``None``
when nothing is that long.

Not ported, because it is TPU scheduling for the windowed Pallas pass: the
sub-window machinery (``W``, ``ECW``, ``CRW``, ``chunk``, the ``*_s`` SDDMM
windows, ``rlo_*``, ``seg_of_*``, ``wptr_*``, ``_window_counts``,
``_flat_geom``, ``WINDOW_BYTES``) and the padding of ``x`` to ``SR`` rows. The
counting sort (``_counting_order``, a TPU toolchain workaround) is a stable
``torch.argsort``. Gathers run in :func:`~.kernels.spmm_spans_cuda.
product_dtype` (bf16 with ``stream="bf16"``), multiplied and summed in f32.
"""
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from .kernels.row_split import RowSplit, split_lengths
from .kernels.sddmm_cuda import sddmm_spans_cuda
from .kernels.spmm_spans_cuda import product_dtype, spmm_spans_cuda

# the JAX package's fast-gather source ceiling (bytes, measured on a TPU
# v5e); kept because it sets SR, and SR fixes the packed order
FAST_SRC_BYTES = 64 << 20


class Seg2Plan(NamedTuple):
    """Static geometry for :func:`spmm_seg2`."""
    num_rows: int
    num_cols: int
    S: int             # source segments (forward)
    SR: int            # rows per source segment (power of two)
    S_t: int           # transpose-side segments (source = g)
    SR_t: int
    stream: str = "f32"


class Seg2Structure(NamedTuple):
    """The packed index structure (int32 tensors on the plan's device)."""
    col_f: torch.Tensor     # (nnz,) source-slice-local cols, fwd layout
    rp_f: torch.Tensor      # (S, M+1) absolute row pointers per segment
    perm_f: torch.Tensor    # (nnz,) fwd position -> COO position
    sbase_f: torch.Tensor   # (S,) source slice base rows (clamped)
    col_t: torch.Tensor     # (nnz,) slice-local g rows, transpose layout
    rp_t: torch.Tensor      # (S_t, N+1) absolute out-row pointers
    sbase_t: torch.Tensor   # (S_t,)
    relay_ft: torch.Tensor  # (nnz,) t position -> fwd position (values)
    split_f: Optional[RowSplit]  # pieces of the fwd layout's M rows
    split_t: Optional[RowSplit]  # pieces of the transpose's N rows


def _lg2(v: int) -> int:
    return int(v).bit_length() - 1


def _pick_sr(num_src_rows: int, feat_dim: int, stream_bytes: int) -> int:
    sr = 1 << _lg2(max(8, FAST_SRC_BYTES // max(1, feat_dim
                                                * stream_bytes)))
    # no point segmenting finer than the (pow2-rounded) source itself
    while sr // 2 >= num_src_rows and sr > 8:
        sr //= 2
    return sr


def _seg_rowptrs(seg: torch.Tensor, row: torch.Tensor, S: int,
                 M: int) -> torch.Tensor:
    """(S, M+1) absolute row pointers of a (segment, row)-sorted stream:
    ``rp[s, m]`` counts the edges before (s, m) in that order, from one
    bincount over the key ``s * M + row`` and its cumsum."""
    counts = torch.bincount(seg.long() * M + row.long(), minlength=S * M)
    ptr = torch.zeros(S * M + 1, dtype=torch.int64, device=seg.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32)


def _slice_bases(S: int, SR: int, num_src_rows: int,
                 device) -> torch.Tensor:
    """Slice base rows ``s * SR``, clamped so the last slice stays inside
    the source."""
    return (torch.arange(S, device=device, dtype=torch.int32) * SR).clamp(
        max=max(0, num_src_rows - SR))


def _layout(seg: torch.Tensor, order: torch.Tensor, sbase: torch.Tensor,
            local: torch.Tensor, rows_of_out: torch.Tensor, S: int,
            out_rows: int):
    """Slice-local source indices and (S, out_rows+1) row pointers of the
    edges in ``order``."""
    seg_o = seg[order]
    col_o = local[order] - sbase[seg_o]
    return col_o, _seg_rowptrs(seg_o, rows_of_out[order], S, out_rows)


def _check_indices(row: torch.Tensor, col: torch.Tensor, M: int, N: int,
                   who: str):
    row, col = torch.as_tensor(row), torch.as_tensor(col)
    col = col.to(row.device)
    if row.dim() != 1 or row.shape != col.shape:
        raise ValueError(f"{who}: row and col must be 1-D of one length, got "
                         f"{tuple(row.shape)} and {tuple(col.shape)}")
    if row.dtype.is_floating_point or col.dtype.is_floating_point:
        raise TypeError(f"{who}: row and col must be integer tensors")
    if max(M, N, row.numel()) >= 2 ** 31:
        raise ValueError(f"{who} indexes with int32: M, N and nnz must each "
                         f"be below 2**31")
    if row.numel():
        if bool((row[1:] < row[:-1]).any()):
            raise ValueError(
                f"{who} requires row indices sorted ascending (canonical "
                f"COO order); sort/coalesce the structure first")
        lo = torch.stack([row.min(), col.min()]).tolist()
        hi = torch.stack([row.max(), col.max()]).tolist()
        if min(lo) < 0 or hi[0] >= M or hi[1] >= N:
            raise ValueError(f"{who}: indices out of range for shape "
                             f"({M}, {N})")
    return row.to(torch.int32), col.to(torch.int32)


def _segment_size(sr: Optional[int], num_src_rows: int, feat_dim: int,
                  stream: str) -> int:
    if stream not in ("f32", "bf16"):
        raise ValueError(f"stream must be 'f32' or 'bf16', not {stream!r}")
    SR = sr or _pick_sr(num_src_rows, feat_dim, 2 if stream == "bf16" else 4)
    if SR <= 0 or SR & (SR - 1):
        # a non-power-of-two SR would put edges past the segment count
        raise ValueError(f"segment size must be a power of two, got {SR}")
    return SR


def build_layouts(row: torch.Tensor, col: torch.Tensor, M: int, N: int, *,
                  SR: int, SR_t: int):
    """The forward and transpose layouts of row-sorted int32 ``row``/``col``
    (the JAX package's ``_build_fwd``, ``_build_t`` and ``_relays``) and
    their piece tables: ``(S, S_t, col_f, rp_f, perm_f, sbase_f, col_t,
    rp_t, sbase_t, relay_ft, split_f, split_t)``. The JAX structure's
    ``row_f`` is ``row[perm_f]``: no kernel reads it (they read ``rp_f``),
    so it is not kept. A row's edges over all segments are its degree, so
    the tables come from two bincounts."""
    dev = row.device
    S = max(1, -(-N // SR))
    S_t = max(1, -(-M // SR_t))
    nnz = row.numel()
    # forward: stable bucket by x-segment; rows stay sorted within one
    seg = col >> _lg2(SR)
    perm_f = torch.argsort(seg, stable=True)
    sbase_f = _slice_bases(S, SR, N, dev)
    col_f, rp_f = _layout(seg, perm_f, sbase_f, col, row, S, M)
    # transpose: (g-segment of row, col) order, ties in COO order
    seg_t = row >> _lg2(SR_t)
    perm_t = torch.argsort(seg_t.long() * N + col, stable=True)
    sbase_t = _slice_bases(S_t, SR_t, M, dev)
    col_t, rp_t = _layout(seg_t, perm_t, sbase_t, row, col, S_t, N)
    # the value relay, t position -> fwd position
    inv_f = torch.empty(nnz, dtype=torch.int32, device=dev)
    inv_f[perm_f] = torch.arange(nnz, dtype=torch.int32, device=dev)
    split_f = split_lengths(torch.bincount(row, minlength=M))
    split_t = split_lengths(torch.bincount(col, minlength=N))
    return (S, S_t, col_f, rp_f, perm_f.to(torch.int32), sbase_f, col_t,
            rp_t, sbase_t, inv_f[perm_t], split_f, split_t)


def make_seg2_plan(row, col, num_rows: int, num_cols: int, *,
                   feat_dim: int, stream: str = "f32",
                   sr: Optional[int] = None):
    """``(plan, structure)`` for :func:`spmm_seg2`, built on ``row``'s
    device. ``row`` must be sorted ascending (canonical COO order);
    ``stream`` is ``"f32"`` or ``"bf16"`` (gather ``x`` in bf16); ``sr``
    overrides the segment size (a power of two; testing and tuning)."""
    M, N = num_rows, num_cols
    row, col = _check_indices(row, col, M, N, "make_seg2_plan")
    SR = _segment_size(sr, N, feat_dim, stream)
    SR_t = _segment_size(sr, M, feat_dim, stream)
    (S, S_t, *arrays) = build_layouts(row, col, M, N, SR=SR, SR_t=SR_t)
    plan = Seg2Plan(M, N, S, SR, S_t, SR_t, stream=stream)
    structure = Seg2Structure(*arrays)
    return plan, structure


def pack_values(s, value: torch.Tensor) -> torch.Tensor:
    """COO-ordered (nnz,) values -> the forward packed layout (once per
    operand; the packed vector is the autograd leaf)."""
    return value.index_select(0, s.perm_f)


def unpack_values(s, packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_values`."""
    return packed.new_zeros(packed.shape).index_copy(0, s.perm_f.long(),
                                                     packed)


def _spans(rp: torch.Tensor, rows: int, col: torch.Tensor,
           base: torch.Tensor, value: Optional[torch.Tensor],
           x: torch.Tensor, pdt: torch.dtype,
           split: Optional[RowSplit]) -> torch.Tensor:
    """One multi-span SpMM over a packed layout and its piece table: ``x``
    gathered in ``pdt`` (a bf16 ``x`` is read as it is: widening is exact),
    output in ``x``'s dtype."""
    src = x if x.dtype in (pdt, torch.bfloat16) else x.to(pdt)
    out_dtype = (x.dtype if x.dtype in (torch.float32, torch.bfloat16)
                 else torch.float32)
    return spmm_spans_cuda(rp[:, :rows], rp[:, 1:rows + 1], col, value, base,
                           src, out_dtype=out_dtype,
                           split=split).to(x.dtype)


class _PackedSpmm(torch.autograd.Function):
    """``A @ x`` over ``(packed_value, x)`` for a seg2 or seg3 plan and
    structure (the same fields), which are closed over."""

    @staticmethod
    def forward(ctx, packed_value, x, plan, s):
        ctx.save_for_backward(packed_value, x)
        ctx.plan, ctx.s = plan, s
        pdt = product_dtype(packed_value, x, plan.stream)
        return _spans(s.rp_f, plan.num_rows, s.col_f, s.sbase_f,
                      packed_value, x, pdt, s.split_f)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        packed_value, x = ctx.saved_tensors
        plan, s = ctx.plan, ctx.s
        g = g.contiguous()       # the grad of a sum is stride-0
        pdt = product_dtype(packed_value, g, plan.stream)
        d_value = d_x = None
        if ctx.needs_input_grad[1]:
            value_t = (None if packed_value is None
                       else packed_value.index_select(0, s.relay_ft))
            d_x = _spans(s.rp_t, plan.num_cols, s.col_t, s.sbase_t, value_t,
                         g, pdt, s.split_t).to(x.dtype)
        if ctx.needs_input_grad[0]:
            M = plan.num_rows
            d_value = sddmm_spans_cuda(
                s.rp_f[:, :M], s.rp_f[:, 1:M + 1], s.col_f, s.sbase_f,
                g.to(pdt), x.to(pdt), split=s.split_f).to(packed_value.dtype)
        return d_value, d_x, None, None


def packed_spmm(plan, s, packed_value: Optional[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_seg2` for any plan and structure with the seg2 fields
    (``ops/spmm_seg3.py`` shares it)."""
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be (N={plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if packed_value is not None and packed_value.shape != s.col_f.shape:
        raise ValueError(f"packed values {tuple(packed_value.shape)} do not "
                         f"match the structure's nnz {s.col_f.numel()}")
    return _PackedSpmm.apply(packed_value, x.contiguous(), plan, s)


def spmm_seg2(plan: Seg2Plan, s: Seg2Structure,
              packed_value: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (sum reduction), differentiable in ``(packed_value, x)``.

    ``packed_value``: values in the forward packed layout
    (:func:`pack_values`), or ``None`` for structural ones. ``x`` is
    (N, K); the output (M, K) has ``x``'s dtype. Double backward raises."""
    return packed_spmm(plan, s, packed_value, x)
