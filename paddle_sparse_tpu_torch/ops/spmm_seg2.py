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
* ``d x`` and ``d value`` together (:func:`fused_span_backward`): one
  launch of the fused span backward
  (:func:`~.kernels.spmm_sddmm_cuda.spmm_sddmm_spans_cuda`) over the
  transpose layout ``(rp_t, col_t, sbase_t)`` on ``packed[relay_ft]``,
  one gather of ``g`` for both, ``d value`` read back into the packed
  order through ``relay_tf``;
* ``d x`` alone: one multi-span launch over the transpose layout with
  ``packed[relay_ft]``; ``d value`` alone: one span-SDDMM launch
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
import functools
from typing import NamedTuple, Optional

import torch

from .convert import invert_perm
from .kernels.row_split import RowSplit, split_lengths
from .kernels.sddmm_cuda import sddmm_spans_cuda
from .kernels.spmm_sddmm_cuda import spmm_sddmm_spans_cuda
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
    relay_tf: torch.Tensor  # (nnz,) its inverse: fwd position -> t position
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


def relays(perm_f: torch.Tensor, perm_t: torch.Tensor):
    """``(relay_ft, relay_tf)`` of a forward and a transpose order of the
    same COO entries (each packed position -> COO position):
    ``relay_ft[e]`` is the forward position of transpose position ``e``,
    ``relay_tf`` its inverse."""
    relay_ft = invert_perm(perm_f.to(torch.int32))[perm_t.long()]
    return relay_ft, invert_perm(relay_ft)


def build_layouts(row: torch.Tensor, col: torch.Tensor, M: int, N: int, *,
                  SR: int, SR_t: int):
    """The forward and transpose layouts of row-sorted int32 ``row``/``col``
    (the JAX package's ``_build_fwd``, ``_build_t`` and ``_relays``) and
    their piece tables: ``(S, S_t, col_f, rp_f, perm_f, sbase_f, col_t,
    rp_t, sbase_t, relay_ft, relay_tf, split_f, split_t)``, ``relay_tf``
    being the inverse of ``relay_ft`` (the backward reads ``d value`` back
    through it), which the JAX package does not keep. The JAX structure's
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
    # the value relay, t position -> fwd position, and its inverse
    relay_ft, relay_tf = relays(perm_f, perm_t)
    split_f = split_lengths(torch.bincount(row, minlength=M))
    split_t = split_lengths(torch.bincount(col, minlength=N))
    return (S, S_t, col_f, rp_f, perm_f.to(torch.int32), sbase_f, col_t,
            rp_t, sbase_t, relay_ft, relay_tf, split_f, split_t)


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


class SpanLayout(NamedTuple):
    """One orientation of a packed layout as the span kernels read it: the
    (S, rows) span bounds, the slice-local source indices, the slice bases
    and the piece table."""
    start: torch.Tensor
    end: torch.Tensor
    col: torch.Tensor
    base: torch.Tensor
    split: Optional[RowSplit]


def _kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a span kernel writes for an output of ``x``'s dtype."""
    return (x.dtype if x.dtype in (torch.float32, torch.bfloat16)
            else torch.float32)


def _spans(lay: SpanLayout, value: Optional[torch.Tensor], x: torch.Tensor,
           pdt: torch.dtype) -> torch.Tensor:
    """One multi-span SpMM over a packed layout: ``x`` gathered in ``pdt``
    (a bf16 ``x`` is read as it is: widening is exact), output in ``x``'s
    dtype."""
    src = x if x.dtype in (pdt, torch.bfloat16) else x.to(pdt)
    return spmm_spans_cuda(lay.start, lay.end, lay.col, value, lay.base, src,
                           out_dtype=_kernel_dtype(x),
                           split=lay.split).to(x.dtype)


def fused_span_backward(t: SpanLayout, relay: torch.Tensor,
                        relay_inv: torch.Tensor, packed_value: torch.Tensor,
                        x: torch.Tensor, g: torch.Tensor, stream: str):
    """``(d value, d x)`` of ``A @ x`` over a packed layout given ``g = d
    out``, in one pass over the transpose layout ``t`` that gathers ``g``
    once for both: ``d x`` summed as the spans SpMM over ``t`` sums it,
    ``d value`` as the span SDDMM over the forward layout does. The values
    go into ``t``'s order through ``relay`` before and ``d value`` comes
    back through ``relay_inv`` after, each in one gather: faster than
    scattered reads and writes through the relay inside the kernel
    (PERF.md). ``d value`` in ``packed_value``'s dtype, ``d x`` in
    ``x``'s; ``g`` contiguous."""
    pdt = product_dtype(packed_value, g, stream)
    d_x, d_value_t = spmm_sddmm_spans_cuda(
        t.start, t.end, t.col, packed_value.index_select(0, relay), t.base,
        g.to(pdt), x.to(pdt), dx_dtype=_kernel_dtype(g), split=t.split)
    return (d_value_t.index_select(0, relay_inv).to(packed_value.dtype),
            d_x.to(x.dtype))


DOUBLE_BACKWARD_REFUSAL = (
    "double backward of the packed-layout SpMMs (spmm_seg2, spmm_seg3, "
    "spmm_split, spmm_seg) is not supported, as in the JAX package, whose "
    "backward runs a Pallas kernel and raises NotImplementedError "
    "(pallas_call has no transpose rule); spmm / PaddedCOO.spmm "
    "differentiate at any order")


class _Refused(torch.autograd.Function):
    """The first ``n`` tensors passed through, attached to the graph of the
    rest (what they were computed from); differentiating them raises
    :data:`DOUBLE_BACKWARD_REFUSAL` (``NotImplementedError``)."""

    @staticmethod
    def forward(ctx, n, *tensors):
        return tuple(t.view_as(t) for t in tensors[:n])

    @staticmethod
    def backward(ctx, *_):
        raise NotImplementedError(DOUBLE_BACKWARD_REFUSAL)


def refuse_double_backward(backward):
    """A backward computed without a graph; under ``create_graph`` its
    grads are tied to what they depend on (the incoming grads and the saved
    inputs) through :class:`_Refused`, so that any derivative through them
    raises ``NotImplementedError`` (``once_differentiable``'s scheme, with
    the JAX package's error, and reached by ``autograd.grad`` too)."""
    @functools.wraps(backward)
    def wrapper(ctx, *args):
        with torch.no_grad():
            grads = backward(ctx, *args)
        if not torch.is_grad_enabled():
            return grads
        at = [i for i, t in enumerate(grads) if t is not None]
        links = [t for t in args + tuple(ctx.saved_tensors)
                 if isinstance(t, torch.Tensor) and t.requires_grad]
        if not at or not links:
            return grads
        out = _Refused.apply(len(at), *(grads[i] for i in at), *links)
        out = (out,) if isinstance(out, torch.Tensor) else out
        grads = list(grads)
        for i, t in zip(at, out):
            grads[i] = t
        return tuple(grads)
    return wrapper


class _PackedSpmm(torch.autograd.Function):
    """``A @ x`` over ``(packed_value, x)`` for a packed layout: ``fwd`` and
    ``t`` (:class:`SpanLayout`) its two orientations, ``relay`` the
    transpose position -> packed position map of the values and
    ``relay_inv`` its inverse; all closed over."""

    @staticmethod
    def forward(ctx, packed_value, x, fwd, t, relay, relay_inv, stream):
        ctx.save_for_backward(packed_value, x)
        ctx.fwd, ctx.t, ctx.stream = fwd, t, stream
        ctx.relay, ctx.relay_inv = relay, relay_inv
        return _spans(fwd, packed_value, x,
                      product_dtype(packed_value, x, stream))

    @staticmethod
    @refuse_double_backward
    def backward(ctx, g):
        packed_value, x = ctx.saved_tensors
        fwd, t = ctx.fwd, ctx.t
        g = g.contiguous()       # the grad of a sum is stride-0
        if ctx.needs_input_grad[0] and ctx.needs_input_grad[1]:
            return (*fused_span_backward(t, ctx.relay, ctx.relay_inv,
                                         packed_value, x, g, ctx.stream),
                    None, None, None, None, None)
        pdt = product_dtype(packed_value, g, ctx.stream)
        d_value = d_x = None
        if ctx.needs_input_grad[1]:
            value_t = (None if packed_value is None
                       else packed_value.index_select(0, ctx.relay))
            d_x = _spans(t, value_t, g, pdt).to(x.dtype)
        if ctx.needs_input_grad[0]:
            d_value = sddmm_spans_cuda(
                fwd.start, fwd.end, fwd.col, fwd.base, g.to(pdt), x.to(pdt),
                split=fwd.split).to(packed_value.dtype)
        return d_value, d_x, None, None, None, None, None


def check_operands(num_cols: int, nnz: int, packed_value, x) -> None:
    """``x`` is (N, K) and the packed values, if any, (nnz,)."""
    if x.dim() != 2 or x.shape[0] != num_cols:
        raise ValueError(f"x must be (N={num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if packed_value is not None and packed_value.shape != (nnz,):
        raise ValueError(f"packed values {tuple(packed_value.shape)} do not "
                         f"match the structure's nnz {nnz}")


def span_layouts(plan, s):
    """The forward and transpose :class:`SpanLayout` of a seg2 (or seg3)
    plan and structure."""
    M, N = plan.num_rows, plan.num_cols
    return (SpanLayout(s.rp_f[:, :M], s.rp_f[:, 1:M + 1], s.col_f,
                       s.sbase_f, s.split_f),
            SpanLayout(s.rp_t[:, :N], s.rp_t[:, 1:N + 1], s.col_t,
                       s.sbase_t, s.split_t))


def packed_spmm(plan, s, packed_value: Optional[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """:func:`spmm_seg2` for any plan and structure with the seg2 fields
    (``ops/spmm_seg3.py`` shares it)."""
    check_operands(plan.num_cols, s.col_f.numel(), packed_value, x)
    return _PackedSpmm.apply(packed_value, x.contiguous(),
                             *span_layouts(plan, s), s.relay_ft, s.relay_tf,
                             plan.stream)


def spmm_seg2(plan: Seg2Plan, s: Seg2Structure,
              packed_value: Optional[torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (sum reduction), differentiable in ``(packed_value, x)``.

    ``packed_value``: values in the forward packed layout
    (:func:`pack_values`), or ``None`` for structural ones. ``x`` is
    (N, K); the output (M, K) has ``x``'s dtype. Double backward raises
    ``NotImplementedError`` (:data:`DOUBLE_BACKWARD_REFUSAL`), as the JAX
    package's does."""
    return packed_spmm(plan, s, packed_value, x)
