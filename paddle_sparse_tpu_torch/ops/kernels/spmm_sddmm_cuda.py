"""The SpMM backward's two products in one pass on the card, over the
transpose of ``A``'s layout: ``d x = A^T @ g`` and ``d value[e] =
g[row[e]] . x[col[e]]``.

Port of ``paddle_sparse_tpu/ops/kernels/spmm_pallas.py::spmm_sddmm_chunked``,
the JAX package's fused backward of ``spmm_chunked``, which shares the
``g[col_t]`` gather between the transpose SpMM (its ``pallas_call`` is K1's
``_reduce_kernel``) and the SDDMM. Here one hand-written CUDA kernel,
``csrc/spmm_sddmm_csc.cu``, gives a warp to each row ``c`` of ``x``: it
holds ``x[c]`` in registers and gathers each row of ``g`` once for both
outputs, where the pair it replaces gathered twice (K2 for ``d value``, then,
after materialising the values in transpose order, the SpMM over the
transpose for ``d x``). Two forms:

* :func:`spmm_sddmm_csc_cuda`, over the CSC view of a CSR SpMM: it replaces
  K2 over the CSR plus K1 over the CSC view. The kernel reads the values and
  writes ``d value`` in CSC order; the wrapper relays them, as the span
  form's caller does: ``value[perm]`` before, one gather, and ``d value``
  back into COO order through the inverse permutation after, another
  gather (no scattered 4-byte access in the kernel);
* :func:`spmm_sddmm_spans_cuda`, over the transpose layout of a packed SpMM
  (``ops/spmm_seg2.py``: ``rp_t``, ``col_t``, ``sbase_t``), on values in
  the transpose's order, ``d value`` written there too: it replaces the
  span SDDMM over the forward layout plus the multi-span SpMM over the
  transpose, seg2's backward (``paddle_sparse_tpu/ops/
  spmm_seg2.py::_spmm_seg2_bwd``, whose ``d x`` is a ``_seg_pass`` of K1's
  ``pallas_call``).

Arithmetic: ``d x`` in the SpMM's order (f32 ``fmaf`` in edge order, a long
row's piece partials folded by ``row_split.fold_pieces_cuda``), ``d value``
in K2's (each lane's share of the dot, then a butterfly), so both equal the
pair's outputs bit for bit. Dtype contract, as the pair's: ``g`` and ``x``
are each read in their own dtype, ``g`` cast up first where it is narrower
than their promoted dtype (``x`` is never copied; ``value`` and ``d value``
are read and written in ``value``'s dtype, ``out_dtype``). The CSC form takes
f32, bf16, f16 and f64 (an f64 ``value`` takes ``g`` to f64 too): sums in
f32, or in f64 when an input is f64, rounded once. The span form takes f32
and bf16, what the packed SpMMs gather in. ``d x`` comes back in the promoted
dtype of ``value`` and ``g`` (``g``'s when ``value`` is None) unless the
caller names it, and ``d value`` in ``out_dtype``, 0 at the entries no edge
reaches (the padding of a ``PaddedCOO``).
"""
from typing import Optional

import torch

from ...profiling import scope
from ..convert import invert_perm
from . import _build
from ._build import FLOAT_DTYPES
from .row_split import (AUTO, RowSplit, fold_pieces_cuda, resolve_split,
                        sum_dtype)
from .spmm_cuda import _WINDOW_BYTES, _out_dtype
from .spmm_spans_cuda import check_span_args, span_windows


def csc_order_reference(colptr: torch.Tensor, col_t: torch.Tensor,
                        value_t: Optional[torch.Tensor], g: torch.Tensor,
                        x: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of the kernel itself, on any device: ``(d x,
    d value)`` with ``value_t`` and ``d value`` in CSC order, 0 at the
    positions no column reaches.

    Walks the CSC edges in bounded windows: one gather of ``g[col_t]`` per
    window, scaled by the window's values and added into ``d x``
    (``index_add_``, as ``spmm_csr_reference`` sums), and its row-wise dot
    with ``x[c]``, written at the window's positions. Sums in f32, or in f64
    when the output's inputs are f64 (``d x``: ``value`` or ``g``; ``d
    value``: ``g`` or ``x``)."""
    N, K = colptr.numel() - 1, x.shape[1]
    dx_dtype = _out_dtype(value_t, g)
    dx_acc = torch.float64 if dx_dtype == torch.float64 else torch.float32
    dv_acc = (torch.float64 if torch.float64 in (g.dtype, x.dtype)
              else torch.float32)
    d_x = torch.zeros((N, K), dtype=dx_acc, device=x.device)
    dv_t = torch.zeros(col_t.numel(), dtype=dv_acc, device=x.device)
    colptr = colptr.long()
    e_begin, e_end = int(colptr[0]), int(colptr[-1])
    step = max(1, _WINDOW_BYTES // max(1, K * d_x.element_size()))
    for s in range(e_begin, e_end, step):
        t = min(s + step, e_end)
        edges = torch.arange(s, t, device=x.device)
        cols = torch.searchsorted(colptr, edges, right=True) - 1
        g_rows = g[col_t[s:t].long()]
        dv_t[s:t] = (g_rows.to(dv_acc) * x[cols].to(dv_acc)).sum(1)
        prod = g_rows.to(dx_acc)          # may be g_rows itself
        if value_t is not None:
            prod *= value_t[s:t, None].to(dx_acc)
        d_x.index_add_(0, cols, prod)
    return d_x.to(dx_dtype), dv_t.to(out_dtype)


def _relayed(csc_fn, colptr, col_t, perm, value, g, x, out_dtype,
             inv_perm, value_t=None):
    """``csc_fn`` (the kernel's wrapper or its plain version, on values and
    ``d value`` in CSC order) between the two relays: ``value[perm]``
    before (``value_t`` when the caller has it), ``d value_t[inv_perm]``
    after (``inv_perm`` built here when None): ``(d x, d value)`` in COO
    order. The gathers run in the spans ``psp.spmm.relay`` and
    ``psp.spmm.readback``."""
    if inv_perm is None:
        inv_perm = invert_perm(perm)
    for name, t in (("perm", perm), ("inv_perm", inv_perm)):
        if t.dtype not in (torch.int32, torch.int64) \
                or t.shape != col_t.shape or t.device != x.device:
            raise ValueError(f"{name} must be int32 or int64 of col_t's "
                             f"shape {tuple(col_t.shape)} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if value is not None and value.shape != perm.shape:
        raise ValueError(f"value shape {tuple(value.shape)} != perm shape "
                         f"{tuple(perm.shape)}")
    if value is None:
        value_t = None
    elif value_t is None:
        with scope("psp.spmm.relay"):
            value_t = value.index_select(0, perm)
    elif value_t.shape != value.shape or value_t.dtype != value.dtype:
        raise ValueError(f"value_t {value_t.dtype} {tuple(value_t.shape)} "
                         f"is not value[perm] of value {value.dtype} "
                         f"{tuple(value.shape)}")
    d_x, dv_t = csc_fn(colptr, col_t, value_t, g, x, out_dtype)
    with scope("psp.spmm.readback"):
        return d_x, dv_t.index_select(0, inv_perm)


def spmm_sddmm_csc_reference(colptr: torch.Tensor, col_t: torch.Tensor,
                             perm: torch.Tensor,
                             value: Optional[torch.Tensor], g: torch.Tensor,
                             x: torch.Tensor,
                             out_dtype: torch.dtype = torch.float32,
                             inv_perm: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`spmm_sddmm_csc_cuda`, on any device:
    ``(d x, d value)``, through the same relays: ``value[perm]`` into CSC
    order, :func:`csc_order_reference`, and ``d value`` read back into COO
    order at ``inv_perm`` (the inverse of ``perm``, built here when
    None)."""
    return _relayed(csc_order_reference, colptr, col_t, perm, value, g, x,
                    out_dtype, inv_perm)


def fused_operands(fn: str, value, g: torch.Tensor, x: torch.Tensor,
                   dtypes, dx_dtype, out_dtype):
    """``(g, kernel_dx_dtype)`` for the fused kernel: ``g``, ``x`` and
    ``value`` each of ``dtypes`` and ``g``, ``x`` contiguous 2-D, ``d x``
    and ``d value`` of ``dtypes`` too. ``g`` is cast up to the promoted
    dtype of ``g`` and ``x`` (to f64 when any input is f64), never ``x``.
    The kernel writes ``d x`` in the sum's type from an f32 or f64 ``g``,
    else (bf16 or f16 ``g``) in ``dx_dtype`` where that is ``g``'s or f32,
    and in f32 otherwise: the caller rounds it once after."""
    for name, t in (("g", g), ("x", x), ("value", value)):
        if t is None:
            continue
        if name != "value" and (t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be a contiguous 2-D tensor, "
                             f"got shape {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()})")
        if t.dtype not in dtypes:
            raise TypeError(f"{fn} takes {name} in {dtypes}, got {t.dtype}")
    for name, dt in (("d x", dx_dtype), ("d value", out_dtype)):
        if dt not in dtypes:
            raise TypeError(f"{fn} writes {name} in {dtypes}, not {dt}")
    wide = torch.promote_types(g.dtype, x.dtype)
    if torch.float64 in (dx_dtype, None if value is None else value.dtype):
        wide = torch.float64
    if g.dtype != wide:
        g = g.to(wide)
    if wide in (torch.float32, torch.float64):
        return g, sum_dtype(wide)
    return g, dx_dtype if dx_dtype in (wide, torch.float32) else torch.float32


def _check_cuda_args(colptr, col_t, value_t, g, x):
    dev = x.device
    for name, t in (("colptr", colptr), ("col_t", col_t),
                    ("value", value_t), ("g", g)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if colptr.dim() != 1 or colptr.numel() < 1 or col_t.dim() != 1:
        raise ValueError("colptr must be 1-D and non-empty, col_t 1-D")
    for name, t in (("colptr", colptr), ("col_t", col_t)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if x.shape[0] != colptr.numel() - 1 or g.shape[1] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} must be (N, K) with N = "
                         f"{colptr.numel() - 1} columns and g's K = "
                         f"{g.shape[1]}")
    if max(col_t.numel(), g.shape[0], x.shape[0], x.shape[1],
           colptr.numel()) >= 2 ** 31:
        raise ValueError("spmm_sddmm_csc_cuda indexes with int32: nnz, M, "
                         "N, K and N + 1 must each be below 2**31")
    if value_t is not None and value_t.shape != col_t.shape:
        raise ValueError(f"value shape {tuple(value_t.shape)} != col_t "
                         f"shape {tuple(col_t.shape)}")


def _slot_table(split: Optional[RowSplit]):
    """The fused kernel's piece arguments: row, piece, P, cap, slot."""
    if split is None:
        return None, None, 0, 0, None
    return (split.row.data_ptr(), split.piece.data_ptr(), split.row.numel(),
            split.cap, split.slot.data_ptr())


def csc_order_cuda(colptr: torch.Tensor, col_t: torch.Tensor,
                   value_t: Optional[torch.Tensor], g: torch.Tensor,
                   x: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                   split=AUTO):
    """The launch of :func:`spmm_sddmm_csc_cuda` alone: ``(d x, d value)``
    with ``value_t`` and ``d value`` in CSC order (0 at the positions no
    column reaches). On a CPU tensor :func:`csc_order_reference`; on a CUDA
    tensor the kernel (and, over split columns, the fold pass), counted in
    ``spmm_sddmm_csc_cuda.launches``, or a raise."""
    if x.device.type == "cpu":
        return csc_order_reference(colptr, col_t, value_t, g, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_sddmm_csc_cuda runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda_args(colptr, col_t, value_t, g, x)
    dx_dtype = _out_dtype(value_t, g)
    # from an f32 g, an f32 d x, rounded after (one rounding, as K1's store)
    g, kernel_dx_dtype = fused_operands("spmm_sddmm_csc_cuda", value_t, g, x,
                                        FLOAT_DTYPES, dx_dtype, out_dtype)
    N, K = x.shape
    d_x = torch.empty((N, K), dtype=kernel_dx_dtype, device=x.device)
    dv_t = torch.zeros(col_t.numel(), dtype=out_dtype, device=x.device)
    if N == 0 or K == 0:
        return d_x.to(dx_dtype), dv_t
    colptr = colptr.to(torch.int32).contiguous()
    col_t = col_t.to(torch.int32).contiguous()
    if value_t is not None:
        value_t = value_t.contiguous()
    split: Optional[RowSplit] = resolve_split(split, colptr[None, :-1],
                                              colptr[None, 1:])
    ws = (None if split is None else torch.empty(
        (split.num_slots, K), dtype=sum_dtype(kernel_dx_dtype),
        device=x.device))
    code = _build.dtype_code
    _build.launch(
        "spmm_sddmm_csc", _build.load_library().psp_spmm_sddmm_csc, x.device,
        colptr.data_ptr(), col_t.data_ptr(),
        None if value_t is None else value_t.data_ptr(),
        0 if value_t is None else code(value_t.dtype), g.data_ptr(),
        x.data_ptr(), d_x.data_ptr(), dv_t.data_ptr(), N, K,
        code(g.dtype), code(x.dtype), code(kernel_dx_dtype), code(out_dtype),
        *_slot_table(split), None if ws is None else ws.data_ptr())
    if split is not None:
        fold_pieces_cuda(split, ws, d_x)
    spmm_sddmm_csc_cuda.launches += 1
    return d_x.to(dx_dtype), dv_t


def spmm_sddmm_csc_cuda(colptr: torch.Tensor, col_t: torch.Tensor,
                        perm: torch.Tensor, value: Optional[torch.Tensor],
                        g: torch.Tensor, x: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32,
                        split=AUTO, inv_perm: Optional[torch.Tensor] = None,
                        value_t: Optional[torch.Tensor] = None):
    """``(d x, d value)`` of ``out = A @ x`` given ``g = d out``, through the
    CUDA kernel ``csrc/spmm_sddmm_csc.cu``:

    * ``d x[c] = sum_{colptr[c] <= e < colptr[c+1]} value[perm[e]] *
      g[col_t[e]]``, (N, K) in the promoted dtype of ``value`` and ``g``;
    * ``d value[perm[e]] = g[col_t[e]] . x[c]`` for the same ``e``,
      ``(perm.numel(),)`` in ``out_dtype``, 0 at entries no column reaches.

    ``colptr``/``col_t``/``perm``/``inv_perm`` are the CSC view of
    ``ops/spmm.py::SpmmStructure`` (``inv_perm`` the inverse of ``perm``,
    built here by one scatter when None); ``value`` is in COO order (or None
    for ones); ``g`` is a contiguous (M, K) and ``x`` a contiguous (N, K)
    tensor, each f32, bf16, f16 or f64 (:func:`fused_operands`). The values
    go into CSC order by one gather (``value[perm]``, or ``value_t`` when
    the caller already has it), the kernel reads them and writes ``d
    value`` there (:func:`csc_order_cuda`), and ``d value`` comes back by
    another gather (``d value_t[inv_perm]``): no scattered access in the
    kernel. ``split`` is ``colptr``'s
    :class:`~.row_split.RowSplit` (``SpmmStructure.col_split``), ``None``
    when no column is longer than its cap, or ``"auto"`` to build it here.
    On a CPU tensor this runs the plain version between the same relays
    (:func:`spmm_sddmm_csc_reference`); on a CUDA tensor it launches the
    kernel or raises. ``spmm_sddmm_csc_cuda.launches`` counts kernel
    launches."""
    return _relayed(lambda *args: csc_order_cuda(*args, split=split),
                    colptr, col_t, perm, value, g, x, out_dtype, inv_perm,
                    value_t)


spmm_sddmm_csc_cuda.launches = 0


# the dtypes of the span form: the packed SpMMs gather in f32 or bf16
# (spmm_spans_cuda.product_dtype), so its backward sees no others
_SPAN_DTYPES = (torch.float32, torch.bfloat16)


def spmm_sddmm_spans_reference(start: torch.Tensor, end: torch.Tensor,
                               col: torch.Tensor,
                               value: Optional[torch.Tensor],
                               base: Optional[torch.Tensor], g: torch.Tensor,
                               x: torch.Tensor,
                               dx_dtype: Optional[torch.dtype] = None,
                               out_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version of :func:`spmm_sddmm_spans_cuda`, on any
    device: ``(d x, d value)``.

    Walks each span row in the bounded windows of
    :func:`~.spmm_spans_cuda.spmm_spans_reference`: one gather of the rows
    of ``g`` per window, scaled by the window's values and added into
    ``d x`` (``index_add_``), and its row-wise dot with ``x[c]``, written
    at the edges' positions. Sums in f32, or in f64 when the output's
    inputs are f64 (``d x``: ``value`` or ``g``; ``d value``: ``g`` or
    ``x``)."""
    dx_dtype = dx_dtype or _out_dtype(value, g)
    dx_acc = (torch.float64 if torch.float64 in (
        g.dtype, None if value is None else value.dtype) else torch.float32)
    dv_acc = (torch.float64 if torch.float64 in (g.dtype, x.dtype)
              else torch.float32)
    N, K = start.shape[1], x.shape[1]
    d_x = torch.zeros((N, K), dtype=dx_acc, device=x.device)
    d_value = torch.zeros(col.numel(), dtype=dv_acc, device=x.device)
    for s, rows, e in span_windows(start, end, K * d_x.element_size()):
        r = col[e].long()
        if base is not None:
            r = r + int(base[s])
        g_rows = g[r]
        d_value[e] = (g_rows.to(dv_acc) * x[rows].to(dv_acc)).sum(1)
        prod = g_rows.to(dx_acc)          # may be g_rows itself
        if value is not None:
            prod *= value[e, None].to(dx_acc)
        d_x.index_add_(0, rows, prod)
    return d_x.to(dx_dtype), d_value.to(out_dtype)


def spmm_sddmm_spans_cuda(start: torch.Tensor, end: torch.Tensor,
                          col: torch.Tensor, value: Optional[torch.Tensor],
                          base: Optional[torch.Tensor], g: torch.Tensor,
                          x: torch.Tensor,
                          dx_dtype: Optional[torch.dtype] = None,
                          out_dtype: torch.dtype = torch.float32,
                          split=AUTO):
    """``(d x, d value)`` of a packed-layout SpMM ``out = A @ x`` given
    ``g = d out``, over the transpose layout, through the span form of the
    CUDA kernel ``csrc/spmm_sddmm_csc.cu``:

    * ``d x[c] = sum_s sum_{start[s, c] <= e < end[s, c]} value[e] *
      g[base[s] + col[e]]``, (N, K) in ``dx_dtype`` (default: the promoted
      dtype of ``value`` and ``g``);
    * ``d value[e] = g[base[s] + col[e]] . x[c]`` for the same ``e``,
      ``(col.numel(),)`` in ``out_dtype``, 0 where no span reaches.

    ``start``/``end`` are the transpose's (S, N) span bounds sharing one row
    stride (``rp_t[:, :-1]``, ``rp_t[:, 1:]``); ``col`` the slice-local rows
    of ``g``; ``base`` (S,) or ``None`` for 0; ``value``
    ``(col.numel(),)`` in the transpose's order, or None for ones (the
    packed backward, ``spmm_seg2.fused_span_backward``, relays the values
    into that order before and reads ``d value`` back after);
    ``g`` a contiguous (M, K) and ``x`` a contiguous (N, K) tensor, each
    f32 or bf16 (the packed SpMMs' product dtypes); ``dx_dtype`` f32 or
    bf16 (from an f32 ``g``, d x is summed in f32 and rounded once after).
    ``split`` is the bounds'
    :class:`~.row_split.RowSplit` (a plan keeps it as ``split_t``), ``None``
    when no row is longer than its cap, or ``"auto"`` to build it here. On a
    CPU tensor this runs :func:`spmm_sddmm_spans_reference`; on a CUDA
    tensor it launches the kernel (and, over split rows, the fold pass) or
    raises. ``spmm_sddmm_spans_cuda.launches`` counts kernel launches."""
    dx_dtype = dx_dtype or _out_dtype(value, g)
    if x.device.type == "cpu":
        return spmm_sddmm_spans_reference(start, end, col, value, base, g, x,
                                          dx_dtype, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_sddmm_spans_cuda runs on cpu or cuda, not "
                         f"{x.device}")
    fn = "spmm_sddmm_spans_cuda"
    start, end, base = check_span_args(fn, start, end, base, x.device,
                                       ("col", col), ("value", value),
                                       ("g", g))
    # from an f32 g, an f32 d x, rounded after (one rounding, as K1's store)
    g, kernel_dx_dtype = fused_operands(fn, value, g, x, _SPAN_DTYPES,
                                        dx_dtype, out_dtype)
    (S, N), K = start.shape, x.shape[1]
    if x.shape[0] != N or g.shape[1] != K:
        raise ValueError(f"{fn}: x {tuple(x.shape)} must be (N, K) with N = "
                         f"{N} rows of the bounds and g's K = {g.shape[1]}")
    if col.dim() != 1 or col.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{fn}: col must be 1-D int32 or int64, got "
                        f"{col.dtype} {tuple(col.shape)}")
    if value is not None and value.shape != col.shape:
        raise ValueError(f"{fn}: value shape {tuple(value.shape)} != col "
                         f"shape {tuple(col.shape)}")
    if max(K, g.shape[0]) >= 2 ** 31:
        raise ValueError(f"{fn} indexes with int32: M and K must each be "
                         f"below 2**31")
    d_x = torch.empty((N, K), dtype=kernel_dx_dtype, device=x.device)
    d_value = torch.zeros(col.numel(), dtype=out_dtype, device=x.device)
    if N == 0 or K == 0 or S == 0:
        return d_x.zero_().to(dx_dtype), d_value
    col = col.to(torch.int32).contiguous()
    if value is not None:
        value = value.contiguous()
    split: Optional[RowSplit] = resolve_split(split, start, end)
    ws = (None if split is None else torch.empty(
        (split.num_slots, K), dtype=torch.float32, device=x.device))
    code = _build.dtype_code
    _build.launch(
        "spmm_sddmm_spans", _build.load_library().psp_spmm_sddmm_spans,
        x.device, start.data_ptr(), end.data_ptr(), start.stride(0),
        col.data_ptr(), None if base is None else base.data_ptr(),
        None if value is None else value.data_ptr(),
        0 if value is None else code(value.dtype), g.data_ptr(),
        x.data_ptr(), d_x.data_ptr(), d_value.data_ptr(), S, N, K,
        code(g.dtype), code(x.dtype), code(kernel_dx_dtype), code(out_dtype),
        *_slot_table(split), None if ws is None else ws.data_ptr())
    if split is not None:
        fold_pieces_cuda(split, ws, d_x)
    spmm_sddmm_spans_cuda.launches += 1
    return d_x.to(dx_dtype), d_value


spmm_sddmm_spans_cuda.launches = 0
