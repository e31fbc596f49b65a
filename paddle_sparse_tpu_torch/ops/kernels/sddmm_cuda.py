"""CSR SDDMM on the card: ``dv[e] = g[m] . x[col[e]]`` over
``rowptr[m] <= e < rowptr[m+1]``, the value gradient of the CSR SpMM.

Port of ``paddle_sparse_tpu/ops/kernels/spmm_pallas.py::mul_rowsum_call``,
whose Pallas kernel ``_mulreduce_kernel`` takes the per-row dot of two (L, K)
streams that XLA has gathered into device memory (``g[row]`` and ``x[col]``).
Here one hand-written CUDA kernel does both gathers and the dot, so neither
stream exists: the span SDDMM of ``csrc/sddmm_spans.cu`` with one span per row
(S = 1, ``start = rowptr[:-1]``, ``end = rowptr[1:]``). With
``rowptr = arange(L + 1)`` and ``col = arange(L)`` it is exactly
``mul_rowsum_call(g, x)``.

Dtype contract: ``g`` and ``x`` are f32, bf16, f16 or f64, each read in its
own dtype: ``g`` is the grad of an SpMM output, whose dtype is at least
``x``'s, and the kernel takes ``g`` as wide as ``x`` or wider (a ``g``
narrower than their promoted dtype is cast up first: that copy is of ``g``,
never of ``x``). Dots are summed in f32, or in f64 when ``g`` or ``x`` is
f64, in the kernel and the plain version alike, and written in
``out_dtype`` (any of the four), rounded once. The output has one slot per
entry of ``col``; slots outside ``[rowptr[0], rowptr[M])``, such as the
padding of a ``PaddedCOO``, are 0.

:func:`sddmm_spans_cuda` is the span form, the value gradient of the
packed-layout SpMMs written in the packed order: it
replaces ``mul_rowsum_call`` at its one call site in the JAX package,
``ops/spmm_seg2.py::_sddmm_pass``.

Both take an optional piece table (``ops/kernels/row_split.py``): a row of
more than ``row_split.CAP`` edges is cut into pieces, one warp each; pieces
own disjoint edges, so there is no second pass.
"""
from typing import Optional

import torch

from . import spmm_cuda
from ._build import FLOAT_DTYPES
from .row_split import AUTO, launch_sddmm_spans, resolve_split
from .spmm_spans_cuda import check_span_args, span_windows


def dot_dtype(g: torch.dtype, x: torch.dtype) -> torch.dtype:
    """The dtype the plain SDDMMs sum a dot in: f64 when ``g`` or ``x`` is
    f64, int64 when both are integers (exact, as K1's integer sums), else
    f32."""
    if torch.float64 in (g, x):
        return torch.float64
    if not (g.is_floating_point or x.is_floating_point):
        return torch.int64
    return torch.float32


def sddmm_csr_reference(rowptr: torch.Tensor, col: torch.Tensor,
                        g: torch.Tensor, x: torch.Tensor,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sddmm_csr_cuda`, on any device.

    Processes the edges in bounded windows (two row gathers and a row-wise
    sum per window), summing in :func:`dot_dtype`."""
    acc_dtype = dot_dtype(g.dtype, x.dtype)
    out = torch.zeros(col.numel(), dtype=acc_dtype, device=x.device)
    rowptr = rowptr.long()
    e_begin, e_end = int(rowptr[0]), int(rowptr[-1])
    K = x.shape[1]
    step = max(1, spmm_cuda._WINDOW_BYTES
               // max(1, 2 * K * out.element_size()))
    for s in range(e_begin, e_end, step):
        t = min(s + step, e_end)
        edges = torch.arange(s, t, device=x.device)
        rows = torch.searchsorted(rowptr, edges, right=True) - 1
        out[s:t] = (g[rows].to(acc_dtype)
                    * x[col[s:t].long()].to(acc_dtype)).sum(1)
    return out.to(out_dtype)


def sddmm_operands(fn: str, g: torch.Tensor, x: torch.Tensor,
                   out_dtype: torch.dtype):
    """``(g, x)`` as ``csrc/sddmm_spans.cu`` takes them: each f32, bf16, f16
    or f64 and contiguous 2-D, ``g`` cast up to the promoted dtype of the
    two where it is narrower (``x`` is never copied); ``out_dtype`` one of
    the four. Raises ``TypeError``/``ValueError`` otherwise."""
    for name, t in (("g", g), ("x", x)):
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 2-D tensor, "
                             f"got shape {tuple(t.shape)} "
                             f"(contiguous={t.is_contiguous()})")
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{fn} takes f32, bf16, f16 or f64 {name}, got "
                            f"{t.dtype}")
    if out_dtype not in FLOAT_DTYPES:
        raise TypeError(f"{fn} writes f32, bf16, f16 or f64, not "
                        f"{out_dtype}")
    wide = torch.promote_types(g.dtype, x.dtype)
    return (g if g.dtype == wide else g.to(wide)), x


def _check_cuda_args(rowptr, col, g, x, out_dtype):
    dev = x.device
    for name, t in (("rowptr", rowptr), ("col", col), ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    g, x = sddmm_operands("sddmm_csr_cuda", g, x, out_dtype)
    if rowptr.dim() != 1 or rowptr.numel() < 1 or col.dim() != 1:
        raise ValueError("rowptr and col must be 1-D, rowptr non-empty")
    if g.shape[0] != rowptr.numel() - 1 or g.shape[1] != x.shape[1]:
        raise ValueError(f"g {tuple(g.shape)} must be (M, K) with M = "
                         f"{rowptr.numel() - 1} rows and x's K = "
                         f"{x.shape[1]}")
    for name, t in (("rowptr", rowptr), ("col", col)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if max(col.numel(), x.shape[0], x.shape[1], rowptr.numel()) >= 2 ** 31:
        raise ValueError("sddmm_csr_cuda indexes with int32: nnz, N, K and "
                         "M must each be below 2**31")
    return g, x


def sddmm_csr_cuda(rowptr: torch.Tensor, col: torch.Tensor, g: torch.Tensor,
                   x: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                   split=AUTO) -> torch.Tensor:
    """CSR SDDMM through the CUDA kernel ``csrc/sddmm_spans.cu`` at S = 1.

    ``rowptr`` (M+1,) is a CSR pointer into ``col``; ``g`` is a contiguous
    (M, K) and ``x`` a contiguous (N, K) tensor, each f32, bf16, f16 or
    f64, and every
    ``col[e]`` with ``rowptr[0] <= e < rowptr[M]`` lies in ``[0, N)``.
    ``split`` is the pointer's :class:`~.row_split.RowSplit`, ``None`` when
    no row is longer than its cap, or ``"auto"`` to build it here (one host
    read of the longest row). Returns ``(col.numel(),)`` in ``out_dtype``, 0
    outside the pointer's range. On a CPU tensor this runs
    :func:`sddmm_csr_reference`; on a CUDA tensor it launches the kernel or
    raises. ``sddmm_csr_cuda.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return sddmm_csr_reference(rowptr, col, g, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_csr_cuda runs on cpu or cuda, not {x.device}")
    g, x = _check_cuda_args(rowptr, col, g, x, out_dtype)
    out = torch.zeros(col.numel(), dtype=out_dtype, device=x.device)
    M = rowptr.numel() - 1
    if M == 0 or col.numel() == 0:
        return out
    rowptr = rowptr.to(torch.int32).contiguous()
    col = col.to(torch.int32).contiguous()
    start, end = rowptr[None, :-1], rowptr[None, 1:]
    launch_sddmm_spans("sddmm_csr", start, end, col, None, g, x, out,
                       resolve_split(split, start, end))
    sddmm_csr_cuda.launches += 1
    return out


sddmm_csr_cuda.launches = 0


def sddmm_spans_reference(start: torch.Tensor, end: torch.Tensor,
                          col: torch.Tensor, base: Optional[torch.Tensor],
                          g: torch.Tensor, x: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`sddmm_spans_cuda`, on any device:
    each span row in bounded windows, two row gathers and a row-wise sum,
    in :func:`dot_dtype`."""
    acc_dtype = dot_dtype(g.dtype, x.dtype)
    out = torch.zeros(col.numel(), dtype=acc_dtype, device=x.device)
    for s, rows, e in span_windows(start, end, 2 * x.shape[1]
                                   * out.element_size()):
        c = col[e].long()
        if base is not None:
            c = c + int(base[s])
        out[e] = (g[rows].to(acc_dtype) * x[c].to(acc_dtype)).sum(1)
    return out.to(out_dtype)


def sddmm_spans_cuda(start: torch.Tensor, end: torch.Tensor,
                     col: torch.Tensor, base: Optional[torch.Tensor],
                     g: torch.Tensor, x: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32,
                     split=AUTO) -> torch.Tensor:
    """The span form of :func:`sddmm_csr_cuda`, through the same CUDA kernel
    ``csrc/sddmm_spans.cu``: ``dv[e] = g[m] . x[base[s] + col[e]]`` for
    every position ``e`` with ``start[s, m] <= e < end[s, m]``.

    ``start``/``end`` are (S, M) int32 tensors sharing one row stride (the
    (S, M+1) row pointers ``rp`` of a packed layout pass as ``rp[:, :-1]``,
    ``rp[:, 1:]``); ``base`` (S,) or ``None`` for 0; ``g`` a contiguous
    (M, K) and ``x`` a contiguous (N, K) tensor, each f32, bf16, f16 or
    f64 (:func:`sddmm_operands`). ``split`` is the bounds'
    :class:`~.row_split.RowSplit` (a plan keeps it), ``None`` when no row
    is longer than its cap, or ``"auto"`` to build it here (one host read
    of the longest row). Returns ``(col.numel(),)`` in ``out_dtype``, 0
    at positions outside every span. On a CPU tensor this runs
    :func:`sddmm_spans_reference`; on a CUDA tensor it launches the kernel
    or raises. ``sddmm_spans_cuda.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return sddmm_spans_reference(start, end, col, base, g, x, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_spans_cuda runs on cpu or cuda, not "
                         f"{x.device}")
    start, end, base = check_span_args("sddmm_spans_cuda", start, end, base,
                                       x.device, ("col", col), ("g", g),
                                       ("x", x))
    g, x = sddmm_operands("sddmm_spans_cuda", g, x, out_dtype)
    (S, M), K = start.shape, x.shape[1]
    if g.shape != (M, K):
        raise ValueError(f"g {tuple(g.shape)} must be (M, K) = ({M}, {K})")
    if col.dim() != 1 or col.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"col must be 1-D int32 or int64, got {col.dtype} "
                        f"{tuple(col.shape)}")
    if K >= 2 ** 31:
        raise ValueError("sddmm_spans_cuda indexes with int32: K must be "
                         "below 2**31")
    out = torch.zeros(col.numel(), dtype=out_dtype, device=x.device)
    if S == 0 or M == 0 or col.numel() == 0:
        return out
    col = col.to(torch.int32).contiguous()
    launch_sddmm_spans("sddmm_spans", start, end, col, base, g, x, out,
                       resolve_split(split, start, end))
    sddmm_spans_cuda.launches += 1
    return out


sddmm_spans_cuda.launches = 0
