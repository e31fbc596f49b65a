"""Sparse @ dense matrix product (SpMM), ``reduce="sum"``, differentiable in
``value`` and ``x``.

Port of ``paddle_sparse_tpu/ops/spmm.py::spmm_coo`` / ``spmm_csr`` and of its
gradients (``_spmm_sum_pallas_vjp``, ``spmm_chunked`` with
``_spmm_chunked_bwd``). The index structure is not differentiable, as in the
reference (autograd on values). Dispatch follows the dense operand's device:
a CUDA tensor goes through the CUDA kernels, a CPU tensor through their plain
PyTorch versions.

* forward: ``out = A @ x``, K1 (:func:`~.kernels.spmm_cuda.spmm_csr_cuda`)
  over the CSR;
* ``d x = A^T @ g``: K1 again, over the CSC view of :class:`SpmmStructure`
  (``colptr``, ``col_t``, ``value[perm]``);
* ``d value[e] = g[row[e]] . x[col[e]]``: the SDDMM kernel
  (:func:`~.kernels.sddmm_cuda.sddmm_csr_cuda`) over the CSR, 0 at padding.

Each launch takes the piece table of its pointer
(:class:`~.kernels.row_split.RowSplit`, ``None`` when no row or column is
longer than ``row_split.CAP``), so a hub row or column is walked by many
warps.

Not yet ported (ROADMAP queue 1, item 3): the mean/min/max reductions, which
raise ``NotImplementedError``.
"""
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from .convert import ind2ptr, ptr2ind_capped
from .kernels.row_split import AUTO, RowSplit, resolve_split
from .kernels.sddmm_cuda import sddmm_csr_cuda
from .kernels.spmm_cuda import spmm_csr_cuda


class SpmmStructure(NamedTuple):
    """CSR pointer and CSC view of one sparse structure, as the reference's
    ``_spmm_structure`` builds it: the CSC view is the CSR of ``A^T``; and
    the piece tables of both pointers.

    Entries with ``row >= num_rows`` are padding: they lie past
    ``rowptr[num_rows]``, sort last in the CSC view and lie past
    ``colptr[num_cols]``, so no kernel reads them."""
    rowptr: torch.Tensor   # (M+1,) over the real rows
    perm: torch.Tensor     # (capacity,) int32, stable argsort of col
    col_t: torch.Tensor    # row[perm]
    colptr: torch.Tensor   # (N+1,) over the real columns
    row_split: Optional[RowSplit]   # rowptr's long rows, None if none
    col_split: Optional[RowSplit]   # colptr's long columns, None if none


def ptr_split(ptr: torch.Tensor, split=AUTO) -> Optional[RowSplit]:
    """The piece table of a CSR pointer, ``None`` when no row is longer
    than ``row_split.CAP``; a given ``split`` is checked and kept."""
    return resolve_split(split, ptr[None, :-1], ptr[None, 1:])


def spmm_structure(rowptr: torch.Tensor, row: torch.Tensor,
                   col: torch.Tensor, num_cols: int,
                   row_split=AUTO) -> SpmmStructure:
    """The :class:`SpmmStructure` of row-sorted COO indices ``row``/``col``
    whose CSR pointer over the real rows is ``rowptr`` (and, when given,
    ``row_split`` its piece table)."""
    # padding sorts last whatever its col holds
    key = torch.where(row < rowptr.numel() - 1, col, num_cols)
    perm = torch.argsort(key, stable=True).to(torch.int32)
    colptr = ind2ptr(key[perm], num_cols)
    return SpmmStructure(
        rowptr=rowptr, perm=perm, col_t=row[perm], colptr=colptr,
        row_split=ptr_split(rowptr, row_split), col_split=ptr_split(colptr))


class _SpmmSum(torch.autograd.Function):
    """``A @ x`` over ``(value, x)``; the index structure is closed over.
    ``structure_fn`` gives the :class:`SpmmStructure` and is called only
    when the backward needs ``d x``; ``row_split`` is ``rowptr``'s piece
    table (or ``"auto"``: built by each launch)."""

    @staticmethod
    def forward(ctx, value, x, rowptr, col, structure_fn, row_split):
        ctx.save_for_backward(value, x)
        ctx.rowptr, ctx.col, ctx.structure_fn = rowptr, col, structure_fn
        ctx.row_split = row_split
        return spmm_csr_cuda(rowptr, col, value, x, split=row_split)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        value, x = ctx.saved_tensors
        g = g.contiguous()       # the grad of a sum is stride-0
        d_value = d_x = None
        if ctx.needs_input_grad[0]:
            d_value = sddmm_csr_cuda(ctx.rowptr, ctx.col, g, x,
                                     out_dtype=value.dtype,
                                     split=ctx.row_split)
        if ctx.needs_input_grad[1]:
            s = ctx.structure_fn()
            value_t = (None if value is None
                       else value.index_select(0, s.perm))
            d_x = spmm_csr_cuda(s.colptr, s.col_t, value_t, g,
                                split=s.col_split).to(x.dtype)
        return d_value, d_x, None, None, None, None


def _check_reduce(reduce: str) -> None:
    if reduce in ("mean", "min", "max"):
        raise NotImplementedError(
            f"spmm reduce={reduce!r} is not ported yet (ROADMAP queue 1, "
            f"item 3: mean/min/max come with GraphSAGE)")
    if reduce not in ("sum", "add"):
        raise ValueError(f"unknown reduction {reduce!r}")


def spmm_with_structure(rowptr: torch.Tensor, col: torch.Tensor,
                        value: Optional[torch.Tensor], x: torch.Tensor,
                        structure_fn: Callable[[], SpmmStructure],
                        reduce: str = "sum", row_split=AUTO) -> torch.Tensor:
    """:func:`spmm_csr`, taking the CSC view from ``structure_fn`` when the
    backward needs it and ``rowptr``'s piece table from ``row_split`` (a
    ``PaddedCOO`` passes its cached ones)."""
    _check_reduce(reduce)
    if value is not None and value.dim() != 1:
        raise ValueError("spmm expects scalar edge values (1-D)")
    M = rowptr.numel() - 1
    x2 = x.reshape(x.shape[0], -1).contiguous()
    out = _SpmmSum.apply(value, x2, rowptr, col, structure_fn, row_split)
    return out.reshape((M,) + tuple(x.shape[1:]))


def spmm_csr(rowptr: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor,
             reduce: str = "sum") -> torch.Tensor:
    """``out[m] = sum_{rowptr[m] <= e < rowptr[m+1]} value[e] * x[col[e]]``.

    ``value`` may be ``None`` (implicit ones); ``x`` is (N, ...) and the
    output (M, ...) with ``M = len(rowptr) - 1``, in the promoted dtype of
    ``value`` and ``x``. Differentiable in ``value`` and ``x``; the backward
    builds the CSC view of ``(rowptr, col)`` on each call, and each launch
    the piece table of its pointer."""
    def structure_fn():
        return spmm_structure(rowptr, ptr2ind_capped(rowptr, col.numel()),
                              col, x.shape[0])

    return spmm_with_structure(rowptr, col, value, x, structure_fn, reduce)


def spmm_coo(row: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor, num_rows: int,
             reduce: str = "sum") -> torch.Tensor:
    """``out[m] = sum_{e: row[e]=m} value[e] * x[col[e]]`` for ``m <
    num_rows``; ``row`` sorted ascending. Entries with ``row >= num_rows``
    (padding) are left out, as the JAX segment-sum drops them, and their
    ``d value`` is 0."""
    return spmm_csr(ind2ptr(row, num_rows), col, value, x, reduce)
