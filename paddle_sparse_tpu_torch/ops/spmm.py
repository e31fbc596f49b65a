"""Sparse @ dense matrix product (SpMM), ``reduce`` in ``"sum"``/``"add"``,
``"mean"``, ``"min"`` and ``"max"``, differentiable in ``value`` and ``x``.

Port of ``paddle_sparse_tpu/ops/spmm.py::spmm_coo`` / ``spmm_csr`` and of its
gradients (``_spmm_sum_pallas_vjp``, ``spmm_chunked`` with
``_spmm_chunked_bwd``). The index structure is not differentiable, as in the
reference (autograd on values). Dispatch follows the dense operand's device:
a CUDA tensor goes through the CUDA kernels, a CPU tensor through their plain
PyTorch versions.

* forward: ``out = A @ x``, K1 (:func:`~.kernels.spmm_cuda.spmm_csr_cuda`)
  over the CSR;
* backward with both grads: ``d x = A^T @ g`` and ``d value[e] = g[row[e]]
  . x[col[e]]`` (0 at padding) in one pass over the CSC view of
  :class:`SpmmStructure`, which gathers each row of ``g`` once for both
  (:func:`~.kernels.spmm_sddmm_cuda.spmm_sddmm_csc_cuda`, as the JAX
  package's ``_spmm_chunked_bwd`` fuses them), on the values in CSC order
  (:func:`csc_values`: relayed once per backward and value) with ``d
  value`` read back through the structure's ``inv_perm``;
* ``d value`` alone: the SDDMM kernel
  (:func:`~.kernels.sddmm_cuda.sddmm_csr_cuda`) over the CSR;
* ``d x`` alone, or with ``value`` None: K1 again, over the CSC view
  (``colptr``, ``col_t``, ``value[perm]`` from :func:`csc_values`).

Per-head values: an (E, H) ``value`` splits ``x``'s K columns into H
blocks of K / H and sums block k with ``value[:, k]`` (GAT's heads,
concatenated): :class:`_HeadsSpmm`, one K1 a head, which reads the head's
column block of ``x`` and writes its block of the one output in place;
each head's backward is the one above.

Double backward (``create_graph=True``, as a gradient penalty, a
Hessian-vector product or force training takes it) differentiates at any
order, on the same kernels and with no (nnz, K) tensor: each of the three
backwards above is a Function whose own backward is built from the same three
(:class:`_SumGrads`, :class:`_Sddmm`, :func:`_spmm_t`; the transpose's CSC
view is A's CSR: :func:`transpose_structure`). A first-order backward
launches the same kernels with or without ``create_graph``.

Spans (``profiling.scope``, recorded only while a profiler records):
``psp.spmm.forward`` and ``psp.spmm.backward`` around :class:`_SpmmSum`'s
(and around each head's in :class:`_HeadsSpmm`),
``psp.spmm.transpose`` around :func:`_spmm_t`, ``psp.spmm.sum_grads``,
``psp.spmm.sddmm`` and their ``.backward`` around the other Functions', and
``psp.spmm.relay`` around each gather of the values into CSC order that
runs (a :func:`csc_values` hit opens none), ``psp.spmm.readback`` around
``d value``'s gather back into COO order
(``kernels/spmm_sddmm_cuda.py::_relayed``).

Dtypes: the output has ``promote_types(value, x)``. A mixed int/float pair
is cast to the promoted float before the kernels (as JAX casts both), so K2
and the fused pass see floats only: an int tensor cannot require grad. Two
ints (or a bool beside an int) sum exactly in K1 (``kernels/spmm_cuda.py``).

Each launch takes the piece table of its pointer
(:class:`~.kernels.row_split.RowSplit`, ``None`` when no row or column is
longer than ``row_split.CAP``), so a hub row or column is walked by many
warps.

``backend`` takes the JAX package's values: ``"auto"``, ``"pallas"`` and
``"xla"`` all run the port's one path (the kernels on a CUDA tensor, their
plain versions on a CPU tensor). ``"sell"`` plans the padded-group layout
once per structure (:func:`_cached_sell_plan`) and runs
:func:`~.spmm_sell.spmm_sell` on the same kernels.

:func:`make_spmm_plan` and :func:`spmm_chunked` are the JAX package's
memory-bounded chunked SpMM. Its chunk geometry (edge blocks, windows, the
``dv_map`` of the backward's windows) is TPU layout and is not ported:
values stay in COO order, and the plan's structure,
:class:`ChunkedStructure`, holds the int32 COO indices and an
:class:`SpmmStructure` (the CSR pointer, the CSC view and the piece tables of
both pointers: JAX's ``_split_long_rows`` pseudo-rows and ``_fold_rows`` are
the piece tables and the fold pass of ``kernels/row_split.py``).

The other reductions, as the reference's XLA path computes them
(``ops/spmm.py:498-514``):

* ``"mean"``: the sum path above (so the same kernels), divided by
  ``max(deg, 1)`` with ``deg`` the row's entry count; autograd carries the
  ``1/deg`` into ``d value`` and ``d x``;
* ``"min"``/``"max"``: plain torch on every device,
  :func:`~.segment.segment_csr` over the products ``value[e] * x[col[e]]``
  of the real entries (the first ``rowptr[M]``), 0 for an empty row; the
  gradient is split evenly among tied entries, as JAX's ``segment_max``
  splits it. The products are an (nnz, K) tensor.
"""
import math
import weakref
from typing import Callable, NamedTuple, Optional

import torch

from ..profiling import scope
from .convert import ind2ptr, invert_perm, ptr2ind_capped
from .kernels.row_split import AUTO, RowSplit, resolve_split
from .kernels.sddmm_cuda import sddmm_csr_cuda
from .kernels.spmm_cuda import spmm_csr_cuda
from .kernels.spmm_sddmm_cuda import spmm_sddmm_csc_cuda
from .segment import segment_csr


class SpmmStructure(NamedTuple):
    """CSR pointer and CSC view of one sparse structure, as the reference's
    ``_spmm_structure`` builds it: the CSC view is the CSR of ``A^T``; the
    piece tables of both pointers; and ``perm``'s inverse, through which the
    fused backward reads ``d value`` back from CSC order.

    Entries with ``row >= num_rows`` are padding: they lie past
    ``rowptr[num_rows]``, sort last in the CSC view and lie past
    ``colptr[num_cols]``, so no kernel reads them."""
    rowptr: torch.Tensor   # (M+1,) over the real rows
    perm: torch.Tensor     # (capacity,) int32, stable argsort of col
    col_t: torch.Tensor    # row[perm]
    colptr: torch.Tensor   # (N+1,) over the real columns
    row_split: Optional[RowSplit]   # rowptr's long rows, None if none
    col_split: Optional[RowSplit]   # colptr's long columns, None if none
    inv_perm: torch.Tensor  # (capacity,) int32, each entry's CSC position


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
        row_split=ptr_split(rowptr, row_split), col_split=ptr_split(colptr),
        inv_perm=invert_perm(perm))


def transpose_structure(s: SpmmStructure, col: torch.Tensor) -> SpmmStructure:
    """The :class:`SpmmStructure` of ``A^T`` from A's (``col`` A's column
    indices in COO order): its CSR is A's CSC view, and its CSC view is A's
    CSR, in A's own entry order (``perm`` A's ``inv_perm`` and ``inv_perm``
    A's ``perm``, ``col_t`` A's ``col``): no sort, no scatter. Values of
    ``A^T`` are in A's CSC order, ``value[s.perm]``."""
    return SpmmStructure(rowptr=s.colptr, perm=s.inv_perm, col_t=col,
                         colptr=s.rowptr, row_split=s.col_split,
                         col_split=s.row_split, inv_perm=s.perm)


class _Csr(NamedTuple):
    """What the Functions below close over: the CSR pointer and column
    indices of A, ``structure_fn`` (gives the :class:`SpmmStructure`, called
    only when a CSC view is needed), ``rowptr``'s piece table (or
    ``"auto"``) and the caller's ``relays`` dict (:func:`csc_values`; None:
    nothing kept)."""
    rowptr: torch.Tensor
    col: torch.Tensor
    structure_fn: Callable[[], SpmmStructure]
    row_split: object
    relays: Optional[dict] = None


def _spmm(a: _Csr, value, x):
    """``A(value) @ x``, differentiable (K1 over the CSR)."""
    return _SpmmSum.apply(value, x, a.rowptr, a.col, a.structure_fn,
                          a.row_split, a.relays)


_CSC_VALUES = "csc_values"   # the key of a relays dict's one entry


def csc_values(value: Optional[torch.Tensor], perm: torch.Tensor,
               relays: Optional[dict]) -> Optional[torch.Tensor]:
    """``value.index_select(0, perm)``: A's values in CSC order, kept in
    the caller's ``relays`` dict and served again while ``value`` is the
    same tensor, unwritten (its version counter), relayed through the same
    ``perm``, so the passes of one backward that share A's values (GCN's and
    GraphSAGE's layers, APPNP's steps) relay them once. The forward entry
    (:func:`spmm_with_structure`) empties the dict, so the entry lives from
    a backward's first relay to the next forward: a write the version
    counter does not see (through ``.data``) between steps is never served
    stale. Not kept with ``relays`` None, or where autograd records the
    gather (grad mode on and ``value`` requiring grad: a double backward
    differentiates through it). Each gather runs in a ``psp.spmm.relay``
    span; a served entry opens none."""
    if value is None:
        return None
    keep = relays is not None and not (torch.is_grad_enabled()
                                       and value.requires_grad)
    if keep:
        ent = relays.get(_CSC_VALUES)
        if (ent is not None and ent[0]() is value
                and ent[1] == value._version and ent[2]() is perm):
            return ent[3]
    with scope("psp.spmm.relay"):
        value_t = value.index_select(0, perm)
    if keep:
        relays[_CSC_VALUES] = (weakref.ref(value), value._version,
                               weakref.ref(perm), value_t)
    return value_t


def _spmm_t(a: _Csr, value, g):
    """``A(value)^T @ g``, differentiable: :class:`_SpmmSum` over the CSC
    view (K1), whose own backward sees A's CSR as the transpose's CSC."""
    with scope("psp.spmm.transpose"):
        s = a.structure_fn()
        value_t = csc_values(value, s.perm, a.relays)
        return _SpmmSum.apply(value_t, g, s.colptr, s.col_t,
                              lambda: transpose_structure(a.structure_fn(),
                                                          a.col),
                              s.col_split, None)


def _sddmm(a: _Csr, g, x, out_dtype):
    """``d[e] = g[row[e]] . x[col[e]]``, differentiable (K2)."""
    return _Sddmm.apply(g, x, a.rowptr, a.col, a.structure_fn, a.row_split,
                        out_dtype)


def _sddmm_vjp(a: _Csr, gg, g, x, need_g, need_x):
    """The grads of ``_sddmm(a, g, x)`` along ``gg``: ``d g = A(gg) @ x``
    and ``d x = A(gg)^T @ g``, each a differentiable K1."""
    d_g = _spmm(a, gg, x).to(g.dtype) if need_g else None
    d_x = _spmm_t(a, gg, g).to(x.dtype) if need_x else None
    return d_g, d_x


class _SpmmSum(torch.autograd.Function):
    """``A @ x`` over ``(value, x)``; the index structure is closed over.
    ``structure_fn`` gives the :class:`SpmmStructure` and is called only
    when the backward needs ``d x``; ``row_split`` is ``rowptr``'s piece
    table (or ``"auto"``: built by each launch); ``relays`` the caller's
    dict for :func:`csc_values`, or None. Its backward is
    :class:`_SumGrads` (both grads), :class:`_Sddmm` (``d value``) or
    :func:`_spmm_t` (``d x``), so it differentiates at any order."""

    @staticmethod
    def forward(ctx, value, x, rowptr, col, structure_fn, row_split,
                relays=None):
        with scope("psp.spmm.forward"):
            ctx.save_for_backward(value, x)
            ctx.csr = _Csr(rowptr, col, structure_fn, row_split, relays)
            return spmm_csr_cuda(rowptr, col, value, x, split=row_split)

    @staticmethod
    def backward(ctx, g):
        with scope("psp.spmm.backward"):
            value, x = ctx.saved_tensors
            d_value, d_x = _sum_vjp(ctx.csr, value, x, g,
                                    *ctx.needs_input_grad[:2])
            return d_value, d_x, None, None, None, None, None


def _sum_vjp(a: _Csr, value, x, g, need_value: bool, need_x: bool):
    """The grads of ``A(value) @ x`` along ``g``, ``(d value, d x)`` (None
    where not needed): :class:`_SumGrads` for both, :class:`_Sddmm` for
    ``d value`` alone, :func:`_spmm_t` for ``d x`` alone."""
    g = g.contiguous()       # the grad of a sum is stride-0
    d_value = d_x = None
    if need_value and need_x:
        d_value, d_x = _SumGrads.apply(value, g, x, a)
    elif need_value:
        d_value = _sddmm(a, g, x, value.dtype)
    elif need_x:
        d_x = _spmm_t(a, value, g)
    if d_x is not None:
        d_x = d_x.to(x.dtype)
    return d_value, d_x


class _HeadsSpmm(torch.autograd.Function):
    """``out[:, k] = A(value[:, k]) @ x[:, k]`` for each of the H heads of
    ``value`` (E, H) and ``x`` (N, H, D), into one (M, H, D) output: the
    same as the H products stacked, bit for bit. Each head's K1 (inside
    ``psp.spmm.forward``) gathers from the view ``x[:, k]`` and writes the
    view ``out[:, k]`` at their row strides, and reads ``value[:, k]``,
    contiguous where ``value`` is the view of a head-major (H, E) buffer.
    Its backward is :class:`_SpmmSum`'s head by head (:func:`_sum_vjp`,
    inside ``psp.spmm.backward``), on the heads' contiguous copies of ``x``
    and ``g``, the grads stacked."""

    @staticmethod
    def forward(ctx, value, x, rowptr, col, structure_fn, row_split):
        ctx.save_for_backward(value, x)
        ctx.csr = _Csr(rowptr, col, structure_fn, row_split)
        M, (H, D) = rowptr.numel() - 1, x.shape[1:]
        out = torch.empty((M, H, D), device=x.device,
                          dtype=torch.promote_types(value.dtype, x.dtype))
        for k in range(H):
            with scope("psp.spmm.forward"):
                spmm_csr_cuda(rowptr, col, value[:, k], x[:, k],
                              split=row_split, out=out[:, k])
        return out

    @staticmethod
    def backward(ctx, g):
        value, x = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        d_value, d_x = [], []
        for k in range(x.shape[1]):
            with scope("psp.spmm.backward"):
                dv, dx = _sum_vjp(ctx.csr, value[:, k],
                                  x[:, k].contiguous(), g[:, k], *need)
            d_value.append(dv)
            d_x.append(dx)
        return (torch.stack(d_value, 1) if need[0] else None,
                torch.stack(d_x, 1) if need[1] else None,
                None, None, None, None)


class _SumGrads(torch.autograd.Function):
    """Both grads of :class:`_SpmmSum` at ``g``, ``d x = A(value)^T @ g``
    and ``d value = g[row] . x[col]`` (0 at padding), in one pass over the
    CSC view that gathers each row of ``g`` once for both (K2′, on the
    values in CSC order from :func:`csc_values`), as ``(d value, d x)``.
    Its backward is those two functions' own, each a
    differentiable Function: along ``gd_x``, ``d value = g[row] .
    gd_x[col]`` (K2) and ``d g = A(value) @ gd_x`` (K1); along
    ``gd_value``, :func:`_sddmm_vjp` (K1 twice)."""

    @staticmethod
    def forward(ctx, value, g, x, a):
        with scope("psp.spmm.sum_grads"):
            ctx.save_for_backward(value, g, x)
            ctx.csr = a
            ctx.set_materialize_grads(False)
            s = a.structure_fn()
            d_x, d_value = spmm_sddmm_csc_cuda(
                s.colptr, s.col_t, s.perm, value, g, x,
                out_dtype=value.dtype, split=s.col_split,
                inv_perm=s.inv_perm,
                value_t=csc_values(value, s.perm, a.relays))
            return d_value, d_x

    @staticmethod
    def backward(ctx, gd_value, gd_x):
        with scope("psp.spmm.sum_grads.backward"):
            value, g, x = ctx.saved_tensors
            a = ctx.csr
            need_v, need_g, need_x = ctx.needs_input_grad[:3]
            d_v = d_g = d_x = None
            if gd_x is not None:
                gd_x = gd_x.contiguous()
                if need_v:
                    d_v = _sddmm(a, g, gd_x, value.dtype)
                if need_g:
                    d_g = _spmm(a, value, gd_x).to(g.dtype)
            if gd_value is not None:
                d_g2, d_x = _sddmm_vjp(a, gd_value.contiguous(), g, x,
                                       need_g, need_x)
                d_g = d_g2 if d_g is None else d_g + d_g2
            return d_v, d_g, d_x, None


class _Sddmm(torch.autograd.Function):
    """``d value[e] = g[row[e]] . x[col[e]]`` (K2, 0 at padding) over
    ``(g, x)``, in ``out_dtype``: the value gradient of :class:`_SpmmSum`
    when ``d x`` is not needed. Its backward is :func:`_sddmm_vjp`, K1
    twice, each a differentiable :class:`_SpmmSum`."""

    @staticmethod
    def forward(ctx, g, x, rowptr, col, structure_fn, row_split, out_dtype):
        with scope("psp.spmm.sddmm"):
            ctx.save_for_backward(g, x)
            ctx.csr = _Csr(rowptr, col, structure_fn, row_split)
            return sddmm_csr_cuda(rowptr, col, g, x, out_dtype=out_dtype,
                                  split=row_split)

    @staticmethod
    def backward(ctx, gg):
        with scope("psp.spmm.sddmm.backward"):
            g, x = ctx.saved_tensors
            d_g, d_x = _sddmm_vjp(ctx.csr, gg.contiguous(), g, x,
                                  *ctx.needs_input_grad[:2])
            return d_g, d_x, None, None, None, None, None


def check_backend(backend: str) -> None:
    """Accept the JAX package's ``backend`` values."""
    if backend not in ("auto", "pallas", "xla", "sell"):
        raise ValueError(f"unknown spmm backend {backend!r}: 'auto', "
                         f"'pallas', 'xla' or 'sell'")


def spmm_with_structure(rowptr: torch.Tensor, col: torch.Tensor,
                        value: Optional[torch.Tensor], x: torch.Tensor,
                        structure_fn: Callable[[], SpmmStructure],
                        reduce: str = "sum", row_split=AUTO,
                        relays: Optional[dict] = None) -> torch.Tensor:
    """:func:`spmm_csr`, taking the CSC view from ``structure_fn`` when the
    backward needs it and ``rowptr``'s piece table from ``row_split`` (a
    ``PaddedCOO`` passes its cached ones, and its cache dict as ``relays``,
    where the backward keeps the values in CSC order: :func:`csc_values`;
    this forward empties it).

    ``value`` is (E,), or (E, H), a value per entry and head: then ``x``'s
    K columns (its trailing dims flattened) are H blocks of K / H, block k
    of the output is the sum of block k of ``x`` with ``value[:, k]``
    (``reduce`` ``"sum"``), equal bit for bit to the H blocks summed apart
    and concatenated, and made by :class:`_HeadsSpmm` with no copy of
    ``x`` and no per-head output (a float sum: an integer pair is
    refused)."""
    if relays is not None:
        relays.pop(_CSC_VALUES, None)
    if reduce not in ("sum", "add", "mean", "min", "max"):
        raise ValueError(f"unknown reduction {reduce!r}")
    heads = value is not None and value.dim() == 2
    if value is not None and value.dim() != 1 and not heads:
        raise ValueError("spmm expects a value per entry (E,), or per entry "
                         "and head (E, H)")
    if heads and (reduce not in ("sum", "add")
                  or math.prod(x.shape[1:]) % value.shape[1]):
        raise ValueError(f"per-head values {tuple(value.shape)} sum "
                         f"(reduce='sum') blocks of x's columns: "
                         f"{tuple(x.shape[1:])} do not split into "
                         f"{value.shape[1]}")
    if value is not None and value.is_floating_point() != \
            x.is_floating_point():
        # a mixed int/float pair sums as the promoted float, as in JAX
        common = torch.promote_types(value.dtype, x.dtype)
        value, x = value.to(common), x.to(common)
    if heads and not x.is_floating_point():
        raise TypeError(f"per-head values sum in a float dtype, got "
                        f"{value.dtype} values and {x.dtype} x")
    M = rowptr.numel() - 1
    if heads:
        out = _HeadsSpmm.apply(value, x.reshape(x.shape[0], value.shape[1],
                                                -1),
                               rowptr, col, structure_fn, row_split)
        return out.reshape((M,) + tuple(x.shape[1:]))
    x2 = x.reshape(x.shape[0], -1).contiguous()
    if reduce in ("min", "max"):
        # the products of the real entries only (one host read of
        # rowptr[M]): a padding product of 0 must not win a row's max
        nnz = int(rowptr[-1])
        prod = x2.index_select(0, col[:nnz].long())
        if value is not None:
            prod = prod * value[:nnz, None]
        out = segment_csr(prod, rowptr, reduce)
    else:
        out = _SpmmSum.apply(value, x2, rowptr, col, structure_fn, row_split,
                             relays)
        if reduce == "mean":
            # the degree in the output's dtype, then at least 1, as JAX
            # counts it; an integer sum divides as a float (f64 from
            # int64, else f32), as JAX's true divide does
            deg = (rowptr[1:] - rowptr[:-1]).to(out.dtype).clamp(min=1)
            if not out.is_floating_point():
                f = (torch.float64 if out.dtype == torch.int64
                     else torch.float32)
                out, deg = out.to(f), deg.to(f)
            out = out / deg[:, None]
    return out.reshape((M,) + tuple(x.shape[1:]))


def spmm_csr(rowptr: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor,
             reduce: str = "sum", backend: str = "auto") -> torch.Tensor:
    """``out[m] = sum_{rowptr[m] <= e < rowptr[m+1]} value[e] * x[col[e]]``,
    or with ``reduce="mean"`` that sum over ``max(1, rowptr[m+1] -
    rowptr[m])``, or with ``"min"``/``"max"`` the row's least/greatest
    product (0 for an empty row).

    ``value`` may be ``None`` (implicit ones); ``x`` is (N, ...) and the
    output (M, ...) with ``M = len(rowptr) - 1``, in the promoted dtype of
    ``value`` and ``x``. Differentiable in ``value`` and ``x``; the backward
    builds the CSC view of ``(rowptr, col)`` on each call, and each launch
    the piece table of its pointer. ``backend``: ``"auto"``, ``"pallas"``
    and ``"xla"`` all run this one path (the kernels on a CUDA tensor, the
    plain versions on a CPU tensor); ``"sell"`` runs
    :func:`~.spmm_sell.spmm_sell` on a plan cached per ``(rowptr, col)``,
    which takes the pointer as starting at 0, as the JAX package does."""
    check_backend(backend)
    if backend == "sell":
        row = ptr2ind_capped(rowptr, col.numel())
        return _sell(row, col, value, x, rowptr.numel() - 1, reduce,
                     key_row=rowptr, key_col=col)

    def structure_fn():
        return spmm_structure(rowptr, ptr2ind_capped(rowptr, col.numel()),
                              col, x.shape[0])

    return spmm_with_structure(rowptr, col, value, x, structure_fn, reduce)


def spmm_coo(row: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor, num_rows: int,
             reduce: str = "sum", backend: str = "auto") -> torch.Tensor:
    """``out[m] = sum_{e: row[e]=m} value[e] * x[col[e]]`` for ``m <
    num_rows`` (or the ``reduce`` of :func:`spmm_csr`); ``row`` sorted
    ascending. Entries with ``row >= num_rows``
    (padding) are left out, as the JAX segment-sum drops them, and their
    ``d value`` is 0. ``backend`` as in :func:`spmm_csr`, the sell plan
    cached per ``(row, col)``."""
    check_backend(backend)
    if backend == "sell":
        return _sell(row, col, value, x, num_rows, reduce)
    return spmm_csr(ind2ptr(row, num_rows), col, value, x, reduce, backend)


def _sell(row, col, value, x, num_rows, reduce, key_row=None,
          key_col=None):
    """``backend="sell"``: the cached sell plan of ``(row, col)`` (keyed on
    ``key_row``/``key_col``, default ``row``/``col``) and its SpMM. It
    takes ``reduce="sum"`` and a 2-D float ``x``, as the JAX package's
    does."""
    from .spmm_sell import spmm_sell
    if reduce not in ("sum", "add") or x.dim() != 2 \
            or not x.is_floating_point():
        raise ValueError("backend='sell' needs a 2-D float dense operand "
                         "and reduce='sum'")
    plan, s = _cached_sell_plan(row, col, num_rows, x.shape[0], x.shape[-1],
                                key_row, key_col)
    return spmm_sell(plan, s, value, x)


class SpmmPlan(NamedTuple):
    """The static part of a :func:`spmm_chunked` plan. The JAX plan's chunk
    geometry (rows per chunk, edge capacities, block counts, ``interpret``)
    is TPU layout and has no counterpart here."""
    num_rows: int
    num_cols: int


class ChunkedStructure(NamedTuple):
    """The index structure of a :func:`spmm_chunked` plan: row-sorted int32
    COO indices and their :class:`SpmmStructure` (named apart from it: it
    adds the forward's ``col``)."""
    row: torch.Tensor      # (nnz,) int32, sorted
    col: torch.Tensor      # (nnz,) int32
    csr: SpmmStructure     # CSR pointer, CSC view, piece tables


def make_spmm_plan(row, col, num_rows: int, num_cols: int, feat_dim: int,
                   target_bytes: int = 512 * 1024 * 1024):
    """Set-up for repeated SpMMs on one structure: ``(plan, structure)``
    for :func:`spmm_chunked`, built once on ``row``'s device: the CSR
    pointer over the real rows (entries with ``row >= num_rows`` are
    padding), the CSC view and both pointers' piece tables. ``row`` must be
    sorted ascending. ``feat_dim`` and ``target_bytes`` sized the JAX
    package's chunks and are accepted for its signature."""
    del feat_dim, target_bytes          # TPU chunk sizing
    row = torch.as_tensor(row)
    col = torch.as_tensor(col, device=row.device)
    if max(num_rows + 1, num_cols, row.numel()) >= 2 ** 31:
        raise ValueError("the SpMM kernels index with int32: M + 1, N and "
                         "nnz must be below 2**31")
    if row.numel() > 1 and bool((row[1:] < row[:-1]).any()):
        raise ValueError("make_spmm_plan requires row indices sorted "
                         "ascending (canonical COO order)")
    # copies, so that a write into the caller's indices leaves the plan as
    # it was built
    row = row.to(torch.int32, copy=True)
    col = col.to(torch.int32, copy=True)
    rowptr = ind2ptr(row, num_rows)
    structure = ChunkedStructure(row, col, spmm_structure(rowptr, row, col,
                                                          num_cols))
    return SpmmPlan(num_rows, num_cols), structure


def spmm_chunked(plan: SpmmPlan, s: ChunkedStructure,
                 value: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (sum) over a :func:`make_spmm_plan` plan, differentiable in
    ``(value, x)``: K1 over the CSR forward; the backward as
    :class:`_SpmmSum`'s, over the plan's cached CSC view (both grads in one
    fused pass, as the JAX package's ``_spmm_chunked_bwd``; ``d value`` 0 at
    padding). ``value`` in COO order or None; the output has ``x``'s
    dtype."""
    if x.shape[0] != plan.num_cols:
        raise ValueError(f"x must have {plan.num_cols} rows, got "
                         f"{tuple(x.shape)}")
    return spmm_with_structure(s.csr.rowptr, s.col, value, x,
                               lambda: s.csr, "sum",
                               s.csr.row_split).to(x.dtype)


# the sell plans, keyed on the caller's index tensors (id + weakref
# liveness, as the JAX package keys them, and each tensor's version
# counter: torch tensors, unlike JAX arrays, can be written in place), so
# repeated calls on one structure plan once
_SELL_CACHE = {}


def _cached_sell_plan(row, col, num_rows: int, num_cols: int,
                      feat_dim: int, key_row=None, key_col=None):
    """``spmm_sell.make_sell_plan`` of ``(row, col)``, cached per
    ``(key_row, key_col)`` (default the indices themselves) and shape, and
    planned again after an in-place write to either key; the plan does not
    depend on ``feat_dim``."""
    from .spmm_sell import make_sell_plan
    key_row = row if key_row is None else key_row
    key_col = col if key_col is None else key_col
    key = id(key_col)
    stamp = (num_rows, num_cols, key_row._version, key_col._version)
    ent = _SELL_CACHE.get(key)
    if (ent is not None and ent[0]() is key_col and ent[1]() is key_row
            and ent[2] == stamp):
        return ent[3], ent[4]
    plan, structure = make_sell_plan(row, col, num_rows, num_cols,
                                     feat_dim=feat_dim)
    _SELL_CACHE[key] = (
        weakref.ref(key_col, lambda _: _SELL_CACHE.pop(key, None)),
        weakref.ref(key_row), stamp, plan, structure)
    return plan, structure
