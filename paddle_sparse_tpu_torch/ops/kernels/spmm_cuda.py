"""CSR SpMM (sum) on the card: ``out[m] = sum_e value[e] * x[col[e]]`` over
``rowptr[m] <= e < rowptr[m+1]``.

Port of ``paddle_sparse_tpu/ops/kernels/spmm_pallas.py::spmm_pallas``, which
gathers and scales ``x`` rows with XLA and row-sums the product stream with the
Pallas kernel ``_reduce_kernel``. Here one hand-written CUDA kernel does the
gather, the scale and the row-sum: the multi-span kernel of
``csrc/spmm_spans.cu`` with one span per row (S = 1, ``start = rowptr[:-1]``,
``end = rowptr[1:]``), which walks a CSR row in edge order.

Dtype contract, as in ``spmm_pallas``: the output has the promoted dtype of
``value`` and ``x``; sums are taken in f32 (f64 in the plain version when the
inputs are f64); ``value=None`` means implicit ones; any K works. A row of
more than ``row_split.CAP`` edges is cut into pieces, one warp each, whose
partials a second pass sums (``ops/kernels/row_split.py``).
"""
from typing import Optional

import torch

from .row_split import AUTO, launch_spmm_spans, resolve_split

# edges per window of the plain version: bounds its (window, K) product
# stream to about 1 GiB, so it never builds the whole (nnz, K) stream
_WINDOW_BYTES = 1 << 30


def _out_dtype(value: Optional[torch.Tensor], x: torch.Tensor) -> torch.dtype:
    return x.dtype if value is None else torch.promote_types(value.dtype,
                                                             x.dtype)


def spmm_csr_reference(rowptr: torch.Tensor, col: torch.Tensor,
                       value: Optional[torch.Tensor],
                       x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_csr_cuda`, on any device.

    Processes the edges in bounded windows (gather, scale, ``index_add_``),
    accumulating in f32, or in f64 when the promoted dtype is f64."""
    M, K = rowptr.numel() - 1, x.shape[1]
    out_dtype = _out_dtype(value, x)
    acc_dtype = torch.float64 if out_dtype == torch.float64 else torch.float32
    out = torch.zeros((M, K), dtype=acc_dtype, device=x.device)
    rowptr = rowptr.long()
    e_begin, e_end = int(rowptr[0]), int(rowptr[-1])
    step = max(1, _WINDOW_BYTES // max(1, K * out.element_size()))
    for s in range(e_begin, e_end, step):
        t = min(s + step, e_end)
        edges = torch.arange(s, t, device=x.device)
        rows = torch.searchsorted(rowptr, edges, right=True) - 1
        prod = x[col[s:t].long()].to(acc_dtype)
        if value is not None:
            prod *= value[s:t, None].to(acc_dtype)
        out.index_add_(0, rows, prod)
    return out.to(out_dtype)


def _check_cuda_args(rowptr, col, value, x):
    dev = x.device
    for name, t in (("rowptr", rowptr), ("col", col), ("value", value)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D tensor, got shape "
                         f"{tuple(x.shape)} (contiguous={x.is_contiguous()})")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"spmm_csr_cuda takes f32 or bf16 x, got {x.dtype}")
    if rowptr.dim() != 1 or rowptr.numel() < 1 or col.dim() != 1:
        raise ValueError("rowptr and col must be 1-D, rowptr non-empty")
    for name, t in (("rowptr", rowptr), ("col", col)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
    if max(col.numel(), x.shape[0], x.shape[1], rowptr.numel()) >= 2 ** 31:
        raise ValueError("spmm_csr_cuda indexes with int32: nnz, N, K and M "
                         "must each be below 2**31")
    if value is not None:
        if value.shape != col.shape:
            raise ValueError(f"value shape {tuple(value.shape)} != col shape "
                             f"{tuple(col.shape)}")
        if value.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"spmm_csr_cuda takes f32 or bf16 value, got "
                            f"{value.dtype}")


def spmm_csr_cuda(rowptr: torch.Tensor, col: torch.Tensor,
                  value: Optional[torch.Tensor], x: torch.Tensor,
                  split=AUTO) -> torch.Tensor:
    """CSR SpMM through the CUDA kernel ``csrc/spmm_spans.cu`` at S = 1.

    ``rowptr`` (M+1,) is a canonical CSR pointer into ``col``/``value``;
    ``x`` is a contiguous (N, K) f32 or bf16 tensor and every ``col[e]`` with
    ``e < rowptr[M]`` lies in ``[0, N)``. ``split`` is the pointer's
    :class:`~.row_split.RowSplit` (``PaddedCOO`` caches it), ``None`` when
    no row is longer than its cap, or ``"auto"`` to build it here (one host
    read of the longest row). On a CPU tensor this runs
    :func:`spmm_csr_reference`; on a CUDA tensor it launches the kernel or
    raises. ``spmm_csr_cuda.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return spmm_csr_reference(rowptr, col, value, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr_cuda runs on cpu or cuda, not {x.device}")
    _check_cuda_args(rowptr, col, value, x)
    out_dtype = _out_dtype(value, x)
    M, K = rowptr.numel() - 1, x.shape[1]
    out = torch.empty((M, K), dtype=out_dtype, device=x.device)
    if M == 0 or K == 0:
        return out
    rowptr = rowptr.to(torch.int32).contiguous()
    col = col.to(torch.int32).contiguous()
    if value is not None:
        value = value.to(torch.float32).contiguous()
    start, end = rowptr[None, :-1], rowptr[None, 1:]
    launch_spmm_spans("spmm_csr", start, end, col, value, None, x, out,
                      resolve_split(split, start, end))
    spmm_csr_cuda.launches += 1
    return out


spmm_csr_cuda.launches = 0
