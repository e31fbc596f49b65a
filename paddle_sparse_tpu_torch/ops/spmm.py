"""Sparse @ dense matrix product (SpMM), forward, ``reduce="sum"``.

Port of ``paddle_sparse_tpu/ops/spmm.py::spmm_coo`` / ``spmm_csr``. Dispatch
follows the dense operand's device: a CUDA tensor goes through the CUDA kernel
(:func:`~.kernels.spmm_cuda.spmm_csr_cuda`), a CPU tensor through its plain
PyTorch version (:func:`~.kernels.spmm_cuda.spmm_csr_reference`).

Not yet ported (ROADMAP queue 1, item 3): the mean/min/max reductions and the
backward pass. A call that would need either raises ``NotImplementedError``.
"""
from typing import Optional

import torch

from .convert import ind2ptr
from .kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference


def _check_forward_only(value: Optional[torch.Tensor], x: torch.Tensor,
                        reduce: str) -> None:
    if reduce in ("mean", "min", "max"):
        raise NotImplementedError(
            f"spmm reduce={reduce!r} is not ported yet (ROADMAP queue 1, "
            f"item 3: mean/min/max come with GraphSAGE)")
    if reduce not in ("sum", "add"):
        raise ValueError(f"unknown reduction {reduce!r}")
    if torch.is_grad_enabled() and (
            x.requires_grad or (value is not None and value.requires_grad)):
        raise NotImplementedError(
            "spmm backward is not ported yet (ROADMAP queue 1, item 3): run "
            "the forward under torch.no_grad() or torch.inference_mode()")


def spmm_csr(rowptr: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor,
             reduce: str = "sum") -> torch.Tensor:
    """``out[m] = sum_{rowptr[m] <= e < rowptr[m+1]} value[e] * x[col[e]]``.

    ``value`` may be ``None`` (implicit ones); ``x`` is (N, ...) and the
    output (M, ...) with ``M = len(rowptr) - 1``, in the promoted dtype of
    ``value`` and ``x``."""
    _check_forward_only(value, x, reduce)
    if value is not None and value.dim() != 1:
        raise ValueError("spmm expects scalar edge values (1-D)")
    M = rowptr.numel() - 1
    x2 = x.reshape(x.shape[0], -1)
    fn = spmm_csr_cuda if x2.is_cuda else spmm_csr_reference
    out = fn(rowptr, col, value, x2.contiguous())
    return out.reshape((M,) + tuple(x.shape[1:]))


def spmm_coo(row: torch.Tensor, col: torch.Tensor,
             value: Optional[torch.Tensor], x: torch.Tensor, num_rows: int,
             reduce: str = "sum") -> torch.Tensor:
    """``out[m] = sum_{e: row[e]=m} value[e] * x[col[e]]`` for ``m <
    num_rows``; ``row`` sorted ascending. Entries with ``row >= num_rows``
    (padding) are left out, as the JAX segment-sum drops them."""
    return spmm_csr(ind2ptr(row, num_rows), col, value, x, reduce)
