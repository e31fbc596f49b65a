"""Reductions over all entries, dim 0 (columns), dim 1 (rows) and value dims
(port of ``paddle_sparse_tpu/reduce.py``).

dim-0 reduces scatter over ``col`` (unsorted ids), dim-1 reduces
segment-reduce over the CSR row pointer (:mod:`~.ops.segment`, plain
torch). The mean of integer values is taken in torch's default float dtype
(the JAX package takes it in its default float dtype).
"""
from typing import Optional

import torch

from .ops.segment import scatter_reduce, segment_csr
from .tensor import SparseTensor

_REDUCES = ("sum", "add", "mean", "min", "max")


def _reduce_all(value: torch.Tensor, reduce: str, dims=None) -> torch.Tensor:
    if reduce in ("sum", "add"):
        return value.sum() if dims is None else value.sum(dim=dims)
    if reduce == "mean":
        if not value.is_floating_point():
            value = value.to(torch.get_default_dtype())
        return value.mean() if dims is None else value.mean(dim=dims)
    if dims is None:
        return value.amin() if reduce == "min" else value.amax()
    return value.amin(dim=dims) if reduce == "min" else value.amax(dim=dims)


def _check(reduce: str) -> None:
    if reduce not in _REDUCES:
        raise ValueError(f"unknown reduction {reduce!r}")


def reduction(src: SparseTensor, dim: Optional[int] = None,
              reduce: str = "sum") -> torch.Tensor:
    _check(reduce)
    value = src.storage.value()
    dev = src.device()

    if dim is None:
        if value is not None:
            return _reduce_all(value, reduce)
        n = src.nnz() if reduce in ("sum", "add") else 1
        return torch.tensor(n, dtype=src.dtype(), device=dev)

    if dim < 0:
        dim = src.dim() + dim

    if dim == 0:
        if value is not None:
            return scatter_reduce(value, src.storage.col(), src.size(1),
                                  reduce)
        if reduce in ("sum", "add"):
            return src.storage.colcount().to(src.dtype())
        return torch.ones((src.size(1),), dtype=src.dtype(), device=dev)

    if dim == 1:
        if value is not None:
            return segment_csr(value, src.storage.rowptr(), reduce=reduce)
        if reduce in ("sum", "add"):
            return src.storage.rowcount().to(src.dtype())
        return torch.ones((src.size(0),), dtype=src.dtype(), device=dev)

    if value is not None:
        return _reduce_all(value, reduce, dims=dim - 1)
    raise ValueError(f"cannot reduce dim {dim} with reduce={reduce!r}")


def sum(src: SparseTensor, dim: Optional[int] = None  # noqa: A001
        ) -> torch.Tensor:
    return reduction(src, dim, reduce="sum")


def mean(src: SparseTensor, dim: Optional[int] = None) -> torch.Tensor:
    return reduction(src, dim, reduce="mean")


def min(src: SparseTensor, dim: Optional[int] = None  # noqa: A001
        ) -> torch.Tensor:
    return reduction(src, dim, reduce="min")


def max(src: SparseTensor, dim: Optional[int] = None  # noqa: A001
        ) -> torch.Tensor:
    return reduction(src, dim, reduce="max")


SparseTensor.sum = sum
SparseTensor.mean = mean
SparseTensor.min = min
SparseTensor.max = max
