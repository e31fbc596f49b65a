"""Matrix multiply facade: sparse @ dense (SpMM) and sparse @ sparse (SpGEMM).

Port of ``paddle_sparse_tpu/matmul.py``, with upstream's functional
contracts:

* ``spmm(index, value, m, n, matrix) -> dense``;
* ``spspmm(indexA, valueA, indexB, valueB, m, k, n) -> (indexC, valueC)``;
* ``matmul(SparseTensor, dense | SparseTensor, reduce)`` and ``A @ B``.

``A @ x`` runs on the storage's own caches, where the JAX facade calls
``spmm_coo`` and so rebuilds the row pointer on every call and the CSC view
on every backward: :func:`~.ops.spmm.spmm_with_structure` over
:meth:`~.storage.SparseStorage.kernel_csr` (int32 ``rowptr``/``col`` and the
piece table, cast once per structure) and
:meth:`~.storage.SparseStorage.spmm_structure` (the CSC view from the cached
``csr2csc``/``colptr``). On a CUDA tensor that is the CSR SpMM kernel (K1)
forward and for ``d x``, the SDDMM kernel (K2) for ``d value``; on a CPU
tensor their plain versions. ``A @ B`` runs :func:`~.ops.spspmm.spspmm_eager`,
whose compress is the run-compaction kernel (K5) on a CUDA tensor.
"""
from typing import Optional, Tuple, Union

import torch

from .ops.spmm import spmm_coo, spmm_with_structure
from .ops.spspmm import spspmm_eager
from .tensor import SparseTensor
from .utils import lexsort_rowcol


def matmul(src: SparseTensor, other: Union[SparseTensor, torch.Tensor],
           reduce: str = "sum"):
    """``src @ other`` with row-wise ``reduce`` (sum/mean/min/max for dense
    ``other``; sum only for sparse ``other``)."""
    if isinstance(other, SparseTensor):
        if reduce not in ("sum", "add"):
            raise ValueError("sparse @ sparse supports reduce='sum' only")
        return _matmul_sparse(src, other)
    if not isinstance(other, torch.Tensor):
        other = torch.as_tensor(other, device=src.device())
    return _matmul_dense(src, other, reduce)


def _matmul_dense(src: SparseTensor, other: torch.Tensor,
                  reduce: str = "sum") -> torch.Tensor:
    if src.sparse_size(1) != other.shape[0]:
        raise ValueError(f"size mismatch: {src.sparse_sizes()} @ "
                         f"{tuple(other.shape)}")
    s = src.storage
    rowptr, col, row_split = s.kernel_csr()
    return spmm_with_structure(rowptr, col, s.value(), other,
                               s.spmm_structure, reduce, row_split)


def _matmul_sparse(src: SparseTensor, other: SparseTensor) -> SparseTensor:
    if src.sparse_size(1) != other.sparse_size(0):
        raise ValueError(f"size mismatch: {src.sparse_sizes()} @ "
                         f"{other.sparse_sizes()}")
    rowA, colA, valA = src.coo()
    rowptrB, colB, valB = other.csr()
    rowC, colC, valC = spspmm_eager(rowA, colA, valA, rowptrB, colB, valB,
                                    src.sparse_size(0), other.sparse_size(1))
    return SparseTensor(row=rowC, col=colC, value=valC,
                        sparse_sizes=(src.sparse_size(0),
                                      other.sparse_size(1)),
                        is_sorted=True, trust_data=True)


# ---------------------------------------------------------------------------
# upstream tuple-style functional API
# ---------------------------------------------------------------------------
def spmm(index, value: Optional[torch.Tensor], m: int, n: int,
         matrix: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    """Sparse-dense multiply of an ``(index, value)`` m x n matrix."""
    index = torch.as_tensor(index)
    row, col = index[0], index[1]
    perm = lexsort_rowcol(row, col)
    if value is not None:
        value = torch.as_tensor(value, device=index.device)[perm]
    return spmm_coo(row[perm], col[perm], value,
                    torch.as_tensor(matrix, device=index.device), m, reduce)


def spspmm(indexA, valueA: Optional[torch.Tensor], indexB,
           valueB: Optional[torch.Tensor], m: int, k: int, n: int,
           coalesced: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sparse-sparse multiply of (m x k) @ (k x n) in tuple form.
    ``coalesced`` is accepted for upstream's signature; the output is always
    coalesced (the compress deduplicates)."""
    A = SparseTensor(row=indexA[0], col=indexA[1], value=valueA,
                     sparse_sizes=(m, k))
    B = SparseTensor(row=indexB[0], col=indexB[1], value=valueB,
                     sparse_sizes=(k, n))
    rowC, colC, valueC = _matmul_sparse(A, B).coo()
    return torch.stack([rowC, colC], dim=0), valueC


SparseTensor.matmul = matmul
SparseTensor.spmm = _matmul_dense
SparseTensor.spspmm = _matmul_sparse
SparseTensor.__matmul__ = matmul
