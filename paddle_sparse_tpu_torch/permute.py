"""Symmetric permutation of a square matrix
(port of ``paddle_sparse_tpu/permute.py``)."""
from .tensor import SparseTensor


def permute(src: SparseTensor, perm) -> SparseTensor:
    if not src.is_quadratic():
        raise ValueError(f"permute takes a square matrix, got "
                         f"{src.sparse_sizes()}")
    return src.index_select(0, perm).index_select(1, perm)


SparseTensor.permute = permute
