"""Single-index selection = narrow of length 1
(port of ``paddle_sparse_tpu/select.py``)."""
from .narrow import narrow
from .tensor import SparseTensor


def select(src: SparseTensor, dim: int, idx: int) -> SparseTensor:
    return narrow(src, dim, start=idx, length=1)


SparseTensor.select = select
