"""Random walks on the facade (port of ``paddle_sparse_tpu/rw.py``; upstream
``torch_sparse.random_walk``, absent from the reference)."""
from typing import Optional

import torch

from .ops.sample import random_walk as _random_walk
from .tensor import SparseTensor


def random_walk(src: SparseTensor, start, walk_length: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform random walks from ``start``: (num_start, walk_length + 1)
    node ids on ``src``'s device, drawn from ``generator`` (default: the
    facade's generator on that device). A node of degree 0 repeats
    itself."""
    rowptr, col, _ = src.csr()
    start = torch.as_tensor(start, device=col.device).to(col.dtype)
    return _random_walk(rowptr, col, start, walk_length, generator)


SparseTensor.random_walk = random_walk
