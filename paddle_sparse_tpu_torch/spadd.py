"""Functional tuple-API sparse + sparse addition (port of
``paddle_sparse_tpu/spadd.py``; upstream ``torch_sparse.spadd``)."""
from typing import Optional, Tuple

import torch

from .coalesce import coalesce


def spadd(indexA, valueA: Optional[torch.Tensor], indexB,
          valueB: Optional[torch.Tensor], m: int, n: int,
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Entry-wise A + B of two (m, n) sparse matrices in tuple form."""
    index = torch.cat([torch.as_tensor(indexA), torch.as_tensor(indexB)],
                      dim=1)
    value = None
    if valueA is not None and valueB is not None:
        value = torch.cat([valueA, valueB])
    return coalesce(index, value, m, n, op="add")
