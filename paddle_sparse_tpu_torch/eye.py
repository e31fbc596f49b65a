"""Functional identity matrix (port of ``paddle_sparse_tpu/eye.py``)."""
import torch


def eye(m: int, dtype=None, device=None):
    """Identity as an ``(index, value)`` tuple on ``device``."""
    row = torch.arange(m, device=device)
    return (torch.stack([row, row], dim=0),
            torch.ones((m,), dtype=dtype, device=device))
