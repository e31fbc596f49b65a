"""Functional tuple-API coalesce (port of ``paddle_sparse_tpu/coalesce.py``):
sort and deduplicate an ``(index, value)`` pair, merging duplicates with any
segment reduction."""
import torch

from .storage import SparseStorage


def coalesce(index, value, m: int, n: int, op: str = "add"):
    """Row-major-sort ``index`` and merge duplicate entries with ``op``."""
    index = torch.as_tensor(index)
    storage = SparseStorage(row=index[0], col=index[1], value=value,
                            sparse_sizes=(m, n), is_sorted=False)
    storage = storage.coalesce(reduce=op)
    return torch.stack([storage.row(), storage.col()], dim=0), storage.value()
