"""Small shared helpers for the eager facade.

Port of ``paddle_sparse_tpu/utils.py``. Canonical order is a (row, col)
lexicographic stable sort, made of two stable ``torch.sort`` passes (the
minor key first, then the major), never a flat ``row * N + col`` key: no
index overflow is possible, and entries with equal keys keep their input
order, which decides how duplicates' values combine.
"""
from typing import Any, Optional, Tuple

import numpy as np
import torch


def index_sort(inputs, max_value=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort; returns (sorted, permutation). ``max_value`` is
    accepted for the reference's signature and unused."""
    inputs = torch.as_tensor(inputs)
    perm = torch.argsort(inputs, stable=True)
    return inputs[perm], perm


def lexsort_rowcol(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (row, col) lexicographically, stably (as
    ``np.lexsort((col, row))``)."""
    perm = torch.argsort(col, stable=True)
    return perm[torch.argsort(row[perm], stable=True)]


def is_row_col_sorted(row: torch.Tensor, col: torch.Tensor) -> bool:
    """Whether (row, col) is in canonical order, duplicates allowed (one
    host read)."""
    if row.shape[0] < 2:
        return True
    r0, r1 = row[:-1], row[1:]
    ok = (r1 > r0) | ((r1 == r0) & (col[1:] >= col[:-1]))
    return bool(ok.all())


def strictly_sorted(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Per adjacent pair of sorted entries, whether the second starts a new
    (row, col): ``(E-1,)`` bool."""
    r0, r1 = row[:-1], row[1:]
    return (r1 > r0) | ((r1 == r0) & (col[1:] > col[:-1]))


def is_scalar(other: Any) -> bool:
    return isinstance(other, (int, float)) or np.isscalar(other)


def as_index_array(x, dtype: Optional[torch.dtype] = None,
                   device=None) -> torch.Tensor:
    """A list, ndarray or tensor as an integer (or bool) tensor. A tensor
    keeps its device unless ``device`` is given, and every input keeps its
    integer dtype unless ``dtype`` is given."""
    arr = torch.as_tensor(x, device=device)
    if arr.is_floating_point() or arr.is_complex():
        raise ValueError(f"expected integer index array, got dtype "
                         f"{arr.dtype}")
    if dtype is not None:
        arr = arr.to(dtype)
    return arr


def same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two tensors alias the same memory (a facade ``copy()``
    shares buffers; ``clone()`` does not)."""
    return a is b or a.data_ptr() == b.data_ptr()


def as_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            f"(torch.cuda.is_available() is False); pass device='cpu' to run "
            f"the plain path on the CPU")
    return dev
