"""Functional tuple-API interop (port of ``paddle_sparse_tpu/convert.py``):
the scipy bridge, and ``torch.sparse`` COO where the JAX package bridges to
``jax.experimental.sparse``."""
import numpy as np
import scipy.sparse
import torch


def to_torch_sparse(index, value, m: int, n: int) -> torch.Tensor:
    """(index, value) tuple -> ``torch.sparse_coo_tensor`` (duplicates
    kept)."""
    index = torch.as_tensor(index)
    return torch.sparse_coo_tensor(index, torch.as_tensor(value,
                                                          device=index.device),
                                   (m, n))


def from_torch_sparse(A: torch.Tensor):
    """``torch.sparse_coo_tensor`` -> (index, value) tuple, the entries as
    stored (coalesced or not)."""
    return A._indices(), A._values()


def to_scipy(index, value, m: int, n: int):
    index = torch.as_tensor(index).detach().cpu().numpy()
    value = torch.as_tensor(value).detach().cpu().numpy()
    return scipy.sparse.coo_matrix((value, (index[0], index[1])), (m, n))


def from_scipy(A, device=None):
    A = A.tocoo()
    index = torch.as_tensor(np.stack([A.row, A.col]).astype(np.int64),
                            device=device)
    return index, torch.as_tensor(A.data, device=device)


# The reference's import names, after the rename of the backing framework
# (paddle -> torch).
to_paddle_sparse = to_torch_sparse
from_paddle_sparse = from_torch_sparse
