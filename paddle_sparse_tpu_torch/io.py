"""Persistence: save and load sparse matrices (port of
``paddle_sparse_tpu/io.py``).

* ``save_npz`` / ``load_npz``: a host-side ``.npz`` with the index arrays,
  values and sizes, in the JAX package's layout (keys ``row``, ``col``,
  ``sparse_sizes``, ``has_value``, ``value``), so either package reads what
  the other wrote.
* ``to_state_dict`` / ``from_state_dict``: a ``PaddedCOO``'s arrays as
  numpy (keys ``row``, ``col``, ``nnz``, ``shape``, ``value``), as the JAX
  functions give them.
"""
from typing import Dict

import numpy as np
import torch

from .core.matrix import PaddedCOO
from .tensor import SparseTensor, _numpy


def save_npz(path: str, tensor: SparseTensor) -> None:
    row, col, value = tensor.coo()
    payload = {
        "row": _numpy(row),
        "col": _numpy(col),
        "sparse_sizes": np.asarray(tensor.sparse_sizes()),
        "has_value": np.asarray(value is not None),
    }
    if value is not None:
        payload["value"] = _numpy(value)
    np.savez_compressed(path, **payload)


def load_npz(path: str, device=None) -> SparseTensor:
    with np.load(path) as data:
        value = (torch.as_tensor(data["value"], device=device)
                 if bool(data["has_value"]) else None)
        M, N = (int(v) for v in data["sparse_sizes"])
        return SparseTensor(row=torch.as_tensor(data["row"], device=device),
                            col=torch.as_tensor(data["col"], device=device),
                            value=value, sparse_sizes=(M, N), is_sorted=True,
                            trust_data=True)


def to_state_dict(mat: PaddedCOO) -> Dict[str, np.ndarray]:
    out = {"row": _numpy(mat.row), "col": _numpy(mat.col),
           "nnz": np.asarray(mat.nnz, dtype=np.int32),
           "shape": np.asarray(mat.shape)}
    if mat.value is not None:
        out["value"] = _numpy(mat.value)
    return out


def from_state_dict(state: Dict[str, np.ndarray], device=None) -> PaddedCOO:
    value = state.get("value")
    M, N = (int(v) for v in state["shape"])

    def copy(a):        # the arrays may be read-only views (JAX's are)
        return torch.tensor(np.asarray(a), device=device)
    return PaddedCOO(row=copy(state["row"]), col=copy(state["col"]),
                     value=None if value is None else copy(value),
                     nnz=int(state["nnz"]), shape=(M, N))


def _save_npz_method(self: SparseTensor, path: str) -> None:
    """``A.save_npz(path)``. (The JAX facade binds ``save_npz(path,
    tensor)`` itself, so its method passes the tensor as the path.)"""
    save_npz(path, self)


SparseTensor.save_npz = _save_npz_method
SparseTensor.load_npz = staticmethod(load_npz)
