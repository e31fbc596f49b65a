"""Boolean-mask selection (port of ``paddle_sparse_tpu/masked_select.py``).

A per-edge predicate plus a prefix-sum relabel of the masked axis: dropping
edges keeps the canonical (row, col) order, so both axes filter in CSR
order, with no permutation or sort.
"""
import torch

from .storage import SparseStorage, get_layout
from .tensor import SparseTensor


def _mask(src: SparseTensor, mask) -> torch.Tensor:
    mask = torch.as_tensor(mask, device=src.device())
    if mask.dim() != 1:
        raise ValueError(f"mask must be 1-D, got shape {tuple(mask.shape)}")
    return mask.bool()


def masked_select(src: SparseTensor, dim: int, mask) -> SparseTensor:
    dim = src.dim() + dim if dim < 0 else dim
    mask = _mask(src, mask)

    if dim in (0, 1):
        row, col, value = src.coo()
        axis = row if dim == 0 else col
        keep = mask[axis]                       # per-edge predicate
        relabel = (torch.cumsum(mask, 0) - 1).to(axis.dtype)
        new_axis = relabel[axis[keep]]
        other = (col if dim == 0 else row)[keep]
        n_keep = int(mask.sum())
        if value is not None:
            value = value[keep]
        if dim == 0:
            storage = SparseStorage(
                row=new_axis, col=other, value=value,
                sparse_sizes=(n_keep, src.sparse_size(1)),
                rowcount=src.storage.rowcount()[mask],
                is_sorted=True, trust_data=True)
        else:
            storage = SparseStorage(
                row=other, col=new_axis, value=value,
                sparse_sizes=(src.sparse_size(0), n_keep),
                colcount=src.storage.colcount()[mask],
                is_sorted=True, trust_data=True)
        return src.from_storage(storage)

    value = src.storage.value()
    if value is None:
        raise ValueError("cannot masked_select a value dim without values")
    idx = torch.nonzero(mask).squeeze(1)
    return src.set_value(value.index_select(dim - 1, idx), layout="coo")


def masked_select_nnz(src: SparseTensor, mask, layout=None) -> SparseTensor:
    mask = _mask(src, mask)
    if get_layout(layout) == "csc":
        mask = mask[src.storage.csc2csr()]

    row, col, value = src.coo()
    row, col = row[mask], col[mask]
    if value is not None:
        value = value[mask]
    return SparseTensor(row=row, col=col, value=value,
                        sparse_sizes=src.sparse_sizes(), is_sorted=True)


SparseTensor.masked_select = masked_select
SparseTensor.masked_select_nnz = masked_select_nnz
