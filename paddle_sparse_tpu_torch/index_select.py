"""Row/column/value gathers (port of ``paddle_sparse_tpu/index_select.py``).

Both sparse axes are one operation, gathering variable-length segments of a
pointer view (:func:`~.ops.segment.gather_segments`): dim 0 gathers CSR row
segments (the result is born row-sorted); dim 1 gathers CSC column segments
and re-canonicalizes with one lexsort.
"""
from .ops.segment import gather_segments
from .storage import SparseStorage, get_layout
from .tensor import SparseTensor
from .utils import as_index_array, lexsort_rowcol


def _index(src: SparseTensor, idx):
    idx = as_index_array(idx, device=src.device())
    if idx.dim() != 1:
        raise ValueError(f"index must be 1-D, got shape {tuple(idx.shape)}")
    return idx


def index_select(src: SparseTensor, dim: int, idx) -> SparseTensor:
    dim = src.dim() + dim if dim < 0 else dim
    idx = _index(src, idx)
    n_idx = int(idx.shape[0])

    if dim == 0:
        rowptr, col, value = src.csr()
        new_rowptr, rowcount, row, perm = gather_segments(rowptr, idx)
        perm = perm.long()
        storage = SparseStorage(
            row=row.to(col.dtype), rowptr=new_rowptr, col=col[perm],
            value=None if value is None else value[perm],
            sparse_sizes=(n_idx, src.sparse_size(1)), rowcount=rowcount,
            is_sorted=True, trust_data=True)
        return src.from_storage(storage)

    if dim == 1:
        colptr, row, value = src.csc()
        new_colptr, colcount, col, perm = gather_segments(colptr, idx)
        perm = perm.long()
        row = row[perm]
        col = col.to(row.dtype)
        csc2csr = lexsort_rowcol(row, col).to(row.dtype)
        storage = SparseStorage(
            row=row[csc2csr], col=col[csc2csr],
            value=None if value is None else value[perm][csc2csr],
            sparse_sizes=(src.sparse_size(0), n_idx),
            colptr=new_colptr, colcount=colcount, csc2csr=csc2csr,
            is_sorted=True, trust_data=True)
        return src.from_storage(storage)

    value = src.storage.value()
    if value is None:
        raise ValueError("cannot index_select a value dim without values")
    return src.set_value(value.index_select(dim - 1, idx.long()),
                         layout="coo")


def index_select_nnz(src: SparseTensor, idx, layout=None) -> SparseTensor:
    idx = _index(src, idx)
    if get_layout(layout) == "csc":
        idx = src.storage.csc2csr()[idx]

    row, col, value = src.coo()
    row, col = row[idx], col[idx]
    if value is not None:
        value = value[idx]
    return SparseTensor(row=row, col=col, value=value,
                        sparse_sizes=src.sparse_sizes(), is_sorted=True)


SparseTensor.index_select = index_select
SparseTensor.index_select_nnz = index_select_nnz
