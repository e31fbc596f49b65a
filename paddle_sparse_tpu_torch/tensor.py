"""User-facing 2-D sparse matrix facade.

Port of ``paddle_sparse_tpu/tensor.py``: the same user API (constructors,
COO/CSR/CSC views, stats, conversions, ``__getitem__`` dispatch) over
:class:`~.storage.SparseStorage`. The op families (narrow, select, add,
mul, reduce, cat, matmul, diag, ...) attach their methods when the package
imports them, one module per family, as in the JAX package.

Autograd is torch's, on ``value`` only: ``requires_grad_``, ``detach`` and
``detach_`` act on the value tensor, and every op is differentiable in it.
Factories that make new tensors (``eye``, ``from_dense`` of an array,
``from_scipy``) take ``device=``; tensors handed in keep their device.
"""
from textwrap import indent
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import scipy.sparse
import torch

from .ops.segment import segment_csr
from .storage import SparseStorage, get_layout
from .utils import lexsort_rowcol, strictly_sorted


class SparseTensor:
    storage: SparseStorage

    def __init__(self,
                 row: Optional[torch.Tensor] = None,
                 rowptr: Optional[torch.Tensor] = None,
                 col: Optional[torch.Tensor] = None,
                 value: Optional[torch.Tensor] = None,
                 sparse_sizes: Optional[Tuple[Optional[int],
                                              Optional[int]]] = None,
                 is_sorted: bool = False,
                 trust_data: bool = False):
        self.storage = SparseStorage(row=row, rowptr=rowptr, col=col,
                                     value=value, sparse_sizes=sparse_sizes,
                                     is_sorted=is_sorted,
                                     trust_data=trust_data)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_storage(cls, storage: SparseStorage) -> "SparseTensor":
        out = cls.__new__(cls)
        out.storage = storage.copy()
        return out

    @classmethod
    def from_edge_index(cls, edge_index, edge_attr=None, sparse_sizes=None,
                        is_sorted: bool = False,
                        trust_data: bool = False) -> "SparseTensor":
        edge_index = torch.as_tensor(edge_index)
        return cls(row=edge_index[0], col=edge_index[1], value=edge_attr,
                   sparse_sizes=sparse_sizes, is_sorted=is_sorted,
                   trust_data=trust_data)

    @classmethod
    def from_dense(cls, mat, has_value: bool = True,
                   device=None) -> "SparseTensor":
        mat = torch.as_tensor(mat, device=device)
        if mat.dim() > 2:
            nz = mat.abs().sum(dim=tuple(range(2, mat.dim())))
        else:
            nz = mat
        row, col = torch.nonzero(nz, as_tuple=True)
        value = mat[row, col] if has_value else None
        return cls(row=row, col=col, value=value,
                   sparse_sizes=(mat.shape[0], mat.shape[1]),
                   is_sorted=True, trust_data=True)

    @classmethod
    def eye(cls, M: int, N: Optional[int] = None, has_value: bool = True,
            dtype=None, device=None, fill_cache: bool = False
            ) -> "SparseTensor":
        N = M if N is None else N
        k = min(M, N)
        kw = dict(dtype=torch.long, device=device)
        row = torch.arange(k, **kw)
        rowptr = torch.arange(M + 1, **kw).clamp(max=k)
        value = (torch.ones((k,), dtype=dtype, device=device) if has_value
                 else None)
        out = cls(row=row, rowptr=rowptr, col=row, value=value,
                  sparse_sizes=(M, N), is_sorted=True, trust_data=True)
        if fill_cache:
            s = out.storage
            s._rowcount = (torch.arange(M, **kw) < k).long()
            s._colptr = torch.arange(N + 1, **kw).clamp(max=k)
            s._colcount = (torch.arange(N, **kw) < k).long()
            s._csr2csc = row
            s._csc2csr = row
        return out

    # ------------------------------------------------------------------
    # copies / dtype / device
    # ------------------------------------------------------------------
    def copy(self) -> "SparseTensor":
        return self.from_storage(self.storage)

    def clone(self) -> "SparseTensor":
        return self.from_storage(self.storage.clone())

    def type(self, dtype, non_blocking: bool = False) -> "SparseTensor":
        value = self.storage.value()
        if value is None or dtype == value.dtype:
            return self
        return self.from_storage(
            self.storage.apply_value(lambda v: v.to(dtype)))

    astype = type

    def type_as(self, tensor, non_blocking: bool = False) -> "SparseTensor":
        return self.type(tensor.dtype)

    def index_dtype(self) -> torch.dtype:
        return self.storage.col().dtype

    def with_index_dtype(self, dtype) -> "SparseTensor":
        """Cast all index tensors (int32 <-> int64)."""
        return self.from_storage(
            self.storage.map_indices(lambda a: a.to(dtype)))

    def to_device(self, device, non_blocking: bool = False) -> "SparseTensor":
        return self.from_storage(self.storage.to_device(device, non_blocking))

    def device_as(self, tensor, non_blocking: bool = False) -> "SparseTensor":
        return self.to_device(tensor.device, non_blocking)

    def device(self) -> torch.device:
        return self.storage.device()

    def cpu(self) -> "SparseTensor":
        return self.to_device("cpu")

    def cuda(self, device=None, non_blocking: bool = False) -> "SparseTensor":
        """Moves to the card (``device``, default the current one); raises
        without one."""
        return self.to_device("cuda" if device is None else device,
                              non_blocking)

    def is_cuda(self) -> bool:
        return self.storage.col().is_cuda

    def pin_memory(self) -> "SparseTensor":
        return self.from_storage(self.storage.pin_memory())

    def is_pinned(self) -> bool:
        return self.storage.is_pinned()

    def share_memory_(self) -> "SparseTensor":
        self.storage.share_memory_()
        return self

    def is_shared(self) -> bool:
        return self.storage.is_shared()

    # ------------------------------------------------------------------
    # formats
    # ------------------------------------------------------------------
    def coo(self):
        return self.storage.row(), self.storage.col(), self.storage.value()

    def csr(self):
        return self.storage.rowptr(), self.storage.col(), self.storage.value()

    def csc(self):
        perm = self.storage.csr2csc()
        value = self.storage.value()
        if value is not None:
            value = value[perm]
        return self.storage.colptr(), self.storage.row()[perm], value

    # ------------------------------------------------------------------
    # storage inheritance
    # ------------------------------------------------------------------
    def has_value(self) -> bool:
        return self.storage.has_value()

    def set_value_(self, value, layout: Optional[str] = None
                   ) -> "SparseTensor":
        self.storage.set_value_(value, layout)
        return self

    def set_value(self, value, layout: Optional[str] = None
                  ) -> "SparseTensor":
        return self.from_storage(self.storage.set_value(value, layout))

    def sparse_sizes(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    def sparse_size(self, dim: int) -> int:
        return self.storage.sparse_sizes()[dim]

    def sparse_resize(self, sparse_sizes) -> "SparseTensor":
        return self.from_storage(self.storage.sparse_resize(sparse_sizes))

    def sparse_reshape(self, num_rows: int, num_cols: int) -> "SparseTensor":
        return self.from_storage(
            self.storage.sparse_reshape(num_rows, num_cols))

    def is_coalesced(self) -> bool:
        return self.storage.is_coalesced()

    def coalesce(self, reduce: str = "sum") -> "SparseTensor":
        return self.from_storage(self.storage.coalesce(reduce))

    def fill_cache_(self) -> "SparseTensor":
        self.storage.fill_cache_()
        return self

    def clear_cache_(self) -> "SparseTensor":
        self.storage.clear_cache_()
        return self

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, self.__class__):
            return False
        if self.sizes() != other.sizes():
            return False
        rowptrA, colA, valueA = self.csr()
        rowptrB, colB, valueB = other.csr()
        if (valueA is None) != (valueB is None):
            return False
        if not torch.equal(rowptrA, rowptrB) or not torch.equal(colA, colB):
            return False
        return valueA is None or torch.equal(valueA, valueB)

    __hash__ = object.__hash__

    # ------------------------------------------------------------------
    # utility
    # ------------------------------------------------------------------
    def _full(self, fill_value, dtype) -> torch.Tensor:
        return torch.full((self.nnz(),), fill_value, dtype=dtype,
                          device=self.device())

    def fill_value_(self, fill_value: float, dtype=None) -> "SparseTensor":
        return self.set_value_(self._full(fill_value, dtype), layout="coo")

    def fill_value(self, fill_value: float, dtype=None) -> "SparseTensor":
        return self.set_value(self._full(fill_value, dtype), layout="coo")

    def sizes(self) -> List[int]:
        sparse_sizes = list(self.sparse_sizes())
        value = self.storage.value()
        if value is not None:
            return sparse_sizes + list(value.shape)[1:]
        return sparse_sizes

    def size(self, dim: int) -> int:
        return self.sizes()[dim]

    def dim(self) -> int:
        return len(self.sizes())

    def nnz(self) -> int:
        return self.storage.nnz()

    def numel(self) -> int:
        value = self.storage.value()
        return value.numel() if value is not None else self.nnz()

    def density(self) -> float:
        M, N = self.sparse_sizes()
        if M == 0 or N == 0:
            return 0.0
        return self.nnz() / (M * N)

    def sparsity(self) -> float:
        return 1.0 - self.density()

    def avg_row_length(self) -> float:
        return self.nnz() / self.sparse_size(0)

    def avg_col_length(self) -> float:
        return self.nnz() / self.sparse_size(1)

    def bandwidth(self) -> int:
        row, col, _ = self.coo()
        return int((row - col).abs().max())

    def avg_bandwidth(self) -> float:
        row, col, _ = self.coo()
        return float((row - col).abs().float().mean())

    def bandwidth_proportion(self, bandwidth: int) -> float:
        row, col, _ = self.coo()
        return int(((row - col).abs() <= bandwidth).sum()) / self.nnz()

    def is_quadratic(self) -> bool:
        return self.sparse_size(0) == self.sparse_size(1)

    def is_symmetric(self) -> bool:
        if not self.is_quadratic():
            return False
        rowptrA, colA, valueA = self.csr()
        colptrB, rowB, valueB = self.csc()
        if not torch.equal(rowptrA, colptrB) or not torch.equal(colA, rowB):
            return False
        if valueA is None or valueB is None:
            return True
        return bool((valueA == valueB).all())

    def to_symmetric(self, reduce: str = "sum") -> "SparseTensor":
        """``A + A^T`` structurally (values merged by ``reduce``)."""
        N = max(self.size(0), self.size(1))
        row, col, value = self.coo()

        all_row = torch.cat([row, col])
        all_col = torch.cat([col, row])
        perm = lexsort_rowcol(all_row, all_col)
        srow, scol = all_row[perm], all_col[perm]
        # the first entry starts a run (no entries: no runs)
        keep = torch.cat([torch.ones(min(1, srow.numel()), dtype=torch.bool,
                                     device=row.device),
                          strictly_sorted(srow, scol)])

        if value is not None:
            starts = torch.nonzero(keep).squeeze(1).to(col.dtype)
            ptr = torch.cat([starts, starts.new_full((1,), srow.shape[0])])
            value = segment_csr(torch.cat([value, value])[perm], ptr,
                                reduce=reduce)
        return SparseTensor(row=srow[keep], col=scol[keep], value=value,
                            sparse_sizes=(N, N), is_sorted=True,
                            trust_data=True)

    # ------------------------------------------------------------------
    # autograd on value
    # ------------------------------------------------------------------
    def detach_(self) -> "SparseTensor":
        value = self.storage.value()
        if value is not None:
            self.storage.set_value_(value.detach(), layout="coo")
        return self

    def detach(self) -> "SparseTensor":
        value = self.storage.value()
        if value is not None:
            value = value.detach()
        return self.set_value(value, layout="coo")

    def requires_grad(self) -> bool:
        """Whether ``value`` requires grad (the JAX facade, which has no
        such flag, answers ``has_value()``)."""
        value = self.storage.value()
        return value is not None and value.requires_grad

    def requires_grad_(self, requires_grad: bool = True,
                       dtype=None) -> "SparseTensor":
        """Sets ``value.requires_grad``; a tensor without values first gets
        ones (of ``dtype``)."""
        if requires_grad and not self.has_value():
            self.fill_value_(1.0, dtype)
        value = self.storage.value()
        if value is not None:
            value.requires_grad_(requires_grad)
        return self

    # ------------------------------------------------------------------
    # dtype helpers
    # ------------------------------------------------------------------
    def dtype(self) -> torch.dtype:
        value = self.storage.value()
        return value.dtype if value is not None else torch.float32

    def is_floating_point(self) -> bool:
        value = self.storage.value()
        return value is None or value.is_floating_point()

    def bfloat16(self):
        return self.type(torch.bfloat16)

    def bool(self):
        return self.type(torch.bool)

    def byte(self):
        return self.type(torch.uint8)

    def char(self):
        return self.type(torch.int8)

    def half(self):
        return self.type(torch.float16)

    def float(self):
        return self.type(torch.float32)

    def double(self):
        return self.type(torch.float64)

    def short(self):
        return self.type(torch.int16)

    def int(self):
        return self.type(torch.int32)

    def long(self):
        return self.type(torch.int64)

    # ------------------------------------------------------------------
    # conversions
    # ------------------------------------------------------------------
    def to_dense(self, dtype=None) -> torch.Tensor:
        row, col, value = self.coo()
        if value is None:
            value = torch.ones((self.nnz(),), dtype=dtype or torch.float32,
                               device=row.device)
        mat = torch.zeros(tuple(self.sizes()), dtype=value.dtype,
                          device=row.device)
        # duplicate (row, col) entries accumulate, as sparse semantics say
        return mat.index_put((row, col), value, accumulate=True)

    def to_torch_sparse_coo_tensor(self, dtype=None) -> torch.Tensor:
        """Export as a ``torch.sparse_coo_tensor`` (duplicates kept)."""
        row, col, value = self.coo()
        if value is None:
            value = torch.ones((self.nnz(),), dtype=dtype or torch.float32,
                               device=row.device)
        elif dtype is not None:
            value = value.to(dtype)
        return torch.sparse_coo_tensor(torch.stack([row, col]), value,
                                       tuple(self.sizes()))

    @classmethod
    def from_torch_sparse_coo_tensor(cls, mat, has_value: bool = True
                                     ) -> "SparseTensor":
        # _indices/_values: the entries as stored, coalesced or not
        index = mat._indices()
        return cls(row=index[0], col=index[1],
                   value=mat._values() if has_value else None,
                   sparse_sizes=(mat.shape[0], mat.shape[1]))

    def to_torch_sparse_csr_tensor(self, dtype=None) -> torch.Tensor:
        """Export as a ``torch.sparse_csr_tensor``."""
        rowptr, col, value = self.csr()
        if value is None:
            value = torch.ones((self.nnz(),), dtype=dtype or torch.float32,
                               device=col.device)
        elif dtype is not None:
            value = value.to(dtype)
        return torch.sparse_csr_tensor(rowptr, col, value,
                                       tuple(self.sizes()))

    @classmethod
    def from_torch_sparse_csr_tensor(cls, mat) -> "SparseTensor":
        return cls(rowptr=mat.crow_indices(), col=mat.col_indices(),
                   value=mat.values(),
                   sparse_sizes=(mat.shape[0], mat.shape[1]))

    # The reference's names: torch's own sparse types stand where the JAX
    # package maps these onto jax.experimental.sparse.
    def to_paddle_sparse_coo_tensor(self, dtype=None) -> torch.Tensor:
        return self.to_torch_sparse_coo_tensor(dtype)

    @classmethod
    def from_paddle_sparse_coo_tensor(cls, mat, has_value: bool = True
                                      ) -> "SparseTensor":
        return cls.from_torch_sparse_coo_tensor(mat, has_value)

    def to_paddle_sparse_csr_tensor(self, dtype=None) -> torch.Tensor:
        return self.to_torch_sparse_csr_tensor(dtype)

    @classmethod
    def from_paddle_sparse_csr_tensor(cls, mat) -> "SparseTensor":
        return cls.from_torch_sparse_csr_tensor(mat)

    def to_paddle_sparse_csc_tensor(self, dtype=None):
        # parity with the reference, which also raises
        raise NotImplementedError(
            "no CSC export, as in the reference; use csc() for the raw "
            "(colptr, row, value) triple")

    def to_padded(self, capacity: Optional[int] = None,
                  index_dtype: torch.dtype = torch.int32):
        """Export to the static-shape core type
        (:class:`~.core.matrix.PaddedCOO`)."""
        from .core.matrix import PaddedCOO
        return PaddedCOO.from_eager(self, capacity=capacity,
                                    index_dtype=index_dtype)

    @classmethod
    def from_padded(cls, mat) -> "SparseTensor":
        return mat.to_eager()

    # ------------------------------------------------------------------
    # indexing & repr
    # ------------------------------------------------------------------
    def __getitem__(self, index: Any) -> "SparseTensor":
        index = list(index) if isinstance(index, tuple) else [index]
        if sum(1 for i in index if i is Ellipsis) > 1:
            raise SyntaxError("only one Ellipsis allowed")

        dim = 0
        out = self
        while len(index) > 0:
            item = index.pop(0)
            if isinstance(item, (list, tuple)):
                item = np.asarray(item)
            if isinstance(item, np.ndarray):
                item = torch.as_tensor(item, device=self.device())

            if isinstance(item, (int, np.integer)):
                out = out.select(dim, int(item))
                dim += 1
            elif isinstance(item, slice):
                if item.step is not None:
                    raise ValueError("step slicing not supported")
                start = 0 if item.start is None else item.start
                start = self.size(dim) + start if start < 0 else start
                stop = self.size(dim) if item.stop is None else item.stop
                stop = self.size(dim) + stop if stop < 0 else stop
                out = out.narrow(dim, start, max(stop - start, 0))
                dim += 1
            elif isinstance(item, torch.Tensor):
                if item.dtype == torch.bool:
                    out = out.masked_select(dim, item)
                else:
                    out = out.index_select(dim, item)
                dim += 1
            elif item is Ellipsis:
                if self.dim() - len(index) < dim:
                    raise SyntaxError
                dim = self.dim() - len(index)
            else:
                raise SyntaxError(f"invalid index {item!r}")
        return out

    def __repr__(self) -> str:
        i = " " * 6
        row, col, value = self.coo()
        infos = [f"row={indent(repr(row), i)[len(i):]}",
                 f"col={indent(repr(col), i)[len(i):]}"]
        if value is not None:
            infos += [f"val={indent(repr(value), i)[len(i):]}"]
        infos += [f"size={tuple(self.sizes())}, nnz={self.nnz()}, "
                  f"density={100 * self.density():.02f}%"]
        body = ",\n".join(infos)
        pad = " " * (len(self.__class__.__name__) + 1)
        return f"{self.__class__.__name__}({indent(body, pad)[len(pad):]})"


# ---------------------------------------------------------------------------
# scipy bridge
# ---------------------------------------------------------------------------
ScipySparseMatrix = Union[scipy.sparse.coo_matrix, scipy.sparse.csr_matrix,
                          scipy.sparse.csc_matrix]


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def from_scipy(mat: ScipySparseMatrix, has_value: bool = True,
               device=None) -> SparseTensor:
    def idx(a):
        return torch.as_tensor(a.astype(np.int64), device=device)
    colptr = None
    if isinstance(mat, scipy.sparse.csc_matrix):
        colptr = idx(mat.indptr)
    csr = mat.tocsr()
    coo = csr.tocoo()
    value = torch.as_tensor(coo.data, device=device) if has_value else None
    storage = SparseStorage(row=idx(coo.row), rowptr=idx(csr.indptr),
                            col=idx(coo.col), value=value,
                            sparse_sizes=coo.shape[:2], colptr=colptr,
                            is_sorted=True)
    return SparseTensor.from_storage(storage)


def to_scipy(self: SparseTensor, layout: Optional[str] = None,
             dtype=None) -> ScipySparseMatrix:
    if self.dim() != 2:
        raise ValueError(f"to_scipy takes a 2-D tensor, got sizes "
                         f"{self.sizes()}")
    layout = get_layout(layout)
    sizes = tuple(self.sizes())

    def val_np(value):
        if value is not None:
            return _numpy(value)
        return np.ones((self.nnz(),), dtype=dtype or np.float32)

    if layout == "coo":
        row, col, value = self.coo()
        return scipy.sparse.coo_matrix(
            (val_np(value), (_numpy(row), _numpy(col))), sizes)
    if layout == "csr":
        rowptr, col, value = self.csr()
        return scipy.sparse.csr_matrix(
            (val_np(value), _numpy(col), _numpy(rowptr)), sizes)
    colptr, row, value = self.csc()
    return scipy.sparse.csc_matrix(
        (val_np(value), _numpy(row), _numpy(colptr)), sizes)


SparseTensor.from_scipy = staticmethod(from_scipy)
SparseTensor.to_scipy = to_scipy


def to(self: SparseTensor, *args, **kwargs) -> SparseTensor:
    """torch-style combined dtype and device move: dtypes, devices (or
    their names), a tensor (its dtype and device) and a ``non_blocking``
    flag, positional or by keyword."""
    device = None
    dtype = None
    if len(args) + len(kwargs) == 0:
        raise TypeError("to() expects at least one argument")

    for arg in args:
        if isinstance(arg, torch.Tensor):
            dtype, device = arg.dtype, arg.device
        elif isinstance(arg, bool):
            pass                        # non_blocking flag
        elif isinstance(arg, torch.dtype):
            dtype = arg
        else:
            device = arg
    device = kwargs.get("device", device)
    dtype = kwargs.get("dtype", dtype)
    other = kwargs.get("other")
    if other is not None and device is None and dtype is None:
        dtype, device = other.dtype, other.device

    out = self
    if dtype is not None:
        out = out.type(dtype)
    if device is not None:
        out = out.to_device(device)
    return out


SparseTensor.to = to
