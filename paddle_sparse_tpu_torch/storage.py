"""Eager sparse storage: canonical row-sorted COO with lazily derived CSR/CSC
views.

Port of ``paddle_sparse_tpu/storage.py``: one canonical (row, col)-sorted
COO layout and a lazy cache of derived fields (``rowptr``, ``rowcount``,
``colptr``, ``colcount``, ``csr2csc``, ``csc2csr``) that structural ops keep
when they can. Canonical order comes from two stable sorts, never from a flat
``row * N + col`` key (:func:`~.utils.lexsort_rowcol`).

"Mutation" rebinds and never writes in place: ``set_value_``,
``apply_value_``, ``fill_cache_`` and the ``*_`` ops of the op modules bind
new tensors to the fields. A :meth:`SparseStorage.copy` shares its source's
tensors, so a write into one of them would show in every copy; a rebind
shows in none. Autograd runs on ``value`` only; the indices are not
differentiable.

Besides the reference's caches, a storage keeps what the SpMM kernels take
(:meth:`SparseStorage.kernel_csr`, :meth:`SparseStorage.spmm_structure`):
``rowptr`` and ``col`` cast to int32 once, the CSC view built from the cached
``csr2csc`` and ``colptr``, and the piece tables of both pointers. Copies
that keep the indices (``copy``, ``set_value``) share them, so a second
``A @ x`` on the same structure builds nothing. The host runtime's int64
``rowptr``/``col`` (:meth:`SparseStorage.host_csr`, for sampling,
partitioning and RCM) is cached the same way. They are not among
:meth:`SparseStorage.cached_keys`.
"""
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from .ops.convert import ind2ptr, invert_perm, ptr2ind
from .ops.segment import scatter_reduce, segment_csr
from .ops.spmm import SpmmStructure, ptr_split
from .utils import (as_device, as_index_array, is_row_col_sorted,
                    lexsort_rowcol, strictly_sorted)

LAYOUTS = ("coo", "csr", "csc")

_CACHE_KEYS = ("rowcount", "colptr", "colcount", "csr2csc", "csc2csr")
_ARRAY_FIELDS = ("_row", "_rowptr", "_col", "_value", "_rowcount",
                 "_colptr", "_colcount", "_csr2csc", "_csc2csr")


def get_layout(layout: Optional[str] = None) -> str:
    if layout is None:
        layout = "coo"
        warnings.warn(
            "`layout` argument unset, using default layout `coo` | "
            "specify `coo`, `csr` or `csc` explicitly", stacklevel=3)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {LAYOUTS}")
    return layout


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


class SparseStorage:
    """Canonical sparse storage (2-D, row-major-sorted COO + cached views)."""

    __slots__ = ("_row", "_rowptr", "_col", "_value", "_sparse_sizes",
                 "_rowcount", "_colptr", "_colcount", "_csr2csc", "_csc2csr",
                 "_kernel")

    # csr2csc argsorts run, over all storages: the CSC view's one sort. A
    # caller sets it to 0 and reads it to see that a cached view was reused.
    csc_builds = 0

    def __init__(self,
                 row: Optional[torch.Tensor] = None,
                 rowptr: Optional[torch.Tensor] = None,
                 col: Optional[torch.Tensor] = None,
                 value: Optional[torch.Tensor] = None,
                 sparse_sizes: Optional[Tuple[Optional[int],
                                              Optional[int]]] = None,
                 rowcount: Optional[torch.Tensor] = None,
                 colptr: Optional[torch.Tensor] = None,
                 colcount: Optional[torch.Tensor] = None,
                 csr2csc: Optional[torch.Tensor] = None,
                 csc2csr: Optional[torch.Tensor] = None,
                 is_sorted: bool = False,
                 trust_data: bool = False):
        _require(row is not None or rowptr is not None,
                 "either `row` or `rowptr` must be given")
        _require(col is not None, "`col` is required")

        col = as_index_array(col)
        dev = col.device
        if row is not None:
            row = as_index_array(row, dtype=col.dtype, device=dev)
        if rowptr is not None:
            rowptr = as_index_array(rowptr, dtype=col.dtype, device=dev)
        if value is not None:
            value = torch.as_tensor(value, device=dev)

        # --- infer / validate sparse sizes ------------------------------
        M: Optional[int] = None
        N: Optional[int] = None
        if sparse_sizes is not None:
            M, N = sparse_sizes
        if M is None:
            if rowptr is not None:
                M = int(rowptr.shape[0]) - 1
            else:
                M = int(row.max()) + 1 if row.shape[0] > 0 else 0
        if N is None:
            N = int(col.max()) + 1 if col.shape[0] > 0 else 0
        M, N = int(M), int(N)

        if not trust_data:
            _require(col.dim() == 1, "`col` must be 1-D")
            if row is not None:
                _require(row.dim() == 1 and row.shape[0] == col.shape[0],
                         "`row` must be 1-D and as long as `col`")
                if row.shape[0] > 0:
                    _require(int(row.min()) >= 0 and int(row.max()) < M,
                             "row index out of bounds")
            if rowptr is not None:
                _require(rowptr.dim() == 1 and rowptr.shape[0] == M + 1,
                         f"`rowptr` must have {M + 1} entries")
            if col.shape[0] > 0:
                _require(int(col.min()) >= 0 and int(col.max()) < N,
                         "col index out of bounds")
            if value is not None:
                _require(value.dim() >= 1 and value.shape[0] == col.shape[0],
                         "`value` length must equal nnz")
            for aux, length in ((rowcount, M), (colcount, N),
                                (colptr, N + 1)):
                if aux is not None:
                    _require(aux.shape[0] == length,
                             "a cached count or pointer has the wrong length")

        # --- canonicalize (sort by (row, col)) --------------------------
        if not is_sorted and col.shape[0] > 1:
            if row is None:
                row = ptr2ind(rowptr, int(col.shape[0]))
            if not is_row_col_sorted(row, col):
                perm = lexsort_rowcol(row, col)
                row = row[perm]
                col = col[perm]
                if value is not None:
                    value = value[perm]
                # count/pointer caches depend only on the (row, col)
                # multiset and stay valid; permutation caches do not.
                csr2csc = csc2csr = None

        self._row = row
        self._rowptr = rowptr
        self._col = col
        self._value = value
        self._sparse_sizes = (M, N)
        self._rowcount = rowcount
        self._colptr = colptr
        self._colcount = colcount
        self._csr2csc = csr2csc
        self._csc2csr = csc2csr
        self._kernel: Dict[str, object] = {}

    # ------------------------------------------------------------------
    # empty / factory
    # ------------------------------------------------------------------
    @classmethod
    def empty(cls, device=None) -> "SparseStorage":
        idx = torch.zeros((0,), dtype=torch.long, device=device)
        return cls(row=idx, col=idx, sparse_sizes=(0, 0), is_sorted=True,
                   trust_data=True)

    # ------------------------------------------------------------------
    # primary fields
    # ------------------------------------------------------------------
    def has_row(self) -> bool:
        return self._row is not None

    def row(self) -> torch.Tensor:
        if self._row is None:
            self._row = ptr2ind(self._rowptr, int(self._col.shape[0]))
        return self._row

    def has_rowptr(self) -> bool:
        return self._rowptr is not None

    def rowptr(self) -> torch.Tensor:
        if self._rowptr is None:
            self._rowptr = ind2ptr(self.row(), self._sparse_sizes[0])
        return self._rowptr

    def col(self) -> torch.Tensor:
        return self._col

    def has_value(self) -> bool:
        return self._value is not None

    def value(self) -> Optional[torch.Tensor]:
        return self._value

    def _layout_value(self, value, layout):
        if value is None:
            return None
        value = torch.as_tensor(value, device=self._col.device)
        if get_layout(layout) == "csc":
            value = value[self.csc2csr()]
        _require(value.dim() >= 1 and value.shape[0] == self._col.shape[0],
                 "`value` length must equal nnz")
        return value

    def set_value_(self, value: Optional[torch.Tensor],
                   layout: Optional[str] = None) -> "SparseStorage":
        self._value = self._layout_value(value, layout)
        return self

    def set_value(self, value: Optional[torch.Tensor],
                  layout: Optional[str] = None) -> "SparseStorage":
        return self._replace(value=self._layout_value(value, layout))

    # ------------------------------------------------------------------
    # sizes
    # ------------------------------------------------------------------
    def sparse_sizes(self) -> Tuple[int, int]:
        return self._sparse_sizes

    def sparse_size(self, dim: int) -> int:
        return self._sparse_sizes[dim]

    def nnz(self) -> int:
        return int(self._col.shape[0])

    def sparse_resize(self, sparse_sizes: Tuple[int, int]) -> "SparseStorage":
        _require(len(sparse_sizes) == 2, "sparse_sizes must have two entries")
        old_M, old_N = self._sparse_sizes
        M, N = int(sparse_sizes[0]), int(sparse_sizes[1])
        nnz = self.nnz()

        def _resize_ptr(ptr, diff):
            if ptr is None or diff == 0:
                return ptr
            if diff > 0:
                return torch.cat([ptr, ptr.new_full((diff,), nnz)])
            return ptr[:diff]

        def _resize_count(cnt, diff):
            if cnt is None or diff == 0:
                return cnt
            if diff > 0:
                return torch.cat([cnt, cnt.new_zeros((diff,))])
            return cnt[:diff]

        return SparseStorage(
            row=self._row, rowptr=_resize_ptr(self._rowptr, M - old_M),
            col=self._col, value=self._value, sparse_sizes=(M, N),
            rowcount=_resize_count(self._rowcount, M - old_M),
            colptr=_resize_ptr(self._colptr, N - old_N),
            colcount=_resize_count(self._colcount, N - old_N),
            csr2csc=self._csr2csc, csc2csr=self._csc2csr,
            is_sorted=True, trust_data=True)

    def sparse_reshape(self, num_rows: int, num_cols: int) -> "SparseStorage":
        _require(num_rows > 0 or num_rows == -1, "num_rows must be > 0 or -1")
        _require(num_cols > 0 or num_cols == -1, "num_cols must be > 0 or -1")
        total = self.sparse_size(0) * self.sparse_size(1)
        if num_rows == -1:
            num_rows = total // num_cols
        if num_cols == -1:
            num_cols = total // num_rows
        _require(num_rows * num_cols == total,
                 f"cannot reshape {self._sparse_sizes} to "
                 f"({num_rows}, {num_cols})")

        # the flat position in 64 bits: immune to int32 overflow
        flat = self.row().long() * self.sparse_size(1) + self._col.long()
        row = (flat // num_cols).to(self._col.dtype)
        col = (flat % num_cols).to(self._col.dtype)
        return SparseStorage(row=row, col=col, value=self._value,
                             sparse_sizes=(int(num_rows), int(num_cols)),
                             is_sorted=True, trust_data=True)

    # ------------------------------------------------------------------
    # derived (cached) fields
    # ------------------------------------------------------------------
    def has_rowcount(self) -> bool:
        return self._rowcount is not None

    def rowcount(self) -> torch.Tensor:
        if self._rowcount is None:
            ptr = self.rowptr()
            self._rowcount = ptr[1:] - ptr[:-1]
        return self._rowcount

    def has_colptr(self) -> bool:
        return self._colptr is not None

    def colptr(self) -> torch.Tensor:
        if self._colptr is None:
            self._colptr = ind2ptr(self._col[self.csr2csc()],
                                   self._sparse_sizes[1])
        return self._colptr

    def has_colcount(self) -> bool:
        return self._colcount is not None

    def colcount(self) -> torch.Tensor:
        if self._colcount is None:
            self._colcount = scatter_reduce(torch.ones_like(self._col),
                                            self._col, self._sparse_sizes[1],
                                            "sum")
        return self._colcount

    def has_csr2csc(self) -> bool:
        return self._csr2csc is not None

    def csr2csc(self) -> torch.Tensor:
        if self._csr2csc is None:
            # column-major order of the row-sorted entries: a stable sort by
            # col keeps row order (and input order of duplicates) within a
            # column, as the JAX lexsort((row, col)) does
            SparseStorage.csc_builds += 1
            self._csr2csc = torch.argsort(self._col, stable=True).to(
                self._col.dtype)
        return self._csr2csc

    def has_csc2csr(self) -> bool:
        return self._csc2csr is not None

    def csc2csr(self) -> torch.Tensor:
        if self._csc2csr is None:
            self._csc2csr = invert_perm(self.csr2csc())
        return self._csc2csr

    # ------------------------------------------------------------------
    # what the SpMM kernels take, built once per structure
    # ------------------------------------------------------------------
    def kernel_csr(self):
        """``(rowptr, col, row_split)``: the row pointer and columns cast to
        int32 (the kernels index with int32; larger sizes raise) and the
        pointer's piece table (``None`` when no row is longer than
        ``row_split.CAP``). Cached, and shared with copies that keep the
        indices."""
        if "csr" not in self._kernel:
            M, N = self._sparse_sizes
            if max(M + 1, N, self.nnz()) >= 2 ** 31:
                raise ValueError(
                    f"the SpMM kernels index with int32: M + 1, N and nnz "
                    f"must be below 2**31, got {self._sparse_sizes} and "
                    f"{self.nnz()}")
            with torch.inference_mode(False):
                rowptr = self.rowptr().to(torch.int32)
                self._kernel["csr"] = (rowptr, self._col.to(torch.int32),
                                       ptr_split(rowptr))
        return self._kernel["csr"]

    def spmm_structure(self) -> SpmmStructure:
        """The CSC view the SpMM backward takes, from the cached ``csr2csc``
        (a stable argsort of ``col``, the structure's ``perm``), its inverse
        and ``colptr``, in int32, with both pointers' piece tables. Cached
        like :meth:`kernel_csr`; built outside inference mode, because
        autograd refuses to use inference tensors a forward under
        ``torch.inference_mode()`` would leave here."""
        if "structure" not in self._kernel:
            rowptr, _, row_split = self.kernel_csr()
            with torch.inference_mode(False):
                perm = self.csr2csc()
                perm32 = perm.to(torch.int32)
                colptr = self.colptr().to(torch.int32)
                self._kernel["structure"] = SpmmStructure(
                    rowptr=rowptr, perm=perm32,
                    col_t=self.row()[perm].to(torch.int32), colptr=colptr,
                    row_split=row_split, col_split=ptr_split(colptr),
                    inv_perm=invert_perm(perm32))
        return self._kernel["structure"]

    def host_csr(self):
        """``(rowptr, col)`` as int64 numpy arrays on the host, for the C++
        host runtime (sampling, partitioning, RCM). Copied from the device
        once per structure and cached like :meth:`kernel_csr`: at
        ogbn-products scale a copy per minibatch would move ~1 GB of
        ``col``."""
        if "host" not in self._kernel:
            self._kernel["host"] = (self.rowptr().cpu().long().numpy(),
                                    self._col.cpu().long().numpy())
        return self._kernel["host"]

    # ------------------------------------------------------------------
    # coalescing
    # ------------------------------------------------------------------
    def is_coalesced(self) -> bool:
        row, col = self.row(), self._col
        if row.shape[0] < 2:
            return True
        return bool(strictly_sorted(row, col).all())

    def coalesce(self, reduce: str = "add") -> "SparseStorage":
        row, col = self.row(), self._col
        nnz = self.nnz()
        if nnz == 0:
            return self
        keep = torch.cat([torch.ones(1, dtype=torch.bool, device=col.device),
                          strictly_sorted(row, col)])
        if bool(keep.all()):
            return self

        value = self._value
        if value is not None:
            starts = torch.nonzero(keep).squeeze(1).to(col.dtype)
            ptr = torch.cat([starts, starts.new_full((1,), nnz)])
            value = segment_csr(value, ptr, reduce=reduce)
        return SparseStorage(row=row[keep], col=col[keep], value=value,
                             sparse_sizes=self._sparse_sizes,
                             is_sorted=True, trust_data=True)

    # ------------------------------------------------------------------
    # cache management
    # ------------------------------------------------------------------
    def fill_cache_(self) -> "SparseStorage":
        self.row()
        self.rowptr()
        self.rowcount()
        self.colptr()
        self.colcount()
        self.csr2csc()
        self.csc2csr()
        return self

    def clear_cache_(self) -> "SparseStorage":
        self._rowcount = None
        self._colptr = None
        self._colcount = None
        self._csr2csc = None
        self._csc2csr = None
        self._kernel = {}
        return self

    def cached_keys(self) -> List[str]:
        return [k for k in _CACHE_KEYS
                if getattr(self, f"_{k}") is not None]

    def num_cached_keys(self) -> int:
        return len(self.cached_keys())

    # ------------------------------------------------------------------
    # copies & moves
    # ------------------------------------------------------------------
    def _replace(self, **updates) -> "SparseStorage":
        fields = dict(row=self._row, rowptr=self._rowptr, col=self._col,
                      value=self._value, sparse_sizes=self._sparse_sizes,
                      rowcount=self._rowcount, colptr=self._colptr,
                      colcount=self._colcount, csr2csc=self._csr2csc,
                      csc2csr=self._csc2csr)
        fields.update(updates)
        out = SparseStorage(is_sorted=True, trust_data=True, **fields)
        if set(updates) <= {"value"}:       # same indices: same kernel cache
            out._kernel = self._kernel
        return out

    def copy(self) -> "SparseStorage":
        """New storage object sharing the same tensors (and the kernel
        cache)."""
        return self._replace()

    def clone(self) -> "SparseStorage":
        """New storage object with freshly copied tensors."""
        return self.apply(torch.clone)

    def apply_value(self, fn) -> "SparseStorage":
        value = self._value
        return self._replace(value=None if value is None else fn(value))

    def apply_value_(self, fn) -> "SparseStorage":
        if self._value is not None:
            self._value = fn(self._value)
        return self

    def _mapped(self, fn, value_too: bool = True) -> "SparseStorage":
        def mp(a):
            return None if a is None else fn(a)
        return SparseStorage(
            row=mp(self._row), rowptr=mp(self._rowptr), col=mp(self._col),
            value=mp(self._value) if value_too else self._value,
            sparse_sizes=self._sparse_sizes,
            rowcount=mp(self._rowcount), colptr=mp(self._colptr),
            colcount=mp(self._colcount), csr2csc=mp(self._csr2csc),
            csc2csr=mp(self._csc2csr), is_sorted=True, trust_data=True)

    def apply(self, fn) -> "SparseStorage":
        """Apply ``fn`` to every tensor field (e.g. a device move)."""
        return self._mapped(fn)

    def apply_(self, fn) -> "SparseStorage":
        for name in _ARRAY_FIELDS:
            arr = getattr(self, name)
            if arr is not None:
                setattr(self, name, fn(arr))
        self._kernel = {}
        return self

    def map_indices(self, fn) -> "SparseStorage":
        """Apply ``fn`` to index-typed fields only (dtype casts)."""
        return self._mapped(fn, value_too=False)

    def device(self) -> torch.device:
        return self._col.device

    def to_device(self, device, non_blocking: bool = False
                  ) -> "SparseStorage":
        dev = as_device(device)
        return self.apply(lambda a: a.to(dev, non_blocking=non_blocking))

    def cpu(self) -> "SparseStorage":
        return self.to_device("cpu")

    def cuda(self) -> "SparseStorage":
        """Moves to the card; raises without one."""
        return self.to_device("cuda")

    def pin_memory(self) -> "SparseStorage":
        return self.apply(lambda a: a.pin_memory())

    def is_pinned(self) -> bool:
        return self._col.is_pinned()

    def share_memory_(self) -> "SparseStorage":
        self.apply_(lambda a: a.share_memory_())
        return self

    def is_shared(self) -> bool:
        return self._col.is_shared()
