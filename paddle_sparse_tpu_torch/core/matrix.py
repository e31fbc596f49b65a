"""PaddedCOO: a row-sorted COO sparse matrix padded to a fixed capacity.

Port of ``paddle_sparse_tpu/core/matrix.py::PaddedCOO``. The padding
convention is kept: the ``capacity - nnz`` padding entries are ``(row=M,
col=N, value=0)`` and sort after every real entry. The JAX version sums
padding into a dead output row M and slices it off; here :meth:`rowptr` covers
only the M real rows (``rowptr[M] == nnz``), so the SpMM kernel never reads a
padding entry, whose ``col == N`` would lie outside ``x``.

A ``PaddedCOO`` builds its row pointer, its CSC view
(:class:`~..ops.spmm.SpmmStructure`) and the piece tables of both pointers
(long rows and columns cut for the kernels, ``ops/kernels/row_split.py``)
once, at first use, and keeps them, as the reference's plan cache keeps them
per structure. ``with_value`` shares them
(same structure); ``to`` and ``dataclasses.replace`` drop them, so a copy with
other indices or on another device builds its own.
"""
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.convert import ind2ptr, ptr2ind_capped
from ..ops.kernels.segcompact_cuda import compact_runs
from ..ops.kernels.row_split import RowSplit
from ..ops.segment import RowGroups, row_groups
from ..ops.spmm import (SpmmStructure, _sell, check_backend, ptr_split,
                        spmm_structure, spmm_with_structure)


@dataclasses.dataclass(frozen=True)
class PaddedCOO:
    row: torch.Tensor               # (capacity,) int, sorted; padding = M
    col: torch.Tensor               # (capacity,) int; padding = N
    value: Optional[torch.Tensor]   # (capacity,) or None; padding = 0
    nnz: int                        # number of real entries
    shape: Tuple[int, int]          # (M, N)
    # "rowptr", "row_split", "structure" and "row_groups", built at first
    # use; not an init field, so dataclasses.replace starts a copy with an
    # empty cache
    _cache: Dict[str, object] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def capacity(self) -> int:
        return int(self.row.shape[0])

    @property
    def M(self) -> int:
        return self.shape[0]

    @property
    def N(self) -> int:
        return self.shape[1]

    def valid_mask(self) -> torch.Tensor:
        return self.row < self.M

    def rowptr(self) -> torch.Tensor:
        """CSR pointer over the M real rows; padding lies past ``rowptr[M]``.
        Cached: do not write to it."""
        if "rowptr" not in self._cache:
            self._cache["rowptr"] = ind2ptr(self.row, self.M)
        return self._cache["rowptr"]

    def row_split(self) -> Optional[RowSplit]:
        """The piece table of :meth:`rowptr`: ``None`` when no row is
        longer than ``row_split.CAP``. Cached."""
        if "row_split" not in self._cache:
            self._cache["row_split"] = ptr_split(self.rowptr())
        return self._cache["row_split"]

    def row_groups(self) -> RowGroups:
        """The entries, padding clipped to row ``M - 1``, in groups of at
        most ``GROUP`` consecutive entries of one row
        (:func:`~..ops.segment.row_groups`), for per-row reductions and
        gathers with no hot spot on a long row. Cached, and built outside
        inference mode: autograd saves these indices, which it refuses to do
        with inference tensors (a forward under ``torch.inference_mode()``
        may build them before a train step uses them)."""
        if "row_groups" not in self._cache:
            with torch.inference_mode(False):
                self._cache["row_groups"] = row_groups(
                    self.row.long().clamp(0, self.M - 1), self.M)
        return self._cache["row_groups"]

    def structure(self) -> SpmmStructure:
        """Row pointer, CSC view (``perm``, ``col_t``, ``colptr``) and the
        piece tables of both pointers, built once and cached. Cached: do not
        write to it."""
        if "structure" not in self._cache:
            self._cache["structure"] = spmm_structure(
                self.rowptr(), self.row, self.col, self.N, self.row_split())
        return self._cache["structure"]

    @classmethod
    def from_arrays(cls, row, col, value, shape: Tuple[int, int],
                    capacity: Optional[int] = None,
                    index_dtype: torch.dtype = torch.int32,
                    device=None) -> "PaddedCOO":
        """Build from exact row-sorted COO arrays (numpy or torch), padding to
        ``capacity`` (default: the exact nnz). Raises on unsorted rows or
        indices outside ``shape``: the CUDA kernel trusts them."""
        row = torch.as_tensor(row, dtype=index_dtype, device=device)
        col = torch.as_tensor(col, dtype=index_dtype, device=row.device)
        n = int(row.shape[0])
        cap = n if capacity is None else int(capacity)
        if cap < n:
            raise ValueError(f"capacity {cap} < nnz {n}")
        if col.shape != row.shape:
            raise ValueError(f"row {tuple(row.shape)} and col "
                             f"{tuple(col.shape)} differ in shape")
        M, N = int(shape[0]), int(shape[1])
        if n and bool((row.min() < 0) | (row.max() >= M) | (col.min() < 0)
                      | (col.max() >= N) | (row[1:] < row[:-1]).any()):
            raise ValueError(f"rows must be sorted, with row in [0, {M}) and "
                             f"col in [0, {N})")
        if value is not None:
            value = torch.as_tensor(value, device=row.device)
        pad = cap - n
        if pad:
            row = torch.cat([row, row.new_full((pad,), M)])
            col = torch.cat([col, col.new_full((pad,), N)])
            if value is not None:
                value = torch.cat([value, value.new_zeros(
                    (pad,) + tuple(value.shape[1:]))])
        return cls(row=row, col=col, value=value, nnz=n, shape=(M, N))

    @classmethod
    def from_eager(cls, tensor, capacity: Optional[int] = None,
                   index_dtype: torch.dtype = torch.int32) -> "PaddedCOO":
        """From a facade ``SparseTensor`` (row-sorted by construction), on
        its device."""
        r, c, v = tensor.coo()
        return cls.from_arrays(r, c, v, tensor.sparse_sizes(),
                               capacity=capacity, index_dtype=index_dtype)

    def to_eager(self):
        """Back to the eager facade, padding dropped (``nnz`` is a Python
        int, so no host read)."""
        from ..tensor import SparseTensor
        n = self.nnz
        value = None if self.value is None else self.value[:n]
        return SparseTensor(row=self.row[:n], col=self.col[:n], value=value,
                            sparse_sizes=self.shape, is_sorted=True,
                            trust_data=True)

    def to(self, device) -> "PaddedCOO":
        return dataclasses.replace(
            self, row=self.row.to(device), col=self.col.to(device),
            value=None if self.value is None else self.value.to(device))

    def spmm(self, x: torch.Tensor, reduce: str = "sum",
             backend: str = "auto",
             value: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``self @ x`` for dense ``x`` of shape (N, ...), differentiable in
        ``value`` and ``x``; the backward's ``d x`` runs over the cached CSC
        view. ``reduce``: ``"sum"``/``"add"``, ``"mean"``, ``"min"`` or
        ``"max"``, over the real entries only. ``backend``: ``"auto"``,
        ``"pallas"`` and ``"xla"`` all run the port's one path; ``"sell"``
        runs :func:`~..ops.spmm_sell.spmm_sell` on a plan cached per index
        structure (``reduce="sum"`` only; :func:`~..ops.spmm.spmm_csr`).

        ``value``, if given, is a value per entry and head, (capacity, H),
        multiplied in place of ``self.value`` and read at the real entries
        only (its padding need not be 0, so no ``with_value`` copy is
        made): x's columns sum in H blocks, block k with ``value[:, k]``
        (GAT's heads, concatenated: one kernel a head, each reading its
        block of ``x`` and writing its block of the output in place;
        :func:`~..ops.spmm.spmm_with_structure`). ``"sell"`` refuses it."""
        check_backend(backend)
        if value is not None and (value.dim() != 2 or backend == "sell"):
            raise ValueError(f"value= takes per-head values (capacity, H) "
                             f"on a backend other than 'sell', got shape "
                             f"{tuple(value.shape)} on {backend!r}")
        if backend == "sell":
            return _sell(self.row, self.col, self.value, x, self.M, reduce)
        return spmm_with_structure(self.rowptr(), self.col,
                                   self.value if value is None else value,
                                   x, self.structure, reduce,
                                   self.row_split(),
                                   relays=self._cache)

    def transpose(self) -> "PaddedCOO":
        """Swap axes, re-sorted canonically: a stable sort by ``(col, row)``
        (the cached ``perm``). Padding ``(M, N)`` becomes ``(N, M)`` and still
        sorts last. The result starts its cache with ``rowptr = colptr``
        and that pointer's piece table."""
        s = self.structure()
        value = None if self.value is None else self.value.index_select(
            0, s.perm)
        t = PaddedCOO(row=ptr2ind_capped(s.colptr, self.capacity),
                      col=s.col_t, value=value, nnz=self.nnz,
                      shape=(self.N, self.M))
        t._cache["rowptr"] = s.colptr
        t._cache["row_split"] = s.col_split
        return t

    def sort(self) -> "PaddedCOO":
        """Stable lexicographic sort by ``(row, col)``, padding ``(M, N)``
        last; as the JAX ``jnp.lexsort((col, row))``."""
        by_col = torch.argsort(self.col, stable=True)
        perm = by_col[torch.argsort(self.row[by_col], stable=True)]
        value = None if self.value is None else self.value[perm]
        return PaddedCOO(row=self.row[perm], col=self.col[perm], value=value,
                         nnz=self.nnz, shape=self.shape)

    def coalesce(self, assume_sorted: bool = True) -> "PaddedCOO":
        """Merge adjacent duplicate coordinates, summing their values;
        capacity kept, padding ``(M, N, 0)`` past the new ``nnz``, the number
        of unique entries. Without ``assume_sorted`` it sorts first; with it,
        only adjacent duplicates merge, as in the JAX version.

        The sum runs through the run-compaction kernel
        (``ops/kernels/segcompact_cuda.py``) on a CUDA tensor, and its plain
        version on a CPU tensor, differentiable in ``value``: values of
        shape (capacity,) or (capacity, D...), in f32, bf16, f16, f64, int32
        or int64, each entry's vector summed lane by lane in position
        order, f16 and bf16 in f32 and rounded once, the others in their
        own dtype. ``nnz`` is a Python int, so this reads the unique count
        from the device: one host sync."""
        mat = self if assume_sorted else self.sort()
        out = compact_runs(mat.col.int().contiguous(),
                           mat.row.int().contiguous(),
                           None if mat.value is None
                           else mat.value.contiguous(),
                           self.shape, self.capacity)
        idx = self.row.dtype
        return PaddedCOO(row=out.row.to(idx), col=out.col.to(idx),
                         value=out.value, nnz=int(out.count), shape=self.shape)

    def with_value(self, value: Optional[torch.Tensor]) -> "PaddedCOO":
        """Replace the values, zeroing them at padding entries. The structure
        is unchanged, so the copy shares the cache dict itself: what either
        builds later (the CSC view, say) serves both, as ``gcn_normalize``'s
        normalized copy uses it."""
        if value is not None:
            mask = self.valid_mask().reshape((-1,) + (1,) * (value.dim() - 1))
            value = torch.where(mask, value, torch.zeros((), dtype=value.dtype,
                                                         device=value.device))
        out = dataclasses.replace(self, value=value)
        object.__setattr__(out, "_cache", self._cache)
        return out

    def degree(self) -> torch.Tensor:
        """Entries per row (padding excluded)."""
        return torch.bincount(self.row.long(), minlength=self.M + 1)[:self.M]


def padded_coo_from_jax(mat, device=None) -> PaddedCOO:
    """A JAX ``paddle_sparse_tpu.core.PaddedCOO`` (or any object with its
    fields, arrays convertible with ``np.asarray``) -> the port's
    ``PaddedCOO``, array for array: capacity, padding and ``nnz`` kept, the
    entries copied as they are (not validated or re-sorted)."""
    value = None if mat.value is None else torch.from_numpy(
        np.array(mat.value)).to(device)
    return PaddedCOO(row=torch.from_numpy(np.array(mat.row)).to(device),
                     col=torch.from_numpy(np.array(mat.col)).to(device),
                     value=value, nnz=int(mat.nnz),
                     shape=(int(mat.shape[0]), int(mat.shape[1])))


_STORAGE_FIELDS = ("row", "rowptr", "col", "value", "rowcount", "colptr",
                   "colcount", "csr2csc", "csc2csr")


def sparse_tensor_from_jax(t, device=None):
    """A JAX ``paddle_sparse_tpu.SparseTensor`` (or any object whose
    ``storage`` has its ``_row``, ``_rowptr``, ... fields, arrays
    convertible with ``np.asarray``) -> the port's ``SparseTensor``, array
    for array: the sizes, the cached fields and which of them are present
    kept, nothing validated or re-sorted."""
    from ..storage import SparseStorage
    from ..tensor import SparseTensor
    s = t.storage
    fields = {}
    for name in _STORAGE_FIELDS:
        a = getattr(s, f"_{name}")
        fields[name] = (None if a is None
                        else torch.from_numpy(np.array(a)).to(device))
    M, N = s._sparse_sizes
    storage = SparseStorage(sparse_sizes=(int(M), int(N)), is_sorted=True,
                            trust_data=True, **fields)
    return SparseTensor.from_storage(storage)
