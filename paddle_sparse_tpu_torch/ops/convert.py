"""Index-format conversions: COO row indices <-> CSR row pointers, and the
inverse of a permutation.

Port of ``paddle_sparse_tpu/ops/convert.py``. Both directions are one
``torch.searchsorted``:

* ``ind2ptr(row, M)``: for sorted ``row``, ``ptr[i] = #{k : row[k] < i}``.
* ``ptr2ind(ptr, E)``: ``ind[e] = max{i < len(ptr) - 1 : ptr[i] <= e}``.

``invert_perm(perm)`` is one scatter: ``inv[perm[i]] = i``.

Outputs keep the input's integer dtype and device. Empty inputs are allowed.
"""
import torch


def ind2ptr(row: torch.Tensor, M: int) -> torch.Tensor:
    """Sorted COO row indices -> CSR row pointer of length ``M + 1``."""
    positions = torch.arange(M + 1, dtype=row.dtype, device=row.device)
    return torch.searchsorted(row, positions,
                              out_int32=row.dtype == torch.int32
                              ).to(row.dtype)


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of the permutation ``perm`` (``inv[perm[i]] = i``), in
    ``perm``'s dtype and on its device: one scatter. For the CSC view's
    ``perm`` it maps each COO entry to its CSC position."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.numel(), dtype=perm.dtype,
                                    device=perm.device)
    return inv


def _expand_ptr(ptr: torch.Tensor, E: int) -> torch.Tensor:
    """``out[t] = max{i < n : ptr[i] <= t}`` for ``t < E``, ``n = len(ptr)-1``.

    Needs ``ptr[0] == 0``. Empty segments resolve to the last of the
    segments sharing a start, as ``searchsorted(side="right") - 1`` does."""
    n = ptr.numel() - 1
    if E == 0 or n <= 0:
        return torch.zeros(E, dtype=ptr.dtype, device=ptr.device)
    positions = torch.arange(E, dtype=ptr.dtype, device=ptr.device)
    ind = torch.searchsorted(ptr, positions, right=True) - 1
    # positions at or past ptr[-1] belong to no segment: the last segment
    # whose start is <= them, i.e. at most n - 1
    return ind.clamp_(0, n - 1).to(ptr.dtype)


def ptr2ind(ptr: torch.Tensor, E: int) -> torch.Tensor:
    """CSR row pointer -> COO row indices of length ``E`` (= ``ptr[-1]``).

    A non-canonical pointer (``ptr[0] != 0``) is rebased first."""
    return _expand_ptr(ptr - ptr[:1], E)


def ptr2ind_capped(ptr: torch.Tensor, capacity: int) -> torch.Tensor:
    """Like :func:`ptr2ind` for padded buffers of length ``capacity``:
    positions at or past ``ptr[-1]`` map to ``M = len(ptr) - 1``, the padding
    row that sorts last."""
    ptr = ptr - ptr[:1]
    positions = torch.arange(capacity, dtype=ptr.dtype, device=ptr.device)
    ind = _expand_ptr(ptr, capacity)
    M = ptr.numel() - 1
    return torch.where(positions < ptr[-1], ind,
                       torch.full_like(ind, M)).to(ptr.dtype)
