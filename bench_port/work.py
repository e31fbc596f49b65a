"""The work of a step, counted from shapes: what the equations need,
whatever implements them.

A sparse op is ``(kind, K)`` over an ``n``-node graph of ``nnz`` entries,
every index int32 and every value and feature of ``itemsize`` bytes:

* ``spmm``: ``out = A @ x`` over the CSR (pointer, cols, values, ``x``
  read once, ``out`` written once);
* ``spmm_t``: ``d x = A^T @ g`` alone, over the CSC view (the same bytes);
* ``sddmm``: ``d value[e] = g[row[e]] . x[col[e]]`` alone (pointer, cols,
  ``g`` and ``x`` read, ``d value`` written);
* ``spmm_sddmm``: both grads in one pass over the CSC view (pointer, rows,
  values, ``g`` and ``x`` read, ``d x`` and ``d value`` written).

Operations: 2 per entry and column for each product (``spmm_sddmm`` has
two). A roofline's least time is the larger of bytes over the card's HBM
rate and operations over its float32 rate (``peaks.py``).
"""
from typing import Iterable, Tuple

INDEX_BYTES = 4


def sparse_bytes(kind: str, K: int, n: int, nnz: int, itemsize: int) -> int:
    ptr = (n + 1) * INDEX_BYTES
    dense = n * K * itemsize
    if kind in ("spmm", "spmm_t"):
        return ptr + nnz * (INDEX_BYTES + itemsize) + 2 * dense
    if kind == "sddmm":
        return ptr + nnz * (INDEX_BYTES + itemsize) + 2 * dense
    if kind == "spmm_sddmm":
        return ptr + nnz * (INDEX_BYTES + 2 * itemsize) + 3 * dense
    raise ValueError(f"unknown sparse op {kind!r}")


def sparse_flops(kind: str, K: int, nnz: int) -> int:
    if kind not in ("spmm", "spmm_t", "sddmm", "spmm_sddmm"):
        raise ValueError(f"unknown sparse op {kind!r}")
    return (4 if kind == "spmm_sddmm" else 2) * nnz * K


def least_seconds(nbytes: float, flops: float, peak: dict) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["flops_per_s"])


def sparse_least_seconds(ops: Iterable[Tuple[str, int]], n: int, nnz: int,
                         itemsize: int, peak: dict) -> float:
    return sum(least_seconds(sparse_bytes(k, K, n, nnz, itemsize),
                             sparse_flops(k, K, nnz), peak) for k, K in ops)


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n
