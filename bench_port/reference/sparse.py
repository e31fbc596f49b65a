"""Plain PyTorch sparse products for the reference.

Nothing here imports the program: the adjacency is rebuilt from the raw
COO arrays that the benchmark generated (``graphs.py``), its CSR and its
CSC order (sorts by row and by column) included. ``A @ h`` and ``A^T @ g``
are ``torch.sparse.mm`` over those (cuSPARSE on the card); the value
gradient ``g[row[e]] . h[col[e]]`` is a gather and a dot over blocks of
edges, so an (edges, K) temporary never exceeds ``block_bytes``. Sums run
in the dtype of the operands (float64 for the reference, float32 for the
control). Duplicate entries stay apart: each gets its own value gradient.
"""
from typing import NamedTuple

import torch

BLOCK_BYTES = 1 << 31      # 2 GiB of gathered rows a block


class Adjacency(NamedTuple):
    row: torch.Tensor      # (nnz,) int64, sorted
    col: torch.Tensor      # (nnz,) int64
    value: torch.Tensor    # (nnz,) in the reference's dtype
    num_nodes: int
    csr: torch.Tensor      # A, sparse CSR
    csc: torch.Tensor      # A^T, sparse CSR (A's CSC order)
    block_bytes: int = BLOCK_BYTES

    def spmm(self, h: torch.Tensor) -> torch.Tensor:
        """``out[r] = sum_e value[e] h[col[e]]`` over the entries of row r."""
        return torch.sparse.mm(self.csr, h)

    def spmm_t(self, g: torch.Tensor) -> torch.Tensor:
        """``A^T @ g``: ``out[c] = sum_e value[e] g[row[e]]``."""
        return torch.sparse.mm(self.csc, g)

    def sddmm(self, g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """``d[e] = g[row[e]] . h[col[e]]``: the value gradient of
        ``spmm(h)`` at output gradient ``g``."""
        out = torch.empty(self.row.numel(), dtype=g.dtype, device=g.device)
        step = max(1, self.block_bytes
                   // max(1, g.shape[1] * g.element_size()))
        for a in range(0, self.row.numel(), step):
            b = slice(a, a + step)
            out[b] = (g.index_select(0, self.row[b])
                      * h.index_select(0, self.col[b])).sum(1)
        return out

    def degree(self) -> torch.Tensor:
        """Entries per row, in the values' dtype."""
        return torch.bincount(self.row, minlength=self.num_nodes).to(
            self.value.dtype)


def _csr(row, col, value, n):
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    ptr[1:] = torch.bincount(row, minlength=n).cumsum(0)
    return torch.sparse_csr_tensor(ptr, col, value, (n, n),
                                   check_invariants=False)


def adjacency(row, col, value, num_nodes: int, dtype: torch.dtype,
              normalize: bool, block_bytes: int = BLOCK_BYTES) -> Adjacency:
    """The reference's adjacency from the raw arrays (rows sorted).
    ``normalize``: GCN's ``D^-1/2 A D^-1/2`` with ``D`` the row's entry
    count, used for the row and the column scale (the port's and the JAX
    package's ``gcn_normalize``), 0 where a degree is 0."""
    row, col = row.long(), col.long()
    value = value.to(dtype)
    if normalize:
        deg = torch.bincount(row, minlength=num_nodes).to(dtype)
        inv = torch.where(deg > 0, deg.clamp(min=1).rsqrt(),
                          torch.zeros((), dtype=dtype, device=deg.device))
        value = value * inv[row] * inv[col.clamp(max=num_nodes - 1)]
    # both orders sorted by (major, minor), as cuSPARSE's CSR expects
    by_row = torch.argsort(row * num_nodes + col)
    by_col = torch.argsort(col * num_nodes + row)
    return Adjacency(row, col, value, num_nodes,
                     _csr(row[by_row], col[by_row], value[by_row],
                          num_nodes),
                     _csr(col[by_col], row[by_col], value[by_col],
                          num_nodes),
                     block_bytes)


def cross_entropy(z: torch.Tensor, y: torch.Tensor):
    """Mean negative log-likelihood of ``log_softmax(z)`` at ``y`` and its
    gradient in ``z``."""
    logp = torch.log_softmax(z, dim=1)
    loss = -logp.gather(1, y[:, None]).mean()
    dz = logp.exp()
    dz[torch.arange(z.shape[0], device=z.device), y] -= 1.0
    return loss, dz / z.shape[0]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10-bit mantissa, to nearest with
    ties away from zero, as the tensor cores convert their inputs."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul_for(control: bool):
    """The reference's GEMM: plain ``a @ b`` (TF32 off), or for the
    control ``a @ b`` in TF32: on the card the tensor cores' own TF32
    (``allow_tf32``), on the CPU its inputs rounded as TF32 rounds them."""
    if not control:
        return torch.matmul

    def mm(a, b):
        if a.is_cuda:
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                return a @ b
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
        return tf32_round(a) @ tf32_round(b)
    return mm
