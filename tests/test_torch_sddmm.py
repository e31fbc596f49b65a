"""Port parity: the SDDMM of paddle_sparse_tpu_torch on the CPU (the plain
version of the CUDA kernel) against the JAX Pallas ``mul_rowsum_call`` in
interpret mode and the JAX ``sddmm_dot_chunked``, on the same numpy inputs.

Tolerances: f32 ``rtol=atol=1e-5`` (K-term f32 dots summed in another order;
K <= 128 here). bf16 inputs are widened to f32 exactly on both sides, so the
same tolerance holds; a bf16 output adds bf16 rounding (``rtol=atol=1e-2``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops.kernels.spmm_pallas import (mul_rowsum_call,
                                                       sddmm_dot_chunked)
from paddle_sparse_tpu_torch import PaddedCOO
from paddle_sparse_tpu_torch.ops.kernels import spmm_cuda
from paddle_sparse_tpu_torch.ops.kernels.sddmm_cuda import (
    sddmm_csr_cuda, sddmm_csr_reference)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16_OUT = dict(rtol=1e-2, atol=1e-2)
M, N = 300, 200
EMPTY_ROWS = (0, 7, 150, 299)   # the last row too


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _identity(L):
    return (torch.arange(L + 1, dtype=torch.int32),
            torch.arange(L, dtype=torch.int32))


def _graph(nnz=3000, seed=7):
    """Row-sorted COO with EMPTY_ROWS holding no entries, and its CSR."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(M), EMPTY_ROWS)
    row = np.sort(rng.choice(keep, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    return row, col, rowptr, rng


@pytest.mark.parametrize("K", [1, 47, 128])
def test_identity_structure_is_mul_rowsum(K):
    """rowptr = arange(L+1), col = arange(L): the SDDMM is the Pallas
    ``mul_rowsum_call(a, b)``."""
    rng = np.random.default_rng(K)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((M, K)).astype(np.float32)
    want = np.asarray(mul_rowsum_call(jnp.asarray(a), jnp.asarray(b),
                                      chunk=128, interpret=True))
    rowptr, col = _identity(M)
    out = sddmm_csr_reference(rowptr, col, _t(a), _t(b))
    assert out.dtype == torch.float32 and out.shape == (M,)
    np.testing.assert_allclose(out.numpy(), want, **F32)
    np.testing.assert_allclose(out.numpy(), (a.astype(np.float64) * b).sum(1),
                               **F32)


def test_identity_bf16_vs_mul_rowsum():
    """bf16 streams: both sides widen to f32 and sum in f32."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((M, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((M, 64)).astype(np.float32))
    a16, b16 = a.bfloat16(), b.bfloat16()
    want = np.asarray(mul_rowsum_call(
        jnp.asarray(a16.float().numpy(), jnp.bfloat16),
        jnp.asarray(b16.float().numpy(), jnp.bfloat16), chunk=128,
        interpret=True))
    rowptr, col = _identity(M)
    out = sddmm_csr_reference(rowptr, col, a16, b16)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, **F32)


@pytest.mark.parametrize("K", [1, 16, 100])
@pytest.mark.parametrize("pad", [0, 250])
def test_graph_vs_sddmm_dot_chunked(K, pad):
    """A random graph with empty rows, as a PaddedCOO with ``pad`` padding
    entries: real edges match JAX's per-edge dot, padding reads back 0."""
    row, col, rowptr, rng = _graph()
    g = rng.standard_normal((M, K)).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    want = np.asarray(sddmm_dot_chunked(jnp.asarray(row), jnp.asarray(col),
                                        jnp.asarray(g), jnp.asarray(x),
                                        target_bytes=64 * 1024))
    adj = PaddedCOO.from_arrays(row, col, None, (M, N),
                                capacity=row.size + pad)
    out = sddmm_csr_cuda(adj.rowptr(), adj.col, _t(g), _t(x))   # CPU: plain
    assert out.shape == (row.size + pad,) and out.dtype == torch.float32
    np.testing.assert_allclose(out[:row.size].numpy(), want, **F32)
    assert not out[row.size:].any()
    ref = sddmm_csr_reference(_t(rowptr), _t(col), _t(g), _t(x))
    np.testing.assert_array_equal(ref.numpy(), out[:row.size].numpy())


@pytest.mark.parametrize("gdt,xdt,odt", [
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.float64, torch.float32, torch.float64),
])
def test_dtype_contract(gdt, xdt, odt):
    """Sums in f32 (f64 when an input is f64), written in ``out_dtype``;
    against JAX ``sddmm_dot_chunked`` on the same (rounded) inputs."""
    row, col, rowptr, rng = _graph(nnz=800)
    g = torch.from_numpy(rng.standard_normal((M, 24))).to(gdt)
    x = torch.from_numpy(rng.standard_normal((N, 24))).to(xdt)
    out = sddmm_csr_reference(_t(rowptr), _t(col), g, x, out_dtype=odt)
    assert out.dtype == odt
    want = np.asarray(sddmm_dot_chunked(
        jnp.asarray(row), jnp.asarray(col), jnp.asarray(g.double().numpy()),
        jnp.asarray(x.double().numpy())))
    tol = BF16_OUT if odt == torch.bfloat16 else F32
    np.testing.assert_allclose(out.double().numpy(), want, **tol)


def test_reference_windows(monkeypatch):
    """Bounded edge windows (here ~50 edges each) give the one-window
    result."""
    _, col, rowptr, rng = _graph()
    g = _t(rng.standard_normal((M, 10)).astype(np.float32))
    x = _t(rng.standard_normal((N, 10)).astype(np.float32))
    whole = sddmm_csr_reference(_t(rowptr), _t(col), g, x)
    monkeypatch.setattr(spmm_cuda, "_WINDOW_BYTES", 50 * 2 * 10 * 4)
    windowed = sddmm_csr_reference(_t(rowptr), _t(col), g, x)
    np.testing.assert_array_equal(windowed.numpy(), whole.numpy())


def test_wrapper_on_cpu_runs_plain_without_launch():
    _, col, rowptr, rng = _graph(nnz=500)
    g = _t(rng.standard_normal((M, 8)).astype(np.float32))
    x = _t(rng.standard_normal((N, 8)).astype(np.float32))
    before = sddmm_csr_cuda.launches
    out = sddmm_csr_cuda(_t(rowptr), _t(col), g, x)
    assert sddmm_csr_cuda.launches == before
    np.testing.assert_array_equal(
        out.numpy(), sddmm_csr_reference(_t(rowptr), _t(col), g, x).numpy())


def test_empty():
    rowptr = torch.zeros(5, dtype=torch.int32)
    out = sddmm_csr_reference(rowptr, torch.zeros(3, dtype=torch.int32),
                              torch.ones(4, 2), torch.ones(3, 2))
    assert out.shape == (3,) and not out.any()


def test_wrapper_rejects_other_devices():
    x = torch.ones(4, 4, device="meta")
    rowptr = torch.zeros(3, dtype=torch.int32, device="meta")
    col = torch.zeros(0, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sddmm_csr_cuda(rowptr, col, torch.ones(2, 4, device="meta"), x)
