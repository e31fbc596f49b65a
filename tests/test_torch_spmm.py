"""Port parity: the SpMM of paddle_sparse_tpu_torch on the CPU (the plain
version of the CUDA kernel) against the JAX Pallas kernel in interpret mode
and the JAX ``spmm_coo``, on the same numpy inputs.

Tolerances: f32 ``rtol=atol=1e-4`` (the Pallas kernel's hi/lo bf16 split is
about f32-accurate); bf16 output ``6e-2`` (bf16 rounding of products and
output, rows of ~13 products), as in ``test_pallas_kernel.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops.kernels.spmm_pallas import spmm_pallas
from paddle_sparse_tpu.ops.spmm import spmm_coo as jspmm_coo
from paddle_sparse_tpu_torch.ops.kernels import spmm_cuda
from paddle_sparse_tpu_torch.ops.kernels.spmm_cuda import (spmm_csr_cuda,
                                                           spmm_csr_reference)
from paddle_sparse_tpu_torch.ops.spmm import spmm_coo, spmm_csr

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)
EMPTY_ROWS = (0, 7, 150, 299)   # the last row too


def _graph(M=300, N=200, nnz=4000, seed=5):
    """Row-sorted COO with EMPTY_ROWS holding no entries, its CSR pointer,
    edge values and the seeded generator."""
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(M), EMPTY_ROWS)
    row = np.sort(rng.choice(keep, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    row, col = row[order].astype(np.int32), col[order].astype(np.int32)
    rowptr = np.searchsorted(row, np.arange(M + 1)).astype(np.int32)
    val = rng.standard_normal(nnz).astype(np.float32)
    return row, col, rowptr, val, rng


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("K", [8, 64, 128])
@pytest.mark.parametrize("with_value", [True, False])
def test_spmm_f32_vs_pallas_and_jax(K, with_value):
    row, col, rowptr, val, rng = _graph()
    x = rng.standard_normal((200, K)).astype(np.float32)
    v = val if with_value else None
    pallas = np.asarray(spmm_pallas(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v is None else jnp.asarray(v), jnp.asarray(x),
        interpret=True))
    jcoo = np.asarray(jspmm_coo(jnp.asarray(row), jnp.asarray(col),
                                None if v is None else jnp.asarray(v),
                                jnp.asarray(x), 300))
    tv = None if v is None else _t(v)
    ref = spmm_csr_reference(_t(rowptr), _t(col), tv, _t(x))
    with torch.no_grad():
        coo = spmm_coo(_t(row), _t(col), tv, _t(x), 300)
    wrapped = spmm_csr_cuda(_t(rowptr), _t(col), tv, _t(x))  # CPU: plain
    for out in (ref, coo, wrapped):
        assert out.dtype == torch.float32 and out.shape == (300, K)
        np.testing.assert_allclose(out.numpy(), pallas, **F32)
        np.testing.assert_allclose(out.numpy(), jcoo, **F32)
        assert not out[list(EMPTY_ROWS)].any()


@pytest.mark.parametrize("with_value", [True, False])
def test_spmm_bf16_vs_pallas(with_value):
    row, col, rowptr, val, rng = _graph()
    x = rng.standard_normal((200, 128)).astype(np.float32)
    x16 = torch.from_numpy(x).bfloat16()
    v16 = torch.from_numpy(val).bfloat16() if with_value else None
    pallas = spmm_pallas(
        jnp.asarray(rowptr), jnp.asarray(col),
        None if v16 is None else jnp.asarray(v16.float().numpy(),
                                             jnp.bfloat16),
        jnp.asarray(x16.float().numpy(), jnp.bfloat16), interpret=True)
    assert pallas.dtype == jnp.bfloat16
    out = spmm_csr_reference(_t(rowptr), _t(col), v16, x16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.double().numpy(),
                               np.asarray(pallas, np.float64), **BF16)


@pytest.mark.parametrize("vdt,xdt,odt", [
    (torch.float32, torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (None, torch.bfloat16, torch.bfloat16),
    (torch.float64, torch.float32, torch.float64),
])
def test_spmm_dtype_contract(vdt, xdt, odt):
    """Output dtype is the promoted dtype of value and x, as in JAX."""
    row, col, rowptr, val, rng = _graph(nnz=500)
    x = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    v = None if vdt is None else _t(val).to(vdt)
    out = spmm_csr_reference(_t(rowptr), _t(col), v, x.to(xdt))
    assert out.dtype == odt
    jout = jspmm_coo(jnp.asarray(row), jnp.asarray(col),
                     None if v is None else jnp.asarray(v.double().numpy(),
                                                        str(vdt)[6:]),
                     jnp.asarray(x.to(xdt).double().numpy(), str(xdt)[6:]),
                     300)
    assert str(jout.dtype) == str(odt)[6:]
    tol = BF16 if odt == torch.bfloat16 else F32
    np.testing.assert_allclose(out.double().numpy(),
                               np.asarray(jout, np.float64), **tol)


def test_spmm_coo_drops_padding_rows():
    """Entries with row == num_rows (padding) are left out, as the JAX
    segment-sum over num_rows segments drops them."""
    row, col, _, val, rng = _graph(nnz=1000)
    pad = 50
    row_p = np.concatenate([row, np.full(pad, 300, np.int32)])
    col_p = np.concatenate([col, np.zeros(pad, np.int32)])
    val_p = np.concatenate([val, np.ones(pad, np.float32)])
    x = rng.standard_normal((200, 24)).astype(np.float32)
    with torch.no_grad():
        out = spmm_coo(_t(row_p), _t(col_p), _t(val_p), _t(x), 300)
    jout = jspmm_coo(jnp.asarray(row_p), jnp.asarray(col_p),
                     jnp.asarray(val_p), jnp.asarray(x), 300)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)


def test_spmm_coo_trailing_dims():
    row, col, _, val, rng = _graph(nnz=800)
    x = rng.standard_normal((200, 3, 5)).astype(np.float32)
    with torch.no_grad():
        out = spmm_coo(_t(row), _t(col), _t(val), _t(x), 300)
    jout = jspmm_coo(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val),
                     jnp.asarray(x), 300)
    assert out.shape == (300, 3, 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)


def test_reference_windows(monkeypatch):
    """The plain version's bounded edge windows (here ~100 edges each) give
    the one-window result."""
    _, col, rowptr, val, rng = _graph()
    x = _t(rng.standard_normal((200, 10)).astype(np.float32))
    whole = spmm_csr_reference(_t(rowptr), _t(col), _t(val), x)
    monkeypatch.setattr(spmm_cuda, "_WINDOW_BYTES", 100 * 10 * 4)
    windowed = spmm_csr_reference(_t(rowptr), _t(col), _t(val), x)
    np.testing.assert_allclose(windowed.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_empty_matrix():
    rowptr = torch.zeros(5, dtype=torch.int32)
    col = torch.zeros(0, dtype=torch.int32)
    x = torch.ones(3, 4)
    out = spmm_csr_reference(rowptr, col, None, x)
    assert out.shape == (4, 4) and not out.any()


@pytest.mark.parametrize("reduce", ["mean", "min", "max"])
def test_other_reductions_not_ported(reduce):
    _, col, rowptr, val, _ = _graph(nnz=100)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmm_csr(_t(rowptr), _t(col), _t(val), torch.ones(200, 4), reduce)


def test_unknown_reduction():
    _, col, rowptr, val, _ = _graph(nnz=100)
    with pytest.raises(ValueError, match="unknown reduction"):
        spmm_csr(_t(rowptr), _t(col), _t(val), torch.ones(200, 4), "prod")


def test_wrapper_rejects_other_devices():
    """The kernel wrapper takes the plain path only for CPU tensors."""
    x = torch.ones(4, 4, device="meta")
    rowptr = torch.zeros(3, dtype=torch.int32, device="meta")
    col = torch.zeros(0, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_csr_cuda(rowptr, col, None, x)
