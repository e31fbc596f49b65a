"""The CUDA kernel of paddle_sparse_tpu_torch against its plain version, on
the card. Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (sums in another order); bf16
output ``rtol=atol=2e-2`` (output rounded to bf16). TF32 stays off, so the
GCN's ``h @ w`` is full f32 on the card."""
import dataclasses

import pytest
import torch

from paddle_sparse_tpu_torch import (PaddedCOO, entry, spmm_csr_cuda,
                                     spmm_csr_reference)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _csr(dev, M=500, N=300, max_deg=30, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    deg = torch.randint(0, max_deg + 1, (M,), generator=g, device=dev)
    deg[[0, M - 1]] = 0
    rowptr = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    nnz = int(rowptr[-1])
    col = torch.randint(0, N, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    value = torch.rand(nnz, generator=g, device=dev) * 2 - 1
    return rowptr, col, value, g


def _ref(rowptr, col, value, x):
    return spmm_csr_reference(rowptr, col,
                              None if value is None else value.double(),
                              x.double())


@pytest.mark.parametrize("K", [1, 8, 47, 100, 256, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_value", [True, False])
def test_kernel_vs_plain(dev, K, dtype, with_value):
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, K, generator=g, device=dev).to(dtype)
    v = value.to(dtype) if with_value else None
    out = spmm_csr_cuda(rowptr, col, v, x)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (500, K)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(out.double(), _ref(rowptr, col, v, x), **tol)


def test_int64_indices_and_unaligned_x(dev):
    rowptr, col, value, g = _csr(dev)
    base = torch.randn(300 * 64 + 1, generator=g, device=dev)
    x = base[1:].view(300, 64)          # 4-byte offset: scalar loads
    out = spmm_csr_cuda(rowptr.long(), col.long(), value, x)
    torch.testing.assert_close(out.double(), _ref(rowptr, col, value, x),
                               **F32)


def test_launch_counter(dev):
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, 16, generator=g, device=dev)
    before = spmm_csr_cuda.launches
    spmm_csr_cuda(rowptr, col, value, x)
    spmm_csr_reference(rowptr, col, value, x)
    assert spmm_csr_cuda.launches == before + 1


def test_padding_never_read(dev):
    rowptr, col, value, g = _csr(dev)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(row, col, value, (500, 300),
                                capacity=col.numel() + 77)
    poisoned = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    x = torch.randn(300, 32, generator=g, device=dev)
    with torch.inference_mode():
        out = poisoned.spmm(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.double(), _ref(rowptr, col, value, x),
                               **F32)


@pytest.mark.parametrize("bad", ["f64", "f16", "noncontig", "device", "3d"])
def test_kernel_rejects(dev, bad):
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, 8, generator=g, device=dev)
    if bad == "f64":
        x = x.double()
    elif bad == "f16":
        x = x.half()
    elif bad == "noncontig":
        x = torch.randn(8, 300, generator=g, device=dev).t()
    elif bad == "device":
        value = value.cpu()
    else:
        x = x.view(300, 2, 4)
    with pytest.raises((TypeError, ValueError)):
        spmm_csr_cuda(rowptr, col, value, x)


def test_toy_gcn_card_vs_cpu(dev):
    model_c, adj_c, x_c = entry("cuda")
    model_h, adj_h, x_h = entry("cpu")
    with torch.inference_mode():
        torch.testing.assert_close(model_c(adj_c, x_c).cpu(),
                                   model_h(adj_h, x_h), **F32)
