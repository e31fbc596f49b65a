"""The CUDA kernels of paddle_sparse_tpu_torch against their plain versions,
and the SpMM autograd and the toy train step on the card against the CPU.
Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (sums in another order); bf16
output ``rtol=atol=2e-2`` (output rounded to bf16). TF32 stays off, so the
GCN's ``h @ w`` and its backward GEMMs are full f32 on the card."""
import dataclasses

import pytest
import torch

from paddle_sparse_tpu_torch import (PaddedCOO, entry, gcn_loss,
                                     sddmm_csr_cuda, sddmm_csr_reference,
                                     spmm_coo, spmm_csr_cuda,
                                     spmm_csr_reference, train_entry,
                                     train_step)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _sddmm_ref(rowptr, col, g, x):
    return sddmm_csr_reference(rowptr, col, g.double(), x.double(),
                               out_dtype=torch.float64)


@pytest.mark.parametrize("K", [1, 8, 47, 100, 256, 600, 1100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_sddmm_kernel_vs_plain(dev, K, dtype, out_dtype):
    """K past the registers' 32 * V * 4 columns (600 f32, 1100 bf16) reads
    the rest of the g row from memory."""
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, K, generator=g, device=dev).to(dtype)
    x = torch.randn(300, K, generator=g, device=dev).to(dtype)
    out = sddmm_csr_cuda(rowptr, col, gm, x, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert out.dtype == out_dtype and out.shape == col.shape
    tol = F32 if out_dtype == torch.float32 else BF16
    torch.testing.assert_close(out.double(), _sddmm_ref(rowptr, col, gm, x),
                               **tol)


def test_sddmm_identity_is_mul_rowsum(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(3000, 47, generator=g, device=dev)
    b = torch.randn(3000, 47, generator=g, device=dev)
    rowptr = torch.arange(3001, dtype=torch.int32, device=dev)
    col = torch.arange(3000, dtype=torch.int32, device=dev)
    out = sddmm_csr_cuda(rowptr, col, a, b)
    torch.testing.assert_close(out.double(),
                               (a.double() * b.double()).sum(1), **F32)


def test_sddmm_mixed_unaligned_int64(dev):
    """f32 g with bf16 x (summed in f32), int64 indices, an x at a 4-byte
    offset (scalar loads)."""
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, 64, generator=g, device=dev)
    base = torch.randn(300 * 64 + 1, generator=g, device=dev)
    x = base[1:].view(300, 64)
    out = sddmm_csr_cuda(rowptr.long(), col.long(), gm, x)
    torch.testing.assert_close(out.double(), _sddmm_ref(rowptr, col, gm, x),
                               **F32)
    xb = x.bfloat16()
    torch.testing.assert_close(sddmm_csr_cuda(rowptr, col, gm, xb).double(),
                               _sddmm_ref(rowptr, col, gm, xb), **F32)


def test_sddmm_long_row_exact(dev):
    """A row of 1.1M edges: small-integer inputs keep every dot exact."""
    deg = torch.tensor([3, 0, 1_100_000, 5, 0], device=dev)
    rowptr = torch.zeros(6, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    g = torch.Generator(device=dev).manual_seed(4)
    col = torch.randint(0, 300, (int(rowptr[-1]),), generator=g, device=dev,
                        dtype=torch.int32)
    gm = torch.randint(-4, 5, (5, 256), generator=g, device=dev).float()
    x = torch.randint(-4, 5, (300, 256), generator=g, device=dev).float()
    out = sddmm_csr_cuda(rowptr, col, gm, x)
    assert torch.equal(out.double(), _sddmm_ref(rowptr, col, gm, x))


def test_sddmm_pads_zero_and_never_read(dev):
    rowptr, col, value, g = _csr(dev)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(row, col, value, (500, 300),
                                capacity=col.numel() + 77)
    poisoned = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    gm = torch.randn(500, 32, generator=g, device=dev)
    x = torch.randn(300, 32, generator=g, device=dev)
    out = sddmm_csr_cuda(poisoned.rowptr(), poisoned.col, gm, x)
    torch.cuda.synchronize()
    assert not out[col.numel():].any()
    torch.testing.assert_close(out[:col.numel()].double(),
                               _sddmm_ref(rowptr, col, gm, x), **F32)


def test_sddmm_launch_counter(dev):
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, 16, generator=g, device=dev)
    x = torch.randn(300, 16, generator=g, device=dev)
    before = sddmm_csr_cuda.launches
    sddmm_csr_cuda(rowptr, col, gm, x)
    sddmm_csr_reference(rowptr, col, gm, x)
    assert sddmm_csr_cuda.launches == before + 1


@pytest.mark.parametrize("bad", ["f64", "noncontig", "device", "shape",
                                 "out_f16"])
def test_sddmm_rejects(dev, bad):
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, 8, generator=g, device=dev)
    x = torch.randn(300, 8, generator=g, device=dev)
    kw = {}
    if bad == "f64":
        x = x.double()
    elif bad == "noncontig":
        gm = torch.randn(8, 500, generator=g, device=dev).t()
    elif bad == "device":
        gm = gm.cpu()
    elif bad == "shape":
        gm = gm[:, :4].contiguous()
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises((TypeError, ValueError)):
        sddmm_csr_cuda(rowptr, col, gm, x, **kw)


@pytest.mark.parametrize("with_value", [True, False])
def test_spmm_autograd_card_vs_cpu(dev, with_value):
    """Forward, d value and d x (stride-0 upstream grad of a sum, and a
    weighted one) on the card against the CPU's plain path; padding of a
    PaddedCOO with poisoned cols gets zero grad."""
    rowptr, col, value, g = _csr(dev)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(row, col, value if with_value else None,
                                (500, 300), capacity=col.numel() + 50)
    adj = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    x = torch.randn(300, 64, generator=g, device=dev)
    w = torch.randn(500, 64, generator=g, device=dev)
    grads = {}
    for where in ("cuda", "cpu"):
        a = adj.to(where)
        v = None if a.value is None else a.value.clone().requires_grad_()
        a = dataclasses.replace(a, value=v)
        xt = x.to(where).detach().requires_grad_()
        out = a.spmm(xt)
        (out.sum() + (out * w.to(where)).sum()).backward()
        grads[where] = [t.cpu() for t in (out.detach(), xt.grad)
                        + (() if v is None else (v.grad,))]
    for c, h in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(c, h, **F32)
    if with_value:
        assert not grads["cuda"][2][col.numel():].any()


def test_spmm_autograd_launches(dev):
    """One forward + backward with both grads: K1 twice (forward, d x over
    the CSC view), the SDDMM once; d x alone skips the SDDMM."""
    rowptr, col, value, g = _csr(dev)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    x = torch.randn(300, 16, generator=g, device=dev, requires_grad=True)
    for v, want_sddmm in ((value.clone().requires_grad_(), 1), (value, 0)):
        k1, k2 = spmm_csr_cuda.launches, sddmm_csr_cuda.launches
        spmm_coo(row, col, v, x, 500).sum().backward()
        assert spmm_csr_cuda.launches - k1 == 2
        assert sddmm_csr_cuda.launches - k2 == want_sddmm


def test_toy_train_step_card_vs_cpu(dev):
    """Loss, every grad and d value of the toy GCN, then 20 SGD steps, on
    the card against the CPU; the loss decreases."""
    runs = {}
    for where in ("cuda", "cpu"):
        model, adj, x, y = train_entry(where)
        adj.value.requires_grad_()
        loss0 = gcn_loss(model, adj, x, y)
        loss0.backward()
        # copies: .cpu() of a CPU tensor is the tensor itself, and the
        # SGD steps below accumulate into adj.value.grad in place
        grads = [p.grad.cpu().clone() for p in model.parameters()]
        grads.append(adj.value.grad.cpu().clone())
        losses = [float(train_step(model, adj, x, y, 0.1)) for _ in range(20)]
        runs[where] = (float(loss0.detach()), grads, losses)
    (lc, gc, sc), (lh, gh, sh) = runs["cuda"], runs["cpu"]
    assert abs(lc - lh) < 1e-5
    for a, b in zip(gc, gh):
        torch.testing.assert_close(a, b, **F32)
    torch.testing.assert_close(torch.tensor(sc), torch.tensor(sh), **F32)
    assert sc[-1] < sc[0]
