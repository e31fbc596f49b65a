"""The CUDA kernels of paddle_sparse_tpu_torch against their plain versions,
and the SpMM autograd, the toy train step, SpGEMM and the packed-layout SpMMs
(seg2, seg3, split) on the card against the CPU; the span kernels' long-row
split (pieces of a ``RowSplit`` table and the fold pass) against the plain
versions, bit for bit from launch to launch.
Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (sums in another order); bf16
output ``rtol=atol=2e-2`` (output rounded to bf16); run compaction with
f64 values against the plain version in f64 ``rtol=atol=1e-12`` (the plain
version's ``index_add`` sums in another order). TF32 stays off, so the
GCN's ``h @ w`` and its backward GEMMs are full f32 on the card."""
import dataclasses

import pytest
import torch

from paddle_sparse_tpu_torch import (CAP, SPMM_BACKENDS, PaddedCOO,
                                     band_reduce_call, compact_runs_cuda,
                                     compact_runs_reference, entry,
                                     fold_pieces_cuda, gcn_loss,
                                     make_seg2_plan, pack_values,
                                     plan_spgemm, plan_spgemm_blocked,
                                     plan_spgemm_rows, sddmm_csr_cuda,
                                     sddmm_csr_reference, sddmm_spans_cuda,
                                     sddmm_spans_reference, spgemm_entry,
                                     spmm_coo, spmm_csr_cuda,
                                     spmm_csr_reference, spmm_entry,
                                     spmm_seg2, spmm_seg3, spmm_spans_cuda,
                                     spmm_spans_reference, spmm_split,
                                     split_rows, spspmm_padded,
                                     spspmm_rowblocked,
                                     spspmm_rowsorted, tilespan_call,
                                     train_entry, train_step)

pytestmark = pytest.mark.cuda

F32 = dict(rtol=1e-5, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
# a sum of thousands of f32 terms (a long row or column), against f64 or a
# sum in another order: within this share of the sum of |terms| of its entry
SUM_REL = 1e-5


def _close_to_sum(got, ref, scale, out_rel=0.0):
    """``|got - ref| <= SUM_REL * scale + out_rel * |ref|`` elementwise
    (``scale``: the sum of |terms| of each entry, from the same function on
    |inputs|; ``out_rel``: the rounding of a narrower output)."""
    ref = ref.double()
    bound = SUM_REL * scale.double() + out_rel * ref.abs() + 1e-30
    err = (got.double() - ref).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


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


# ---- run compaction (K5) and SpGEMM ---------------------------------------

def _sorted_grid(dev, R, F, N, seed=0, dtype=torch.float64):
    """An (R, F) grid, each row's columns sorted with pads (N) last, random
    row fill (empty and full rows included), and values of ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fill = torch.randint(0, F + 1, (R,), generator=g, device=dev)
    fill[0], fill[-1] = 0, F
    key = torch.randint(0, N, (R, F), generator=g, device=dev,
                        dtype=torch.int32)
    key = torch.where(torch.arange(F, device=dev) < fill[:, None], key, N)
    key = key.sort(dim=1).values
    val = torch.randn(R, F, generator=g, device=dev, dtype=torch.float64)
    val = torch.where(key < N, val, 0.0).to(dtype)
    return key.contiguous(), val.contiguous()


def _flat_sorted(dev, M, N, L, pads, seed=0):
    """A flat stream sorted by (row, col) with ``pads`` trailing pads."""
    g = torch.Generator(device=dev).manual_seed(seed)
    row = torch.randint(0, M, (L,), generator=g, device=dev)
    col = torch.randint(0, N, (L,), generator=g, device=dev)
    key = (row * (N + 1) + col).sort().values
    key = torch.cat([key, torch.full((pads,), M * (N + 1) + N, device=dev)])
    val = torch.randn(L + pads, generator=g, device=dev, dtype=torch.float64)
    val[L:] = 0
    return ((key % (N + 1)).int(), (key // (N + 1)).int(), val)


def _same_compact(got, ref, val_tol):
    assert int(got.count) == int(ref.count)
    assert torch.equal(got.row, ref.row) and torch.equal(got.col, ref.col)
    if ref.value is None:
        assert got.value is None
    else:
        torch.testing.assert_close(got.value.double(), ref.value.double(),
                                   **val_tol)
    if ref.seg is not None:
        assert torch.equal(got.seg, ref.seg)


F64_SUMS = dict(rtol=1e-12, atol=1e-12)   # f64 sums in another order


@pytest.mark.parametrize("R,F,N", [(7, 16, 12), (5, 32, 6), (1, 8, 4),
                                   (3000, 64, 500), (20000, 256, 100000),
                                   (64, 1, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segcompact_grid_vs_plain(dev, R, F, N, dtype):
    """K5 on per-row-sorted grids against the plain version in f64: tiles
    of 2048 cut through runs and rows; f32 values summed in f32."""
    key, val = _sorted_grid(dev, R, F, N, seed=R + F, dtype=dtype)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    cap = int((key < N).sum()) + 5
    got = compact_runs_cuda(key, rows, val, (R, N), cap, seg=True)
    ref = compact_runs_reference(key, rows, val.double(), (R, N), cap,
                                 seg=True)
    torch.cuda.synchronize()
    tol = F64_SUMS if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-5)
    _same_compact(got, ref, tol)
    assert got.value.dtype == dtype


@pytest.mark.parametrize("with_value", [True, False])
def test_segcompact_flat_vs_plain(dev, with_value):
    col, row, val = _flat_sorted(dev, 3000, 400, 200_000, 3001, seed=2)
    val = val if with_value else None
    cap = 200_100
    got = compact_runs_cuda(col, row, val, (3000, 400), cap, seg=True)
    ref = compact_runs_reference(col, row, val, (3000, 400), cap, seg=True)
    _same_compact(got, ref, F64_SUMS)


@pytest.mark.parametrize("run", [100_000, 1_100_000])
def test_segcompact_long_runs_exact(dev, run):
    """One run across many tiles (and one of over 1M elements, walked by one
    thread) between short ones; small integers keep f32 sums exact."""
    parts = [torch.tensor([0, 0, 1], dtype=torch.int32, device=dev),
             torch.full((run,), 2, dtype=torch.int32, device=dev),
             torch.tensor([3, 3, 5], dtype=torch.int32, device=dev)]
    col = torch.cat(parts)
    row = torch.zeros_like(col)
    g = torch.Generator(device=dev).manual_seed(7)
    val = torch.randint(-3, 4, (col.numel(),), generator=g,
                        device=dev).float()
    got = compact_runs_cuda(col, row, val, (1, 6), 8, seg=True)
    ref = compact_runs_reference(col, row, val.double(), (1, 6), 8, seg=True)
    _same_compact(got, ref, dict(rtol=0, atol=0))
    assert int(got.count) == 5


@pytest.mark.parametrize("cut", [1, 1000, 50_000])
def test_segcompact_truncation(dev, cut):
    key, val = _sorted_grid(dev, 3000, 64, 500, seed=3)
    rows = torch.arange(3000, dtype=torch.int32, device=dev)
    count = int(compact_runs_reference(key, rows, None, (3000, 500),
                                       0).count)
    cap = count - cut
    got = compact_runs_cuda(key, rows, val, (3000, 500), cap, seg=True)
    ref = compact_runs_reference(key, rows, val, (3000, 500), cap, seg=True)
    _same_compact(got, ref, F64_SUMS)
    assert got.row.numel() == cap and int(got.seg.max()) == cap - 1


def test_segcompact_structure_only_and_row_block(dev):
    """No values; grid rows mapped to ``r0 + arange`` as a row block."""
    key, _ = _sorted_grid(dev, 777, 40, 90, seed=4)
    rows = torch.arange(5000, 5777, dtype=torch.int32, device=dev)
    got = compact_runs_cuda(key, rows, None, (6000, 90), 40_000)
    ref = compact_runs_reference(key, rows, None, (6000, 90), 40_000)
    _same_compact(got, ref, F64_SUMS)


def test_segcompact_launch_counter(dev):
    key, val = _sorted_grid(dev, 50, 16, 20)
    rows = torch.arange(50, dtype=torch.int32, device=dev)
    before = compact_runs_cuda.launches
    compact_runs_cuda(key, rows, val, (50, 20), 900)
    compact_runs_reference(key, rows, val, (50, 20), 900)
    assert compact_runs_cuda.launches == before + 1


@pytest.mark.parametrize("bad", ["int64", "bf16", "noncontig", "device",
                                 "shape", "rows", "3d", "capacity"])
def test_segcompact_rejects(dev, bad):
    key, val = _sorted_grid(dev, 50, 16, 20, dtype=torch.float32)
    rows = torch.arange(50, dtype=torch.int32, device=dev)
    cap = 900
    if bad == "int64":
        key = key.long()
    elif bad == "bf16":
        val = val.bfloat16()
    elif bad == "noncontig":
        key = key.t()
    elif bad == "device":
        val = val.cpu()
    elif bad == "shape":
        val = val[:, :8].contiguous()
    elif bad == "rows":
        rows = rows[:49]
    elif bad == "3d":
        key = key.view(50, 4, 4)
    else:
        cap = 2 ** 31
    with pytest.raises((TypeError, ValueError)):
        compact_runs_cuda(key, rows, val, (50, 20), cap)


def _spgemm_pair(where):
    """Random A (300, 200) and B (200, 250), B with empty rows, coalesced."""
    g = torch.Generator().manual_seed(11)
    mats = []
    for m, k, nnz in ((300, 200, 3000), (200, 250, 2500)):
        row = torch.randint(0, m, (nnz,), generator=g)
        if m == 200:
            row = row - row % 5           # rows not divisible by 5 empty
        col = torch.randint(0, k, (nnz,), generator=g)
        key = (row * k + col).sort().values
        mats.append(PaddedCOO.from_arrays(
            key // k, key % k, torch.randn(nnz, generator=g), (m, k),
            capacity=nnz + 40, device=where).coalesce())
    return mats


def _spgemm_runs(A, B):
    F, oc = plan_spgemm_rows(A, B)
    fc, oc2 = plan_spgemm(A, B)
    blocked = plan_spgemm_blocked(A, B)
    return {"rowsorted": spspmm_rowsorted(A, B, F, oc),
            "padded": spspmm_padded(A, B, fc, oc2),
            "rowblocked": spspmm_rowblocked(A, B, blocked[0], blocked[1], 32,
                                            A.capacity, blocked[4])}


def test_spgemm_card_vs_cpu(dev):
    """Every variant on the card against the CPU: nnz, flag, coordinates
    exact, values F32; each launches K5 (the blocked one once per block);
    sort and coalesce too."""
    (Ac, Bc), (Ah, Bh) = _spgemm_pair("cuda"), _spgemm_pair("cpu")
    assert Ac.nnz == Ah.nnz and torch.equal(Ac.row.cpu(), Ah.row)
    before = compact_runs_cuda.launches
    on_card = _spgemm_runs(Ac, Bc)
    launches = compact_runs_cuda.launches - before
    on_cpu = _spgemm_runs(Ah, Bh)
    for name, res in on_card.items():
        ref = on_cpu[name]
        assert res.matrix.nnz == ref.matrix.nnz > 0
        assert res.overflowed == ref.overflowed is False
        assert torch.equal(res.matrix.row.cpu(), ref.matrix.row)
        assert torch.equal(res.matrix.col.cpu(), ref.matrix.col)
        torch.testing.assert_close(res.matrix.value.cpu(), ref.matrix.value,
                                   **F32)
    # planners: 1 structural padded product; variants: 1 + 1 + 10 blocks
    assert launches == 1 + 1 + 1 + 10
    sc, sh = Ac.sort(), Ah.sort()
    assert torch.equal(sc.row.cpu(), sh.row) and torch.equal(sc.col.cpu(),
                                                             sh.col)


def test_spgemm_grads_card_vs_cpu(dev):
    """Value grads of A @ A (the toy entry) through each variant."""
    grads = {}
    for where in ("cuda", "cpu"):
        A = spgemm_entry(where)
        v = A.value.clone().requires_grad_()
        Ai = A.with_value(v)
        G = torch.linspace(-1, 1, 20000, device=where)
        for name, res in _spgemm_runs(Ai, Ai).items():
            (res.matrix.value * G[:res.matrix.capacity]).sum().backward(
                retain_graph=True)
            grads[where, name] = v.grad.cpu().clone()
            v.grad = None
    for name in ("rowsorted", "padded", "rowblocked"):
        torch.testing.assert_close(grads["cuda", name], grads["cpu", name],
                                   **F32)


# ---- multi-span SpMM (K3/K4), span SDDMM (K2's span form), seg2/seg3/split

def _span_ptrs(dev, S, M, max_len, seed=0):
    """(S, M+1) int32 row pointers of contiguous spans, span-major, with
    empty spans and empty rows (0 and M-1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lens = torch.randint(0, max_len + 1, (S, M), generator=g, device=dev)
    lens[:, [0, M - 1]] = 0
    ptr = torch.zeros(S * M + 1, dtype=torch.int64, device=dev)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    return ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32), g


@pytest.mark.parametrize("S", [1, 3, 19, 40])
@pytest.mark.parametrize("K", [1, 47, 64, 100, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spans_kernel_vs_plain(dev, S, K, dtype):
    """Multi-span SpMM and span SDDMM against their plain versions in f64,
    with slice bases, empty spans and rows; ``value=None`` at K=47."""
    M, N = 400, 300
    rp, g = _span_ptrs(dev, S, M, 4, seed=S * 7 + K)
    nnz = int(rp[-1, -1])
    base = torch.randint(0, 50, (S,), generator=g, device=dev,
                         dtype=torch.int32)
    idx = torch.randint(0, N - 50, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    val = None if K == 47 else torch.rand(nnz, generator=g, device=dev)
    x = torch.randn(N, K, generator=g, device=dev).to(dtype)
    out = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, val, base, x)
    ref = spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx,
                               None if val is None else val.double(), base,
                               x.double())
    torch.cuda.synchronize()
    assert out.dtype == (dtype if val is None else torch.float32)
    tol = F32 if out.dtype == torch.float32 else BF16
    torch.testing.assert_close(out.double(), ref, **tol)
    assert not out[[0, M - 1]].any()
    gm = torch.randn(M, K, generator=g, device=dev).to(dtype)
    dv = sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, base, gm, x)
    dref = sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, base,
                                 gm.double(), x.double(), torch.float64)
    torch.testing.assert_close(dv.double(), dref, **F32)


@pytest.mark.parametrize("K", [1, 8, 47, 100, 256, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spans_s1_equals_k1_bitwise(dev, K, dtype):
    """With one span the multi-span kernel sums the same edges in the same
    order with the same operations as K1."""
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, K, generator=g, device=dev).to(dtype)
    rp = rowptr[None]
    for v in (value, None):
        a = spmm_spans_cuda(rp[:, :-1], rp[:, 1:], col, v, None, x)
        b = spmm_csr_cuda(rowptr, col, v, x)
        assert torch.equal(a, b)


def test_spans_stream_form_and_long_row(dev):
    """The stream form (idx=None) with overlapping spans, reversed (empty)
    spans, and one row of 1.1M edges over 3 spans; small-integer inputs
    keep every f32 sum exact."""
    g = torch.Generator(device=dev).manual_seed(9)
    L, K = 1_200_000, 64
    src = torch.randint(-3, 4, (L, K), generator=g, device=dev).float()
    start = torch.randint(0, L - 100, (3, 500), generator=g, device=dev)
    end = start + torch.randint(-5, 60, (3, 500), generator=g, device=dev)
    start[:, 7], end[:, 7] = torch.tensor([0, 400_000, 800_000]), torch.tensor(
        [366_000, 766_000, 1_168_000])
    out = spmm_spans_cuda(start.int(), end.int(), None, None, None, src)
    ref = spmm_spans_reference(start, end, None, None, None, src.double())
    assert torch.equal(out.double(), ref)


def test_tilespan_and_band_reduce_entry_points(dev):
    """K3's and K4's entry points on the card against their plain versions
    on the CPU, on tables of the JAX layout (a stream with pads past the
    staged slices)."""
    from paddle_sparse_tpu_torch import make_seg3_plan, tilespan_tables
    g = torch.Generator().manual_seed(10)
    row = torch.sort(torch.randint(0, 600, (6000,), generator=g)).values
    col = torch.randint(0, 500, (6000,), generator=g)
    plan, s = make_seg3_plan(row, col, 600, 500, feat_dim=64, sr=64,
                             band_rows=256)
    e0a, bst, ben = tilespan_tables(s.rp_f, S=plan.S, BAND=plan.BAND,
                                    cap=plan.cap, CAP_TS=plan.CAP_TS)
    L = plan.S * plan.cap + plan.CAP_TS
    kw = dict(S=plan.S, T_B=plan.BAND // 128, CAP_TS=plan.CAP_TS, K=64)
    for b in range(e0a.shape[0]):
        stream = torch.randn(L, 64, generator=g)
        for dt in (torch.float32, torch.bfloat16):
            got = tilespan_call(e0a[b].to(dev), bst[b].to(dev),
                                ben[b].to(dev), stream.to(dev, dt), **kw)
            ref = tilespan_call(e0a[b], bst[b], ben[b],
                                stream.to(dt).double(), **kw)
            torch.testing.assert_close(got.cpu(), ref, **F32)
    S, BR_pad, E = 3, 384, 64
    bounds = torch.sort(torch.randint(0, S * 448, (S, BR_pad + 1),
                                      generator=g), dim=1).values
    bs, be = bounds[:, :-1].reshape(-1, 128), bounds[:, 1:].reshape(-1, 128)
    stream = torch.randn(S * 448, 32, generator=g)
    sched = [torch.zeros(1, dtype=torch.int32)] * 3
    got = band_reduce_call(*(t.to(dev) for t in sched), bs.to(dev),
                           be.to(dev), stream.to(dev), S=S, BR_pad=BR_pad,
                           E=E, K=32, TMAX=4)
    ref = band_reduce_call(*sched, bs, be, stream.double(), S=S,
                           BR_pad=BR_pad, E=E, K=32, TMAX=4)
    torch.testing.assert_close(got.cpu(), ref, **F32)


def test_spans_launch_counters(dev):
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    x = torch.randn(50, 16, generator=g, device=dev)
    gm = torch.randn(100, 16, generator=g, device=dev)
    before = (spmm_spans_cuda.launches, sddmm_spans_cuda.launches)
    spmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, None, None, x)
    spmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, None, x)
    sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, None, gm, x)
    sddmm_spans_reference(rp[:, :-1], rp[:, 1:], idx, None, gm, x)
    assert (spmm_spans_cuda.launches, sddmm_spans_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("bad", ["f64", "noncontig", "device", "3d",
                                 "f32_to_bf16", "bounds_shape", "base_short",
                                 "value_shape"])
def test_spans_rejects(dev, bad):
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    val = torch.rand(nnz, generator=g, device=dev)
    base = torch.zeros(3, dtype=torch.int32, device=dev)
    x = torch.randn(50, 16, generator=g, device=dev)
    start, end, kw = rp[:, :-1], rp[:, 1:], {}
    if bad == "f64":
        x = x.double()
    elif bad == "noncontig":
        x = torch.randn(16, 50, generator=g, device=dev).t()
    elif bad == "device":
        idx = idx.cpu()
    elif bad == "3d":
        x = x.view(50, 4, 4)
    elif bad == "f32_to_bf16":
        kw["out_dtype"] = torch.bfloat16
    elif bad == "bounds_shape":
        end = rp[:, 2:]
    elif bad == "base_short":
        base = base[:2]
    else:
        val = val[:-1]
    with pytest.raises((TypeError, ValueError)):
        spmm_spans_cuda(start, end, idx, val, base, x, **kw)


@pytest.mark.parametrize("bad", ["f64", "g_shape", "device", "out_f16"])
def test_sddmm_spans_rejects(dev, bad):
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    x = torch.randn(50, 16, generator=g, device=dev)
    gm = torch.randn(100, 16, generator=g, device=dev)
    kw = {}
    if bad == "f64":
        x = x.double()
    elif bad == "g_shape":
        gm = gm[:99]
    elif bad == "device":
        gm = gm.cpu()
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises((TypeError, ValueError)):
        sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, None, gm, x, **kw)


_PACKED_FNS = {"seg2": spmm_seg2, "seg3": spmm_seg3, "seg2split": spmm_split}


@pytest.mark.parametrize("backend", SPMM_BACKENDS)
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_packed_spmm_card_vs_cpu(dev, backend, stream):
    """``spmm_entry``'s toy for each backend: forward, d packed and d x on
    the card against the CPU; launches: spans 1 per forward and 1 for d x,
    span SDDMM 1 for d value, per seg2 call (split: two calls)."""
    runs = {}
    for where in ("cuda", "cpu"):
        plan, s, packed, x = spmm_entry(backend, where)
        if stream == "bf16":
            plan = (plan._replace(stream="bf16") if backend != "seg2split"
                    else plan._replace(local=plan.local._replace(
                        stream="bf16"), resid=plan.resid._replace(
                        stream="bf16")))
        pv = (tuple(t.clone().requires_grad_() for t in packed)
              if backend == "seg2split" else packed.clone().requires_grad_())
        xx = x.clone().requires_grad_()
        w = torch.linspace(-1, 1, 256 * 32, device=where).view(256, 32)
        k = (spmm_spans_cuda.launches, sddmm_spans_cuda.launches)
        out = _PACKED_FNS[backend](plan, s, pv, xx)
        (out * w).sum().backward()
        launches = (spmm_spans_cuda.launches - k[0],
                    sddmm_spans_cuda.launches - k[1])
        grads = [t.grad for t in pv] if backend == "seg2split" else [pv.grad]
        runs[where] = ([out.detach().cpu(), xx.grad.cpu()]
                       + [t.cpu() for t in grads], launches)
    calls = 2 if backend == "seg2split" else 1
    assert runs["cuda"][1] == (2 * calls, calls)
    assert runs["cpu"][1] == (0, 0)
    for c, h in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(c, h, **F32)


# ---- long rows: pieces of a RowSplit table, one warp each, and the fold ---

def _long_row_bounds(dev, S, cap, seed=0):
    """(S, M) span bounds whose rows hold cap-1, cap, cap+1 and 2*cap+3
    flat edges among short and empty rows, each row's edges spread over
    the S spans with empty spans among them."""
    g = torch.Generator().manual_seed(seed)
    totals = [0, cap - 1, 3, cap, 0, cap + 1, 7, 2 * cap + 3, 0, 1]
    lens = torch.zeros(S, len(totals), dtype=torch.int64)
    for m, n in enumerate(totals):
        if n:
            cut = torch.sort(torch.randint(0, n + 1, (S - 1,),
                                           generator=g)).values
            lens[:, m] = torch.diff(torch.cat([torch.tensor([0]), cut,
                                               torch.tensor([n])]))
    ptr = torch.zeros(lens.numel() + 1, dtype=torch.int64)
    ptr[1:] = lens.reshape(-1).cumsum(0)
    M = len(totals)
    rp = ptr.as_strided((S, M + 1), (M, 1)).to(torch.int32).to(dev)
    return rp[:, :-1], rp[:, 1:], int(ptr[-1])


@pytest.mark.parametrize("S", [1, 38])
@pytest.mark.parametrize("cap", [32, CAP])
@pytest.mark.parametrize("K", [1, 47, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_kernels_vs_plain(dev, S, cap, K, dtype):
    """Both span kernels over a split table (rows of cap-1 to 2*cap+3
    edges) against their plain versions in f64; the SpMM's fold runs once
    per launch."""
    start, end, nnz = _long_row_bounds(dev, S, cap, seed=S + K)
    t = split_rows(start, end, cap)
    assert t is not None and t.fold_row.tolist() == [5, 7]
    g = torch.Generator(device=dev).manual_seed(K)
    N = 500
    base = torch.randint(0, 50, (S,), generator=g, device=dev,
                         dtype=torch.int32)
    idx = torch.randint(0, N - 50, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.rand(nnz, generator=g, device=dev) * 2 - 1
    x = torch.randn(N, K, generator=g, device=dev).to(dtype)
    folds = fold_pieces_cuda.launches
    out = spmm_spans_cuda(start, end, idx, val.to(dtype), base, x, split=t)
    assert fold_pieces_cuda.launches == folds + 1
    ref = spmm_spans_reference(start, end, idx, val.to(dtype).double(), base,
                               x.double())
    scale = spmm_spans_reference(start, end, idx,
                                 val.to(dtype).double().abs(), base,
                                 x.double().abs())
    torch.cuda.synchronize()
    # a bf16 output rounds each entry once, by at most 2**-9 of it
    _close_to_sum(out, ref, scale, 0.0 if dtype == torch.float32 else 2 ** -8)
    gm = torch.randn(start.shape[1], K, generator=g, device=dev).to(dtype)
    dv = sddmm_spans_cuda(start, end, idx, base, gm, x, split=t)
    dref = sddmm_spans_reference(start, end, idx, base, gm.double(),
                                 x.double(), torch.float64)
    torch.testing.assert_close(dv.double(), dref, **F32)


def test_split_launches_bitwise_equal(dev):
    """Two split launches give the same bits (no atomics; a fixed fold);
    ``split=None`` and an unsplit graph launch no fold."""
    start, end, nnz = _long_row_bounds(dev, 38, 64)
    t = split_rows(start, end, 64)
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, 400, (nnz,), generator=g, device=dev)
    x = torch.randn(400, 256, generator=g, device=dev)
    gm = torch.randn(start.shape[1], 256, generator=g, device=dev)
    a = spmm_spans_cuda(start, end, idx, None, None, x, split=t)
    b = spmm_spans_cuda(start, end, idx, None, None, x, split=t)
    assert torch.equal(a, b)
    da = sddmm_spans_cuda(start, end, idx, None, gm, x, split=t)
    db = sddmm_spans_cuda(start, end, idx, None, gm, x, split=t)
    assert torch.equal(da, db)
    folds = fold_pieces_cuda.launches
    whole = spmm_spans_cuda(start, end, idx, None, None, x, split=None)
    rp, _ = _span_ptrs(dev, 3, 100, 3)
    spmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx[:int(rp[-1, -1])], None,
                    None, x)                     # "auto": nothing splits
    assert fold_pieces_cuda.launches == folds
    torch.testing.assert_close(whole, a, **F32)


def test_split_csr_long_row_exact(dev):
    """K1 and K2 through the table built per call ("auto"), on a row of
    1.1M edges among short and empty ones; small-integer inputs keep every
    f32 sum exact whatever the order."""
    g = torch.Generator(device=dev).manual_seed(4)
    deg = torch.tensor([3, 0, 1_100_000, 5, CAP + 1, 0], device=dev)
    rowptr = torch.zeros(7, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    nnz = int(rowptr[-1])
    col = torch.randint(0, 2000, (nnz,), generator=g, device=dev,
                        dtype=torch.int32)
    val = torch.randint(-2, 3, (nnz,), generator=g, device=dev).float()
    for K in (8, 256):
        x = torch.randint(-4, 5, (2000, K), generator=g, device=dev).float()
        gm = torch.randint(-4, 5, (6, K), generator=g, device=dev).float()
        folds = fold_pieces_cuda.launches
        out = spmm_csr_cuda(rowptr, col, val, x)
        assert fold_pieces_cuda.launches == folds + 1
        assert torch.equal(out.double(), spmm_csr_reference(
            rowptr, col, val.double(), x.double()))
        assert torch.equal(sddmm_csr_cuda(rowptr, col, gm, x).double(),
                           sddmm_csr_reference(rowptr, col, gm.double(),
                                               x.double(), torch.float64))


def _zipf_rows(n, nnz, seed=0):
    import numpy as np
    w = np.random.default_rng(seed).zipf(1.5, n).astype(np.float64)
    deg = np.maximum(1, np.floor(w * (nnz / w.sum()))).astype(np.int64)
    return torch.arange(n, dtype=torch.int32).repeat_interleave(
        torch.as_tensor(deg))


def test_seg2_zipf_card_vs_cpu(dev):
    """seg2 on a small zipf graph whose hub rows split: forward, d packed
    and d x on the card against the CPU, each entry within SUM_REL of its
    sum of |terms| (the CPU's run on |inputs|); the forward's fold runs."""
    n = 20_000
    row = _zipf_rows(n, 200_000)
    g = torch.Generator().manual_seed(5)
    col = torch.randint(0, n, (row.numel(),), generator=g, dtype=torch.int32)
    val = torch.rand(row.numel(), generator=g)
    x = torch.randn(n, 64, generator=g)
    w = torch.randn(n, 64, generator=g)
    runs = {}
    for where, sign in (("cuda", 1), ("cpu", 1), ("cpu", 0)):
        f = (lambda t: t) if sign else torch.abs        # 0: |inputs|
        plan, s = make_seg2_plan(row.to(where), col.to(where), n, n,
                                 feat_dim=64, sr=4096)
        assert s.split_f is not None and s.split_t is None
        pv = pack_values(s, f(val).to(where)).requires_grad_()
        xx = f(x).to(where, copy=True).requires_grad_()
        folds = fold_pieces_cuda.launches
        out = spmm_seg2(plan, s, pv, xx)
        (out * f(w).to(where)).sum().backward()
        runs[where, sign] = ([out.detach().cpu(), pv.grad.cpu(),
                              xx.grad.cpu()],
                             fold_pieces_cuda.launches - folds)
    assert runs["cuda", 1][1] == 1 and runs["cpu", 1][1] == 0
    for c, h, a in zip(*(runs[k][0] for k in (("cuda", 1), ("cpu", 1),
                                               ("cpu", 0)))):
        _close_to_sum(c, h, a)


def test_spmm_autograd_hub_row_and_column(dev):
    """``PaddedCOO.spmm`` forward, d value and d x with a hub row and a hub
    column past ``CAP``: the cached tables on the card against the CPU,
    each entry within SUM_REL of its sum of |terms|."""
    g = torch.Generator().manual_seed(6)
    M = N = 3000
    hub = CAP * 2 + 5
    row = torch.cat([torch.full((hub,), 7), torch.randint(0, M, (20_000,),
                                                          generator=g),
                     torch.arange(hub) % M])
    col = torch.cat([torch.randint(0, N, (hub,), generator=g),
                     torch.randint(0, N, (20_000,), generator=g),
                     torch.full((hub,), 11)])
    order = torch.argsort(row, stable=True)
    row, col = row[order], col[order]
    val = torch.rand(row.numel(), generator=g)
    x = torch.randn(N, 48, generator=g)
    w = torch.randn(M, 48, generator=g)
    runs = {}
    for where, sign in (("cuda", 1), ("cpu", 1), ("cpu", 0)):
        f = (lambda t: t) if sign else torch.abs        # 0: |inputs|
        adj = PaddedCOO.from_arrays(row, col, f(val), (M, N), device=where)
        s = adj.structure()
        assert s.row_split is not None and s.col_split is not None
        v = adj.value.clone().requires_grad_()
        xx = f(x).to(where, copy=True).requires_grad_()
        out = adj.with_value(v).spmm(xx)
        (out * f(w).to(where)).sum().backward()
        runs[where, sign] = [out.detach().cpu(), v.grad.cpu(),
                             xx.grad.cpu()]
    for c, h, a in zip(runs["cuda", 1], runs["cpu", 1], runs["cpu", 0]):
        _close_to_sum(c, h, a)
