"""The CUDA kernels of paddle_sparse_tpu_torch against their plain versions,
and the SpMM autograd, the toy train step, SpGEMM and the packed-layout SpMMs
(seg2, seg3, split) on the card against the CPU; the span kernels' long-row
split (pieces of a ``RowSplit`` table and the fold pass) against the plain
versions, bit for bit from launch to launch; SpMM mean (through the same
kernels, split rows too) against plain f64, min and max on the card against
the CPU, and each model family's toy forward and grads, card against CPU,
with GAT's per-head launches; GAT's attention kernels (node scores, edge
softmax; split rows, non-finite logits, head groups, f64) against their
plain version, and PyG's GAT on split rows card against CPU; K1 on strided
views (GAT's heads in place, ``out=``) bit for bit against contiguous
copies, its refusals, and PyG's GAT against its former stacked heads,
``spmm_csr_cuda.strided`` per model; the fused CSC backward
(``spmm_sddmm_csc_cuda``) equal to the pair it replaces (K2 and K1 over
the CSC view) bit for bit, at every batch size and on offset views,
within SUM_REL of f64, two launches equal, its launch alone
(``csc_order_cuda``, CSC order) against its plain version in every dtype,
and its launches per GCN step;
its span form (``spmm_sddmm_spans_cuda``) over seg2's transpose layout
equal to the pair it replaces (the span SDDMM over the forward layout and
the spans SpMM over the transpose) bit for bit through the backward's own
fused pass (``spmm_seg2.fused_span_backward``), split x rows too, within
SUM_REL of f64, two launches equal;
``spmm_seg``, ``spmm_sell`` and ``spmm_chunked`` (launches exact) and
``backend="sell"``; sampling, walks,
``saint_subgraph``, ``partition`` and RCM on the card against the CPU
(exact where the draws are the same); every launch site of
``ops/kernels/`` on a side stream (``torch.cuda.stream``) equal bit for bit
to the default stream's result, and P1 and P2 replayed in a CUDA graph.
Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is False. This file imports no JAX, so on a
machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 ``rtol=1e-5, atol=1e-4`` (sums in another order); bf16
output ``rtol=atol=2e-2`` (output rounded to bf16); run compaction with
f64 values against the plain version in f64 ``rtol=atol=1e-12`` (the plain
version's ``index_add`` sums in another order), its own row sort against
``torch.sort`` + its presorted mode bit for bit, and flat runs of up to 10M
f32 values (summed across lanes, warps and tiles) within 1e-6 of each
run's sum of |terms| of f64. TF32 stays off, so the
GCN's ``h @ w`` and its backward GEMMs are full f32 on the card."""
import dataclasses

import pytest
import torch

from paddle_sparse_tpu_torch import (CAP, MODELS, PaddedCOO,
                                     band_reduce_call, compact_runs_cuda,
                                     compact_runs_reference, entry,
                                     fold_pieces_cuda, gat_attention_cuda,
                                     gat_attention_reference, gcn_loss,
                                     make_seg2_plan, model_entry,
                                     pack_values, plan_spgemm,
                                     plan_spgemm_blocked, plan_spgemm_rows,
                                     product_dtype, sddmm_csr_cuda,
                                     sddmm_csr_reference, sddmm_spans_cuda,
                                     sddmm_spans_reference, spgemm_entry,
                                     spmm_coo, spmm_csr_cuda,
                                     spmm_csr_reference, spmm_entry,
                                     spmm_sddmm_csc_cuda,
                                     spmm_sddmm_csc_reference,
                                     spmm_sddmm_spans_cuda,
                                     spmm_sddmm_spans_reference, spmm_seg2,
                                     spmm_seg3, spmm_spans_cuda,
                                     spmm_spans_reference, spmm_split,
                                     split_rows, spspmm_padded,
                                     spspmm_rowblocked,
                                     spspmm_rowsorted, tilespan_call,
                                     train_entry, train_step)

from paddle_sparse_tpu_torch.experiments import (bisect_pallas as bp,
                                                 r4_band_cost as rb,
                                                 r4_dma_issue as rd)
from paddle_sparse_tpu_torch.ops.kernels import probes_cuda as pc
from paddle_sparse_tpu_torch.ops.kernels.segcompact_cuda import F_MAX
from paddle_sparse_tpu_torch.ops.spmm_seg2 import (fused_span_backward,
                                                   span_layouts)
from stacked_heads import stacked_spmm

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


def _csr(dev, M=500, N=300, max_deg=30, seed=0, long_row=0):
    """A random CSR with rows 0 and M - 1 empty and, if ``long_row``, row
    M // 2 of that many edges."""
    g = torch.Generator(device=dev).manual_seed(seed)
    deg = torch.randint(0, max_deg + 1, (M,), generator=g, device=dev)
    deg[[0, M - 1]] = 0
    if long_row:
        deg[M // 2] = long_row
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


@pytest.mark.parametrize("bad", ["int32", "int_value", "noncontig", "device",
                                 "3d"])
def test_kernel_rejects(dev, bad):
    """What K1 refuses: a mixed int/float pair (the entry, ``ops/spmm.py``,
    casts it to the float first, as JAX does; ``test_int_k1_equals_plain``
    holds the int pairs), and layouts and devices the kernel cannot read.
    f16 and f64 are accuracy cases (``test_kernel_dtypes_vs_plain``)."""
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, 8, generator=g, device=dev)
    if bad == "int32":
        x = x.int()
    elif bad == "int_value":
        value = value.int()
    elif bad == "noncontig":
        x = torch.randn(8, 300, generator=g, device=dev).t()
    elif bad == "device":
        value = value.cpu()
    else:
        x = x.view(300, 2, 4)
    with pytest.raises((TypeError, ValueError)):
        spmm_csr_cuda(rowptr, col, value, x)


# (x, value): f16 and f64 alone and their mixed pairs with the others
NEW_DTYPE_PAIRS = [(torch.float16, torch.float16),
                   (torch.float16, torch.float32),
                   (torch.float32, torch.float16),
                   (torch.float16, torch.bfloat16),
                   (torch.float16, None), (torch.float64, torch.float64),
                   (torch.float64, torch.float32),
                   (torch.float32, torch.float64),
                   (torch.bfloat16, torch.float64), (torch.float64, None)]
F16_HALF_ULP, BF16_HALF_ULP = 2.0 ** -11, 2.0 ** -8
# f64 sums in another order: within this share of each entry's sum of |terms|
F64_REL = 1e-12


def _close_in_dtype(got, ref, scale):
    """``got`` against its f64 ``ref``: f64 within F64_REL of each entry's
    sum of |terms| (``scale``); narrower outputs within SUM_REL of it (an
    f32 sum) plus half an ulp of their dtype (one rounding) and, for f16,
    half its subnormal spacing."""
    if got.dtype == torch.float64:
        err = (got - ref.double()).abs()
        assert bool((err <= F64_REL * scale.double() + 1e-300).all()), \
            float(err.max())
        return
    out_rel = {torch.float16: F16_HALF_ULP,
               torch.bfloat16: BF16_HALF_ULP}.get(got.dtype, 0.0)
    tiny = 2.0 ** -25 if got.dtype == torch.float16 else 0.0
    ref = ref.double()
    err = (got.double() - ref).abs()
    bound = SUM_REL * scale.double() + out_rel * ref.abs() + tiny + 1e-30
    assert bool((err <= bound).all()), float((err - bound).max())


def _ids(pairs):
    return ["-".join("none" if d is None else str(d)[6:] for d in p)
            for p in pairs]


@pytest.mark.parametrize("K", [1, 3, 47, 256])
@pytest.mark.parametrize("xdt,vdt", NEW_DTYPE_PAIRS,
                         ids=_ids(NEW_DTYPE_PAIRS))
def test_kernel_dtypes_vs_plain(dev, xdt, vdt, K):
    """K1 in f16, f64 and the mixed pairs: the output in torch's promoted
    dtype, one launch, and within its dtype's rounding of the plain version
    run in f64 (``test_kernel_rejects`` refused f16 and f64 before)."""
    rowptr, col, value, g = _csr(dev)
    x = torch.randn(300, K, generator=g, device=dev).to(xdt)
    v = None if vdt is None else value.to(vdt)
    n = spmm_csr_cuda.launches
    out = spmm_csr_cuda(rowptr, col, v, x)
    torch.cuda.synchronize()
    assert spmm_csr_cuda.launches == n + 1
    assert out.dtype == (xdt if v is None else torch.promote_types(vdt, xdt))
    ref, scale = (spmm_csr_reference(rowptr, col,
                                     None if v is None else f(v.double()),
                                     f(x.double()))
                  for f in (lambda t: t, torch.abs))
    _close_in_dtype(out, ref, scale)


def test_f16_x_with_f32_value_launches_once_without_a_copy(dev):
    """``PaddedCOO.spmm`` with an f16 ``x`` and an f32 value: one K1
    launch, an f32 output, and no f32 copy of ``x``: the call allocates
    less than that copy besides its output."""
    rowptr, col, value, g = _csr(dev, M=500, N=4000)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    adj = PaddedCOO.from_arrays(row, col, value, (500, 4000))
    adj.rowptr(), adj.row_split()
    x = torch.randn(4000, 256, generator=g, device=dev).half()
    torch.cuda.synchronize()
    n = spmm_csr_cuda.launches
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = adj.spmm(x)
    torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base
             - out.numel() * out.element_size())
    assert spmm_csr_cuda.launches == n + 1 and out.dtype == torch.float32
    assert extra < x.numel() * 4 // 2, extra


@pytest.mark.parametrize("dt", [torch.float64, torch.float16])
def test_backward_launches_fused_once(dev, dt):
    """``A @ x`` forward and backward with ``value`` and ``x`` requiring
    grad, in f64 and f16: K1 once forward, the fused CSC backward once, no
    K2; d value in the value's dtype, d x in x's."""
    adj = _fused_graph(dev, False)
    gen = torch.Generator(device=dev).manual_seed(3)
    v = adj.value.to(dt).requires_grad_()
    x = torch.randn(adj.N, 64, generator=gen, device=dev).to(
        dt).requires_grad_()
    before = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
              spmm_sddmm_csc_cuda.launches)
    out = adj.with_value(v).spmm(x)
    out.sum().backward()
    torch.cuda.synchronize()
    after = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
             spmm_sddmm_csc_cuda.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 0, 1]
    assert (out.dtype, v.grad.dtype, x.grad.dtype) == (dt, dt, dt)


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


@pytest.mark.parametrize("bad", ["int32", "noncontig", "device", "shape",
                                 "out_int32"])
def test_sddmm_rejects(dev, bad):
    """What K2 still refuses: integer inputs or outputs, and layouts and
    devices it cannot read. f64 and f16 are accuracy cases
    (``test_sddmm_dtypes_vs_plain``)."""
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, 8, generator=g, device=dev)
    x = torch.randn(300, 8, generator=g, device=dev)
    kw = {}
    if bad == "int32":
        x = x.int()
    elif bad == "noncontig":
        gm = torch.randn(8, 500, generator=g, device=dev).t()
    elif bad == "device":
        gm = gm.cpu()
    elif bad == "shape":
        gm = gm[:, :4].contiguous()
    else:
        kw["out_dtype"] = torch.int32
    with pytest.raises((TypeError, ValueError)):
        sddmm_csr_cuda(rowptr, col, gm, x, **kw)


# (g, x, d value): f16 and f64, their mixed pairs, and a g narrower than x
SDDMM_DTYPES = [(torch.float16, torch.float16, torch.float16),
                (torch.float16, torch.float16, torch.float32),
                (torch.float32, torch.float16, torch.float32),
                (torch.float16, torch.float32, torch.float16),
                (torch.float64, torch.float64, torch.float64),
                (torch.float64, torch.float32, torch.float64),
                (torch.float64, torch.bfloat16, torch.float64),
                (torch.float32, torch.float64, torch.float32)]


@pytest.mark.parametrize("K", [1, 3, 47, 256])
@pytest.mark.parametrize("gdt,xdt,odt", SDDMM_DTYPES,
                         ids=_ids(SDDMM_DTYPES))
def test_sddmm_dtypes_vs_plain(dev, gdt, xdt, odt, K):
    """K2 in f16, f64 and the mixed pairs, d value in ``out_dtype``: one
    launch, within its dtype's rounding of the plain version in f64
    (``test_sddmm_rejects`` refused f64 and an f16 output before)."""
    rowptr, col, _, g = _csr(dev)
    gm = torch.randn(500, K, generator=g, device=dev).to(gdt)
    x = torch.randn(300, K, generator=g, device=dev).to(xdt)
    n = sddmm_csr_cuda.launches
    out = sddmm_csr_cuda(rowptr, col, gm, x, out_dtype=odt)
    torch.cuda.synchronize()
    assert sddmm_csr_cuda.launches == n + 1 and out.dtype == odt
    ref, scale = (sddmm_csr_reference(rowptr, col, f(gm.double()),
                                      f(x.double()), torch.float64)
                  for f in (lambda t: t, torch.abs))
    _close_in_dtype(out, ref, scale)


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
    """One forward + backward with both grads: K1 once (forward) and the
    fused CSC backward once; d x alone: K1 twice (forward, d x over the CSC
    view), no SDDMM."""
    rowptr, col, value, g = _csr(dev)
    row = torch.repeat_interleave(torch.arange(500, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    x = torch.randn(300, 16, generator=g, device=dev, requires_grad=True)
    for v, want in ((value.clone().requires_grad_(), (1, 0, 1)),
                    (value, (2, 0, 0))):
        k = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
             spmm_sddmm_csc_cuda.launches)
        spmm_coo(row, col, v, x, 500).sum().backward()
        assert (spmm_csr_cuda.launches - k[0], sddmm_csr_cuda.launches - k[1],
                spmm_sddmm_csc_cuda.launches - k[2]) == want


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


@pytest.mark.parametrize("bad", ["int64", "int16", "noncontig", "device",
                                 "shape", "rows", "3d", "capacity",
                                 "unsorted_flat", "unsorted_wide",
                                 "grid_trailing"])
def test_segcompact_rejects(dev, bad):
    key, val = _sorted_grid(dev, 50, 16, 20, dtype=torch.float32)
    rows = torch.arange(50, dtype=torch.int32, device=dev)
    cap = 900
    kw = {}
    if bad == "unsorted_flat":
        key, val, rows = key.reshape(-1), val.reshape(-1), rows.repeat(16)
        kw = dict(rows_sorted=False)
    elif bad == "unsorted_wide":
        key = torch.zeros(2, F_MAX + 8, dtype=torch.int32, device=dev)
        val, rows = key.float(), rows[:2]
        kw = dict(rows_sorted=False)
    elif bad == "int64":
        key = key.long()
    elif bad == "int16":               # bf16 is an accuracy case now
        val = val.to(torch.int16)
    elif bad == "grid_trailing":        # trailing dims: flat streams only
        val = val[..., None].expand(50, 16, 2).contiguous()
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
        compact_runs_cuda(key, rows, val, (50, 20), cap, **kw)


VALUE_DTYPES = [torch.float32, torch.bfloat16, torch.float16,
                torch.float64, torch.int32, torch.int64]


def _values_like(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return torch.randint(-100, 101, shape, generator=g, device=dev,
                         dtype=dtype)


@pytest.mark.parametrize("layout", ["flat", "flat_D8", "grid",
                                    "grid_unsorted", "grid_wide"])
@pytest.mark.parametrize("dtype", VALUE_DTYPES,
                         ids=[str(d)[6:] for d in VALUE_DTYPES])
def test_segcompact_value_dtypes(dev, dtype, layout):
    """K5 in every value dtype ``coalesce`` and SpGEMM hand it (bf16 was a
    refusal before): structure and seg exact against the plain version; int
    sums exact; float sums within 1e-6 of each run's sum of |terms| in f64
    plus half an ulp of the value's dtype (f16 and bf16 summed in f32 and
    rounded once); (L, 8) values on a flat stream summed lane by lane."""
    if layout.startswith("flat"):
        col, rows, _ = _flat_sorted(dev, 300, 40, 50_000, 77)
        shape = (col.numel(), 8) if layout == "flat_D8" else (col.numel(),)
        M, N, kw = 300, 40, {}
    else:
        R, F = (200, 1500) if layout == "grid_wide" else (3000, 64)
        col, _ = _sorted_grid(dev, R, F, 30)
        if layout == "grid_unsorted":
            perm = torch.rand(R, F, device=dev).argsort(1)
            col = col.gather(1, perm).contiguous()
        rows = torch.arange(R, dtype=torch.int32, device=dev)
        shape, M, N = (R, F), R, 30
        kw = {"rows_sorted": layout != "grid_unsorted"}
    val = _values_like(shape, dtype, dev, 3)
    cap = int(compact_runs_reference(col, rows, None, (M, N), 1,
                                     **kw).count) + 3
    n = compact_runs_cuda.launches
    got = compact_runs_cuda(col, rows, val, (M, N), cap, seg=True, **kw)
    torch.cuda.synchronize()
    assert compact_runs_cuda.launches == n + 1
    wide = torch.float64 if dtype.is_floating_point else torch.int64
    ref = compact_runs_reference(col, rows, val.to(wide), (M, N), cap,
                                 seg=True, **kw)
    assert got.value.dtype == dtype and got.value.shape == ref.value.shape
    assert int(got.count) == int(ref.count)
    assert torch.equal(got.row, ref.row) and torch.equal(got.col, ref.col)
    assert torch.equal(got.seg, ref.seg)
    if not dtype.is_floating_point:
        assert torch.equal(got.value, ref.value.to(dtype))
        return
    scale = compact_runs_reference(col, rows, val.double().abs(), (M, N),
                                   cap, **kw).value
    out_rel = {torch.float16: F16_HALF_ULP,
               torch.bfloat16: BF16_HALF_ULP}.get(dtype, 0.0)
    rel = F64_REL if dtype == torch.float64 else 1e-6
    err = (got.value.double() - ref.value).abs()
    assert bool((err <= rel * scale + out_rel * ref.value.abs()
                 + 2.0 ** -25 + 1e-300).all()), float(err.max())


def _shuffled(key, val, seed):
    """The grid's rows each in a random order (as the SpGEMM expansion
    leaves them)."""
    g = torch.Generator(device=key.device).manual_seed(seed)
    perm = torch.rand(key.shape, generator=g, device=key.device).argsort(1)
    return (key.gather(1, perm).contiguous(),
            None if val is None else val.gather(1, perm).contiguous())


def _unsorted_vs_presorted(key, rows, val, shape, cap):
    """The kernel's own row sort against ``torch.sort(stable=True)`` + the
    presorted mode on the same grid: coordinates, count, values and seg
    (mapped back through the sort) bit for bit."""
    got = compact_runs_cuda(key, rows, val, shape, cap, seg=True,
                            rows_sorted=False)
    sk, perm = torch.sort(key, dim=1, stable=True)
    sv = None if val is None else val.gather(1, perm).contiguous()
    ref = compact_runs_cuda(sk.contiguous(), rows, sv, shape, cap, seg=True)
    torch.cuda.synchronize()
    assert int(got.count) == int(ref.count)
    assert torch.equal(got.row, ref.row) and torch.equal(got.col, ref.col)
    if val is not None:
        assert torch.equal(got.value.view(torch.int8),
                           ref.value.view(torch.int8))
    assert torch.equal(got.seg.view(key.shape).gather(1, perm),
                       ref.seg.view(key.shape))
    return got


@pytest.mark.parametrize("R,F,N", [(7, 16, 12), (5, 32, 6), (1, 8, 4),
                                   (3000, 64, 500), (20000, 256, 100000),
                                   (64, 1, 3), (333, 5, 4), (900, 24, 30),
                                   (600, 100, 40), (97, 264, 50),
                                   (41, 1000, 300), (17, 1024, 2),
                                   (50, 300, 1 << 30)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_segcompact_unsorted_rows(dev, R, F, N, dtype):
    """Grid rows in random order (ties of equal cols among them, down to N
    = 2): the kernel's row sort equals torch.sort + the presorted mode bit
    for bit, and the plain version (rows_sorted=False) in f64."""
    key, val = _shuffled(*_sorted_grid(dev, R, F, N, seed=R + F,
                                       dtype=dtype), seed=F)
    rows = torch.arange(R, dtype=torch.int32, device=dev)
    cap = int((key < N).sum()) + 5
    got = _unsorted_vs_presorted(key, rows, val, (R, N), cap)
    ref = compact_runs_reference(key, rows, val.double(), (R, N), cap,
                                 seg=True, rows_sorted=False)
    tol = F64_SUMS if dtype == torch.float64 else dict(rtol=1e-5, atol=1e-5)
    _same_compact(got, ref, tol)
    _unsorted_vs_presorted(key, rows, None, (R, N), cap)


@pytest.mark.parametrize("cut", [1, 5000])
def test_segcompact_unsorted_truncation_and_row_block(dev, cut):
    key, val = _shuffled(*_sorted_grid(dev, 3000, 64, 500, seed=5), seed=6)
    rows = torch.arange(7000, 10000, dtype=torch.int32, device=dev)
    count = int(compact_runs_reference(key, rows, None, (10000, 500), 0,
                                       rows_sorted=False).count)
    got = _unsorted_vs_presorted(key, rows, val, (10000, 500), count - cut)
    ref = compact_runs_reference(key, rows, val, (10000, 500), count - cut,
                                 seg=True, rows_sorted=False)
    _same_compact(got, ref, F64_SUMS)


@pytest.mark.parametrize("run", [100_000, 1_100_000, 10_000_000])
def test_segcompact_flat_long_runs_vs_f64(dev, run):
    """Flat mode: runs of 100k, 1.1M and 10M elements amid short ones, f32
    normal values, summed across lanes, warps and tiles: within 1e-6 of
    each run's sum of |terms| of f64; two launches bit for bit equal."""
    g = torch.Generator(device=dev).manual_seed(run % 97)
    lens = torch.tensor([3, run, 1, 5000, 2, run // 3, 7], device=dev)
    col = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                  lens).int()
    row = torch.zeros_like(col)
    val = torch.randn(col.numel(), generator=g, device=dev)
    a = compact_runs_cuda(col, row, val, (1, 7), 9, seg=True)
    b = compact_runs_cuda(col, row, val, (1, 7), 9, seg=True)
    ref = compact_runs_reference(col, row, val.double(), (1, 7), 9, seg=True)
    scale = compact_runs_reference(col, row, val.double().abs(), (1, 7),
                                   9).value
    torch.cuda.synchronize()
    assert int(a.count) == 7
    assert torch.equal(a.row, ref.row) and torch.equal(a.col, ref.col)
    assert torch.equal(a.seg, ref.seg)
    assert bool(((a.value.double() - ref.value).abs()
                 <= 1e-6 * scale + 1e-30).all())
    assert torch.equal(a.value.view(torch.int32), b.value.view(torch.int32))


def test_segcompact_two_launches_equal(dev):
    """Every mode, twice: equal bits (no atomics on values)."""
    key, val = _shuffled(*_sorted_grid(dev, 20000, 256, 300, seed=9,
                                       dtype=torch.float32), seed=10)
    rows = torch.arange(20000, dtype=torch.int32, device=dev)
    col, row, fval = _flat_sorted(dev, 300, 40, 3_000_000, 77, seed=11)
    for args, kw in (((key, rows, val, (20000, 300), 6_000_000),
                      dict(rows_sorted=False)),
                     ((col, row, fval.float(), (300, 40), 20_000), {})):
        a = compact_runs_cuda(*args, seg=True, **kw)
        b = compact_runs_cuda(*args, seg=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(a.value.view(torch.int32),
                           b.value.view(torch.int32))
        assert torch.equal(a.seg, b.seg) and torch.equal(a.row, b.row)


def test_segcompact_launch_counters_and_f_max(dev):
    """``launches`` counts every launch, ``launches_row_sorted`` those that
    sorted the rows; the plain version counts none; the library's row limit
    is the wrapper's F_MAX."""
    from paddle_sparse_tpu_torch.ops.kernels import _build
    assert _build.load_library().psp_segcompact_f_max() == F_MAX
    key, val = _sorted_grid(dev, 50, 16, 20)
    rows = torch.arange(50, dtype=torch.int32, device=dev)
    n, u = compact_runs_cuda.launches, compact_runs_cuda.launches_row_sorted
    compact_runs_cuda(key, rows, val, (50, 20), 900)
    compact_runs_cuda(key, rows, val, (50, 20), 900, rows_sorted=False)
    compact_runs_reference(key, rows, val, (50, 20), 900, rows_sorted=False)
    assert compact_runs_cuda.launches == n + 2
    assert compact_runs_cuda.launches_row_sorted == u + 1


def test_segcompact_wide_presorted_grid_takes_the_stream_kernel(dev):
    """A sorted grid wider than F_MAX runs as a stream (rows[e / F]); runs
    still end with their grid row."""
    key, val = _sorted_grid(dev, 300, F_MAX + 40, 9, seed=12)
    rows = torch.arange(300, dtype=torch.int32, device=dev)
    rows[1::2] = rows[0::2]                 # neighbours share a row
    cap = int((key < 9).sum())
    got = compact_runs_cuda(key, rows, val, (300, 9), cap, seg=True)
    ref = compact_runs_reference(key, rows, val, (300, 9), cap, seg=True)
    torch.cuda.synchronize()
    _same_compact(got, ref, dict(rtol=1e-11, atol=1e-11))


def test_spgemm_row_sort_dispatch(dev, monkeypatch):
    """``_sorted_row_grid``: F <= F_MAX hands the compress unsorted rows
    (counted), above it torch.sort + the presorted mode; same C."""
    from paddle_sparse_tpu_torch.ops.kernels import segcompact_cuda
    A, B = _spgemm_pair("cuda")
    F, oc = plan_spgemm_rows(A, B)
    u = compact_runs_cuda.launches_row_sorted
    c1 = spspmm_rowsorted(A, B, F, oc).matrix
    assert compact_runs_cuda.launches_row_sorted == u + 1
    monkeypatch.setattr(segcompact_cuda, "F_MAX", F - 1)
    c2 = spspmm_rowsorted(A, B, F, oc).matrix
    assert compact_runs_cuda.launches_row_sorted == u + 1
    assert c1.nnz == c2.nnz and torch.equal(c1.row, c2.row)
    assert torch.equal(c1.col, c2.col)
    torch.testing.assert_close(c1.value, c2.value, **F32)


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


@pytest.mark.parametrize("bad", ["int32", "noncontig", "device", "3d",
                                 "f32_to_bf16", "bounds_shape", "base_short",
                                 "value_shape"])
def test_spans_rejects(dev, bad):
    """What the multi-span SpMM still refuses (its kernel is K1's: f64 and
    f16 are accuracy cases, ``test_spans_dtypes_vs_plain``)."""
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    val = torch.rand(nnz, generator=g, device=dev)
    base = torch.zeros(3, dtype=torch.int32, device=dev)
    x = torch.randn(50, 16, generator=g, device=dev)
    start, end, kw = rp[:, :-1], rp[:, 1:], {}
    if bad == "int32":
        x = x.int()
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


@pytest.mark.parametrize("bad", ["int32", "g_shape", "device", "out_int32"])
def test_sddmm_spans_rejects(dev, bad):
    """What the span SDDMM still refuses (its kernel is K2's: f64 and an
    f16 output are accuracy cases, ``test_spans_dtypes_vs_plain``)."""
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    x = torch.randn(50, 16, generator=g, device=dev)
    gm = torch.randn(100, 16, generator=g, device=dev)
    kw = {}
    if bad == "int32":
        x = x.int()
    elif bad == "g_shape":
        gm = gm[:99]
    elif bad == "device":
        gm = gm.cpu()
    else:
        kw["out_dtype"] = torch.int32
    with pytest.raises((TypeError, ValueError)):
        sddmm_spans_cuda(rp[:, :-1], rp[:, 1:], idx, None, gm, x, **kw)


@pytest.mark.parametrize("dt", [torch.float64, torch.float16])
def test_spans_dtypes_vs_plain(dev, dt):
    """The direct span entry points in f64 and f16, which run K1's and K2's
    kernels: one launch each, within their dtype's rounding of the plain
    versions in f64 (``test_spans_rejects`` and
    ``test_sddmm_spans_rejects`` refused them before)."""
    rp, g = _span_ptrs(dev, 3, 100, 3)
    nnz = int(rp[-1, -1])
    idx = torch.randint(0, 50, (nnz,), generator=g, device=dev)
    val = (torch.rand(nnz, generator=g, device=dev) * 2 - 1).to(dt)
    x = torch.randn(50, 16, generator=g, device=dev).to(dt)
    gm = torch.randn(100, 16, generator=g, device=dev).to(dt)
    start, end = rp[:, :-1], rp[:, 1:]
    n = (spmm_spans_cuda.launches, sddmm_spans_cuda.launches)
    out = spmm_spans_cuda(start, end, idx, val, None, x)
    dv = sddmm_spans_cuda(start, end, idx, None, gm, x, out_dtype=dt)
    torch.cuda.synchronize()
    assert (spmm_spans_cuda.launches, sddmm_spans_cuda.launches) == (
        n[0] + 1, n[1] + 1)
    assert out.dtype == dt and dv.dtype == dt
    ref, scale = (spmm_spans_reference(start, end, idx, f(val.double()),
                                       None, f(x.double()))
                  for f in (lambda t: t, torch.abs))
    _close_in_dtype(out, ref, scale)
    ref, scale = (sddmm_spans_reference(start, end, idx, None,
                                        f(gm.double()), f(x.double()),
                                        torch.float64)
                  for f in (lambda t: t, torch.abs))
    _close_in_dtype(dv, ref, scale)


_PACKED_FNS = {"seg2": spmm_seg2, "seg3": spmm_seg3, "seg2split": spmm_split}


@pytest.mark.parametrize("backend", list(_PACKED_FNS))
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_packed_spmm_card_vs_cpu(dev, backend, stream):
    """``spmm_entry``'s toy for each backend: forward, d packed and d x on
    the card against the CPU; launches: spans 1 per forward and the fused
    span backward 1 for d x and d value together, no span SDDMM, per seg2
    call (split: two calls)."""
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
        k = (spmm_spans_cuda.launches, sddmm_spans_cuda.launches,
             spmm_sddmm_spans_cuda.launches)
        out = _PACKED_FNS[backend](plan, s, pv, xx)
        (out * w).sum().backward()
        launches = (spmm_spans_cuda.launches - k[0],
                    sddmm_spans_cuda.launches - k[1],
                    spmm_sddmm_spans_cuda.launches - k[2])
        grads = [t.grad for t in pv] if backend == "seg2split" else [pv.grad]
        runs[where] = ([out.detach().cpu(), xx.grad.cpu()]
                       + [t.cpu() for t in grads], launches)
    calls = 2 if backend == "seg2split" else 1
    assert runs["cuda"][1] == (calls, 0, calls)
    assert runs["cpu"][1] == (0, 0, 0)
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


# ---- the fused CSC backward -------------------------------------------------

FUSED_K = [1, 3, 47, 64, 100, 256, 300, 520]
# (value, x, g, d value): f32; bf16 throughout; bf16 in, f32 out; a mixed
# g and x (summed in f32) with a bf16 d x
FUSED_DTYPES = {"f32": (torch.float32,) * 4,
                "bf16": (torch.bfloat16,) * 4,
                "bf16_in_f32_out": (torch.float32, torch.bfloat16,
                                    torch.bfloat16, torch.float32),
                "mixed_g_x": (torch.bfloat16, torch.float32, torch.bfloat16,
                              torch.bfloat16),
                "f16": (torch.float16,) * 4,
                "f16_x_f32_value": (torch.float32, torch.float16,
                                    torch.float32, torch.float32),
                "f64": (torch.float64,) * 4,
                "f64_value_f16_x": (torch.float64, torch.float16,
                                    torch.float64, torch.float64)}


def _fused_graph(dev, split, M=3000, N=2000):
    """A ``PaddedCOO`` on the card with empty columns, 100 padding entries
    whose cols are poisoned (a read would fault) and, with ``split``, a hub
    column of ``2 * CAP + 5`` edges (pieces and the fold)."""
    g = torch.Generator().manual_seed(11)
    row = torch.randint(0, M, (30_000,), generator=g)
    col = torch.randint(0, N, (30_000,), generator=g)
    col = torch.where(col % 97 == 3, 5, col)            # empty columns
    if split:
        row = torch.cat([row, torch.randint(0, M, (CAP * 2 + 5,),
                                            generator=g)])
        col = torch.cat([col, torch.full((CAP * 2 + 5,), 7)])
    order = torch.argsort(row, stable=True)
    val = torch.rand(row.numel(), generator=g) * 2 - 1
    adj = PaddedCOO.from_arrays(row[order], col[order], val, (M, N),
                                capacity=row.numel() + 100, device=dev)
    adj = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    assert (adj.structure().col_split is not None) == split
    return adj


def _fused(adj, v, g, x, out_dtype):
    s = adj.structure()
    return spmm_sddmm_csc_cuda(s.colptr, s.col_t, s.perm, v, g, x,
                               out_dtype=out_dtype, split=s.col_split,
                               inv_perm=s.inv_perm)


def _pair(adj, v, g, x, out_dtype):
    """What the fused kernel replaces: K2 over the CSR for d value, then
    ``value[perm]`` and K1 over the CSC view for d x."""
    s = adj.structure()
    dv = sddmm_csr_cuda(adj.rowptr(), adj.col, g, x, out_dtype=out_dtype,
                        split=s.row_split)
    vt = None if v is None else v.index_select(0, s.perm)
    return spmm_csr_cuda(s.colptr, s.col_t, vt, g, split=s.col_split), dv


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtypes", list(FUSED_DTYPES))
@pytest.mark.parametrize("K", FUSED_K)
def test_fused_equals_pair_bitwise(dev, K, dtypes, split):
    """The fused CSC backward's d x and d value equal the K2 + K1-over-CSC
    pair's bit for bit (K1's and K2's arithmetic orders), dtypes included;
    one launch counted; d value 0 at padding."""
    adj = _fused_graph(dev, split)
    vdt, xdt, gdt, odt = FUSED_DTYPES[dtypes]
    gen = torch.Generator(device=dev).manual_seed(K)
    x = torch.randn(adj.N, K, generator=gen, device=dev).to(xdt)
    g = torch.randn(adj.M, K, generator=gen, device=dev).to(gdt)
    v = adj.value.to(vdt)
    n = spmm_sddmm_csc_cuda.launches
    got = _fused(adj, v, g, x, odt)
    assert spmm_sddmm_csc_cuda.launches == n + 1
    want = _pair(adj, v, g, x, odt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not got[1][adj.nnz:].any()


@pytest.mark.parametrize("K", [3, 64, 256, 520])
@pytest.mark.parametrize("with_value", [True, False])
def test_fused_vs_plain_f64(dev, K, with_value):
    """f32 (and ``value`` None) against the plain version in f64: each
    entry within SUM_REL of its sum of |terms|; equal to the pair bit for
    bit with ``value`` None too."""
    adj = _fused_graph(dev, True)
    s = adj.structure()
    gen = torch.Generator(device=dev).manual_seed(K + 1)
    x = torch.randn(adj.N, K, generator=gen, device=dev)
    g = torch.randn(adj.M, K, generator=gen, device=dev)
    v = adj.value if with_value else None
    got = _fused(adj, v, g, x, torch.float32)
    for a, b in zip(got, _pair(adj, v, g, x, torch.float32)):
        assert torch.equal(a, b)
    ref, scale = (spmm_sddmm_csc_reference(
        s.colptr, s.col_t, s.perm, None if v is None else f(v), f(g), f(x),
        torch.float64) for f in (torch.Tensor.double,
                                 lambda t: t.double().abs()))
    for a, r, sc in zip(got, ref, scale):
        _close_to_sum(a, r, sc)


@pytest.mark.parametrize("K", [3, 64, 256])
@pytest.mark.parametrize("dtypes", ["f16", "f16_x_f32_value", "f64",
                                    "f64_value_f16_x"])
def test_fused_dtypes_vs_plain_f64(dev, K, dtypes):
    """f16, f64 and their mixed pairs against the plain version in f64,
    split columns included: d x and d value each within their dtype's
    rounding of it."""
    adj = _fused_graph(dev, True)
    s = adj.structure()
    vdt, xdt, gdt, odt = FUSED_DTYPES[dtypes]
    gen = torch.Generator(device=dev).manual_seed(K + 2)
    x = torch.randn(adj.N, K, generator=gen, device=dev).to(xdt)
    g = torch.randn(adj.M, K, generator=gen, device=dev).to(gdt)
    v = adj.value.to(vdt)
    got = _fused(adj, v, g, x, odt)
    ref, scale = (spmm_sddmm_csc_reference(
        s.colptr, s.col_t, s.perm, f(v.double()), f(g.double()),
        f(x.double()), torch.float64) for f in (lambda t: t, torch.abs))
    for a, r, sc in zip(got, ref, scale):
        _close_in_dtype(a, r, sc)


def test_fused_two_launches_equal(dev):
    """Two launches give the same bits (no atomics; a fixed fold), split
    columns and bf16 included; a g off 16-byte alignment takes the scalar
    loads, as K2 then does, and still equals the pair."""
    adj = _fused_graph(dev, True)
    gen = torch.Generator(device=dev).manual_seed(5)
    for dt, K in ((torch.float32, 256), (torch.bfloat16, 64)):
        x = torch.randn(adj.N, K, generator=gen, device=dev).to(dt)
        v = adj.value.to(dt)
        for g in (torch.randn(adj.M, K, generator=gen, device=dev).to(dt),
                  torch.randn(adj.M * K + 1, generator=gen, device=dev)
                  .to(dt)[1:].view(adj.M, K)):     # off 16-byte alignment
            a, b = _fused(adj, v, g, x, dt), _fused(adj, v, g, x, dt)
            want = _pair(adj, v, g, x, dt)
            torch.cuda.synchronize()
            assert all(torch.equal(p, q) for p, q in zip(a, b))
            assert all(torch.equal(p, q) for p, q in zip(a, want))


def _every_batch_graph(dev, M=900, N=150):
    """A ``PaddedCOO`` on the card whose column c holds ``c % 75`` edges
    (every batch size 1-32 as a first batch, and past 32 as a second),
    columns 150 apart from them empty, poisoned padding; no column split."""
    g = torch.Generator().manual_seed(14)
    deg = torch.arange(N) % 75
    col = torch.repeat_interleave(torch.arange(N), deg)
    row = torch.randint(0, M, (col.numel(),), generator=g)
    order = torch.argsort(row, stable=True)
    val = torch.rand(col.numel(), generator=g) * 2 - 1
    adj = PaddedCOO.from_arrays(row[order], col[order], val, (M, N),
                                capacity=col.numel() + 64, device=dev)
    adj = dataclasses.replace(adj, col=torch.where(
        adj.valid_mask(), adj.col, torch.full_like(adj.col, 1 << 30)))
    assert adj.structure().col_split is None
    return adj


@pytest.mark.parametrize("dtypes", ["f32", "bf16", "f16", "f64"])
@pytest.mark.parametrize("K", [3, 47, 256, 520])
def test_fused_every_batch_size(dev, K, dtypes):
    """Columns of 0-74 edges, so every partial batch (1-31 edges: the
    batch exchange over 1, 2, 4 or 8 groups of 4, then an xor butterfly on
    what is left) and full ones: d x and d value equal the pair's bit for
    bit, odd K through the scalar loads, K past ``32 * V * NV`` (520)
    re-walking the edges."""
    adj = _every_batch_graph(dev)
    vdt, xdt, gdt, odt = FUSED_DTYPES[dtypes]
    gen = torch.Generator(device=dev).manual_seed(K + 7)
    x = torch.randn(adj.N, K, generator=gen, device=dev).to(xdt)
    g = torch.randn(adj.M, K, generator=gen, device=dev).to(gdt)
    v = adj.value.to(vdt)
    got = _fused(adj, v, g, x, odt)
    want = _pair(adj, v, g, x, odt)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not got[1][adj.nnz:].any()


def test_fused_offset_views(dev):
    """``value``, ``x`` and ``g`` as views at storage offsets (``x`` and
    ``g`` off 16-byte alignment: the scalar loads) and ``value`` a strided
    view: equal to the pair bit for bit; the relays take any view."""
    adj = _fused_graph(dev, True)
    gen = torch.Generator(device=dev).manual_seed(9)
    M, N, K = adj.M, adj.N, 64
    x = torch.randn(N * K + 1, generator=gen, device=dev)[1:].view(N, K)
    g = torch.randn(M * K + 3, generator=gen, device=dev)[3:].view(M, K)
    cap = adj.value.numel()
    for v in (torch.randn(cap + 5, generator=gen, device=dev)[5:],
              torch.randn(2 * cap, generator=gen, device=dev)[::2]):
        got = _fused(adj, v, g, x, torch.float32)
        want = _pair(adj, v, g, x, torch.float32)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtypes", list(FUSED_DTYPES))
@pytest.mark.parametrize("K", [5, 300])
def test_fused_launch_alone_vs_plain(dev, K, dtypes):
    """The launch alone (``csc_order_cuda``: values and d value in CSC
    order, split columns) in every dtype against its plain version
    (``csc_order_reference``) run in f64 on the card: each entry within its
    dtype's rounding of the sum; and the routed call's d value is the
    launch's read back through ``inv_perm``."""
    from paddle_sparse_tpu_torch.ops.kernels.spmm_sddmm_cuda import (
        csc_order_cuda, csc_order_reference)
    adj = _fused_graph(dev, True)
    s = adj.structure()
    vdt, xdt, gdt, odt = FUSED_DTYPES[dtypes]
    gen = torch.Generator(device=dev).manual_seed(K + 3)
    x = torch.randn(adj.N, K, generator=gen, device=dev).to(xdt)
    g = torch.randn(adj.M, K, generator=gen, device=dev).to(gdt)
    v_t = adj.value.to(vdt).index_select(0, s.perm)
    got = csc_order_cuda(s.colptr, s.col_t, v_t, g, x, odt, s.col_split)
    ref, scale = (csc_order_reference(
        s.colptr, s.col_t, f(v_t.double()), f(g.double()), f(x.double()),
        torch.float64) for f in (lambda t: t, torch.abs))
    for a, r, sc in zip(got, ref, scale):
        _close_in_dtype(a, r, sc)
    routed = _fused(adj, adj.value.to(vdt), g, x, odt)
    torch.cuda.synchronize()
    assert torch.equal(routed[0], got[0])
    assert torch.equal(routed[1], got[1].index_select(0, s.inv_perm))


@pytest.mark.parametrize("layers", [2, 3])
def test_gcn_step_launches(dev, layers):
    """A GCN train step with ``value`` requiring grad, as phase 5 of
    ``chip_smoke.py`` runs it at scale: per step K1 once per layer
    (forward), K2 once (the first layer's d value: its input needs no
    grad) and the fused CSC backward once per later layer; no fold."""
    from paddle_sparse_tpu_torch import init_gcn
    _, adj, x, y = model_entry("gcn", dev)
    model = init_gcn(torch.Generator().manual_seed(0), 32, 64, 8,
                     num_layers=layers, device=dev)
    adj.value.requires_grad_()
    for _ in range(2):
        b = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
             spmm_sddmm_csc_cuda.launches, fold_pieces_cuda.launches)
        adj.value.grad = None
        train_step(model, adj, x, y, 0.1)
        torch.cuda.synchronize()
        assert (spmm_csr_cuda.launches - b[0], sddmm_csr_cuda.launches - b[1],
                spmm_sddmm_csc_cuda.launches - b[2],
                fold_pieces_cuda.launches - b[3]) == (layers, 1,
                                                      layers - 1, 0)
        assert adj.value.grad is not None and bool(
            torch.isfinite(adj.value.grad).all())


# ---- the fused span backward of the packed SpMMs ---------------------------

SPANS_FUSED_K = [1, 3, 47, 64, 256, 300, 520]
# (packed value, x, g, stream): f32; bf16 throughout; the bf16 stream (f32
# operands gathered in bf16); bf16 x and g with f32 values (product f32, g
# read as bf16 by the pair)
SPANS_FUSED_DTYPES = {
    "f32": (torch.float32, torch.float32, torch.float32, "f32"),
    "bf16": (torch.bfloat16, torch.bfloat16, torch.bfloat16, "f32"),
    "bf16_stream": (torch.float32, torch.float32, torch.float32, "bf16"),
    "bf16_x_f32_value": (torch.float32, torch.bfloat16, torch.bfloat16,
                         "f32")}


def _spans_fused_graph(dev, split, M=3000, N=2000):
    """A seg2 plan and structure on the card (S and S_t > 1) over a graph
    with empty rows and columns and, with ``split``, an x row (column 7)
    of ``2 * CAP + 5`` edges, so the transpose has pieces and a fold."""
    g = torch.Generator().manual_seed(12)
    row = torch.randint(0, M, (30_000,), generator=g)
    col = torch.randint(0, N, (30_000,), generator=g)
    col = torch.where(col % 97 == 3, 5, col)            # empty columns
    row = torch.where(row % 89 == 4, 6, row)            # empty rows
    if split:
        row = torch.cat([row, torch.randint(0, M, (CAP * 2 + 5,),
                                            generator=g)])
        col = torch.cat([col, torch.full((CAP * 2 + 5,), 7)])
    order = torch.argsort(row, stable=True)
    row, col = row[order].to(dev), col[order].to(dev)
    plan, s = make_seg2_plan(row, col, M, N, feat_dim=64, sr=256)
    assert plan.S > 1 and plan.S_t > 1
    assert (s.split_t is not None) == split
    val = torch.rand(row.numel(), generator=torch.Generator(
        device=dev).manual_seed(13), device=dev) * 2 - 1
    return plan, s, pack_values(s, val)


def _spans_fused(plan, s, v, g, x, stream):
    """``(d value, d x)`` through the backward's own fused pass
    (``spmm_seg2.fused_span_backward``: the values relayed into the
    transpose's order, one launch, ``d value`` read back through
    ``relay_tf``); with ``v`` None (ones) the same form around the
    wrapper."""
    t = span_layouts(plan, s)[1]
    if v is not None:
        return fused_span_backward(t, s.relay_ft, s.relay_tf, v, x, g,
                                   stream)
    pdt = product_dtype(None, g, stream)
    d_x, dv_t = spmm_sddmm_spans_cuda(t.start, t.end, t.col, None, t.base,
                                      g.to(pdt), x.to(pdt),
                                      dx_dtype=g.dtype, split=t.split)
    return dv_t.index_select(0, s.relay_tf), d_x.to(x.dtype)


def _spans_pair(plan, s, v, g, x, stream):
    """What the fused span pass replaces, as ``_PackedSpmm.backward`` ran
    it: the span SDDMM over the forward layout for ``d value``, the spans
    SpMM over the transpose on ``packed[relay]`` for ``d x`` (a bf16 g
    read as it is): ``(d value, d x)``."""
    fwd, t = span_layouts(plan, s)
    pdt = product_dtype(v, g, stream)
    vt = None if v is None else v.index_select(0, s.relay_ft)
    src = g if g.dtype in (pdt, torch.bfloat16) else g.to(pdt)
    d_x = spmm_spans_cuda(t.start, t.end, t.col, vt, t.base, src,
                          out_dtype=g.dtype, split=t.split).to(x.dtype)
    d_v = sddmm_spans_cuda(fwd.start, fwd.end, fwd.col, fwd.base, g.to(pdt),
                           x.to(pdt), split=fwd.split)
    return d_v if v is None else d_v.to(v.dtype), d_x


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("dtypes", list(SPANS_FUSED_DTYPES))
@pytest.mark.parametrize("K", SPANS_FUSED_K)
def test_spans_fused_equals_pair_bitwise(dev, K, dtypes, split):
    """The backward's fused span pass gives the pair's d value and d x bit
    for bit (the span SDDMM's and the spans SpMM's arithmetic orders),
    dtypes included; one launch counted; the fold runs exactly over split
    x rows."""
    plan, s, packed = _spans_fused_graph(dev, split)
    vdt, xdt, gdt, stream = SPANS_FUSED_DTYPES[dtypes]
    gen = torch.Generator(device=dev).manual_seed(K)
    x = torch.randn(plan.num_cols, K, generator=gen, device=dev).to(xdt)
    g = torch.randn(plan.num_rows, K, generator=gen, device=dev).to(gdt)
    v = packed.to(vdt)
    n, folds = spmm_sddmm_spans_cuda.launches, fold_pieces_cuda.launches
    got = _spans_fused(plan, s, v, g, x, stream)
    assert spmm_sddmm_spans_cuda.launches == n + 1
    assert fold_pieces_cuda.launches == folds + split
    want = _spans_pair(plan, s, v, g, x, stream)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("K", [3, 64, 256, 520])
@pytest.mark.parametrize("with_value", [True, False])
def test_spans_fused_vs_plain_f64(dev, K, with_value):
    """f32 (and ``value`` None) against the plain version in f64, split x
    rows included: each entry within SUM_REL of its sum of |terms|; equal
    to the pair bit for bit with ``value`` None too."""
    plan, s, packed = _spans_fused_graph(dev, True)
    gen = torch.Generator(device=dev).manual_seed(K + 1)
    x = torch.randn(plan.num_cols, K, generator=gen, device=dev)
    g = torch.randn(plan.num_rows, K, generator=gen, device=dev)
    v = packed if with_value else None
    got = _spans_fused(plan, s, v, g, x, "f32")
    for a, b in zip(got, _spans_pair(plan, s, v, g, x, "f32")):
        assert torch.equal(a, b)
    t = span_layouts(plan, s)[1]
    vt = None if v is None else v.index_select(0, s.relay_ft)
    ref, scale = (spmm_sddmm_spans_reference(
        t.start, t.end, t.col, None if vt is None else f(vt), t.base, f(g),
        f(x), out_dtype=torch.float64)
        for f in (torch.Tensor.double, lambda t: t.double().abs()))
    for a, r, sc in zip(got, (ref[1].index_select(0, s.relay_tf), ref[0]),
                        (scale[1].index_select(0, s.relay_tf), scale[0])):
        _close_to_sum(a, r, sc)


def test_spans_fused_two_launches_equal(dev):
    """Two launches give the same bits (no atomics; a fixed fold), split
    x rows and bf16 included; a g off 16-byte alignment takes the scalar
    loads, as the span SDDMM then does, and still equals the pair."""
    plan, s, packed = _spans_fused_graph(dev, True)
    gen = torch.Generator(device=dev).manual_seed(5)
    M, N = plan.num_rows, plan.num_cols
    for dt, K in ((torch.float32, 256), (torch.bfloat16, 64)):
        x = torch.randn(N, K, generator=gen, device=dev).to(dt)
        v = packed.to(dt)
        for g in (torch.randn(M, K, generator=gen, device=dev).to(dt),
                  torch.randn(M * K + 1, generator=gen, device=dev)
                  .to(dt)[1:].view(M, K)):         # off 16-byte alignment
            a = _spans_fused(plan, s, v, g, x, "f32")
            b = _spans_fused(plan, s, v, g, x, "f32")
            want = _spans_pair(plan, s, v, g, x, "f32")
            torch.cuda.synchronize()
            assert all(torch.equal(p, q) for p, q in zip(a, b))
            assert all(torch.equal(p, q) for p, q in zip(a, want))


@pytest.mark.parametrize("bad", ["f64", "noncontig", "device", "x_rows",
                                 "col_float", "value_shape", "dx_f16"])
def test_spans_fused_rejects(dev, bad):
    """The wrapper raises on what the kernel does not take, and launches
    nothing then."""
    plan, s, packed = _spans_fused_graph(dev, False)
    t = span_layouts(plan, s)[1]
    col = t.col
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(plan.num_cols, 16, generator=gen, device=dev)
    g = torch.randn(plan.num_rows, 16, generator=gen, device=dev)
    v, kw = packed.index_select(0, s.relay_ft), {}
    if bad == "f64":
        x = x.double()
    elif bad == "noncontig":
        g = torch.randn(16, plan.num_rows, device=dev).t()
    elif bad == "device":
        g = g.cpu()
    elif bad == "x_rows":
        x = x[:-1]
    elif bad == "col_float":
        col = col.float()
    elif bad == "value_shape":
        v = v[:-1]
    else:
        kw["dx_dtype"] = torch.float16
    before = spmm_sddmm_spans_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        spmm_sddmm_spans_cuda(t.start, t.end, col, v, t.base, g, x, **kw)
    assert spmm_sddmm_spans_cuda.launches == before


# ---- SpMM mean/min/max and the other model families ------------------------

def _hub_graph(M=3000, N=3000, hub=CAP * 2 + 5, seed=6, ints=False):
    """COO with a hub row (7) and a hub column (11) past ``CAP``, empty
    rows, and (with ``ints``) small-integer values and x: tied products."""
    g = torch.Generator().manual_seed(seed)
    row = torch.cat([torch.full((hub,), 7), torch.randint(0, M, (20_000,),
                                                          generator=g),
                     torch.arange(hub) % M])
    col = torch.cat([torch.randint(0, N, (hub,), generator=g),
                     torch.randint(0, N, (20_000,), generator=g),
                     torch.full((hub,), 11)])
    keep = (row != 0) & (row != M - 1) & (row != 500)      # empty rows
    row, col = row[keep], col[keep]
    order = torch.argsort(row, stable=True)
    row, col = row[order], col[order]
    if ints:
        val = torch.randint(-2, 3, (row.numel(),), generator=g).float()
        x = torch.randint(-2, 3, (N, 24), generator=g).float()
    else:
        val = torch.rand(row.numel(), generator=g) * 2 - 1
        x = torch.randn(N, 48, generator=g)
    val[row == 3] = -val[row == 3].abs() - 0.5      # a row all negative ...
    x = torch.where(torch.isin(torch.arange(N), col[row == 3])[:, None],
                    x.abs() + 1, x)                 # ... over positive x
    return row, col, val, x, M, N


def test_spmm_mean_kernels_vs_plain_f64(dev):
    """Mean forward, d value and d x through K1 and K2 (split rows and
    columns: pieces and the fold) against the plain path in f64 on the
    CPU, each entry within SUM_REL of its sum of |terms|; padding gets no
    grad; one K1 forward and one fused CSC backward for d x and d value,
    the fold after each (split rows, split columns)."""
    row, col, val, x, M, N = _hub_graph()
    w = torch.randn(M, x.shape[1], generator=torch.Generator().manual_seed(1))
    runs = {}
    for where, f in (("cuda", lambda t: t), ("f64", torch.Tensor.double),
                     ("abs", lambda t: t.double().abs())):
        dev_ = "cuda" if where == "cuda" else "cpu"
        adj = PaddedCOO.from_arrays(row, col, f(val), (M, N),
                                    capacity=row.numel() + 100, device=dev_)
        assert adj.row_split() is not None
        v = adj.value.clone().requires_grad_()
        xx = f(x).to(dev_, copy=True).requires_grad_()
        k1, k2 = spmm_csr_cuda.launches, sddmm_csr_cuda.launches
        fused = spmm_sddmm_csc_cuda.launches
        folds = fold_pieces_cuda.launches
        out = adj.with_value(v).spmm(xx, "mean")
        (out * f(w).to(dev_)).sum().backward()
        if where == "cuda":
            assert spmm_csr_cuda.launches - k1 == 1
            assert sddmm_csr_cuda.launches - k2 == 0
            assert spmm_sddmm_csc_cuda.launches - fused == 1
            assert fold_pieces_cuda.launches - folds == 2   # both split
            assert not v.grad[adj.nnz:].any()
        runs[where] = [out.detach().cpu(), v.grad.cpu(), xx.grad.cpu()]
    for c, h, a in zip(runs["cuda"], runs["f64"], runs["abs"]):
        _close_to_sum(c, h, a)


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("ints", [False, True])
def test_spmm_min_max_card_vs_cpu(dev, reduce, ints):
    """Min and max on the card (plain torch, no kernel) against the CPU:
    padding, empty rows, a row of negative products, a hub row, and with
    small integers many ties, whose gradient is split evenly."""
    row, col, val, x, M, N = _hub_graph(ints=ints)
    w = torch.randn(M, x.shape[1], generator=torch.Generator().manual_seed(2))
    runs = {}
    for where in ("cuda", "cpu"):
        adj = PaddedCOO.from_arrays(row, col, val, (M, N),
                                    capacity=row.numel() + 100, device=where)
        v = adj.value.clone().requires_grad_()
        xx = x.to(where, copy=True).requires_grad_()
        out = adj.with_value(v).spmm(xx, reduce)
        (out * w.to(where)).sum().backward()
        runs[where] = [out.detach().cpu(), v.grad.cpu(), xx.grad.cpu()]
    out = runs["cpu"][0]
    assert not out[[0, 500, M - 1]].any()
    if reduce == "max":
        assert (out[3] < 0).all()
    for c, h in zip(runs["cuda"], runs["cpu"]):
        torch.testing.assert_close(c, h, **F32)


@pytest.mark.parametrize("kind", MODELS)
def test_model_toy_card_vs_cpu(dev, kind):
    """Each family's toy set-up: forward, loss, every parameter's grad and
    d value (GAT reads no adjacency values) on the card against the CPU,
    then 5 SGD steps."""
    runs = {}
    for where in ("cuda", "cpu"):
        model, adj, x, y = model_entry(kind, where)
        adj.value.requires_grad_()
        with torch.inference_mode():
            out = model(adj, x).cpu()
        loss = gcn_loss(model, adj, x, y)
        loss.backward()
        grads = {n: p.grad.cpu().clone() for n, p in model.named_parameters()}
        dv = None if adj.value.grad is None else adj.value.grad.cpu().clone()
        losses = [float(train_step(model, adj, x, y, 0.05)) for _ in range(5)]
        runs[where] = (out, float(loss.detach()), grads, dv, losses)
    (oc, lc, gc, dc, sc), (oh, lh, gh, dh, sh) = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(oc, oh, **F32)
    assert abs(lc - lh) < 1e-5
    assert gc.keys() == gh.keys()
    for name in gc:
        torch.testing.assert_close(gc[name], gh[name], **F32, msg=name)
    assert (dc is None) == (dh is None) == (kind == "gat")
    if dc is not None:
        torch.testing.assert_close(dc, dh, **F32)
    torch.testing.assert_close(torch.tensor(sc), torch.tensor(sh), **F32)
    assert sc[-1] < sc[0]


def test_model_launches_per_step(dev):
    """One train step each: GAT runs K1 and the fused CSC backward (d hw and
    d att) once per head and layer; GraphSAGE and GIN K1 for each layer's
    forward, K2 for the first layer's d value (its input needs no grad) and
    the fused CSC backward for each later layer's d x and d value; APPNP
    K1 and the fused CSC backward per propagation step."""
    heads = 2 + 1                           # GAT: 2 heads, then 1 output
    want = {"sage": (2, 1, 1), "gin": (2, 1, 1), "appnp": (5, 0, 5),
            "gat": (heads, 0, heads)}           # toys of 2 layers, k = 5
    for kind, counts in want.items():
        model, adj, x, y = model_entry(kind, "cuda")
        if kind != "gat":
            adj.value.requires_grad_()
        b = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
             spmm_sddmm_csc_cuda.launches)
        train_step(model, adj, x, y, 0.1)
        torch.cuda.synchronize()
        assert (spmm_csr_cuda.launches - b[0], sddmm_csr_cuda.launches - b[1],
                spmm_sddmm_csc_cuda.launches - b[2]) == counts, kind


# ---- GAT's attention kernels (csrc/gat_attention.cu) ------------------------
# The node scores and each row's edge softmax on the card against the plain
# version (``gat_attention_reference``, run on the card): f32 within
# ``rtol=1e-5, atol=1e-6`` (scores summed in another order, the sums of
# exp in another order), f64 within 1e-12.

GAT_N = 3000


def _gat_graph(dev, kind, seed=0):
    """A square ``PaddedCOO`` on ``dev``, padded past its entries, no
    values: ``uniform`` rows of 0-90 entries (empty rows; rows past 64 take
    the online sweep) and no piece table; ``zipf`` the same with a hub row
    of ``2 * CAP + 5`` entries and rows of ``CAP`` and ``CAP + 1``, so rows
    8 (one piece) and 7, 9 (split) are cut by the table."""
    g = torch.Generator().manual_seed(seed)
    deg = torch.randint(0, 91, (GAT_N,), generator=g)
    deg[[0, 500, GAT_N - 1]] = 0
    if kind == "zipf":
        deg[7], deg[8], deg[9] = 2 * CAP + 5, CAP, CAP + 1
    row = torch.repeat_interleave(torch.arange(GAT_N), deg)
    col = torch.randint(0, GAT_N, (row.numel(),), generator=g)
    adj = PaddedCOO.from_arrays(row, col, None, (GAT_N, GAT_N),
                                capacity=row.numel() + 37, device=dev)
    assert (adj.row_split() is None) == (kind == "uniform")
    return adj


def _gat_inputs(dev, H, D, dtype=torch.float32, seed=1):
    """``hw`` (N, H, D) and ``a_src``, ``a_dst`` (H, D): scores of about
    N(0, 4), so each row's softmax is far from flat."""
    g = torch.Generator().manual_seed(seed)
    hw = torch.randn(GAT_N, H, D, generator=g, dtype=dtype)
    a = torch.randn(2, H, D, generator=g, dtype=dtype) * 2 / D ** 0.5
    return hw.to(dev), a[0].to(dev), a[1].to(dev)


def _gat_args(adj, hw, a_src, a_dst):
    return (adj.rowptr(), adj.col, hw, a_src, a_dst, 0.2, adj.row_split())


@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("H,D", [(1, 47), (4, 47), (1, 128), (4, 128)])
def test_gat_attention_kernels_vs_plain(dev, kind, H, D):
    """Weights and scores against the plain version; padding entries 0;
    the weights an (E, H) view of head-major storage; two launches equal
    bit for bit; one count a call."""
    adj = _gat_graph(dev, kind)
    hw, a_src, a_dst = _gat_inputs(dev, H, D)
    before = gat_attention_cuda.launches
    got = gat_attention_cuda(*_gat_args(adj, hw, a_src, a_dst))
    assert gat_attention_cuda.launches - before == 1
    want = gat_attention_reference(adj, hw, a_src, a_dst, 0.2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    att = got[0]
    assert att.shape == (adj.capacity, H)
    assert att.stride() == (1, adj.capacity) and att.t().is_contiguous()
    assert not att[adj.nnz:].any()
    again = gat_attention_cuda(*_gat_args(adj, hw, a_src, a_dst))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("H", [2, 3, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gat_attention_head_groups_and_f64(dev, H, dtype):
    """Head counts other than 4, which run in groups of four and then one
    head at a time (2 = 1 + 1, 3 = 1 + 1 + 1, 8 = 4 + 4, 9 = 4 + 4 + 1),
    split rows, f32 and f64."""
    adj = _gat_graph(dev, "zipf", seed=2)
    hw, a_src, a_dst = _gat_inputs(dev, H, 24, dtype)
    got = gat_attention_cuda(*_gat_args(adj, hw, a_src, a_dst))
    want = gat_attention_reference(adj, hw, a_src, a_dst, 0.2)
    tol = (dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32
           else dict(rtol=1e-12, atol=1e-14))
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, **tol)


def test_gat_attention_nonfinite_rows(dev):
    """Scores of +inf, NaN and -inf at three nodes, so that rows in the
    register, online and split paths hold a +inf or a NaN logit, and the
    rows of the -inf node (one of them split) only -inf logits: the plain
    version's weights (NaN where it gives NaN, 0 where its max was -inf)."""
    adj = _gat_graph(dev, "zipf", seed=3)
    hw, a_src, a_dst = _gat_inputs(dev, 4, 16)
    a_src[:, 0] = a_src[:, 0].abs() + 0.1
    a_dst[:, 0] = a_dst[:, 0].abs() + 0.1
    rp = adj.rowptr()
    n_inf = int(adj.col[int(rp[7]) + 5])           # in the hub row
    n_nan = int(adj.col[int(rp[8]) + 3])           # in the row of CAP
    hw[n_inf, :, 0] = float("inf")
    hw[n_nan, :, 0] = float("nan")
    hw[[9, 10], :, 0] = float("-inf")              # rows of -inf logits
    got = gat_attention_cuda(*_gat_args(adj, hw, a_src, a_dst))[0]
    want = gat_attention_reference(adj, hw, a_src, a_dst, 0.2)[0]
    assert want.isnan().any() and (want == 0).any()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def test_gat_attention_launches_per_layer(dev):
    """A forward and a train step of the toy GAT (2 layers): one call of
    the pair a layer each, K1 once a head as before."""
    model, adj, x, y = model_entry("gat", "cuda")
    b = (gat_attention_cuda.launches, spmm_csr_cuda.launches)
    with torch.no_grad():
        model(adj, x)
    train_step(model, adj, x, y, 0.1)
    torch.cuda.synchronize()
    heads = 2 + 1
    assert (gat_attention_cuda.launches - b[0],
            spmm_csr_cuda.launches - b[1]) == (2 * 2, 2 * heads)


def test_gat_pyg_split_rows_card_vs_cpu(dev):
    """PyG's stacking (3 layers of 4 heads, the output heads averaged, bias
    and skips) on the graph with split rows: forward, loss and every
    parameter's grad on the card against the CPU."""
    from paddle_sparse_tpu_torch import init_gat
    runs = {}
    g = torch.Generator().manual_seed(4)
    x = torch.randn(GAT_N, 16, generator=g)
    y = torch.randint(0, 5, (GAT_N,), generator=g)
    for where in ("cuda", "cpu"):
        model = init_gat(torch.Generator().manual_seed(0), 16, 8, 5,
                         heads=4, num_layers=3, device=where, out_heads=4,
                         bias=True, skip=True)
        adj = _gat_graph(where, "zipf")
        xx, yy = x.to(where), y.to(where)
        with torch.no_grad():
            out = model(adj, xx).cpu()
        loss = gcn_loss(model, adj, xx, yy)
        loss.backward()
        runs[where] = (out, float(loss.detach()),
                       {n: p.grad.cpu() for n, p in model.named_parameters()})
    (oc, lc, gc), (oh, lh, gh) = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(oc, oh, **F32)
    assert abs(lc - lh) < 1e-5
    assert gc.keys() == gh.keys()
    for name in gc:
        torch.testing.assert_close(gc[name], gh[name], **F32, msg=name)


# ---- K1 on strided views: GAT's heads in place ------------------------------
# Each head's launch reads ``hw[:, k]`` (row stride H * D) and writes
# ``out[:, k]`` of one (M, H, D) output at its row stride: bit for bit the
# launch on contiguous copies, which sums each column in the same order.

def _strided_k1(adj, value, hw):
    """Per head: the launch on the views, and on contiguous copies."""
    rowptr, split = adj.rowptr(), adj.row_split()
    out = torch.full((adj.M,) + tuple(hw.shape[1:]), float("nan"),
                     dtype=torch.promote_types(value.dtype, hw.dtype),
                     device=hw.device)
    want = []
    for k in range(hw.shape[1]):
        got = spmm_csr_cuda(rowptr, adj.col, value[:, k], hw[:, k],
                            split=split, out=out[:, k])
        assert got.data_ptr() == out[:, k].data_ptr()
        want.append(spmm_csr_cuda(rowptr, adj.col,
                                  value[:, k].contiguous(),
                                  hw[:, k].contiguous(), split=split))
    return out, torch.stack(want, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["uniform", "zipf"])
@pytest.mark.parametrize("H,D", [(4, 128), (4, 47)])
def test_strided_k1_equals_contiguous(dev, H, D, kind, dtype):
    """4 x 128 at row stride 512 (the 16-byte path), 4 x 47 at row stride
    188 (odd heads misaligned: the scalar path); ``zipf`` with split rows
    (the workspace and the fold pass into the strided output); f32 and
    bf16 (weights, operand and output). Each launch counted once, and
    those on views as strided; against plain f64 too."""
    adj = _gat_graph(dev, kind)
    g = torch.Generator().manual_seed(5)
    hw = torch.randn(GAT_N, H, D, generator=g).to(dev, dtype)
    value = torch.rand(H, adj.capacity, generator=g).to(dev, dtype).t()
    b = (spmm_csr_cuda.launches, spmm_csr_cuda.strided,
         fold_pieces_cuda.launches)
    got, want = _strided_k1(adj, value, hw)
    torch.cuda.synchronize()
    assert (spmm_csr_cuda.launches - b[0], spmm_csr_cuda.strided - b[1],
            fold_pieces_cuda.launches - b[2]) == (
                2 * H, H, 2 * H * (kind == "zipf"))
    assert got.dtype == dtype
    assert torch.equal(got, want)
    ref = torch.stack([_ref(adj.rowptr(), adj.col, value[:, k], hw[:, k])
                       for k in range(H)], 1)
    torch.testing.assert_close(got.double(), ref,
                               **(F32 if dtype == torch.float32 else BF16))


def test_strided_k1_vector_path_by_strides(dev):
    """The kernel's instantiation under the profiler: V = 4 for f32 rows
    of 128 at row stride 512 (16-byte aligned bases and rows), V = 1 for a
    row stride of 130 (rows misaligned, though K = 128 divides)."""
    from torch.profiler import ProfilerActivity, profile
    adj = _gat_graph(dev, "uniform")
    g = torch.Generator().manual_seed(6)
    value = torch.rand(adj.capacity, generator=g).to(dev)
    names = {}
    for ld in (512, 130):
        x = torch.randn(GAT_N, ld, generator=g).to(dev)[:, :128]
        out = torch.empty(GAT_N, ld, device=dev)[:, :128]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spmm_csr_cuda(adj.rowptr(), adj.col, value, x, out=out)
            torch.cuda.synchronize()
        names[ld] = [e.key for e in prof.key_averages()
                     if "spmm_spans_kernel" in e.key]
        torch.testing.assert_close(
            out, spmm_csr_cuda(adj.rowptr(), adj.col, value, x.contiguous()),
            rtol=0, atol=0)
    assert len(names[512]) == 1 and "<float, float, 4," in names[512][0]
    assert len(names[130]) == 1 and "<float, float, 1," in names[130][0]


@pytest.mark.parametrize("bad", ["overlap", "alias", "x_last_stride",
                                 "out_last_stride", "x_rows"])
def test_strided_k1_refuses(dev, bad):
    """An ``out`` whose memory meets ``x``'s, a last stride other than 1
    (``x`` or ``out``), rows of ``x`` closer than K."""
    rowptr, col, value, g = _csr(dev)
    hw = torch.randn(300, 4, 8, generator=g, device=dev)
    x, out = hw[:, 1], torch.empty(500, 4, 8, device=dev)[:, 0]
    if bad == "overlap":
        x = torch.randn(500, 4, 8, generator=g, device=dev)[:, 1, :]
        out = x.as_strided((500, 8), (32, 1), x.storage_offset() + 8)
    elif bad == "alias":
        x = out = torch.randn(500, 4, 8, generator=g, device=dev)[:, 1]
    elif bad == "x_last_stride":
        x = torch.randn(300, 16, generator=g, device=dev)[:, ::2]
    elif bad == "out_last_stride":
        out = torch.empty(500, 16, device=dev)[:, ::2]
    else:
        x = torch.randn(300 * 4 + 8, generator=g, device=dev).as_strided(
            (300, 8), (4, 1))
    with pytest.raises(ValueError):
        spmm_csr_cuda(rowptr, col, value, x, out=out)


def test_gat_heads_in_place_equal_the_stack(dev, monkeypatch):
    """PyG's stacking (3 layers of 4 heads, the output heads averaged,
    bias, skips) on split rows: the forward bit for bit as the former
    stack of per-head SpMMs gives it, and its 12 K1 launches all strided
    (the stack's none); every parameter's grad within F32 of the stack's
    (the attention's backward sums columns with ``index_add_``, whose
    atomic adds take another order on each run)."""
    from paddle_sparse_tpu_torch import init_gat
    adj = _gat_graph(dev, "zipf")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(GAT_N, 16, generator=g).to(dev)
    w = torch.randn(GAT_N, 5, generator=g).to(dev)
    model = init_gat(torch.Generator().manual_seed(0), 16, 8, 5, heads=4,
                     num_layers=3, device=dev, out_heads=4, bias=True,
                     skip=True)
    runs = []
    for patch in (False, True):
        if patch:
            monkeypatch.setattr(PaddedCOO, "spmm",
                                stacked_spmm(PaddedCOO.spmm))
        b = (spmm_csr_cuda.launches, spmm_csr_cuda.strided)
        with torch.no_grad():
            out = model(adj, x)
        torch.cuda.synchronize()
        counts = (spmm_csr_cuda.launches - b[0],
                  spmm_csr_cuda.strided - b[1])
        model.zero_grad(set_to_none=True)
        (model(adj, x) * w).sum().backward()
        runs.append((out, counts,
                     {n: p.grad for n, p in model.named_parameters()}))
    (got, got_n, got_g), (want, want_n, want_g) = runs
    assert (got_n, want_n) == ((12, 12), (12, 0))
    assert torch.equal(got, want)
    for name in got_g:
        torch.testing.assert_close(got_g[name], want_g[name], **F32,
                                   msg=name)


def test_strided_counter_per_model_forward(dev):
    """One forward: PyG's GAT (3 layers x 4 heads) adds 12 to
    ``spmm_csr_cuda.strided``, the toy GCN, GraphSAGE and APPNP 0."""
    from paddle_sparse_tpu_torch import init_gat
    adj = _gat_graph(dev, "uniform")
    x = torch.randn(GAT_N, 16, generator=torch.Generator().manual_seed(7))
    runs = {"gat": (init_gat(torch.Generator().manual_seed(0), 16, 8, 5,
                             heads=4, num_layers=3, device=dev, out_heads=4,
                             bias=True, skip=True), adj, x.to(dev))}
    for kind in ("gcn", "sage", "appnp"):
        model, a, xx, _ = model_entry(kind, "cuda")
        runs[kind] = (model, a, xx)
    added = {}
    for kind, (model, a, xx) in runs.items():
        b = spmm_csr_cuda.strided
        with torch.no_grad():
            model(a, xx)
        added[kind] = spmm_csr_cuda.strided - b
    assert added == {"gat": 12, "gcn": 0, "sage": 0, "appnp": 0}


# ---- the eager facade on the card ------------------------------------------

def _facade_pipeline(where):
    """``facade_entry``'s graph through ``gcn_norm`` and ``A @ (A @ x)``
    with ``value`` and ``x`` requiring grad: the normalized values, the
    output, d value and d x, on the CPU; and the launches of the card's
    kernels (CSC views built) between the forward and the end of the
    second backward."""
    from paddle_sparse_tpu_torch import SparseStorage, facade_entry, gcn_norm
    adj, x = facade_entry(where)
    norm = gcn_norm(adj).requires_grad_()
    x = x.clone().requires_grad_()
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(
        x.device)
    counts = []
    for _ in range(2):
        norm.storage.value().grad = x.grad = None
        SparseStorage.csc_builds = 0
        b = (spmm_csr_cuda.launches, sddmm_csr_cuda.launches,
             spmm_sddmm_csc_cuda.launches, fold_pieces_cuda.launches)
        out = norm @ x
        (out * w).sum().backward()
        if where == "cuda":
            torch.cuda.synchronize()
        counts.append((spmm_csr_cuda.launches - b[0],
                       sddmm_csr_cuda.launches - b[1],
                       spmm_sddmm_csc_cuda.launches - b[2],
                       fold_pieces_cuda.launches - b[3],
                       SparseStorage.csc_builds))
    res = [norm.storage.value().detach(), out.detach(),
           norm.storage.value().grad, x.grad]
    return [t.cpu() for t in res], counts


def test_facade_gcn_norm_card_vs_cpu(dev):
    """PyG's gcn_norm on the facade and ``A @ x`` with its grads: the card
    against the CPU; each forward+backward launches K1 once (forward) and
    the fused CSC backward once (d x and d value), no fold; the CSC view is
    built by the first backward only, and the CPU launches no kernel."""
    card, card_counts = _facade_pipeline("cuda")
    cpu, cpu_counts = _facade_pipeline("cpu")
    for c, h in zip(card, cpu):
        torch.testing.assert_close(c, h, **F32)
    assert card_counts == [(1, 0, 1, 0, 1), (1, 0, 1, 0, 0)]
    assert cpu_counts == [(0, 0, 0, 0, 1), (0, 0, 0, 0, 0)]


def test_facade_cached_structure_on_the_card(dev):
    """The storage's kernel caches live on the card in int32, with the piece
    table of a row past ``CAP``; ``A @ x`` equals ``PaddedCOO.spmm`` over
    the same entries bit for bit, and the plain version in f64 within
    ``SUM_REL`` of each entry's sum of |terms| (the split row sums 3,072
    terms)."""
    from paddle_sparse_tpu_torch import SparseTensor
    g = torch.Generator(device=dev).manual_seed(4)
    row = torch.cat([torch.full((3 * CAP,), 5, device=dev),
                     torch.randint(0, 300, (5000,), generator=g, device=dev)])
    col = torch.randint(0, 200, (row.numel(),), generator=g, device=dev)
    A = SparseTensor(row=row, col=col,
                     value=torch.rand(row.numel(), generator=g, device=dev),
                     sparse_sizes=(300, 200))
    x = torch.randn(200, 64, generator=g, device=dev)
    rowptr, col32, split = A.storage.kernel_csr()
    assert rowptr.is_cuda and rowptr.dtype == col32.dtype == torch.int32
    assert split is not None
    b = fold_pieces_cuda.launches
    out = A @ x
    torch.cuda.synchronize()
    assert fold_pieces_cuda.launches == b + 1
    assert torch.equal(out, A.to_padded().spmm(x))
    value = A.storage.value()
    _close_to_sum(out, _ref(rowptr, col32, value, x),
                  _ref(rowptr, col32, value.abs(), x.abs()))


@pytest.mark.parametrize("reduce", ["mean", "min", "max"])
def test_facade_matmul_reduce_card_vs_cpu(dev, reduce):
    from paddle_sparse_tpu_torch import facade_entry, gcn_norm
    runs = {}
    for where in ("cuda", "cpu"):
        adj, x = facade_entry(where)
        runs[where] = gcn_norm(adj).matmul(x, reduce).cpu()
    torch.testing.assert_close(runs["cuda"], runs["cpu"], **F32)


def test_facade_structural_ops_card_vs_cpu(dev):
    """index_select, narrow, t, masked_select, the diag family, cat,
    coalesce and to_symmetric on the card equal the CPU's field for field."""
    from paddle_sparse_tpu_torch import cat, facade_entry, gcn_norm
    idx = torch.tensor([5, 3, 3, 200, 0])
    ops = {
        "index_select0": lambda A: A[idx.to(A.device())],
        "index_select1": lambda A: A.index_select(1, idx.to(A.device())),
        "narrow": lambda A: A.narrow(1, 10, 100),
        "t": lambda A: A.t(),
        "masked_select": lambda A: A.masked_select(
            0, (torch.arange(256) % 3 == 0).to(A.device())),
        "remove_diag": lambda A: A.remove_diag(1),
        "get_diag": lambda A: A.get_diag(),
        "cat": lambda A: cat([A, A.t()], dim=(0, 1)),
        "coalesce": lambda A: A.coalesce(),
        "to_symmetric": lambda A: A.to_symmetric(),
        "sum0": lambda A: A.sum(dim=0),
    }
    norm = {w: gcn_norm(facade_entry(w)[0]) for w in ("cuda", "cpu")}
    for name, op in ops.items():
        c, h = op(norm["cuda"]), op(norm["cpu"])
        if isinstance(c, torch.Tensor):
            torch.testing.assert_close(c.cpu(), h, **F32, msg=name)
            continue
        assert c.is_cuda() and c.sparse_sizes() == h.sparse_sizes(), name
        for a, b in zip(c.coo(), h.coo()):
            torch.testing.assert_close(a.cpu(), b, **F32, msg=name)


def test_facade_a_at_a_card_vs_cpu(dev):
    """``A @ A`` through the facade runs K5 once on the card and equals the
    CPU's (structure exact, values within f32), and ``spspmm_eager`` on the
    same arrays bit for bit."""
    from paddle_sparse_tpu_torch import facade_entry, gcn_norm, spspmm_eager
    runs = {}
    for where in ("cuda", "cpu"):
        A = gcn_norm(facade_entry(where)[0])
        b = compact_runs_cuda.launches
        C = A @ A
        if where == "cuda":
            torch.cuda.synchronize()
            assert compact_runs_cuda.launches == b + 1
            row, col, val = A.coo()
            rowptr, _, _ = A.csr()
            ref = spspmm_eager(row, col, val, rowptr, col, val, 256, 256)
            for a, r in zip(C.coo(), ref):
                assert torch.equal(a, r)
        runs[where] = [t.cpu() for t in C.coo()]
    for i, (c, h) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if i < 2:
            assert torch.equal(c, h)
        else:
            torch.testing.assert_close(c, h, **F32)


def test_facade_device_moves(dev):
    """``cuda()``, ``to``, ``is_cuda``, ``pin_memory`` and factories with
    ``device=``: tensors keep their device, moves go where asked."""
    from paddle_sparse_tpu_torch import SparseTensor, load_npz, save_npz
    A = SparseTensor.eye(4, fill_cache=True)
    C = A.cuda()
    assert C.is_cuda() and not A.is_cuda()
    assert all(getattr(C.storage, f"_{k}").is_cuda
               for k in C.storage.cached_keys())
    assert C.to("cpu") == A and C.cpu().device() == torch.device("cpu")
    assert A.pin_memory().is_pinned() and not A.is_pinned()
    assert SparseTensor.eye(3, device="cuda").is_cuda()
    assert SparseTensor.from_dense(torch.eye(3).numpy(), device="cuda"
                                   ).is_cuda()
    assert SparseTensor.from_scipy(A.to_scipy(layout="csr"),
                                   device="cuda").is_cuda()
    x = torch.ones(4, 2, device=dev)
    assert (C @ x).is_cuda
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        save_npz(f"{d}/a.npz", C)
        assert load_npz(f"{d}/a.npz", device="cuda") == C


# ---- the plan-holding SpMM entry points and sampling ----------------------

_ENTRY_FNS = {"seg": "spmm_seg", "sell": "spmm_sell",
              "chunked": "spmm_chunked"}


@pytest.mark.parametrize("backend", list(_ENTRY_FNS))
def test_entry_spmm_card_vs_cpu(dev, backend):
    """``spmm_entry``'s toy for seg, sell and chunked: forward, d packed
    and d x on the card against the CPU; launches per forward+backward:
    seg spans 1 and the fused span backward 1, sell and chunked K1 1 and
    the fused CSC backward 1."""
    import paddle_sparse_tpu_torch as p
    fn = getattr(p, _ENTRY_FNS[backend])
    runs = {}
    for where in ("cuda", "cpu"):
        plan, s, packed, x = spmm_entry(backend, where)
        pv, xx = packed.clone().requires_grad_(), x.clone().requires_grad_()
        w = torch.linspace(-1, 1, 256 * 32, device=where).view(256, 32)
        counters = (spmm_spans_cuda, sddmm_spans_cuda, spmm_csr_cuda,
                    sddmm_csr_cuda, spmm_sddmm_csc_cuda,
                    spmm_sddmm_spans_cuda)
        k = [c.launches for c in counters]
        out = fn(plan, s, pv, xx)
        (out * w).sum().backward()
        launches = tuple(c.launches - k0 for c, k0 in zip(counters, k))
        runs[where] = ([out.detach().cpu(), xx.grad.cpu(), pv.grad.cpu()],
                       launches)
    want = ((1, 0, 0, 0, 0, 1) if backend == "seg"
            else (0, 0, 1, 0, 1, 0))
    assert runs["cuda"][1] == want and runs["cpu"][1] == (0,) * 6
    for c, h in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(c, h, **F32)


def test_backend_sell_on_the_card(dev):
    """``backend="sell"`` through ``spmm_coo`` and ``PaddedCOO.spmm`` on the
    card equals ``"auto"`` bit for bit; ``group="auto"`` on a CUDA tensor
    is ``_pick_group``'s."""
    from paddle_sparse_tpu_torch.ops.spmm_sell import (_pick_group,
                                                       make_sell_plan)
    adj = entry("cuda")[1]
    x = torch.randn(256, 32, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    for b in ("sell", "auto"):
        assert torch.equal(adj.spmm(x, backend=b), adj.spmm(x))
        assert torch.equal(spmm_coo(adj.row, adj.col, adj.value, x, 256,
                                    backend=b), adj.spmm(x))
    plan, _ = make_sell_plan(adj.row, adj.col, 256, 256)
    assert plan.group == _pick_group(adj.row, 256, adj.row.numel())


def test_sampling_card_vs_cpu(dev):
    """``sample_entry``: the host sampler with one seed, ``saint_subgraph``,
    ``partition`` and RCM equal card and CPU; the device samplers and walks
    equal when fed the same uniforms."""
    import paddle_sparse_tpu_torch as p
    from paddle_sparse_tpu_torch.ops import sample as ops_sample
    res = {}
    for where in ("cuda", "cpu"):
        adj, seeds = p.sample_entry(where)
        p.seed(3)
        sub, n_id = p.sample_adj(adj, seeds, 5)
        sg, e_id = p.saint_subgraph(adj, seeds)
        out, partptr, perm = p.partition(adj, 8)
        rcm = p.reverse_cuthill_mckee(adj)
        rowptr, col, _ = adj.csr()
        g = torch.Generator().manual_seed(5)
        u_rep = torch.rand(16, 4, generator=g).to(where)
        prio = torch.rand(int((rowptr[seeds + 1] - rowptr[seeds]).sum()),
                          generator=g).to(where)
        u_walk = torch.rand(6, 16, generator=g).to(where)
        padded = [ops_sample._sample_adj_padded(rowptr, col, seeds, 4, r, u)
                  for r, u in ((True, u_rep), (False, prio))]
        walk = ops_sample._random_walk(rowptr, col, seeds, u_walk)
        res[where] = [t.cpu() for t in (
            *sub.coo()[:2], sub.storage.value(), n_id, *sg.coo(), e_id,
            *out.coo(), partptr, perm, rcm, walk,
            *[f for pa in padded for f in pa])]
    for c, h in zip(res["cuda"], res["cpu"]):
        assert torch.equal(c, h)
    adj, seeds = p.sample_entry("cuda")
    gen = p.random.generator("cuda")
    assert gen.device.type == "cuda"
    walks = p.random_walk(adj, seeds, 4)
    assert walks.is_cuda and walks.shape == (16, 5)
    drawn = p.sample(adj, 3, seeds)
    assert drawn.is_cuda and drawn.shape == (16, 3)


# ---- the experiments/ probes (csrc/probes.cu) -------------------------------
# scale2, chunk_sum, band_ablate nodot/empty and slice_gather onehot_write
# repeat their plain versions' operations in the same order: bit for bit.
# span_colsum (pieces, then steps), its staged form and nosel sum thousands
# of bf16 terms in f32 in another order: within SUM_REL of each entry's sum
# of |terms| against f64. onehot_reduce (counts times the slice) rounds
# that sum to bf16 once: within half a bf16 ulp (2**-8 of the value) on top.

@pytest.mark.parametrize("double_buffer", [False, True])
def test_probe_scale2_and_chunk_sum_vs_plain(dev, double_buffer):
    g = torch.Generator(device=dev).manual_seed(0)
    for n in (1, 5, 4096, 100_003):
        x = torch.randn(n + 1, generator=g, device=dev)
        for v in (x[:n], x[1:]):
            assert torch.equal(pc.scale2_cuda(v), v * 2)
    ptr = torch.tensor([0, 3, 3, 9, 10], device=dev, dtype=torch.int32)
    src = torch.randn(1000, 36, generator=g, device=dev)
    before = pc.chunk_sum_cuda.launches
    got = pc.chunk_sum_cuda(ptr, src, 100, double_buffer)
    assert pc.chunk_sum_cuda.launches == before + 1
    assert torch.equal(got, pc.chunk_sum_reference(ptr, src, 100))
    assert not got[100:200].any()                      # the empty tile
    assert torch.equal(bp.dma_copy(double_buffer, dev).cpu(),
                       bp.dma_copy(double_buffer, "cpu"))


@pytest.mark.parametrize("K", [8, 16, 128, 256, 2048])
def test_probe_span_colsum_vs_plain(dev, K):
    """The piece path (span_colsum_cuda) and the staged kernel, one launch
    each a call, within SUM_REL of f64: 13 and 9 steps (not multiples of 8)
    and 16, CAP 77/33/300/40 from unaligned starts, a span ending at the
    stream's last row, identical and overlapping spans in one step, two
    steps holding the same spans; r4_dma_issue.run's output from them at
    every case."""
    g = torch.Generator(device=dev).manual_seed(K)
    L = 6000 if K <= 256 else 2000
    stream = torch.randn(L, K, generator=g, device=dev).bfloat16()
    for NS, CAP, steps in ((5, 77, 13), (3, 33, 13), (2, 300, 9),
                           (4, 40, 16)):
        e0 = torch.randint(0, L - CAP, (steps * NS,), generator=g,
                           device=dev).int()
        e0[0] = L - CAP                     # ends at the last row
        e0[1] = e0[0]                       # identical (NS > 2)
        e0[NS - 1] = L - CAP - CAP // 2     # overlapping
        e0[NS:2 * NS] = e0[:NS]             # steps 0 and 1 share all
        ref = pc.span_colsum_reference(stream, e0, NS, CAP, steps,
                                       torch.float64)
        scale = pc.span_colsum_reference(stream.abs(), e0, NS, CAP, steps,
                                         torch.float64)
        for fn, want in ((pc.span_colsum_cuda, (1, 0)),
                         (pc.span_colsum_staged_cuda, (0, 1))):
            before = (pc.span_colsum_cuda.launches,
                      pc.span_colsum_staged_cuda.launches)
            got = fn(stream, e0, NS, CAP, steps)
            assert (pc.span_colsum_cuda.launches - before[0],
                    pc.span_colsum_staged_cuda.launches - before[1]) == want
            _close_to_sum(got, ref, scale)
        seed = torch.randn(1, 128, generator=g, device=dev)
        out = rd.run(stream, e0, seed, NS=NS, CAP=CAP, steps=steps)
        _close_to_sum(out, pc.dma_issue_output(ref, seed),
                      pc.dma_issue_output(scale, seed.abs()))
    with pytest.raises(ValueError, match="at least 8 steps"):
        rd.run(stream, e0, seed, NS=NS, CAP=CAP, steps=7)


def test_probe_plans_on_the_card(dev):
    """The plans built on the card (``psp_span_plan``, ``psp_slice_plan``)
    equal their torch references entry for entry (the piece tables up to
    the piece count), one launch each; the piece sums through them equal
    the plain version's; no steps or no spans launch nothing."""
    g = torch.Generator(device=dev).manual_seed(3)
    e0 = torch.randint(0, 5000, (7 * 19,), generator=g, device=dev).int()
    e0[1] = e0[0]
    e0[-1] = 5000
    for cap in (384, 1, 600):
        before = pc.span_pieces.launches
        card = pc.span_pieces(e0, cap, 5000 + cap)
        assert pc.span_pieces.launches == before + 1
        ref = pc.span_pieces_reference(e0, cap, 5000 + cap)
        total = int(ref.total[0])
        assert card.max_pieces == ref.max_pieces
        assert int(card.total[0]) == total
        for a, b in ((card.row, ref.row), (card.length, ref.length)):
            assert torch.equal(a[:total], b[:total])
        assert torch.equal(card.first, ref.first)
        assert torch.equal(card.last, ref.last)
    stream = torch.randn(5384, 64, generator=g, device=dev).bfloat16()
    got = pc.span_colsum_cuda(stream, e0, 19, 384, 7)
    want = pc.span_colsum_pieces_reference(
        stream, pc.span_pieces_reference(e0, 384, 5384), 19, 7,
        torch.float64)
    torch.testing.assert_close(got.double(), want, **F32)
    before = pc.span_colsum_cuda.launches
    assert pc.span_colsum_cuda(stream, e0, 19, 384, 0).shape == (0, 64)
    assert pc.span_colsum_cuda.launches == before
    assert not pc.span_colsum_cuda(stream, e0, 0, 384, 3).any()
    for fs in ([5, 1, 5, 5, 0] + [3] * 70, [2], [7] * 1000):
        fs = torch.tensor(fs, device=dev, dtype=torch.int32)
        for nslices in (None, 8):
            before = pc.slice_items.launches
            card = pc.slice_items(fs, nslices)
            assert pc.slice_items.launches == before + 1
            ref = pc.slice_items_reference(fs)
            n = int(ref.n_items[0])
            assert int(card.n_items[0]) == n
            assert torch.equal(card.order, ref.order)
            assert torch.equal(card.sf, ref.sf)
            assert torch.equal(card.istart[:n + 1], ref.istart[:n + 1])


@pytest.mark.parametrize("kind", ["full", "nodot", "nosel", "empty",
                                  "untrans"])
def test_probe_band_variants_vs_plain(dev, kind):
    tb = rb.tables(S=3, BAND=640, E=128, K=128, CAP=1024, device=dev)
    rb.check_schedule(tb)
    assert int(tb.visits[0].diff().max()) > 1
    counts = (pc.band_ablate_cuda.launches,
              pc.span_colsum_staged_cuda.launches, spmm_spans_cuda.launches)
    got = rb.variant_call(kind, tb)
    delta = tuple(b - a for a, b in zip(counts, (
        pc.band_ablate_cuda.launches, pc.span_colsum_staged_cuda.launches,
        spmm_spans_cuda.launches)))
    kw = dict(S=tb.S, BR_pad=tb.BR_pad, E=tb.E, K=tb.K, TMAX=tb.TMAX,
              visits=tb.visits)
    if kind in ("full", "untrans"):
        assert delta == (0, 0, 1)
        st, en = tb.bst.reshape(tb.S, -1), tb.ben.reshape(tb.S, -1)
        ref = spmm_spans_reference(st, en, None, None, None,
                                   tb.stream.double())
        torch.testing.assert_close(got.double(), ref, **F32)
        return
    assert delta == (1, int(kind == "nosel"), 0)
    args = (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben)
    if kind == "nosel":
        torch.testing.assert_close(got.double(), pc.band_ablate_reference(
            kind, *args, tb.stream.double(), **kw), **F32)
    else:
        assert torch.equal(got, pc.band_ablate_reference(kind, *args,
                                                         tb.stream, **kw))


NODOT_CTAS_PER_SM = 4    # csrc/probes.cu kNodotCtasPerSm
BAND_NODOT_CASES = {
    "defaults": {}, "K8": dict(K=8), "K72": dict(K=72), "K264": dict(K=264),
    "TMAX1": dict(TMAX=1), "TMAX4": dict(TMAX=4),
    "mid_tile": dict(S=2, BAND=3712, CAP=4096, K=264)}


def _band_random(dev, case, seed=0):
    """``unvisited``: tiles 2 and 3 of 6 visited by no chunk; ``many``: 72 of
    96 chunks on tile 1, which has more than 64 visits. Random spans and
    bounds (a visit's overlap anywhere in [0, E])."""
    g = torch.Generator().manual_seed(seed)
    R, E, K, TMAX = 128, 16, 72, 4

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int32)

    if case == "unvisited":
        S, BAND, n = 2, 640, 40
        cr, cn = ints(0, 2, n) * 4 * R, ints(0, 3, n)
    else:
        S, BAND, n = 2, 384, 96
        cr = torch.where(torch.arange(n) < 72, 1, ints(0, 3, n)) * R
        cn = ints(1, 3, n)
    BR_pad, L = BAND + 128, n * E
    bst = ints(0, L + 1, S * BR_pad)
    ben = torch.minimum(bst + ints(0, L // 2, S * BR_pad),
                        torch.tensor(L, dtype=torch.int32))
    stream = torch.randn(L, K, generator=g).bfloat16()
    args = tuple(t.to(dev) for t in (ints(0, S, n), cr.int(), cn,
                                     bst.reshape(-1, R), ben.reshape(-1, R),
                                     stream))
    visits = pc.band_visits(args[1], args[2], BR_pad=BR_pad, TMAX=TMAX)
    return args, dict(S=S, BR_pad=BR_pad, E=E, K=K, TMAX=TMAX,
                      visits=visits)


@pytest.mark.parametrize("case", [*BAND_NODOT_CASES, "unvisited", "many"])
def test_probe_band_nodot_vs_plain(dev, case):
    """nodot bit for bit with the plain version: at the probe's defaults,
    K 8/72/264, TMAX 1 and 4, tiles no chunk visits, a tile of more than 64
    visits, and a band whose CTA shares cross tile boundaries mid-tile."""
    if case in BAND_NODOT_CASES:
        sizes = {} if case == "defaults" else dict(S=3, BAND=640, E=128,
                                                   K=128, CAP=1024)
        tb = rb.tables(**{**sizes, **BAND_NODOT_CASES[case]}, device=dev)
        args = (tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, tb.stream)
        kw = dict(S=tb.S, BR_pad=tb.BR_pad, E=tb.E, K=tb.K, TMAX=tb.TMAX,
                  visits=tb.visits)
    else:
        args, kw = _band_random(dev, case)
    counts = kw["visits"][0].diff()
    if case == "unvisited":
        assert not counts[2:4].any() and bool(counts.any())
    if case == "many":
        assert int(counts.max()) > 64
    if case in ("defaults", "mid_tile"):
        # some CTA's share of the 16-byte units starts in one tile and ends
        # in the next (psp_band_ablate's grid)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile_units = 32 * kw["K"]
        units = counts.numel() * tile_units
        G = max(1, min(NODOT_CTAS_PER_SM * sms, units // 256))
        assert any(units * b // G // tile_units
                   != (units * (b + 1) // G - 1) // tile_units
                   for b in range(G))
    before = pc.band_ablate_cuda.launches
    got = pc.band_ablate_cuda("nodot", *args, **kw)
    assert pc.band_ablate_cuda.launches == before + 1
    want = pc.band_ablate_reference("nodot", *args, **kw)
    assert torch.equal(got, want)
    assert bool(want.any())


@pytest.mark.parametrize("variant", ["onehot_write", "onehot_reduce"])
@pytest.mark.parametrize("shape", [(256, 512, 2048), (200, 400, 50),
                                   (8, 16, 7), (40, 300, 100),
                                   (64, 100, 2500)])
def test_probe_slice_gather_vs_plain(dev, variant, shape):
    """Repeated, unsorted fs (one slice holding more than ITEM_CHUNKS
    chunks), K 256/200/8/40/64 (a narrow last column part), R
    512/400/16/300/100 (past one TMA box, not a multiple of it or of 8), E
    2048/50/7/100 (the reduce's TF32 tensor-core sums) and 2500 (its f32
    FMAs, counts past 2,048): write bit for bit the plain gather; reduce
    within half a bf16 ulp (+ SUM_REL of the sum of |terms|) of f64; one
    launch a call, the reduce counted apart."""
    K, R, E = shape
    g = torch.Generator(device=dev).manual_seed(K)
    fs = torch.tensor([0, 4, 4, 1, 0, 4, 4] + [2] * 40, device=dev,
                      dtype=torch.int32)
    cols = torch.randint(0, R, (fs.numel() * E,), generator=g, device=dev,
                         dtype=torch.int32)
    x = torch.randn(5 * R, K, generator=g, device=dev).bfloat16()
    before = (pc.slice_gather_cuda.launches,
              pc.slice_gather_cuda.launches_reduce)
    got = pc.slice_gather_cuda(fs, cols, x, R, variant)
    reduce = variant == "onehot_reduce"
    assert (pc.slice_gather_cuda.launches - before[0],
            pc.slice_gather_cuda.launches_reduce - before[1]) == (1, reduce)
    if not reduce:
        assert torch.equal(got, pc.slice_gather_reference(fs, cols, x, R,
                                                          variant))
        return
    ref = pc.slice_gather_reference(fs, cols, x, R, variant, torch.float64)
    scale = pc.slice_gather_reference(fs, cols, x.abs(), R, variant,
                                      torch.float64)
    _close_to_sum(got, ref, scale, out_rel=2.0 ** -8)


@pytest.mark.parametrize("case", [
    (256, 512, 2048, 1), (256, 512, 2048, 3), (200, 400, 52, 2),
    (256, 799, 64, 0), (40, 1232, 100, 1), (8, 1000, 7, 0)])
def test_probe_slice_reduce_offset_cols_and_wide_slices(dev, case):
    """cols as a view starting 1, 3 or 2 int32 entries past a 16-byte
    boundary with E a multiple of 4 (the histogram's 16-byte loads then do
    not apply), and R 799 (the per-chunk kernel's largest), 1,000 and 1,232
    (parts of 16 or 8 columns): reduce within half a bf16 ulp (+ SUM_REL
    of the sum of |terms|) of f64, and write (where it fits) bit for bit
    the plain gather, from the same views."""
    K, R, E, off = case
    g = torch.Generator(device=dev).manual_seed(R + off)
    fs = torch.tensor([1, 0, 1, 1, 2] + [0] * 40, device=dev,
                      dtype=torch.int32)
    buf = torch.randint(0, R, (off + fs.numel() * E,), generator=g,
                        device=dev, dtype=torch.int32)
    cols = buf[off:]
    assert (cols.data_ptr() % 16 != 0) == (off != 0)
    x = torch.randn(3 * R, K, generator=g, device=dev).bfloat16()
    got = pc.slice_gather_cuda(fs, cols, x, R, "onehot_reduce")
    ref = pc.slice_gather_reference(fs, cols, x, R, "onehot_reduce",
                                    torch.float64)
    scale = pc.slice_gather_reference(fs, cols, x.abs(), R, "onehot_reduce",
                                      torch.float64)
    _close_to_sum(got, ref, scale, out_rel=2.0 ** -8)
    if R * 256 + E * 4 <= 200 * 1024:
        assert torch.equal(
            pc.slice_gather_cuda(fs, cols, x, R, "onehot_write"),
            pc.slice_gather_reference(fs, cols, x, R, "onehot_write"))


def test_probe_slice_reduce_one_slice_and_limits(dev):
    """10,000 chunks on one slice (313 items on the SMs) and five, within
    half a bf16 ulp of f64; an R whose shared memory exceeds 227 KB (1,233)
    raises; E = 0 writes zeros."""
    g = torch.Generator(device=dev).manual_seed(11)
    R, E, K = 512, 64, 256
    x = torch.randn(8 * R, K, generator=g, device=dev).bfloat16()
    for n in (10_000, 5):
        fs = torch.full((n,), 3, device=dev, dtype=torch.int32)
        cols = torch.randint(0, R, (n * E,), generator=g, device=dev,
                             dtype=torch.int32)
        got = pc.slice_gather_cuda(fs, cols, x, R, "onehot_reduce")
        ref = pc.slice_gather_reference(fs, cols, x, R, "onehot_reduce",
                                        torch.float64)
        scale = pc.slice_gather_reference(fs, cols, x.abs(), R,
                                          "onehot_reduce", torch.float64)
        _close_to_sum(got, ref, scale, out_rel=2.0 ** -8)
    big = torch.randn(2 * 1233, K, generator=g, device=dev).bfloat16()
    with pytest.raises(ValueError, match="227 KB"):
        pc.slice_gather_cuda(fs[:2], cols[:2 * E], big, 1233,
                             "onehot_reduce")
    empty = torch.zeros(0, device=dev, dtype=torch.int32)
    assert not pc.slice_gather_cuda(fs, empty, x, R, "onehot_reduce").any()


def test_probe_entry_points_card_vs_cpu(dev):
    """The probes' entry points on the card against the same on the CPU:
    ``bisect_pallas``'s stages, ``segment_rows_matmul`` with ``acc``."""
    from paddle_sparse_tpu_torch import segment_rows_matmul
    card, host = bp.main(["all"], device=dev), bp.main(["all"], device="cpu")
    for name in ("trivial", "dma1", "dma2"):
        assert torch.equal(card[name].cpu(), host[name])
    torch.testing.assert_close(card["spmm"].cpu(), host["spmm"], **F32)
    val, row, rowptr = bp.spmm_inputs(dev)
    acc = torch.randn(bp.SPMM_M, bp.SPMM_K, device=dev)
    for p in (val, val.bfloat16()):
        got = segment_rows_matmul(p, row, rowptr, bp.SPMM_M, acc=acc)
        want = segment_rows_matmul(p.cpu(), row.cpu(), rowptr.cpu(),
                                   bp.SPMM_M, acc=acc.cpu())
        torch.testing.assert_close(got.cpu(), want, **F32)


# ---- the launch path (ops/kernels/_build.launch) ---------------------------
# Every kernel launches on PyTorch's current stream of its tensors' device.
# Each launch site below runs once on the default stream and once on a side
# stream under torch.cuda.stream, where its float inputs are written into
# zeroed copies after a ~25 ms sleep of that stream: a kernel launched on any
# other stream would read the zeros, so the two results are equal bit for
# bit only if the launch kept the side stream's order.

def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def _site(dev, site):
    """``(fn, data)``: one launch site's call over its float inputs."""
    g = torch.Generator(device=dev).manual_seed(5)
    if site == "scale2":
        return pc.scale2_cuda, [torch.randn(256, 128, generator=g,
                                            device=dev)]
    if site == "chunk_sum":
        ptr, src = bp.dma_inputs(dev)
        return (lambda s: pc.chunk_sum_cuda(ptr, s, bp.E, True),
                [torch.randn(src.shape, generator=g, device=dev)])
    if site == "span_colsum":
        e0 = torch.randint(0, 6000 - 77, (65,), generator=g, device=dev,
                           dtype=torch.int32)
        return (lambda s: pc.span_colsum_cuda(s, e0, 5, 77, 13),
                [torch.randn(6000, 128, generator=g, device=dev).bfloat16()])
    if site == "band_ablate":
        tb = rb.tables(S=3, BAND=640, E=128, K=128, CAP=1024, device=dev)
        return (lambda s: pc.band_ablate_cuda(
            "empty", tb.cs, tb.cr, tb.cn, tb.bst, tb.ben, s, S=tb.S,
            BR_pad=tb.BR_pad, E=tb.E, K=tb.K, TMAX=tb.TMAX,
            visits=tb.visits), [tb.stream])
    if site == "span_colsum_staged":
        e0 = torch.randint(0, 6000 - 77, (65,), generator=g, device=dev,
                           dtype=torch.int32)
        return (lambda s: pc.span_colsum_staged_cuda(s, e0, 5, 77, 13),
                [torch.randn(6000, 128, generator=g, device=dev).bfloat16()])
    if site in ("slice_gather", "slice_reduce"):
        fs = torch.tensor([0, 4, 4, 1] + [2] * 40, device=dev,
                          dtype=torch.int32)
        cols = torch.randint(0, 400, (44 * 50,), generator=g, device=dev,
                             dtype=torch.int32)
        variant = ("onehot_write" if site == "slice_gather"
                   else "onehot_reduce")
        return (lambda x: pc.slice_gather_cuda(fs, cols, x, 400, variant),
                [torch.randn(2000, 200, generator=g, device=dev).bfloat16()])
    if site == "spmm_sddmm_csc":
        adj = _fused_graph(dev, split=True)
        return (lambda v, gr, x: _fused(adj, v, gr, x, torch.float32),
                [adj.value.clone(), torch.randn(3000, 64, generator=g,
                                                device=dev),
                 torch.randn(2000, 64, generator=g, device=dev)])
    if site == "spmm_sddmm_spans":
        plan, s, packed = _spans_fused_graph(dev, split=True)
        return (lambda v, gr, x: _spans_fused(plan, s, v, gr, x, "f32"),
                [packed.clone(), torch.randn(3000, 64, generator=g,
                                             device=dev),
                 torch.randn(2000, 64, generator=g, device=dev)])
    if site == "gat_attention":
        adj = _gat_graph(dev, "zipf")
        hw, a_src, a_dst = _gat_inputs(dev, 4, 64)
        return (lambda h: gat_attention_cuda(*_gat_args(adj, h, a_src,
                                                        a_dst)), [hw])
    if site == "fold_pieces":
        rowptr, col, value, _ = _csr(dev, M=6000, N=5000, max_deg=40,
                                     long_row=3000)
        split = split_rows(rowptr[None, :-1], rowptr[None, 1:])
        assert split is not None
        x = torch.randn(5000, 64, generator=g, device=dev)
        return (lambda v, xx: spmm_csr_cuda(rowptr, col, v, xx,
                                            split=split), [value, x])
    rowptr, col, value, _ = _csr(dev)
    x = torch.randn(300, 64, generator=g, device=dev)
    if site == "spmm_spans":
        return (lambda v, xx: spmm_csr_cuda(rowptr, col, v, xx, split=None),
                [value, x])
    if site == "sddmm_spans":
        return (lambda gr, xx: sddmm_csr_cuda(rowptr, col, gr, xx,
                                              split=None),
                [torch.randn(500, 64, generator=g, device=dev), x])
    if site == "segcompact_rows":
        key, val = _sorted_grid(dev, 3000, 64, 500, seed=3)
        rows = torch.arange(3000, dtype=torch.int32, device=dev)
        return (lambda v: compact_runs_cuda(key, rows, v, (3000, 500),
                                            200_000, seg=True), [val])
    assert site == "segcompact_stream"
    col, row, val = _flat_sorted(dev, 3000, 400, 200_000, 3001, seed=2)
    return (lambda v: compact_runs_cuda(col, row, v, (3000, 400), 200_100,
                                        seg=True), [val])


LAUNCH_SITES = ("scale2", "chunk_sum", "span_colsum", "span_colsum_staged",
                "band_ablate", "slice_gather", "slice_reduce",
                "spmm_sddmm_csc", "spmm_sddmm_spans",
                "spmm_spans", "fold_pieces", "sddmm_spans",
                "segcompact_rows", "segcompact_stream", "gat_attention")


@pytest.mark.parametrize("site", LAUNCH_SITES)
def test_launch_site_keeps_the_side_streams_order(dev, site):
    fn, data = _site(dev, site)
    want = _tensors(fn(*data))
    copies = [torch.zeros_like(d) for d in data]
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for c, d in zip(copies, data):
            c.copy_(d)
        got = _tensors(fn(*copies))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_probe_launches_replay_in_a_cuda_graph(dev):
    """P1 and P2 captured in a CUDA graph (their launches go to the
    capturing stream) and replayed on new inputs: bit for bit their plain
    versions."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(256, 128, generator=g, device=dev)
    ptr, src = bp.dma_inputs(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the graph
        pc.scale2_cuda(x)
        pc.chunk_sum_cuda(ptr, src, bp.E, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o1 = pc.scale2_cuda(x)
        o2 = pc.chunk_sum_cuda(ptr, src, bp.E, True)
    x.copy_(torch.randn(x.shape, generator=g, device=dev))
    src.copy_(torch.randn(src.shape, generator=g, device=dev))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(o1, pc.scale2_reference(x))
    assert torch.equal(o2, pc.chunk_sum_reference(ptr, src, bp.E))


@pytest.mark.parametrize("double_buffer", [False, True])
def test_probe_p1_p2_shapes_and_offsets(dev, double_buffer):
    """P1 and P2 at the probe's shapes and at odd sizes, 4-byte and
    16-byte offsets, non-contiguous inputs and int64 or 2-D pointers: bit
    for bit their plain versions, one launch a call."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(256, 128, generator=g, device=dev)
    assert torch.equal(pc.scale2_cuda(x), pc.scale2_reference(x))
    big = torch.randn(4099 * 3 + 3, generator=g, device=dev)
    for v in (big[:4099], big[1:4100], big[2:4101], big[3:4102],
              big[:4099 * 3].view(4099, 3).t(), big[:7]):
        before = pc.scale2_cuda.launches
        assert torch.equal(pc.scale2_cuda(v), pc.scale2_reference(v))
        assert pc.scale2_cuda.launches == before + 1
    ptr, src = bp.dma_inputs(dev)
    src = torch.randn(src.shape, generator=g, device=dev)
    want = pc.chunk_sum_reference(ptr, src, bp.E)
    for p in (ptr, ptr.long(), ptr[:, None]):
        before = pc.chunk_sum_cuda.launches
        assert torch.equal(pc.chunk_sum_cuda(p, src, bp.E, double_buffer),
                           want)
        assert pc.chunk_sum_cuda.launches == before + 1
    # odd E and K (E * K a multiple of 4), a 16-byte row offset, and a
    # transposed (non-contiguous) src, which the wrapper copies
    ptr2 = torch.tensor([0, 1, 1, 4, 5], device=dev, dtype=torch.int32)
    rows = torch.randn(3 * 5 + 3, 12, generator=g, device=dev)
    for s in (rows[:15], rows[3:18], rows[:15].t().contiguous().t()):
        assert torch.equal(pc.chunk_sum_cuda(ptr2, s, 3, double_buffer),
                           pc.chunk_sum_reference(ptr2, s, 3))
    with pytest.raises(ValueError, match="16-byte"):      # 4-byte offset
        pc.chunk_sum_cuda(ptr2, rows.view(-1)[1:181].view(15, 12), 3,
                          double_buffer)


# ---- parallel/ at world size 1 on NCCL -------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A 1-D mesh over an NCCL process group of one rank (file store), for
    the module; one card runs NCCL at world size 1 only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from paddle_sparse_tpu_torch.parallel import make_mesh
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("nccl") / "store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    yield make_mesh(1)
    dist.destroy_process_group()


def _toy_sharded(dev):
    """The dry run's toy graph (64 nodes, 256 entries) as a SparseTensor on
    the CPU, its features (64, 16) and a cotangent, both on ``dev``."""
    from paddle_sparse_tpu_torch import SparseTensor
    from paddle_sparse_tpu_torch.entry import _toy_graph
    row, col, val, x, _ = _toy_graph(num_nodes=64, avg_deg=4, feat=16)
    adj = SparseTensor(row=torch.as_tensor(row), col=torch.as_tensor(col),
                       value=torch.as_tensor(val), sparse_sizes=(64, 64))
    g = torch.Generator().manual_seed(4)
    return adj, torch.as_tensor(x).to(dev), torch.randn(
        64, 16, generator=g).to(dev)


def _sharded_block(name, adj, mesh, dev):
    """``(fn(x, value), value)`` of one interchange at world size 1."""
    from paddle_sparse_tpu_torch import parallel as tpar
    if name in ("allgather", "ring"):
        blk = tpar.device_put_sharded_matrix(tpar.shard_padded_coo(adj, 1),
                                             0, dev)
        fn = tpar.spmm_allgather if name == "allgather" else tpar.spmm_ring
    elif name == "ring_bucketed":
        blk = tpar.device_put_ring(tpar.shard_ring_buckets(adj, 1), 0, dev)
        fn = tpar.spmm_ring_bucketed
    elif name == "halo":
        blk = tpar.device_put_halo(tpar.shard_halo(adj, 1), 0, dev)
        fn = tpar.spmm_halo
    else:
        blk = tpar.device_put_2d(tpar.shard_2d(adj, 1, 1), 0, dev)
        mesh = tpar.make_mesh_2d(1, 1)
        fn = tpar.spmm_2d
    return (lambda x, v: fn(mesh, blk._replace(value=v), x)), blk.value


@pytest.mark.parametrize("name", ["allgather", "ring", "ring_bucketed",
                                  "halo", "2d"])
def test_parallel_spmm_world1(nccl_mesh, dev, name):
    """Each interchange at world size 1 on NCCL: output, d x and d value
    of ``sum(out * g)`` against ``spmm_coo`` over the same entries on the
    CPU (at one rank every layout keeps the COO order)."""
    adj, x, g = _toy_sharded(dev)
    fn, value = _sharded_block(name, adj, nccl_mesh, dev)
    xx, vv = x.clone().requires_grad_(), value.clone().requires_grad_()
    out = fn(xx, vv)
    (out * g).sum().backward()
    r, c, v = (t.cpu() for t in adj.coo())
    xh = x.cpu().clone().requires_grad_()
    vh = v.clone().requires_grad_()
    ref = spmm_coo(r, c, vh, xh, 64)
    (ref * g.cpu()).sum().backward()
    torch.testing.assert_close(out.cpu(), ref.detach(), **F32)
    torch.testing.assert_close(xx.grad.cpu(), xh.grad, **F32)
    torch.testing.assert_close(vv.grad.cpu().reshape(-1)[:256], vh.grad,
                               **F32)


@pytest.mark.parametrize("halo", [False, True])
def test_parallel_seg2_world1(nccl_mesh, dev, halo):
    """seg2 under the all-gather or the halo all-to-all at world size 1:
    output, d x and d packed value against ``spmm_seg2`` of the same plan
    on the CPU."""
    from paddle_sparse_tpu_torch import parallel as tpar
    adj, x, g = _toy_sharded(dev)
    if halo:
        mat = tpar.shard_halo(adj, 1)
        sh = tpar.make_seg2_halo_plan(mat, feat_dim=16, sr=32)
        blk = tpar.device_put_halo(mat, 0, dev)

        def fn(s, v, h):
            return tpar.spmm_seg2_halo(nccl_mesh, blk, s, v, h)
    else:
        mat = tpar.shard_padded_coo(adj, 1)
        sh = tpar.make_seg2_plan_sharded(mat, feat_dim=16, sr=32)

        def fn(s, v, h):
            return tpar.spmm_seg2_allgather(nccl_mesh, s, v, h)
    assert sh.plans[0].S > 1
    packed = tpar.pack_values_sharded(sh, mat.value)[0]
    outs = []
    for d in (dev, torch.device("cpu")):
        shard = tpar.device_put_sharded_seg2(sh, 0, d)
        pv = packed.detach().to(d).requires_grad_()
        xx = x.detach().to(d).requires_grad_()
        if d.type == "cuda":
            out = fn(shard, pv, xx)
        else:        # one rank's halo buffer: the rows it sends itself
            hx = xx[mat.send_idx.reshape(-1).long()] if halo else xx
            out = spmm_seg2(shard.plan, shard.structure, pv, hx)
        (out * g.to(d)).sum().backward()
        outs.append((out.detach().cpu(), xx.grad.cpu(), pv.grad.cpu()))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, **F32)


def test_parallel_spgemm_world1(nccl_mesh, dev):
    """``spgemm_rowsharded`` at world size 1 (K5 on the card) against
    ``spspmm_padded`` on the CPU, and its flag at a capacity too small."""
    from paddle_sparse_tpu_torch import parallel as tpar
    adj, _, _ = _toy_sharded(dev)
    blocks, _ = tpar.shard_padded_rows(adj, 1)
    A = tpar.device_put_blocks(blocks, 0, dev)
    B = PaddedCOO.from_eager(adj)
    flop_cap, out_cap = plan_spgemm(B, B)
    C, over = tpar.spgemm_rowsharded(nccl_mesh, A, B.to(dev), flop_cap,
                                     out_cap)
    ref = spspmm_padded(B, B, flop_cap, out_cap)
    assert over.tolist() == [False] and not ref.overflowed
    assert C.nnz == ref.matrix.nnz
    assert torch.equal(C.row.cpu(), ref.matrix.row)
    assert torch.equal(C.col.cpu(), ref.matrix.col)
    torch.testing.assert_close(C.value.cpu(), ref.matrix.value, **F32)
    _, over = tpar.spgemm_rowsharded(nccl_mesh, A, B.to(dev), 8, out_cap)
    assert over.tolist() == [True]


def test_parallel_dryrun_world1(nccl_mesh, dev):
    """Every block of the dry run at world size 1 on the card passes its
    own checks, and its three steps' losses agree (one graph, one set of
    parameters)."""
    from paddle_sparse_tpu_torch.entry import DryRun, dryrun_nodes
    res = DryRun(nccl_mesh, dev, dryrun_nodes(1), verbose=False).run()
    losses = [float(res[k]["loss"]) for k in ("gcn_step", "seg2_step",
                                              "seg2_halo_step")]
    assert all(abs(v - losses[0]) <= 1e-5 * abs(losses[0]) for v in losses)
    assert not res["spgemm"]["overflowed"].any()


def test_dryrun_multichip_needs_a_card_per_rank(dev):
    """More ranks than cards on ``"cuda"``: raises naming the reason
    before any process starts."""
    from paddle_sparse_tpu_torch.entry import dryrun_multichip
    with pytest.raises(RuntimeError, match="one rank per card"):
        dryrun_multichip(torch.cuda.device_count() + 1, "cuda")


# ---- integer K1 and the create_graph backward -------------------------------

INT_RANGE = {torch.int8: (-128, 127), torch.int16: (-2 ** 15, 2 ** 15 - 1),
             torch.int32: (-2 ** 30, 2 ** 30),
             torch.int64: (-2 ** 40, 2 ** 40), torch.uint8: (0, 255),
             torch.bool: (0, 1)}
INT_CARD_PAIRS = [(torch.int32, torch.int32), (None, torch.int32),
                  (None, torch.int64), (torch.int64, torch.int64),
                  (torch.int64, torch.int32), (torch.int32, torch.int64),
                  (torch.int8, torch.int16), (torch.uint8, torch.uint8),
                  (torch.bool, torch.int32), (torch.int16, torch.int8)]


def _int_rand(g, dtype, shape, dev):
    lo, hi = INT_RANGE[dtype]
    return torch.randint(lo, hi + 1, shape, generator=g, device=dev,
                         dtype=torch.int64).to(dtype)


def _hub_csr(dev, hub, M=300, N=200, seed=4):
    """A CSR of ``M`` rows (empty first and last), with a row of ``3 * CAP
    + 5`` edges when ``hub`` (pieces and the fold)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    deg = torch.randint(0, 20, (M,), generator=g, device=dev)
    deg[[0, M - 1]] = 0
    if hub:
        deg[M // 2] = 3 * CAP + 5
    rowptr = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    rowptr[1:] = deg.cumsum(0)
    col = torch.randint(0, N, (int(rowptr[-1]),), generator=g, device=dev,
                        dtype=torch.int32)
    return rowptr, col, g


@pytest.mark.parametrize("K", [1, 5, 47, 64])
@pytest.mark.parametrize("hub", [False, True], ids=["no_pieces", "pieces"])
@pytest.mark.parametrize("vdt,xdt", INT_CARD_PAIRS,
                         ids=["-".join("none" if d is None else str(d)[6:]
                                       for d in p) for p in INT_CARD_PAIRS])
def test_int_k1_equals_plain(dev, vdt, xdt, K, hub):
    """K1 on integer operands equals its plain version exactly (sums in
    int64, the result in the promoted dtype, wrapped), with and without a
    row cut into pieces; int32 operands of +-2**30 wrap past 2**31."""
    rowptr, col, g = _hub_csr(dev, hub)
    v = None if vdt is None else _int_rand(g, vdt, (col.numel(),), dev)
    x = _int_rand(g, xdt, (200, K), dev)
    n, nf = spmm_csr_cuda.launches, fold_pieces_cuda.launches
    out = spmm_csr_cuda(rowptr, col, v, x)
    assert spmm_csr_cuda.launches == n + 1
    assert (fold_pieces_cuda.launches > nf) == hub
    ref = spmm_csr_reference(rowptr, col, v, x)
    want = x.dtype if v is None else torch.promote_types(v.dtype, x.dtype)
    assert out.dtype == ref.dtype == want
    assert torch.equal(out, ref)
    assert torch.equal(out.cpu(), spmm_csr_reference(
        rowptr.cpu(), col.cpu(), None if v is None else v.cpu(), x.cpu()))


def test_int_k1_unaligned_and_public_path(dev):
    """int32 x at a 4-byte offset (scalar loads) and int64 at an 8-byte
    one; ``spmm_coo`` on the card equal to the CPU's, sum and mean."""
    rowptr, col, g = _hub_csr(dev, True)
    for dt in (torch.int32, torch.int64):
        base = _int_rand(g, dt, (200 * 8 + 1,), dev)
        x = base[1:].view(200, 8)
        out = spmm_csr_cuda(rowptr, col, None, x)
        assert torch.equal(out, spmm_csr_reference(rowptr, col, None, x))
    row = torch.repeat_interleave(torch.arange(300, device=dev),
                                  (rowptr[1:] - rowptr[:-1]).long())
    v = _int_rand(g, torch.int32, (col.numel(),), dev)
    x = _int_rand(g, torch.int32, (200, 16), dev)
    for reduce in ("sum", "mean"):
        got = spmm_coo(row, col, v, x, 300, reduce)
        want = spmm_coo(row.cpu(), col.cpu(), v.cpu(), x.cpu(), 300, reduce)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want)


def _hub_padded(dev, dtype=torch.float32):
    """A padded ``PaddedCOO`` (400 x 300) with a hub row and a hub column
    of ``2 * CAP + 5`` edges: both pointers have pieces."""
    g = torch.Generator().manual_seed(7)
    row = torch.randint(0, 400, (6000,), generator=g)
    col = torch.randint(0, 300, (6000,), generator=g)
    row = torch.cat([row, torch.full((2 * CAP + 5,), 123),
                     torch.randint(0, 400, (2 * CAP + 5,), generator=g)])
    col = torch.cat([col, torch.randint(0, 300, (2 * CAP + 5,),
                                        generator=g),
                     torch.full((2 * CAP + 5,), 77)])
    order = torch.argsort(row * 300 + col, stable=True)
    A = PaddedCOO.from_arrays(row[order].to(torch.int32),
                              col[order].to(torch.int32), None, (400, 300),
                              capacity=row.numel() + 9)
    v = torch.randn(A.capacity, generator=g, dtype=torch.float64)
    v[A.nnz:] = 0
    x = torch.randn(300, 24, generator=g, dtype=torch.float64)
    w = torch.randn(400, 24, generator=g, dtype=torch.float64)
    return A, v, x, w


def _penalty_run(A, v, x, w, dev, dtype):
    """First-order grads of ``sum(w * (A(v) x) ** 2)`` under
    ``create_graph``, then the grads of their squared norms; returns both
    and the launches of each pass."""
    tv = v.to(dev, dtype).requires_grad_()
    tx = x.to(dev, dtype).requires_grad_()
    tw = w.to(dev, dtype)
    names = ("spmm_csr", "sddmm_csr", "spmm_sddmm_csc")
    fns = (spmm_csr_cuda, sddmm_csr_cuda, spmm_sddmm_csc_cuda)
    c0 = [f.launches for f in fns]
    out = A.with_value(tv).spmm(tx)
    gv, gx = torch.autograd.grad((tw * out ** 2).sum(), (tv, tx),
                                 create_graph=True)
    c1 = [f.launches for f in fns]
    (gv.square().sum() + gx.square().sum()).backward()
    c2 = [f.launches for f in fns]
    first = dict(zip(names, (b - a for a, b in zip(c0, c1))))
    second = dict(zip(names, (b - a for a, b in zip(c1, c2))))
    return gv, gx, tv.grad, tx.grad, first, second


def test_create_graph_backward_launches_and_values(dev):
    """Under ``create_graph`` the forward and the first-order grads launch
    K1 and the fused pass once each, as without it, and the grads equal
    those of a backward without it bit for bit; the second
    backward launches K2 and K1 along the fused pass's ``d x``, K1 twice
    along its ``d value`` and the fused pass once (the forward's); the
    second-order grads agree with the CPU's in f64 (hub row and column in
    pieces)."""
    A, v, x, w = _hub_padded(dev)
    Ad = PaddedCOO.from_arrays(A.row[:A.nnz].to(dev), A.col[:A.nnz].to(dev),
                               None, A.shape, capacity=A.capacity)
    gv, gx, dv, dx, first, second = _penalty_run(Ad, v, x, w, dev,
                                                 torch.float32)
    assert first == {"spmm_csr": 1, "sddmm_csr": 0, "spmm_sddmm_csc": 1}
    assert second == {"spmm_csr": 3, "sddmm_csr": 1, "spmm_sddmm_csc": 1}
    tv = v.to(dev, torch.float32).requires_grad_()
    tx = x.to(dev, torch.float32).requires_grad_()
    out = Ad.with_value(tv).spmm(tx)
    n = spmm_sddmm_csc_cuda.launches
    gv0, gx0 = torch.autograd.grad(
        (w.to(dev, torch.float32) * out ** 2).sum(), (tv, tx))
    assert spmm_sddmm_csc_cuda.launches == n + 1
    assert torch.equal(gv.detach(), gv0) and torch.equal(gx.detach(), gx0)
    _, _, rv, rx, _, _ = _penalty_run(A, v, x, w, torch.device("cpu"),
                                      torch.float64)
    for got, ref in ((dv, rv), (dx, rx)):
        ref = ref.to(dev)
        torch.testing.assert_close(got.double(), ref, rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()))
    assert not dv[A.nnz:].any()


def test_create_graph_f64_third_order_and_spgemm(dev):
    """f64 on the card: ``d/dx`` of ``|d^2 f / dx^2 . u|^2`` equal to the
    CPU's within 1e-10; SpGEMM's value HVP card vs CPU."""
    A, v, x, w = _hub_padded(dev)
    u = torch.randn(x.shape, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    res = []
    for d in (dev, torch.device("cpu")):
        Ad = PaddedCOO.from_arrays(A.row[:A.nnz].to(d),
                                   A.col[:A.nnz].to(d), v[:A.nnz].to(d),
                                   A.shape, capacity=A.capacity)
        tx = x.to(d).requires_grad_()
        f = (w.to(d) * Ad.spmm(tx) ** 3).sum()
        gx, = torch.autograd.grad(f, tx, create_graph=True)
        hu, = torch.autograd.grad((gx * u.to(d)).sum(), tx,
                                  create_graph=True)
        t3, = torch.autograd.grad(hu.square().sum(), tx)
        res.append(t3.cpu())
    torch.testing.assert_close(res[0], res[1], rtol=1e-10,
                               atol=1e-10 * float(res[1].abs().max()))
    B = spgemm_entry(dev)
    Bc = spgemm_entry("cpu")
    F, oc = plan_spgemm_rows(Bc, Bc)
    hv = []
    for M_ in (B, Bc):
        val = M_.value.double().requires_grad_()
        Mi = M_.with_value(val)
        C = spspmm_rowsorted(Mi, Mi, F, oc).matrix.value
        G = torch.linspace(-1, 1, C.numel(), dtype=torch.float64,
                           device=C.device)
        g, = torch.autograd.grad((G * C ** 2).sum(), val, create_graph=True)
        h, = torch.autograd.grad((g * torch.cos(torch.arange(
            g.numel(), device=g.device, dtype=torch.float64))).sum(), val)
        hv.append(h.cpu())
    torch.testing.assert_close(hv[0], hv[1], rtol=1e-10,
                               atol=1e-10 * float(hv[1].abs().max()))
