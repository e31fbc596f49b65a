"""Per-head SpMM (``PaddedCOO.spmm(x, value=...)`` with an (E, H) value,
``ops/spmm.py::_HeadsSpmm``), GAT's aggregation, on the CPU: against the
stack of per-head ``adj.with_value(value[:, k]).spmm(x[:, k])`` it
replaced, forward bit for bit and grads in ``value`` and ``x``, first and
second order; values at padding unread; what the per-head call refuses;
and the plain
K1 (``spmm_csr_reference``, and ``spmm_csr_cuda`` on a CPU tensor, which
runs it) on the strided views ``x[:, k]`` and ``out=`` views of one
output, with what ``out=`` refuses. The kernel itself on such views runs
only on the card (``tests/test_torch_cuda.py -k strided``).

Both sides sum each head's columns in the same edge order, so forwards and
first-order grads are equal bit for bit; second-order grads are held to
f64 ``1e-12``."""
import pytest
import torch

from paddle_sparse_tpu_torch import (PaddedCOO, spmm_csr_cuda,
                                     spmm_csr_reference)
from stacked_heads import stacked_heads

N, NNZ, CAP = 60, 420, 470


def _graph(seed=0):
    """A square graph with empty rows and duplicate entries, padded past
    its entries, no values."""
    g = torch.Generator().manual_seed(seed)
    row = torch.randint(0, N - 5, (NNZ,), generator=g).sort().values
    col = torch.randint(0, N, (NNZ,), generator=g)
    return PaddedCOO.from_arrays(row, col, None, (N, N), capacity=CAP)


def _operands(H, D, dtype, seed=1, head_major=False):
    """``value`` (CAP, H), garbage at padding (never read), and ``x``
    (N, H, D), both requiring grad; ``head_major``: ``value`` the (CAP, H)
    view of an (H, CAP) buffer, as GAT's attention weights are on the
    card."""
    g = torch.Generator().manual_seed(seed)
    value = torch.rand(H, CAP, generator=g, dtype=dtype)
    value = value.t() if head_major else value.t().contiguous()
    x = torch.randn(N, H, D, generator=g, dtype=dtype)
    return value.requires_grad_(), x.requires_grad_()


def _heads(adj, value, x):
    return adj.spmm(x, value=value)


@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("H,D", [(1, 5), (4, 5), (4, 47), (3, 1)])
def test_forward_equals_the_stack(H, D, dtype, head_major):
    adj = _graph()
    value, x = _operands(H, D, dtype, head_major=head_major)
    got = _heads(adj, value, x)
    assert got.shape == (N, H, D) and got.dtype == dtype
    assert got.is_contiguous()
    assert torch.equal(got, stacked_heads(adj, value, x))


@pytest.mark.parametrize("need", ["both", "value", "x"])
@pytest.mark.parametrize("H,D", [(1, 5), (4, 5), (4, 47)])
def test_grads_equal_the_stack(H, D, need):
    """``d value`` (0 at padding) and ``d x`` along a random cotangent,
    with both or one of them needed: the backward runs the kernels the
    stack's did (the fused pass, K2, or K1 over the CSC view)."""
    adj = _graph()
    value, x = _operands(H, D, torch.float32)
    if need == "value":
        x.requires_grad_(False)
    elif need == "x":
        value.requires_grad_(False)
    w = torch.randn(N, H, D, generator=torch.Generator().manual_seed(3))
    wrt = [t for t in (value, x) if t.requires_grad]
    got = torch.autograd.grad((_heads(adj, value, x) * w).sum(), wrt)
    want = torch.autograd.grad((stacked_heads(adj, value, x) * w).sum(), wrt)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b)
    if need != "x":
        assert not got[0][adj.nnz:].any()


def test_second_order_grads_match_the_stack():
    """Grad of grad (an input-gradient penalty through the heads): the
    backward is itself differentiable, and agrees with the stack's."""
    adj = _graph()
    value, x = _operands(3, 4, torch.float64)
    w = torch.randn(N, 3, 4, generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    res = []
    for fn in (_heads, stacked_heads):
        dv, dx = torch.autograd.grad((fn(adj, value, x) * w).sum(),
                                     (value, x), create_graph=True)
        res.append(torch.autograd.grad(
            (dv[:adj.nnz] ** 2).sum() + (dx ** 3).sum(), (value, x)))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_gradcheck():
    adj = _graph()
    value, x = _operands(2, 3, torch.float64)
    assert torch.autograd.gradcheck(
        lambda v, xx: _heads(adj, v, xx), (value, x))


@pytest.mark.parametrize("H,D", [(4, 5), (2, 47)])
def test_columns_in_blocks_equal_the_heads(H, D):
    """An (N, H * D) operand, as GAT passes ``h @ W``: the (M, H * D)
    output, the (N, H, D) call's output flattened."""
    adj = _graph()
    value, x = _operands(H, D, torch.float32)
    got = adj.spmm(x.reshape(N, H * D), value=value)
    assert got.shape == (N, H * D)
    assert torch.equal(got, _heads(adj, value, x).reshape(N, H * D))


def test_value_at_padding_is_not_read():
    """Per-head values with NaN at padding: the product of each head's
    ``adj.with_value`` (which zeroes the padding), stacked."""
    adj = _graph()
    value, x = _operands(3, 4, torch.float32)
    value = value.detach()
    value[adj.nnz:] = float("nan")
    x = x.detach()
    assert torch.equal(adj.spmm(x, value=value), stacked_heads(adj, value, x))


@pytest.mark.parametrize("bad", ["mean", "split", "3d", "1d", "sell"])
def test_refuses_what_heads_cannot_sum(bad):
    """A reduction other than a sum, columns that do not split into the
    heads, a value= that is not (capacity, H), and ``backend="sell"``,
    which sums one value an entry."""
    adj = _graph()
    value, x = _operands(3, 4, torch.float32)
    reduce = "mean" if bad == "mean" else "sum"
    backend = "sell" if bad == "sell" else "auto"
    if bad == "split":
        x = x.reshape(N, 12)[:, :10]
    elif bad == "3d":
        value = value[..., None]
    elif bad == "1d":
        value = value[:, 0]
    with pytest.raises(ValueError, match="per-head"):
        adj.spmm(x, reduce, backend, value=value)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32])
def test_refuses_integer_heads(dtype):
    """Per-head values are weights that sum as floats: an integer pair is
    refused on every device (the card's K1 would write narrow ints as
    int32), a float value with integer ``x`` sums as the float."""
    adj = _graph()
    value = torch.ones(CAP, 2, dtype=dtype)
    x = torch.ones(N, 2, 3, dtype=dtype)
    with pytest.raises(TypeError, match="float"):
        adj.spmm(x, value=value)
    got = adj.spmm(x, value=value.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, stacked_heads(adj, value.float(), x.float()))


# ---- the plain K1 on strided views -----------------------------------------

def _csr():
    adj = _graph()
    g = torch.Generator().manual_seed(5)
    return adj.rowptr(), adj.col, torch.rand(CAP, generator=g) * 2 - 1, g


@pytest.mark.parametrize("H,D", [(4, 128), (4, 47), (2, 1)])
def test_reference_reads_strided_views(H, D):
    """``spmm_csr_reference`` on ``hw[:, k]`` (row stride H * D), with
    ``value`` a strided column too: equal bit for bit to the same call on
    contiguous copies."""
    rowptr, col, value, g = _csr()
    hw = torch.randn(N, H, D, generator=g)
    vals = torch.stack([value, value.flip(0)], 1)
    for k in range(H):
        x, v = hw[:, k], vals[:, k % 2]
        assert not x.is_contiguous() and not v.is_contiguous()
        assert torch.equal(spmm_csr_reference(rowptr, col, v, x),
                           spmm_csr_reference(rowptr, col, v.contiguous(),
                                              x.contiguous()))


def test_wrapper_writes_out_views_on_the_cpu():
    """``spmm_csr_cuda`` on a CPU tensor with ``out=`` views of one
    (M, H, D) output: each head written in place, the view returned, the
    whole equal to the per-head outputs stacked."""
    rowptr, col, value, g = _csr()
    H, D = 4, 6
    hw = torch.randn(N, H, D, generator=g)
    out = torch.full((N, H, D), float("nan"))
    for k in range(H):
        got = spmm_csr_cuda(rowptr, col, value, hw[:, k], out=out[:, k])
        assert got.data_ptr() == out[:, k].data_ptr()
    want = torch.stack([spmm_csr_cuda(rowptr, col, value, hw[:, k])
                        for k in range(H)], 1)
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["overlap", "alias", "last_stride", "shape",
                                 "dtype", "row_stride", "narrow_int"])
def test_wrapper_refuses_bad_out(bad):
    """What ``out=`` refuses, on any device: memory that meets ``x``'s
    (a slice of the same array, or ``x`` itself), a last stride other than
    1, another shape, another dtype than the output's, rows closer than
    K, and an int narrower than int32 (which the card's K1 writes as
    int32), so that a call refused on the card is refused here too."""
    rowptr, col, value, g = _csr()
    hw = torch.randn(N, 4, 8, generator=g)
    x = hw[:, 1]
    out = torch.empty(N, 4, 8)[:, 2]
    if bad == "overlap":
        out = hw[:, 2]
    elif bad == "alias":
        out = x
    elif bad == "last_stride":
        out = torch.empty(N, 16)[:, ::2]
    elif bad == "shape":
        out = torch.empty(N - 1, 8)
    elif bad == "dtype":
        out = torch.empty(N, 8, dtype=torch.float64)
    elif bad == "narrow_int":
        value, x = value.to(torch.int8), x.to(torch.int8)
        out = torch.empty(N, 8, dtype=torch.int8)
    elif bad == "row_stride":
        out = torch.empty(N * 8 + 8).as_strided((N, 8), (4, 1))
    err = TypeError if bad in ("dtype", "narrow_int") else ValueError
    with pytest.raises(err):
        spmm_csr_cuda(rowptr, col, value, x, out=out)
