"""GAT's attention pass on the CPU: ``gat_attention`` (the autograd Function
whose forward runs the two kernels of ``csrc/gat_attention.cu`` on a CUDA
tensor) and its plain version ``gat_attention_reference``.

* The plain version, and the Function on a CPU tensor, equal bit for bit
  the arithmetic GAT ran before the kernels (the per-head scores, the
  ``(E, H)`` logits through the row groups, ``edge_softmax``): padding
  entries, empty rows, rows past ``CAP``, one and four heads, D of 47 and
  128.
* The Function's backward (plain torch) against ``gradcheck`` and
  ``gradgradcheck`` in float64, and against autograd through the plain
  version on a graph with a hub row (float64, ``1e-12``: the same
  quantities summed in another order).
* The wrappers' refusals on the CPU, and a rectangular adjacency refused.
  The kernels themselves run only on the card (``tests/test_torch_cuda.py
  -k gat``).
"""
import pytest
import torch
from torch.nn import functional as F

from paddle_sparse_tpu_torch import (CAP, PaddedCOO, edge_softmax,
                                     gat_attention, gat_attention_cuda,
                                     gat_attention_reference)
from paddle_sparse_tpu_torch.ops.kernels import gat_attention_cuda as gk
from paddle_sparse_tpu_torch.ops.segment import grouped_gather, take_rows

N = 1500


def _graph(seed=0, n=N, hub=True, pad=37):
    """Rows of 0-90 entries (empty rows among them), with ``hub`` rows of
    ``2 * CAP + 5``, ``CAP`` and ``CAP + 1`` entries; ``pad`` padding
    entries past them; no values."""
    g = torch.Generator().manual_seed(seed)
    deg = torch.randint(0, 91, (n,), generator=g)
    deg[[0, n // 3, n - 1]] = 0
    if hub:
        deg[7], deg[8], deg[9] = 2 * CAP + 5, CAP, CAP + 1
    row = torch.repeat_interleave(torch.arange(n), deg)
    col = torch.randint(0, n, (row.numel(),), generator=g)
    return PaddedCOO.from_arrays(row, col, None, (n, n),
                                 capacity=row.numel() + pad)


def _inputs(n, H, D, dtype=torch.float32, seed=1):
    g = torch.Generator().manual_seed(seed)
    hw = torch.randn(n, H, D, generator=g, dtype=dtype)
    a = torch.randn(2, H, D, generator=g, dtype=dtype) * 2 / D ** 0.5
    return hw, a[0].clone(), a[1].clone()


def _before(adj, hw, a_src, a_dst, slope):
    """GAT's attention as ``models/gcn.py`` computed it before the kernels
    (``GAT._scores``, then ``edge_softmax``)."""
    groups = adj.row_groups()
    col = adj.col.long().clamp(0, adj.N - 1)
    alpha_dst = (hw * a_dst).sum(-1)
    alpha_src = (hw * a_src).sum(-1)
    logits = F.leaky_relu(grouped_gather(alpha_dst, groups)
                          + take_rows(alpha_src, col), slope)
    return edge_softmax(adj, logits), alpha_dst, alpha_src


@pytest.mark.parametrize("H", [1, 4])
@pytest.mark.parametrize("D", [47, 128])
def test_plain_version_is_the_former_arithmetic(H, D):
    adj = _graph()
    assert adj.row_split() is not None and adj.capacity > adj.nnz
    hw, a_src, a_dst = _inputs(N, H, D)
    want = _before(adj, hw, a_src, a_dst, 0.2)
    got = gat_attention_reference(adj, hw, a_src, a_dst, 0.2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(gat_attention(adj, hw, a_src, a_dst, 0.2), want[0])
    att = want[0]
    assert not att[adj.nnz:].any()
    rp = adj.rowptr()
    sums = torch.stack([att[rp[i]:rp[i + 1]].sum(0) for i in range(N)])
    empty = rp[1:] == rp[:-1]
    torch.testing.assert_close(sums[~empty], torch.ones_like(sums[~empty]))
    assert not sums[empty].any()


def _small(dtype=torch.float64):
    """12 nodes, an empty row (5), padding; H = 2, D = 3."""
    row = torch.tensor([0, 0, 0, 1, 2, 2, 3, 4, 4, 4, 4, 6, 7, 7, 8, 9, 9,
                        10, 11, 11])
    col = torch.tensor([1, 2, 5, 0, 3, 4, 3, 0, 1, 2, 11, 7, 6, 8, 9, 10, 1,
                        0, 11, 4])
    adj = PaddedCOO.from_arrays(row, col, None, (12, 12), capacity=24)
    hw, a_src, a_dst = _inputs(12, 2, 3, dtype, seed=5)
    return adj, [t.requires_grad_() for t in (hw, a_src, a_dst)]


def test_backward_passes_gradcheck():
    adj, inputs = _small()
    assert torch.autograd.gradcheck(
        lambda *t: gat_attention(adj, *t, 0.2), inputs)


def test_backward_passes_gradgradcheck():
    adj, inputs = _small()
    assert torch.autograd.gradgradcheck(
        lambda *t: gat_attention(adj, *t, 0.2), inputs)


@pytest.mark.parametrize("H", [1, 3])
def test_backward_equals_autograd_through_the_plain_version(H):
    """Every grad of a weighted sum of the weights, the Function's own
    backward against autograd through ``gat_attention_reference``, on the
    graph with a hub row and padding (the weights of padding entries get
    a nonzero cotangent, and must pass no grad)."""
    adj = _graph(seed=2)
    hw, a_src, a_dst = (t.requires_grad_() for t in _inputs(
        N, H, 24, torch.float64, seed=3))
    w = torch.randn(adj.capacity, H, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad(
        (gat_attention(adj, hw, a_src, a_dst, 0.2) * w).sum(),
        (hw, a_src, a_dst))
    want = torch.autograd.grad(
        (gat_attention_reference(adj, hw, a_src, a_dst, 0.2)[0] * w).sum(),
        (hw, a_src, a_dst))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def test_wrapper_refuses_the_cpu_and_other_dtypes():
    adj = _graph(n=40, hub=False)
    hw, a_src, a_dst = _inputs(40, 2, 8)
    args = (adj.rowptr(), adj.col, hw, a_src, a_dst, 0.2, None)
    with pytest.raises(ValueError, match="runs on cuda, not cpu"):
        gat_attention_cuda(*args)
    with pytest.raises(TypeError, match="f32 or f64"):
        gk._check_scores(hw.bfloat16(), a_src, a_dst)
    with pytest.raises(ValueError, match=r"\(N, H, D\)"):
        gk._check_scores(hw, a_src[:1], a_dst)


def test_edge_pass_refuses_the_cpu_and_bad_scores():
    """The edge pass alone: CPU scores, scores of two shapes or dtypes,
    more rows than scored nodes, float indices."""
    adj = _graph(n=40, hub=False)
    s = torch.randn(40, 2)
    with pytest.raises(ValueError, match="runs on cuda, not cpu"):
        gk.gat_softmax_cuda(adj.rowptr(), adj.col, s, s, 0.2, None)
    with pytest.raises(ValueError, match=r"one \(N, H\) shape"):
        gk._check_edges(adj.rowptr(), adj.col, s, s[:, :1])
    with pytest.raises(TypeError, match="scores of one dtype"):
        gk._check_edges(adj.rowptr(), adj.col, s, s.double())
    with pytest.raises(ValueError, match="41 rows but scores of 40 nodes"):
        gk._check_edges(torch.zeros(42, dtype=torch.int32), adj.col, s, s)
    with pytest.raises(TypeError, match="col must be int32 or int64"):
        gk._check_edges(adj.rowptr(), adj.col.float(), s, s)


def test_refuses_a_rectangular_adjacency():
    """Row scores and column scores come from the same N rows of ``hw``:
    an adjacency of M != N is refused before anything runs (its backward
    would add (M, H) and (N, H) grads)."""
    adj = PaddedCOO.from_arrays(torch.tensor([0, 1, 2]),
                                torch.tensor([3, 0, 4]), None, (3, 5))
    hw, a_src, a_dst = _inputs(5, 2, 4)
    with pytest.raises(ValueError, match=r"square adjacency, got \(3, 5\)"):
        gat_attention(adj, hw, a_src, a_dst, 0.2)
