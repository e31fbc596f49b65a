"""The window plan of the windowed CSR SpMM of paddle_sparse_tpu_torch
(``ops/kernels/row_window.py``) on the CPU: each tile's best window and its
in-window edges against a numpy recount, the flag rule at its threshold,
no flag on a uniform graph, every tile of a small clustered graph flagged,
split-row tiles left out, the TMA rules of :func:`applies`, windows clamped
at N; ``spmm_window_cuda`` on a CPU tensor (its plain version) filling the
flagged tiles' rows and no other; and, on a small clustered graph, the split
of rows a plan makes (flagged tiles through the windowed kernel's plain
version, the others through K1's) and ``PaddedCOO.spmm`` (the port's path,
which takes no plan), forward and both grads, against the JAX package's
``spmm_coo`` (XLA).

On the CPU the plan only selects rows: the plain version sums each flagged
row as ``spmm_csr_reference`` does, since a window moves where a row of
``x`` is read from, not what is summed. The windowed kernel itself is held
against K1 bit for bit on the card (``tests/test_torch_cuda.py``).

Tolerances: against ``spmm_csr_reference`` and the JAX package in f32
``rtol=atol=1e-5``: the same f32 products summed in another order (per row
in JAX's segment sum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu.ops.spmm as jspmm
from paddle_sparse_tpu_torch import (PaddedCOO, spmm_csr_reference,
                                     spmm_window_cuda, spmm_window_reference,
                                     split_rows, window_plan)
from paddle_sparse_tpu_torch.ops.kernels import row_window as RW

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _csr(deg, col):
    rowptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return _t(rowptr), _t(np.asarray(col, np.int32))


def _clustered(M, N, deg, block, p_in=0.85, seed=0):
    """Rows of ``deg`` edges (0 for a few), each inside the row's
    ``block``-row community with probability ``p_in``, else uniform."""
    rng = np.random.default_rng(seed)
    d = np.full(M, deg)
    d[[0, M // 3, M - 1]] = 0
    row = np.repeat(np.arange(M), d)
    home = np.minimum(row * N // M // block * block
                      + rng.integers(0, block, row.size), N - 1)
    col = np.where(rng.random(row.size) < p_in, home,
                   rng.integers(0, N, row.size))
    return d, col


def _recount(rowptr, col, N, T, W):
    """Each tile's window start, in-window and all edges, by brute force:
    the smallest edge column c with the most edges in [c, c + W), moved
    down to N - W (not below 0)."""
    rp, col = rowptr.numpy(), col.numpy()
    M = rp.size - 1
    out = []
    for t in range(-(-M // T)):
        c = np.sort(col[rp[t * T]:rp[min(t * T + T, M)]])
        best = N
        if c.size:
            counts = [np.sum((c >= v) & (c < v + W)) for v in c]
            best = c[int(np.argmax(counts))]
        w0 = max(0, min(best, N - W))
        out.append((w0, int(np.sum((c >= w0) & (c < w0 + W))), c.size))
    return np.array(out, dtype=np.int64).reshape(-1, 3)


def _graphs():
    rng = np.random.default_rng(1)
    w = rng.zipf(1.5, 300).astype(np.float64)
    zdeg = np.maximum(1, np.floor(w * (3000 / w.sum()))).astype(np.int64)
    empty = rng.integers(0, 12, 250)
    empty[rng.integers(0, 250, 60)] = 0
    return {"clustered": _clustered(300, 280, 10, 32),
            "uniform": (rng.integers(0, 15, 300), None),
            "empty_rows": (empty, None),
            "power_law": (zdeg, None)}


@pytest.mark.parametrize("T,W", [(8, 4), (64, 40), (100, 64), (7, 1000)])
@pytest.mark.parametrize("kind", ["clustered", "uniform", "empty_rows",
                                  "power_law"])
def test_plan_matches_numpy_recount(kind, T, W):
    """Every tile's ``w0``, in-window edges and edges equal the brute-force
    recount, and the flags follow the 2 W rule."""
    deg, col = _graphs()[kind]
    N = 280
    if col is None:
        col = np.random.default_rng(2).integers(0, N, int(np.sum(deg)))
    rowptr, colt = _csr(deg, col)
    plan = window_plan(rowptr, colt, N, None, T, W)
    want = _recount(rowptr, colt, N, T, W)
    np.testing.assert_array_equal(plan.w0.numpy(), want[:, 0])
    np.testing.assert_array_equal(plan.in_window.numpy(), want[:, 1])
    np.testing.assert_array_equal(plan.edges.numpy(), want[:, 2])
    flagged = want[:, 1] >= RW.MIN_GAIN * W
    np.testing.assert_array_equal(plan.flagged.numpy(), flagged)
    np.testing.assert_array_equal(plan.tiles.numpy(), np.nonzero(flagged)[0])
    np.testing.assert_array_equal(plan.tile_w0.numpy(), want[flagged, 0])
    assert plan.w0.dtype == plan.tiles.dtype == torch.int32


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_flag_rule_at_its_threshold(delta):
    """A tile of 2 W + delta edges inside one window (and three far apart
    outside it) is flagged exactly when delta >= 0."""
    W, T, N = 4, 4, 100
    inside = list(np.arange(2 * W + delta) % W + 10)
    col = inside + [60, 75, 90]
    deg = [len(inside), 3, 0, 0]
    plan = window_plan(*_csr(deg, col), N, None, T, W)
    assert int(plan.in_window[0]) == 2 * W + delta
    assert int(plan.w0[0]) == 10
    assert bool(plan.flagged[0]) == (delta >= 0)
    assert plan.tiles.tolist() == ([0] if delta >= 0 else [])


def test_uniform_graph_flags_nothing():
    """Uniform columns over N much larger than W: no tile's best window
    comes near 2 W at the default tile and window."""
    M = N = 300_000
    rng = np.random.default_rng(3)
    deg = np.full(M, 6)
    col = rng.integers(0, N, int(deg.sum()))
    plan = window_plan(*_csr(deg, col), N)
    assert plan.tile_rows == RW.TILE_ROWS and plan.window_rows == RW.WINDOW_ROWS
    assert not bool(plan.flagged.any()) and plan.tiles.numel() == 0
    assert plan.tile_w0.numel() == 0
    assert int(plan.in_window.max()) < RW.MIN_GAIN * RW.WINDOW_ROWS // 10


def test_clustered_graph_tiles_flagged():
    """``bench.py``'s clustered shape at a small size (communities of 512
    rows, 85% of each row's edges inside): every tile flagged at the
    default tile and window, each window inside its tile's communities."""
    M = N = 6144
    deg, col = _clustered(M, N, 8, 512)
    rowptr, colt = _csr(deg, col)
    plan = window_plan(rowptr, colt, N)
    assert plan.tiles.tolist() == [0, 1, 2] and bool(plan.flagged.all())
    for t, w0 in enumerate(plan.tile_w0.tolist()):
        lo = t * RW.TILE_ROWS
        assert lo - RW.WINDOW_ROWS < w0 <= lo + RW.TILE_ROWS - 1
    assert float(plan.in_window.sum()) > 0.7 * float(plan.edges.sum())


def test_split_row_tiles_unflagged():
    """A tile that holds a piece of a split row is not flagged (the
    register walk keeps the row's pieces and fold), though it would be
    without the split; the other tiles keep their flags."""
    M = N = 64
    deg, col = _clustered(M, N, 6, 16, p_in=1.0)
    deg = deg.copy()
    deg[20] = 40                                   # cut into pieces of 8
    rng = np.random.default_rng(4)
    row = np.repeat(np.arange(M), deg)
    col = np.minimum(row // 16 * 16 + rng.integers(0, 16, row.size), N - 1)
    rowptr, colt = _csr(deg, col)
    split = split_rows(rowptr[None, :-1], rowptr[None, 1:], cap=8)
    assert split.fold_row.tolist() == [20]
    plan = window_plan(rowptr, colt, N, split, tile_rows=16, window_rows=8)
    free = window_plan(rowptr, colt, N, None, tile_rows=16, window_rows=8)
    assert bool(free.flagged[1]) and not bool(plan.flagged[1])
    assert plan.flagged.tolist() == [True, False, True, True]
    assert plan.tiles.tolist() == [0, 2, 3]
    assert torch.equal(plan.tile_w0, free.tile_w0[[0, 2, 3]])


@pytest.mark.parametrize("dtype,K,ok", [
    (torch.float32, 1, False), (torch.float32, 3, False),
    (torch.float32, 47, False), (torch.float32, 4, True),
    (torch.float32, 100, True), (torch.float32, 256, True),
    (torch.bfloat16, 4, False), (torch.bfloat16, 100, False),
    (torch.bfloat16, 8, True), (torch.bfloat16, 256, True),
    (torch.float64, 256, False), (torch.float16, 256, False)])
def test_applies_rules(dtype, K, ok):
    """The plan applies to f32 and bf16 rows whose bytes are a multiple of
    16 (TMA's stride rule), never to another dtype, never to an x that
    starts off a 16-byte boundary, and never when nothing is flagged."""
    M = N = 4096
    deg, col = _clustered(M, N, 8, 512)
    plan = window_plan(*_csr(deg, col), N)
    x = torch.zeros(N, K, dtype=dtype)
    assert RW.applies(plan, x) == ok
    assert not RW.applies(None, x)
    base = torch.zeros(N * K + 4, dtype=dtype)
    assert not RW.applies(plan, base[1:N * K + 1].view(N, K))
    none = window_plan(*_csr(deg, col), N, None, tile_rows=4,
                       window_rows=10_000)
    assert none.tiles.numel() == 0 and not RW.applies(none, x)


def test_windows_clamped_at_n():
    """A tile whose edges sit at the last columns gets [N - W, N); a
    window wider than N starts at 0."""
    N, W = 50, 8
    deg = [5, 0]
    col = [45, 46, 47, 48, 49]
    plan = window_plan(*_csr(deg, col), N, None, 2, W)
    assert int(plan.w0[0]) == N - W and int(plan.in_window[0]) == 5
    plan = window_plan(*_csr(deg, col), N, None, 2, 64)
    assert int(plan.w0[0]) == 0 and int(plan.in_window[0]) == 5


@pytest.mark.parametrize("with_split", [False, True])
@pytest.mark.parametrize("with_value", [True, False])
def test_window_plain_version_fills_flagged_rows(with_split, with_value):
    """``spmm_window_cuda`` on CPU tensors (its plain version) gives
    ``spmm_csr_reference``'s rows of the flagged tiles, a split row's tile
    among the unflagged ones, and 0 on every other row."""
    M, N, K = 96, 80, 12
    rng = np.random.default_rng(5)
    deg, col = _clustered(M, N, 7, 16)
    if with_split:
        deg = deg.copy()
        deg[40] = 30
        row = np.repeat(np.arange(M), deg)
        col = np.where(rng.random(row.size) < 0.85,
                       np.minimum(row * N // M // 16 * 16
                                  + rng.integers(0, 16, row.size), N - 1),
                       rng.integers(0, N, row.size))
    rowptr, colt = _csr(deg, col)
    split = (split_rows(rowptr[None, :-1], rowptr[None, 1:], cap=8)
             if with_split else None)
    plan = window_plan(rowptr, colt, N, split, tile_rows=16, window_rows=16)
    assert 0 < plan.tiles.numel() < plan.flagged.numel() or not with_split
    value = _t(rng.standard_normal(colt.numel()).astype(np.float32)) \
        if with_value else None
    x = _t(rng.standard_normal((N, K)).astype(np.float32))
    want = spmm_csr_reference(rowptr, colt, value, x)
    out = spmm_window_cuda(rowptr, colt, value, x, plan)      # the CPU path
    rows = plan.flagged.repeat_interleave(16)[:M]
    assert not with_split or not bool(rows[40])
    torch.testing.assert_close(out[rows], want[rows], **F32)
    assert not bool(out[~rows].any())
    assert torch.equal(out, spmm_window_reference(rowptr, colt, value, x,
                                                  plan))


def _jax_spmm_grads(row, col, val, x, w, M):
    r, c = jnp.asarray(row), jnp.asarray(col)

    def f(v, xx):
        return (jspmm.spmm_coo(r, c, v, xx, M, backend="xla") * w).sum()

    out = jspmm.spmm_coo(r, c, jnp.asarray(val), jnp.asarray(x), M,
                         backend="xla")
    dv, dx = jax.grad(f, argnums=(0, 1))(jnp.asarray(val), jnp.asarray(x))
    return np.asarray(out), np.asarray(dv), np.asarray(dx)


def _clustered_problem():
    """A 4,096-node clustered graph (communities of 512, 8 edges a row, a
    few empty rows) in seeded numpy: rows, columns, values, x and the
    cotangent ``w``."""
    M = N = 4096
    deg, col = _clustered(M, N, 8, 512)
    rng = np.random.default_rng(6)
    row = np.repeat(np.arange(M), deg).astype(np.int32)
    val = rng.standard_normal(row.size).astype(np.float32)
    x = rng.standard_normal((N, 8)).astype(np.float32)
    w = rng.standard_normal((M, 8)).astype(np.float32)
    return deg, row, col.astype(np.int32), val, x, w


def test_window_split_of_rows_vs_jax():
    """The split of rows a plan makes: its flagged tiles through the
    windowed kernel's plain version (``spmm_window_cuda`` on CPU tensors),
    the tiles it leaves out (rows 1,280 to 2,047, their columns made
    uniform) through K1's, and the two joined: output, ``d value`` and
    ``d x`` against the JAX package's ``spmm_coo``."""
    deg, row, col, val, x, w = _clustered_problem()
    M = N = x.shape[0]
    far = (row >= 1280) & (row < 2048)
    col = np.where(far, np.random.default_rng(7).integers(0, N, row.size),
                   col).astype(np.int32)
    rowptr, colt = _csr(deg, col)
    plan = window_plan(rowptr, colt, N, None, tile_rows=256,
                       window_rows=512)
    assert plan.flagged.tolist() == [True] * 5 + [False] * 3 + [True] * 8
    mask = plan.flagged.repeat_interleave(256)[:M, None]
    v = _t(val).requires_grad_()
    xt = _t(x).requires_grad_()
    out = torch.where(mask, spmm_window_cuda(rowptr, colt, v, xt, plan),
                      spmm_csr_reference(rowptr, colt, v, xt))
    (out * _t(w)).sum().backward()
    jout, jdv, jdx = _jax_spmm_grads(row, col, val, x, w, M)
    np.testing.assert_allclose(out.detach().numpy(), jout, **F32)
    np.testing.assert_allclose(v.grad.numpy(), jdv, **F32)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_padded_coo_spmm_on_clustered_graph_vs_jax(reduce):
    """``PaddedCOO.spmm`` on the clustered graph whose tiles a plan would
    all flag (no path builds one: the register walk measured faster), with
    padding: output, ``d value`` and ``d x`` equal the JAX package's."""
    deg, row, col, val, x, w = _clustered_problem()
    M = N = x.shape[0]
    assert bool(window_plan(*_csr(deg, col), N).flagged.all())
    adj = PaddedCOO.from_arrays(row, col, None, (M, N), capacity=row.size + 5)
    v = torch.zeros(adj.capacity)
    v[:row.size] = _t(val)
    v.requires_grad_()
    xt = _t(x).requires_grad_()
    out = adj.with_value(v).spmm(xt, reduce)
    (out * _t(w)).sum().backward()
    if reduce == "mean":
        d = np.maximum(deg, 1).astype(np.float32)[:, None]
        ww = w / d
    else:
        d, ww = 1.0, w
    jout, jdv, jdx = _jax_spmm_grads(row, col, val, x, ww, M)
    np.testing.assert_allclose(out.detach().numpy(), jout / d, **F32)
    np.testing.assert_allclose(v.grad[:row.size].numpy(), jdv, **F32)
    assert not bool(v.grad[row.size:].any())
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **F32)
