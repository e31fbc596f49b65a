"""Port parity: the run compaction of paddle_sparse_tpu_torch (its plain
version, which CPU tensors take) against the JAX Pallas kernel
``compact_sorted_stream`` in interpret mode and a dict oracle in f64, on the
same numpy grids, and its value gradient against ``jax.grad`` of
``compact_runs``.

Tolerances: coordinates and the unique count exact. Values within
``5e-5 * max(1, max|v|)`` of the JAX kernel, whose values ride as Dekker
hi/lo bf16 pairs (``tests/test_segcompact.py``), and within ``1e-6 * scale``
of the f64 oracle: the port sums f32 runs of at most F elements in stream
order. Gradients are gathers of the cotangent: with a loss linear in the
output values the cotangent is the same on both sides, so they match to
``rtol=atol=1e-6``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu.ops.kernels.segcompact import (compact_runs as
                                                      j_compact_runs,
                                                      compact_sorted_stream)
from paddle_sparse_tpu_torch import (compact_runs, compact_runs_cuda,
                                     compact_runs_reference)

GRID_CASES = [
    (7, 16, 12, 8),       # chunk-boundary runs + trailing-pad boundaries
    (32, 8, 40, 16),
    (5, 32, 6, 64),       # heavy duplication (tiny N)
    (1, 8, 4, 8),
    (3, 8, 5, 128),       # single chunk
    (64, 16, 100, 32),
]


def _random_grid(rng, M, F, N):
    key = np.full((M, F), N, np.int32)
    prod = np.zeros((M, F), np.float32)
    for m in range(M):
        u = int(rng.integers(0, F + 1))
        key[m, :u] = np.sort(rng.integers(0, N, u))
        prod[m, :u] = rng.standard_normal(u)
    return key, prod


def _oracle(rows, key, prod, N):
    """``[((row, col), f64 sum)]`` in (row, col) order, rows of each grid
    row given by ``rows``."""
    ref = {}
    for m in range(key.shape[0]):
        for f in range(key.shape[1]):
            if key[m, f] < N:
                k = (int(rows[m]), int(key[m, f]))
                ref[k] = ref.get(k, 0.0) + float(prod[m, f])
    return sorted(ref.items())


def _port(key, rows, prod, shape, cap, seg=False):
    return compact_runs_cuda(
        torch.from_numpy(key), torch.from_numpy(rows),
        None if prod is None else torch.from_numpy(prod), shape, cap, seg=seg)


def _check_oracle(out, items, n_keep):
    assert int(out.count) == len(items)
    got = items[:n_keep]
    np.testing.assert_array_equal(out.row[:n_keep].numpy(),
                                  [i[0][0] for i in got])
    np.testing.assert_array_equal(out.col[:n_keep].numpy(),
                                  [i[0][1] for i in got])
    if out.value is not None and got:
        v = np.array([i[1] for i in got])
        scale = max(1.0, float(np.abs(v).max()))
        assert np.abs(out.value[:n_keep].double().numpy() - v).max() \
            <= 1e-6 * scale


def _check_pads(out, n_keep, M, N):
    assert (out.row[n_keep:] == M).all() and (out.col[n_keep:] == N).all()
    if out.value is not None:
        assert not out.value[n_keep:].any()


@pytest.mark.parametrize("M,F,N,E", GRID_CASES)
def test_grid_matches_jax_kernel_and_oracle(M, F, N, E):
    rng = np.random.default_rng(M * 1000 + F)
    key, prod = _random_grid(rng, M, F, N)
    rows = np.arange(M, dtype=np.int32)
    cap = int((key < N).sum()) + 3
    out = _port(key, rows, prod, (M, N), cap)
    items = _oracle(rows, key, prod, N)
    n = len(items)
    _check_oracle(out, items, n)
    _check_pads(out, n, M, N)
    jr, jc, jv, juc = jax.jit(lambda k, p: compact_sorted_stream(
        k, p, jnp.asarray(rows), N, cap, E=E, interpret=True))(
        jnp.asarray(key), jnp.asarray(prod))
    assert int(juc) == int(out.count)
    np.testing.assert_array_equal(out.row[:n].numpy(), np.asarray(jr)[:n])
    np.testing.assert_array_equal(out.col[:n].numpy(), np.asarray(jc)[:n])
    scale = max(1.0, float(np.abs(np.asarray(jv)[:n]).max())) if n else 1.0
    np.testing.assert_allclose(out.value[:n].numpy(), np.asarray(jv)[:n],
                               rtol=0, atol=5e-5 * scale)


def test_empty_and_full_rows():
    M, F, N = 4, 8, 6
    key = np.full((M, F), N, np.int32)
    prod = np.zeros((M, F), np.float32)
    key[1, :] = [0, 0, 1, 1, 1, 2, 5, 5]                # a full row
    prod[1, :] = np.arange(1.0, 9.0)
    rows = np.arange(M, dtype=np.int32)
    out = _port(key, rows, prod, (M, N), 8)
    _check_oracle(out, _oracle(rows, key, prod, N), 4)
    np.testing.assert_array_equal(out.value[:4].numpy(), [3, 12, 6, 15])
    _check_pads(out, 4, M, N)


def test_grid_rows_of_a_row_block():
    """A row block's grid rows map to ``r0 + arange``, as in
    ``spspmm_rowblocked``; a grid row may hold a pad-only row."""
    rng = np.random.default_rng(4)
    M, F, N, r0 = 9, 12, 7, 30
    key, prod = _random_grid(rng, M, F, N)
    key[3] = N
    rows = np.arange(r0, r0 + M, dtype=np.int32)
    items = _oracle(rows, key, prod, N)
    out = _port(key, rows, prod, (r0 + M, N), len(items) + 2)
    _check_oracle(out, items, len(items))


@pytest.mark.parametrize("extra", [0, -1, -7])
def test_truncation_keeps_the_first_slots(extra):
    """``out_capacity`` below the unique count: the first slots are kept and
    ``count`` still says how many runs there were; the JAX kernel agrees on
    the kept slots."""
    rng = np.random.default_rng(12)
    M, F, N = 11, 16, 9
    key, prod = _random_grid(rng, M, F, N)
    rows = np.arange(M, dtype=np.int32)
    items = _oracle(rows, key, prod, N)
    cap = len(items) + extra
    out = _port(key, rows, prod, (M, N), cap, seg=True)
    _check_oracle(out, items, cap)
    assert out.row.shape == (cap,)
    seg = out.seg.numpy().reshape(M, F)
    assert (seg[key == N] == -1).all()
    assert seg.max() == cap - 1
    jr, jc, jv, juc = compact_sorted_stream(
        jnp.asarray(key), jnp.asarray(prod), jnp.asarray(rows), N, cap, E=16,
        interpret=True)
    assert int(juc) == len(items)
    np.testing.assert_array_equal(out.row.numpy(), np.asarray(jr)[:cap])
    np.testing.assert_array_equal(out.col.numpy(), np.asarray(jc)[:cap])


def _flat_stream(rng, M, N, L, pads):
    """A globally (row, col)-sorted flat stream with runs and ``pads``
    trailing (M, N) pads."""
    row = np.sort(rng.integers(0, M, L))
    col = rng.integers(0, N, L)
    order = np.lexsort((col, row))
    row = np.concatenate([row[order], np.full(pads, M)]).astype(np.int32)
    col = np.concatenate([col[order], np.full(pads, N)]).astype(np.int32)
    val = np.concatenate([rng.standard_normal(L),
                          np.zeros(pads)]).astype(np.float32)
    return row, col, val


@pytest.mark.parametrize("with_value", [True, False])
def test_flat_sorted_stream(with_value):
    """The flat layout (``spspmm_padded``, ``coalesce``): one row per
    element. The JAX kernel takes it as an (L, 1) grid whose grid rows are
    the elements."""
    rng = np.random.default_rng(5)
    M, N = 13, 8
    row, col, val = _flat_stream(rng, M, N, 300, 17)
    items = _oracle(row, col[:, None], val[:, None], N)
    out = _port(col, row, val if with_value else None, (M, N),
                len(items) + 4)
    assert (out.value is None) == (not with_value)
    _check_oracle(out, items, len(items))
    _check_pads(out, len(items), M, N)
    jr, jc, _, juc = compact_sorted_stream(
        jnp.asarray(col[:, None]), jnp.asarray(val[:, None]),
        jnp.asarray(row), N, len(items) + 4, E=64, interpret=True)
    n = int(juc)
    assert n == len(items)
    np.testing.assert_array_equal(out.row[:n].numpy(), np.asarray(jr)[:n])
    np.testing.assert_array_equal(out.col[:n].numpy(), np.asarray(jc)[:n])


def test_flat_stream_poisoned_pads_and_trailing_dims():
    """Pads with a row of M and any col are invalid; the plain version sums
    values with trailing dims (``coalesce`` of a (capacity, D) value)."""
    rng = np.random.default_rng(6)
    M, N = 10, 6
    row, col, val = _flat_stream(rng, M, N, 120, 9)
    col[-9:] = [0, 3, -4, 1 << 30, 5, 2, 2, 0, 7]
    items = _oracle(row, col[:, None], val[:, None], N)
    wide = np.stack([val, 2 * val, -val], axis=1)
    out = _port(col, row, wide, (M, N), len(items))
    assert out.value.shape == (len(items), 3)
    v = np.array([i[1] for i in items])
    np.testing.assert_allclose(out.value.numpy(),
                               np.stack([v, 2 * v, -v], axis=1), rtol=1e-6,
                               atol=1e-6)


def test_empty_stream():
    out = _port(np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                np.zeros((0,), np.float32), (4, 5), 3, seg=True)
    assert int(out.count) == 0 and out.seg.numel() == 0
    _check_pads(out, 0, 4, 5)


@pytest.mark.parametrize("cap_extra", [2, -5])
def test_value_grad_matches_jax(cap_extra):
    """``d prod[e] = d valC[seg[e]]`` for kept elements, 0 for pads and for
    runs past ``out_capacity``: the JAX custom VJP of ``compact_runs``."""
    rng = np.random.default_rng(3)
    M, F, N, E = 9, 16, 10, 16
    key, prod = _random_grid(rng, M, F, N)
    rows = np.arange(M, dtype=np.int32)
    cap = len(_oracle(rows, key, prod, N)) + cap_extra
    weight = rng.standard_normal(cap).astype(np.float32)

    def j_loss(p):
        _, _, valC, _ = j_compact_runs(N, cap, E, True, jnp.asarray(key), p,
                                       jnp.asarray(rows))
        return (valC * jnp.asarray(weight)).sum()

    g_ref = jax.grad(j_loss)(jnp.asarray(prod))
    p = torch.from_numpy(prod).requires_grad_()
    out = compact_runs(torch.from_numpy(key), torch.from_numpy(rows), p,
                       (M, N), cap)
    assert out.seg is None
    (out.value * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(g_ref), rtol=1e-6,
                               atol=1e-6)
    assert not p.grad[torch.from_numpy(key) == N].any()


def test_value_grad_f64_gradcheck_and_no_double_backward():
    rng = np.random.default_rng(8)
    M, F, N = 5, 8, 4
    key, prod = _random_grid(rng, M, F, N)
    kt, rt = torch.from_numpy(key), torch.arange(M, dtype=torch.int32)
    p = torch.from_numpy(prod).double().requires_grad_()

    def f(v):
        return compact_runs(kt, rt, v, (M, N), 12).value

    assert torch.autograd.gradcheck(f, (p,))
    out = f(p)
    g, = torch.autograd.grad(out.sum(), p, create_graph=True)
    with pytest.raises(RuntimeError):
        g.sum().backward()


def test_cpu_takes_the_plain_version():
    """A CPU tensor runs the plain version and counts no launch; the
    differentiable entry point agrees with it."""
    rng = np.random.default_rng(9)
    key, prod = _random_grid(rng, 6, 8, 5)
    before = compact_runs_cuda.launches
    rows = torch.arange(6, dtype=torch.int32)
    a = compact_runs_cuda(torch.from_numpy(key), rows,
                          torch.from_numpy(prod), (6, 5), 20)
    b = compact_runs_reference(torch.from_numpy(key), rows,
                               torch.from_numpy(prod), (6, 5), 20)
    c = compact_runs(torch.from_numpy(key), rows,
                     torch.from_numpy(prod).requires_grad_(), (6, 5), 20)
    assert compact_runs_cuda.launches == before
    for x, y, z in zip(a[:4], b[:4], c[:4]):
        assert torch.equal(x, y) and torch.equal(x, z.detach())
