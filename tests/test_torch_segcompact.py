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
    """f64 ``gradcheck`` and ``gradgradcheck``; the double backward that
    raised before now runs, and the grad of the value-grad penalty
    ``sum(d loss / d prod ** 2)`` for ``loss = sum(w * valC ** 2)`` equals
    JAX's ``jax.grad`` of ``jax.grad`` in f32 (the Pallas kernel sums in
    f32 whatever the dtype: ``rtol = 1e-5``, ``atol`` 1e-5 of the largest
    entry)."""
    rng = np.random.default_rng(8)
    M, F, N, cap = 5, 8, 4, 12
    key, prod = _random_grid(rng, M, F, N)
    kt, rt = torch.from_numpy(key), torch.arange(M, dtype=torch.int32)
    p = torch.from_numpy(prod).double().requires_grad_()
    w = rng.standard_normal(cap)

    def f(v):
        return compact_runs(kt, rt, v, (M, N), cap).value

    assert torch.autograd.gradcheck(f, (p,))
    assert torch.autograd.gradgradcheck(f, (p,))
    p32 = torch.from_numpy(prod).float().requires_grad_()
    g, = torch.autograd.grad((torch.from_numpy(w).float() * f(p32) ** 2
                              ).sum(), p32, create_graph=True)
    (g ** 2).sum().backward()

    def j_loss(v):
        _, _, valC, _ = j_compact_runs(N, cap, 16, True, jnp.asarray(key), v,
                                       jnp.asarray(rt.numpy()))
        return (jnp.asarray(w, jnp.float32) * valC ** 2).sum()

    want = np.asarray(jax.grad(lambda v: (jax.grad(j_loss)(v) ** 2).sum())(
        jnp.asarray(prod, jnp.float32)))
    np.testing.assert_allclose(p32.grad.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


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


# ---- grid rows in any order (rows_sorted=False): the compaction sorts -----

def _unsorted(rng, key, prod):
    """Each grid row in a random order, as the SpGEMM expansion leaves it."""
    perm = np.argsort(rng.random(key.shape), axis=1)
    return (np.take_along_axis(key, perm, 1),
            np.take_along_axis(prod, perm, 1))


def _tied_grid(rng, M, F, N):
    """Rows full of repeated cols (ties), pads scattered among them."""
    key = rng.integers(0, N, (M, F)).astype(np.int32)
    key[rng.random((M, F)) < 0.3] = N
    prod = np.where(key < N, rng.standard_normal((M, F)), 0).astype(
        np.float32)
    return key, prod


def _jax_sorted(key, prod):
    """JAX's own row sort (unstable among ties) of the grid."""
    k, p = jax.lax.sort((jnp.asarray(key), jnp.asarray(prod)), dimension=1,
                        num_keys=1)
    return k, p


@pytest.mark.parametrize("M,F,N,E", GRID_CASES + [(40, 24, 3, 16),
                                                  (9, 64, 2, 64)])
def test_unsorted_rows_match_jax_sort_and_kernel(M, F, N, E):
    """``rows_sorted=False`` against ``jax.lax.sort`` of each row then
    ``compact_sorted_stream`` in interpret mode: coordinates and count
    exact, values within ``5e-5 * scale`` of it and ``1e-6 * scale`` of the
    f64 oracle; ties of equal cols in the last two shapes."""
    rng = np.random.default_rng(M * 7 + F)
    make = _tied_grid if N <= 3 else _random_grid
    key, prod = _unsorted(rng, *make(rng, M, F, N))
    rows = np.arange(M, dtype=np.int32)
    cap = int((key < N).sum()) + 3
    out = compact_runs_cuda(torch.from_numpy(key), torch.from_numpy(rows),
                            torch.from_numpy(prod), (M, N), cap,
                            rows_sorted=False)
    items = _oracle(rows, key, prod, N)
    n = len(items)
    _check_oracle(out, items, n)
    _check_pads(out, n, M, N)
    jk, jp = _jax_sorted(key, prod)
    jr, jc, jv, juc = compact_sorted_stream(jk, jp, jnp.asarray(rows), N,
                                            cap, E=E, interpret=True)
    assert int(juc) == int(out.count) == n
    np.testing.assert_array_equal(out.row[:n].numpy(), np.asarray(jr)[:n])
    np.testing.assert_array_equal(out.col[:n].numpy(), np.asarray(jc)[:n])
    scale = max(1.0, float(np.abs(np.asarray(jv)[:n]).max())) if n else 1.0
    np.testing.assert_allclose(out.value[:n].numpy(), np.asarray(jv)[:n],
                               rtol=0, atol=5e-5 * scale)


@pytest.mark.parametrize("cap_extra", [4, -6])
def test_unsorted_rows_seg_in_input_order(cap_extra):
    """``seg[e]`` names element e's run in the input's own order: the slot
    holds e's (row, col), or -1 for pads and runs past ``out_capacity``;
    it equals the sorted grid's seg carried back through the sort."""
    rng = np.random.default_rng(21)
    M, F, N = 12, 16, 5
    key, prod = _unsorted(rng, *_tied_grid(rng, M, F, N))
    rows = np.arange(M, dtype=np.int32)
    cap = len(_oracle(rows, key, prod, N)) + cap_extra
    kt = torch.from_numpy(key)
    out = compact_runs_cuda(kt, torch.from_numpy(rows),
                            torch.from_numpy(prod), (M, N), cap, seg=True,
                            rows_sorted=False)
    seg = out.seg.view(M, F)
    kept = seg >= 0
    assert not kept[kt == N].any()
    r = torch.arange(M, dtype=torch.int32)[:, None].expand(M, F)
    assert torch.equal(out.col[seg[kept].long()], kt[kept])
    assert torch.equal(out.row[seg[kept].long()], r[kept])
    sk, perm = torch.sort(kt, dim=1, stable=True)
    ref = compact_runs_cuda(sk.contiguous(), torch.from_numpy(rows),
                            torch.from_numpy(prod).gather(1, perm), (M, N),
                            cap, seg=True)
    assert torch.equal(seg.gather(1, perm), ref.seg.view(M, F))
    assert torch.equal(out.value, ref.value)


@pytest.mark.parametrize("cap_extra", [2, -5])
def test_unsorted_rows_value_grad_matches_jax(cap_extra):
    """The value grad with the rows sorted inside: ``jax.grad`` of the JAX
    ``compact_runs`` on the stably sorted grid, carried back to the input
    order."""
    rng = np.random.default_rng(13)
    M, F, N, E = 9, 16, 6, 16
    key, prod = _unsorted(rng, *_tied_grid(rng, M, F, N))
    rows = np.arange(M, dtype=np.int32)
    cap = len(_oracle(rows, key, prod, N)) + cap_extra
    weight = rng.standard_normal(cap).astype(np.float32)
    perm = np.argsort(key, axis=1, kind="stable")
    sk = np.take_along_axis(key, perm, 1)
    sp = np.take_along_axis(prod, perm, 1)

    def j_loss(p):
        _, _, valC, _ = j_compact_runs(N, cap, E, True, jnp.asarray(sk), p,
                                       jnp.asarray(rows))
        return (valC * jnp.asarray(weight)).sum()

    g_sorted = np.asarray(jax.grad(j_loss)(jnp.asarray(sp)))
    g_ref = np.zeros_like(prod)
    np.put_along_axis(g_ref, perm, g_sorted, 1)
    p = torch.from_numpy(prod).requires_grad_()
    out = compact_runs(torch.from_numpy(key), torch.from_numpy(rows), p,
                       (M, N), cap, rows_sorted=False)
    (out.value * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), g_ref, rtol=1e-6, atol=1e-6)


def test_rows_sorted_false_needs_a_grid():
    with pytest.raises(ValueError, match="grid"):
        compact_runs_reference(torch.zeros(5, dtype=torch.int32),
                               torch.zeros(5, dtype=torch.int32), None, (1, 2),
                               5, rows_sorted=False)


@pytest.mark.parametrize("variant", ["rowsorted", "rowblocked"])
def test_sorted_row_grid_f_max_dispatch(monkeypatch, variant):
    """``_sorted_row_grid`` hands grids of ``F <= F_MAX`` to the compress
    unsorted and sorts wider ones itself: both branches give the same C,
    values and grads."""
    from paddle_sparse_tpu_torch import (PaddedCOO, plan_spgemm_blocked,
                                         plan_spgemm_rows, spspmm_rowblocked,
                                         spspmm_rowsorted)
    from paddle_sparse_tpu_torch.core import spgemm
    from paddle_sparse_tpu_torch.ops.kernels import segcompact_cuda
    rng = np.random.default_rng(17)
    M, nnz = 60, 500
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, M, nnz)
    order = np.lexsort((col, row))
    A = PaddedCOO.from_arrays(row[order], col[order],
                              rng.standard_normal(nnz).astype(np.float32),
                              (M, M), capacity=nnz + 7).coalesce()
    calls = []
    real = spgemm._sorted_row_grid

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append(out[2])
        return out

    monkeypatch.setattr(spgemm, "_sorted_row_grid", spy)
    runs = []
    for f_max in (segcompact_cuda.F_MAX, 1):
        monkeypatch.setattr(segcompact_cuda, "F_MAX", f_max)
        v = A.value.clone().requires_grad_()
        Ai = A.with_value(v)
        if variant == "rowsorted":
            F, oc = plan_spgemm_rows(Ai, Ai)
            res = spspmm_rowsorted(Ai, Ai, F, oc)
        else:
            F, oc, _, EB, BOC = plan_spgemm_blocked(Ai, Ai)
            res = spspmm_rowblocked(Ai, Ai, F, oc, 16, EB, BOC)
        res.matrix.value.sum().backward()
        runs.append((res.matrix, v.grad))
    assert calls and not calls[0] and all(calls[-1:])
    (c1, g1), (c2, g2) = runs
    assert c1.nnz == c2.nnz > 0
    assert torch.equal(c1.row, c2.row) and torch.equal(c1.col, c2.col)
    assert torch.equal(c1.value, c2.value) and torch.equal(g1, g2)
