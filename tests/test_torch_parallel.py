"""Port parity across processes: the sharded SpMMs, the row-sharded SpGEMM
and the collectives of ``paddle_sparse_tpu_torch.parallel`` at world sizes
2 and 4 on gloo (``parallel.spawn``), against the JAX package's functions on
its virtual CPU mesh of the same size.

One spawn per world size runs every case (``tests/_torch_parallel_cases.py``,
which imports no JAX); each test compares one result. The graph is
``tests/test_parallel.py``'s (64 x 64, 512 entries, seed 3) with K = 16 and
a cotangent ``g`` from the same seed.

* ``spmm_allgather``, ``spmm_ring``, ``spmm_ring_bucketed``, ``spmm_halo``
  and ``spmm_2d`` (grid (2, D/2)): the output, ``d x`` and ``d value`` of
  ``sum(out * g)`` against ``jax.vjp``, within 1e-5 of each entry or of the
  largest entry (f32 sums in another order). ``d x`` of the 2-D SpMM is
  summed over the grid rows that hold the same ``x`` block, as JAX's
  transpose of its replication sums it.
* Poisoned padding: the all-gather and halo blocks with every padding entry
  at column 2**31 - 1 and value NaN give JAX's unpoisoned results (padding
  is never read; its ``d value`` is 0); ``x`` holds exactly N rows.
* ``spgemm_rowsharded``: C (rows and columns exact, values 1e-5) and the
  overflow flags against JAX's, and at a flop capacity that some shards
  exceed and some do not, the flags alone; ``allgather_padded`` gives the
  whole matrix back, padding last.
* The collectives: forward and backward against numpy (exact).
"""
import numpy as np
import pytest
import torch

import _jax_parallel_ref as ref
from _torch_parallel_cases import run_cases
from paddle_sparse_tpu import parallel as jpar
from paddle_sparse_tpu.ops.spspmm import plan_spgemm
from paddle_sparse_tpu_torch import PaddedCOO, SparseTensor
from paddle_sparse_tpu_torch import parallel as tpar

WORLDS = (2, 4)
SPMM = ("allgather", "ring", "ring_bucketed", "halo", "2d")
POISONED = ("allgather", "halo")
PARTS = ("out", "dx", "dv")


def _jobs(D):
    g = ref.graph_64()
    A, B, ops = ref.spgemm_operands()
    flop_cap, out_cap = plan_spgemm(A.to_padded(), B.to_padded())
    flops = ref.shard_flops(A, B, D)
    tight = int(np.sort(flops)[D // 2 - 1])        # some shards over, some not
    jobs = {name: (name, dict(g, grid=(2, D // 2))) for name in SPMM}
    jobs.update({f"{name}_poisoned": (f"{name}_poisoned", g)
                 for name in POISONED})
    jobs["spgemm"] = ("spgemm", dict(ops, flop_cap=flop_cap,
                                     out_cap=out_cap))
    jobs["spgemm_tight"] = ("spgemm", dict(ops, flop_cap=tight,
                                           out_cap=out_cap))
    jobs["allgather_padded"] = ("allgather_padded", ops)
    jobs["collectives"] = ("collectives", {})
    return jobs, (A, B, flop_cap, out_cap, tight, flops)


@pytest.fixture(scope="module")
def runs():
    """World size -> (the jobs' per-rank results, the SpGEMM operands)."""
    cache = {}

    def get(D):
        if D not in cache:
            jobs, extra = _jobs(D)
            cache[D] = tpar.spawn(run_cases, D, jobs, device="cpu"), extra
        return cache[D]
    return get


@pytest.fixture(scope="module")
def jax_spmm():
    cache = {}

    def get(name, D):
        if (name, D) not in cache:
            cache[name, D] = ref.spmm_vjp(name, D, dict(ref.graph_64(),
                                                        grid=(2, D // 2)))
        return cache[name, D]
    return get


def _assemble(name, part, ranks, D):
    """The global array of one part from every rank's block."""
    blocks = [r[part] for r in ranks]
    if part == "dx" and name == "2d":
        dc = D // 2        # rank r holds a partial of x block r % dc
        return np.concatenate([sum(blocks[j::dc]) for j in range(dc)])
    if part == "dv":
        return np.stack(blocks)
    return np.concatenate(blocks)


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", SPMM)
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_spmm(runs, jax_spmm, D, name, part):
    ranks = [r[name] for r in runs(D)[0]]
    want = jax_spmm(name, D)[part]
    got = _assemble(name, part, ranks, D)
    if name == "2d" and part == "dv":
        got = got.reshape(want.shape)
    ref.close(got, want, f"{name} {part}")


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", POISONED)
@pytest.mark.parametrize("D", WORLDS)
def test_poisoned_padding(runs, jax_spmm, D, name, part):
    """Padding at column 2**31 - 1 with value NaN is never read: the
    results equal JAX's on the unpoisoned blocks, padding's d value 0."""
    mat = jpar.shard_padded_coo(ref.tensor(ref.graph_64()), D)
    assert (np.asarray(mat.nnz) < mat.row.shape[1]).any(), "no padding"
    ranks = [r[f"{name}_poisoned"] for r in runs(D)[0]]
    got = _assemble(name, part, ranks, D)
    assert np.isfinite(got).all()
    ref.close(got, jax_spmm(name, D)[part], f"poisoned {name} {part}")


@pytest.mark.parametrize("D", WORLDS)
def test_spgemm_rowsharded_c(runs, D):
    results, (A, B, flop_cap, out_cap, _, _) = runs(D)
    ranks = [r["spgemm"] for r in results]
    (jrow, jcol, jval), jover = ref.jax_spgemm(A, B, D, flop_cap, out_cap)
    row, col, val = ref.c_of(ranks, (A.sizes()[0] // D, B.sizes()[1]))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    ref.close(val.numpy(), jval, "C values")
    dense = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())
    got = np.zeros_like(dense)
    np.add.at(got, (row.numpy(), col.numpy()), val.numpy())
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    for r in ranks:
        np.testing.assert_array_equal(r["overflowed"], jover)
    assert not jover.any()


@pytest.mark.parametrize("D", WORLDS)
def test_spgemm_rowsharded_overflow(runs, D):
    """At a flop capacity some shards exceed: the same (D,) flags as JAX's,
    on every rank."""
    results, (A, B, _, out_cap, tight, flops) = runs(D)
    _, jover = ref.jax_spgemm(A, B, D, tight, out_cap)
    np.testing.assert_array_equal(jover, flops > tight)
    assert jover.any() and not jover.all()
    for r in results:
        np.testing.assert_array_equal(r["spgemm_tight"]["overflowed"], jover)


@pytest.mark.parametrize("D", WORLDS)
def test_allgather_padded(runs, D):
    results, (_, B, _, _, _, _) = runs(D)
    whole = PaddedCOO.from_eager(SparseTensor(
        row=torch.as_tensor(np.array(B.storage.row())),
        col=torch.as_tensor(np.array(B.storage.col())),
        value=torch.as_tensor(np.array(B.storage.value())),
        sparse_sizes=B.sizes()))
    for r in results:
        got = r["allgather_padded"]
        n = int(got["nnz"])
        assert n == whole.nnz and tuple(got["shape"]) == whole.shape
        for f in ("row", "col", "value"):
            np.testing.assert_array_equal(got[f][:n],
                                          getattr(whole, f).numpy())
        np.testing.assert_array_equal(got["row"][n:], whole.shape[0])
        np.testing.assert_array_equal(got["col"][n:], whole.shape[1])
        np.testing.assert_array_equal(got["value"][n:], 0)


def _cot(r, shape):
    return (r + 1) * (1 + np.arange(int(np.prod(shape)),
                                    dtype=np.float32)).reshape(shape)


def _collective_want(op, D):
    """Numpy forward and backward of each collective on every rank, for the
    inputs and cotangents of ``case_collectives``."""
    base = np.arange(6, dtype=np.float32).reshape(3, 2)
    if op == "all_gather":
        xs = [base + 100 * r for r in range(D)]
        out = np.concatenate(xs)
        cots = [_cot(r, out.shape) for r in range(D)]
        return [(out, sum(c[3 * r:3 * r + 3] for c in cots))
                for r in range(D)]
    if op == "reduce_scatter":
        xs = [np.arange(D * 6, dtype=np.float32).reshape(D * 3, 2) + 10 * r
              for r in range(D)]
        total = sum(xs)
        cots = [_cot(r, (3, 2)) for r in range(D)]
        return [(total[3 * r:3 * r + 3], np.concatenate(cots))
                for r in range(D)]
    if op == "all_to_all":
        xs = [100 * r + 10 * np.arange(D)[:, None, None] + base[None]
              for r in range(D)]
        cots = [_cot(r, (D, 3, 2)) for r in range(D)]
        return [(np.stack([xs[s][r] for s in range(D)]),
                 np.stack([cots[j][r] for j in range(D)]))
                for r in range(D)]
    xs = [base + 100 * r for r in range(D)]                  # ring_shift
    return [(xs[(r - 1) % D], _cot((r + 1) % D, (3, 2))) for r in range(D)]


@pytest.mark.parametrize("op", ("all_gather", "reduce_scatter", "all_to_all",
                                "ring_shift"))
@pytest.mark.parametrize("D", WORLDS)
def test_collective_and_its_transpose(runs, D, op):
    for r, (out, grad) in zip(runs(D)[0], _collective_want(op, D)):
        np.testing.assert_array_equal(r["collectives"][op]["out"], out)
        np.testing.assert_array_equal(r["collectives"][op]["grad"], grad)
