"""Port parity, in one process: the host-side ``shard_*`` functions of
``paddle_sparse_tpu_torch.parallel`` against the JAX package's
``paddle_sparse_tpu.parallel`` on the same graphs, array for array, and the
scaling estimator exactly.

The ``shard_*`` functions at the JAX tests' shard counts (D = 2, 4, 8; grids 2x1, 2x2, 2x4)
on four graphs made from a seed with numpy: a random one (duplicates
included), one whose rows all lie in the first shard (empty shards), one
with a hub column, and nnz = 0; plus a value-less graph (ones, as the JAX
functions fill). Every array, every static field and every dtype class
(integer indices, float values) equal. The seg2 planners: each shard's ``S``
and ``SR`` equal JAX's plan at the same ``sr``, and each shard's packed
values equal JAX's packed layout with its padding entries left out, then 0
(the all-gather plan's padding, at column N, sorts last in JAX's layout
too, so there the two are equal whole). ``gather_blocks``: the same (row,
col, value) as JAX's on the same stacked blocks. Scaling:
``estimate_scaling`` and ``scaling_report`` equal (``==``) for every
strategy, device kind and grid tried.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_sparse_tpu import SparseTensor as JSparseTensor
from paddle_sparse_tpu import parallel as jpar
from paddle_sparse_tpu.parallel import scaling as jscaling
from paddle_sparse_tpu.parallel import spmm_seg2 as jseg2
from paddle_sparse_tpu.parallel.spmm2d import shard_2d as jshard_2d
from paddle_sparse_tpu_torch import SparseTensor
from paddle_sparse_tpu_torch import parallel as tpar

M = N = 64
GRAPHS = ("random", "empty_shards", "hub_col", "empty", "no_value")


def _graph(kind: str, seed: int = 3):
    """Row-sorted (row, col, value or None) numpy arrays of an (M, N)
    graph."""
    rng = np.random.default_rng(seed)
    nnz = 0 if kind == "empty" else 400
    hi = M // 8 if kind == "empty_shards" else M
    row = rng.integers(0, hi, nnz)
    col = rng.integers(0, N, nnz)
    if kind == "hub_col":
        col[rng.random(nnz) < 0.4] = 5
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    return (row[order], col[order],
            None if kind == "no_value" else val[order])


def _pair(kind: str):
    row, col, val = _graph(kind)
    jt = JSparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                       value=None if val is None else jnp.asarray(val),
                       sparse_sizes=(M, N))
    tt = SparseTensor(row=torch.as_tensor(row), col=torch.as_tensor(col),
                      value=None if val is None else torch.as_tensor(val),
                      sparse_sizes=(M, N))
    return jt, tt


def _same(got, want, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _same_tuple(got, want, fields):
    for f in fields:
        _same(getattr(got, f), getattr(want, f), f)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_padded_coo(kind, D):
    jt, tt = _pair(kind)
    want, got = jpar.shard_padded_coo(jt, D), tpar.shard_padded_coo(tt, D)
    _same_tuple(got, want, ("row", "col", "value", "nnz"))
    assert (got.shape, got.rows_per_shard) == (want.shape,
                                                 want.rows_per_shard)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_ring_buckets(kind, D):
    jt, tt = _pair(kind)
    want = jpar.shard_ring_buckets(jt, D)
    got = tpar.shard_ring_buckets(tt, D)
    _same_tuple(got, want, ("row", "col", "value"))
    assert (got.shape, got.rows_per_shard) == (want.shape,
                                                 want.rows_per_shard)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_halo(kind, D):
    jt, tt = _pair(kind)
    want, got = jpar.shard_halo(jt, D), tpar.shard_halo(tt, D)
    _same_tuple(got, want, ("row", "col", "value", "send_idx"))
    assert (got.shape, got.rows_per_shard, got.halo_per_src) == (
        want.shape, want.rows_per_shard, want.halo_per_src)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("grid", [(2, 1), (2, 2), (2, 4)])
def test_shard_2d(kind, grid):
    jt, tt = _pair(kind)
    want, got = jshard_2d(jt, *grid), tpar.shard_2d(tt, *grid)
    _same_tuple(got, want, ("row", "col", "value"))
    assert (got.shape, got.grid) == (want.shape, want.grid)


@pytest.mark.parametrize("kind", GRAPHS)
@pytest.mark.parametrize("D", [2, 4, 8])
def test_shard_padded_rows_and_gather_blocks(kind, D):
    jt, tt = _pair(kind)
    (want, rp_want), (got, rp_got) = (jpar.shard_padded_rows(jt, D),
                                      tpar.shard_padded_rows(tt, D))
    assert rp_got == rp_want and got.shape == want.shape
    fields = ("row", "col", "nnz") + (("value",) if kind != "no_value"
                                      else ())
    _same_tuple(got, want, fields)
    assert (got.value is None) == (want.value is None)
    for g, w, name in zip(tpar.gather_blocks(got, rp_got, M, N),
                          jpar.gather_blocks(want, rp_want, M, N),
                          ("row", "col", "value")):
        assert (g is None) == (w is None), name
        if g is not None:
            _same(g, w, name)


def test_shard_functions_refuse_uneven_shards():
    _, tt = _pair("random")
    for fn in (tpar.shard_padded_coo, tpar.shard_ring_buckets,
               tpar.shard_halo, tpar.shard_padded_rows):
        with pytest.raises(ValueError, match="must divide"):
            fn(tt, 3)
    with pytest.raises(ValueError, match="must divide"):
        tpar.shard_2d(tt, 3, 2)


def _packed_without_padding(jsharded, jpacked, jrow, rows_per):
    """JAX's packed values with the padding entries left out, then 0, per
    shard."""
    perm = np.asarray(jsharded.structure.perm_f)
    out = np.zeros_like(np.asarray(jpacked))
    for d in range(out.shape[0]):
        real = np.asarray(jrow[d])[perm[d]] < rows_per
        out[d, :real.sum()] = np.asarray(jpacked[d])[real]
    return out


@pytest.mark.parametrize("kind", ("random", "empty_shards", "hub_col"))
@pytest.mark.parametrize("D", [2, 4, 8])
def test_seg2_plans_sharded(kind, D):
    """S and SR of each shard's plan equal JAX's at the same sr; the
    packed values equal JAX's packed layout, padding (last, 0) included."""
    jt, tt = _pair(kind)
    jmat, tmat = jpar.shard_padded_coo(jt, D), tpar.shard_padded_coo(tt, D)
    want = jseg2.make_seg2_plan_sharded(jmat, feat_dim=16, sr=16,
                                        chunk_edges=128)
    got = tpar.make_seg2_plan_sharded(tmat, feat_dim=16, sr=16,
                                      chunk_edges=128)
    assert want.plan.S > 1
    for plan in got.plans:
        assert (plan.S, plan.SR) == (want.plan.S, want.plan.SR)
        assert plan.num_rows == tmat.rows_per_shard and plan.num_cols == N
    jpacked = jseg2.pack_values_sharded(want, jmat.value)
    _same(tpar.pack_values_sharded(got, tmat.value), jpacked, "packed")
    # one rank's own plan only: its row packed, the others left 0
    mine = tpar.make_seg2_plan_sharded(tmat, feat_dim=16, sr=16, ranks=[1])
    assert mine.plans[0] is None and mine.plans[1] == got.plans[1]
    one = tpar.pack_values_sharded(mine, tmat.value)
    _same(one[1], jpacked[1], "rank 1 packed")
    assert not one[0].any()
    with pytest.raises(ValueError, match="no plan"):
        tpar.device_put_sharded_seg2(mine, 0, "cpu")


@pytest.mark.parametrize("kind", ("random", "hub_col"))
@pytest.mark.parametrize("D", [2, 4, 8])
def test_seg2_halo_plans(kind, D):
    jt, tt = _pair(kind)
    jh, th = jpar.shard_halo(jt, D), tpar.shard_halo(tt, D)
    want = jseg2.make_seg2_halo_plan(jh, feat_dim=16, sr=16,
                                     chunk_edges=128)
    got = tpar.make_seg2_halo_plan(th, feat_dim=16, sr=16)
    for plan in got.plans:
        assert (plan.S, plan.SR) == (want.plan.S, want.plan.SR)
        assert plan.num_cols == want.plan.num_cols == D * th.halo_per_src
    # the halo padding (column 0) sits inside JAX's first segment
    _same(tpar.pack_values_sharded(got, th.value),
          _packed_without_padding(want, jseg2.pack_values_sharded(
              want, jh.value), jh.row, jh.rows_per_shard), "packed")


SCALING_CASES = [
    # ogbn-products at K=256, 8 and 256 devices (tests/test_parallel.py)
    dict(n_devices=8, nnz=124_000_000, m=2_449_029, n=2_449_029, k=256,
         achieved_gbps=280.0),
    dict(n_devices=256, nnz=124_000_000, m=2_449_029, n=2_449_029, k=256,
         achieved_gbps=280.0),
    # papers100M-like, halo footprint given; another chip and an odd count
    dict(n_devices=16, nnz=1_600_000_000, m=111_000_000, n=111_000_000,
         k=128, achieved_gbps=280.0, unique_cols=100_000_000),
    dict(n_devices=12, nnz=10_000_000, m=1_000_000, n=1_000_000, k=64,
         achieved_gbps=512.5, device_kind="TPU v4", elem_bytes=2),
    dict(n_devices=6, nnz=5_000_000, m=600_000, n=600_000, k=32,
         achieved_gbps=100.0, device_kind="some other card", grid=(3, 2)),
]


@pytest.mark.parametrize("case", range(len(SCALING_CASES)))
@pytest.mark.parametrize("strategy", ["all_gather", "ring", "halo", "2d"])
def test_estimate_scaling_exact(case, strategy):
    kw = SCALING_CASES[case]
    assert tpar.estimate_scaling(strategy, **kw) == jscaling.estimate_scaling(
        strategy, **kw)


@pytest.mark.parametrize("case", range(len(SCALING_CASES)))
def test_scaling_report_exact(case):
    kw = SCALING_CASES[case]
    assert tpar.scaling_report(**kw) == jscaling.scaling_report(**kw)
    with pytest.raises(ValueError, match="unknown strategy"):
        tpar.estimate_scaling("mesh", **kw)
