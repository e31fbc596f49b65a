"""``tests/test_parallel.py``'s 12 cases as port parity tests, at its world
size of 8 on gloo (one ``parallel.spawn`` of 8 ranks runs every case, in
``tests/_torch_parallel_cases.py``, no JAX there), each on that test's own
data and against both the JAX function on the 8-device virtual CPU mesh and
the test's dense oracle.

Gradients are those of that test's loss, ``sum(out ** 2)``: the worker gets
the cotangent ``g = 2 * A @ x`` (the oracle's, in f64 then f32). Against
JAX: 1e-5 of each entry or of the largest (f32 sums in another order);
against the dense oracle the original test's 1e-4 (outputs) and 1e-3
(grads). The dry run: ``DryRun`` at 8 ranks from the JAX dry run's
parameters against its three steps rebuilt (``tests/_jax_parallel_ref.py``):
loss, grads and new parameters at 1e-5, and its other blocks' own checks.
The scaling case: the original asserts on the port's estimator and equality
with JAX's.
"""
import numpy as np
import pytest

import _jax_parallel_ref as ref
from _torch_parallel_cases import run_cases
from paddle_sparse_tpu.ops.spspmm import plan_spgemm
from paddle_sparse_tpu.parallel import scaling as jscaling
from paddle_sparse_tpu_torch import gcn_params_from_jax
from paddle_sparse_tpu_torch import parallel as tpar
from paddle_sparse_tpu_torch.entry import dryrun_nodes

D = 8


def _dense(d):
    out = np.zeros(d["shape"], np.float64)
    np.add.at(out, (d["row"], d["col"]), d["val"])
    return out


def _with_square_loss(d):
    """``d`` with ``g`` the cotangent of ``sum((A @ x) ** 2)``."""
    return dict(d, g=(2 * _dense(d) @ d["x"]).astype(np.float32))


def _seg2_graph(seed, nnz, K, coalesce=False):
    """``test_spmm_seg2_sharded_flagship``'s (seed 11, 900 entries, K 128)
    and ``test_spmm_seg2_halo``'s (seed 13, 700, K 64, coalesced) graphs."""
    rng = np.random.default_rng(seed)
    M = N = 128
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    row, col, val = row[order], col[order], val[order]
    if coalesce:
        t = ref.tensor({"row": row, "col": col, "val": val,
                        "shape": (M, N)}).coalesce()
        row, col, val = (np.array(t.storage.row()), np.array(t.storage.col()),
                         np.array(t.storage.value()))
    x = rng.standard_normal((N, K)).astype(np.float32)
    return _with_square_loss({"row": row, "col": col, "val": val,
                              "shape": (M, N), "sr": 32, "x": x})


def _data():
    g64 = _with_square_loss(dict(ref.graph_64(), grid=(2, 4)))
    A, B, ops = ref.spgemm_operands()
    flop_cap, out_cap = plan_spgemm(A.to_padded(), B.to_padded())
    return {"graph": g64, "seg2": _seg2_graph(11, 900, 128),
            "seg2_halo": _seg2_graph(13, 700, 64, coalesce=True),
            "spgemm": (A, B, dict(ops, flop_cap=flop_cap, out_cap=out_cap))}


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def jax_dryrun():
    return ref.dryrun_steps(D, dryrun_nodes(D))


@pytest.fixture(scope="module")
def ranks(data, jax_dryrun):
    """One spawn of 8 ranks for every case."""
    g = data["graph"]
    jobs = {name: (name, g) for name in ("allgather", "ring",
                                         "ring_bucketed", "halo", "2d")}
    jobs["seg2_allgather"] = ("seg2_allgather", data["seg2"])
    jobs["seg2_halo"] = ("seg2_halo", data["seg2_halo"])
    jobs["spgemm"] = ("spgemm", data["spgemm"][2])
    jobs["dryrun"] = ("dryrun", {
        "num_nodes": dryrun_nodes(D),
        "params": gcn_params_from_jax(jax_dryrun["params"])})
    return tpar.spawn(run_cases, D, jobs, device="cpu")


def _joined(ranks, name, part):
    blocks = [r[name][part] for r in ranks]
    if name == "2d" and part == "dx":
        return np.concatenate([sum(blocks[j::4]) for j in range(4)])
    return np.stack(blocks) if part == "dv" else np.concatenate(blocks)


def _check(ranks, d, name, parts=("out",)):
    """The parts of one case against JAX's function and the dense
    oracle; returns JAX's results."""
    want = ref.spmm_vjp(name, D, d)
    dense = _dense(d)
    oracle = {"out": dense @ d["x"], "dx": dense.T @ d["g"]}
    for part in parts:
        got = _joined(ranks, name, part)
        ref.close(got.reshape(want[part].shape), want[part],
                  f"{name} {part}")
        if part in oracle:
            tol = 1e-4 if part == "out" else 1e-3
            np.testing.assert_allclose(got, oracle[part], rtol=tol, atol=tol)
    return want


def test_spmm_allgather(ranks, data):
    _check(ranks, data["graph"], "allgather")


def test_spmm_ring(ranks, data):
    _check(ranks, data["graph"], "ring")


def test_spmm_allgather_grad(ranks, data):
    """Collectives differentiate: d x (and d value) of the sharded SpMM."""
    _check(ranks, data["graph"], "allgather", ("dx", "dv"))


def test_graft_dryrun(ranks, jax_dryrun):
    """The dry run at 8 ranks: its blocks' checks passed on every rank, and
    each train step equals the JAX dry run's."""
    for r in ranks:
        run = r["dryrun"]
        assert not run["spgemm"]["overflowed"].any()
        assert run["seg2_step"]["S"] == jax_dryrun["seg2_step"]["S"] > 1
        for step in ("gcn_step", "seg2_step", "seg2_halo_step"):
            want = jax_dryrun[step]
            ref.close(run[step]["loss"], want["loss"], step)
            for what in ("grads", "params"):
                w = gcn_params_from_jax(want[what])
                for k, v in w.items():
                    ref.close(run[step][what][k], v.numpy(),
                              f"{step} {what} {k}")


def test_spgemm_rowsharded(ranks, data):
    A, B, ops = data["spgemm"]
    got = [r["spgemm"] for r in ranks]
    (jrow, jcol, jval), jover = ref.jax_spgemm(A, B, D, int(ops["flop_cap"]),
                                               int(ops["out_cap"]))
    row, col, val = ref.c_of(got, (A.sizes()[0] // D, B.sizes()[1]))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    ref.close(val.numpy(), jval, "C values")
    assert not jover.any() and not any(r["overflowed"].any() for r in got)
    dense = np.asarray(A.to_dense()) @ np.asarray(B.to_dense())
    C = np.zeros_like(dense)
    np.add.at(C, (row.numpy(), col.numpy()), val.numpy())
    np.testing.assert_allclose(C, dense, rtol=1e-4, atol=1e-4)


def test_spmm_ring_bucketed(ranks, data):
    _check(ranks, data["graph"], "ring_bucketed", ("out", "dx", "dv"))


def test_spmm_halo(ranks, data):
    """The halo exchanges fewer rows than the all-gather replicates."""
    _check(ranks, data["graph"], "halo")
    assert all(r["halo"]["halo_per_src"] <= 64 // D for r in ranks)


def test_spmm_halo_grad(ranks, data):
    _check(ranks, data["graph"], "halo", ("dx", "dv"))


def test_spmm_2d(ranks, data):
    _check(ranks, data["graph"], "2d", ("out", "dx", "dv"))


def test_scaling_estimates():
    """The original's asserts on the port's estimator, and equality with
    JAX's."""
    rep = tpar.scaling_report(8, 124_000_000, 2_449_029, 2_449_029, 256,
                              achieved_gbps=280.0)
    assert rep == jscaling.scaling_report(8, 124_000_000, 2_449_029,
                                          2_449_029, 256, achieved_gbps=280.0)
    for s, r in rep.items():
        if not isinstance(r, dict):
            continue
        assert 0 < r["efficiency"] <= 1.0, (s, r)
        assert 0 < r["efficiency_at_target"] <= 1.0, (s, r)
    assert rep["ring"]["efficiency"] >= 0.8
    assert rep["halo"]["efficiency"] >= 0.8
    pod = tpar.scaling_report(256, 124_000_000, 2_449_029, 2_449_029, 256,
                              achieved_gbps=280.0)
    assert pod["all_gather"]["efficiency_at_target"] < 0.5
    assert pod["2d"]["efficiency_at_target"] > \
        pod["all_gather"]["efficiency_at_target"]
    big = {"nnz": 1_600_000_000, "m": 111_000_000, "n": 111_000_000,
           "k": 128}
    ag = tpar.estimate_scaling("all_gather", 16, achieved_gbps=280.0, **big)
    halo = tpar.estimate_scaling("halo", 16, achieved_gbps=280.0, **big,
                                 unique_cols=big["nnz"] // 16)
    assert halo.efficiency > ag.efficiency


def test_spmm_seg2_sharded_flagship(ranks, data):
    """seg2 under the all-gather, more than one segment: forward, d x and d
    packed value."""
    want = _check(ranks, data["seg2"], "seg2_allgather", ("out", "dx", "dv"))
    assert all(r["seg2_allgather"]["S"] == want["S"] > 1 for r in ranks)


def test_spmm_seg2_halo(ranks, data):
    _check(ranks, data["seg2_halo"], "seg2_halo", ("out", "dx", "dv"))
