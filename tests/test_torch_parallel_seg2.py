"""Port parity across processes: the row-sharded packed SpMM (seg2) under
the all-gather and under the halo all-to-all, and the dry run's train steps,
at world sizes 2 and 4 on gloo (``parallel.spawn``), against the JAX
package's functions on its virtual CPU mesh of the same size.

One spawn per world size runs every case (``tests/_torch_parallel_cases.py``,
no JAX there). seg2: a 128 x 128 graph of 900 entries (seed 11), K = 32,
segments of 32 rows (S = 4 > 1): the output, ``d x`` and ``d packed value``
of ``sum(out * g)`` against ``jax.vjp`` within 1e-5 of each entry or of the
largest (f32 sums in another order); the halo plan's packed values compared
with JAX's padding left out, as the port packs them.

The dry run (``entry.DryRun``) at D = 4 from the JAX dry run's parameters
(``gcn_params_from_jax``), against its three steps rebuilt from
``__graft_entry__.py`` (``tests/_jax_parallel_ref.py``): the loss, every
parameter's grad and the parameters after SGD at 1e-5, and with the values
differentiated too, each shard's ``d value``. The port sums the parameter
grads over the ranks (``all_reduce``): JAX's step gives every shard the
full gradient (its ``pmean`` then changes nothing), and a sum of the ranks'
shares is that gradient.
"""
import numpy as np
import pytest
import torch

import _jax_parallel_ref as ref
from _torch_parallel_cases import run_cases
from paddle_sparse_tpu_torch import gcn_params_from_jax
from paddle_sparse_tpu_torch import parallel as tpar
from paddle_sparse_tpu_torch.entry import dryrun_nodes

WORLDS = (2, 4)
SEG2 = ("seg2_allgather", "seg2_halo")
PARTS = ("out", "dx", "dv")
DRYRUN_D = 4
STEPS = ("gcn_step", "seg2_step", "seg2_halo_step")


def _graph():
    rng = np.random.default_rng(11)
    M = N = 128
    nnz, K = 900, 32
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    return {"row": row[order], "col": col[order], "val": val[order],
            "shape": (M, N), "sr": 32,
            "x": rng.standard_normal((N, K)).astype(np.float32),
            "g": rng.standard_normal((M, K)).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_dryrun():
    return ref.dryrun_steps(DRYRUN_D, dryrun_nodes(DRYRUN_D))


@pytest.fixture(scope="module")
def runs(jax_dryrun):
    cache = {}

    def get(D):
        if D not in cache:
            jobs = {name: (name, _graph()) for name in SEG2}
            if D == DRYRUN_D:
                jobs["dryrun"] = ("dryrun", {
                    "num_nodes": dryrun_nodes(D), "value_grad": True,
                    "params": gcn_params_from_jax(jax_dryrun["params"])})
            cache[D] = tpar.spawn(run_cases, D, jobs, device="cpu")
        return cache[D]
    return get


@pytest.fixture(scope="module")
def jax_spmm():
    cache = {}

    def get(name, D):
        if (name, D) not in cache:
            cache[name, D] = ref.spmm_vjp(name, D, _graph())
        return cache[name, D]
    return get


@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", SEG2)
@pytest.mark.parametrize("D", WORLDS)
def test_sharded_seg2(runs, jax_spmm, D, name, part):
    ranks = [r[name] for r in runs(D)]
    want = jax_spmm(name, D)
    join = np.stack if part == "dv" else np.concatenate
    ref.close(join([r[part] for r in ranks]), want[part], f"{name} {part}")
    if name == "seg2_allgather":
        assert all(r["S"] == want["S"] > 1 for r in ranks)


def _state(params):
    """A JAX params tree as the GCN's state dict, in numpy."""
    return {k: v.numpy() for k, v in gcn_params_from_jax(params).items()}


@pytest.mark.parametrize("what", ("loss", "grads", "params"))
@pytest.mark.parametrize("step", STEPS)
def test_dryrun_step(runs, jax_dryrun, step, what):
    """The loss, the summed grads and the parameters after SGD of each of
    the dry run's steps equal the JAX step's on every rank."""
    want = jax_dryrun[step]
    for r in runs(DRYRUN_D):
        for got in (r["dryrun"][step], r["dryrun"]["value_grad"][step]):
            if what == "loss":
                ref.close(got["loss"], want["loss"], step)
                continue
            w = _state(want[what])
            assert set(got[what]) == set(w)
            for k in w:
                ref.close(got[what][k], w[k], f"{step} {what} {k}")


@pytest.mark.parametrize("step", STEPS)
def test_dryrun_d_value(runs, jax_dryrun, step):
    """``d value`` of each step with the values differentiated, per shard
    (seg2: of the packed values), against JAX's."""
    got = np.stack([r["dryrun"]["value_grad"][step]["d_value"]
                    for r in runs(DRYRUN_D)])
    ref.close(got, jax_dryrun[step]["d_value"], step)


def test_dryrun_blocks(runs):
    """The dry run's other blocks ran their checks on every rank (else the
    spawn raised): every interchange gave the all-gather SpMM's rows, the
    2-D grid ran on (2, 2) and A @ A did not overflow."""
    ranks = runs(DRYRUN_D)
    for r in ranks:
        inter = r["dryrun"]["interchanges"]
        assert set(inter) == {"all_gather", "ring", "ring_bucketed", "halo"}
        np.testing.assert_allclose(r["dryrun"]["grid_2d"],
                                   inter["all_gather"], rtol=1e-4, atol=1e-4)
        assert not r["dryrun"]["spgemm"]["overflowed"].any()
        assert r["dryrun"]["seg2_step"]["S"] > 1
    assert torch.as_tensor(ranks[0]["dryrun"]["spgemm"]["C"]).shape == (
        dryrun_nodes(DRYRUN_D),) * 2
