"""The rank side of the spawned parity tests of
``paddle_sparse_tpu_torch.parallel`` (``tests/test_torch_parallel*.py``).

``parallel.spawn`` runs :func:`run_cases` in one process per rank (gloo on
the CPU). It imports no JAX, and asserts so: the tests compute the JAX side
in their own process and pass the workers numpy. Each case takes this rank's
inputs from a dict of numpy arrays, runs the port's function and returns
what this rank holds: the output block, and for SpMMs the grads of ``sum(out
* g)`` with respect to this rank's ``x`` rows (``dx``) and its block's
values (``dv``).
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from paddle_sparse_tpu_torch import PaddedCOO, SparseTensor
from paddle_sparse_tpu_torch import parallel as tpar
from paddle_sparse_tpu_torch.entry import DryRun
from paddle_sparse_tpu_torch.parallel.mesh import axis_rank

POISON_COL = 2 ** 31 - 1


def _adj(d, prefix=""):
    """The port's SparseTensor of ``d``'s graph ``prefix``row/col/val."""
    val = d.get(prefix + "val")
    return SparseTensor(row=torch.as_tensor(d[prefix + "row"]),
                        col=torch.as_tensor(d[prefix + "col"]),
                        value=None if val is None else torch.as_tensor(val),
                        sparse_sizes=tuple(d[prefix + "shape"]))


def _leaf(a):
    return torch.as_tensor(a).detach().clone().requires_grad_()


def _rows(a, world, rank):
    return tpar.shard_rows(torch.as_tensor(a), world, rank)


def _vjp(fn, x, value, g):
    """``fn(x, value)`` and the grads of ``sum(out * g)`` with respect to
    ``x`` and ``value`` (leaves made here)."""
    x, value = _leaf(x), _leaf(value)
    out = fn(x, value)
    (out * g).sum().backward()
    return {"out": out, "dx": x.grad, "dv": value.grad}


def _poison(block, rows_per):
    """A block whose padding entries read column 2**31 - 1 and value NaN:
    no kernel may read them."""
    pad = block.row >= rows_per
    return block._replace(
        col=torch.where(pad, torch.full_like(block.col, POISON_COL),
                        block.col),
        value=torch.where(pad, torch.full_like(block.value, float("nan")),
                          block.value))


def case_allgather(mesh, rank, world, d, poison=False):
    blk = tpar.device_put_sharded_matrix(
        tpar.shard_padded_coo(_adj(d), world), rank)
    if poison:
        blk = _poison(blk, blk.rows_per_shard)
    return _vjp(lambda x, v: tpar.spmm_allgather(mesh, blk._replace(value=v),
                                                 x),
                _rows(d["x"], world, rank), blk.value,
                _rows(d["g"], world, rank))


def case_ring(mesh, rank, world, d):
    blk = tpar.device_put_sharded_matrix(
        tpar.shard_padded_coo(_adj(d), world), rank)
    return _vjp(lambda x, v: tpar.spmm_ring(mesh, blk._replace(value=v), x),
                _rows(d["x"], world, rank), blk.value,
                _rows(d["g"], world, rank))


def case_ring_bucketed(mesh, rank, world, d):
    blk = tpar.device_put_ring(tpar.shard_ring_buckets(_adj(d), world), rank)
    return _vjp(lambda x, v: tpar.spmm_ring_bucketed(
        mesh, blk._replace(value=v), x), _rows(d["x"], world, rank),
        blk.value, _rows(d["g"], world, rank))


def case_halo(mesh, rank, world, d, poison=False):
    hmat = tpar.shard_halo(_adj(d), world)
    blk = tpar.device_put_halo(hmat, rank)
    if poison:
        blk = _poison(blk, blk.rows_per_shard)
    res = _vjp(lambda x, v: tpar.spmm_halo(mesh, blk._replace(value=v), x),
               _rows(d["x"], world, rank), blk.value,
               _rows(d["g"], world, rank))
    res["halo_per_src"] = hmat.halo_per_src
    return res


def case_2d(mesh, rank, world, d):
    dr, dc = d["grid"]
    mesh2 = tpar.make_mesh_2d(dr, dc)
    blk = tpar.device_put_2d(tpar.shard_2d(_adj(d), dr, dc), rank)
    return _vjp(lambda x, v: tpar.spmm_2d(mesh2, blk._replace(value=v), x),
                _rows(d["x"], dc, rank % dc), blk.value,
                _rows(d["g"], world, rank))


def case_seg2_allgather(mesh, rank, world, d):
    mat = tpar.shard_padded_coo(_adj(d), world)
    sh = tpar.make_seg2_plan_sharded(mat, feat_dim=d["x"].shape[1],
                                     sr=d["sr"], ranks=[rank])
    shard = tpar.device_put_sharded_seg2(sh, rank)
    packed = tpar.pack_values_sharded(sh, mat.value)[rank]
    res = _vjp(lambda x, v: tpar.spmm_seg2_allgather(mesh, shard, v, x),
               _rows(d["x"], world, rank), packed,
               _rows(d["g"], world, rank))
    res["S"] = shard.plan.S
    return res


def case_seg2_halo(mesh, rank, world, d):
    hmat = tpar.shard_halo(_adj(d), world)
    blk = tpar.device_put_halo(hmat, rank)
    sh = tpar.make_seg2_halo_plan(hmat, feat_dim=d["x"].shape[1],
                                  sr=d["sr"], ranks=[rank])
    shard = tpar.device_put_sharded_seg2(sh, rank)
    packed = tpar.pack_values_sharded(sh, hmat.value)[rank]
    return _vjp(lambda x, v: tpar.spmm_seg2_halo(mesh, blk, shard, v, x),
                _rows(d["x"], world, rank), packed,
                _rows(d["g"], world, rank))


def case_spgemm(mesh, rank, world, d):
    """``A @ B`` with A row-sharded, B whole on every rank, at ``d``'s
    capacities: this rank's C block and every rank's overflow flag."""
    blocks, _ = tpar.shard_padded_rows(_adj(d, "a_"), world)
    A = tpar.device_put_blocks(blocks, rank)
    B = PaddedCOO.from_eager(_adj(d, "b_"))
    C, over = tpar.spgemm_rowsharded(mesh, A, B, int(d["flop_cap"]),
                                     int(d["out_cap"]))
    return {"row": C.row, "col": C.col, "value": C.value, "nnz": C.nnz,
            "overflowed": over}


def case_allgather_padded(mesh, rank, world, d):
    """B row-sharded, gathered whole by ``allgather_padded``."""
    blocks, _ = tpar.shard_padded_rows(_adj(d, "b_"), world)
    B = tpar.allgather_padded(mesh, tpar.device_put_blocks(blocks, rank))
    return {"row": B.row, "col": B.col, "value": B.value, "nnz": B.nnz,
            "shape": B.shape}


def case_collectives(mesh, rank, world, d):
    """Each collective's forward, and its backward for the cotangent
    ``(r + 1) * (1 + arange)`` on rank r."""
    group, r, W = axis_rank(mesh)

    def cot(shape):
        return (r + 1) * (1 + torch.arange(int(np.prod(shape)),
                                           dtype=torch.float32)
                          ).reshape(shape)

    def run(fn, x):
        x = _leaf(x)
        out = fn(x, group)
        (out * cot(out.shape)).sum().backward()
        return {"out": out, "grad": x.grad}

    base = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    return {
        "all_gather": run(tpar.all_gather, base + 100 * r),
        "reduce_scatter": run(tpar.reduce_scatter,
                              torch.arange(W * 6, dtype=torch.float32)
                              .reshape(W * 3, 2) + 10 * r),
        "all_to_all": run(tpar.all_to_all,
                          100 * r + 10 * torch.arange(W)[:, None, None]
                          + base[None].expand(W, 3, 2)),
        "ring_shift": run(tpar.ring_shift, base + 100 * r)}


def case_dryrun(mesh, rank, world, d):
    """Every block of the dry run, from ``d["params"]``; with
    ``d["value_grad"]`` also its steps with ``d value`` (the values' grads,
    on this rank's block)."""
    run = DryRun(mesh, "cpu", int(d["num_nodes"]), d["params"],
                 verbose=False)
    out = run.run()
    if d.get("value_grad"):
        out["value_grad"] = {
            "gcn_step": run.gcn_step(value_grad=True),
            "seg2_step": run.seg2_step(value_grad=True),
            "seg2_halo_step": run.seg2_halo_step(value_grad=True)}
    return out


def case_penalty_step(mesh, rank, world, d):
    """The row-sharded GCN step (``DryRun``'s graph and model) with the
    input-gradient penalty ``CE + lam * |d CE / d x|^2``: each rank takes
    ``d CE / d x`` at its rows under ``create_graph`` (the all-gathers'
    backward sums the ranks' shares), adds ``lam`` times its square, and
    backpropagates; parameter grads summed over the ranks, then SGD."""
    from paddle_sparse_tpu_torch.entry import DRYRUN_LR
    from paddle_sparse_tpu_torch.models import GCN
    from paddle_sparse_tpu_torch.parallel.spmm import (RowShardedAdjacency,
                                                       block_coo)
    run = DryRun(mesh, "cpu", int(d["num_nodes"]), d["params"],
                 verbose=False)
    model = GCN(16, 32, 4)
    model.load_state_dict(run.params)
    adj = RowShardedAdjacency(block_coo(run.blk), run.group)
    x = run.x.detach().clone().requires_grad_()
    logp = torch.log_softmax(model(adj, x), dim=-1)
    local = -logp.gather(1, run.y[:, None]).sum() / run.num_nodes
    gx, = torch.autograd.grad(local, x, create_graph=True)
    pen = float(d["lam"]) * gx.square().sum()
    (local + pen).backward()
    stats = torch.stack([local.detach(), pen.detach()])
    dist.all_reduce(stats, group=run.group)
    grads = {}
    with torch.no_grad():
        for k, prm in model.named_parameters():
            dist.all_reduce(prm.grad, group=run.group)
            grads[k] = prm.grad
            prm -= DRYRUN_LR * prm.grad
    return {"loss": float(stats.sum()), "penalty": float(stats[1]),
            "grads": grads, "params": model.state_dict()}


def case_collectives_grad_of_grad(mesh, rank, world, d):
    """Each collective's second derivative: ``h = <c, op(x) ** 2>`` summed
    over the ranks, ``g = d h / d x`` under ``create_graph``, then the grad
    of ``<g, u>`` (``ggx``); small integers, so the sums are exact."""
    group, r, W = axis_rank(mesh)
    gen = torch.Generator().manual_seed(100 + r)

    def ints(shape):
        return torch.randint(-3, 4, shape, generator=gen).double()

    shapes = {"all_gather": ((3, 2), (W * 3, 2)),
              "reduce_scatter": ((W * 3, 2), (3, 2)),
              "all_to_all": ((W, 3, 2), (W, 3, 2)),
              "ring_shift": ((3, 2), (3, 2))}
    out = {"x": {}, "c": {}, "u": {}, "ggx": {}}
    for name, (xs, ys) in shapes.items():
        fn = getattr(tpar, name)
        x, c, u = ints(xs).requires_grad_(), ints(ys), ints(xs)
        h = (c * fn(x, group) ** 2).sum()
        g, = torch.autograd.grad(h, x, create_graph=True)
        ggx, = torch.autograd.grad((g * u).sum(), x)
        out["x"][name], out["c"][name] = x.detach(), c
        out["u"][name], out["ggx"][name] = u, ggx
    return out


CASES = {
    "allgather": case_allgather,
    "allgather_poisoned": lambda *a: case_allgather(*a, poison=True),
    "ring": case_ring,
    "ring_bucketed": case_ring_bucketed,
    "halo": case_halo,
    "halo_poisoned": lambda *a: case_halo(*a, poison=True),
    "2d": case_2d,
    "seg2_allgather": case_seg2_allgather,
    "seg2_halo": case_seg2_halo,
    "spgemm": case_spgemm,
    "allgather_padded": case_allgather_padded,
    "collectives": case_collectives,
    "dryrun": case_dryrun,
    "penalty_step": case_penalty_step,
    "collectives_grad_of_grad": case_collectives_grad_of_grad,
}


def run_cases(rank: int, world: int, jobs) -> dict:
    """``jobs``: ``{key: (case name, inputs)}``; returns ``{key: result}``
    for this rank, every case on one mesh of ``world`` ranks."""
    assert "jax" not in sys.modules, "a spawned worker imported jax"
    mesh = tpar.make_mesh(world)
    out = {}
    for key, (name, data) in jobs.items():
        out[key] = CASES[name](mesh, rank, world, data)
        dist.barrier()
    assert "jax" not in sys.modules, "a spawned worker imported jax"
    return out

