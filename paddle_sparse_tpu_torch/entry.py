"""Toy models of the port: the counterpart of ``__graft_entry__.entry`` and of
the JAX models' train steps (``tests/test_models.py``, ``__graft_entry__.py``).

``entry(device)`` returns ``(model, adj, x)`` for a 2-layer GCN (32 -> 64 -> 8)
on a 256-node synthetic graph; ``model(adj, x)`` under
``torch.inference_mode()`` runs the forward. ``train_entry(device)`` adds the
labels ``y``, and ``train_step(model, adj, x, y, lr)`` takes one SGD step.
``model_entry(kind, device)`` gives ``(model, adj, x, y)`` for any of
``MODELS`` (GCN, GraphSAGE, GIN, APPNP, GAT) on the same graph, set up as
``tests/test_models.py`` sets each up; ``gcn_loss`` and ``train_step`` take
any of them.
``spgemm_entry(device)`` returns the toy adjacency for ``A @ A`` (the
SpGEMM cross-check of ``__graft_entry__.dryrun_multichip``).
``spmm_entry(backend, device)`` plans the toy graph for an SpMM entry point
that holds a plan (``seg2``, ``seg3``, ``seg2split``, ``seg``, ``sell``,
``chunked``), as ``bench.py`` plans its graphs.
``facade_entry(device)`` gives the toy graph as a value-less ``SparseTensor``
with int64 indices, as PyG hands ``adj_t`` over, and its features;
``gcn_norm`` is PyG's normalization of such a tensor on the facade.
``sample_entry(device)`` gives the same graph with its values, and seed
nodes, for neighbour sampling, walks and partitioning.
``dryrun_multichip(n_devices, device)`` is ``__graft_entry__``'s multi-chip
dry run on ``parallel/``: one process per rank runs every block of
:class:`DryRun` (the row-sharded GCN train step, ring, halo and 2-D SpMMs,
the sharded seg2 steps, the row-sharded SpGEMM) with the JAX dry run's
checks and lines; ``sharded_train_step`` is its train step over any
row-sharded adjacency.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``); without a card it raises instead of carrying on on the
CPU.
"""
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from .core.matrix import PaddedCOO
from torch import nn

from .models.gcn import (GCN, gcn_normalize, init_appnp, init_gat, init_gcn,
                         init_gin, init_sage)
from .ops import spmm_seg
from .ops.spmm import make_spmm_plan
from .ops.spmm_seg2 import make_seg2_plan, pack_values
from .ops.spmm_seg3 import make_seg3_plan
from .ops.spmm_sell import make_sell_plan, pad_values
from .ops.spmm_split import make_split_plan, pack_values_split
from .ops.spspmm import plan_spgemm
from .parallel import (RowShardedAdjacency, device_put_2d, device_put_blocks,
                       device_put_halo, device_put_ring,
                       device_put_sharded_matrix, device_put_sharded_seg2,
                       gather_blocks, make_mesh, make_mesh_2d,
                       make_seg2_halo_plan, make_seg2_plan_sharded,
                       pack_values_sharded, replicate, shard_2d, shard_halo,
                       shard_padded_coo, shard_padded_rows,
                       shard_ring_buckets, shard_rows, spawn,
                       spgemm_rowsharded, spmm_2d, spmm_allgather,
                       spmm_halo, spmm_ring, spmm_ring_bucketed,
                       spmm_seg2_allgather, spmm_seg2_halo, stack_blocks)
from .parallel.mesh import axis_rank
from .parallel.spmm import block_coo
from .diag import fill_diag
from .mul import mul
from .reduce import sum as sparsesum
from .tensor import SparseTensor
from .utils import as_device

SPMM_BACKENDS = ("seg2", "seg3", "seg2split", "seg", "sell", "chunked")
MODELS = ("gcn", "sage", "gin", "appnp", "gat")


def _toy_graph(num_nodes=256, avg_deg=8, feat=32, classes=8, seed=0):
    """Synthetic row-sorted graph + features (host-side numpy); the same
    arrays as ``__graft_entry__._toy_graph`` for the same arguments."""
    rng = np.random.default_rng(seed)
    nnz = num_nodes * avg_deg
    row = np.sort(rng.integers(0, num_nodes, nnz))
    col = rng.integers(0, num_nodes, nnz)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = rng.random(nnz).astype(np.float32)
    x = rng.standard_normal((num_nodes, feat)).astype(np.float32)
    y = rng.integers(0, classes, num_nodes)
    return row, col, val, x, y


def model_entry(kind: str, device="cuda"):
    """``(model, adj, x, y)`` for the toy ``kind`` model (one of ``MODELS``)
    on ``device``: ``_toy_graph``'s adjacency (256 nodes, 2048 entries,
    values in [0, 1), capacity 2304), features (256, 32) and int64 labels
    of 8 classes, and a 2-layer model 32 -> 64 -> 8 as
    ``tests/test_models.py`` sets each family up: GCN and APPNP (``k=5``,
    ``alpha=0.1``) on the ``gcn_normalize``-d adjacency, GraphSAGE, GIN and
    GAT (2 heads of 16) on the raw one. The weights come from a CPU
    ``torch.Generator`` seeded with 0, so every device gets the same
    model."""
    if kind not in MODELS:
        raise ValueError(f"unknown model {kind!r}; one of {MODELS}")
    device = as_device(device)
    row, col, val, x, y = _toy_graph()
    adj = PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                device=device)
    if kind in ("gcn", "appnp"):
        adj = gcn_normalize(adj)
    gen = torch.Generator().manual_seed(0)
    if kind == "gat":
        model = init_gat(gen, 32, 16, 8, heads=2, device=device)
    elif kind == "appnp":
        model = init_appnp(gen, 32, 64, 8, k=5, device=device)
    else:
        init = {"gcn": init_gcn, "sage": init_sage, "gin": init_gin}[kind]
        model = init(gen, 32, 64, 8, device=device)
    return (model, adj, torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))


def train_entry(device="cuda"):
    """``(model, adj, x, y)`` for the toy GCN on ``device``, ``y`` the int64
    class labels of ``_toy_graph``: ``model_entry("gcn", device)``."""
    return model_entry("gcn", device)


def entry(device="cuda"):
    """``(model, adj, x)`` for the toy GCN on ``device``: ``train_entry``
    without the labels."""
    return train_entry(device)[:3]


def spgemm_entry(device="cuda") -> PaddedCOO:
    """The adjacency of ``_toy_graph`` (256 nodes, 2048 entries, values in
    [0, 1)) on ``device``, padded to capacity 2304 and coalesced, ready for
    ``A @ A``::

        F, cap = plan_spgemm_rows(A, A)
        C = spspmm_rowsorted(A, A, F, cap).matrix
    """
    row, col, val, _, _ = _toy_graph()
    return PaddedCOO.from_arrays(row, col, val, (256, 256), capacity=2304,
                                 device=as_device(device)).coalesce()


def spmm_entry(backend: str, device="cuda"):
    """``(plan, structure, packed, x)`` of the toy graph (256 nodes, 2048
    edges, values in [0, 1), x (256, 32) f32) for ``backend`` in
    ``SPMM_BACKENDS``, on ``device``, as ``bench.py`` builds its operands:
    plan, then lay the values out once (``packed``: the packed vector of
    seg2/seg3/split/seg, the (G, ng) grid of sell, the COO values of
    chunked). Segments of 64 rows give each row 4 spans (the default size
    would give the toy one); the split uses blocks of 64 so that both sides
    hold edges; sell groups 8 slots. Then::

        out = spmm_seg2(plan, structure, packed, x)    # or the backend's
    """
    dev = as_device(device)
    row, col, val, x, _ = _toy_graph()
    row, col = torch.as_tensor(row, device=dev), torch.as_tensor(col,
                                                                 device=dev)
    val, x = torch.as_tensor(val, device=dev), torch.as_tensor(x, device=dev)
    kw = dict(feat_dim=x.shape[1], sr=64)
    if backend == "seg2":
        plan, s = make_seg2_plan(row, col, 256, 256, **kw)
        return plan, s, pack_values(s, val), x
    if backend == "seg3":
        plan, s = make_seg3_plan(row, col, 256, 256, **kw)
        return plan, s, pack_values(s, val), x
    if backend == "seg2split":
        plan, s = make_split_plan(row, col, 256, 256, block=64, **kw)
        return plan, s, pack_values_split(s, val), x
    if backend == "seg":
        plan, s = spmm_seg.make_seg_plan(row, col, 256, 256,
                                         feat_dim=x.shape[1], seg_rows=64)
        return plan, s, spmm_seg.pack_values(s, val), x
    if backend == "sell":
        plan, s = make_sell_plan(row, col, 256, 256, group=8,
                                 feat_dim=x.shape[1])
        return plan, s, pad_values(s, val, group=8), x
    if backend == "chunked":
        plan, s = make_spmm_plan(row, col, 256, 256, x.shape[1])
        return plan, s, val, x
    raise ValueError(f"unknown SpMM backend {backend!r}; one of "
                     f"{SPMM_BACKENDS}")


def facade_entry(device="cuda"):
    """``(adj_t, x)`` on ``device``: ``_toy_graph``'s structure (256 nodes,
    2048 entries, duplicates and self loops included) as a
    ``SparseTensor(row=..., col=..., sparse_sizes=(256, 256))`` with int64
    indices and no value, and its features (256, 32) f32. Then::

        out = gcn_norm(adj_t) @ x
    """
    dev = as_device(device)
    row, col, _, x, _ = _toy_graph()
    adj_t = SparseTensor(row=torch.as_tensor(row, device=dev),
                         col=torch.as_tensor(col, device=dev),
                         sparse_sizes=(256, 256))
    return adj_t, torch.as_tensor(x, device=dev)


def sample_entry(device="cuda"):
    """``(adj, seeds)`` on ``device``: ``_toy_graph``'s structure (256
    nodes, 2048 entries, duplicates and self loops included) as a
    ``SparseTensor`` with int64 indices and its values in [0, 1), and 16
    seed nodes (int64, every 16th node). Then, as PyG's samplers use it::

        sub, n_id = sample_adj(adj, seeds, 5)        # one hop, fanout 5
        walks = random_walk(adj, seeds, 4)
        out, partptr, perm = partition(adj, 4)
    """
    dev = as_device(device)
    row, col, val, _, _ = _toy_graph()
    adj = SparseTensor(row=torch.as_tensor(row, device=dev),
                       col=torch.as_tensor(col, device=dev),
                       value=torch.as_tensor(val, device=dev),
                       sparse_sizes=(256, 256))
    return adj, torch.arange(0, 256, 16, device=dev)


def gcn_norm(adj_t: SparseTensor) -> SparseTensor:
    """PyG's ``gcn_norm`` of a ``SparseTensor`` with self loops of weight 1:
    ``D^-1/2 (A + I) D^-1/2`` with ``D`` the row sums of ``A + I`` (existing
    diagonal entries replaced), 0 where a degree is 0."""
    adj_t = fill_diag(adj_t, 1.0)
    deg = sparsesum(adj_t, dim=1)
    dis = deg.pow(-0.5)
    dis = dis.masked_fill(torch.isinf(dis), 0.0)
    adj_t = mul(adj_t, dis.view(-1, 1))
    return mul(adj_t, dis.view(1, -1))


def gcn_loss(model: nn.Module, adj: PaddedCOO, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``log_softmax(model(adj, x))`` at the
    labels ``y``, over all nodes, for any model of ``MODELS``."""
    logp = torch.log_softmax(model(adj, x), dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def train_step(model: nn.Module, adj: PaddedCOO, x: torch.Tensor,
               y: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGD step of :func:`gcn_loss` in place, ``p -= lr * grad`` for
    every parameter of ``model`` (any of ``MODELS``); returns the loss
    before the step (detached). Gradients of ``adj.value``, if it requires
    them, accumulate in ``adj.value.grad``."""
    model.zero_grad(set_to_none=True)
    loss = gcn_loss(model, adj, x, y)
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= lr * p.grad
    return loss.detach()


# ---- the multi-rank dry run -------------------------------------------------

DRYRUN_LR = 0.01


def dryrun_nodes(n_devices: int) -> int:
    """The dry run's default graph size: ``16 * n_devices`` nodes as in the
    JAX dry run, raised to at least 64 (in whole multiples of ``16 *
    n_devices``) so that its seg2 plans at segments of 32 rows always span
    more than one segment."""
    return 16 * n_devices * -(-4 // n_devices)


def sharded_train_step(model: nn.Module, adj, x: torch.Tensor,
                       y: torch.Tensor, num_nodes: int, lr: float,
                       group) -> dict:
    """One train step of ``model`` (any of ``MODELS``) over a row-sharded
    adjacency (anything with ``spmm`` over this rank's rows, such as
    ``parallel.RowShardedAdjacency``), from this rank's rows of ``x`` and
    labels ``y``: the NLL summed over this rank's rows over ``num_nodes``
    (so the ranks' losses sum to ``gcn_loss``), backward, every parameter
    grad summed over the ranks of ``group`` (each rank's share of the full
    gradient, as ``all_gather``'s transpose hands it over), SGD in place.
    Returns ``{"loss": the summed loss, "params": the state after the
    step, "grads": the summed grads}``."""
    model.zero_grad(set_to_none=True)
    logp = torch.log_softmax(model(adj, x), dim=-1)
    local = -logp.gather(1, y[:, None]).sum() / num_nodes
    local.backward()
    loss = local.detach().clone()
    dist.all_reduce(loss, group=group)
    with torch.no_grad():
        for p in model.parameters():
            dist.all_reduce(p.grad, group=group)
            p -= lr * p.grad
    return {"loss": loss, "params": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()}}


class DryRun:
    """One rank's part of :func:`dryrun_multichip`, block by block, on the
    JAX dry run's toy graph (``_toy_graph(num_nodes, avg_deg=4, feat=16,
    classes=4)``) and GCN 16 -> 32 -> 4. The graph is built and sharded on
    the host; each rank takes its blocks to ``device``. Every block checks
    its results (raising ``AssertionError``), prints the JAX dry run's line
    on rank 0 and returns what it computed, as this rank holds it:

    * :meth:`gcn_step`: the row-sharded GCN train step (all-gather of ``x``
      and ``h`` through ``RowShardedAdjacency``; :func:`sharded_train_step`
      at ``DRYRUN_LR``);
    * :meth:`interchanges`: ring, bucketed ring and halo against the
      all-gather SpMM at 1e-4;
    * :meth:`grid_2d`: the 2-D SpMM on a (2, D/2) grid, (1, D) for odd D;
    * :meth:`seg2_step` / :meth:`seg2_halo_step`: the seg2 SpMM under the
      all-gather / the halo all-to-all against the all-gather SpMM, and the
      GCN step through it (more than one segment asserted for the former);
    * :meth:`spgemm`: the row-sharded ``A @ A`` against dense.

    ``params``: a GCN state dict (``gcn_params_from_jax`` turns the JAX
    dry run's into one); default ``init_gcn`` from seed 0. Rank 0's
    parameters are broadcast to every rank. ``value_grad=True`` on a step
    also differentiates the adjacency's values (its ``d value`` returned)."""

    def __init__(self, mesh, device, num_nodes: int, params=None,
                 verbose: bool = True):
        self.mesh, self.device = mesh, torch.device(device)
        self.group, self.rank, self.world = axis_rank(mesh)
        self.verbose = verbose
        D, n = self.world, num_nodes
        row, col, val, x, y = _toy_graph(num_nodes=n, avg_deg=4, feat=16,
                                         classes=4)
        self.num_nodes = n
        self.adj = SparseTensor(row=torch.as_tensor(row),
                                col=torch.as_tensor(col),
                                value=torch.as_tensor(val),
                                sparse_sizes=(n, n))
        self.mat = shard_padded_coo(self.adj, D)
        self.blk = device_put_sharded_matrix(self.mat, self.rank,
                                             self.device)
        self.x_full = torch.as_tensor(x)
        self.x = shard_rows(self.x_full, D, self.rank, self.device)
        self.y = shard_rows(torch.as_tensor(y), D, self.rank, self.device)
        if params is None:
            params = init_gcn(torch.Generator().manual_seed(0), 16, 32,
                              4).state_dict()
        self.params = {k: replicate(torch.as_tensor(v).to(self.device,
                                                          copy=True))
                       for k, v in params.items()}
        self.out_ag = None

    def _print(self, msg: str) -> None:
        if self.verbose and self.rank == 0:
            print(f"dryrun_multichip({self.world}): {msg}", flush=True)

    def _step(self, adj, value_leaf):
        model = GCN(16, 32, 4, device=self.device)
        model.load_state_dict(self.params)
        res = sharded_train_step(model, adj, self.x, self.y, self.num_nodes,
                                 DRYRUN_LR, self.group)
        res["d_value"] = None if value_leaf is None else value_leaf.grad
        return res

    def _value(self, value, value_grad):
        return value.detach().clone().requires_grad_() if value_grad \
            else value

    def gcn_step(self, value_grad: bool = False) -> dict:
        block = block_coo(self.blk)
        value = self._value(block.value, value_grad)
        block = block.with_value(value) if value_grad else block
        res = self._step(RowShardedAdjacency(block, self.group),
                         value if value_grad else None)
        self._print(f"one sharded GCN train step OK, "
                    f"loss={float(res['loss']):.4f}")
        return res

    def all_gather_spmm(self) -> torch.Tensor:
        """This rank's rows of ``A @ x`` through the all-gather SpMM (the
        other interchanges' reference), computed once."""
        if self.out_ag is None:
            self.out_ag = spmm_allgather(self.mesh, self.blk, self.x)
        return self.out_ag

    def _close(self, got, what):
        torch.testing.assert_close(got, self.all_gather_spmm(), rtol=1e-4,
                                   atol=1e-4, msg=lambda m: f"{what}: {m}")

    def interchanges(self) -> dict:
        D, r, dev = self.world, self.rank, self.device
        out = {"all_gather": self.all_gather_spmm(),
               "ring": spmm_ring(self.mesh, self.blk, self.x)}
        rmat = device_put_ring(shard_ring_buckets(self.adj, D), r, dev)
        out["ring_bucketed"] = spmm_ring_bucketed(self.mesh, rmat, self.x)
        hblk = device_put_halo(shard_halo(self.adj, D), r, dev)
        out["halo"] = spmm_halo(self.mesh, hblk, self.x)
        for name in ("ring", "ring_bucketed", "halo"):
            self._close(out[name], name)
        self._print("ring / bucketed-ring / halo SpMM all match all-gather "
                    "SpMM")
        return out

    def grid_2d(self) -> torch.Tensor:
        D = self.world
        dr, dc = (2, D // 2) if D % 2 == 0 else (1, D)
        mesh2 = make_mesh_2d(dr, dc)
        m2 = device_put_2d(shard_2d(self.adj, dr, dc), self.rank,
                           self.device)
        xb = shard_rows(self.x_full, dc, self.rank % dc, self.device)
        out = spmm_2d(mesh2, m2, xb)
        self._close(out, "2-D")
        self._print(f"2-D psum_scatter SpMM matches ({dr}x{dc} grid)")
        return out

    def _seg2_step(self, sharded, value, spmm, value_grad, what):
        shard = device_put_sharded_seg2(sharded, self.rank, self.device)
        packed = pack_values_sharded(sharded, value)[self.rank].to(
            self.device)
        out = spmm(shard, packed, self.x)
        self._close(out, what)
        leaf = self._value(packed, value_grad)
        # an adjacency for GCN.forward: spmm over this rank's seg2 block
        adj = SimpleNamespace(spmm=lambda h: spmm(shard, leaf, h))
        res = self._step(adj, leaf if value_grad else None)
        res.update(out=out, S=shard.plan.S, SR=shard.plan.SR)
        return res

    def seg2_step(self, value_grad: bool = False) -> dict:
        sharded = make_seg2_plan_sharded(self.mat, feat_dim=16, sr=32,
                                         chunk_edges=128, ranks=[self.rank])
        if sharded.plans[self.rank].S <= 1:
            raise AssertionError("dry run must exercise multi-segment "
                                 "geometry")
        res = self._seg2_step(
            sharded, self.mat.value,
            lambda s, v, h: spmm_seg2_allgather(self.mesh, s, v, h),
            value_grad, "seg2 all-gather")
        self._print(f"sharded GCN train step through the seg2 flagship "
                    f"(spans forward, fused span backward) OK "
                    f"(S={res['S']}, loss={float(res['loss']):.4f})")
        return res

    def seg2_halo_step(self, value_grad: bool = False) -> dict:
        hmat = shard_halo(self.adj, self.world)
        hblk = device_put_halo(hmat, self.rank, self.device)
        sharded = make_seg2_halo_plan(hmat, feat_dim=16, sr=32,
                                      chunk_edges=128, ranks=[self.rank])
        res = self._seg2_step(
            sharded, hmat.value,
            lambda s, v, h: spmm_seg2_halo(self.mesh, hblk, s, v, h),
            value_grad, "seg2 x halo")
        self._print(f"sharded GCN train step through seg2 x HALO "
                    f"(deduplicated all_to_all, H={hmat.halo_per_src}) OK "
                    f"(loss={float(res['loss']):.4f})")
        return res

    def spgemm(self) -> dict:
        n = self.num_nodes
        blocks, rows_per = shard_padded_rows(self.adj, self.world)
        A_blk = device_put_blocks(blocks, self.rank, self.device)
        A = PaddedCOO.from_eager(self.adj)
        B = A.to(self.device)
        flop_cap, out_cap = plan_spgemm(A, A, exact_out=False)
        C_blk, overflowed = spgemm_rowsharded(self.mesh, A_blk, B,
                                              flop_capacity=flop_cap,
                                              out_capacity=out_cap)
        if bool(overflowed.any()):
            raise AssertionError(f"row-sharded SpGEMM overflowed: "
                                 f"{overflowed.tolist()}")
        row, col, val = gather_blocks(stack_blocks(self.mesh, C_blk),
                                      rows_per, n, n)
        got = torch.zeros(n, n, device=self.device).index_put_(
            (row.long(), col.long()), val, accumulate=True)
        dense = self.adj.to_dense().to(self.device)
        torch.testing.assert_close(got, dense @ dense, rtol=1e-4, atol=1e-4)
        self._print("row-sharded SpGEMM matches dense A @ A")
        return {"C": got, "overflowed": overflowed}

    def run(self) -> dict:
        """Every block in the JAX dry run's order."""
        return {"gcn_step": self.gcn_step(),
                "interchanges": self.interchanges(),
                "grid_2d": self.grid_2d(),
                "seg2_step": self.seg2_step(),
                "seg2_halo_step": self.seg2_halo_step(),
                "spgemm": self.spgemm()}


def dryrun_rank(rank: int, world: int, device_type: str, num_nodes: int,
                params) -> dict:
    """One spawned rank of :func:`dryrun_multichip`."""
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    return DryRun(make_mesh(world), device, num_nodes, params).run()


def dryrun_multichip(n_devices: int, device="cuda", num_nodes=None,
                     params=None) -> dict:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: one process
    per rank (``parallel.spawn``: NCCL, one card per rank, on ``"cuda"``;
    gloo on ``"cpu"``) runs every block of :class:`DryRun` with the JAX dry
    run's checks and printed lines; returns rank 0's results (numpy).
    ``num_nodes`` defaults to :func:`dryrun_nodes`. On ``"cuda"`` with
    fewer cards than ranks it raises and names the reason."""
    dev = as_device(device)
    n = num_nodes or dryrun_nodes(n_devices)
    return spawn(dryrun_rank, n_devices, dev.type, n, params,
                 device=dev.type)[0]
