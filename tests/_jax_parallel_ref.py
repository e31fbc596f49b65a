"""The JAX side of the spawned parity tests of
``paddle_sparse_tpu_torch.parallel`` (``tests/test_torch_parallel*.py``),
computed in the test process on the virtual CPU mesh: each sharded SpMM's
output and its ``jax.vjp``, and the dry run's train steps rebuilt from
``__graft_entry__.py:63-124`` (the row-sharded GCN step) and ``:170-248``
(the seg2 and seg2 x halo steps), with the values' grads besides. Nothing of
the JAX package or of ``__graft_entry__.py`` changes for it."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_sparse_tpu import SparseTensor
from paddle_sparse_tpu import parallel as jpar
from paddle_sparse_tpu.models import init_gcn
from paddle_sparse_tpu.ops.spmm import spmm_coo
from paddle_sparse_tpu.parallel import spmm_seg2 as jseg2
from paddle_sparse_tpu.parallel.spmm import device_put_sharded_matrix
from paddle_sparse_tpu.parallel.spmm2d import make_mesh_2d, shard_2d
from paddle_sparse_tpu_torch import parallel as tpar
from paddle_sparse_tpu_torch.entry import DRYRUN_LR, _toy_graph

# f32 sums in another order: 1e-5 of the entry, or of the largest entry
# for those near 0 by cancellation
RTOL = 1e-5


def close(got, want, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=name)


def graph_64():
    """``tests/test_parallel.py``'s graph (64 x 64, 512 entries, seed 3),
    x of K = 16 and a cotangent g, from the same seed."""
    rng = np.random.default_rng(3)
    M = N = 64
    nnz, K = 512, 16
    row = np.sort(rng.integers(0, M, nnz))
    col = rng.integers(0, N, nnz)
    order = np.lexsort((col, row))
    val = rng.standard_normal(nnz).astype(np.float32)
    return {"row": row[order], "col": col[order], "val": val[order],
            "shape": (M, N),
            "x": rng.standard_normal((N, K)).astype(np.float32),
            "g": rng.standard_normal((M, K)).astype(np.float32)}


def coalesced(rng, m, k, nnz):
    """A random (m, k) matrix coalesced by the JAX facade, and its arrays."""
    row = np.sort(rng.integers(0, m, nnz))
    col = rng.integers(0, k, nnz)
    val = rng.standard_normal(nnz).astype(np.float32)
    t = SparseTensor(row=np.asarray(row), col=np.asarray(col),
                      value=np.asarray(val), sparse_sizes=(m, k)).coalesce()
    return t, (np.asarray(t.storage.row()), np.asarray(t.storage.col()),
               np.asarray(t.storage.value()))


def spgemm_operands():
    """``tests/test_parallel.py::test_spgemm_rowsharded``'s operands (A 64 x
    48, B 48 x 40, seed 11), coalesced by the JAX facade."""
    rng = np.random.default_rng(11)
    A, (ra, ca, va) = coalesced(rng, 64, 48, 400)
    B, (rb, cb, vb) = coalesced(rng, 48, 40, 300)
    d = {"a_row": ra, "a_col": ca, "a_val": va, "a_shape": (64, 48),
         "b_row": rb, "b_col": cb, "b_val": vb, "b_shape": (48, 40)}
    return A, B, d


def shard_flops(A, B, D):
    """Flops of each of A's D row blocks against B (numpy)."""
    degB = np.bincount(np.asarray(B.storage.row()), minlength=B.sizes()[0])
    flops = degB[np.asarray(A.storage.col())]
    return np.bincount(np.asarray(A.storage.row()) // (A.sizes()[0] // D),
                       weights=flops, minlength=D).astype(np.int64)


def tensor(d, prefix=""):
    val = d.get(prefix + "val")
    return SparseTensor(row=jnp.asarray(d[prefix + "row"]),
                        col=jnp.asarray(d[prefix + "col"]),
                        value=None if val is None else jnp.asarray(val),
                        sparse_sizes=tuple(d[prefix + "shape"]))


def _vjp(fn, x, v, g):
    out, vjp = jax.vjp(fn, x, v)
    dx, dv = vjp(jnp.asarray(g, out.dtype))
    return {"out": np.asarray(out), "dx": np.asarray(dx),
            "dv": np.asarray(dv)}


def spmm_vjp(name: str, D: int, d) -> dict:
    """The JAX counterpart of the worker case ``name`` (``allgather``,
    ``ring``, ``ring_bucketed``, ``halo``, ``2d``, ``seg2_allgather``,
    ``seg2_halo``) on a mesh of ``D``: the global output, ``d x`` and the
    stacked ``d value`` (of the packed values for seg2)."""
    adj = tensor(d)
    mesh = jpar.make_mesh(D)
    x = jax.device_put(jnp.asarray(d["x"]), NamedSharding(mesh, P("x", None)))
    if name in ("allgather", "ring"):
        mat = device_put_sharded_matrix(mesh, jpar.shard_padded_coo(adj, D))
        fn = jpar.spmm_allgather if name == "allgather" else jpar.spmm_ring
        return _vjp(lambda xx, v: fn(mesh, mat._replace(value=v), xx), x,
                    mat.value, d["g"])
    if name == "ring_bucketed":
        mat = jpar.device_put_ring(mesh, jpar.shard_ring_buckets(adj, D))
        return _vjp(lambda xx, v: jpar.spmm_ring_bucketed(
            mesh, mat._replace(value=v), xx), x, mat.value, d["g"])
    if name == "halo":
        mat = jpar.device_put_halo(mesh, jpar.shard_halo(adj, D))
        return _vjp(lambda xx, v: jpar.spmm_halo(
            mesh, mat._replace(value=v), xx), x, mat.value, d["g"])
    if name == "2d":
        dr, dc = d["grid"]
        mesh2 = make_mesh_2d(dr, dc)
        mat = jpar.device_put_2d(mesh2, shard_2d(adj, dr, dc))
        xb = jax.device_put(jnp.asarray(d["x"]),
                            NamedSharding(mesh2, P("dc", None)))
        return _vjp(lambda xx, v: jpar.spmm_2d(mesh2, mat._replace(value=v),
                                               xx), xb, mat.value, d["g"])
    if name == "seg2_allgather":
        mat = device_put_sharded_matrix(mesh, jpar.shard_padded_coo(adj, D))
        sh = jseg2.device_put_sharded_seg2(mesh, jseg2.make_seg2_plan_sharded(
            mat, feat_dim=d["x"].shape[1], sr=int(d["sr"]), chunk_edges=128))
        res = _vjp(lambda xx, v: jseg2.spmm_seg2_allgather(mesh, sh, v, xx)
                   .reshape(-1, d["x"].shape[1]), x,
                   jseg2.pack_values_sharded(sh, mat.value), d["g"])
        res["S"] = sh.plan.S
        return res
    if name == "seg2_halo":
        hmat = jpar.shard_halo(adj, D)
        sh = jseg2.make_seg2_halo_plan(hmat, feat_dim=d["x"].shape[1],
                                       sr=int(d["sr"]), chunk_edges=128)
        res = _vjp(lambda xx, v: jseg2.spmm_seg2_halo(mesh, hmat, sh, v, xx)
                   .reshape(-1, d["x"].shape[1]), x,
                   jseg2.pack_values_sharded(sh, hmat.value), d["g"])
        res["dv"] = without_padding(sh, res["dv"], hmat.row,
                                    hmat.rows_per_shard)
        return res
    raise ValueError(name)


def without_padding(sharded, packed, row, rows_per):
    """JAX's packed values (D, C) with each shard's padding entries left out
    (in its plan's order), then 0: the port's packed layout."""
    perm = np.asarray(sharded.structure.perm_f)
    packed = np.asarray(packed)
    out = np.zeros_like(packed)
    for d in range(out.shape[0]):
        real = np.asarray(row[d])[perm[d]] < rows_per
        out[d, :real.sum()] = packed[d][real]
    return out


def _new(params, grads):
    return jax.tree_util.tree_map(lambda p, g: p - DRYRUN_LR * g, params,
                                  grads)


def dryrun_steps(D: int, num_nodes: int) -> dict:
    """The JAX dry run's three train steps on a mesh of ``D`` at
    ``num_nodes``, each from the initial parameters, with the grads too:
    ``{"params": initial, name: {"loss", "params", "grads", "d_value"}}``
    for ``gcn_step`` (``d_value`` (D, C) per shard), ``seg2_step`` and
    ``seg2_halo_step`` (``d_value`` of the packed values, the latter with
    its padding left out as the port packs)."""
    row, col, val, x, y = _toy_graph(num_nodes=num_nodes, avg_deg=4,
                                     feat=16, classes=4)
    n = num_nodes
    mesh = jpar.make_mesh(D)
    adj = SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                       value=jnp.asarray(val), sparse_sizes=(n, n))
    mat = device_put_sharded_matrix(mesh, jpar.shard_padded_coo(adj, D))
    rows_per = mat.rows_per_shard
    params = init_gcn(jax.random.PRNGKey(0), 16, 32, 4)
    x_arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x", None)))
    y_arr = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("x")))
    spec2 = P("x", None)

    def local_spmm(row_l, col_l, val_l, x_full):
        return spmm_coo(row_l, col_l, val_l, x_full, rows_per + 1,
                        "sum")[:rows_per]

    # __graft_entry__.py:91-108, as it is
    def loss_fn(params, row_b, col_b, val_b, x_local, y_local):
        x_full = jax.lax.all_gather(x_local, "x", tiled=True)
        h = local_spmm(row_b, col_b, val_b, x_full)
        h = jax.nn.relu(h @ params["layers"][0]["w"]
                        + params["layers"][0]["b"])
        h_full = jax.lax.all_gather(h, "x", tiled=True)
        out = local_spmm(row_b, col_b, val_b, h_full)
        out = out @ params["layers"][1]["w"] + params["layers"][1]["b"]
        logp = jax.nn.log_softmax(out, axis=-1)
        local_loss = -jnp.take_along_axis(
            logp, y_local[:, None], axis=1).sum()
        return jax.lax.psum(local_loss, "x") / (rows_per * D)

    # __graft_entry__.py:110-124, with d value (per shard) besides
    def step_kernel(params, row_b, col_b, val_b, x_local, y_local):
        row_l, col_l, val_l = row_b[0], col_b[0], val_b[0]
        loss, (grads, dv) = jax.value_and_grad(loss_fn, argnums=(0, 3))(
            params, row_l, col_l, val_l, x_local, y_local)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "x"), grads)
        return _new(params, grads), loss, grads, dv[None]

    step = jax.jit(shard_map(
        step_kernel, mesh=mesh,
        in_specs=(P(), spec2, spec2, spec2, spec2, P("x")),
        out_specs=(P(), P(), P(), spec2)))
    p1, loss1, g1, dv1 = step(params, mat.row, mat.col, mat.value, x_arr,
                              y_arr)
    out = {"params": params, "gcn_step": {"loss": loss1, "params": p1,
                                          "grads": g1, "d_value": dv1}}

    def seg2_like(spmm, packed):
        def loss(params, pv):
            h = spmm(pv, x_arr).reshape(n, -1)
            h = jax.nn.relu(h @ params["layers"][0]["w"]
                            + params["layers"][0]["b"])
            o = spmm(pv, h).reshape(n, -1)
            o = o @ params["layers"][1]["w"] + params["layers"][1]["b"]
            logp = jax.nn.log_softmax(o, axis=-1)
            return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                        axis=1).mean()
        lv, (grads, dpv) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1)))(params, packed)
        return {"loss": lv, "params": _new(params, grads), "grads": grads,
                "d_value": dpv}

    sh = jseg2.device_put_sharded_seg2(mesh, jseg2.make_seg2_plan_sharded(
        mat, feat_dim=16, sr=32, chunk_edges=128))
    out["seg2_step"] = seg2_like(
        lambda pv, h: jseg2.spmm_seg2_allgather(mesh, sh, pv, h),
        jseg2.pack_values_sharded(sh, mat.value))
    out["seg2_step"]["S"] = sh.plan.S
    hmat = jpar.device_put_halo(mesh, jpar.shard_halo(adj, D))
    shh = jseg2.device_put_sharded_seg2(mesh, jseg2.make_seg2_halo_plan(
        hmat, feat_dim=16, sr=32, chunk_edges=128))
    res = seg2_like(
        lambda pv, h: jseg2.spmm_seg2_halo(mesh, hmat, shh, pv, h),
        jseg2.pack_values_sharded(shh, hmat.value))
    res["d_value"] = without_padding(shh, res["d_value"], hmat.row,
                                     hmat.rows_per_shard)
    out["seg2_halo_step"] = res
    return jax.tree_util.tree_map(np.asarray, out)


def penalty_step(D: int, num_nodes: int, lam: float, params) -> dict:
    """The dry run's row-sharded GCN step (``dryrun_steps``' ``loss_fn``)
    with the input-gradient penalty ``loss + lam * |d loss / d x|^2`` under
    ``shard_map``: each device's ``d loss / d x_local`` by ``jax.grad``
    inside the map (the whole derivative at its rows), the squares summed
    over the mesh, then ``jax.grad`` of the sum and ``pmean``, as the dry
    run's step takes its grads. ``{"loss", "grads", "params"}`` (after SGD
    at ``DRYRUN_LR``)."""
    row, col, val, x, y = _toy_graph(num_nodes=num_nodes, avg_deg=4,
                                     feat=16, classes=4)
    n = num_nodes
    mesh = jpar.make_mesh(D)
    adj = SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                       value=jnp.asarray(val), sparse_sizes=(n, n))
    mat = device_put_sharded_matrix(mesh, jpar.shard_padded_coo(adj, D))
    rows_per = mat.rows_per_shard
    x_arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x", None)))
    y_arr = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("x")))
    spec2 = P("x", None)

    def local_spmm(row_l, col_l, val_l, x_full):
        return spmm_coo(row_l, col_l, val_l, x_full, rows_per + 1,
                        "sum")[:rows_per]

    def loss_fn(params, row_l, col_l, val_l, x_local, y_local):
        x_full = jax.lax.all_gather(x_local, "x", tiled=True)
        h = local_spmm(row_l, col_l, val_l, x_full)
        h = jax.nn.relu(h @ params["layers"][0]["w"]
                        + params["layers"][0]["b"])
        h_full = jax.lax.all_gather(h, "x", tiled=True)
        out = local_spmm(row_l, col_l, val_l, h_full)
        out = out @ params["layers"][1]["w"] + params["layers"][1]["b"]
        logp = jax.nn.log_softmax(out, axis=-1)
        local_loss = -jnp.take_along_axis(
            logp, y_local[:, None], axis=1).sum()
        return jax.lax.psum(local_loss, "x") / (rows_per * D)

    def pen_fn(params, row_l, col_l, val_l, x_local, y_local):
        gx = jax.grad(loss_fn, argnums=4)(params, row_l, col_l, val_l,
                                          x_local, y_local)
        return (loss_fn(params, row_l, col_l, val_l, x_local, y_local)
                + lam * jax.lax.psum((gx ** 2).sum(), "x"))

    def step_kernel(params, row_b, col_b, val_b, x_local, y_local):
        loss, grads = jax.value_and_grad(pen_fn)(
            params, row_b[0], col_b[0], val_b[0], x_local, y_local)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, "x"), grads)
        return _new(params, grads), loss, grads

    step = jax.jit(shard_map(
        step_kernel, mesh=mesh,
        in_specs=(P(), spec2, spec2, spec2, spec2, P("x")),
        out_specs=(P(), P(), P())))
    p1, loss1, g1 = step(params, mat.row, mat.col, mat.value, x_arr, y_arr)
    return jax.tree_util.tree_map(np.asarray, {"loss": loss1, "params": p1,
                                               "grads": g1})


def c_of(ranks, shape):
    """The port's C as ``gather_blocks`` merges the ranks' blocks."""
    blocks = tpar.RowBlocks(
        row=torch.as_tensor(np.stack([r["row"] for r in ranks])),
        col=torch.as_tensor(np.stack([r["col"] for r in ranks])),
        value=torch.as_tensor(np.stack([r["value"] for r in ranks])),
        nnz=torch.as_tensor([int(r["nnz"]) for r in ranks]), shape=shape)
    return tpar.gather_blocks(blocks, shape[0], 0, 0)


def jax_spgemm(A, B, D, flop_cap, out_cap):
    """JAX's row-sharded ``A @ B`` on a mesh of ``D``: its C as
    ``gather_blocks`` merges it, and the (D,) overflow flags."""
    mesh = jpar.make_mesh(D)
    blocks, rows_per = jpar.shard_padded_rows(A, D)
    blocks = jpar.device_put_blocks(mesh, blocks)
    B_pad = jax.device_put(B.to_padded(), NamedSharding(mesh, P()))
    C, over = jpar.spgemm_rowsharded(mesh, blocks, B_pad, flop_cap, out_cap)
    return jpar.gather_blocks(C, rows_per, 0, 0), np.asarray(over)
