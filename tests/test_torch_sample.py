"""Port parity: neighbour sampling and random walks against the JAX package
on the same numpy inputs.

* ``ops.sample``: ``sample_neighbors``, ``sample_adj_padded`` (with and
  without replacement) and ``random_walk`` are equal to the JAX functions
  when fed the uniforms ``jax.random.uniform`` draws from the JAX key (the
  port's private seams take the uniforms; without replacement the port takes
  the priorities of the subset rows' edges only, read from JAX's per-edge
  draw). Rows of degree 0, the last row among them, with and without a
  subset, int32 and int64 indices.
* the public functions with the port's own generator pass the structural
  checks of ``tests/test_sample.py``.
* the facade: ``sample_adj(..., rng=np.random.default_rng(s))`` equals the
  JAX package's pure-Python path; the native runtime with one seed equals
  JAX's native one; ``sample`` (fed JAX's uniforms) and ``saint_subgraph``
  are equal.
* the draw offset is clamped to ``deg - 1``: JAX's ``sample_neighbors``
  casts ``deg`` to f32, and with f64 uniforms ``floor(u * deg)`` reaches
  ``deg`` on a row of more than 2**24 edges.

Everything is compared exactly (indices and copied values)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu import runtime as jrt
from paddle_sparse_tpu.ops import sample as jops
from paddle_sparse_tpu.sample import sample as jsample
from paddle_sparse_tpu_torch import runtime as trt
from paddle_sparse_tpu_torch.ops import sample as tops

# the package's ``sample`` function shadows its module of that name
tsample_mod = importlib.import_module("paddle_sparse_tpu_torch.sample")


def _graph(seed=0, n=40, max_deg=7, zero=(3, 17, 39), self_loops=True):
    """A row-sorted CSR with rows of degree 0 (the last row among them)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, max_deg + 1, n)
    deg[list(zero)] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    col = np.concatenate([np.sort(rng.choice(n, d, replace=False))
                          for d in deg]) if deg.sum() else np.zeros(0, int)
    if not self_loops:
        col = np.where(col == np.repeat(np.arange(n), deg), (col + 1) % n,
                       col)
    return rowptr.astype(np.int64), col.astype(np.int64)


def _both(a, dtype):
    return (torch.as_tensor(a.astype(np.int64)).to(dtype),
            jnp.asarray(a, {torch.int32: jnp.int32,
                            torch.int64: jnp.int64}[dtype]))


def _edges_of(rowptr, subset):
    return np.concatenate([np.arange(rowptr[s], rowptr[s + 1])
                           for s in subset]).astype(np.int64)


def _eq(t, j):
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


IDX = pytest.mark.parametrize("dtype", [torch.int32, torch.int64],
                              ids=["i32", "i64"])


@IDX
@pytest.mark.parametrize("subset", [None, [39, 0, 3, 12, 17, 5, 39]],
                         ids=["all", "subset"])
def test_sample_neighbors_equal(dtype, subset):
    rowptr, col = _graph()
    (tp, jp), (tc, jc) = _both(rowptr, dtype), _both(col, dtype)
    key = jax.random.PRNGKey(3)
    j_sub = None if subset is None else jnp.asarray(subset)
    want = jops.sample_neighbors(jp, jc, key, 4, j_sub)
    n = len(rowptr) - 1 if subset is None else len(subset)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n, 4))))
    got = tops._sample_neighbors(tp, tc, u, subset)
    _eq(got, want)


@IDX
@pytest.mark.parametrize("replace", [True, False], ids=["replace", "distinct"])
@pytest.mark.parametrize("subset", [[2, 5, 39, 0, 17, 11],
                                    list(range(40))], ids=["some", "every"])
def test_sample_adj_padded_equal(dtype, replace, subset):
    rowptr, col = _graph(seed=1)
    (tp, jp), (tc, jc) = _both(rowptr, dtype), _both(col, dtype)
    F = 3
    key = jax.random.PRNGKey(7)
    sub = np.asarray(subset)
    want = jops.sample_adj_padded(jp, jc, jnp.asarray(sub, jc.dtype), F,
                                  replace, key)
    if replace:
        u = np.array(jax.random.uniform(key, (len(sub), F)))
    else:   # JAX's per-edge priorities, at the subset rows' edges
        u = np.asarray(jax.random.uniform(key, (len(col),)))
        u = u[_edges_of(rowptr, sub)]
    got = tops._sample_adj_padded(tp, tc, torch.from_numpy(sub), F, replace,
                                  torch.from_numpy(u))
    for name in tops.PaddedAdj._fields:
        _eq(getattr(got, name), getattr(want, name))
    assert got.col.dtype == dtype and got.n_id.dtype == dtype


def test_sample_adj_padded_priority_ties_break_by_edge():
    """Equal priorities: the lower edge position goes first, as JAX's
    lexsort keeps it."""
    rowptr, col = _graph(seed=2)
    sub = np.asarray([1, 4, 6])
    u = np.zeros(len(_edges_of(rowptr, sub)))
    got = tops._sample_adj_padded(torch.from_numpy(rowptr),
                                  torch.from_numpy(col),
                                  torch.from_numpy(sub), 2, False,
                                  torch.from_numpy(u))
    ptr = got.rowptr.numpy()
    for i, s in enumerate(sub):
        e = np.sort(got.e_id.numpy()[ptr[i]:ptr[i + 1]])
        want = np.arange(rowptr[s], rowptr[s] + min(2, rowptr[s + 1]
                                                    - rowptr[s]))
        np.testing.assert_array_equal(e, want)


@IDX
def test_random_walk_equal(dtype):
    rowptr, col = _graph(seed=4)
    (tp, jp), (tc, jc) = _both(rowptr, dtype), _both(col, dtype)
    start = np.asarray([0, 3, 39, 17, 8, 8, 21])
    key = jax.random.PRNGKey(11)
    want = jops.random_walk(jp, jc, jnp.asarray(start, jc.dtype), 6, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (6, 7))))
    got = tops._random_walk(tp, tc, torch.as_tensor(start).to(dtype), u)
    _eq(got, want)
    assert got.dtype == dtype


def _check_sampled(rowptr, col, sub, out, distinct):
    ptr = out.rowptr.numpy()
    n_id = out.n_id.numpy()
    for i, s in enumerate(sub):
        nbrs = set(col[rowptr[s]:rowptr[s + 1]].tolist())
        got = [int(n_id[c]) for c in out.col.numpy()[ptr[i]:ptr[i + 1]]]
        assert set(got) <= nbrs
        assert len(got) == (min(len(nbrs), 3) if distinct
                            else (3 if nbrs else 0))
        if distinct:
            assert len(set(got)) == len(got)
    k = int(out.num_nodes)
    assert n_id[:len(sub)].tolist() == list(sub)
    assert len(set(n_id[:k].tolist())) == k
    assert (n_id[k:] == tops.SENTINEL).all()
    valid = out.edge_mask.numpy()
    assert valid.sum() == int(out.num_edges) == ptr[-1]
    e = out.e_id.numpy()[valid]
    np.testing.assert_array_equal(col[e], n_id[out.col.numpy()[valid]])


@pytest.mark.parametrize("replace", [True, False], ids=["replace", "distinct"])
def test_public_samplers_structural(replace):
    rowptr, col = _graph(seed=5, self_loops=False)
    tp, tc = torch.from_numpy(rowptr), torch.from_numpy(col)
    gen = torch.Generator().manual_seed(0)
    sub = [5, 39, 0, 17, 30]
    out = tops.sample_adj_padded(tp, tc, torch.tensor(sub), 3, replace, gen)
    _check_sampled(rowptr, col, sub, out, not replace)
    nb = tops.sample_neighbors(tp, tc, gen, 5, sub).numpy()
    for s, row in zip(sub, nb):
        if rowptr[s + 1] > rowptr[s]:
            assert set(row.tolist()) <= set(col[rowptr[s]:rowptr[s + 1]])
    walks = tops.random_walk(tp, tc, torch.arange(40), 5, gen).numpy()
    assert walks.shape == (40, 6) and (walks[:, 0] == np.arange(40)).all()
    for w in walks:
        for u, v in zip(w[:-1], w[1:]):
            nbrs = col[rowptr[u]:rowptr[u + 1]].tolist()
            assert v in nbrs or (not nbrs and v == u)
    # the default generator is the facade's, seeded by seed()
    tsp.seed(4)
    a = tops.random_walk(tp, tc, torch.arange(40), 5, None)
    tsp.seed(4)
    b = tops.random_walk(tp, tc, torch.arange(40), 5, None)
    _eq(a, b.numpy())


def test_draw_offsets_clamp_past_2_24():
    """A row of more than 2**24 edges: JAX's ``sample_neighbors`` casts deg
    to f32 whatever the uniforms' dtype, and f32 rounds deg = 2**24 + 3 up
    to 2**24 + 4, so with f64 uniforms (x64, as the JAX tests run)
    ``floor(u * deg)`` reaches deg itself and reads the next row's edge.
    The port converts deg to the uniforms' dtype and clamps the offset to
    deg - 1 (no 16M-entry array needed)."""
    deg = 2 ** 24 + 3
    u = 1.0 - 2.0 ** -40
    jax_off = int(np.floor(np.float64(u) * np.float64(np.float32(deg))))
    assert jax_off == deg                       # the reference's fault
    got = tops.draw_offsets(torch.tensor([u], dtype=torch.float64),
                            torch.tensor([deg]))
    assert got.tolist() == [deg - 1]
    # f32 uniforms on a long row, u = 1 at the boundary, rows of degree 0
    got = tops.draw_offsets(torch.tensor([1.0 - 2.0 ** -24, 1.0, 0.0, 0.5]),
                            torch.tensor([deg, 10, 0, 10]))
    assert got.tolist()[1:] == [9, 0, 5] and got[0] <= deg - 1


# ---- the facade ----------------------------------------------------------

def _adj(seed=0, values=True):
    rowptr, col = _graph(seed=seed)
    row = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr))
    val = np.arange(len(col), dtype=np.float32) * 0.5 if values else None
    T = tsp.SparseTensor(row=torch.from_numpy(row), col=torch.from_numpy(col),
                         value=None if val is None else torch.from_numpy(val),
                         sparse_sizes=(40, 40))
    J = jsp.SparseTensor(row=jnp.asarray(row), col=jnp.asarray(col),
                         value=None if val is None else jnp.asarray(val),
                         sparse_sizes=(40, 40))
    return T, J, rowptr, col


def _same_tensor(T, J):
    assert T.sparse_sizes() == J.sparse_sizes()
    for t, j in zip(T.coo(), J.coo()):
        if t is None or j is None:
            assert t is None and j is None
        else:
            _eq(t, j)


@pytest.mark.parametrize("num,replace", [(-1, False), (2, True), (2, False),
                                         (10, False)])
def test_sample_adj_python_path_equal(num, replace):
    T, J, _, _ = _adj()
    sub = [2, 39, 17, 0, 5]
    t_out, t_nid = tsp.sample_adj(T, torch.tensor(sub), num, replace,
                                  rng=np.random.default_rng(5))
    j_out, j_nid = jsp.sample_adj(J, jnp.asarray(sub), num, replace,
                                  rng=np.random.default_rng(5))
    _same_tensor(t_out, j_out)
    _eq(t_nid, j_nid)


@pytest.mark.parametrize("num,replace", [(-1, False), (3, True), (3, False)])
def test_native_sample_adj_equal(num, replace):
    """One seed: the port's build of the same source gives JAX's bits."""
    _, _, rowptr, col = _adj()
    sub = np.asarray([2, 39, 17, 0, 5, 21])
    for a, b in zip(trt.sample_adj(rowptr, col, sub, num, replace, 1234),
                    jrt.sample_adj(rowptr, col, sub, num, replace, 1234)):
        np.testing.assert_array_equal(a, b)


def test_facade_sample_adj_native_seeded_from_generator():
    """The default path: the native runtime, seeded from the facade's CPU
    generator, the values gathered at ``e_id``; the host CSR is cached."""
    T, _, rowptr, col = _adj()
    sub = torch.tensor([2, 39, 17, 0, 5])
    tsp.seed(9)
    out, n_id = tsp.sample_adj(T, sub, 3)
    tsp.seed(9)
    seed = tsample_mod._seed_from(tsp.random.generator())
    r_ptr, r_col, r_eid, r_nid = trt.sample_adj(rowptr, col, sub.numpy(), 3,
                                                False, seed)
    _eq(out.storage.rowptr(), r_ptr)
    _eq(out.storage.col(), r_col)
    _eq(out.storage.value(), T.storage.value()[torch.from_numpy(r_eid)])
    _eq(n_id, r_nid)
    assert out.sparse_sizes() == (5, len(r_nid))
    assert T.storage.host_csr() is T.storage.host_csr()


def test_sample_equal():
    """``sample`` fed JAX's uniforms gives JAX's draw, a row of degree 0
    included (JAX clamps the read at nnz; the port clamps explicitly)."""
    T, J, _, _ = _adj(values=False)
    key = jax.random.PRNGKey(2)
    sub = [39, 3, 5, 0]
    u = torch.from_numpy(np.array(jax.random.uniform(key, (4, 5))))
    want = jsample(J, 5, jnp.asarray(sub), key)
    got = tops._sample_neighbors(*T.csr()[:2], u, sub)
    _eq(got, want)
    want_all = jsample(J, 2, None, key)
    u_all = torch.from_numpy(np.array(jax.random.uniform(key, (40, 2))))
    _eq(tops._sample_neighbors(*T.csr()[:2], u_all), want_all)


def test_facade_sample_draws_from_the_uniforms(monkeypatch):
    T, J, _, _ = _adj(values=False)
    key = jax.random.PRNGKey(6)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (3, 4))))
    monkeypatch.setattr(tsample_mod, "_uniform", lambda *a: u)
    _eq(tsp.sample(T, 4, [39, 1, 2]), jsample(J, 4, jnp.asarray([39, 1, 2]),
                                              key))


@pytest.mark.parametrize("values", [True, False], ids=["value", "no_value"])
def test_saint_subgraph_equal(values):
    T, J, _, _ = _adj(seed=3, values=values)
    idx = [0, 2, 4, 9, 17, 39, 33]
    t_sub, t_eid = tsp.saint_subgraph(T, torch.tensor(idx))
    j_sub, j_eid = jsp.saint_subgraph(J, jnp.asarray(idx))
    _same_tensor(t_sub, j_sub)
    _eq(t_eid, j_eid)


def test_facade_random_walk_equal_structure():
    T, J, rowptr, col = _adj(seed=4)
    walks = tsp.random_walk(T, torch.arange(40), 4,
                            torch.Generator().manual_seed(1))
    assert walks.shape == (40, 5) and walks.dtype == T.storage.col().dtype
    w = walks.numpy()
    for i in range(40):
        for t in range(4):
            nbrs = col[rowptr[w[i, t]]:rowptr[w[i, t] + 1]].tolist()
            assert w[i, t + 1] in nbrs or (not nbrs and w[i, t + 1] == w[i, t])
