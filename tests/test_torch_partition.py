"""Port parity: partitioning and RCM against the JAX package on the same
numpy graphs.

* native against native: the port's build of the copied C++ source and the
  JAX package's give the same clusters, ``partition`` outputs and RCM
  permutations;
* numpy against numpy: the port's ``*_reference`` functions against the JAX
  functions with JAX's ``runtime.available`` patched to False (inside each
  test only);
* ``edge_cut_fraction`` / ``random_cut_fraction`` equal; the region grower
  beats a random cut on a structured graph; RCM reduces the bandwidth.

Every comparison is exact (ids, permutations, dense results); the cut
fractions are equal as Python floats."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_sparse_tpu as jsp
import paddle_sparse_tpu_torch as tsp
from paddle_sparse_tpu import runtime as jrt

# each package's ``partition`` function shadows its module of that name
jpart = importlib.import_module("paddle_sparse_tpu.partition")
tpart = importlib.import_module("paddle_sparse_tpu_torch.partition")


def _ring_of_cliques(num_cliques=4, clique=5):
    N = num_cliques * clique
    dense = np.zeros((N, N))
    for c in range(num_cliques):
        s = c * clique
        dense[s:s + clique, s:s + clique] = 1
        t = ((c + 1) % num_cliques) * clique
        dense[s, t] = dense[t, s] = 1
    np.fill_diagonal(dense, 0)
    return dense


def _banded_shuffled(N=40, seed=0):
    rng = np.random.default_rng(seed)
    dense = np.zeros((N, N))
    for i in range(N):
        dense[i, max(0, i - 2):min(N, i + 3)] = 1
    sh = rng.permutation(N)
    return dense[np.ix_(sh, sh)]


def _random_directed(N=60, p=0.06, seed=1):
    rng = np.random.default_rng(seed)
    dense = (rng.random((N, N)) < p).astype(float)
    dense[N - 3:] = 0              # rows without entries
    return dense


GRAPHS = {"cliques": _ring_of_cliques, "banded": _banded_shuffled,
          "directed": _random_directed}


def _pair(dense):
    return (tsp.SparseTensor.from_dense(torch.from_numpy(dense)),
            jsp.SparseTensor.from_dense(jnp.asarray(dense)))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("parts", [1, 3, 4, 7])
def test_native_partition_equal(graph, parts):
    T, J = _pair(GRAPHS[graph]())
    assert jrt.available()
    np.testing.assert_array_equal(tpart.partition_clusters(T, parts),
                                  jpart.partition_clusters(J, parts))
    t_out, t_ptr, t_perm = tsp.partition(T, parts)
    j_out, j_ptr, j_perm = jsp.partition(J, parts)
    np.testing.assert_array_equal(_np(t_perm), _np(j_perm))
    np.testing.assert_array_equal(_np(t_ptr), _np(j_ptr))
    np.testing.assert_array_equal(_np(t_out.to_dense()),
                                  _np(j_out.to_dense()))
    assert t_perm.dtype == T.storage.col().dtype


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("parts", [3, 4])
def test_numpy_partition_equal(graph, parts, monkeypatch):
    T, J = _pair(GRAPHS[graph]())
    monkeypatch.setattr(jrt, "available", lambda: False)
    np.testing.assert_array_equal(
        tpart.partition_clusters_reference(T, parts),
        jpart.partition_clusters(J, parts))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_rcm_equal(graph, monkeypatch):
    T, J = _pair(GRAPHS[graph]())
    np.testing.assert_array_equal(_np(tsp.reverse_cuthill_mckee(T)),
                                  _np(jsp.reverse_cuthill_mckee(J)))
    monkeypatch.setattr(jrt, "available", lambda: False)
    np.testing.assert_array_equal(
        _np(tpart.reverse_cuthill_mckee_reference(T)),
        _np(jsp.reverse_cuthill_mckee(J)))


def test_rcm_reduces_bandwidth():
    T, _ = _pair(_banded_shuffled())
    assert T.bandwidth() > 4
    for fn in (tsp.reverse_cuthill_mckee,
               tpart.reverse_cuthill_mckee_reference):
        perm = fn(T)
        assert sorted(perm.tolist()) == list(range(40))
        assert T.permute(perm).bandwidth() <= 6


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_cut_fractions_equal(graph):
    T, J = _pair(GRAPHS[graph]())
    cl = tpart.partition_clusters(T, 4)
    assert tpart.edge_cut_fraction(T, cl) == jpart.edge_cut_fraction(J, cl)
    assert tpart.edge_cut_fraction(T, torch.from_numpy(cl)) == \
        jpart.edge_cut_fraction(J, cl)
    assert tpart.random_cut_fraction(cl) == jpart.random_cut_fraction(cl)


def test_cut_beats_random_on_cliques():
    T, _ = _pair(_ring_of_cliques())
    cl = tpart.partition_clusters(T, 4)
    assert tpart.edge_cut_fraction(T, cl) < \
        0.5 * tpart.random_cut_fraction(cl)


def test_partition_contract():
    dense = _ring_of_cliques()
    T, _ = _pair(dense)
    out, partptr, perm = T.partition(4)
    p = perm.numpy()
    assert sorted(p.tolist()) == list(range(20))
    assert partptr[0] == 0 and partptr[-1] == 20
    np.testing.assert_array_equal(out.to_dense().numpy(), dense[np.ix_(p, p)])
    with pytest.raises(ValueError, match="square"):
        tsp.partition(tsp.SparseTensor.from_dense(torch.ones(2, 3)), 2)
