"""The benchmark's generators: seeded, the same sizes for every seed, and
the same graphs as ``chip_smoke.py::bench_graph`` (which fixes the seed at
0), degree sequence and community rule included, but for the clustered
graph's last, partial community, whose draws wrap inside it where
``bench_graph`` clamps them onto the last column."""
import numpy as np
import pytest
import torch

from bench_port import graphs

N, DEG = 2449, 50      # bench_graph at scale 1/1000: 2,449 nodes of degree 50


def _all(kind, seed, n=N, deg=DEG, dim=100):
    gen = graphs.generator(seed, "cpu")
    g = graphs.graph(gen, kind, n, deg)
    x = graphs.features(gen, n, dim)
    y = graphs.labels(gen, n, 47)
    w = graphs.weights(gen, [("w", (100, 256)), ("b", (256,)),
                             ("v", (256, 47))])
    rows = graphs.sample_rows(gen, n, 64)
    return g, x, y, w, rows


def _flat(parts):
    g, x, y, w, rows = parts
    return [g.row, g.col, g.value, x, y, *w.values(), rows]


@pytest.mark.parametrize("kind", graphs.KINDS)
def test_same_seed_same_tensors(kind):
    a, b = _flat(_all(kind, 2**31 + 11)), _flat(_all(kind, 2**31 + 11))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("kind", graphs.KINDS)
def test_other_seed_other_tensors_same_sizes(kind):
    a, b = _flat(_all(kind, 5)), _flat(_all(kind, 6))
    assert [t.shape for t in a] == [t.shape for t in b]
    # rows (and zipf's degrees) are the graph's shape, not the seed's
    assert torch.equal(a[0], b[0])
    for u, v in zip(a[1:], b[1:]):
        if u.dtype.is_floating_point and not u.any():
            continue                  # zero biases
        assert not torch.equal(u, v)


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
def test_seed_zero_is_bench_graph(kind):
    import chip_smoke
    row, col, val, x = chip_smoke.bench_graph("cpu", kind, 1e-3, 100)
    assert (row.numel(), x.shape[0]) == (N * DEG, N)
    gen = graphs.generator(0, "cpu")
    g = graphs.graph(gen, kind, N, DEG)
    assert torch.equal(g.row, row) and torch.equal(g.value, val)
    assert torch.equal(graphs.features(gen, N, 100), x)
    differ = g.col != col
    if kind == "uniform":
        assert not differ.any()
        return
    # only the last block's draws past its end, clamped by bench_graph,
    # wrapped here inside the block
    last = N // 2048 * 2048
    assert differ.any()
    assert bool((col[differ] == N - 1).all())
    assert bool((g.row[differ] >= last).all())
    assert bool((g.col[differ] >= last).all())


def test_zipf_degree_sequence_is_bench_graphs_rule():
    n, deg = 3000, 20
    g = graphs.graph(graphs.generator(9, "cpu"), "zipf", n, deg)
    w = np.random.default_rng(0).zipf(1.5, size=n).astype(np.float64)
    want = np.maximum(1, np.floor(w * (n * deg / w.sum()))).astype(np.int64)
    got = torch.bincount(g.row.long(), minlength=n).numpy()
    assert np.array_equal(got, want)
    assert bool((g.row[1:] >= g.row[:-1]).all())


def test_clustered_community_rule():
    n, deg, c = 8192, 40, 2048
    g = graphs.graph(graphs.generator(3, "cpu"), "clustered", n, deg,
                     community=c, p_in=0.8)
    inside = (g.row // c == g.col // c).double().mean().item()
    # 80% drawn inside, and a quarter of the uniform 20% lands inside too
    assert abs(inside - (0.8 + 0.2 * c / n)) < 0.01
    assert bool((g.row == torch.arange(n * deg) // deg).all())


def test_clustered_last_block_has_no_hub():
    # a last block of 904 nodes: ~32 in-block entries a column (64 where
    # the wrap doubles), where a clamp would pile ~15k onto one column
    n, deg, c = 5000, 40, 2048
    g = graphs.graph(graphs.generator(8, "cpu"), "clustered", n, deg,
                     community=c, p_in=0.8)
    last = n // c * c
    assert bool((g.col >= 0).all()) and bool((g.col < n).all())
    inside = g.row >= last
    assert (g.col[inside] >= last).double().mean().item() > 0.8
    assert torch.bincount(g.col.long(), minlength=n).max().item() < 200


def test_weights_he_normal_and_zero_biases():
    w = graphs.weights(graphs.generator(1, "cpu"),
                       [("a", (400, 300)), ("b", (300,)), ("c", (300, 50))])
    assert not w["b"].any()
    assert abs(w["a"].std().item() - (2 / 400) ** 0.5) < 2e-3
    assert abs(w["c"].std().item() - (2 / 300) ** 0.5) < 4e-3


def test_sample_rows_distinct():
    rows = graphs.sample_rows(graphs.generator(4, "cpu"), 100, 100)
    assert sorted(rows.tolist()) == list(range(100))
