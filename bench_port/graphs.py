"""The benchmark's inputs, made on the device from ``--seed``.

The graph generators are copies of ``chip_smoke.py::bench_graph`` (itself
``bench.py``'s ``synthetic_graph``, ``clustered_graph`` and ``zipf_graph``
in torch), kept here so that the yardstick does not move when the smoke
test does. Two changes: the generator is seeded from the run's seed
(``bench_graph`` fixes 0), and a clustered graph's last, partial community
keeps its in-block draws inside itself, where ``bench_graph`` clamps those
past the last node onto column ``N - 1`` (at products' size ~12k entries
on one column, a hub that no reordered graph has). Seed 0 gives
``bench_graph``'s tensors bit for bit but for those clamped entries. Every seed gives the same sizes: row ``r`` of a uniform or
clustered graph holds exactly ``degree`` entries, and a zipf graph's degree
sequence is drawn from a fixed stream (numpy seed 0, as ``bench.py`` does),
so the seed changes which columns and values, never how much work.

``features``, ``labels`` and ``weights`` continue the same generator, so one
seed fixes everything a run feeds both the program and the reference.
"""
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

KINDS = ("uniform", "clustered", "zipf")


class Graph(NamedTuple):
    row: torch.Tensor      # (nnz,) int32, sorted ascending
    col: torch.Tensor      # (nnz,) int32
    value: torch.Tensor    # (nnz,) float32, U(0, 1)
    num_nodes: int


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def graph(gen: torch.Generator, kind: str, num_nodes: int, degree: int,
          community: int = 2048, p_in: float = 0.8,
          zipf_a: float = 1.5) -> Graph:
    """``bench_graph``'s graph of ``kind`` with ``num_nodes`` rows and
    ``num_nodes * degree`` entries (zipf: about as many, degrees ~ Zipf(
    ``zipf_a``) scaled to that total, at least 1 a row). Rows sorted; cols
    uniform, or for ``clustered`` a share ``p_in`` inside the row's
    ``community``-node block (the last block holds what is left of the
    nodes, and a draw past its end wraps inside it); values U(0, 1). Draw order as there: cols,
    the community cols and their coin, values."""
    if kind not in KINDS:
        raise ValueError(f"unknown graph kind {kind!r}; one of {KINDS}")
    dev = gen.device
    n = int(num_nodes)
    if kind == "zipf":
        e = n * int(degree)
        w = np.random.default_rng(0).zipf(zipf_a, size=n).astype(np.float64)
        deg = np.maximum(1, np.floor(w * (e / w.sum()))).astype(np.int64)
        row = torch.arange(n, device=dev, dtype=torch.int32).repeat_interleave(
            torch.as_tensor(deg, device=dev))
    else:
        row = torch.arange(int(degree) * n, device=dev,
                           dtype=torch.int32) // int(degree)
    nnz = row.numel()
    col = torch.randint(0, n, (nnz,), generator=gen, device=dev,
                        dtype=torch.int32)
    if kind == "clustered":
        c = int(community)
        base = row // c * c
        v_in = base + torch.randint(
            0, c, (nnz,), generator=gen, device=dev,
            dtype=torch.int32) % torch.clamp(n - base, max=c)
        col = torch.where(torch.rand(nnz, generator=gen, device=dev) < p_in,
                          v_in, col)
    value = torch.rand(nnz, generator=gen, device=dev)
    return Graph(row, col, value, n)


def features(gen: torch.Generator, num_nodes: int, dim: int) -> torch.Tensor:
    """N(0, 1) node features, float32."""
    return torch.randn(num_nodes, dim, generator=gen, device=gen.device)


def labels(gen: torch.Generator, num_nodes: int,
           classes: int) -> torch.Tensor:
    """Uniform int64 class labels."""
    return torch.randint(0, classes, (num_nodes,), generator=gen,
                         device=gen.device)


def weights(gen: torch.Generator, shapes: Sequence[Tuple[str, tuple]],
            ) -> Dict[str, torch.Tensor]:
    """Float32 parameters by name: every 2-D ``(d_in, d_out)`` weight
    He-normal, std ``sqrt(2 / d_in)`` (the port's and the JAX package's
    ``init_*``), every 1-D bias zero. One normal draw for all weights,
    split in the order of ``shapes``."""
    mats: List[Tuple[str, tuple]] = [(k, s) for k, s in shapes if len(s) == 2]
    total = sum(s[0] * s[1] for _, s in mats)
    draw = torch.randn(total, generator=gen, device=gen.device)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) == 2:
            size = shape[0] * shape[1]
            out[name] = (draw[at:at + size].view(shape)
                         * (2.0 / shape[0]) ** 0.5)
            at += size
        else:
            out[name] = torch.zeros(shape, device=gen.device)
    return out


def sample_rows(gen: torch.Generator, num_nodes: int,
                count: int) -> torch.Tensor:
    """``count`` distinct row ids (int64), drawn from ``gen``."""
    return torch.randperm(num_nodes, generator=gen,
                          device=gen.device)[:count]
