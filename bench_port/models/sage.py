"""GraphSAGE with the mean aggregator (``models/gcn.py::GraphSAGE`` of the
program): its parameters, how the program builds it, and the work of its
equations.

A layer is ``H' = relu(H @ W_self + b_self + mean_N(H) @ W_neigh +
b_neigh)`` on the raw adjacency (no normalization), the mean the row's
value-weighted sum over its entry count.
"""
from typing import List, Tuple

from bench_port import work
# one mean aggregation a layer at its input width; backward ``d h`` through
# the mean above the first layer (with ``d value``: both in one pass),
# ``d value`` alone for the first if asked: GCN's sparse products
from bench_port.models.gcn import dims, sparse_ops  # noqa: F401

REFERENCE = "sage"
NORMALIZE = False


def param_shapes(cfg) -> List[Tuple[str, tuple]]:
    d = dims(cfg)
    out = []
    for part in ("self", "neigh"):
        out += [(f"{part}_weight.{i}", (d[i], d[i + 1]))
                for i in range(len(d) - 1)]
        out += [(f"{part}_bias.{i}", (d[i + 1],)) for i in range(len(d) - 1)]
    return out


def build(psp, cfg, params, device):
    """The program's ``GraphSAGE`` holding ``params``."""
    model = psp.GraphSAGE(cfg["in_channels"], cfg["hidden_channels"],
                          cfg["out_channels"], cfg["num_layers"],
                          device=device)
    model.load_state_dict(params)
    return model


def dense_flops(cfg, n: int, train: bool, value_grad: bool) -> int:
    """GEMM operations: ``h @ W_self`` and ``agg @ W_neigh`` forward;
    backward both ``d W``, ``d h`` through ``W_self`` above the first layer,
    and ``d agg`` through ``W_neigh`` above it or for ``d value``."""
    d = dims(cfg)
    fl = 0
    for i in range(len(d) - 1):
        one = work.gemm_flops(n, d[i], d[i + 1])
        fl += 2 * one
        if train:
            fl += 2 * one
            fl += one if i > 0 else 0
            fl += one if i > 0 or value_grad else 0
    return fl
