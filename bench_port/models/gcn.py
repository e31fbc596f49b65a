"""GCN (``models/gcn.py::GCN`` of the program): its parameters, how the
program builds it, and the work of its equations.

A layer is ``H' = relu((A_hat @ H) @ W + b)`` on the ``gcn_normalize``-d
adjacency (``NORMALIZE``), so the SpMM runs at the layer's input width.
"""
from typing import List, Tuple

from bench_port import work

REFERENCE = "gcn"
NORMALIZE = True


def dims(cfg) -> List[int]:
    L = cfg["num_layers"]
    return ([cfg["in_channels"]] + [cfg["hidden_channels"]] * (L - 1)
            + [cfg["out_channels"]])


def param_shapes(cfg) -> List[Tuple[str, tuple]]:
    d = dims(cfg)
    return ([(f"weight.{i}", (d[i], d[i + 1])) for i in range(len(d) - 1)]
            + [(f"bias.{i}", (d[i + 1],)) for i in range(len(d) - 1)])


def build(psp, cfg, params, device):
    """The program's ``GCN`` holding ``params``."""
    model = psp.GCN(cfg["in_channels"], cfg["hidden_channels"],
                    cfg["out_channels"], cfg["num_layers"], device=device)
    model.load_state_dict(params)
    return model


def sparse_ops(cfg, train: bool, value_grad: bool) -> List[Tuple[str, int]]:
    """The sparse products of one forward (``train`` False) or one step:
    each layer's ``A_hat @ h``; backward, per layer above the first, ``d h``
    (with ``d value``: both in one pass) and, for the first, ``d value``
    alone if asked (the features need no grad)."""
    d = dims(cfg)
    ops = [("spmm", d[i]) for i in range(len(d) - 1)]
    if train:
        for i in reversed(range(len(d) - 1)):
            if i > 0:
                ops.append(("spmm_sddmm" if value_grad else "spmm_t", d[i]))
            elif value_grad:
                ops.append(("sddmm", d[0]))
    return ops


def dense_flops(cfg, n: int, train: bool, value_grad: bool) -> int:
    """GEMM operations: ``s @ W`` forward; backward ``d W = s^T dz`` and
    ``d s = dz W^T`` where a grad flows below (every layer but the first,
    which needs it only for ``d value``)."""
    d = dims(cfg)
    fl = 0
    for i in range(len(d) - 1):
        one = work.gemm_flops(n, d[i], d[i + 1])
        fl += one
        if train:
            fl += one + (one if i > 0 or value_grad else 0)
    return fl
