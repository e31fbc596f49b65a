"""GAT as PyG's ogbn-products example stacks it (``models/gcn.py::GAT``
of the program with ``out_heads=heads, bias=True, skip=True``): its
parameters, how the program builds it, and the work of its equations.

A layer of ``H`` heads of ``C`` channels on input ``h`` (``N x d_in``):
``hw = h @ W`` (``W``: ``d_in x H C``, no bias), per head scores ``s_src =
hw . a_src`` and ``s_dst = hw . a_dst``, for each entry ``(i, j)`` the logit
``leaky_relu(s_dst[i] + s_src[j], 0.2)``, its softmax over row ``i``'s
entries ``alpha``, and ``o[i, k] = sum_j alpha[(i, j), k] hw[j, k]``.
Hidden layers ``elu(concat_k o + b + h @ S + s)``, the last ``mean_k o + b
+ h @ S + s`` (the logits). The adjacency's values are unused
(``NORMALIZE`` False: the raw graph).
"""
from typing import List, NamedTuple, Tuple

from bench_port import work

REFERENCE = "gat"
NORMALIZE = False


class Layer(NamedTuple):
    d_in: int
    heads: int
    channels: int
    d_out: int            # concat (hidden) or mean (last) of the heads


def layers(cfg) -> List[Layer]:
    L, H = cfg["num_layers"], cfg["heads"]
    C, out = cfg["hidden_channels"], cfg["out_channels"]
    d = [cfg["in_channels"]] + [H * C] * (L - 1)
    return ([Layer(d[i], H, C, H * C) for i in range(L - 1)]
            + [Layer(d[-1], H, out, out)])


def param_shapes(cfg) -> List[Tuple[str, tuple]]:
    """By layer ``i``: ``weight.i`` (``d_in, H C``); the attention vectors
    ``att_src.i`` and ``att_dst.i`` as ``(C, H)`` matrices, so that
    ``graphs.weights`` draws them with std ``sqrt(2 / C)``, near PyG's
    Glorot for ``(H, C)`` (the program holds them as ``(H, C)``:
    :func:`build` transposes); ``bias.i``; the skip ``skip_weight.i``
    (``d_in, d_out``) and ``skip_bias.i``."""
    out = []
    for i, ly in enumerate(layers(cfg)):
        out += [(f"weight.{i}", (ly.d_in, ly.heads * ly.channels)),
                (f"att_src.{i}", (ly.channels, ly.heads)),
                (f"att_dst.{i}", (ly.channels, ly.heads)),
                (f"bias.{i}", (ly.d_out,)),
                (f"skip_weight.{i}", (ly.d_in, ly.d_out)),
                (f"skip_bias.{i}", (ly.d_out,))]
    return out


def program_state(params) -> dict:
    """``params`` under the program's names: ``att_*.i`` transposed into
    ``a_src.i`` and ``a_dst.i`` (``(H, C)``), the rest as they are."""
    state = {}
    for k, v in params.items():
        if k.startswith("att_"):
            k, v = "a_" + k[len("att_"):], v.t().contiguous()
        state[k] = v
    return state


def build(psp, cfg, params, device):
    """The program's ``GAT`` with PyG's options, holding ``params``."""
    model = psp.GAT(cfg["in_channels"], cfg["hidden_channels"],
                    cfg["out_channels"], heads=cfg["heads"],
                    num_layers=cfg["num_layers"], device=device,
                    out_heads=cfg["heads"], bias=True, skip=True)
    model.load_state_dict(program_state(params))
    return model


def sparse_ops(cfg, train: bool, value_grad: bool) -> List[Tuple[str, int]]:
    """The sparse products of one forward: each layer's ``H`` per-head
    aggregations ``A_alpha @ hw[:, k]`` at ``C`` columns. The edge scores
    and softmax are plain torch (no kernel of the program, counted by no
    roofline). No train step is counted: no cell trains GAT."""
    if train:
        raise NotImplementedError(
            "GAT is benchmarked in inference alone: a full-batch step at "
            "these widths does not fit one card beside its reference")
    return [("spmm", ly.channels) for ly in layers(cfg)
            for _ in range(ly.heads)]


def dense_flops(cfg, n: int, train: bool, value_grad: bool) -> int:
    """Operations of a forward outside the sparse products: per layer the
    GEMMs ``h @ W`` (``2 n d_in H C``) and ``h @ S`` (``2 n d_in d_out``),
    and the score projections ``hw . a_src`` and ``hw . a_dst`` (``2 n H
    C`` each, ``4 n H C`` together). The edge work (logits, softmax) is
    left out: it is counted per entry by no metric."""
    if train:
        raise NotImplementedError(
            "GAT is benchmarked in inference alone (sparse_ops)")
    fl = 0
    for ly in layers(cfg):
        hc = ly.heads * ly.channels
        fl += work.gemm_flops(n, ly.d_in, hc)
        fl += work.gemm_flops(n, ly.d_in, ly.d_out)
        fl += 4 * n * hc
    return fl
