"""Graph neural network families on the PaddedCOO core, differentiable end
to end.

Port of ``paddle_sparse_tpu/models/gcn.py``: ``gcn_normalize``, ``GCN``,
``GraphSAGE`` (mean aggregator), ``GIN``, ``edge_softmax``, ``GAT`` and
``APPNP`` (each model an ``nn.Module`` here), their ``init_*`` (drawing from
an explicit ``torch.Generator``) and one ``*_params_from_jax`` each, which
turns the JAX params pytree into the module's state dict. A layer's weight
keeps the JAX layout, ``(d_in, d_out)``, as a plain ``Parameter`` (not
``nn.Linear``), so a layer is ``h @ w + b`` in both packages and JAX params
load without a transpose.

Every aggregation is ``PaddedCOO.spmm``: the sum (GCN, GIN, APPNP) and the
mean (GraphSAGE) run the SpMM kernel forward and for ``d x`` and the SDDMM
kernel for ``d value`` on a CUDA tensor. GCN and GraphSAGE run each layer's
``A @ h @ W`` at the narrower of ``W``'s widths (:func:`_aggregate`): the
same product as the JAX layer's ``(A @ h) @ W``, its f32 sums in another
order where ``W`` narrows; GAT aggregates each head as an SpMM whose
values are that head's attention weights (``adj.spmm(hw, value=att)``:
one launch a head, each reading its columns of the layer's operand and
writing its columns of the layer's output in place), so the same kernels
carry it. GAT's attention weights (the per-node scores and each row's edge
softmax) run two hand-written kernels on a CUDA tensor
(:func:`gat_attention`), where the reference leaves them to XLA;
:func:`edge_softmax` stays plain torch, and with it the plain version
(:func:`gat_attention_reference`) that the CPU runs.

Under autograd, every parameter gets its gradient (GIN's ``eps`` too), and
so does ``adj.value`` when the caller sets ``requires_grad`` on it (before or
after ``gcn_normalize``), as ``jax.grad`` reaches the values of the JAX
pytree.
"""
from typing import Any, Dict, Iterable, List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.matrix import PaddedCOO
from ..ops.kernels.gat_attention_cuda import (gat_scores_cuda,
                                               gat_softmax_cuda)
from ..ops.segment import (_AddRows, grouped_gather, grouped_max,
                           grouped_sum, take_rows)
from ..profiling import scope


def gcn_normalize(adj: PaddedCOO, add_self_loops: bool = False) -> PaddedCOO:
    """GCN normalization ``D^-1/2 A D^-1/2`` on the padded core.

    As in the JAX version, ``D`` is the row entry count (:meth:`degree`),
    used for both the row and the column scale, with the index clipped to
    ``M - 1``. Self-loops are the caller's to add before padding;
    ``add_self_loops`` only flags that the caller did, as in JAX, and
    changes nothing."""
    deg = adj.degree().to(torch.float32)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg.clamp(min=1.0)),
                           torch.zeros((), device=deg.device))
    value = adj.value
    if value is None:
        value = adj.valid_mask().to(torch.float32)
    row_scale = inv_sqrt[adj.row.long().clamp(0, adj.M - 1)]
    col_scale = inv_sqrt[adj.col.long().clamp(0, adj.M - 1)]
    return adj.with_value(value * row_scale * col_scale)


def _dims(in_dim: int, hidden: int, out_dim: int, num_layers: int
          ) -> List[int]:
    return [in_dim] + [hidden] * (num_layers - 1) + [out_dim]


def _zeros(shapes: Iterable[Tuple[int, ...]], device) -> nn.ParameterList:
    return nn.ParameterList(nn.Parameter(torch.zeros(*s, device=device))
                            for s in shapes)


def _he_normal_(generator: torch.Generator, params: Iterable[nn.Parameter],
                fan_in=None) -> None:
    """Fill each of ``params`` with N(0, 2 / d_in) draws from ``generator``
    on its own device: ``d_in`` is ``fan_in`` or the weight's first dim (the
    JAX ``_dense`` scale)."""
    with torch.no_grad():
        for p in params:
            d_in = fan_in or p.shape[0]
            p.copy_(torch.randn(tuple(p.shape), generator=generator,
                                device=generator.device) * (2.0 / d_in) ** 0.5)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense_state(state: Dict[str, torch.Tensor], weight: str, bias: str,
                 layers) -> None:
    """Write a JAX list of ``{"w", "b"}`` layers into ``state`` as
    ``weight.i`` / ``bias.i``."""
    for i, layer in enumerate(layers):
        state[f"{weight}.{i}"] = _t(layer["w"])
        state[f"{bias}.{i}"] = _t(layer["b"])


def _transform_first(w: torch.Tensor) -> bool:
    """Whether a layer of weight ``w`` (``(d_in, d_out)``) multiplies by
    ``w`` before it aggregates: where ``w`` narrows, so that the SpMM
    gathers ``d_out`` columns. Ties aggregate first."""
    d_in, d_out = w.shape
    return d_out < d_in


def _aggregate(adj, h: torch.Tensor, w: torch.Tensor, **reduce
               ) -> torch.Tensor:
    """``adj.spmm(h, **reduce) @ w``, the SpMM at the narrower of ``w``'s
    widths: as ``adj.spmm(h @ w)`` inside the span
    ``psp.model.transform_first`` where :func:`_transform_first`, else
    aggregating first. The SpMM is linear in its dense operand, the mean's
    divide included, so both orders give the same product; the GEMM's
    shape is the same either way."""
    if _transform_first(w):
        with scope("psp.model.transform_first"):
            return adj.spmm(h @ w, **reduce)
    return adj.spmm(h, **reduce) @ w


# ---- GCN -------------------------------------------------------------------

class GCN(nn.Module):
    """Kipf-Welling GCN: ``H' = relu(A_norm @ H @ W + b)`` stacked, no relu
    after the last layer, ``A_norm @ H @ W`` at the narrower of ``W``'s
    widths (:func:`_aggregate`). ``weight[i]`` is ``(d_in, d_out)``."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, device=None):
        super().__init__()
        dims = _dims(in_dim, hidden, out_dim, num_layers)
        self.weight = _zeros(zip(dims[:-1], dims[1:]), device)
        self.bias = _zeros(((d,) for d in dims[1:]), device)

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.weight)
        for i, (w, b) in enumerate(zip(self.weight, self.bias)):
            h = _aggregate(adj, h, w) + b
            if i < n - 1:
                h = torch.relu(h)
        return h


def init_gcn(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, num_layers: int = 2, device=None) -> GCN:
    """A GCN with He-normal weights (std ``sqrt(2 / d_in)``, as the JAX
    ``_dense``) drawn from ``generator`` on its own device, and zero biases.
    The numbers differ from JAX's for the same seed."""
    model = GCN(in_dim, hidden, out_dim, num_layers, device=device)
    _he_normal_(generator, model.weight)
    return model


def gcn_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``init_gcn`` params (``{"layers": [{"w", "b"}, ...]}``, arrays
    convertible with ``np.asarray``) -> a ``GCN`` state dict, for
    ``model.load_state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    _dense_state(state, "weight", "bias", params["layers"])
    return state


# ---- GraphSAGE (mean aggregator) -------------------------------------------

class GraphSAGE(nn.Module):
    """GraphSAGE with the mean aggregator: ``H' = relu(H @ W_self + b_self +
    mean_neighbours(H) @ W_neigh + b_neigh)`` stacked, no relu after the
    last layer; the mean is ``adj.spmm(h, reduce="mean")`` (the row sum over
    the row's entry count), ``mean_neighbours(H) @ W_neigh`` at the narrower
    of ``W_neigh``'s widths (:func:`_aggregate`)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, device=None):
        super().__init__()
        dims = _dims(in_dim, hidden, out_dim, num_layers)
        self.self_weight = _zeros(zip(dims[:-1], dims[1:]), device)
        self.self_bias = _zeros(((d,) for d in dims[1:]), device)
        self.neigh_weight = _zeros(zip(dims[:-1], dims[1:]), device)
        self.neigh_bias = _zeros(((d,) for d in dims[1:]), device)

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.self_weight)
        for i in range(n):
            agg = _aggregate(adj, h, self.neigh_weight[i], reduce="mean")
            h = (h @ self.self_weight[i] + self.self_bias[i] + agg
                 + self.neigh_bias[i])
            if i < n - 1:
                h = torch.relu(h)
        return h


def init_sage(generator: torch.Generator, in_dim: int, hidden: int,
              out_dim: int, num_layers: int = 2, device=None) -> GraphSAGE:
    """A GraphSAGE with He-normal weights from ``generator`` and zero biases
    (as :func:`init_gcn`)."""
    model = GraphSAGE(in_dim, hidden, out_dim, num_layers, device=device)
    _he_normal_(generator, [*model.self_weight, *model.neigh_weight])
    return model


def sage_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``init_sage`` params (``{"self": [...], "neigh": [...]}``) -> a
    ``GraphSAGE`` state dict."""
    state: Dict[str, torch.Tensor] = {}
    _dense_state(state, "self_weight", "self_bias", params["self"])
    _dense_state(state, "neigh_weight", "neigh_bias", params["neigh"])
    return state


# ---- GIN -------------------------------------------------------------------

class GIN(nn.Module):
    """Graph isomorphism network: ``H' = MLP((1 + eps) * H + A @ H)``, the
    MLP ``relu(. @ W1 + b1) @ W2 + b2``, stacked with a relu between layers;
    ``eps`` (one per layer) is trained."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, device=None):
        super().__init__()
        dims = _dims(in_dim, hidden, out_dim, num_layers)
        self.mlp1_weight = _zeros(zip(dims[:-1], dims[1:]), device)
        self.mlp1_bias = _zeros(((d,) for d in dims[1:]), device)
        self.mlp2_weight = _zeros(((d, d) for d in dims[1:]), device)
        self.mlp2_bias = _zeros(((d,) for d in dims[1:]), device)
        self.eps = nn.Parameter(torch.zeros(num_layers, device=device))

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.mlp1_weight)
        for i in range(n):
            agg = adj.spmm(h)
            h = (1.0 + self.eps[i]) * h + agg
            h = torch.relu(h @ self.mlp1_weight[i] + self.mlp1_bias[i])
            h = h @ self.mlp2_weight[i] + self.mlp2_bias[i]
            if i < n - 1:
                h = torch.relu(h)
        return h


def init_gin(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, num_layers: int = 2, device=None) -> GIN:
    """A GIN with He-normal MLP weights from ``generator``, zero biases and
    ``eps = 0``, as the JAX ``init_gin``."""
    model = GIN(in_dim, hidden, out_dim, num_layers, device=device)
    _he_normal_(generator, [*model.mlp1_weight, *model.mlp2_weight])
    return model


def gin_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``init_gin`` params (``{"mlp1", "mlp2", "eps"}``) -> a ``GIN``
    state dict."""
    state: Dict[str, torch.Tensor] = {"eps": _t(params["eps"])}
    _dense_state(state, "mlp1_weight", "mlp1_bias", params["mlp1"])
    _dense_state(state, "mlp2_weight", "mlp2_bias", params["mlp2"])
    return state


# ---- GAT (graph attention) -------------------------------------------------

def edge_softmax(adj: PaddedCOO, logits: torch.Tensor) -> torch.Tensor:
    """Per-destination-row softmax over edge ``logits`` of shape
    ``(capacity,)`` or ``(capacity, H)``, as the JAX ``edge_softmax``:
    padding rows clipped to ``M - 1`` and their logits masked to ``-1e30``
    (weight 0), the row max subtracted (a non-finite max, an empty row's,
    taken as 0), and the denominator floored at ``1e-16``. Plain torch: the
    row max, the row sum and the per-edge gathers of both go through
    ``adj.row_groups()`` (``ops/segment.py``), so that a hub row's edges
    never pile on one address: straight ``scatter_reduce``, ``index_add``
    and ``t[row]`` serialized a row of 10M edges on the card, and the
    backward of ``t[row]`` alone took seconds per GAT step. Runs inside
    the span ``psp.model.edge_softmax``."""
    with scope("psp.model.edge_softmax"):
        groups = adj.row_groups()
        vmask = adj.valid_mask().reshape((-1,) + (1,) * (logits.dim() - 1))
        masked = torch.where(vmask, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
        # the max only shifts each row's logits, which the softmax does not
        # see: its gradient is 0 in exact arithmetic (PyG's softmax detaches
        # it too), and skipping it skips two E-sized gathers per call
        row_max = grouped_max(masked.detach(), groups)
        row_max = torch.where(torch.isfinite(row_max), row_max,
                              torch.zeros((), dtype=row_max.dtype,
                                          device=row_max.device))
        e = torch.where(vmask,
                        torch.exp(masked - grouped_gather(row_max, groups)),
                        torch.zeros((), dtype=masked.dtype,
                                    device=masked.device))
        denom = grouped_sum(e, groups)
        return e / grouped_gather(denom, groups).clamp(min=1e-16)


def gat_attention_reference(adj: PaddedCOO, hw: torch.Tensor,
                            a_src: torch.Tensor, a_dst: torch.Tensor,
                            negative_slope: float = 0.2):
    """Plain version of :func:`gat_attention`, on any device and
    differentiable: ``(att, s_dst, s_src)``, the ``(E, H)`` attention
    weights of one GAT layer and the ``(N, H)`` node scores of ``hw``
    (``(N, H, D)``). The scores and the edge logits ``leaky_relu(s_dst[row]
    + s_src[col])`` (through the row groups, inside the span
    ``psp.model.gat.scores``), then :func:`edge_softmax`: the JAX layer's
    arithmetic in plain torch."""
    with scope("psp.model.gat.scores"):
        s_dst = (hw * a_dst).sum(-1)                    # (N, H)
        s_src = (hw * a_src).sum(-1)
        col = adj.col.long().clamp(0, adj.N - 1)
        logits = F.leaky_relu(grouped_gather(s_dst, adj.row_groups())
                              + take_rows(s_src, col), negative_slope)
    return edge_softmax(adj, logits), s_dst, s_src


class _GatAttention(torch.autograd.Function):
    """One GAT layer's attention weights from ``hw``, ``a_src`` and
    ``a_dst``: on a CUDA tensor the node-score kernel inside the span
    ``psp.model.gat.scores`` and the edge pass inside
    ``psp.model.edge_softmax`` (``ops/kernels/gat_attention_cuda.py``),
    else :func:`gat_attention_reference` computed without grad. The backward is
    plain torch over the grouped row ops, and differentiable (each op in it
    is), so a double backward goes through it:

    ``t = att * g``; ``d logit = t - att * sum_row(t)``, times the slope
    where the pre-activation ``s_dst[row] + s_src[col]`` is not above 0
    (``leaky_relu``'s backward); ``d s_dst = sum_row(d logit)``, ``d s_src
    = sum over col(d logit)``; then ``d hw = d s_dst a_dst + d s_src a_src``
    and ``d a = sum_n hw d s``."""

    @staticmethod
    def forward(ctx, hw, a_src, a_dst, adj, negative_slope):
        if hw.device.type == "cuda":
            rowptr, split = adj.rowptr(), adj.row_split()
            with scope("psp.model.gat.scores"):
                s_dst, s_src = gat_scores_cuda(hw, a_src, a_dst)
            with scope("psp.model.edge_softmax"):
                att = gat_softmax_cuda(rowptr, adj.col, s_dst, s_src,
                                       negative_slope, split)
        else:
            att, s_dst, s_src = gat_attention_reference(
                adj, hw, a_src, a_dst, negative_slope)
        ctx.save_for_backward(hw, a_src, a_dst, att)
        ctx.adj, ctx.slope, ctx.scores = adj, negative_slope, (s_dst, s_src)
        return att

    @staticmethod
    def backward(ctx, g):
        hw, a_src, a_dst, att = ctx.saved_tensors
        adj, (s_dst, s_src) = ctx.adj, ctx.scores
        groups = adj.row_groups()
        col = adj.col.long().clamp(0, adj.N - 1)
        t = att * g
        d_logit = t - att * grouped_gather(grouped_sum(t, groups), groups)
        pre = grouped_gather(s_dst, groups) + take_rows(s_src, col)
        d_logit = torch.where(pre > 0, d_logit, d_logit * ctx.slope)
        d_dst = grouped_sum(d_logit, groups)[..., None]          # (N, H, 1)
        d_src = _AddRows.apply(d_logit, col, adj.N)[..., None]
        d_hw = d_a_src = d_a_dst = None
        if ctx.needs_input_grad[0]:
            d_hw = d_dst * a_dst + d_src * a_src
        if ctx.needs_input_grad[1]:
            d_a_src = (hw * d_src).sum(0)
        if ctx.needs_input_grad[2]:
            d_a_dst = (hw * d_dst).sum(0)
        return d_hw, d_a_src, d_a_dst, None, None


def gat_attention(adj: PaddedCOO, hw: torch.Tensor, a_src: torch.Tensor,
                  a_dst: torch.Tensor, negative_slope: float = 0.2
                  ) -> torch.Tensor:
    """The ``(E, H)`` attention weights of one GAT layer: per head the
    softmax over each row's entries of ``leaky_relu(hw[row] . a_dst +
    hw[col] . a_src)``, 0 at padding (``hw``: ``(N, H, D)``, the adjacency
    square). On the card two hand-written kernels, the scores inside the
    span ``psp.model.gat.scores`` and the softmax inside
    ``psp.model.edge_softmax``, the weights the view of a head-major
    buffer (``att[:, k]`` contiguous); on the CPU
    :func:`gat_attention_reference`. Differentiable in ``hw``, ``a_src``
    and ``a_dst``."""
    # the scores of hw's N rows are gathered by row and by col alike
    if adj.M != adj.N:
        raise ValueError(f"gat_attention requires a square adjacency, got "
                         f"{tuple(adj.shape)}")
    return _GatAttention.apply(hw, a_src, a_dst, adj, negative_slope)


class GAT(nn.Module):
    """Velickovic-style graph attention network.

    Per layer and head: ``hw = h @ W`` split into heads, edge logits
    ``leaky_relu(a_dst . hw[row] + a_src . hw[col])`` (span
    ``psp.model.gat.scores``) and their softmax over each row (span
    ``psp.model.edge_softmax``), both :func:`gat_attention`, and the heads
    aggregated by ``adj.spmm(hw, value=att)`` (span
    ``psp.model.gat.heads``, with the heads' mean on the output layer):
    one K1 a head, which reads the head's columns of ``hw`` and writes its
    columns of the layer's one output in place, with no ``with_value``
    copy, and the adjacency's cached CSC view, built once per graph, in
    the backward. The same function as the JAX per-head ``segment_sum``
    of ``(E, H, D)`` messages, without the messages. Heads are
    concatenated on hidden layers (the output as it is, (M, H * D)) and
    averaged on the output layer, then ``elu`` on hidden layers. The
    adjacency must be square.

    The defaults are the JAX package's layer: one output head, no bias, no
    skip. PyG's ``GATConv`` as its ogbn-products example stacks it
    (``examples/ogbn_products_gat.py``) is ``out_heads=heads, bias=True,
    skip=True``: ``out_heads`` heads averaged on the output layer; ``bias``
    a bias per layer (``bias[i]``, the layer's output width), added after
    the concat or mean; ``skip`` a linear map of the layer's input
    (``skip_weight[i]``, ``(d_in, d_out)``, and ``skip_bias[i]``) added
    before ``elu``."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 heads: int = 4, num_layers: int = 2,
                 negative_slope: float = 0.2, device=None,
                 out_heads: int = 1, bias: bool = False,
                 skip: bool = False):
        super().__init__()
        self.negative_slope = negative_slope
        dims = [in_dim] + [hidden * heads] * (num_layers - 1) + [out_dim]
        hd = [(heads, hidden)] * (num_layers - 1) + [(out_heads, out_dim)]
        self.weight = _zeros(((d, h * o) for d, (h, o) in zip(dims, hd)),
                             device)
        self.a_src = _zeros(hd, device)
        self.a_dst = _zeros(hd, device)
        self.bias = _zeros(((d,) for d in dims[1:]), device) if bias \
            else None
        self.skip_weight = _zeros(zip(dims[:-1], dims[1:]), device) if skip \
            else None
        self.skip_bias = _zeros(((d,) for d in dims[1:]), device) if skip \
            else None

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        # after the first layer hw has adj.M rows but is gathered by col
        # (range adj.N): a rectangular adjacency would read wrong rows
        if adj.M != adj.N:
            raise ValueError(f"GAT requires a square adjacency, got "
                             f"{tuple(adj.shape)}")
        h = x
        n = len(self.weight)
        for i, (w, a_src, a_dst) in enumerate(zip(self.weight, self.a_src,
                                                  self.a_dst)):
            H, D = a_src.shape
            hw = h @ w                                      # (N, H * D)
            att = gat_attention(adj, hw.view(-1, H, D), a_src, a_dst,
                                self.negative_slope)
            with scope("psp.model.gat.heads"):
                # head k: columns k * D .. of hw with att[:, k], which is 0
                # at padding already, written in place: (M, H * D)
                out = adj.spmm(hw, value=att)
                if i == n - 1:
                    out = out.view(-1, H, D).mean(1)
            del att, hw       # freed before the skip's GEMM under no_grad
            if self.bias is not None:
                out = out + self.bias[i]
            if self.skip_weight is not None:
                out = out + (h @ self.skip_weight[i] + self.skip_bias[i])
            h = F.elu(out) if i < n - 1 else out
        return h


def init_gat(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, heads: int = 4, num_layers: int = 2,
             device=None, out_heads: int = 1, bias: bool = False,
             skip: bool = False) -> GAT:
    """A GAT whose weights and attention vectors are N(0, 2 / d_in) draws
    from ``generator``, ``d_in`` the layer's input width, as the JAX
    ``init_gat``; with ``skip``, the skip weights drawn after those the
    same way, and every bias zero."""
    model = GAT(in_dim, hidden, out_dim, heads, num_layers, device=device,
                out_heads=out_heads, bias=bias, skip=skip)
    for w, a_src, a_dst in zip(model.weight, model.a_src, model.a_dst):
        _he_normal_(generator, (w, a_src, a_dst), fan_in=w.shape[0])
    if skip:
        _he_normal_(generator, model.skip_weight)
    return model


def gat_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``init_gat`` params (``{"layers": [{"w", "a_src", "a_dst"}]}``)
    -> a ``GAT`` state dict."""
    state: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["layers"]):
        for name, key in (("weight", "w"), ("a_src", "a_src"),
                          ("a_dst", "a_dst")):
            state[f"{name}.{i}"] = _t(layer[key])
    return state


# ---- APPNP (predict, then propagate) ---------------------------------------

class APPNP(nn.Module):
    """APPNP: ``h = relu(x @ W1 + b1) @ W2 + b2``, then ``k`` steps of
    personalized-PageRank propagation ``z = (1 - alpha) * A @ z + alpha *
    h`` from ``z = h`` (the JAX ``lax.scan``, here a loop of ``k`` SpMMs)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, k: int = 10,
                 alpha: float = 0.1, device=None):
        super().__init__()
        self.k, self.alpha = k, alpha
        self.weight = _zeros([(in_dim, hidden), (hidden, out_dim)], device)
        self.bias = _zeros([(hidden,), (out_dim,)], device)

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.weight[0] + self.bias[0])
        h = h @ self.weight[1] + self.bias[1]
        z = h
        for _ in range(self.k):
            z = (1 - self.alpha) * adj.spmm(z) + self.alpha * h
        return z


def init_appnp(generator: torch.Generator, in_dim: int, hidden: int,
               out_dim: int, k: int = 10, alpha: float = 0.1,
               device=None) -> APPNP:
    """An APPNP with He-normal weights from ``generator`` and zero biases."""
    model = APPNP(in_dim, hidden, out_dim, k, alpha, device=device)
    _he_normal_(generator, model.weight)
    return model


def appnp_params_from_jax(params: Dict[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``init_appnp`` params (``{"lin1", "lin2"}``) -> an ``APPNP``
    state dict."""
    state: Dict[str, torch.Tensor] = {}
    _dense_state(state, "weight", "bias", [params["lin1"], params["lin2"]])
    return state
