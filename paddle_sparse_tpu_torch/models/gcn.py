"""GCN on the PaddedCOO core, differentiable end to end.

Port of ``paddle_sparse_tpu/models/gcn.py``: ``gcn_normalize``, ``GCN`` (an
``nn.Module`` here) and ``init_gcn``. A layer's weight keeps the JAX layout,
``(d_in, d_out)``, as a plain ``Parameter`` (not ``nn.Linear``), so a layer is
``h @ w + b`` in both packages and JAX params load without a transpose.

Under autograd, every weight and bias gets its gradient, and so does
``adj.value`` when the caller sets ``requires_grad`` on it (before or after
``gcn_normalize``), as ``jax.grad`` reaches the values of the JAX pytree.
"""
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..core.matrix import PaddedCOO


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


class GCN(nn.Module):
    """Kipf-Welling GCN: ``H' = relu(A_norm @ H @ W + b)`` stacked, no relu
    after the last layer. ``weight[i]`` is ``(d_in, d_out)``."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int = 2, device=None):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.weight = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i], dims[i + 1], device=device))
            for i in range(num_layers))
        self.bias = nn.ParameterList(
            nn.Parameter(torch.zeros(dims[i + 1], device=device))
            for i in range(num_layers))

    def forward(self, adj: PaddedCOO, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.weight)
        for i, (w, b) in enumerate(zip(self.weight, self.bias)):
            h = adj.spmm(h)
            h = h @ w + b
            if i < n - 1:
                h = torch.relu(h)
        return h


def init_gcn(generator: torch.Generator, in_dim: int, hidden: int,
             out_dim: int, num_layers: int = 2, device=None) -> GCN:
    """A GCN with He-normal weights (std ``sqrt(2 / d_in)``, as the JAX
    ``_dense``) drawn from ``generator`` on its own device, and zero biases.
    The numbers differ from JAX's for the same seed."""
    model = GCN(in_dim, hidden, out_dim, num_layers, device=device)
    with torch.no_grad():
        for w in model.weight:
            d_in, d_out = w.shape
            w.copy_(torch.randn(d_in, d_out, generator=generator,
                                device=generator.device)
                    * (2.0 / d_in) ** 0.5)
    return model


def gcn_params_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``init_gcn`` params (``{"layers": [{"w", "b"}, ...]}``, arrays
    convertible with ``np.asarray``) -> a ``GCN`` state dict, for
    ``model.load_state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["layers"]):
        state[f"weight.{i}"] = torch.from_numpy(
            np.array(layer["w"], dtype=np.float32))
        state[f"bias.{i}"] = torch.from_numpy(
            np.array(layer["b"], dtype=np.float32))
    return state
