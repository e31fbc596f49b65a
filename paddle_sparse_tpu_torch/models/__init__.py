"""GNN models on the PaddedCOO core."""
from .gcn import GCN, gcn_normalize, gcn_params_from_jax, init_gcn

__all__ = ["GCN", "gcn_normalize", "gcn_params_from_jax", "init_gcn"]
