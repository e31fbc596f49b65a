"""GNN models on the PaddedCOO core: GCN, GraphSAGE, GIN, GAT, APPNP."""
from .gcn import (APPNP, GAT, GCN, GIN, GraphSAGE, appnp_params_from_jax,
                  edge_softmax, gat_attention, gat_attention_reference,
                  gat_params_from_jax, gcn_normalize,
                  gcn_params_from_jax, gin_params_from_jax, init_appnp,
                  init_gat, init_gcn, init_gin, init_sage,
                  sage_params_from_jax)

__all__ = ["APPNP", "GAT", "GCN", "GIN", "GraphSAGE", "appnp_params_from_jax",
           "edge_softmax", "gat_attention", "gat_attention_reference",
           "gat_params_from_jax", "gcn_normalize",
           "gcn_params_from_jax", "gin_params_from_jax", "init_appnp",
           "init_gat", "init_gcn", "init_gin", "init_sage",
           "sage_params_from_jax"]
