"""paddle_sparse_tpu_torch: the PyTorch/CUDA port of paddle_sparse_tpu.

This slice holds the GCN forward path: index conversions, the padded COO
core, SpMM (sum) with a hand-written CUDA kernel for Hopper, and the GCN
model. It imports torch and never jax.
"""
from .core.matrix import PaddedCOO
from .entry import entry
from .models.gcn import GCN, gcn_normalize, gcn_params_from_jax, init_gcn
from .ops.convert import ind2ptr, ptr2ind, ptr2ind_capped
from .ops.kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference
from .ops.spmm import spmm_coo, spmm_csr

__all__ = [
    "GCN", "PaddedCOO", "entry", "gcn_normalize", "gcn_params_from_jax",
    "ind2ptr", "init_gcn", "ptr2ind", "ptr2ind_capped", "spmm_coo",
    "spmm_csr", "spmm_csr_cuda", "spmm_csr_reference",
]
