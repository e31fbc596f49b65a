"""paddle_sparse_tpu_torch: the PyTorch/CUDA port of paddle_sparse_tpu.

This slice holds the GCN train step: index conversions, the padded COO core
with its cached CSC view, SpMM (sum) differentiable in ``value`` and ``x``
through two hand-written CUDA kernels for Hopper (the CSR SpMM for the
forward and ``d x``, the CSR SDDMM for ``d value``), the GCN model, its loss
and an SGD step. It imports torch and never jax.
"""
from .core.matrix import PaddedCOO
from .entry import entry, gcn_loss, train_entry, train_step
from .models.gcn import GCN, gcn_normalize, gcn_params_from_jax, init_gcn
from .ops.convert import ind2ptr, ptr2ind, ptr2ind_capped
from .ops.kernels.sddmm_cuda import sddmm_csr_cuda, sddmm_csr_reference
from .ops.kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference
from .ops.spmm import spmm_coo, spmm_csr

__all__ = [
    "GCN", "PaddedCOO", "entry", "gcn_loss", "gcn_normalize",
    "gcn_params_from_jax", "ind2ptr", "init_gcn", "ptr2ind", "ptr2ind_capped",
    "sddmm_csr_cuda", "sddmm_csr_reference", "spmm_coo", "spmm_csr",
    "spmm_csr_cuda", "spmm_csr_reference", "train_entry", "train_step",
]
