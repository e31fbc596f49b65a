"""paddle_sparse_tpu_torch: the PyTorch/CUDA port of paddle_sparse_tpu.

The port holds the GCN train step and SpGEMM: index conversions, the padded
COO core with its cached CSC view, ``sort`` and ``coalesce``; SpMM (sum)
differentiable in ``value`` and ``x`` through two hand-written CUDA kernels for
Hopper (the CSR SpMM for the forward and ``d x``, the CSR SDDMM for
``d value``); the GCN model, its loss and an SGD step; and sparse @ sparse
products on ``PaddedCOO`` (three padded variants, their capacity planners and
an exact eager one), differentiable in the values, whose compress runs
through a third hand-written kernel (run compaction). It imports torch and
never jax.
"""
from .core.matrix import PaddedCOO, padded_coo_from_jax
from .core.spgemm import (SpGEMMResult, matmul_padded, spspmm_padded,
                          spspmm_rowblocked, spspmm_rowsorted)
from .entry import entry, gcn_loss, spgemm_entry, train_entry, train_step
from .models.gcn import GCN, gcn_normalize, gcn_params_from_jax, init_gcn
from .ops.convert import ind2ptr, ptr2ind, ptr2ind_capped
from .ops.kernels.sddmm_cuda import sddmm_csr_cuda, sddmm_csr_reference
from .ops.kernels.segcompact_cuda import (compact_runs, compact_runs_cuda,
                                          compact_runs_reference)
from .ops.kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference
from .ops.spmm import spmm_coo, spmm_csr
from .ops.spspmm import (plan_spgemm, plan_spgemm_blocked, plan_spgemm_rows,
                         spgemm_flops, spspmm_eager)

__all__ = [
    "GCN", "PaddedCOO", "SpGEMMResult", "compact_runs", "compact_runs_cuda",
    "compact_runs_reference", "entry", "gcn_loss", "gcn_normalize",
    "gcn_params_from_jax", "ind2ptr", "init_gcn", "matmul_padded",
    "padded_coo_from_jax", "plan_spgemm", "plan_spgemm_blocked",
    "plan_spgemm_rows", "ptr2ind", "ptr2ind_capped", "sddmm_csr_cuda",
    "sddmm_csr_reference", "spgemm_entry", "spgemm_flops", "spmm_coo",
    "spmm_csr", "spmm_csr_cuda", "spmm_csr_reference", "spspmm_eager",
    "spspmm_padded", "spspmm_rowblocked", "spspmm_rowsorted", "train_entry",
    "train_step",
]
