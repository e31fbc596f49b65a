"""paddle_sparse_tpu_torch: the PyTorch/CUDA port of paddle_sparse_tpu.

The port holds the GCN train step, SpGEMM and the packed-layout SpMMs: index
conversions, the padded COO core with its cached CSC view, ``sort`` and
``coalesce``; SpMM (sum) differentiable in ``value`` and ``x`` through two
hand-written CUDA kernels for Hopper (the CSR SpMM for the forward and
``d x``, the CSR SDDMM for ``d value``); the GCN model, its loss and an SGD
step; sparse @ sparse products on ``PaddedCOO`` (three padded variants, their
capacity planners and an exact eager one), differentiable in the values,
whose compress runs through a third hand-written kernel (run compaction); and
the packed (segment, row)-sorted SpMMs ``spmm_seg2``, ``spmm_seg3`` and
``spmm_split``, planned once per graph, whose forward and ``d x`` run a
multi-span SpMM kernel and whose ``d value`` runs its span-SDDMM kernel.
Both span kernels cut rows of more than ``CAP`` edges across warps, from a
piece table (``RowSplit``) that structures and plans build once. It imports
torch and never jax.
"""
from .core.matrix import PaddedCOO, padded_coo_from_jax
from .core.spgemm import (SpGEMMResult, matmul_padded, spspmm_padded,
                          spspmm_rowblocked, spspmm_rowsorted)
from .entry import (SPMM_BACKENDS, entry, gcn_loss, spgemm_entry, spmm_entry,
                    train_entry, train_step)
from .models.gcn import GCN, gcn_normalize, gcn_params_from_jax, init_gcn
from .ops.convert import ind2ptr, ptr2ind, ptr2ind_capped
from .ops.kernels.row_split import (CAP, RowSplit, fold_pieces_cuda,
                                    split_long_rows, split_rows)
from .ops.kernels.sddmm_cuda import (sddmm_csr_cuda, sddmm_csr_reference,
                                     sddmm_spans_cuda, sddmm_spans_reference)
from .ops.kernels.segcompact_cuda import (compact_runs, compact_runs_cuda,
                                          compact_runs_reference)
from .ops.kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference
from .ops.kernels.spmm_spans_cuda import (band_reduce_call, product_dtype,
                                          spmm_spans_cuda,
                                          spmm_spans_reference, tilespan_call)
from .ops.spmm import spmm_coo, spmm_csr
from .ops.spmm_seg2 import (Seg2Plan, Seg2Structure, make_seg2_plan,
                            pack_values, spmm_seg2, unpack_values)
from .ops.spmm_seg3 import (Seg3Infeasible, Seg3Plan, Seg3Structure,
                            make_seg3_plan, spmm_seg3, tilespan_tables)
from .ops.spmm_split import (SplitPlan, SplitStructure, make_split_plan,
                             pack_values_split, spmm_split,
                             unpack_values_split)
from .ops.spspmm import (plan_spgemm, plan_spgemm_blocked, plan_spgemm_rows,
                         spgemm_flops, spspmm_eager)

__all__ = [
    "CAP", "GCN", "PaddedCOO", "RowSplit", "SPMM_BACKENDS", "Seg2Plan",
    "Seg2Structure", "Seg3Infeasible", "Seg3Plan", "Seg3Structure",
    "SpGEMMResult", "SplitPlan", "SplitStructure", "band_reduce_call",
    "compact_runs", "compact_runs_cuda", "compact_runs_reference", "entry",
    "fold_pieces_cuda", "gcn_loss",
    "gcn_normalize", "gcn_params_from_jax", "ind2ptr", "init_gcn",
    "make_seg2_plan", "make_seg3_plan", "make_split_plan", "matmul_padded",
    "pack_values", "pack_values_split", "padded_coo_from_jax", "plan_spgemm",
    "plan_spgemm_blocked", "plan_spgemm_rows", "product_dtype", "ptr2ind",
    "ptr2ind_capped", "sddmm_csr_cuda", "sddmm_csr_reference",
    "sddmm_spans_cuda", "sddmm_spans_reference", "spgemm_entry",
    "spgemm_flops", "spmm_coo", "spmm_csr", "spmm_csr_cuda",
    "spmm_csr_reference", "spmm_entry", "spmm_seg2", "spmm_seg3",
    "spmm_spans_cuda", "spmm_spans_reference", "spmm_split",
    "split_long_rows", "split_rows", "spspmm_eager",
    "spspmm_padded", "spspmm_rowblocked", "spspmm_rowsorted",
    "tilespan_call", "tilespan_tables", "train_entry", "train_step",
    "unpack_values", "unpack_values_split",
]
