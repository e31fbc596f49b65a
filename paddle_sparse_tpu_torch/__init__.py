"""paddle_sparse_tpu_torch: the PyTorch/CUDA port of paddle_sparse_tpu.

The port holds the five GNN families' train steps, SpGEMM and the
packed-layout SpMMs: index conversions and segment reductions, the padded COO
core with its cached CSC view, ``sort`` and ``coalesce``; SpMM (sum and mean
differentiable in ``value`` and ``x`` through two hand-written CUDA kernels
for Hopper, the CSR SpMM for the forward and ``d x`` and the CSR SDDMM for
``d value``; min and max in plain torch); the GCN, GraphSAGE, GIN, GAT (whose
attention weights, node scores and each row's edge softmax, run two
hand-written kernels, ``gat_attention_cuda``; ``edge_softmax`` stays the
plain version's) and APPNP models, a loss and an SGD step; sparse @ sparse
products on ``PaddedCOO`` (three padded variants, their capacity planners and
an exact eager one), differentiable in the values, whose compress runs
through a third hand-written kernel (run compaction); and
the packed (segment, row)-sorted SpMMs ``spmm_seg2``, ``spmm_seg3`` and
``spmm_split``, planned once per graph, whose forward and ``d x`` run a
multi-span SpMM kernel and whose ``d value`` runs its span-SDDMM kernel.
Both span kernels cut rows of more than ``CAP`` edges across warps, from a
piece table (``RowSplit``) that structures and plans build once. The other
SpMM entry points of the JAX package (``spmm_chunked``, ``spmm_seg``,
``spmm_sell`` and ``backend="sell"``) run on the same kernels.

Neighbour sampling (``sample``, ``sample_adj``, ``saint_subgraph``,
``ops.sample``), random walks and partitioning (``partition``,
``reverse_cuthill_mckee``) run in plain torch on the tensor's device, or on
the host through the C++ host runtime (``runtime``, built with g++ at first
use from the package's own copy of the JAX package's source).

The eager facade, ``SparseTensor`` over ``SparseStorage`` (canonical
(row, col)-sorted COO with lazily cached CSR/CSC views), holds the
reference's op suite; each op module binds its methods onto ``SparseTensor``
when this package imports it, as in the JAX package. ``A @ x`` runs the
SpMM kernels on the storage's cached int32 CSR and CSC view, ``A @ B`` the
SpGEMM path. ``sum``, ``mean``, ``min`` and ``max`` are exported as in the
JAX package and shadow the builtins here, so nothing inside the package
imports ``*`` from it. It imports torch and never jax.
"""
from .storage import SparseStorage
from .tensor import SparseTensor

# Import op modules for their side effect of binding SparseTensor methods.
from .narrow import narrow, __narrow_diag__
from .select import select
from .index_select import index_select, index_select_nnz
from .masked_select import masked_select, masked_select_nnz
from .permute import permute
from .add import add, add_, add_nnz, add_nnz_
from .mul import mul, mul_, mul_nnz, mul_nnz_
from .reduce import max, mean, min, reduction, sum  # noqa: A004
from .cat import cat
from .transpose import t, transpose
from .coalesce import coalesce
from .eye import eye
from .convert import (from_paddle_sparse, from_scipy,
                      from_torch_sparse, to_paddle_sparse, to_scipy,
                      to_torch_sparse)
from .diag import fill_diag, get_diag, remove_diag, set_diag
from .matmul import matmul, spmm, spspmm
from .spadd import spadd
from .sample import sample, sample_adj, saint_subgraph
from .rw import random_walk
from .partition import partition, reverse_cuthill_mckee
from .io import from_state_dict, load_npz, save_npz, to_state_dict
from .random import seed

from .core.matrix import (PaddedCOO, padded_coo_from_jax,
                          sparse_tensor_from_jax)
from .core.spgemm import (SpGEMMResult, matmul_padded, spspmm_padded,
                          spspmm_rowblocked, spspmm_rowsorted)
from .entry import (MODELS, SPMM_BACKENDS, dryrun_multichip, entry,
                    facade_entry, gcn_loss, gcn_norm, model_entry,
                    sample_entry, spgemm_entry, spmm_entry, train_entry,
                    train_step)
from .models.gcn import (APPNP, GAT, GCN, GIN, GraphSAGE,
                         appnp_params_from_jax, edge_softmax,
                         gat_attention, gat_attention_reference,
                         gat_params_from_jax, gcn_normalize,
                         gcn_params_from_jax, gin_params_from_jax, init_appnp,
                         init_gat, init_gcn, init_gin, init_sage,
                         sage_params_from_jax)
from .ops.convert import ind2ptr, ptr2ind, ptr2ind_capped
from .ops.kernels.gat_attention_cuda import gat_attention_cuda
from .ops.kernels.row_split import (CAP, RowSplit, fold_pieces_cuda,
                                    split_long_rows, split_rows)
from .ops.kernels.sddmm_cuda import (sddmm_csr_cuda, sddmm_csr_reference,
                                     sddmm_spans_cuda, sddmm_spans_reference)
from .ops.kernels.segcompact_cuda import (compact_runs, compact_runs_cuda,
                                          compact_runs_reference)
from .ops.kernels.spmm_cuda import spmm_csr_cuda, spmm_csr_reference
from .ops.kernels.spmm_sddmm_cuda import (spmm_sddmm_csc_cuda,
                                          spmm_sddmm_csc_reference,
                                          spmm_sddmm_spans_cuda,
                                          spmm_sddmm_spans_reference)
from .ops.kernels.spmm_spans_cuda import (band_reduce_call, product_dtype,
                                          segment_rows_matmul,
                                          spmm_spans_cuda,
                                          spmm_spans_reference, tilespan_call)
from .ops.segment import (REDUCTIONS, bincount, gather_csr, gather_segments,
                          scatter_reduce, segment_csr)
from .ops.sample import (PaddedAdj, sample_adj_padded, sample_neighbors)
from .ops.spmm import (ChunkedStructure, SpmmPlan, make_spmm_plan,
                       spmm_chunked, spmm_coo, spmm_csr)
from .ops.spmm_seg import SegPlan, SegStructure, make_seg_plan, spmm_seg
from .ops.spmm_sell import (SellPlan, SellStructure, make_sell_plan,
                            pad_values, spmm_sell, unpad_values)
from .ops.spmm_seg2 import (Seg2Plan, Seg2Structure, make_seg2_plan,
                            pack_values, spmm_seg2, unpack_values)
from .ops.spmm_seg3 import (Seg3Infeasible, Seg3Plan, Seg3Structure,
                            make_seg3_plan, spmm_seg3, tilespan_tables)
from .ops.spmm_split import (SplitPlan, SplitStructure, make_split_plan,
                             pack_values_split, spmm_split,
                             unpack_values_split)
from .ops.spspmm import (plan_spgemm, plan_spgemm_blocked, plan_spgemm_rows,
                         spgemm_flops, spspmm_eager)
from . import core, ops, parallel, profiling, runtime

__version__ = "0.1.0"

__all__ = [
    # the eager facade and its op suite
    "SparseStorage", "SparseTensor", "narrow", "__narrow_diag__", "select",
    "index_select", "index_select_nnz", "masked_select", "masked_select_nnz",
    "permute", "add", "add_", "add_nnz", "add_nnz_", "mul", "mul_",
    "mul_nnz", "mul_nnz_", "reduction", "sum", "mean", "min", "max", "cat",
    "t", "transpose", "coalesce", "eye", "from_scipy", "to_scipy",
    "from_torch_sparse", "to_torch_sparse", "from_paddle_sparse",
    "to_paddle_sparse", "remove_diag", "set_diag", "fill_diag", "get_diag",
    "matmul", "spmm", "spspmm", "spadd", "sample", "sample_adj",
    "saint_subgraph", "random_walk", "partition", "reverse_cuthill_mckee",
    "load_npz", "save_npz",
    "to_state_dict", "from_state_dict", "seed", "sparse_tensor_from_jax",
    "facade_entry", "gcn_norm", "sample_entry", "__version__",
    # the padded core, kernels, models and entry points
    "APPNP", "CAP", "GAT", "GCN", "GIN", "GraphSAGE", "MODELS", "PaddedCOO",
    "REDUCTIONS", "RowSplit", "SPMM_BACKENDS",
    "ChunkedStructure",
    "PaddedAdj", "SegPlan", "SegStructure", "SellPlan", "SellStructure",
    "SpmmPlan", "Seg2Plan",
    "Seg2Structure", "Seg3Infeasible", "Seg3Plan", "Seg3Structure",
    "SpGEMMResult", "SplitPlan", "SplitStructure", "band_reduce_call",
    "appnp_params_from_jax", "bincount", "compact_runs", "compact_runs_cuda",
    "compact_runs_reference", "dryrun_multichip", "edge_softmax", "entry",
    "fold_pieces_cuda", "gat_attention", "gat_attention_cuda",
    "gat_attention_reference", "gat_params_from_jax", "gather_csr", "gather_segments", "gcn_loss",
    "gcn_normalize", "gcn_params_from_jax", "gin_params_from_jax", "ind2ptr",
    "init_appnp", "init_gat", "init_gcn", "init_gin", "init_sage",
    "make_seg_plan", "make_sell_plan", "make_spmm_plan", "pad_values",
    "sample_adj_padded", "sample_neighbors", "spmm_chunked", "spmm_seg",
    "spmm_sell", "unpad_values", "make_seg2_plan", "make_seg3_plan",
    "make_split_plan", "matmul_padded",
    "model_entry", "pack_values", "pack_values_split", "padded_coo_from_jax",
    "plan_spgemm",
    "plan_spgemm_blocked", "plan_spgemm_rows", "product_dtype", "ptr2ind",
    "ptr2ind_capped", "sage_params_from_jax", "scatter_reduce",
    "sddmm_csr_cuda", "sddmm_csr_reference",
    "sddmm_spans_cuda", "sddmm_spans_reference", "segment_csr",
    "segment_rows_matmul",
    "spgemm_entry",
    "spgemm_flops", "spmm_coo", "spmm_csr", "spmm_csr_cuda",
    "spmm_csr_reference", "spmm_entry", "spmm_sddmm_csc_cuda",
    "spmm_sddmm_csc_reference", "spmm_sddmm_spans_cuda",
    "spmm_sddmm_spans_reference", "spmm_seg2", "spmm_seg3",
    "spmm_spans_cuda", "spmm_spans_reference", "spmm_split",
    "split_long_rows",
    "split_rows", "spspmm_eager",
    "spspmm_padded", "spspmm_rowblocked", "spspmm_rowsorted",
    "tilespan_call", "tilespan_tables", "train_entry", "train_step",
    "unpack_values", "unpack_values_split",
]
