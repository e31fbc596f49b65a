"""The windowed CSR SpMM on the card: the rows of a window plan's flagged
tiles of ``out[m] = sum_e value[e] * x[col[e]]`` over ``rowptr[m] <= e <
rowptr[m+1]``, with each tile's window of ``x`` rows staged in shared memory
(``csrc/spmm_window.cu``; the plan: ``row_window.py``).

It is K1, the port of
``paddle_sparse_tpu/ops/kernels/spmm_pallas.py::_reduce_kernel``, over the
flagged tiles' rows: each column sums in f32 in edge order from 0, as the
register walk (:func:`~.spmm_cuda.spmm_csr_cuda`) does, so those rows come
out bit for bit the register walk's. No path of the port calls it: the
card measured it slower than the register walk (``row_window.py``).
"""
from typing import Optional

import torch

from . import _build
from .row_window import BOX_ROWS, WINDOW_ROW_BYTES, RowWindow, applies
from .spmm_cuda import _check_cuda_args, _out_dtype, spmm_csr_reference

# the most shared memory a block may have on sm_90 (227 KB), and the
# kernel's stage beside the window: 8 bytes for each of a block's 1,024
# threads
MAX_SMEM = 232_448
STAGE_BYTES = 8 * 1024


def tile_rows_mask(plan: RowWindow) -> torch.Tensor:
    """(M,) bool: the rows of the plan's flagged tiles."""
    return plan.flagged.repeat_interleave(plan.tile_rows)[:plan.num_rows]


def spmm_window_reference(rowptr: torch.Tensor, col: torch.Tensor,
                          value: Optional[torch.Tensor], x: torch.Tensor,
                          plan: RowWindow) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm_window_cuda`, on any device:
    :func:`~.spmm_cuda.spmm_csr_reference`'s rows of the flagged tiles, the
    other rows 0. It reads ``plan``'s flags, not its windows: a window
    only moves where a row is read from, not what is summed."""
    M = rowptr.numel() - 1
    out = torch.zeros((M, x.shape[1]), dtype=_out_dtype(value, x),
                      device=x.device)
    rows = torch.nonzero(tile_rows_mask(plan)).squeeze(1)
    out[rows] = spmm_csr_reference(rowptr, col, value, x)[rows].to(out.dtype)
    return out


def spmm_window_cuda(rowptr: torch.Tensor, col: torch.Tensor,
                     value: Optional[torch.Tensor], x: torch.Tensor,
                     plan: RowWindow) -> torch.Tensor:
    """The rows of ``plan``'s flagged tiles of the CSR SpMM, through the
    CUDA kernel ``csrc/spmm_window.cu``, in the promoted dtype of ``value``
    and ``x``; the other rows are 0. Arguments as
    :func:`~.spmm_cuda.spmm_csr_cuda`'s; ``plan`` must be the window plan of ``(rowptr, col)`` over ``x``'s rows,
    and must apply to ``x`` (:func:`~.row_window.applies`). On a CPU
    tensor this runs :func:`spmm_window_reference`; on a CUDA tensor it
    launches the kernel or raises. ``spmm_window_cuda.launches`` counts
    kernel launches."""
    if x.device.type == "cpu":
        return spmm_window_reference(rowptr, col, value, x, plan)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_window_cuda runs on cpu or cuda, not "
                         f"{x.device}")
    _check_cuda_args(rowptr, col, value, x)
    M, N, K = rowptr.numel() - 1, x.shape[0], x.shape[1]
    if plan.num_rows != M or plan.num_cols != N:
        raise ValueError(f"window plan of a {plan.num_rows} x "
                         f"{plan.num_cols} matrix for one of {M} x {N}")
    if not applies(plan, x):
        raise ValueError("the window plan flags no tile, or x is not an "
                         "f32/bf16 array of 16-byte aligned rows")
    W = plan.window_rows
    if W % BOX_ROWS or W * WINDOW_ROW_BYTES + STAGE_BYTES > MAX_SMEM - 64:
        raise ValueError(f"window of {W} rows: must be a multiple of "
                         f"{BOX_ROWS} and fit beside the stage in "
                         f"{MAX_SMEM} bytes")
    out = torch.zeros((M, K), dtype=_out_dtype(value, x), device=x.device)
    rowptr = rowptr.to(torch.int32).contiguous()
    col = col.to(torch.int32).contiguous()
    if value is not None:
        value = value.to(torch.float32).contiguous()
    for name in ("tiles", "tile_w0"):
        t = getattr(plan, name)
        if t.device != x.device or t.dtype != torch.int32:
            raise ValueError(f"plan.{name} must be int32 on {x.device}")
    _build.launch("spmm_window", _build.load_library().psp_spmm_window,
                  x.device, rowptr.data_ptr(), col.data_ptr(),
                  None if value is None else value.data_ptr(), x.data_ptr(),
                  out.data_ptr(), plan.tiles.data_ptr(),
                  plan.tile_w0.data_ptr(), plan.tiles.numel(), M, N, K,
                  plan.tile_rows, W, int(x.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16))
    spmm_window_cuda.launches += 1
    return out


spmm_window_cuda.launches = 0
