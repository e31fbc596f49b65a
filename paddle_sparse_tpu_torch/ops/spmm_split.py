"""Local/residual split SpMM (``seg2split``) for community-structured
graphs: ``A @ x`` as the sum of two :func:`~.spmm_seg2.spmm_seg2` calls.

Port of ``paddle_sparse_tpu/ops/spmm_split.py``. Edges are partitioned into
the LOCAL ones (``row // block == col // block``) and the RESIDUAL ones, each
side gets its own seg2 plan, and the two calls share the dense operand, so
``d x`` adds and ``d value`` splits. On the TPU the split keeps one mixed
plan's sub-windows from spanning millions of rows on the sparse tail; the
port keeps it for the API and the packed-value contract.
"""
from typing import NamedTuple, Tuple

import torch

from .spmm_seg2 import (Seg2Plan, Seg2Structure, _check_indices,
                        make_seg2_plan, pack_values, spmm_seg2,
                        unpack_values)


class SplitPlan(NamedTuple):
    local: Seg2Plan
    resid: Seg2Plan
    block: int


class SplitStructure(NamedTuple):
    local: Seg2Structure
    resid: Seg2Structure
    idx_local: torch.Tensor   # (n_local,) COO positions of local edges
    idx_resid: torch.Tensor


def make_split_plan(row, col, num_rows: int, num_cols: int, *,
                    feat_dim: int, block: int = 2048, stream: str = "f32",
                    sr=None) -> Tuple[SplitPlan, SplitStructure]:
    """Partition edges by community block and plan each side with
    :func:`~.spmm_seg2.make_seg2_plan`. ``row`` must be sorted ascending;
    each side inherits it. Raises ``ValueError`` when one side is empty."""
    row, col = _check_indices(row, col, num_rows, num_cols,
                              "make_split_plan")
    local = (row // block) == (col // block)
    idx_local = torch.nonzero(local).squeeze(1).to(torch.int32)
    idx_resid = torch.nonzero(~local).squeeze(1).to(torch.int32)
    if idx_local.numel() == 0 or idx_resid.numel() == 0:
        raise ValueError(
            "split plan needs edges on BOTH sides of the block "
            "partition; use make_seg2_plan directly for one-sided "
            "structures")
    kw = dict(feat_dim=feat_dim, stream=stream, sr=sr)
    plan_l, s_l = make_seg2_plan(row[idx_local], col[idx_local], num_rows,
                                 num_cols, **kw)
    plan_r, s_r = make_seg2_plan(row[idx_resid], col[idx_resid], num_rows,
                                 num_cols, **kw)
    return (SplitPlan(local=plan_l, resid=plan_r, block=block),
            SplitStructure(local=s_l, resid=s_r, idx_local=idx_local,
                           idx_resid=idx_resid))


def pack_values_split(s: SplitStructure, value: torch.Tensor):
    """COO-ordered values -> ``(packed_local, packed_resid)`` leaves."""
    return (pack_values(s.local, value.index_select(0, s.idx_local)),
            pack_values(s.resid, value.index_select(0, s.idx_resid)))


def unpack_values_split(s: SplitStructure, packed) -> torch.Tensor:
    """Inverse of :func:`pack_values_split`."""
    pv_l, pv_r = packed
    out = pv_l.new_zeros(s.idx_local.numel() + s.idx_resid.numel())
    out = out.index_copy(0, s.idx_local.long(), unpack_values(s.local, pv_l))
    return out.index_copy(0, s.idx_resid.long(),
                          unpack_values(s.resid, pv_r))


def spmm_split(plan: SplitPlan, s: SplitStructure, packed_values,
               x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` as local + residual passes; differentiable in
    ``(packed_values, x)``."""
    pv_l, pv_r = (None, None) if packed_values is None else packed_values
    return (spmm_seg2(plan.local, s.local, pv_l, x)
            + spmm_seg2(plan.resid, s.resid, pv_r, x))
