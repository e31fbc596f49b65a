"""Row-sharded packed-layout SpMM (seg2) over ``torch.distributed``.

Port of ``paddle_sparse_tpu/parallel/spmm_seg2.py``: every rank runs the
single-device ``ops/spmm_seg2.py::spmm_seg2`` (the spans kernel forward, the
fused span backward) over its row block, after an all-gather of ``x``
(:func:`spmm_seg2_allgather`) or the deduplicated halo all-to-all
(:func:`spmm_seg2_halo`). Differentiable in ``(packed_value, x)``.

The JAX planner makes one plan serve every shard (``shard_map`` compiles one
program): it ``vmap``s the phase functions, takes the geometry's maximum over
shards and clamps padding columns to ``N - 1``. Processes need none of that:
each shard's plan is ``ops/spmm_seg2.py::make_seg2_plan`` over its real
entries (``rows_per_shard`` rows, the global ``N`` columns), padding dropped.
A shard's packed values are its real entries in the plan's forward order
(JAX's order with the padding left out), then zeros to the common capacity.
"""
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.spmm_seg2 import (Seg2Plan, Seg2Structure, make_seg2_plan,
                             pack_values, spmm_seg2)
from .collectives import all_gather
from .mesh import axis_rank
from .spmm import RowShardedMatrix, halo_exchange


class ShardedSeg2(NamedTuple):
    """One plan and structure per shard (None where not built)."""
    plans: Tuple[Optional[Seg2Plan], ...]
    structures: Tuple[Optional[Seg2Structure], ...]


class Seg2Shard(NamedTuple):
    """One rank's plan and structure, on its device."""
    plan: Seg2Plan
    structure: Seg2Structure


def make_seg2_plan_sharded(mat: RowShardedMatrix, *, feat_dim: int,
                           stream: str = "f32", chunk_edges: int = 512,
                           sr: Optional[int] = None,
                           window_bytes: Optional[int] = None,
                           ranks: Optional[Sequence[int]] = None
                           ) -> ShardedSeg2:
    """Per-shard seg2 plans of stacked row blocks (on their device), for
    the shards in ``ranks`` (default all; a rank need build only its own).
    A shard's real entries are its rows below ``rows_per_shard``, a prefix
    of its sorted block. ``chunk_edges`` and ``window_bytes`` sized the JAX
    package's TPU windows and are accepted for its signature."""
    del chunk_edges, window_bytes            # TPU window geometry
    D = int(mat.row.shape[0])
    rows_per, N = mat.rows_per_shard, mat.shape[1]
    plans, structures = [None] * D, [None] * D
    for d in (range(D) if ranks is None else ranks):
        n = int((mat.row[d] < rows_per).sum())
        plans[d], structures[d] = make_seg2_plan(
            mat.row[d, :n], mat.col[d, :n], rows_per, N, feat_dim=feat_dim,
            stream=stream, sr=sr)
    return ShardedSeg2(tuple(plans), tuple(structures))


def pack_values_sharded(sharded: ShardedSeg2,
                        value: torch.Tensor) -> torch.Tensor:
    """(D, C) per-shard values in COO order -> the forward packed layout:
    shard ``d``'s real entries in its plan's order, then zeros (a shard
    whose plan was not built stays all zeros)."""
    rows = []
    for s, v in zip(sharded.structures, value):
        if s is None:
            rows.append(torch.zeros_like(v))
            continue
        n = s.perm_f.numel()
        rows.append(torch.cat([pack_values(s, v[:n]), v.new_zeros(
            (v.shape[0] - n,))]))
    return torch.stack(rows)


def _to(obj, device):
    """A structure (named tuple of tensors, ints, None and named tuples of
    them) with every tensor on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(v, device) for v in obj))
    return obj


def device_put_sharded_seg2(sharded: ShardedSeg2, rank: int,
                            device=None) -> Seg2Shard:
    """Rank ``rank``'s plan and structure, on ``device``."""
    if sharded.structures[rank] is None:
        raise ValueError(f"no plan was built for rank {rank}")
    return Seg2Shard(sharded.plans[rank],
                     _to(sharded.structures[rank], device))


def _local(shard: Seg2Shard, packed_value, x_full):
    pv = (None if packed_value is None
          else packed_value[:shard.structure.col_f.numel()])
    return spmm_seg2(shard.plan, shard.structure, pv, x_full)


def spmm_seg2_allgather(mesh, shard: Seg2Shard,
                        packed_value: Optional[torch.Tensor],
                        x: torch.Tensor, axis_name: str = "x") -> torch.Tensor:
    """All-gather ``x`` (this rank's (N/D, K) rows), then the single-device
    seg2 path over this rank's block. ``packed_value``: this rank's row of
    :func:`pack_values_sharded`, or None. Returns its (rows_per_shard, K)
    output rows."""
    group, _, _ = axis_rank(mesh, axis_name)
    return _local(shard, packed_value, all_gather(x, group))


def make_seg2_halo_plan(halo_mat, *, feat_dim: int, stream: str = "f32",
                        chunk_edges: int = 512, sr: Optional[int] = None,
                        window_bytes: Optional[int] = None,
                        ranks: Optional[Sequence[int]] = None
                        ) -> ShardedSeg2:
    """Per-shard seg2 plans over a
    :class:`~.spmm.HaloShardedMatrix`'s halo-buffer column space (N = D *
    halo_per_src)."""
    D = int(halo_mat.row.shape[0])
    facade = RowShardedMatrix(
        row=halo_mat.row, col=halo_mat.col, value=halo_mat.value, nnz=None,
        shape=(halo_mat.shape[0], D * halo_mat.halo_per_src),
        rows_per_shard=halo_mat.rows_per_shard)
    return make_seg2_plan_sharded(facade, feat_dim=feat_dim, stream=stream,
                                  chunk_edges=chunk_edges, sr=sr,
                                  window_bytes=window_bytes, ranks=ranks)


def spmm_seg2_halo(mesh, halo_mat, shard: Seg2Shard,
                   packed_value: Optional[torch.Tensor], x: torch.Tensor,
                   axis_name: str = "x") -> torch.Tensor:
    """The deduplicated halo all-to-all (O(unique cols * K) interchange),
    then the single-device seg2 path over the received halo buffer.
    ``halo_mat``: this rank's :class:`~.spmm.HaloShardedMatrix` block (its
    ``send_idx``); ``x``: its (N/D, K) rows. Returns its (rows_per_shard,
    K) output rows."""
    group, _, _ = axis_rank(mesh, axis_name)
    return _local(shard, packed_value,
                  halo_exchange(group, halo_mat.send_idx, x))
