"""Padded-group (SELL) SpMM: ``A @ x`` (sum) with the values held in a padded
slot grid, differentiable in the grid (or COO values) and ``x``.

Port of ``paddle_sparse_tpu/ops/spmm_sell.py``. The plan pads every row's
edge list to a multiple of ``G`` slots and stores the slot grid transposed as
``(G, groups)``: slot ``(i, g)`` holds padded-stream position ``g * G + i``.
The values live in the same grid (:func:`pad_values` converts COO values
once; training keeps the grid as the differentiated leaf), so the grid
layout is what users hold: its slot order (``eid``) is the JAX package's.
The JAX structure's other arrays (the column grid, group pointers, the
transpose's grid and maps) serve only the TPU's reduce; the plan does not
keep them, and :func:`jax_arrays` builds all ten on demand to compare them
array for array. Pad slots carry column ``N``, as in the JAX package.

What runs on the card is not the TPU's two-level reduce: the real slots'
values are gathered out of the grid into COO order (one gather of nnz
values, whose backward scatters ``d value`` back into the grid, 0 at pads),
and the SpMM runs on the kernels of ``ops/spmm.py``: K1 over the CSR
forward, K1 over the plan's CSC view for ``d x``, K2 for ``d value``. No pad
slot's column reaches a gather, and ``x`` is never padded with a zero row.
The port's structure holds the slot of each COO edge (``slot``, the inverse
of ``eid`` in the grid's flat order) and the kernels' :class:`~.spmm.
SpmmStructure` (CSR pointer, CSC view, piece tables).

The transpose is built over the real entries only: padding (``row >=
num_rows``) sorts last whatever its column holds. The JAX plan sorts
padding by its raw column, so a padding entry with a column below N
becomes a slot of A^T there, reading the grid's slot 0 into ``d x``; with
``PaddedCOO``'s padding (column N) :func:`jax_arrays` gives the same
arrays.

``group="auto"`` picks ``G`` as the JAX package does per platform: 8 for
tensors on the CPU (JAX's CPU choice), :func:`_pick_group` for tensors on
the card. The JAX plan's row-block sizes, level-2 backend and ``interpret``
are TPU scheduling and are not kept.
"""
from typing import NamedTuple, Optional

import torch

from .convert import ind2ptr
from .spmm import SpmmStructure, spmm_structure, spmm_with_structure
from .spmm_seg2 import _check_indices


class SellStructure(NamedTuple):
    """The padded-group index structure, int32 tensors on the plan's device.
    The grid is ``(G, ng)`` with ``ng = eid.numel() // G``."""
    eid: torch.Tensor      # (ng * G,) edge id per padded slot, -1 = pad
    row: torch.Tensor      # (nnz,) sorted COO rows
    col: torch.Tensor      # (nnz,) COO cols
    slot: torch.Tensor     # (nnz,) flat grid index (i * ng + g) of each edge
    csr: SpmmStructure     # the kernels' CSR pointer, CSC view, pieces


class SellPlan(NamedTuple):
    """Static geometry for :func:`spmm_sell`."""
    num_rows: int
    num_cols: int
    group: int


def _geometry(row, num_rows: int, group: int):
    """``(rowptr, gptr)`` of one orientation: its CSR pointer and the
    pointer in group units."""
    rowptr = ind2ptr(row, num_rows).to(torch.int32)
    deg = rowptr[1:] - rowptr[:-1]
    gptr = torch.zeros(num_rows + 1, dtype=torch.int32, device=row.device)
    torch.cumsum(-(-deg // group), 0, out=gptr[1:])
    return rowptr, gptr


def _slots(rowptr, gptr, ngroups: int, group: int, num_rows: int):
    """``(eid, grow)``: the padded slots' edge ids in stream order (-1 on
    pads) and each group's row."""
    dev = rowptr.device
    deg = rowptr[1:] - rowptr[:-1]
    g_ids = torch.arange(ngroups, dtype=torch.int32, device=dev)
    grow = (torch.searchsorted(gptr, g_ids, right=True) - 1).clamp(
        0, max(num_rows - 1, 0)).long()
    within = ((g_ids - gptr[grow])[:, None] * group
              + torch.arange(group, dtype=torch.int32, device=dev)[None, :])
    valid = within < deg[grow][:, None]
    eid2d = torch.where(valid, rowptr[grow][:, None] + within, -1)
    return eid2d.reshape(-1).to(torch.int32), grow.to(torch.int32)


def _pad(row, num_rows: int, group: int):
    """``(eid, grow, gptr, rowptr)`` of one orientation."""
    rowptr, gptr = _geometry(row, num_rows, group)
    ngroups = max(int(gptr[-1]), 1)
    eid, grow = _slots(rowptr, gptr, ngroups, group, num_rows)
    return eid, grow, gptr, rowptr


def _col_grid(eid, col, group: int, num_cols: int):
    """The transposed ``(G, ng)`` column grid of slots ``eid``:
    ``num_cols`` on pads."""
    src = col if col.numel() else col.new_zeros(1)
    safe = eid.clamp(0, src.numel() - 1).long()
    c = torch.where(eid >= 0, src[safe], num_cols).to(torch.int32)
    return c.reshape(-1, group).T.contiguous()


def _pick_group(row, num_rows: int, nnz: int) -> int:
    """The group width of the fewest padded slots among a few candidates
    (>= 32, the JAX package's measured XLA fusion threshold), as JAX picks
    it: near-regular graphs land on ``G`` ~ the mean degree."""
    mean_deg = max(1, nnz // max(num_rows, 1))
    cands = sorted({32, 48, 64, min(256, max(32, mean_deg)),
                    min(256, max(32, -(-mean_deg // 8) * 8))})
    rowptr = ind2ptr(torch.as_tensor(row), num_rows).long()
    deg = rowptr[1:] - rowptr[:-1]
    totals = torch.stack([(-(-deg // g) * g).sum() for g in cands])
    return int(cands[int(torch.argmin(totals))])


def _fwd_slot_map(eid, perm_t, eid_t, nnz: int, group: int, ng: int):
    """(G, ng_t) flat forward-grid slot (``i * ng + g``) of each A^T slot;
    ``G * ng`` on pads."""
    dev = eid.device
    p = torch.arange(eid.numel(), device=dev)
    flat = (p % group) * ng + p // group
    real = eid >= 0
    inv_slot = torch.zeros(nnz, dtype=torch.int64, device=dev)
    inv_slot[eid[real].long()] = flat[real]
    real_t = eid_t >= 0
    orig = torch.where(real_t, perm_t[eid_t.clamp(min=0).long()], 0).long()
    vmap = torch.where(real_t, inv_slot[orig.clamp(0, nnz - 1)],
                       group * ng)
    return vmap.reshape(-1, group).T.contiguous().to(torch.int32)


def make_sell_plan(row, col, num_rows: int, num_cols: int, *,
                   group="auto", feat_dim: int = 256,
                   target_bytes: int = 120 * 1024 * 1024,
                   l2_backend: Optional[str] = None):
    """``(plan, structure)`` for :func:`spmm_sell`, built on ``row``'s
    device. ``row`` must be sorted ascending; entries with ``row >=
    num_rows`` are padding (no slot, ``d value`` 0). ``group``: the pad
    quantum, or ``"auto"`` (8 on the CPU, :func:`_pick_group` on the card).
    ``feat_dim``, ``target_bytes`` and ``l2_backend`` sized and chose the
    JAX package's TPU passes and are accepted for its signature."""
    del feat_dim, target_bytes, l2_backend       # TPU scheduling
    row = torch.as_tensor(row)
    col = torch.as_tensor(col, device=row.device)
    real = row < num_rows
    _check_indices(row[real], col[real], num_rows, num_cols,
                   "make_sell_plan")
    if row.numel() > 1 and bool((row[1:] < row[:-1]).any()):
        raise ValueError("make_sell_plan requires row indices sorted "
                         "ascending (canonical COO order)")
    # copies, so that a cached plan does not keep the caller's indices
    # alive (the cache drops a plan when its key tensors die)
    row = row.to(torch.int32, copy=True)
    col = col.to(torch.int32, copy=True)
    nnz = row.numel()
    if group == "auto":
        group = (_pick_group(row, num_rows, nnz) if row.is_cuda else 8)

    eid, _, _, rowptr = _pad(row, num_rows, group)
    ng = eid.numel() // group
    p = torch.arange(eid.numel(), device=row.device)
    slot = torch.zeros(nnz, dtype=torch.int32, device=row.device)
    real_slot = eid >= 0
    slot[eid[real_slot].long()] = ((p % group) * ng + p // group)[
        real_slot].to(torch.int32)

    structure = SellStructure(eid, row, col, slot=slot,
                              csr=spmm_structure(rowptr, row, col, num_cols))
    return SellPlan(num_rows, num_cols, group), structure


def jax_arrays(plan: SellPlan, s: SellStructure) -> dict:
    """The JAX package's ten structure arrays of this plan (``col_T``,
    ``gptr``, ``grow``, ``eid``, ``row``, ``col``, ``col_Tt``, ``gptr_t``,
    ``vmap_t``, ``perm_t``), built on demand: the port computes with none
    of them but ``eid``; they show that the layout is JAX's array for
    array."""
    G, M, N = plan.group, plan.num_rows, plan.num_cols
    row, col = s.row, s.col
    _, grow, gptr, _ = _pad(row, M, G)
    # the transpose over the real entries: padding (row >= num_rows) sorts
    # last by its column and lies past the transpose's pointer
    key = torch.where(row < M, col, N)
    perm_t = torch.argsort(key, stable=True).to(torch.int32)
    row_t, col_t = key[perm_t.long()], row[perm_t.long()]
    eid_t, _, gptr_t, _ = _pad(row_t, N, G)
    ng = s.eid.numel() // G
    vmap_t = _fwd_slot_map(s.eid, perm_t, eid_t, max(row.numel(), 1), G, ng)
    return dict(col_T=_col_grid(s.eid, col, G, N), gptr=gptr, grow=grow,
                eid=s.eid, row=row, col=col,
                col_Tt=_col_grid(eid_t, col_t, G, M), gptr_t=gptr_t,
                vmap_t=vmap_t, perm_t=perm_t)


def pad_values(s: SellStructure, value: torch.Tensor, *,
               group: int) -> torch.Tensor:
    """COO-ordered (nnz,) values -> the ``(G, ng)`` grid (pads 0). Do this
    once per operand and keep the grid as the autograd leaf."""
    real = s.eid >= 0
    v = value[s.eid.clamp(min=0).long()] if value.numel() else \
        value.new_zeros(s.eid.shape)
    v = torch.where(real, v, torch.zeros((), dtype=value.dtype,
                                         device=value.device))
    return v.reshape(-1, group).T.contiguous()


def unpad_values(s: SellStructure, grid: torch.Tensor, *,
                 group: int) -> torch.Tensor:
    """The ``(G, ng)`` grid -> COO-ordered (nnz,) values (the inverse of
    :func:`pad_values` on the real slots). Entries without a slot (padding
    rows) read slot 0, as the JAX function reads them."""
    del group                      # the slot map holds it
    return grid.reshape(-1).index_select(0, s.slot)


def spmm_sell(plan: SellPlan, s: SellStructure,
              value: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` (sum reduction) over a padded-group plan, differentiable in
    ``(value, x)``.

    ``value``: None (structural ones), a COO-ordered (nnz,) vector, or the
    ``(G, ng)`` grid (its grad comes back in the grid, 0 at pads). The
    output has ``x``'s dtype; sums are taken in f32."""
    if x.dim() != 2 or x.shape[0] != plan.num_cols:
        raise ValueError(f"x must be (N={plan.num_cols}, K), got "
                         f"{tuple(x.shape)}")
    if value is not None and value.dim() == 2:
        grid = (plan.group, s.eid.numel() // plan.group)
        if tuple(value.shape) != grid:
            raise ValueError(f"value grid {tuple(value.shape)} does not "
                             f"match the plan's {grid}")
        # the real slots in COO order (the kernels never read a padding
        # entry's, and K2 gives it a 0 gradient)
        value = unpad_values(s, value, group=plan.group)
    out = spmm_with_structure(s.csr.rowptr, s.col, value, x, lambda: s.csr,
                              "sum", s.csr.row_split)
    return out.to(x.dtype)
