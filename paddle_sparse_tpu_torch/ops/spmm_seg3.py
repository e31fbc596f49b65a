"""Tile-span packed SpMM (``seg3``): the same packed layout and function as
``seg2``, planned with the JAX package's band and tile-span capacities.

Port of ``paddle_sparse_tpu/ops/spmm_seg3.py``. On the TPU, seg3 differs from
seg2 in its reduction only: per 128-row output tile, the tile's spans from
all S segments are staged into VMEM and folded in one MXU product (K3,
``spmm_pallas.py::_tilespan_kernel``). On the card both run the same
multi-span kernel, so :func:`spmm_seg3` is seg2's autograd function over
seg3's structure: forward and ``d x`` are one multi-span SpMM launch each,
``d value`` one span-SDDMM launch.

:func:`make_seg3_plan` keeps the JAX planner's refusal rule
(:class:`Seg3Infeasible` when ``2 * max(S * CAP_TS, S_t * CAP_TS_t) * K *
stream bytes`` exceeds ``staging_budget``), so that callers fall back to seg2
exactly as ``bench.py`` does. The H100 kernel stages nothing, so the rule is
kept for parity of the API, not because the card needs it. The row pointers
are padded to whole bands, as there. The TPU's staging tables (``_tables``,
``Seg3Tables``) and the ``d value`` window map (``dv_map``) are not on the
path: :func:`tilespan_tables` builds the tables only for the K3 entry point
(:func:`~.kernels.spmm_spans_cuda.tilespan_call`).
"""
from typing import NamedTuple, Optional

import torch

from .kernels.row_split import RowSplit
from .spmm_seg2 import (_check_indices, _segment_size, build_layouts,
                        pack_values, packed_spmm, unpack_values)

__all__ = ["Seg3Infeasible", "Seg3Plan", "Seg3Structure", "make_seg3_plan",
           "pack_values", "spmm_seg3", "tilespan_tables", "unpack_values"]


class Seg3Plan(NamedTuple):
    """Static geometry for :func:`spmm_seg3` (the JAX plan's fields)."""
    num_rows: int
    num_cols: int
    S: int
    SR: int
    BAND: int          # output rows per band (multiple of 128)
    cap: int           # per-(band, segment) window capacity (mult 16)
    CAP_TS: int        # per-(tile, segment) staged capacity (mult 16)
    S_t: int
    SR_t: int
    BAND_t: int
    cap_t: int
    CAP_TS_t: int
    stream: str = "f32"


class Seg3Structure(NamedTuple):
    col_f: torch.Tensor
    rp_f: torch.Tensor      # (S, bands * BAND + 1), padded with the last
    perm_f: torch.Tensor
    sbase_f: torch.Tensor
    col_t: torch.Tensor
    rp_t: torch.Tensor      # (S_t, bands_t * BAND + 1)
    sbase_t: torch.Tensor
    relay_ft: torch.Tensor
    split_f: Optional[RowSplit]   # pieces of the M rows (seg2's tables)
    split_t: Optional[RowSplit]


class Seg3Infeasible(ValueError):
    """Row skew inflates the tile-span capacity past the staging budget of
    the JAX package's TPU kernel: use the degree-agnostic seg2 instead."""


def _pad_rp(rp: torch.Tensor, rows_pad: int) -> torch.Tensor:
    pad = rows_pad + 1 - rp.shape[1]
    return torch.cat([rp, rp[:, -1:].expand(-1, pad)], 1) if pad else rp


def _windows_and_spans(rp: torch.Tensor, BAND: int):
    """(max edges of a (band, segment) window, max staged span of a
    (tile, segment) including the 16-row alignment of its start)."""
    R = 128
    T_B = BAND // R
    rp = rp.long()
    at_bands = rp[:, ::BAND]                         # (S, bands + 1)
    win = int((at_bands[:, 1:] - at_bands[:, :-1]).max())
    at_tiles = rp[:, ::R]                            # (S, bands * T_B + 1)
    band_base = at_bands[:, :-1].repeat_interleave(T_B, dim=1)
    ts = at_tiles[:, :-1] - band_base
    te = at_tiles[:, 1:] - band_base
    return win, int((te - ts.div(16, rounding_mode="floor") * 16).max())


def tilespan_tables(rp: torch.Tensor, *, S: int, BAND: int, cap: int,
                    CAP_TS: int):
    """The TPU staging tables of one orientation, as
    ``paddle_sparse_tpu/ops/spmm_seg3.py::_tables`` builds them from band-
    padded row pointers ``rp`` (S, bands * BAND + 1): per band, ``e0a``
    (T_B * S,) 16-aligned staged-slice starts in the band's stream (span
    ``s`` of the band occupies stream rows ``s * cap`` on), and ``bst``/
    ``ben`` (T_B, S, 128) staging-relative row bounds. Returns
    ``(e0a, bst, ben)`` stacked over bands. Only the K3 entry point
    :func:`~.kernels.spmm_spans_cuda.tilespan_call` reads them."""
    R = 128
    T_B = BAND // R
    bands = (rp.shape[1] - 1) // BAND
    rp = rp.long()
    base = rp[:, :bands * BAND:BAND, None]                     # (S, bands, 1)
    off = (torch.arange(S, device=rp.device) * cap)[:, None, None]
    st = rp[:, :bands * BAND].reshape(S, bands, BAND) - base + off
    en = rp[:, 1:bands * BAND + 1].reshape(S, bands, BAND) - base + off
    e0a = st[:, :, ::R].div(16, rounding_mode="floor") * 16     # (S, bands, T_B)
    stage = (e0a - (torch.arange(S, device=rp.device)
                    * CAP_TS)[:, None, None])[..., None]
    bst, ben = ((b.reshape(S, bands, T_B, R) - stage).permute(1, 2, 0, 3)
                .to(torch.int32) for b in (st, en))
    return (e0a.permute(1, 2, 0).reshape(bands, T_B * S).to(torch.int32),
            bst.contiguous(), ben.contiguous())


def make_seg3_plan(row, col, num_rows: int, num_cols: int, *,
                   feat_dim: int, stream: str = "f32",
                   band_rows: int = 28672, sr=None,
                   staging_budget: int = 24 << 20):
    """``(plan, structure)`` for :func:`spmm_seg3`, built on ``row``'s
    device (``row`` sorted ascending). Raises :class:`Seg3Infeasible` under
    the JAX planner's rule: when the staged spans would need more than
    ``staging_budget`` bytes of TPU VMEM (power-law hot tiles)."""
    M, N = num_rows, num_cols
    row, col = _check_indices(row, col, M, N, "make_seg3_plan")
    SR = _segment_size(sr, N, feat_dim, stream)
    SR_t = _segment_size(sr, M, feat_dim, stream)
    BAND = max(128, (band_rows // 128) * 128)
    bands = max(1, -(-M // BAND))
    bands_t = max(1, -(-N // BAND))
    (S, S_t, col_f, rp_f, perm_f, sbase_f, col_t, rp_t, sbase_t, relay_ft,
     split_f, split_t) = build_layouts(row, col, M, N, SR=SR, SR_t=SR_t)
    rp_f = _pad_rp(rp_f, bands * BAND)
    rp_t = _pad_rp(rp_t, bands_t * BAND)

    def rnd16(v):
        return max(16, -(-int(v) // 16) * 16)

    win_f, span_f = _windows_and_spans(rp_f, BAND)
    win_t, span_t = _windows_and_spans(rp_t, BAND)
    cap, CAP_TS = rnd16(win_f), rnd16(span_f)
    cap_t, CAP_TS_t = rnd16(win_t), rnd16(span_t)
    need = (2 * max(S * CAP_TS, S_t * CAP_TS_t) * feat_dim
            * (2 if stream == "bf16" else 4))
    if need > staging_budget:
        raise Seg3Infeasible(
            f"staged spans need {need >> 20} MB VMEM (> "
            f"{staging_budget >> 20} MB) — skewed rows; use seg2")
    plan = Seg3Plan(M, N, S, SR, BAND, cap, CAP_TS, S_t, SR_t, BAND, cap_t,
                    CAP_TS_t, stream=stream)
    structure = Seg3Structure(col_f=col_f, rp_f=rp_f, perm_f=perm_f,
                              sbase_f=sbase_f, col_t=col_t, rp_t=rp_t,
                              sbase_t=sbase_t, relay_ft=relay_ft,
                              split_f=split_f, split_t=split_t)
    return plan, structure


def spmm_seg3(plan: Seg3Plan, s: Seg3Structure, packed_value, x):
    """``A @ x`` (sum), differentiable in ``(packed_value, x)``: seg2's
    kernels over seg3's structure (values packed with :func:`pack_values`)."""
    return packed_spmm(plan, s, packed_value, x)
